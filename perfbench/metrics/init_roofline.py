"""init_roofline (program span): the device init's floor over ``init_s``,
in percent.  The floor is priced from the instance, whatever implements the
init: the ``(users + items) * k`` float32 initial factors written once, at
the card's HBM rate (``roofline.HBM_BYTES_S``).  None where no job recorded
the ``init`` span."""

from perfbench import roofline
from perfbench.metrics._spans import span_median

F32_BYTES = 4


def floor_seconds(instance: dict) -> float:
    """The seconds to write the initial factors once in float32: one value
    of L and R a glibc draw."""
    values = (instance["users"] + instance["items"]) * instance["features"]
    return F32_BYTES * values / roofline.HBM_BYTES_S


def read(readings):
    init = span_median(readings, "init")
    if not init:
        return None
    return 100.0 * floor_seconds(readings["instance"]) / init
