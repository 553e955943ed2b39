"""scan_roofline (program span): the top-1 scan's floor over ``scan_s``,
in percent.  The floor is priced from the instance, whatever implements
the scan: 2·k FLOP a (user, item) at the dtype's peak, or R's
``items * k`` values read once at the card's HBM rate, the larger
(``roofline.PEAK_FLOPS``, ``roofline.HBM_BYTES_S``).  None where no job
recorded the ``scan`` span."""

from perfbench import roofline
from perfbench.metrics._spans import span_median


def floor_seconds(instance: dict, dtype: str) -> float:
    """The seconds of the scan's work at the card's peak."""
    users, items, k = instance["users"], instance["items"], instance["features"]
    flops = 2.0 * k * users * items
    nbytes = roofline.ITEMSIZE[dtype] * items * k
    return max(flops / roofline.PEAK_FLOPS[dtype], nbytes / roofline.HBM_BYTES_S)


def read(readings):
    scan = span_median(readings, "scan")
    if not scan:
        return None
    return 100.0 * floor_seconds(readings["instance"], readings["dtype"]) / scan
