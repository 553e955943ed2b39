"""plan_s (program span): the median over the traced window's jobs of the
seconds in the ``plan`` span: the route's choice, ``choose_path`` and on
``pallas`` its checks and ``dense_plan`` (``engine/trainer.py``)."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "plan")
