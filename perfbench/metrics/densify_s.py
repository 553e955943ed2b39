"""densify_s (program span): the median over the traced window's jobs of the
seconds in the ``densify`` span: the host build of dense Aᵀ inside
``upload`` (``dense_fused.device_dense_AT``), before its copy."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "densify")
