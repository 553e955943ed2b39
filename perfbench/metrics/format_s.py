"""format_s (program span): the median over the traced window's jobs of the
seconds in the ``format`` span: the printed list, the rated counts and
``format_recommendations`` (``trainer.format_top1``)."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "format")
