"""walk_s (program span): the median over the traced window's jobs of the
seconds in the ``walk`` span: the sparse walk's tables, built on the card
inside ``upload`` (``stream_walk`` or ``resident_walk``)."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "walk")
