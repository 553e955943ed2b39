"""init_s (program span): the median over the traced window's jobs of the
seconds in the ``init`` span: the initial factors' glibc draws made on the
card (``engine/trainer.py::_factorize_bell_device``, inside ``upload``,
waiting for the card at its end).  None where no job drew its factors on
the card: another route, the host init, or a program without the span."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "init")
