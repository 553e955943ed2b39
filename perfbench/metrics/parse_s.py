"""parse_s (program span): the median over the traced window's jobs of the
seconds in the ``parse`` span: the ``.in`` file's read and parse
(``cli.py``, ``io/parser.py``)."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "parse")
