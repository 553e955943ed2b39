"""scan_s (program span): the median over the traced window's jobs of the
seconds in the ``scan`` span: the top-1's item-block loop
(``engine/trainer.py::recommend``, inside the ``top1`` phase: R's padding,
one (users x block) product, mask and running best a block, and the
result's copy to the host, which waits for the device).  None where no
job scanned item blocks: the resident and stream routes, whose top-1 is a
kernel of their own, or a program without the span."""

from perfbench.metrics._spans import span_median


def read(readings):
    return span_median(readings, "scan")
