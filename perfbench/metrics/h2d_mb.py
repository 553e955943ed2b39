"""h2d_mb (program counter): the median over the traced window's jobs of
the bytes a job copied from the host to the card (``h2d_bytes``, counted
by ``utils.timing.h2d`` in ``upload``, ``top1`` and the un-permute), in MB
(10^6 B)."""

from perfbench.metrics._spans import count_median


def read(readings):
    n = count_median(readings, "h2d_bytes")
    return None if n is None else n / 1e6
