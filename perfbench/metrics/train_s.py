"""train_s (program span): the median over the traced window's jobs of the
engine's ``train`` phase (``utils.timing.collect_phases``)."""

from perfbench.metrics._common import phase_median


def read(readings):
    return phase_median(readings, "train")
