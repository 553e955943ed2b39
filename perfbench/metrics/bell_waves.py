"""bell_waves (program counter): the median over the traced window's jobs
of the waves of the BELL step's launch (``bell_waves``, counted once a
train by ``ops/bell.py::bell_train``: the launch's blocks over the SMs
times the blocks an SM holds at once, rounded up).  None where no job
counted it: a route without BELL, or a program without the counter."""

from perfbench.metrics._spans import count_median


def read(readings):
    return count_median(readings, "bell_waves")
