"""solve_s (host clock): time to a solution, the whole window over the jobs
completed in it."""

from perfbench.metrics._common import solve_seconds


def read(readings):
    return solve_seconds(readings)
