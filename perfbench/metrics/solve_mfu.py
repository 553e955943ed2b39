"""solve_mfu (host clock): a whole job's FLOP (6·k·nnz·iters for the
iterations, 2·k·users·items for the top-1) over the traced window's
seconds a job and the dtype's peak, in percent."""

from perfbench import roofline
from perfbench.metrics._common import solve_seconds


def read(readings):
    s = solve_seconds(readings)
    if not s:
        return None
    i = readings["instance"]
    flops = roofline.job_flops(i["nnz"], i["features"], i["iters"], i["users"], i["items"])
    return 100.0 * flops / (s * roofline.PEAK_FLOPS[readings["dtype"]])
