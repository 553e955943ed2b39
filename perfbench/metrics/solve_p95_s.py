"""solve_p95_s (host clock): the 95th percentile (nearest rank) of every
job's wall in the window, failed jobs at +inf."""

import math


def read(readings):
    walls = sorted(j["wall"] if j["ok"] else math.inf for j in readings["jobs"])
    if not walls:
        return None
    return walls[max(math.ceil(0.95 * len(walls)) - 1, 0)]
