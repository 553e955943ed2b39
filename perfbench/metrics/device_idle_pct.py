"""device_idle_pct (device trace): the share of the profiled jobs' span in
which no kernel, copy or set ran on the card (``torch.profiler``)."""


def read(readings):
    t = readings.get("trace")
    if not t or not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
