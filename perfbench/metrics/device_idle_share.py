"""device_idle_share: 100 x (1 - the union of device operation intervals / the traced window)."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
