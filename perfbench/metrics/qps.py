"""qps: every query answered in the window over the window's seconds (updates in it too)."""


def read(run):
    return run.queries() / run.window_s if run.calls and run.window_s else None
