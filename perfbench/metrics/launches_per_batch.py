"""launches_per_batch: kernels launched inside search calls in the traced window, per call."""


def read(run):
    t = run.trace
    if t is None or not t.spans.get("search"):
        return None
    return t.launches.get("search", 0) / t.spans["search"]
