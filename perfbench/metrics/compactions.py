"""compactions: the mutable index's compactions over the window (stats()["compactions"])."""


def read(run):
    return None if run.compactions is None else float(run.compactions)
