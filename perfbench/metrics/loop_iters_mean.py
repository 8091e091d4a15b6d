"""loop_iters_mean: mean Eq.-1 iterations (SearchResult.iters) over the window's checked answers."""


def read(run):
    return run.iters_mean
