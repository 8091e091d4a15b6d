"""update_ms_p95: the 95th percentile of every insert and delete call's host time, call to synchronize."""

from perfbench.harness.stats import p95


def read(run):
    v = p95(run.times("insert", "delete"))
    return None if v is None else 1e3 * v
