"""Statistics the metric readers share."""

from __future__ import annotations

import statistics


def p95(values: list[float]) -> float | None:
    """The 95th percentile of every value (inclusive quantiles), None if none."""
    if not values:
        return None
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def kernel_ms_per_call(run, kind: str, kernel: str) -> float | None:
    """Device milliseconds of one kernel, by entry-function name, per call of
    `kind` in a traced window; None where it never ran there."""
    t = run.trace
    if t is None or not t.spans.get(kind):
        return None
    secs = [s for name, s in t.kernel_s.get(kind, {}).items() if kernel in name]
    if not secs:
        return None
    return 1e3 * sum(secs) / t.spans[kind]
