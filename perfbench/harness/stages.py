"""Split a traced window by the program's own stages.

The program opens `asnn.` spans around its stages (the names and owners
are in `repro_torch/utils/spans.py`); they record only under a profiler.
From the same raw kineto records as `trace.summarize`, this module takes:

- for each device-idle stretch inside a facade call (a `bench.<kind>`
  span), cut at the call's ends and at every `asnn.` span's start and
  end, the innermost `asnn.` span open at each piece's midpoint (the
  midpoint rule of `trace._idle_gaps`, exact on such pieces); per
  search call, the idle time under `asnn.loop` (`loop_idle_ms`), under
  `asnn.select` (`candidate_idle_ms`) and under neither (`facade_idle_ms`),
  which add up to the search calls' idle time (`search_idle_ms`, counted
  apart as the calls' time less their busy time);
- for each `asnn.` span, its extent: the later of its end and the end of
  the last device operation launched inside it (matched by correlation
  id, as `trace.summarize` matches kernels to calls), less its start;
  `snapshot_ms` is the mean over the `asnn.snapshot` spans of insert and
  delete calls outside any `asnn.compact`, `compact_ms` the mean over
  `asnn.compact` spans (absent where the window held none).

A device event named `asnn.` is an annotation range, never device work.

`runner.run_cell` keeps its profiler to itself, so no metric of
BENCHMARK.json reads this yet; `traced_run` holds the profiler that a
traced run makes, and

  python3 -m perfbench.harness.stages --workload paper2d.churn --seed 7 --seconds 20

prints one traced run's result line with the split under `stages`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from perfbench.harness import trace as trace_lib

PREFIX = "asnn."
LOOP, SELECT, SNAPSHOT, COMPACT = "asnn.loop", "asnn.select", "asnn.snapshot", "asnn.compact"


def kind(e) -> str:
    """`trace._kind`, with the program's device-side ranges as annotations."""
    from torch.autograd import DeviceType

    if e.device_type() == DeviceType.CUDA and e.name().startswith(PREFIX):
        return "gpu_user_annotation"
    return trace_lib._kind(e)


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans):
    """A function from a time to the innermost span open then (its index),
    or -1; `spans` are (start, end, name), properly nested, sorted."""
    starts = [s for s, _, _ in spans]
    parent, stack = [], []
    for i, (s, _, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][1] <= t:
            i = parent[i]
        return i

    return at, parent


def split(prof) -> dict | None:
    """The stage split of one traced window (see the module's docstring),
    None where the trace has no window."""
    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if e.name() == trace_lib.WINDOW]
    if not windows:
        return None
    win = windows[0]
    w0, w1, tid = win.start_ns(), win.start_ns() + win.duration_ns(), win.start_thread_id()

    calls, stages, device, launch_at = [], [], [], {}
    for e in events:
        k, name = kind(e), e.name()
        if k in trace_lib.DEVICE_OPS:
            if w0 <= e.start_ns() <= w1:
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id()))
        elif k == "cuda_runtime":
            launch_at[e.correlation_id()] = e.start_ns()
        elif k in ("cpu_op", "user_annotation") and e.start_thread_id() == tid \
                and w0 <= e.start_ns() <= w1:
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
            if name.startswith(trace_lib.SPAN_PREFIX) and name != trace_lib.WINDOW:
                calls.append((*span[:2], name[len(trace_lib.SPAN_PREFIX):]))
            elif name.startswith(PREFIX):
                stages.append(span)
    calls.sort()
    stages.sort(key=lambda s: (s[0], -s[1]))
    n_calls = defaultdict(int)
    for *_, k in calls:
        n_calls[k] += 1

    busy = _merged((max(s, w0), min(e, w1)) for s, e, _ in device)
    gaps, last = [], w0
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))

    stage_at, parent = _innermost(stages)
    bounds = sorted({t for s, e, _ in stages for t in (s, e)})
    idle = defaultdict(float)             # (call kind, innermost stage) -> ns
    part = defaultdict(float)             # facade / loop / candidate -> ns, search calls
    gap_starts = [g0 for g0, _ in gaps]
    for c0, c1, k in calls:
        i = max(bisect.bisect_right(gap_starts, c0) - 1, 0)
        while i < len(gaps) and gaps[i][0] < c1:
            g0, g1 = max(gaps[i][0], c0), min(gaps[i][1], c1)
            i += 1
            if g1 <= g0:
                continue
            cuts = bounds[bisect.bisect_right(bounds, g0):bisect.bisect_left(bounds, g1)]
            for p0, p1 in zip([g0, *cuts], [*cuts, g1]):
                j = stage_at((p0 + p1) / 2)
                idle[(k, stages[j][2] if j >= 0 else "none")] += p1 - p0
                if k == "search":
                    names = set()
                    while j >= 0:
                        names.add(stages[j][2])
                        j = parent[j]
                    part["loop" if LOOP in names else "candidate" if SELECT in names
                         else "facade"] += p1 - p0

    busy_starts = [s for s, _ in busy]
    search_idle = 0
    for c0, c1, k in calls:
        if k != "search":
            continue
        i = max(bisect.bisect_right(busy_starts, c0) - 1, 0)
        covered = 0
        while i < len(busy) and busy[i][0] < c1:
            covered += max(0, min(busy[i][1], c1) - max(busy[i][0], c0))
            i += 1
        search_idle += (c1 - c0) - covered

    # each stage's extent: its end or its device work's, whichever is later
    ops = sorted((launch_at[c], e) for _, e, c in device if c in launch_at)
    op_starts = [t for t, _ in ops]
    call_at, _ = _innermost(calls)
    extent = defaultdict(list)
    snapshots, compacts = [], []
    for i, (s, e, name) in enumerate(stages):
        lo, hi = bisect.bisect_left(op_starts, s), bisect.bisect_right(op_starts, e)
        end = max([e] + [ops[m][1] for m in range(lo, hi)])
        extent[name].append(end - s)
        if name == COMPACT:
            compacts.append(end - s)
        elif name == SNAPSHOT:
            c = call_at(s)
            up, in_compact = parent[i], False
            while up >= 0:
                in_compact |= stages[up][2] == COMPACT
                up = parent[up]
            if c >= 0 and calls[c][2] in ("insert", "delete") and not in_compact:
                snapshots.append(end - s)

    n_search = n_calls.get("search", 0)
    out = {"calls": dict(n_calls),
           "idle_ms_per_call": {f"{k}: {stage}": ns / 1e6 / n_calls[k]
                                for (k, stage), ns in sorted(idle.items(), key=lambda kv: -kv[1])},
           "span_ms": {name: {"n": len(v), "mean": sum(v) / len(v) / 1e6}
                       for name, v in sorted(extent.items())}}
    if n_search:
        out["search_idle_ms"] = search_idle / 1e6 / n_search
        for name in ("facade", "loop", "candidate"):
            out[f"{name}_idle_ms"] = part[name] / 1e6 / n_search
    if snapshots:
        out["snapshot_ms"] = sum(snapshots) / len(snapshots) / 1e6
    if compacts:
        out["compact_ms"] = sum(compacts) / len(compacts) / 1e6
    out["compact_spans"] = len(compacts)
    return out


def traced_run(cell, seed: int, seconds: float, root, device="cuda"):
    """One `--trace 1` run of `cell` through `runner.run_cell`, and the
    split of its trace: (result line, split)."""
    from perfbench.harness import runner

    made, profile = [], trace_lib.profile

    def keep(dev):
        made.append(profile(dev))
        return made[-1]

    trace_lib.profile = keep
    try:
        line = runner.run_cell(cell, seed, seconds, True, root, device=device)
    finally:
        trace_lib.profile = profile
    return line, split(made[0]) if made else None


def main() -> int:
    import argparse
    import json
    import os
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    parser = argparse.ArgumentParser(description="One traced run of a cell, split by stage.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args()
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    sys.path[:0] = [str(root), str(root / "src")]
    from perfbench.harness import cell as cell_lib

    line, stages = traced_run(cell_lib.load_cell(root, args.workload), args.seed,
                              args.seconds, root)
    print(json.dumps({**line, "stages": stages}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
