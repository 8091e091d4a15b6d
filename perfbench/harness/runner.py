"""One run of one cell: set-up, the measured window, the check, the result line.

Set-up makes the cell's data from the seed on the device, builds the index
through `ActiveSearcher.build`, has each operation of the mix's step draw
the inputs of every step the window can reach (`Op.prepare`), and warms up
with the cell's own first steps.  The window then drives the step, closed
loop with one client, for `seconds`.  Every facade call is timed on the
host clock from the call to a `synchronize`.  The answers of a few steps,
at shares of the window drawn from the seed, and of the last one are
copied to the host after their synchronize (outside the call's time); where
an operation changes the index, one more answer after the window reads the
state the window left.  Once the window has closed and the program's state
is freed, the plain reference (`perfbench/reference/`) rebuilds the index
from the points live at each checked answer, answers the same calls, and
each operation's `check` gives the numbers `correct` holds to their limits.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
import traceback

import torch

from perfbench.harness import trace as trace_lib
from perfbench.harness.cell import Cell, load_reader
from perfbench.reference import compare
from perfbench.reference import index as ref_index

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What the metric readers read (perfbench/metrics/<name>.py)."""

    def __init__(self):
        self.calls = []          # (kind, seconds, rows) of every facade call in the window
        self.window_s = None     # first call's start to the last call's end
        self.setup_s = None
        self.peak_bytes = None
        self.recall = None
        self.iters_mean = None
        self.compactions = None  # over the window; None without updates
        self.trace = None        # trace.Trace of a --trace 1 run
        self.candidate_work = None  # (bytes, ops) of one search call's candidate stage

    def times(self, *kinds) -> list[float]:
        return [s for kind, s, _ in self.calls if kind in kinds]

    def queries(self) -> int:
        return sum(n for kind, _, n in self.calls if kind == "search")


class Ctx:
    """What an operation's `run` calls the facade through: each call is
    timed to a synchronize and, inside the window, recorded."""

    def __init__(self, run: Run, dev):
        self.run, self.dev = run, dev
        self.record = False
        self.spans = contextlib.nullcontext

    def call(self, kind: str, fn, rows: int):
        with self.spans(f"bench.{kind}"):
            t0 = time.perf_counter()
            out = fn()
            _sync(self.dev)
            t1 = time.perf_counter()
        if self.record:
            self.run.calls.append((kind, t1 - t0, rows))
        return out


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _program(config: dict, points, labels, dev):
    """The searcher the window drives, built by the facade from the base points."""
    from repro_torch import api

    grid = api.GridConfig(**config["grid"])
    plan = api.ExecutionPlan(**config["plan"])
    proj = {"pca": api.pca_projection, "identity": api.identity_projection}[config["projection"]]
    s = api.ActiveSearcher.build(points, labels=labels, cfg=grid, plan=plan,
                                 proj=proj(points), device=dev)
    _sync(dev)
    return s


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, root, device="cuda",
             clock0: float | None = None, marks: dict | None = None) -> dict:
    """Run `cell` once and return its result line (a dict).

    clock0: the `perf_counter` reading that stands for the process's start,
    from which `setup_s` runs; marks: set-up parts already timed."""
    dev = torch.device(device)
    clock0 = time.perf_counter() if clock0 is None else clock0
    marks = dict(marks or {})
    mark_t = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        marks[name] = now - mark_t[0]
        mark_t[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    mark("cuda_context_s")
    tr = cell.traffic(seed, dev)
    points, labels = tr.base()
    _sync(dev)
    mark("data_s")
    searcher = _program(cell.config, points, labels, dev)
    del points, labels
    tr.forget()
    mark("index_build_s")
    steps_cap = tr.warmup_steps + math.ceil(seconds * tr.max_steps_per_s)
    for op in tr.ops:
        op.prepare(steps_cap)
    _sync(dev)
    mark("inputs_s")
    run = Run()
    ctx = Ctx(run, dev)

    def step(i, s):
        for op in tr.ops:
            s = op.run(ctx, s, i)
        return s

    def answers(i):
        return [((i, j), j, op.take()) for j, op in enumerate(tr.ops) if op.answers]

    for i in range(tr.warmup_steps):
        searcher = step(i, searcher)
        mark("warmup_first_step_s" if i == 0 else "warmup_rest_s")
    compactions0 = searcher.stats().get("compactions")

    checks = [f * seconds for f in tr.check_fractions()]
    checked = []            # (live-set key (step, op), op index, the answer on the host)
    prof = trace_lib.profile(dev) if trace else contextlib.nullcontext()
    if trace:
        from torch.profiler import record_function
        ctx.spans = record_function
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.record = True
    failed = 0
    i = tr.warmup_steps
    with prof:
        with ctx.spans("bench.window"):
            start = time.perf_counter()
            run.setup_s = start - clock0
            end = start
            while end - start < seconds and i < steps_cap:
                try:
                    t0 = time.perf_counter()
                    searcher = step(i, searcher)
                except Exception:  # a failed call ends the window and the run is not correct
                    failed += 1
                    print(f"perfbench: step {i} raised\n{traceback.format_exc()}", file=sys.stderr)
                    break
                end = time.perf_counter()
                if checks and t0 - start >= checks[0]:
                    checks = [c for c in checks if c > t0 - start]
                    checked += answers(i)
                i += 1
    ctx.record = False
    run.window_s = end - start
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if i >= steps_cap and end - start < seconds:
        print(f"perfbench: the window reached the {steps_cap} steps drawn for it after "
              f"{end - start:.3f} s", file=sys.stderr)
    last_step = i - 1
    if failed == 0 and (not checked or checked[-1][0][0] != last_step):
        checked += answers(last_step)
    if tr.mutates and failed == 0:
        compactions1 = searcher.stats().get("compactions")
        if compactions0 is not None and compactions1 is not None:
            run.compactions = compactions1 - compactions0
        for j, op in enumerate(tr.ops):
            if op.answers:
                op.run(ctx, searcher, i)
                checked.append(((i, 0), j, op.take()))
    if trace:
        run.trace = trace_lib.summarize(prof)
    del searcher
    for op in tr.ops:
        op.forget()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    readings, notes = check(cell, tr, checked, last_step, run, want_work=trace, dev=dev)
    attempted = len(run.calls) + failed
    correct = failed == 0 and bool(checked) and all(
        readings[name] <= limit for name, limit in cell.limits.items())
    notes["diagnostics"] = {n: v for n, v in readings.items() if n not in cell.limits}
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = load_reader(root, name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": _device(dev, run), "setup_parts": marks,
           "window": {"steps": i - tr.warmup_steps, "checked": sorted({k for k, _, _ in checked}),
                      **notes}}
    if trace and run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {name: {"value": readings[name], "limit": limit}
                     for name, limit in cell.limits.items()}
    return out


def _device(dev, run: Run) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": 1, "memory_peak_bytes": run.peak_bytes}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s
        out["window_s"] = run.trace.window_s
    return out


def live_sets(tr, keys: list):
    """Every point the run made (vectors and labels, indexed by id) and, for
    each live-set key (step, op) in `keys`, the ids live just before that
    operation of that step ran, ascending (their arrival order, the order
    the program's index keeps within a cell)."""
    base, labels = tr.base()
    if labels is None:
        labels = torch.zeros(tr.n, dtype=torch.int32, device=base.device)
    table = torch.arange(tr.n, dtype=torch.int32, device=base.device)
    if not tr.mutates:
        return base, labels, {key: table for key in keys}
    want, live, new = set(keys), {}, []
    last = max(keys)
    for i in range(last[0] + 1):
        for j, op in enumerate(tr.ops):
            if (i, j) in want:
                live[(i, j)] = torch.sort(table).values
            if (i, j) >= last:
                break
            added = op.replay(table, i)
            if added is not None:
                new.append(added)
    if new:
        ids = torch.cat([a[0] for a in new]).long()
        size = max(tr.n, int(ids.max()) + 1)
        vectors = base.new_zeros((size, tr.d))
        vectors[:tr.n], vectors[ids] = base, torch.cat([a[1] for a in new]).to(base.dtype)
        labs = labels.new_zeros(size)
        labs[:tr.n] = labels
        if new[0][2] is not None:
            labs[ids] = torch.cat([a[2] for a in new]).to(labels.dtype)
        base, labels = vectors, labs
    return base, labels, live


class Ref:
    """The reference's view of the index at one live set."""

    def __init__(self, cfg, proj, vectors, labels, ids, dev, precision="float64"):
        self.cfg, self.vectors, self.labels, self.ids, self.device = cfg, vectors, labels, ids, dev
        self.index = ref_index.build_index(vectors[ids], cfg, proj, labels[ids], ids,
                                           precision=precision)
        self.alive = torch.zeros(vectors.shape[0], dtype=torch.bool, device=dev)
        self.alive[ids] = True
        self._memo = {}

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]


def references(cell: Cell, tr, keys: list, dev, precision: str = "float64"):
    """A function from a live-set key to its `Ref` (built once per key)."""
    cfg = ref_index.GridConfig(**cell.config["grid"])
    vectors, labels, live = live_sets(tr, keys)
    proj = ref_index.make_projection(cell.config["projection"], vectors[:tr.n], precision)
    built = {}

    def ref(key):
        key = key if tr.mutates else keys[0]
        if key not in built:
            built.clear()
            built[key] = Ref(cfg, proj, vectors, labels, live[key].long(), dev, precision)
        return built[key]

    return ref


def check(cell: Cell, tr, checked: list, last_step: int, run: Run, want_work: bool, dev):
    """The reference's readings over the checked answers and notes on what
    was checked; sets `run.recall` and `run.iters_mean` (means over the
    checked answers of the window) and, when asked, `run.candidate_work`
    (of the window's last answer).  `checked` holds (live-set key, op
    index, the answer's fields on the host)."""
    if not checked:
        return {name: 1.0 for name in cell.limits}, {}
    keys = sorted({key for key, _, _ in checked})
    ref = references(cell, tr, keys, dev)
    readings, summaries = [], []
    for key, j, got in sorted(checked, key=lambda c: c[0]):
        r = ref(key)
        readings.append(tr.ops[j].check(r, got))
        if key[0] <= last_step:
            work = want_work and key[0] == last_step
            summaries.append(tr.ops[j].summary(r, got, work))
    if summaries:
        run.recall = sum(s["recall"] for s in summaries) / len(summaries)
        run.iters_mean = sum(s["iters_mean"] for s in summaries) / len(summaries)
        run.candidate_work = next((s["candidate_work"] for s in summaries
                                   if "candidate_work" in s), None)
    n_queries = sum(r["query_mismatch"][1] for r in readings if "query_mismatch" in r)
    return compare.combine(readings), {"checked_queries": n_queries}
