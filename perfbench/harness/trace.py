"""Read one `torch.profiler` trace of the measured window.

The harness marks the window and each facade call with `record_function`
spans named `bench.window`, `bench.search`, `bench.insert` and
`bench.delete`.  From the raw kineto records (no per-event Python parsing
by the profiler) this module takes:

- the window's length and the device's busy time: the union of every
  kernel, copy and fill interval that lies in it;
- per span kind, the spans and the kernels their host code launched (a
  kernel belongs to the span that holds its launch call, matched by the
  CUDA correlation id), with each kernel's device time by name;
- the device operations that took most time, and the idle gaps named by
  the innermost host operation running at each gap's midpoint.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
WINDOW = "bench.window"
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    spans: dict            # kind -> number of spans
    launches: dict         # kind -> kernels launched inside its spans
    kernel_s: dict         # kind -> {kernel name: device seconds}
    device_ops: list       # [[name, seconds]], most time first
    idle_gaps: list        # [[host operation, seconds]], most time first


def profile(device):
    """A profiler of host and device activity, or of the host alone off the card."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts)


def _union(intervals):
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _kind(e) -> str:
    """The kineto activity type of a record, from its device and name (the
    events of PyTorch 2.11 do not carry the type)."""
    from torch.autograd import DeviceType

    name = e.name()
    if e.device_type() == DeviceType.CUDA:
        if name.startswith(SPAN_PREFIX):
            return "gpu_user_annotation"
        if "Sync" in name:
            return "cuda_sync"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if name.startswith(SPAN_PREFIX):
        return "user_annotation"
    return "cuda_runtime" if _RUNTIME.match(name) else "cpu_op"


def summarize(prof) -> Trace | None:
    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if e.name() == WINDOW]
    if not windows:
        return None
    win = windows[0]
    w0, w1, tid = win.start_ns(), win.start_ns() + win.duration_ns(), win.start_thread_id()

    spans, host, launch_at, device = [], [], {}, []
    for e in events:
        kind = _kind(e)
        if kind in DEVICE_OPS:
            s = e.start_ns()
            if w0 <= s <= w1:
                device.append((s, s + e.duration_ns(), e.name(), kind, e.correlation_id()))
        elif kind == "cuda_runtime":
            launch_at[e.correlation_id()] = e.start_ns()
            if e.start_thread_id() == tid:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif kind in ("cpu_op", "user_annotation") and e.start_thread_id() == tid:
            s, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.name().startswith(SPAN_PREFIX) and e.name() != WINDOW:
                spans.append((s, end, e.name()[len(SPAN_PREFIX):]))
            host.append((s, end, e.name()))

    spans.sort()
    starts = [s for s, _, _ in spans]
    n_spans, launches = defaultdict(int), defaultdict(int)
    kernel_s = defaultdict(lambda: defaultdict(float))
    for _, _, kind in spans:
        n_spans[kind] += 1
    by_name = defaultdict(float)
    for s, e, name, kind, corr in device:
        by_name[name] += (e - s) / 1e9
        if kind != "kernel":
            continue
        at = launch_at.get(corr, s)
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and spans[i][0] <= at <= spans[i][1]:
            launches[spans[i][2]] += 1
            kernel_s[spans[i][2]][name] += (e - s) / 1e9

    intervals = [(max(s, w0), min(e, w1)) for s, e, *_ in device]
    busy_ns = _union(intervals)
    return Trace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        spans=dict(n_spans), launches=dict(launches),
        kernel_s={k: dict(v) for k, v in kernel_s.items()},
        device_ops=[[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_idle_gaps(intervals, host, spans, w0, w1),
    )


def _idle_gaps(intervals, host, spans, w0, w1) -> list:
    """Device-idle time in the window summed by what the host was doing
    at each gap's midpoint: '<span kind>: <innermost host operation>'."""
    gaps, last = [], w0
    for s, e in sorted(intervals):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if w1 > last:
        gaps.append((last, w1))
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    parent, stack = [], []
    for i, (s, e, _) in enumerate(host):
        while stack and host[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    span_starts = [s for s, _, _ in spans]
    total = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and host[i][1] <= mid:
            i = parent[i]
        j = bisect.bisect_right(span_starts, mid) - 1
        kind = spans[j][2] if j >= 0 and spans[j][1] > mid else "between calls"
        what = host[i][2] if i >= 0 and not host[i][2].startswith(SPAN_PREFIX) else "python"
        total[f"{kind}: {what}"] += (g1 - g0) / 1e9
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
