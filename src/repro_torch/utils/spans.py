"""Named spans of the search stages and the mutable index, for a profiler.

`span(name)` marks a stage on the profiler's own clock, the clock of the
device trace, so that a `torch.profiler` trace can split a call's host and
device time by stage.  Every span name starts with `asnn.`; a span's
parent is the span that holds it on the same thread.  No span
synchronises: the device side of a span is the device work launched
inside it, which a trace reads from the launches' correlation ids.

Spans record only while a `torch.profiler` runs.  Otherwise `span` returns
one shared `contextlib.nullcontext()`, so a span costs a check and two
empty calls on the search path.

A span is a `RecordFunction` of the function scope, as an aten operator
is: it shows in the trace as a host operation and, unlike
`torch.profiler.record_function` (the user scope), adds no annotation
range to the device's timeline, where a reader that names each device
event a kernel, a copy or a fill would take it for device work.

The spans and where they are opened:

  asnn.search          core/engine.py      ActiveSearcher.search (the chunk loop)
  asnn.project         core/batched.py     _search_impl: to_grid_coords
  asnn.loop                                _search_impl: radius_search_batched
  asnn.windows                             _search_impl: window_spans, truncated
  asnn.select                              _search_impl: the candidate pipeline
  asnn.assemble                            _search_impl: the record gathers
  asnn.insert          core/engine.py      ActiveSearcher.insert
  asnn.delete                              ActiveSearcher.delete
  asnn.insert.plan     core/mutable.py     insert: _plan_insert, the spill count read
  asnn.insert.apply                        insert: _apply_insert
  asnn.insert.tiles                        insert: _refresh_tiles
  asnn.delete.plan                         delete: _plan_delete, the strict check
  asnn.delete.apply                        delete: _apply_delete, _refresh_tiles
  asnn.snapshot                            snapshot (the O(N) merge)
  asnn.compact                             compact (its snapshot and re-layout)
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_RECORD = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records `name` while a profiler runs, else a shared
    null context."""
    if torch.autograd._profiler_enabled():
        return _RECORD(name)
    return _NULL
