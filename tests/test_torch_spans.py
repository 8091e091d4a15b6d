"""The port's profiler spans (`repro_torch.utils.spans`) and the reference's
count of skipped tile loads (`kernels.ref.dmas_skipped`), on the CPU.

Under `torch.profiler` a search, an insert, a delete and a compaction emit
exactly their `asnn.` spans, nested on one thread as the stages run; with
no profiler a span is the one shared null context."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api
from repro_torch.configs.paper_active_search import PAPER_GRID
from repro_torch.core import mutable as mut
from repro_torch.core import projection
from repro_torch.kernels import ref
from repro_torch.utils import spans

K = 11
CFG = dataclasses.replace(PAPER_GRID, grid_size=100, window=16, row_cap=16, r0=4)
STAGES = ["asnn.project", "asnn.loop", "asnn.windows", "asnn.select", "asnn.assemble"]


@pytest.fixture(scope="module")
def searcher():
    gen = torch.Generator().manual_seed(3)
    pts = torch.randn((3000, 2), generator=gen)
    labels = torch.randint(0, CFG.n_classes, (3000,), generator=gen, dtype=torch.int32)
    return api.ActiveSearcher.build(pts, labels=labels, cfg=CFG,
                                    proj=api.identity_projection(pts), device="cpu")


def _points(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 2), generator=gen),
            torch.randint(0, CFG.n_classes, (n,), generator=gen, dtype=torch.int32))


def traced(fn):
    """fn's result and its `asnn.` spans, all on one thread: (name, parent
    span's name or None), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("asnn.")]
    assert len({e.start_thread_id() for e in events}) == 1      # one thread
    found = sorted((e.start_ns(), -e.duration_ns(), e.name()) for e in events)
    rows, open_ = [], []
    for start, neg_dur, name in found:
        while open_ and open_[-1][0] <= start:
            open_.pop()
        rows.append((name, open_[-1][1] if open_ else None))
        open_.append((start - neg_dur, name))
    return out, rows


def test_no_profiler_gives_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    assert spans.span("asnn.search") is spans.span("asnn.loop") is spans._NULL
    with spans.span("asnn.search") as inner:
        assert inner is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("asnn.search") is not spans._NULL


@pytest.mark.parametrize("chunk", [None, 32])
def test_search_emits_its_stages_inside_the_search_span(searcher, chunk):
    q, _ = _points(64, 5)
    s = searcher.with_plan(chunk_size=chunk)
    want = s.search(q, K)
    got, rows = traced(lambda: s.search(q, K))
    assert torch.equal(got.ids, want.ids) and torch.equal(got.dists, want.dists)
    chunks = 1 if chunk is None else 64 // chunk
    assert rows == [("asnn.search", None)] + [(n, "asnn.search") for n in STAGES] * chunks


def test_insert_and_delete_emit_their_stages(searcher):
    pts, labels = _points(200, 6)
    grown, rows = traced(lambda: searcher.insert(pts, labels=labels))
    assert rows == [("asnn.insert", None), ("asnn.insert.plan", "asnn.insert"),
                    ("asnn.insert.apply", "asnn.insert"), ("asnn.insert.tiles", "asnn.insert"),
                    ("asnn.snapshot", "asnn.insert")]
    ids = grown.index.ids_sorted[::7][:50]
    shrunk, rows = traced(lambda: grown.delete(ids))
    assert rows == [("asnn.delete", None), ("asnn.delete.plan", "asnn.delete"),
                    ("asnn.delete.apply", "asnn.delete"), ("asnn.snapshot", "asnn.delete")]
    assert shrunk.stats()["n_points"] == grown.stats()["n_points"] - 50
    _, rows = traced(lambda: shrunk.search(pts[:8], K))
    assert [n for n, _ in rows] == ["asnn.search"] + STAGES


def test_compaction_shows_inside_the_insert(searcher):
    """A spill log of 4 slots overflows: the failed attempt's plan, the
    compaction (with its own snapshot) and the retried insert, all inside
    the one insert span."""
    small = dataclasses.replace(searcher, mutable=mut.from_index(searcher.index, CFG,
                                                                 spill_capacity=4))
    pts, labels = _points(500, 7)
    grown, rows = traced(lambda: small.insert(pts, labels=labels))
    assert grown.stats()["compactions"] == 1
    assert rows == [("asnn.insert", None), ("asnn.insert.plan", "asnn.insert"),
                    ("asnn.compact", "asnn.insert"), ("asnn.snapshot", "asnn.compact"),
                    ("asnn.insert.plan", "asnn.insert"), ("asnn.insert.apply", "asnn.insert"),
                    ("asnn.insert.tiles", "asnn.insert"), ("asnn.snapshot", "asnn.insert")]


@pytest.mark.parametrize("max_iters", [3, 16])
@pytest.mark.parametrize("early_exit", [True, False])
def test_dmas_skipped_equals_the_lockstep_count(searcher, early_exit, max_iters):
    """The helper's count from the loop's per-lane outputs against the
    lock-step loop's own, counted pass by pass from its live-lane masks
    (max_iters 3 leaves lanes unconverged)."""
    cfg = dataclasses.replace(CFG, max_iters=max_iters)
    q, _ = _points(256, 8)
    q_grid = projection.to_grid_coords(searcher.index.proj, q, cfg.grid_size)
    r0 = torch.full((256,), cfg.r0, dtype=torch.int32)
    out = ref.radius_search_loop(searcher.index.pyr_tiles, q_grid, r0, K, K, cfg.max_radius,
                                 cfg.max_iters, cfg.tile, cfg.level_nblks, early_exit=early_exit)
    got = ref.dmas_skipped(out["iters"], out["converged"], early_exit)
    assert got.dtype == torch.int32 and got.shape == ()
    assert torch.equal(got, out["tile_dmas_skipped"])
    assert (int(got) > 0) == early_exit
    if max_iters == 3:
        assert not bool(out["converged"].all())
    assert int(ref.dmas_skipped(out["iters"][:0], out["converged"][:0], early_exit)) == 0
