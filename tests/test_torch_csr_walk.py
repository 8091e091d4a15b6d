"""csr_candidate_topk's walk over the valid slots of a window.

The kernel (csrc/csr_candidate_topk.cu) walks only the valid slots of each
query's window: one run of store rows per window row, found through the
exclusive prefix of the runs' lengths, a group of window rows at a time.
`_window_positions` mirrors that enumeration from `ref.window_runs`.  On
the CPU these tests hold it against the validity of every slot, and a plain
top-k over the positions alone (walked in groups too) against
`ref.csr_candidate_topk`, bit for bit.  The `gpu` cases hold the kernel
against its plain version at the same edge cases and at the cells' shapes,
and skip where there is no card.
"""

import numpy as np
import pytest
import torch
from _torch_port import assert_dists_close, assert_ids_equal_up_to_ties, np_, require_cuda

from repro_torch.kernels import ref

INT_MAX = 2**31 - 1
CASES = ["mixed", "empty_rows", "no_valid_slot", "all_valid", "long_spans", "clamped_end",
         "n_below_row_cap", "w1", "k_past_valid", "ties"]


def _case(name, d=3):
    """(store, starts, ends, queries, n, row_cap, k) of one named case,
    from a seed: empty window rows, queries with no valid slot (V = 0),
    windows valid in every slot, spans longer than row_cap, starts clamped
    at n_pad - row_cap (the run starts inside its row), a live count below
    row_cap, one window row, k past the valid slots, and tied distances."""
    rng = np.random.default_rng(sum(map(ord, name)) + d)
    b, w, rcap, n_pad, k = 16, 6, 8, 96, 5
    if name == "w1":
        w = 1
    if name == "n_below_row_cap":
        n_pad = rcap  # the store holds row_cap rows, the last 3 padding
    n = n_pad - 3
    starts = rng.integers(-4, n_pad, (b, w))
    ends = starts + rng.integers(0, rcap + 4, (b, w))
    if name == "empty_rows":  # every other row empty, or its span reversed
        ends[:, ::2] = starts[:, ::2] - rng.integers(0, 2, (b, (w + 1) // 2))
    elif name == "no_valid_slot":
        ends[: b // 2] = starts[: b // 2]
    elif name == "all_valid":
        n = n_pad
        starts = rng.integers(0, n_pad - rcap + 1, (b, w))
        ends = starts + rcap
    elif name == "long_spans":
        ends = starts + rng.integers(rcap, 4 * rcap, (b, w))
    elif name == "clamped_end":
        n = n_pad
        starts = rng.integers(n_pad - rcap + 1, n_pad, (b, w))
        ends = starts + rng.integers(1, rcap, (b, w))
    elif name == "k_past_valid":
        k = w * rcap + 3
    if name == "ties":
        store = rng.integers(0, 3, (n_pad, d)).astype(np.float32)
        q = np.zeros((b, d), np.float32)
    else:
        store = (8.0 * rng.normal(size=(n_pad, d))).astype(np.float32)
        q = (8.0 * rng.normal(size=(b, d))).astype(np.float32)
    return (torch.from_numpy(store), torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(ends.astype(np.int32)), torch.from_numpy(q), n, rcap, k)


def _window_positions(starts, ends, n_pad, n, rcap):
    """The valid slots of each query's window in slot order, as the kernel
    walks them: position p lies in the window row i with prefix[i] <= p <
    prefix[i + 1] (ref.window_runs) and is slot i*rcap + lo[i] + p -
    prefix[i].  Returns (slots (B, max V) int64, -1 past a query's V;
    V (B,) int64)."""
    lo, _length, prefix = ref.window_runs(starts, ends, n_pad, n, rcap)
    b, w = starts.shape
    v = prefix[:, -1]
    vmax = int(v.max()) if b and w else 0
    p = torch.arange(vmax).expand(b, vmax).contiguous()
    i = torch.searchsorted(prefix[:, 1:].contiguous(), p, right=True).clamp_max(max(w - 1, 0))
    slots = (i * rcap + torch.gather(lo, 1, i) + p - torch.gather(prefix, 1, i)) if w else p
    return torch.where(p < v[:, None], slots, torch.full_like(slots, -1)), v


def _positions_oracle(starts, ends, n_pad, n, rcap):
    """Every query's valid slots in slot order, slot by slot."""
    out = []
    for st_b, en_b in zip(starts.tolist(), ends.tolist()):
        slots = []
        for i, (st, en) in enumerate(zip(st_b, en_b)):
            cs = min(max(st, 0), max(n_pad - rcap, 0))
            slots += [i * rcap + t for t in range(rcap) if st <= cs + t < en and cs + t < n]
        out.append(slots)
    return out


@pytest.mark.parametrize("case", CASES)
def test_window_positions_are_the_valid_slots_in_order(case):
    store, starts, ends, _q, n, rcap, _k = _case(case)
    n_pad, (b, w) = store.shape[0], starts.shape
    slots, v = _window_positions(starts, ends, n_pad, n, rcap)
    _flat, ok = ref.window_slots(starts, ends, n_pad, n, rcap)
    want = _positions_oracle(starts, ends, n_pad, n, rcap)
    for i in range(b):
        vi = int(v[i])
        assert vi == len(want[i]) == int(ok[i].sum())
        assert slots[i, :vi].tolist() == want[i] == ok[i].nonzero().flatten().tolist()
        assert (slots[i, vi:] == -1).all()
    lo, length, prefix = ref.window_runs(starts, ends, n_pad, n, rcap)
    assert torch.equal(prefix[:, -1], v) and torch.equal(length.sum(1), v)
    assert bool((lo >= 0).all() and (lo + length <= rcap).all())
    if case == "all_valid":  # every slot valid: the position is the slot
        assert bool((v == w * rcap).all())
        assert torch.equal(slots, torch.arange(w * rcap).expand(b, -1))
    if case == "no_valid_slot":
        assert bool((v[: b // 2] == 0).all())
    if case == "clamped_end":
        assert bool((lo > 0).any())
    if case == "long_spans":
        assert bool((ends - starts > rcap).any())
    if case == "n_below_row_cap":
        assert n < rcap == n_pad


def _topk_over_positions(store, starts, ends, q, k, n, rcap, metric="l2", radii=None,
                         center_cells=False, d_chunk=None, group=None):
    """The plain top-k over the valid positions alone, `group` window rows
    at a time (all of them by default), as the kernel walks a window: each
    group's candidates ranked by (distance, position) against the list,
    then the list's positions turned into their slots less w*row_cap, so
    that an earlier group's slot ranks first on ties.  Returns (dists (B,
    k), GLOBAL CSR rows (B, k) int32), as ref.csr_candidate_topk does."""
    b, w = starts.shape
    n_pad, slots_total = store.shape[0], w * rcap
    flat, _ok = ref.window_slots(starts, ends, n_pad, n, rcap)
    list_v = torch.full((b, k), float("inf"))
    list_s = torch.full((b, k), INT_MAX, dtype=torch.int64)
    for g0 in range(0, w, group or w):
        g1 = g0 + (group or w)
        pos, _v = _window_positions(starts[:, g0:g1], ends[:, g0:g1], n_pad, n, rcap)
        if pos.shape[1] == 0:
            pos = torch.full((b, 1), -1, dtype=torch.int64)
        slot = torch.where(pos >= 0, pos + g0 * rcap, torch.zeros_like(pos))
        cand = store[torch.gather(flat, 1, slot)]
        if center_cells:
            cand = torch.floor(cand) + 0.5
        dist = ref.chunked_distance(cand, q, metric, d_chunk)
        ok = pos >= 0
        if radii is not None:
            ok = ok & (dist <= radii[:, None])
        dist = torch.where(ok, dist, torch.full_like(dist, float("inf")))
        p = torch.arange(pos.shape[1]).expand(b, -1)
        all_v = torch.cat([list_v, dist], dim=1)
        all_s = torch.cat([list_s, torch.where(ok, p, torch.full_like(p, INT_MAX))], dim=1)
        order = torch.sort(all_s, dim=1, stable=True).indices
        order = torch.gather(order, 1, torch.sort(torch.gather(all_v, 1, order), dim=1,
                                                  stable=True).indices)[:, :k]
        list_v, list_s = torch.gather(all_v, 1, order), torch.gather(all_s, 1, order)
        at = torch.gather(slot, 1, list_s.clamp(0, pos.shape[1] - 1))
        list_s = torch.where((list_s >= 0) & (list_s != INT_MAX), at - slots_total, list_s)
    rows = torch.gather(flat, 1, (list_s + slots_total).clamp(0, slots_total - 1))
    return list_v, torch.where(torch.isfinite(list_v), rows, -1).to(torch.int32)


def _mode(mode, b, rng):
    """The keyword arguments of one ranking mode."""
    if mode == "paper":
        radii = torch.from_numpy(rng.uniform(1.0, 20.0, b).astype(np.float32))
        return dict(radii=radii, center_cells=True)
    return {"l2": {}, "l1_d_chunk": dict(metric="l1", d_chunk=2)}[mode]


# each ranking mode at a few of the edge cases; the card cases hold the
# kernel itself at every case and mode
TOPK_CASES = [("mixed", "l2"), ("ties", "l2"), ("no_valid_slot", "l1_d_chunk"),
              ("clamped_end", "l1_d_chunk"), ("n_below_row_cap", "paper"),
              ("k_past_valid", "paper")]


@pytest.mark.parametrize(("case", "mode"), TOPK_CASES)
def test_topk_over_positions_equals_plain(case, mode):
    """Ranking the valid positions alone gives ref.csr_candidate_topk's
    output bit for bit: the same pairs, ties to the smaller slot."""
    store, starts, ends, q, n, rcap, k = _case(case, d=2 if mode == "paper" else 3)
    kw = _mode(mode, starts.shape[0], np.random.default_rng(1))
    got = _topk_over_positions(store, starts, ends, q, k, n, rcap, **kw)
    want = ref.csr_candidate_topk(store, starts, ends, q, k, n, rcap, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(("case", "group"), [("mixed", 1), ("ties", 2), ("clamped_end", 4)])
def test_grouped_walk_equals_plain(case, group):
    """A window walked `group` rows at a time, the list's positions turned
    into slots between groups, as the kernel walks windows wider than its
    prefix: the same output, ties included."""
    store, starts, ends, q, n, rcap, k = _case(case)
    got = _topk_over_positions(store, starts, ends, q, k, n, rcap, group=group)
    want = ref.csr_candidate_topk(store, starts, ends, q, k, n, rcap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------- the card ----


# rows wider than test_torch_kernels.py's (d <= 600): the kernel and the
# plain version sum 4,096 float32 terms in different orders, and chip_smoke.py
# holds the kNN-LM head's d 4096 to rtol 1e-5 (phase 6b)
WIDE_D, WIDE_RTOL = 1024, 1e-5


def _hold(got, want, store, q, metric):
    """Bit-equal at d <= 2; above, as test_torch_kernels.py holds the
    kernels: rows exact up to near-ties, distances within DIST_RTOL
    (WIDE_RTOL past WIDE_D)."""
    gd, gi = (t.cpu() for t in got)
    if store.shape[1] <= 2:
        assert torch.equal(gd, want[0]) and torch.equal(gi, want[1])
        return
    if store.shape[1] <= WIDE_D:
        assert_ids_equal_up_to_ties(gi, want[1], lambda b, ids: store[ids], q, metric)
        assert_dists_close(gd, want[0])
        return
    assert_ids_equal_up_to_ties(gi, want[1], lambda b, ids: store[ids], q, metric,
                                rtol=WIDE_RTOL)
    np.testing.assert_array_equal(np.isinf(np_(gd)), np.isinf(np_(want[0])))
    fin = torch.isfinite(want[0])
    np.testing.assert_allclose(np_(gd[fin]), np_(want[0][fin]), rtol=WIDE_RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 40])
@pytest.mark.parametrize("case", CASES)
def test_gpu_walk_edge_cases(case, d):
    """The kernel at the CPU tests' edge cases, direct (d 2) and staged
    (d 40), in every ranking mode."""
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk as csr

    store, starts, ends, q, n, rcap, k = _case(case, d=d)
    for mode in ("l2", "l1_d_chunk") + (("paper",) if d == 2 else ()):
        kw = _mode(mode, starts.shape[0], np.random.default_rng(2))
        want = ref.csr_candidate_topk(store, starts, ends, q, k, n, rcap, **kw)
        got = csr.csr_candidate_topk(
            store.to(dev), starts.to(dev), ends.to(dev), q.to(dev), k, n, rcap,
            **{key: (v.to(dev) if isinstance(v, torch.Tensor) else v) for key, v in kw.items()})
        torch.cuda.synchronize()
        _hold(got, want, store, q, kw.get("metric", "l2"))


# name: (B, w, row_cap, d, k, n, spans, paper mode): the map's and
# random-s-100's windows (most slots empty), the phase-3 chunk's and the
# kNN-LM batch's (every slot valid), and windows of several prefix groups
CELL_SHAPES = {
    "map64k": (512, 128, 64, 2, 11, 200_000, "sparse", True),
    "rand100_k10": (512, 64, 64, 100, 10, 90_000, "sparse", False),
    "rand100_k100": (512, 64, 64, 100, 100, 90_000, "sparse", False),
    "phase3_chunk": (512, 64, 64, 128, 10, 200_000, "dense", False),
    "knn_lm_batch": (64, 32, 32, 4096, 16, 8192, "dense", False),
    "groups_d2": (64, 1100, 16, 2, 11, 40_000, "sparse", True),
    "groups_d40": (64, 1100, 16, 40, 300, 40_000, "sparse", False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(CELL_SHAPES))
def test_gpu_walk_cell_shapes(shape):
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk as csr

    b, w, rcap, d, k, n, spans, paper = CELL_SHAPES[shape]
    g = torch.Generator().manual_seed(sum(map(ord, shape)))
    if spans == "dense":
        starts = torch.randint(0, n - rcap + 1, (b, w), generator=g, dtype=torch.int32)
        ends = starts + rcap
    else:  # 70% of the window rows empty, the others up to a row and a bit
        starts = torch.randint(0, n, (b, w), generator=g, dtype=torch.int32)
        length = torch.randint(1, rcap + 9, (b, w), generator=g, dtype=torch.int32)
        ends = starts + torch.where(torch.rand((b, w), generator=g) < 0.7, 0, length)
    ends = ends.clamp_max(n).to(torch.int32)
    store = torch.randn((n, d), generator=g)
    q = torch.randn((b, d), generator=g)
    kw = {}
    if paper:
        store, q = store * 300.0 + 1500.0, q * 300.0 + 1500.0
        kw = dict(radii=torch.rand((b,), generator=g) * 400.0, center_cells=True)
    want = ref.csr_candidate_topk(store.to(dev), starts.to(dev), ends.to(dev), q.to(dev), k,
                                  n - 5, rcap, **{key: (v.to(dev) if isinstance(v, torch.Tensor)
                                                        else v) for key, v in kw.items()})
    got = csr.csr_candidate_topk(store.to(dev), starts.to(dev), ends.to(dev), q.to(dev), k,
                                 n - 5, rcap, **{key: (v.to(dev) if isinstance(v, torch.Tensor)
                                                       else v) for key, v in kw.items()})
    torch.cuda.synchronize()
    _hold(got, tuple(t.cpu() for t in want), store, q, "l2")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_gpu_hopper_gather_equals_hopper_on_sparse_windows(mode):
    """hopper_gather (the dense candidate kernel over every slot) equals
    hopper (the walk over the valid ones) field for field, on queries in
    the sparse land of a 2-D Gaussian, where most window slots are empty."""
    dev = require_cuda()
    from repro_torch import api
    from repro_torch.configs.paper_active_search import PAPER_GRID

    g = torch.Generator().manual_seed(31)
    pts = torch.randn((200_000, 2), generator=g).to(dev)
    labels = torch.randint(0, 3, (200_000,), generator=g, dtype=torch.int32).to(dev)
    s = api.ActiveSearcher.build(pts, labels=labels, cfg=PAPER_GRID,
                                 proj=api.identity_projection(pts), device=dev)
    q = (torch.rand((512, 2), generator=g) * 9.0 - 4.5).to(dev)
    want = s.search(q, 11, mode=mode)
    got = s.with_plan(backend="hopper_gather").search(q, 11, mode=mode)
    for field in want._fields:
        np.testing.assert_array_equal(np_(getattr(got, field)), np_(getattr(want, field)),
                                      err_msg=field)
