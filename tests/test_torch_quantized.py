"""The port's quantized candidate path (`hopper_q8`) against the JAX
package's (`pallas_q8`).

Same numpy points, the reference's test configuration (grid 64, window 8,
row_cap 4, N=256), a coordinate-selecting projection at d=8 so the two
indexes are equal array for array; the port loads the reference's index
through `index_from_numpy`.  On the CPU the port runs its plain versions
and the reference runs Pallas in interpret mode.  Tolerances: the int8
store, the shortlist's ids and scores, and every search field but `dists`
exact; `dists` within DIST_RTOL (the float32 re-rank sums in the
reference's XLA order); inside the port, bit-equal to `hopper`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_dists_close, assert_results_match, np_

from repro import api as japi
from repro.core.quantized import quantize_index as jquantize_index
from repro.kernels import ops as jops
from repro.utils import quantize as jquant
from repro_torch import api as tapi
from repro_torch.convert import index_from_numpy
from repro_torch.core import batched
from repro_torch.core.active_search import padded_csr, window_spans
from repro_torch.core.projection import to_grid_coords
from repro_torch.core.quantized import quantize_index
from repro_torch.kernels import ops, ref
from repro_torch.utils import quantize

CFG = dict(grid_size=64, tile=8, n_classes=3, window=8, row_cap=4, r0=4, k_slack=2.0)
N, B, K, D = 256, 8, 3, 8


def _indexes(seed=0, n=N, spread=1.0, **over):
    """(reference index, cfg, port index, cfg, points, queries) on the same
    numpy points; grid coordinates are dims 0 and 1."""
    kw = {**CFG, **over}
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, D)) * spread).astype(np.float32)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    mat = np.zeros((D, 2), np.float32)
    mat[0, 0] = mat[1, 1] = 1.0
    g = pts @ mat
    lo, hi = g.min(0) - 0.05, g.max(0) + 0.05
    jcfg, tcfg = japi.GridConfig(**kw), tapi.GridConfig(**kw)
    jidx = japi.build_index(jnp.asarray(pts), jcfg,
                            japi.Projection(jnp.asarray(mat), jnp.asarray(lo), jnp.asarray(hi)),
                            labels=jnp.asarray(labels))
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), tcfg, device="cpu")
    q = rng.normal(size=(B, D)).astype(np.float32) * spread
    q[:4, :2] = [[-9, -9], [9, 9], [-9, 9], [9, -9]]  # the grid's corners
    return jidx, jcfg, tidx, tcfg, q


@pytest.fixture(scope="module", params=["l2", "l1"])
def pair(request):
    """(reference searcher, port searcher, queries) on pallas / hopper."""
    jidx, jcfg, tidx, tcfg, q = _indexes(seed=1, metric=request.param)
    js = japi.ActiveSearcher.from_index(
        jidx, jcfg, plan=japi.ExecutionPlan(backend="pallas", interpret=True))
    ts = tapi.ActiveSearcher.from_index(tidx, tcfg, device="cpu")
    return js, ts, q


# ------------------------------------------------------------------ store ----


@pytest.mark.parametrize("n,spread", [(N, 1.0), (N, 0.05), (3, 1.0)])
def test_quantize_index_matches_reference(n, spread):
    """Every array of the store bit-equal, including the per-cell scales
    (the reference's jitted `/ 127` is a reciprocal multiply) and, at
    n < row_cap, the padded slack rows."""
    jidx, jcfg, tidx, tcfg, _ = _indexes(seed=2, n=n, spread=spread)
    want, got = jquantize_index(jidx, jcfg), quantize_index(tidx, tcfg)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), np_(getattr(got, field))
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def test_codec_matches_reference():
    """The int8 codec: codes equal the reference's (a true division, round
    half to even), and the round trip stays within half a step."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, 5)) * 3).astype(np.float32)
    x[0, :3] = [0.5, 1.5, -2.5]  # ties: half to even
    scale = np.float32(0.5) * np.ones((64, 1), np.float32)
    np.testing.assert_array_equal(
        np_(quantize.quantize_with_scale(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(jquant.quantize_with_scale(jnp.asarray(x), jnp.asarray(scale))))
    q, s = quantize.quantize_symmetric(torch.from_numpy(x))
    jq, js = jax.jit(jquant.quantize_symmetric)(jnp.asarray(x))
    np.testing.assert_array_equal(np_(q), np.asarray(jq))
    assert np_(s) == np.asarray(js)
    back = quantize.dequantize(q, s)
    assert back.dtype == torch.float32 and (back - torch.from_numpy(x)).abs().max() <= s / 2


# ------------------------------------------------------ csr_shortlist_q8 ----


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("d_chunk", [None, 1, 3])
def test_csr_shortlist_q8_matches_reference_exactly(metric, d_chunk):
    """Integer scoring: ids and scores bit-equal, l1 and l2, each chunking."""
    jidx, jcfg, tidx, tcfg, q = _indexes(seed=4, metric=metric)
    jstore, tstore = jquantize_index(jidx, jcfg), quantize_index(tidx, tcfg)
    st, en = window_spans(tidx, tcfg, to_grid_coords(tidx.proj, torch.from_numpy(q), 64))
    want = jops.csr_shortlist_q8(jstore.q_points, jstore.row_scales, jnp.asarray(np_(st)),
                                 jnp.asarray(np_(en)), jnp.asarray(q), 6, N, 4,
                                 metric=metric, d_chunk=d_chunk, interpret=True)
    got = ops.csr_shortlist_q8(tstore.q_points, tstore.row_scales, st, en,
                               torch.from_numpy(q), 6, N, 4, metric=metric, d_chunk=d_chunk)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np_(got[0]), np.asarray(want[0]))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_plain_csr_shortlist_q8_past_the_old_window_cap(metric):
    """ref.csr_shortlist_q8 at w*row_cap = 32,768 (past the old kernel's
    shared-memory cap) equals the reference's plain oracle bit for bit:
    starts clamped at the store's start and end, empty and overflowing
    spans, the live boundary."""
    from repro.kernels import ref as jref

    rng = np.random.default_rng(31)
    b, w, rcap, n, d = 2, 512, 64, 40_000, 4
    codes = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    scales = (rng.uniform(size=(n, 1)) * 0.05 + 0.001).astype(np.float32)
    scales[1000:1100] = scales[1000]  # a cell's rows share one scale
    q = (rng.normal(size=(b, d)) * 2.0).astype(np.float32)
    starts = rng.integers(-8, n, size=(b, w)).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, rcap + 8, size=(b, w)), n).astype(np.int32)
    args = (codes, scales, starts, ends, q, 40, n - 100, rcap)
    want = jref.csr_shortlist_q8(*(jnp.asarray(a) for a in args[:5]), *args[5:], metric=metric)
    got = ref.csr_shortlist_q8(*(torch.from_numpy(a) for a in args[:5]), *args[5:], metric=metric)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np_(got[0]), np.asarray(want[0]))


def test_q8_d_chunks_cap_the_int32_sum():
    assert ref.q8_d_chunks(1200, None) == [(0, 512), (512, 512), (1024, 176)]
    assert ref.q8_d_chunks(8, 3) == [(0, 3), (3, 3), (6, 2)]


def test_csr_shortlist_q8_rejects_bad_rerank_k():
    _, _, tidx, tcfg, q = _indexes(seed=5)
    store = quantize_index(tidx, tcfg)
    st, en = window_spans(tidx, tcfg, to_grid_coords(tidx.proj, torch.from_numpy(q), 64))
    for rk in (0, tcfg.window * tcfg.row_cap + 1):
        with pytest.raises(ValueError, match="rerank_k"):
            ops.csr_shortlist_q8(store.q_points, store.row_scales, st, en,
                                 torch.from_numpy(q), rk, N, tcfg.row_cap)


# --------------------------------------------------------- candidate_topk ----


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("d,d_chunk,k", [(9, 512, 5), (9, 3, 5), (9, 512, 40), (2, 512, 5)])
def test_candidate_topk_matches_reference(metric, d, d_chunk, k):
    """LOCAL slots exact (k > C pads with -1 / +inf); distances within
    DIST_RTOL (XLA sums a row of 9 in another order, and contracts the l2
    sum into an FMA), exact for l1 at d = 2."""
    rng = np.random.default_rng(6)
    cand = rng.normal(size=(7, 33, d)).astype(np.float32)
    valid = rng.uniform(size=(7, 33)) < 0.8
    valid[0] = False  # a lane with no valid candidate
    q = rng.normal(size=(7, d)).astype(np.float32)
    want = jops.candidate_topk(jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(q), k,
                               metric=metric, d_chunk=d_chunk, interpret=True)
    got = ops.candidate_topk(torch.from_numpy(cand), torch.from_numpy(valid),
                             torch.from_numpy(q), k, metric=metric, d_chunk=d_chunk)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    assert_dists_close(got[0], want[0])
    if d == 2 and metric == "l1":
        np.testing.assert_array_equal(np_(got[0]), np.asarray(want[0]))


@pytest.mark.parametrize("d_chunk", [None, 48])
def test_candidate_topk_sums_like_csr_candidate_topk(d_chunk):
    """The two plain versions rank the same row to the same float whatever
    the candidate count: the shortlist re-rank (C = rerank_k) and the fused
    window (C = w*row_cap) share one summation order at d = 128."""
    rng = np.random.default_rng(7)
    store = torch.from_numpy(rng.normal(size=(600, 128)).astype(np.float32))
    starts = torch.from_numpy(rng.integers(0, 500, size=(5, 6)).astype(np.int32))
    ends = starts + 16
    q = torch.from_numpy(rng.normal(size=(5, 128)).astype(np.float32))
    wd, wi = ref.csr_candidate_topk(store, starts, ends, q, 96, 600, 16, d_chunk=d_chunk)
    sub = wi[:, 3:40]  # a sub-list of rows, so C differs from the window's
    gd, gi = ref.candidate_topk(store[sub.long()], sub >= 0, q, 37, d_chunk=d_chunk or 128)
    assert torch.equal(gd, wd[:, 3:40])
    assert torch.equal(gi, torch.arange(37, dtype=torch.int32).expand(5, 37))


# ------------------------------------------ candidate_topk's staged walk ----

STAGE_TR, STAGE_TD, TOPK_CHUNK = 256, 32, 4096  # csrc/kernel_common.cuh


def _middle_out(i, n):
    """kernel_common.cuh's middle_out: the i-th of n tiles from the middle out."""
    h = (i + 1) >> 1
    return n // 2 - h if i & 1 else n // 2 + h


class _ChunkedSum:
    """kernel_common.cuh's ChunkedSum in float32, for a tile's rows at once
    (every row of a tile crosses the same chunk boundaries)."""

    def __init__(self, rows, d_chunk):
        self.acc = np.zeros(rows, np.float32)
        self.part = np.zeros(rows, np.float32)
        self.next, self.first = d_chunk, True

    def boundary(self, c, d_chunk):
        if c != self.next:
            return
        self.acc = self.part if self.first else self.acc + self.part
        self.first, self.part = False, np.zeros_like(self.part)
        self.next += d_chunk

    def add(self, x, q, l1):
        df = x - q
        self.part = self.part + (np.abs(df) if l1 else df * df)

    def finish(self, l1):
        acc = self.part if self.first else self.acc + self.part
        return acc if l1 else np.sqrt(np.maximum(acc, np.float32(0)))


def _offer(best, dists, slots, k):
    """The running list after a batch of offers: the k best finite (value,
    slot) pairs, smaller slot first on ties."""
    return sorted(best + [(v, s) for v, s in zip(dists.tolist(), slots.tolist())
                          if np.isfinite(v)])[:k]


def _emulated_candidate_topk(cand, valid, q, k, metric, d_chunk):
    """csrc/candidate_topk.cu's walk in numpy float32, step for step: at d
    >= STAGE_TD kernel_common.cuh's staged_rank (tiles of STAGE_TR slots
    middle-out, STAGE_TD-dim stages, ChunkedSum's folds where a d_chunk
    block ends inside a stage, offers after a tile's last stage); below it
    direct_rank (chunks of TOPK_CHUNK slots centred on the middle, each row
    summed alone)."""
    b, c, d = cand.shape
    dc, l1 = max(1, min(d_chunk, d)), metric == "l1"
    out_d = np.full((b, k), np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    for bi in range(b):
        best = []
        if d < STAGE_TD:
            steps = 2 * ((c - c // 2 + TOPK_CHUNK // 2 + TOPK_CHUNK - 1) // TOPK_CHUNK) + 1
            for ci in range(steps):
                kk = (ci + 1) // 2 if ci & 1 else -(ci // 2)
                lo = c // 2 - TOPK_CHUNK // 2 + kk * TOPK_CHUNK
                slots = np.arange(max(lo, 0), min(lo + TOPK_CHUNK, c))
                if slots.size == 0:
                    continue
                s = _ChunkedSum(slots.size, dc)
                for cc in range(d):
                    s.boundary(cc, dc)
                    s.add(cand[bi, slots, cc], q[bi, cc], l1)
                best = _offer(best, np.where(valid[bi, slots], s.finish(l1), np.inf), slots, k)
        else:
            ntiles, nd = -(-c // STAGE_TR), -(-d // STAGE_TD)
            for t in range(ntiles * nd):
                ti, c0 = t // nd, (t % nd) * STAGE_TD
                if c0 == 0:  # the tile's first stage locates its rows
                    slots = _middle_out(ti, ntiles) * STAGE_TR + np.arange(STAGE_TR)
                    slots = slots[slots < c]
                    rows = slots[valid[bi, slots]]
                    s = _ChunkedSum(rows.size, dc)
                dn = min(STAGE_TD, d - c0)
                stage = cand[bi, rows, c0:c0 + dn]  # the ring slot: one line of each row
                s.boundary(c0, dc)
                if dn == STAGE_TD and c0 + STAGE_TD <= s.next:  # a whole stage in one chunk
                    for g in range(STAGE_TD):
                        s.add(stage[:, g], q[bi, c0 + g], l1)
                else:
                    for cc in range(c0, c0 + dn):
                        s.boundary(cc, dc)
                        s.add(stage[:, cc - c0], q[bi, cc], l1)
                if c0 + dn == d:
                    best = _offer(best, s.finish(l1), rows, k)
        for j, (v, sl) in enumerate(best):
            out_d[bi, j], out_i[bi, j] = v, sl
    return out_d, out_i


def _sequential_candidate_topk(cand, valid, q, k, metric, d_chunk):
    """The kernels' chunked_distance written plainly: each row's terms in
    feature order, per d_chunk block, blocks folded in order; then the k
    best (distance, slot) pairs."""
    b, c, d = cand.shape
    dc = max(1, min(d_chunk, d))
    out_d = np.full((b, k), np.inf, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    for bi in range(b):
        acc = None
        for c0 in range(0, d, dc):
            part = np.zeros(c, np.float32)
            for cc in range(c0, min(c0 + dc, d)):
                df = cand[bi, :, cc] - q[bi, cc]
                part = part + (np.abs(df) if metric == "l1" else df * df)
            acc = part if acc is None else acc + part
        dist = acc if metric == "l1" else np.sqrt(np.maximum(acc, np.float32(0)))
        best = _offer([], np.where(valid[bi], dist, np.inf), np.arange(c), k)
        for j, (v, sl) in enumerate(best):
            out_d[bi, j], out_i[bi, j] = v, sl
    return out_d, out_i


@pytest.mark.parametrize("c,k", [(40, 10), (40, 43), (600, 10)])
@pytest.mark.parametrize("d_chunk", [5, 32, 512])
@pytest.mark.parametrize("d", [2, 37, 128])
def test_candidate_topk_staged_walk(d, d_chunk, c, k):
    """The staged kernel's order, emulated, ranks as every version does:
    one partial tile (C = 40, the q8 re-rank's size, with k past C) and
    three tiles (C = 600), rows invalid throughout and a query with none.
    Distances and slots bit-equal to the kernels' chunked_distance order
    (hence to csr_candidate_topk on the same rows); slots equal to
    ref.candidate_topk's and the JAX kernel's (interpret mode), distances
    within DIST_RTOL (both sum a row of d > 2 in another order), exact at
    d = 2."""
    rng = np.random.default_rng(d * 1000 + d_chunk + c + k)
    cand = rng.normal(size=(3, c, d)).astype(np.float32)
    valid = rng.uniform(size=(3, c)) < 0.7
    valid[1] = False  # a query with no valid candidate
    q = rng.normal(size=(3, d)).astype(np.float32)
    got_d, got_i = _emulated_candidate_topk(cand, valid, q, k, "l2", d_chunk)
    seq_d, seq_i = _sequential_candidate_topk(cand, valid, q, k, "l2", d_chunk)
    np.testing.assert_array_equal(got_i, seq_i)
    np.testing.assert_array_equal(got_d, seq_d)
    want = ref.candidate_topk(torch.from_numpy(cand), torch.from_numpy(valid),
                              torch.from_numpy(q), k, d_chunk=d_chunk)
    np.testing.assert_array_equal(got_i, np_(want[1]))
    assert_dists_close(got_d, want[0])
    if d == 2:
        np.testing.assert_array_equal(got_d, np_(want[0]))
    jd, ji = jops.candidate_topk(jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(q), k,
                                 d_chunk=d_chunk, interpret=True)
    np.testing.assert_array_equal(got_i, np.asarray(ji))
    assert_dists_close(got_d, np.asarray(jd))


# ---------------------------------------------------------------- backend ----


@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_hopper_q8_search_matches_reference(pair, mode):
    js, ts, q = pair
    got = ts.with_plan(backend="hopper_q8").search(q, K, mode=mode)
    assert_results_match(got, js.with_plan(backend="pallas_q8").search(jnp.asarray(q), K, mode=mode))


@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_hopper_q8_classify_matches_reference(pair, mode):
    js, ts, q = pair
    got = ts.with_plan(backend="hopper_q8").classify(q, K, mode=mode)
    want = js.with_plan(backend="pallas_q8").classify(jnp.asarray(q), K, mode=mode)
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    counts = ts.with_plan(backend="hopper_q8").count_at(q, np.full(B, 4, np.int32))
    np.testing.assert_array_equal(np_(counts), np_(ts.count_at(q, np.full(B, 4, np.int32))))


def _assert_lanes_equal(a, b, lanes, msg):
    for field in a._fields:
        assert torch.equal(getattr(a, field)[lanes], getattr(b, field)[lanes]), (msg, field)


@pytest.mark.parametrize("d_chunk", [None, 3])
@pytest.mark.parametrize("spread", [0.02, 1.5])
def test_hopper_q8_containment_implies_bit_parity(pair, d_chunk, spread):
    """A full-window shortlist is bit-equal to `hopper` on every lane; at the
    default rerank_k, so is every lane whose shortlist holds hopper's
    top-k (rows of the shortlist mapped to ids)."""
    _, ts, _ = pair
    cfg = ts.cfg
    _, _, tidx, _, q = _indexes(seed=8, spread=spread, metric=cfg.metric)
    s = tapi.ActiveSearcher.from_index(tidx, cfg, device="cpu").with_plan(d_chunk=d_chunk)
    exact = s.search(q, K)
    q8 = s.with_plan(backend="hopper_q8")
    full = q8.with_plan(rerank_k=cfg.window * cfg.row_cap).search(q, K)
    _assert_lanes_equal(exact, full, torch.arange(B), "full window")

    rk = batched.resolve_rerank_k(cfg, K, None)
    _, sl = batched.q8_shortlist(tidx, q8._quantized_store, cfg, torch.from_numpy(q), rk,
                                 d_chunk=d_chunk)
    ids = padded_csr(tidx, cfg.row_cap)[3]
    sl_ids = torch.where(sl >= 0, ids[sl.clamp_min(0).long()], torch.full_like(sl, -2))
    covered = ((exact.ids[:, :, None] == sl_ids[:, None, :]).any(-1) | ~exact.valid).all(-1)
    assert bool(covered.any())
    _assert_lanes_equal(exact, q8.search(q, K), covered, "covered")


def test_hopper_q8_chunked_and_memoised(pair):
    _, ts, q = pair
    s = ts.with_plan(backend="hopper_q8")
    whole = s.search(q, K)
    _assert_lanes_equal(whole, s.with_plan(chunk_size=3).search(q, K), torch.arange(B), "chunked")
    assert "_quantized_store" in s.__dict__


def test_rerank_k_plan_checks(pair):
    _, ts, q = pair
    with pytest.raises(ValueError, match="positive"):
        tapi.ExecutionPlan(rerank_k=0)
    with pytest.raises(ValueError, match="supports_quantized"):
        ts.with_plan(rerank_k=8).search(q, K)
    with pytest.raises(ValueError, match="rerank_k=2 < k=3"):
        ts.with_plan(backend="hopper_q8", rerank_k=2).search(q, K)
    switched = ts.with_plan(backend="hopper_q8", rerank_k=8).with_plan(backend="hopper")
    assert switched.plan.rerank_k is None
    kept = ts.with_plan(backend="hopper_q8", rerank_k=8, d_chunk=2).with_plan(backend="hopper_gather")
    assert kept.plan.rerank_k is None and kept.plan.d_chunk == 2
    impl = tapi.get_backend("hopper_q8")
    assert impl.supports_quantized and impl.supports_d_chunk and impl.supports_adaptive_r0
