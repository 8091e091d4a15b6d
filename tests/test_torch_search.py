"""The port's main path through the facade against the JAX package's.

`repro_torch.api.ActiveSearcher` on backend `hopper` (plain kernel versions
on the CPU) against `repro.api.ActiveSearcher` on backend `pallas` (Pallas
kernels in interpret mode), and `exact` against `exact`.  Both build from
the same numpy points under the identity projection, where the two
indexes are equal array for array.  Eq.-1 stats, ids, labels and classes
are exact; distances within DIST_RTOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_dists_close, assert_results_match, np_

from repro import api as japi
from repro.core import batched as jbatched
from repro_torch import api as tapi
from repro_torch.convert import index_from_numpy
from repro_torch.core import batched

K = 5
CFG = dict(grid_size=64, tile=8, n_classes=3, window=16, row_cap=16, r0=6)


def _points(seed, n=1500, d=2):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    q = rng.normal(size=(36, d)).astype(np.float32)
    # far-out queries clip to the grid's corners and edges
    far = np.zeros((4, d), np.float32)
    far[:, :2] = [[-9, -9], [9, 9], [-9, 9], [9, 0]]
    return pts, labels, np.concatenate([q, far])


def _pair(seed=0, **over):
    """(reference searcher, port searcher, queries) on the same points."""
    kw = {**CFG, **over}
    pts, labels, q = _points(seed)
    js = japi.ActiveSearcher.build(
        jnp.asarray(pts), labels=jnp.asarray(labels), cfg=japi.GridConfig(**kw),
        proj=japi.identity_projection(jnp.asarray(pts)),
        plan=japi.ExecutionPlan(backend="pallas", interpret=True),
    )
    ts = tapi.ActiveSearcher.build(
        pts, labels=labels, cfg=tapi.GridConfig(**kw),
        proj=tapi.identity_projection(torch.from_numpy(pts)), device="cpu",
    )
    return js, ts, q


@pytest.fixture(scope="module")
def l2_pair():
    return _pair(seed=0)


@pytest.fixture(scope="module")
def l1_pair():
    return _pair(seed=1, metric="l1", k_slack=2.0)


@pytest.mark.parametrize("mode", ["refined", "paper"])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_search_matches_reference(request, mode, metric):
    js, ts, q = request.getfixturevalue(f"{metric}_pair")
    assert_results_match(ts.search(q, K, mode=mode), js.search(jnp.asarray(q), K, mode=mode))


@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_classify_matches_reference(l2_pair, mode):
    js, ts, q = l2_pair
    got = ts.classify(q, K, mode=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np.asarray(js.classify(jnp.asarray(q), K, mode=mode)))


def test_count_at_matches_reference(l1_pair):
    js, ts, q = l1_pair
    radii = np.random.default_rng(2).integers(0, 64, size=len(q)).astype(np.int32)
    got = ts.count_at(q, radii)
    np.testing.assert_array_equal(np_(got), np.asarray(js.count_at(jnp.asarray(q), radii)))


def test_exact_backend_matches_reference(l2_pair):
    js, ts, q = l2_pair
    je, te = js.with_plan(backend="exact"), ts.with_plan(backend="exact")
    got, want = te.search(q, 7), je.search(jnp.asarray(q), 7)
    assert_results_match(got._replace(dists=want.dists), want)
    # ‖q‖² − 2q·x + ‖x‖² cancels: each side's product sums in its own order,
    # so the squared distances agree to a few float32 ulps of ‖q‖² + ‖x‖²,
    # not relatively
    pts = np_(ts.index.points_sorted)
    scale = (q * q).sum(1)[:, None] + (pts * pts).sum(1).max()
    err = np.abs(np_(got.dists) ** 2 - np.asarray(want.dists) ** 2)
    assert (err <= 8 * np.finfo(np.float32).eps * scale).all(), err.max()
    np.testing.assert_array_equal(np_(te.classify(q, 7)),
                                  np.asarray(je.classify(jnp.asarray(q), 7)))


def test_exact_blocked_streaming_matches_one_block():
    """More points than one block: the streaming top-k equals one pass."""
    from repro_torch.core import exact

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(700, 3)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(9, 3)).astype(np.float32))
    one = exact.knn(q, x, 6)
    streamed = exact.knn(q, x, 6, block=64)
    assert torch.equal(one.ids, streamed.ids)
    assert torch.equal(one.dists, streamed.dists)


def test_adaptive_r0_matches_reference(l2_pair):
    js, ts, q = l2_pair
    jq = jnp.asarray(q)
    got = ts.with_plan(adaptive_r0=True).search(q, K)
    assert_results_match(got, js.with_plan(adaptive_r0=True).search(jq, K))


@pytest.mark.parametrize("adaptive_r0", [True, False])
def test_radius_loop_stats_match_reference(l2_pair, adaptive_r0):
    """radius, count, iters, converged and, through `ref.dmas_skipped`,
    tile_dmas_skipped, lane for lane, from the global r0 and from the
    pyramid-seeded start radii."""
    js, ts, q = l2_pair
    from repro.core import projection as jproj

    jgrid = jproj.to_grid_coords(js.index.proj, jnp.asarray(q), js.cfg.grid_size)
    want = jbatched.radius_search_batched(js.index, js.cfg, jgrid, K, True,
                                          adaptive_r0=adaptive_r0)
    tgrid = torch.from_numpy(np.asarray(jgrid))
    got = batched.radius_search_batched(ts.index, ts.cfg, tgrid, K, adaptive_r0=adaptive_r0)
    assert set(got) | {"tile_dmas_skipped"} == set(want)
    for key in want:
        np.testing.assert_array_equal(np_(with_dmas(got)[key]), np.asarray(want[key]),
                                      err_msg=key)


STATS = ("radius", "count", "iters", "converged", "tile_dmas_skipped")


def with_dmas(stats: dict, early_exit: bool = True) -> dict:
    """The loop's four outputs and the reference's tile_dmas_skipped,
    which `ref.dmas_skipped` computes from them."""
    from repro_torch.kernels import ref

    assert "tile_dmas_skipped" not in stats
    return {**stats, "tile_dmas_skipped": ref.dmas_skipped(stats["iters"], stats["converged"],
                                                           early_exit)}


def _reference_loop(js, q, k, **kw):
    """(reference stats, its grid coordinates as a torch tensor)."""
    from repro.core import projection as jproj

    jgrid = jproj.to_grid_coords(js.index.proj, jnp.asarray(q), js.cfg.grid_size)
    want = jbatched.radius_search_batched(js.index, js.cfg, jgrid, k, True, **kw)
    return want, torch.from_numpy(np.array(jgrid))


def _assert_stats_equal(got, want):
    assert set(got) == set(want) == set(STATS)
    for key in STATS:
        np.testing.assert_array_equal(np_(got[key]), np.asarray(want[key]), err_msg=key)
        assert np_(got[key]).dtype == np.asarray(want[key]).dtype, key


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("adaptive_r0", [False, True])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_plain_radius_loop_matches_reference(request, metric, adaptive_r0, early_exit):
    """ref.radius_search_loop (the loop kernel's plain version, on the
    index's tile array) and radius_search_batched against the reference's
    radius_search_batched: all five stats exact (radius_search_batched's
    tile_dmas_skipped through `ref.dmas_skipped`), at PAPER_GRID's
    max_iters = 16 with lanes that never converge."""
    from repro_torch.core import pyramid
    from repro_torch.kernels import ref

    js, ts, q = request.getfixturevalue(f"{metric}_pair")
    cfg = ts.cfg
    assert cfg.max_iters == 16
    want, tgrid = _reference_loop(js, q, K, adaptive_r0=adaptive_r0, early_exit=early_exit)
    never = (np.asarray(want["iters"]) == cfg.max_iters) & ~np.asarray(want["converged"])
    assert never.any() and np.asarray(want["converged"]).any()
    r0 = (pyramid.seed_radius(ts.index, cfg, tgrid, K) if adaptive_r0
          else torch.full((len(q),), cfg.r0, dtype=torch.int32))
    k_hi = max(K, int(np.ceil(K * cfg.k_slack)))
    got = ref.radius_search_loop(ts.index.pyr_tiles, tgrid, r0, K, k_hi, cfg.max_radius,
                                 cfg.max_iters, cfg.tile, cfg.level_nblks, metric=cfg.metric,
                                 early_exit=early_exit)
    _assert_stats_equal(got, want)
    _assert_stats_equal(with_dmas(batched.radius_search_batched(
        ts.index, cfg, tgrid, K, adaptive_r0=adaptive_r0, early_exit=early_exit),
        early_exit), want)


@pytest.mark.parametrize("early_exit", [True, False])
def test_plain_radius_loop_empty_batch(l2_pair, early_exit):
    """B = 0: empty stats of the reference's dtypes and tile_dmas_skipped
    0 (the reference's Pallas count raises on an empty batch, so its dtypes
    come from a one-query call)."""
    js, ts, q = l2_pair
    want, _ = _reference_loop(js, q[:1], K, early_exit=early_exit)
    got = with_dmas(batched.radius_search_batched(ts.index, ts.cfg, torch.zeros((0, 2)), K,
                                                  early_exit=early_exit), early_exit)
    assert set(got) == set(STATS)
    for key in STATS:
        w = np.asarray(want[key])
        assert np_(got[key]).dtype == w.dtype and np_(got[key]).shape == (0,) * w.ndim, key
    assert int(got["tile_dmas_skipped"]) == 0


@pytest.mark.parametrize("adaptive_r0", [False, True])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_dma_skip_identity_holds_on_reference(request, metric, adaptive_r0):
    """`ref.dmas_skipped`, from per-lane outputs alone:
    4 * sum(max iters - iters) + 4 * sum(converged) equals the reference's
    lock-step tile_dmas_skipped."""
    from repro_torch.kernels import ref

    js, _, q = request.getfixturevalue(f"{metric}_pair")
    want, _ = _reference_loop(js, q, K, adaptive_r0=adaptive_r0)
    it = np.asarray(want["iters"]).astype(np.int64)
    conv = np.asarray(want["converged"]).astype(np.int64)
    assert 4 * (it.max() - it).sum() + 4 * conv.sum() == int(want["tile_dmas_skipped"]) > 0
    got = ref.dmas_skipped(torch.from_numpy(np.asarray(want["iters"])),
                           torch.from_numpy(np.asarray(want["converged"])))
    assert got.dtype == torch.int32 and int(got) == int(want["tile_dmas_skipped"])


@pytest.mark.parametrize("counter", ["pyramid", "sat"])
def test_radius_search_calls_the_loop_dispatch_once(monkeypatch, counter):
    """The pyramid counter reaches ops.radius_search_loop exactly once per
    radius_search_batched call (once per chunk of a search); the sat
    counter keeps its host loop and never calls it."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.radius_search_loop

    def spy(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "radius_search_loop", spy)
    _, ts, q = _pair(seed=4, counter=counter, k_slack=2.0)
    grid = batched.proj_lib.to_grid_coords(ts.index.proj, torch.from_numpy(q), ts.cfg.grid_size)
    batched.radius_search_batched(ts.index, ts.cfg, grid, K)
    ts.with_plan(chunk_size=16).search(q, K)
    assert calls == ([len(q), 16, 16, 16] if counter == "pyramid" else [])


def test_chunked_search_matches_reference(l2_pair):
    """chunk_size that does not divide B: the padded last chunk is sliced off."""
    js, ts, q = l2_pair
    got = ts.with_plan(chunk_size=16).search(q, K)
    assert_results_match(got, js.search(jnp.asarray(q), K))
    np.testing.assert_array_equal(np_(ts.with_plan(chunk_size=7).classify(q, K)),
                                  np_(ts.classify(q, K)))


def test_empty_batch_matches_reference_shapes(l2_pair):
    js, ts, q = l2_pair
    empty = np.zeros((0, 2), np.float32)
    assert_results_match(ts.search(empty, K), js.search(jnp.asarray(empty), K))
    got_c = ts.with_plan(chunk_size=4).classify(empty, K)
    want_c = np.asarray(js.classify(jnp.asarray(empty), K))
    assert np_(got_c).shape == want_c.shape and np_(got_c).dtype == want_c.dtype
    got_n = ts.count_at(empty, np.zeros((0,), np.int32))
    want_n = np.asarray(js.count_at(jnp.asarray(empty), np.zeros((0,), np.int32)))
    assert np_(got_n).shape == want_n.shape and np_(got_n).dtype == want_n.dtype


def test_sat_counter_matches_reference():
    js, ts, q = _pair(seed=4, counter="sat", k_slack=2.0)
    jq = jnp.asarray(q)
    assert_results_match(ts.search(q, K), js.search(jq, K))
    np.testing.assert_array_equal(np_(ts.classify(q, K, mode="paper")),
                                  np.asarray(js.classify(jq, K, mode="paper")))


def test_k_exceeds_candidate_window():
    js, ts, q = _pair(seed=5, window=4, row_cap=4, r0=2)
    assert_results_match(ts.search(q, 20), js.search(jnp.asarray(q), 20))


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_d6_coordinate_projection_via_index_from_numpy(metric):
    """d = 6 with a coordinate-selecting projection (one 1.0 per column, so
    the projection product is exact on both sides): the reference builds,
    the port loads the index through index_from_numpy, and both search —
    also with a d_chunk that splits the distance sum."""
    pts, labels, q = _points(6, d=6)
    mat = np.zeros((6, 2), np.float32)
    mat[2, 0] = mat[4, 1] = 1.0
    g = pts @ mat
    lo, hi = g.min(0) - 0.05, g.max(0) + 0.05
    kw = {**CFG, "metric": metric, "k_slack": 2.0}
    jcfg = japi.GridConfig(**kw)
    jidx = japi.build_index(jnp.asarray(pts), jcfg,
                            japi.Projection(jnp.asarray(mat), jnp.asarray(lo), jnp.asarray(hi)),
                            labels=jnp.asarray(labels))
    tcfg = tapi.GridConfig(**kw)
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), tcfg, device="cpu")
    plan = japi.ExecutionPlan(backend="pallas", interpret=True)
    js = japi.ActiveSearcher.from_index(jidx, jcfg, plan=plan)
    ts = tapi.ActiveSearcher.from_index(tidx, tcfg, device="cpu")
    jq = jnp.asarray(q)
    assert_results_match(ts.search(q, K), js.search(jq, K))
    d = ts.with_plan(d_chunk=4).search(q, K)
    want = js.with_plan(d_chunk=4).search(jq, K)
    np.testing.assert_array_equal(np_(d.ids), np.asarray(want.ids))
    assert_dists_close(d.dists, want.dists)


# -------------------------------------------------------------- the facade ----


def test_registered_backends():
    assert tapi.registered_backends() == (
        "exact", "hopper", "hopper_gather", "hopper_q8", "hopper_stacked", "sharded", "torch")
    assert tapi.ExecutionPlan().backend == "hopper"


@pytest.mark.parametrize("kw", [dict(chunk_size=0), dict(d_chunk=-1)])
def test_plan_rejects_non_positive_sizes(kw):
    with pytest.raises(ValueError, match="positive"):
        tapi.ExecutionPlan(**kw)


def test_plan_capabilities_checked_eagerly(l2_pair):
    _, ts, q = l2_pair
    with pytest.raises(ValueError, match="d_chunk"):
        ts.with_plan(tapi.ExecutionPlan(backend="exact", d_chunk=2)).search(q, K)
    with pytest.raises(ValueError, match="adaptive_r0"):
        ts.with_plan(tapi.ExecutionPlan(backend="exact", adaptive_r0=True)).search(q, K)
    with pytest.raises(ValueError, match="does not implement"):
        ts.with_plan(backend="exact").count_at(q, np.ones(len(q), np.int32))
    with pytest.raises(ValueError, match="unknown backend"):
        ts.with_plan(backend="pallas").search(q, K)
    with pytest.raises(ValueError, match="unknown mode"):
        ts.search(q, K, mode="fast")
    # switching backend drops the knobs the new backend does not take
    switched = ts.with_plan(d_chunk=2, adaptive_r0=True).with_plan(backend="exact")
    assert switched.plan.d_chunk is None and switched.plan.adaptive_r0 is False


def test_classify_needs_classes():
    _, ts, q = _pair(seed=7, n_classes=0)
    with pytest.raises(ValueError, match="n_classes"):
        ts.classify(q, K)


def test_stats_match_reference(l2_pair):
    js, ts, _ = l2_pair
    got, want = ts.stats(), js.stats()
    for key in ("n_points", "dim", "grid_size", "padded_size", "levels",
                "n_classes", "metric", "counter", "pyramid_bytes",
                "pyr_tiles_bytes", "csr_bytes"):
        assert got[key] == want[key], key
    assert got["backend"] == "hopper" and got["device"] == "cpu"


def test_from_index_lays_out_missing_tiles(l2_pair):
    _, ts, q = l2_pair
    bare = ts.index._replace(pyr_tiles=None)
    with pytest.raises(ValueError, match="pyr_tiles"):
        batched.batched_counts(bare, ts.cfg, torch.zeros((1, 2)), torch.ones((1,), dtype=torch.int32))
    again = tapi.ActiveSearcher.from_index(bare, ts.cfg, device="cpu")
    assert torch.equal(again.index.pyr_tiles, ts.index.pyr_tiles)
