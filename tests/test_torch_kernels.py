"""The port's kernels against the JAX package's.

On the CPU each port wrapper runs its plain PyTorch version
(repro_torch/kernels/ref.py); it is held against the reference's Pallas
kernels, run in interpret mode as the reference's own tests run them.
Counts and selected indices are exact; f32 distances within DIST_RTOL.
The `gpu` cases hold each Hopper kernel against its plain version on the
card and skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_dists_close, assert_ids_equal_up_to_ties, np_, require_cuda

from repro.core import batched as jbatched
from repro.core import pyramid as jpyr
from repro.core.grid import GridConfig as JGridConfig
from repro.core.grid import build_index as jbuild_index
from repro.core.projection import identity_projection as jidentity
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

# ------------------------------------------------------------ tile counts ----


def _pyramid_fixture(seed=0, grid=64, tile=8, c=3, n=800):
    rng = np.random.default_rng(seed)
    pts = jnp.asarray(rng.normal(size=(n, 2)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, c, size=n), jnp.int32)
    cfg = JGridConfig(grid_size=grid, tile=tile, n_classes=c, r0=8)
    idx = jbuild_index(pts, cfg, jidentity(pts), labels=labels)
    return cfg, idx, rng


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("s,tile,c", [(32, 8, 1), (64, 16, 3), (64, 8, 4)])
@pytest.mark.parametrize("scale", [1, 4])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_plain_tile_count_matches_reference(s, tile, c, scale, metric):
    rng = np.random.default_rng(s + tile + c + scale)
    level = rng.integers(0, 5, size=(s, s, c)).astype(np.int32)
    q = rng.uniform(0, s * scale, size=(9, 2)).astype(np.float32)
    r = rng.uniform(0.5, scale * (tile / 2 - 1.5), size=(9,)).astype(np.float32)
    want = jref.tile_count(jnp.asarray(level), jnp.asarray(q), jnp.asarray(r),
                           scale, tile, metric=metric)
    got = ref.tile_count(_t(level), _t(q), _t(r), scale, tile, metric=metric)
    np.testing.assert_array_equal(np_(got), np_(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_tile_count_multilevel_matches_reference_kernel(metric):
    """Radii spanning every pyramid level, integer as on the main path."""
    cfg, idx, rng = _pyramid_fixture(seed=1)
    b = 24
    q = rng.uniform(0, cfg.padded_size, size=(b, 2)).astype(np.float32)
    r = rng.integers(0, cfg.max_radius + 1, size=(b,)).astype(np.int32)
    lv = jpyr.level_for_radius(jnp.asarray(r), cfg)
    want = jops.tile_count_multilevel(
        idx.pyr_tiles, jnp.asarray(q), jnp.asarray(r, jnp.float32), lv,
        cfg.tile, cfg.level_nblks, metric=metric, interpret=True,
    )
    got = ops.tile_count_multilevel(
        _t(idx.pyr_tiles), _t(q), _t(r).float(), _t(lv), cfg.tile,
        cfg.level_nblks, metric=metric,
    )
    np.testing.assert_array_equal(np_(got), np_(want))


def test_tile_count_multilevel_forced_levels_and_corners():
    """Level is an input: every query forced to each level in turn, with
    grid-corner queries where the window clamps, against the reference's
    single-level count."""
    cfg, idx, rng = _pyramid_fixture(seed=2)
    g = cfg.padded_size
    corners = np.array([[0, 0], [g - 1e-3, g - 1e-3], [0, g - 1e-3],
                        [g - 1e-3, 0], [g / 2, 0]], np.float32)
    q = np.concatenate([corners, rng.uniform(0, g, size=(7, 2)).astype(np.float32)])
    r = rng.uniform(0.5, cfg.max_radius / 2, size=(len(q),)).astype(np.float32)
    for lv in range(cfg.levels):
        levels = np.full((len(q),), lv, np.int32)
        want = jref.tile_count(idx.pyramid[lv], jnp.asarray(q), jnp.asarray(r),
                               1 << lv, cfg.tile)
        got = ref.tile_count_multilevel(_t(idx.pyr_tiles), _t(q), _t(r), _t(levels),
                                        cfg.tile, cfg.level_nblks)
        np.testing.assert_array_equal(np_(got), np_(want), err_msg=f"level {lv}")


def test_tile_count_multilevel_active_mask():
    """Parked lanes give 0; live lanes equal the unmasked reference."""
    cfg, idx, rng = _pyramid_fixture(seed=3)
    b = 16
    q = rng.uniform(0, cfg.padded_size, size=(b, 2)).astype(np.float32)
    r = rng.integers(1, cfg.max_radius, size=(b,)).astype(np.int32)
    active = rng.uniform(size=b) < 0.5
    lv = jpyr.level_for_radius(jnp.asarray(r), cfg)
    want = jops.tile_count_multilevel(
        idx.pyr_tiles, jnp.asarray(q), jnp.asarray(r, jnp.float32), lv,
        cfg.tile, cfg.level_nblks, interpret=True, active=jnp.asarray(active),
    )
    got = ops.tile_count_multilevel(
        _t(idx.pyr_tiles), _t(q), _t(r).float(), _t(lv), cfg.tile,
        cfg.level_nblks, active=_t(active),
    )
    np.testing.assert_array_equal(np_(got), np_(want))
    assert (np_(got)[~active] == 0).all()


def test_tile_count_multilevel_max_radius_top_level():
    """r == max_radius counts the whole top level's circle."""
    cfg, idx, rng = _pyramid_fixture(seed=4)
    q = rng.uniform(0, cfg.padded_size, size=(5, 2)).astype(np.float32)
    r = np.full((5,), cfg.max_radius, np.int32)
    lv = jpyr.level_for_radius(jnp.asarray(r), cfg)
    assert int(lv[0]) == cfg.levels - 1
    want = jref.tile_count_multilevel(idx.pyramid, jnp.asarray(q),
                                      jnp.asarray(r, jnp.float32), lv, cfg.tile)
    got = ref.tile_count_multilevel(_t(idx.pyr_tiles), _t(q), _t(r).float(),
                                    _t(lv), cfg.tile, cfg.level_nblks)
    np.testing.assert_array_equal(np_(got), np_(want))


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_counts_take_forty_channels(metric):
    """n_classes = 40, past 32 count channels: both count paths against the
    reference's kernels in interpret mode, exact."""
    cfg, idx, rng = _pyramid_fixture(seed=5, c=40, n=1500)
    b = 12
    q = rng.uniform(0, cfg.padded_size, size=(b, 2)).astype(np.float32)
    r = rng.integers(0, cfg.max_radius + 1, size=(b,)).astype(np.int32)
    lv = jpyr.level_for_radius(jnp.asarray(r), cfg)
    want = jops.tile_count_multilevel(
        idx.pyr_tiles, jnp.asarray(q), jnp.asarray(r, jnp.float32), lv,
        cfg.tile, cfg.level_nblks, metric=metric, interpret=True,
    )
    got = ops.tile_count_multilevel(
        _t(idx.pyr_tiles), _t(q), _t(r).float(), _t(lv), cfg.tile,
        cfg.level_nblks, metric=metric,
    )
    assert got.shape == (b, 40)
    np.testing.assert_array_equal(np_(got), np_(want))
    for level in (0, 2):
        rf = r.astype(np.float32) / 2
        want = jops.tile_count(idx.pyramid[level], jnp.asarray(q), jnp.asarray(rf), 1 << level,
                               cfg.tile, metric=metric, interpret=True)
        got = ops.tile_count(_t(idx.pyramid[level]), _t(q), _t(rf), 1 << level, cfg.tile,
                             metric=metric)
        np.testing.assert_array_equal(np_(got), np_(want), err_msg=f"level {level}")


def test_tile_count_multilevel_bad_layout_raises():
    cfg, idx, _ = _pyramid_fixture()
    with pytest.raises(ValueError, match="tiles shape"):
        ops.tile_count_multilevel(
            _t(idx.pyr_tiles)[:-1], torch.zeros((1, 2)), torch.ones((1,)),
            torch.zeros((1,), dtype=torch.int32), cfg.tile, cfg.level_nblks,
        )


def _loop_fixture(metric, c=3):
    """A reference index with a dense cluster (lanes there shrink to r = 1
    and never converge), a sparse cluster across an empty quadrant (lanes
    there see n = 0 and double), and queries on both and between."""
    rng = np.random.default_rng(9)
    dense = rng.normal(scale=1e-3, size=(600, 2)) - 1.0
    sparse = rng.uniform(0.0, 1.0, size=(300, 2))
    pts = jnp.asarray(np.concatenate([dense, sparse]), jnp.float32)
    labels = jnp.asarray(rng.integers(0, c, size=pts.shape[0]), jnp.int32)
    cfg = JGridConfig(grid_size=64, tile=8, n_classes=c, r0=8, metric=metric)
    idx = jbuild_index(pts, cfg, jidentity(pts), labels=labels)
    q = np.concatenate([np.full((4, 2), -1.0), [[1.0, -1.0], [-1.0, 1.0], [0.5, 0.5]],
                        rng.uniform(-1, 1, size=(25, 2))]).astype(np.float32)
    from repro.core import projection as jproj

    return cfg, idx, jproj.to_grid_coords(idx.proj, jnp.asarray(q), cfg.grid_size)


@pytest.mark.parametrize("adaptive_r0", [False, True])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_plain_radius_search_loop_edge_cases_match_reference(metric, adaptive_r0, monkeypatch):
    """ref.radius_search_loop against the reference's radius_search_batched
    where radii clamp at 1 and reach r_max, counts are 0, and lanes run
    out of iterations: all five stats exact (a spy on its count records
    each pass's radii)."""
    from repro_torch.core import pyramid
    from repro_torch.core.grid import GridConfig

    cfg, idx, jgrid = _loop_fixture(metric)
    k = 5
    want = jbatched.radius_search_batched(idx, cfg, jgrid, k, True, adaptive_r0=adaptive_r0)
    tcfg = GridConfig(grid_size=64, tile=8, n_classes=3, r0=8, metric=metric)
    grid = _t(jgrid)
    if adaptive_r0:
        import jax

        from repro_torch.convert import index_from_numpy

        tidx = index_from_numpy(jax.tree.map(np.asarray, idx)._asdict(), tcfg, device="cpu")
        r0 = pyramid.seed_radius(tidx, tcfg, grid, k)
    else:
        r0 = torch.full((grid.shape[0],), cfg.r0, dtype=torch.int32)
    passes = []
    plain_count = ref.tile_count_multilevel

    def spy(tiles, queries, radii, *args, **kwargs):
        passes.append(radii)
        return plain_count(tiles, queries, radii, *args, **kwargs)

    monkeypatch.setattr(ref, "tile_count_multilevel", spy)
    got = ref.radius_search_loop(_t(idx.pyr_tiles), grid, r0, k, k, cfg.max_radius,
                                 cfg.max_iters, cfg.tile, cfg.level_nblks, metric=metric)
    for key in ("radius", "count", "iters", "converged", "tile_dmas_skipped"):
        np.testing.assert_array_equal(np_(got[key]), np_(want[key]), err_msg=key)
    # the helper's count from the per-lane outputs equals the pass-by-pass one
    assert torch.equal(ref.dmas_skipped(got["iters"], got["converged"]),
                       got["tile_dmas_skipped"])
    radius, iters, conv = np_(got["radius"]), np_(got["iters"]), np_(got["converged"])
    assert (radius == 1).any() and ((iters == cfg.max_iters) & ~conv).any() and conv.any()
    assert any(bool((r == cfg.max_radius).any()) for r in passes)
    assert len(passes) == iters.max() + 1


# ------------------------------------------------------ csr_candidate_topk ----


def _csr_fixture(seed, b=6, w=5, rcap=16, n=120, d=6):
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    starts = rng.integers(0, n - 4, size=(b, w)).astype(np.int32)
    # spans from empty through overflowing (end - start > rcap)
    ends = np.minimum(starts + rng.integers(0, rcap + 6, size=(b, w)), n).astype(np.int32)
    return store, starts, ends, q


def _both(store, starts, ends, q, k, n, rcap, **kw):
    """(port, reference-kernel) results on the same arrays."""
    jkw = dict(kw)
    tkw = dict(kw)
    if kw.get("radii") is not None:
        jkw["radii"] = jnp.asarray(kw["radii"])
        tkw["radii"] = _t(kw["radii"])
    want = jops.csr_candidate_topk(
        jnp.asarray(store), jnp.asarray(starts), jnp.asarray(ends), jnp.asarray(q),
        k, n, rcap, interpret=True, **jkw,
    )
    got = ops.csr_candidate_topk(_t(store), _t(starts), _t(ends), _t(q), k, n, rcap, **tkw)
    return got, want


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_csr_candidate_topk_refined_matches_reference(metric, k):
    store, starts, ends, q = _csr_fixture(seed=k)
    (gd, gi), (wd, wi) = _both(store, starts, ends, q, k, store.shape[0], 16,
                               metric=metric)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)
    assert gd.dtype == torch.float32 and gi.dtype == torch.int32


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_csr_candidate_topk_paper_mode_matches_reference(metric):
    """center_cells + radii: rank floor(coords)+0.5 cell centers, masked to
    the circle (d = 2, as the grid coordinates are)."""
    store, starts, ends, _ = _csr_fixture(seed=7, d=2)
    store = store * 8.0
    rng = np.random.default_rng(8)
    q = rng.uniform(-16, 16, size=(6, 2)).astype(np.float32)
    radii = rng.uniform(1.0, 12.0, size=(6,)).astype(np.float32)
    (gd, gi), (wd, wi) = _both(store, starts, ends, q, 4, store.shape[0], 16,
                               metric=metric, radii=radii, center_cells=True)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)


@pytest.mark.parametrize("d_chunk", [1, 4, 5])
def test_csr_candidate_topk_d_chunk_matches_reference(d_chunk):
    store, starts, ends, q = _csr_fixture(seed=11, d=11)
    (gd, gi), (wd, wi) = _both(store, starts, ends, q, 6, store.shape[0], 16,
                               d_chunk=d_chunk)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)


def test_csr_candidate_topk_k_exceeds_window():
    """k > w*row_cap: +inf / -1 pads."""
    store, starts, ends, q = _csr_fixture(seed=12, b=2, w=2, rcap=4)
    k = 2 * 4 + 3
    (gd, gi), (wd, wi) = _both(store, starts, ends, q, k, store.shape[0], 4)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)
    assert torch.isinf(gd[:, -3:]).all() and (gi[:, -3:] == -1).all()


def test_csr_candidate_topk_live_boundary():
    """Spans reaching past the live CSR length n never surface a pad row."""
    rng = np.random.default_rng(13)
    n_live, n_pad = 40, 64
    store = rng.normal(size=(n_pad, 4)).astype(np.float32)
    starts = np.array([[30, 38, 0]], np.int32)
    ends = np.array([[50, 64, 8]], np.int32)
    q = np.zeros((1, 4), np.float32)
    (gd, gi), (wd, wi) = _both(store, starts, ends, q, 32, n_live, 16)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)
    live = np_(gi)[np_(gi) >= 0]
    assert len(live) and (live < n_live).all()


def test_csr_candidate_topk_ties_take_lowest_slot():
    """Equal distances resolve to the earlier window slot."""
    store = np.zeros((32, 3), np.float32)
    starts = np.array([[8, 0]], np.int32)
    ends = np.array([[12, 4]], np.int32)
    q = np.zeros((1, 3), np.float32)
    (gd, gi), (wd, wi) = _both(store, starts, ends, q, 6, 32, 4)
    np.testing.assert_array_equal(np_(gi), np_(wi))
    np.testing.assert_array_equal(np_(gi)[0], [8, 9, 10, 11, 0, 1])


def test_csr_candidate_topk_store_too_small_raises():
    with pytest.raises(ValueError, match="row_cap"):
        ops.csr_candidate_topk(
            torch.zeros((2, 3)), torch.zeros((1, 2), dtype=torch.int32),
            torch.ones((1, 2), dtype=torch.int32), torch.zeros((1, 3)), 2, 2, 8,
        )


def _wide_window(seed, b=2, w=512, rcap=64, n=40_000, d=4):
    """Spans of a window of w*row_cap slots, past the old kernels' shared-
    memory cap (4*d + 8*w*row_cap > 232,448 bytes): empty through
    overflowing spans, starts clamped at the store's start and end."""
    rng = np.random.default_rng(seed)
    store = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    starts = rng.integers(-8, n, size=(b, w)).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, rcap + 8, size=(b, w)), n).astype(np.int32)
    return store, starts, ends, q


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_plain_csr_candidate_topk_past_the_old_window_cap(metric):
    """ref.csr_candidate_topk at w*row_cap = 32,768 equals the reference's
    plain oracle (ids exact, distances within DIST_RTOL)."""
    store, starts, ends, q = _wide_window(seed=30)
    assert 4 * 4 + 8 * 512 * 64 > 232_448
    want = jref.csr_candidate_topk(jnp.asarray(store), jnp.asarray(starts), jnp.asarray(ends),
                                   jnp.asarray(q), 20, store.shape[0] - 100, 64, metric=metric)
    got = ref.csr_candidate_topk(_t(store), _t(starts), _t(ends), _t(q), 20,
                                 store.shape[0] - 100, 64, metric=metric)
    np.testing.assert_array_equal(np_(got[1]), np.asarray(want[1]))
    assert_dists_close(got[0], want[0])


@pytest.mark.parametrize("which", ["csr_candidate_topk", "csr_candidate_topk_q8", "candidate_topk"])
def test_candidate_kernels_shared_bytes_do_not_grow_with_the_window(which):
    """The candidate kernels' shared memory depends on d (and the staging
    tile), not on the window: the same at 4,096 and 65,536 slots, and
    within a block's 232,448 bytes at d = 128."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{which}")
    if which == "candidate_topk":
        small, large = mod.shared_bytes(128, 4096), mod.shared_bytes(128, 65_536)
    else:
        small, large = mod.shared_bytes(128, 64, 64), mod.shared_bytes(128, 1024, 64)
    assert small == large <= 232_448


# --------------------------------------------------------------- the card ----


@pytest.mark.gpu
@pytest.mark.parametrize("c", [3, 40])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_gpu_tile_count_multilevel_kernel_matches_plain(metric, c):
    dev = require_cuda()
    from repro_torch.kernels import tile_count_multilevel as tcm

    cfg, idx, rng = _pyramid_fixture(seed=20, grid=128, tile=16, c=c)
    b = 512
    q = _t(rng.uniform(0, cfg.padded_size, size=(b, 2)).astype(np.float32))
    r = _t(rng.integers(0, cfg.max_radius + 1, size=(b,)).astype(np.int32))
    lv = _t(jpyr.level_for_radius(jnp.asarray(np_(r)), cfg))
    active = _t(rng.uniform(size=b) < 0.5)
    tiles = _t(idx.pyr_tiles)
    want = ref.tile_count_multilevel(tiles, q, r.float(), lv, cfg.tile,
                                     cfg.level_nblks, metric=metric, active=active)
    got = tcm.tile_count_multilevel(
        tiles.to(dev), q.to(dev), r.float().to(dev), lv.to(dev), cfg.tile,
        cfg.level_nblks, metric=metric, active=active.to(dev),
    )
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(got), np_(want))


@pytest.mark.gpu
@pytest.mark.parametrize("adaptive_r0", [False, True])
@pytest.mark.parametrize("c", [3, 40])
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("grid", ["PAPER_GRID", "PROD_GRID", "PROD_GRID_tile8"])
def test_gpu_radius_search_loop_kernel_matches_plain(grid, metric, c, adaptive_r0):
    """The loop kernel against ref.radius_search_loop on the card, at the
    paper's and the production pyramid shapes (and at T = 8, the kernel's
    instance for a tile side other than 16): all five stats exact, one
    launch."""
    import dataclasses

    dev = require_cuda()
    from repro_torch import api
    from repro_torch.configs import paper_active_search as configs
    from repro_torch.core import projection, pyramid
    from repro_torch.kernels import radius_search_loop as rsl

    name, _, tile8 = grid.partition("_tile")
    cfg = dataclasses.replace(getattr(configs, name), n_classes=c, metric=metric,
                              tile=8 if tile8 else 16)
    gen = torch.Generator(device=dev).manual_seed(c)
    pts = torch.randn((200_000, 2), generator=gen, device=dev)
    labels = torch.randint(0, c, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    s = api.ActiveSearcher.build(pts, labels=labels, cfg=cfg,
                                 proj=api.identity_projection(pts), device=dev)
    q = torch.randn((2048, 2), generator=gen, device=dev) * 1.5
    q_grid = projection.to_grid_coords(s.index.proj, q, cfg.grid_size)
    k = 11
    k_hi = max(k, int(np.ceil(k * cfg.k_slack)))
    r0 = (pyramid.seed_radius(s.index, cfg, q_grid, k) if adaptive_r0
          else torch.full((2048,), cfg.r0, dtype=torch.int32, device=dev))
    args = (s.index.pyr_tiles, q_grid.contiguous(), r0, k, k_hi, cfg.max_radius,
            cfg.max_iters, cfg.tile, cfg.level_nblks)
    before = rsl.launches
    got = rsl.radius_search_loop(*args, metric=metric)
    want = ref.radius_search_loop(*args, metric=metric)
    torch.cuda.synchronize()
    assert rsl.launches == before + 1
    assert set(got) == {"radius", "count", "iters", "converged"}
    got = {**got, "tile_dmas_skipped": ref.dmas_skipped(got["iters"], got["converged"])}
    for key in ("radius", "count", "iters", "converged", "tile_dmas_skipped"):
        np.testing.assert_array_equal(np_(got[key]), np_(want[key]), err_msg=key)


@pytest.mark.gpu
@pytest.mark.parametrize("paper", [False, True])
def test_gpu_csr_candidate_topk_kernel_matches_plain(paper):
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk as csr

    store, starts, ends, q = _csr_fixture(seed=21, b=64, w=8, d=2 if paper else 6)
    kw = {}
    if paper:
        store = store * 8.0
        kw = dict(radii=_t(np.full((64,), 6.0, np.float32)), center_cells=True)
    args = [_t(a) for a in (store, starts, ends, q)]
    wd, wi = ref.csr_candidate_topk(*args, 9, store.shape[0], 16, **kw)
    gd, gi = csr.csr_candidate_topk(
        *[a.to(dev) for a in args], 9, store.shape[0], 16,
        **{key: (v.to(dev) if isinstance(v, torch.Tensor) else v) for key, v in kw.items()},
    )
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("c", [3, 40])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_gpu_tile_count_kernel_matches_plain(metric, c, tile):
    """Every level of a 128-grid pyramid, grid corners included, 3 and 40
    channels, both instances (T = 16 with shifts, the generic one at T =
    8), 512 queries, one, and 509 (not a multiple of a block's 4): exact."""
    dev = require_cuda()
    from repro_torch.kernels import tile_count as tc

    cfg, idx, rng = _pyramid_fixture(seed=22, grid=128, tile=tile, c=c)
    g = cfg.padded_size
    q = np.concatenate([np.array([[0, 0], [g - 1e-3, g - 1e-3], [0, g - 1e-3], [g - 1e-3, 0]],
                                 np.float32),
                        rng.uniform(0, g, size=(508, 2)).astype(np.float32)])
    r = rng.uniform(0.5, cfg.max_radius, size=(512,)).astype(np.float32)
    for lv, arr in enumerate(idx.pyramid):
        for bq in (512, 1, 509):
            args = (_t(arr), _t(q[:bq]), _t(r[:bq]))
            want = ref.tile_count(*args, 1 << lv, cfg.tile, metric=metric)
            got = tc.tile_count(*[a.to(dev) for a in args], 1 << lv, cfg.tile, metric=metric)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(np_(got), np_(want), err_msg=f"level {lv}, B={bq}")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [11, 37, 128])
@pytest.mark.parametrize("d_chunk", [None, 4, 5])
def test_gpu_candidate_topk_kernel_matches_plain_and_csr_kernel(d_chunk, d):
    """Against the plain version (slots exact, distances within DIST_RTOL),
    and bit-equal to the csr_candidate_topk kernel on the same rows: rows
    read directly (d = 11), staged by 4-byte (37) and 16-byte copies
    (128), chunk boundaries inside a stage (d_chunk = 4, 5)."""
    dev = require_cuda()
    from repro_torch.kernels import candidate_topk as ctk
    from repro_torch.kernels import csr_candidate_topk as csr

    store, starts, ends, q = [_t(a) for a in _csr_fixture(seed=23, b=64, w=8, d=d)]
    flat, valid = ref.window_slots(starts, ends, store.shape[0], store.shape[0], 16)
    cand = store[flat]
    dc = d if d_chunk is None else d_chunk
    wd, wi = ref.candidate_topk(cand, valid, q, 9, d_chunk=dc)
    gd, gi = ctk.candidate_topk(cand.to(dev), valid.to(dev), q.to(dev), 9, d_chunk=dc)
    fd, fi = csr.csr_candidate_topk(store.to(dev), starts.to(dev), ends.to(dev), q.to(dev), 9,
                                    store.shape[0], 16, d_chunk=d_chunk)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np_(gi), np_(wi))
    assert_dists_close(gd, wd)
    assert torch.equal(gd, fd)
    assert torch.equal(ref.take_slots(flat.to(dev), gi), fi)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("d_chunk", [None, 5])
def test_gpu_csr_shortlist_q8_kernel_matches_plain(metric, d_chunk):
    """Integer scoring: scores and rows bit-equal to the plain version."""
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk_q8 as q8

    store, starts, ends, q = [_t(a) for a in _csr_fixture(seed=24, b=64, w=8, d=11)]
    scales = store.abs().amax(dim=1, keepdim=True) / 100.0
    codes = torch.clamp(torch.round(store / scales), -127, 127).to(torch.int8)
    args = (codes, scales, starts, ends, q * 3.0, 20, store.shape[0] - 7, 16)
    want = ref.csr_shortlist_q8(*args, metric=metric, d_chunk=d_chunk)
    got = q8.csr_shortlist_q8(*[a.to(dev) if isinstance(a, torch.Tensor) else a for a in args],
                              metric=metric, d_chunk=d_chunk)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,k", [(300, 5000, 2, 11), (200, 4099, 13, 20), (64, 70_000, 128, 10),
                                     (9, 7, 5, 12), (50, 5000, 9, 33), (40, 6000, 128, 64),
                                     (30, 5000, 9, 257), (5, 0, 3, 4)])
def test_gpu_brute_knn_kernel_matches_plain(b, n, d, k):
    """Against the plain version on the card: pads exact, ids equal up to
    near-ties, distances within 8 float32 ulps of ‖q‖² + ‖x‖² (the
    product sums in another order than torch.matmul's and the form
    cancels); bit-equal on an integer lattice, where every distance is
    exact and ties take the lower index."""
    dev = require_cuda()
    from repro_torch.kernels import brute_knn as bk

    rng = np.random.default_rng(b + n + d + k)
    q = _t(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    x = _t(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    gd, gi = bk.brute_knn(q, x, k)
    wd, wi = ref.brute_knn(q, x, k)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np.isinf(np_(gd)), np.isinf(np_(wd)))
    scale = (q * q).sum(1, keepdim=True) + torch.cat([(x * x).sum(1), x.new_zeros(1)]).max()
    fin = torch.isfinite(wd)
    err = (gd.double() ** 2 - wd.double() ** 2).abs()
    assert bool((err[fin] <= (8 * np.finfo(np.float32).eps * scale.double()).expand_as(err)[fin]).all())
    assert float((gi == wi).all(1).float().mean()) >= 0.99

    lat_q = torch.randint(0, 6, (b, d), device=dev).float()
    lat_x = torch.randint(0, 6, (n, d), device=dev).float()
    got, want = bk.brute_knn(lat_q, lat_x, k), ref.brute_knn(lat_q, lat_x, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("s,t,h,hd,causal", [(256, 256, 3, 64, True), (100, 70, 2, 20, False),
                                             (130, 130, 1, 128, True), (70, 100, 2, 20, True),
                                             (128, 128, 2, 36, True), (100, 100, 2, 160, True),
                                             (100, 70, 2, 160, False), (64, 96, 1, 256, True),
                                             (100, 100, 2, 129, True), (100, 70, 2, 131, False),
                                             (70, 100, 2, 160, True), (130, 130, 1, 200, False),
                                             (100, 70, 2, 256, False), (70, 100, 1, 200, True),
                                             (8, 8, 35_200, 160, True), (96, 96, 1, 512, True),
                                             (40, 70, 1, 1000, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_flash_attention_kernel_matches_plain(s, t, h, hd, causal, dtype):
    """Against the plain version on the card: rtol/atol 2e-5 in float32,
    2e-2 in bf16 (ragged tiles included: 100, 70 and 130 rows; causal with
    fewer queries than keys; hd = 36, a multiple of 4 but not of 8; the
    wide heads on the tensor cores at hd = 129 and 131 (4-byte copies),
    160, 200 and 256, B·H = 70,400 at hd = 160; the head dim split
    across warps at hd = 512 and 1000)."""
    dev = require_cuda()
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(s + t + hd)
    q, k, v = (_t(rng.normal(size=(2, n, h, hd)).astype(np.float32)).to(dev).to(dtype)
               for n in (s, t, t))
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(np_(got.float()), np_(want.float()), rtol=tol, atol=tol)


def _window_case(case):
    """Spans, store and queries of one named window case (numpy, from a
    seed): the window size, d, and the spans' shape vary."""
    b, w, rcap, n, d = 64, 8, 16, 120, 6
    kind = case
    if case.startswith("wide"):
        b, w, rcap, n, d = ((8, 512, 64, 40_000, 16) if case == "wide_32768"
                            else (4, 1024, 64, 80_000, 8))
    elif case.startswith("d"):
        d = int(case[1:])
    rng = np.random.default_rng(sum(map(ord, case)))
    store = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    # starts clamped at the store's start (< 0) and end (> n - row_cap)
    starts = rng.integers(-8, n, size=(b, w)).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, rcap + 8, size=(b, w)), n).astype(np.int32)
    if kind == "all_invalid":
        ends[: b // 2] = starts[: b // 2]  # half the queries have no valid slot
    return store, starts, ends, q


WINDOW_CASES = ["wide_32768", "wide_65536", "d2", "d9", "d13", "d37", "all_invalid"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("k", [1, 10, 257, -1])
def test_gpu_csr_candidate_topk_windows(case, k):
    """Windows of 32,768 and 65,536 slots, unaligned rows (d = 2, 9, 13
    read directly, 37 staged by 4-byte copies), all-invalid windows, spans
    clamped at the store's ends and a live count below the store; k = 1,
    257 and more than the window: slots exact up to near-ties, distances
    within DIST_RTOL (bit-equal at d = 2)."""
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk as csr

    store, starts, ends, q = _window_case(case)
    rcap = 64 if case.startswith("wide") else 16
    k = starts.shape[1] * rcap + 3 if k == -1 else k  # -1: past the window
    args = [_t(a) for a in (store, starts, ends, q)]
    n_live = store.shape[0] - 7
    for kw in ({}, {"metric": "l1", "d_chunk": 5}):
        wd, wi = ref.csr_candidate_topk(*args, k, n_live, rcap, **kw)
        gd, gi = csr.csr_candidate_topk(*[a.to(dev) for a in args], k, n_live, rcap, **kw)
        torch.cuda.synchronize()
        assert_ids_equal_up_to_ties(gi, wi, lambda b, ids: args[0][ids], args[3],
                                     kw.get("metric", "l2"))
        assert_dists_close(gd, wd)
        if store.shape[1] <= 2:
            assert torch.equal(gd.cpu(), wd)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WINDOW_CASES + ["d130", "d128", "d600"])
@pytest.mark.parametrize("rerank_k", [1, 40, 257, -1])
def test_gpu_csr_shortlist_q8_windows(case, rerank_k):
    """The int8 shortlist over the same window cases, plus d = 128 (16-byte
    units), 130 (unaligned rows, two units per lane) and 600 (the generic
    variant); rerank_k = 1, 40, 257 and the whole window (-1), d_chunk
    None and 5: scores and rows bit-equal."""
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk_q8 as q8

    store, starts, ends, q = _window_case(case)
    rcap = 64 if case.startswith("wide") else 16
    rk = starts.shape[1] * rcap if rerank_k == -1 else min(rerank_k, starts.shape[1] * rcap)
    scales = np.abs(store).max(axis=1, keepdims=True) / 100.0 + 1e-3
    scales[10:40] = scales[10]  # a cell's rows share one scale
    codes = np.clip(np.round(store / scales), -127, 127).astype(np.int8)
    args = [_t(a) for a in (codes, scales.astype(np.float32), starts, ends, q * 3.0)]
    for kw in ({}, {"metric": "l1"}, {"d_chunk": 5}):
        want = ref.csr_shortlist_q8(*args, rk, store.shape[0] - 7, rcap, **kw)
        got = q8.csr_shortlist_q8(*[a.to(dev) for a in args], rk, store.shape[0] - 7, rcap, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), kw


@pytest.mark.gpu
@pytest.mark.parametrize("c,d", [(65_536, 4), (4096, 2), (4096, 9), (4096, 13), (4096, 37),
                                 (40, 128), (600, 128)])
@pytest.mark.parametrize("k", [1, 257, -1])
def test_gpu_candidate_topk_wide(c, d, k):
    """Dense candidates past the old cap (C = 65,536), unaligned rows (d =
    9, 13 read directly, 37 staged by 4-byte copies), the q8 re-rank's
    shape (2048 queries of 40 rows at d = 128: a ring of one partial tile)
    and three tiles with a partial last one; each window also 4 bytes past
    a 16-byte boundary (a slice of a larger tensor, so d = 128 takes 4-byte
    copies); k = 1, 257 and past C (-1), d_chunk 512 and 5: slots exact up
    to near-ties, distances within DIST_RTOL."""
    dev = require_cuda()
    from repro_torch.kernels import candidate_topk as ctk

    rng = np.random.default_rng(c + d)
    b = 2048 if c == 40 else 8
    cand = _t(rng.normal(size=(b, c, d)).astype(np.float32))
    valid = _t(rng.uniform(size=(b, c)) < 0.8)
    valid[0] = False  # a query with no valid candidate
    q = _t(rng.normal(size=(b, d)).astype(np.float32))
    kk = c + 3 if k == -1 else k
    aligned = cand.to(dev)
    shifted = torch.empty(cand.numel() + 1, device=dev)[1:].view(cand.shape)
    shifted.copy_(aligned)
    for cand_dev in (aligned, shifted):
        for dc in (512, 5):
            wd, wi = ref.candidate_topk(cand, valid, q, kk, d_chunk=dc)
            gd, gi = ctk.candidate_topk(cand_dev, valid.to(dev), q.to(dev), kk, d_chunk=dc)
            torch.cuda.synchronize()
            assert_ids_equal_up_to_ties(gi, wi, lambda b, ids: cand[b][ids], q, "l2")
            assert_dists_close(gd, wd)
