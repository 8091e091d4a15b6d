"""The port's grid index, projection, pyramid and summed-area table against
the JAX package, on the same numpy inputs.

Integer arrays are exact.  Builds use the identity projection on 2-D data,
where the projection product is exact in both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_

from repro.core import grid as jgrid
from repro.core import integral as jintegral
from repro.core import projection as jproj
from repro.core import pyramid as jpyr
from repro_torch.convert import index_from_numpy, projection_from_numpy
from repro_torch.core import grid, integral, projection, pyramid

# ------------------------------------------------------------- GridConfig ----

BAD_CONFIGS = [
    dict(tile=3),
    dict(tile=2),
    dict(metric="cosine"),
    dict(counter="dense"),
    dict(r0=0),
    dict(r0=-4),
    dict(grid_size=64, tile=16, r0=65),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=[str(k) for k in BAD_CONFIGS])
def test_gridconfig_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        jgrid.GridConfig(**kw)
    with pytest.raises(ValueError) as got:
        grid.GridConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("grid_size", [8, 30, 64, 100, 1024, 3000])
@pytest.mark.parametrize("tile", [4, 8, 16, 64])
def test_gridconfig_derived_properties(grid_size, tile):
    kw = dict(grid_size=grid_size, tile=tile, n_classes=3, window=8, row_cap=4, r0=1)
    want, got = jgrid.GridConfig(**kw), grid.GridConfig(**kw)
    for name in ("n_channels", "levels", "padded_size", "max_radius",
                 "max_candidates", "level_nblks"):
        assert getattr(got, name) == getattr(want, name), name


# ------------------------------------------------------------ build_index ----


def _data(seed=0, n=1500, d=2, c=3):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, max(c, 1), size=n).astype(np.int32)
    return pts, labels


def _built(cfg_kw, seed=0, n=1500):
    pts, labels = _data(seed, n=n, c=cfg_kw.get("n_classes", 0))
    jcfg, tcfg = jgrid.GridConfig(**cfg_kw), grid.GridConfig(**cfg_kw)
    jidx = jgrid.build_index(jnp.asarray(pts), jcfg, jproj.identity_projection(jnp.asarray(pts)),
                             labels=jnp.asarray(labels))
    tpts = torch.from_numpy(pts)
    tidx = grid.build_index(tpts, tcfg, projection.identity_projection(tpts),
                            labels=torch.from_numpy(labels))
    return jcfg, jidx, tcfg, tidx


BUILDS = [
    dict(grid_size=64, tile=8, n_classes=3, r0=4),
    dict(grid_size=100, tile=16, n_classes=0, r0=8),
    dict(grid_size=128, tile=16, n_classes=2, r0=8, counter="sat"),
]


@pytest.mark.parametrize("cfg_kw", BUILDS, ids=["labelled", "unlabelled", "sat"])
def test_build_index_matches_reference(cfg_kw):
    _, jidx, tcfg, tidx = _built(cfg_kw)
    for field in ("points_sorted", "coords_sorted", "labels_sorted",
                  "ids_sorted", "offsets", "sat", "pyr_tiles"):
        want, got = getattr(jidx, field), getattr(tidx, field)
        if want is None:
            assert got is None, field
            continue
        assert np_(got).dtype == np.asarray(want).dtype, field
        np.testing.assert_array_equal(np_(got), np.asarray(want), err_msg=field)
    assert len(tidx.pyramid) == len(jidx.pyramid) == tcfg.levels
    for lv, (g, w) in enumerate(zip(tidx.pyramid, jidx.pyramid)):
        np.testing.assert_array_equal(np_(g), np.asarray(w), err_msg=f"level {lv}")
    for g, w in zip(tidx.proj, jidx.proj):
        np.testing.assert_array_equal(np_(g), np.asarray(w))


@pytest.mark.parametrize("cfg_kw", BUILDS, ids=["labelled", "unlabelled", "sat"])
def test_validate_invariants(cfg_kw):
    jcfg, jidx, tcfg, tidx = _built(cfg_kw, seed=1)
    got = grid.validate_invariants(tidx, tcfg)
    assert got == jgrid.validate_invariants(jidx, jcfg)
    assert all(got.values()), got
    np.testing.assert_array_equal(np_(grid.base_counts(tidx)),
                                  np.asarray(jgrid.base_counts(jidx)))


def test_validate_invariants_catches_a_broken_pyramid():
    _, _, tcfg, tidx = _built(BUILDS[0], seed=2)
    top = tidx.pyramid[-1].clone()
    top[0, 0, 0] += 1
    broken = tidx._replace(pyramid=tidx.pyramid[:-1] + (top,))
    got = grid.validate_invariants(broken, tcfg)
    assert not got["pyramid_chain_consistent"] and not got["pyramid_mass_is_n"]


def test_build_sat_matches_reference():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, size=(16, 16, 3)).astype(np.int32)
    want = jintegral.build_sat(jnp.asarray(base))
    got = integral.build_sat(torch.from_numpy(base))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_count_linf_matches_reference():
    rng = np.random.default_rng(4)
    sat = jintegral.build_sat(jnp.asarray(rng.integers(0, 4, size=(32, 32, 2)), jnp.int32))
    q = rng.uniform(-2, 34, size=(40, 2)).astype(np.float32)
    r = rng.integers(0, 20, size=(40,)).astype(np.int32)
    want = jax.vmap(lambda a, b: jintegral.count_linf(sat, a, b))(jnp.asarray(q), jnp.asarray(r))
    got = integral.count_linf(torch.from_numpy(np.asarray(sat)), torch.from_numpy(q),
                              torch.from_numpy(r))
    np.testing.assert_array_equal(np_(got), np.asarray(want))


# ----------------------------------------------------------------- pyramid ----


@pytest.mark.parametrize("grid_size,tile", [(3000, 16), (1024, 16), (64, 8), (100, 5), (256, 7)])
def test_level_for_radius_every_radius(grid_size, tile):
    """Every integer radius in [0, max_radius] gets the reference's level."""
    kw = dict(grid_size=grid_size, tile=tile, r0=1)
    jcfg, tcfg = jgrid.GridConfig(**kw), grid.GridConfig(**kw)
    r = np.arange(0, tcfg.max_radius + 1, dtype=np.int32)
    want = jpyr.level_for_radius(jnp.asarray(r), jcfg)
    got = pyramid.level_for_radius(torch.from_numpy(r), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_count_in_circle_matches_reference(metric):
    cfg_kw = dict(grid_size=64, tile=8, n_classes=3, r0=4, metric=metric)
    jcfg, jidx, tcfg, tidx = _built(cfg_kw, seed=5)
    rng = np.random.default_rng(5)
    q = rng.uniform(0, 64, size=(30, 2)).astype(np.float32)
    r = rng.integers(0, tcfg.max_radius + 1, size=(30,)).astype(np.int32)
    want = jax.vmap(lambda a, b: jpyr.count_in_circle(jidx, jcfg, a, b))(
        jnp.asarray(q), jnp.asarray(r))
    got = pyramid.count_in_circle(tidx, tcfg, torch.from_numpy(q), torch.from_numpy(r))
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("k", [1, 11, 40])
def test_seed_radius_matches_reference(k):
    jcfg, jidx, tcfg, tidx = _built(dict(grid_size=128, tile=16, n_classes=3, r0=8), seed=6)
    rng = np.random.default_rng(6)
    q = rng.uniform(0, 128, size=(32, 2)).astype(np.float32)
    want = jax.vmap(lambda a: jpyr.seed_radius(jidx, jcfg, a, k))(jnp.asarray(q))
    got = pyramid.seed_radius(tidx, tcfg, torch.from_numpy(q), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np.asarray(want))


def test_eq1_ratio_is_the_true_quotient():
    """sqrt(k / n) from a tensor division, not k times a rounded reciprocal."""
    n = torch.arange(0, 50_000, dtype=torch.int32)
    want = np.sqrt(np.float32(11) / np.maximum(np_(n), 1).astype(np.float32))
    np.testing.assert_array_equal(np_(pyramid.eq1_ratio(11, n)), want)


# -------------------------------------------------------------- projection ----


def test_to_grid_coords_matches_reference():
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(500, 5)) * 3).astype(np.float32)
    mat = rng.normal(size=(5, 2)).astype(np.float32)
    g = pts @ mat
    lo, hi = g.min(0), g.max(0)
    want = jproj.to_grid_coords(jproj.Projection(jnp.asarray(mat), jnp.asarray(lo),
                                                 jnp.asarray(hi)), jnp.asarray(pts), 300)
    got = projection.to_grid_coords(projection_from_numpy(mat, lo, hi, device="cpu"),
                                    torch.from_numpy(pts), 300)
    # the d=5 product sums in another order on each side: coordinates agree
    # to float32 rounding, and every one stays inside [0, grid_size)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-3)
    assert float(got.min()) >= 0 and float(got.max()) < 300


def test_identity_projection_matches_reference():
    pts, _ = _data(8, n=300)
    want = jproj.identity_projection(jnp.asarray(pts))
    got = projection.identity_projection(torch.from_numpy(pts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_(g), np.asarray(w))


def test_pca_projection_properties():
    """Orthonormal columns, leading direction = the reference's up to sign,
    extents cover the projected points."""
    rng = np.random.default_rng(9)
    pts = (rng.normal(size=(800, 6)) * np.array([5, 2, 1, 0.5, 0.2, 0.1])).astype(np.float32)
    got = projection.pca_projection(torch.from_numpy(pts))
    want = jproj.pca_projection(jnp.asarray(pts))
    m = np_(got.matrix).astype(np.float64)
    np.testing.assert_allclose(m.T @ m, np.eye(2), atol=1e-5)
    np.testing.assert_allclose(np.abs(m), np.abs(np.asarray(want.matrix)), atol=1e-4)
    g = pts @ np_(got.matrix)
    assert (np_(got.lo) <= g.min(0)).all() and (np_(got.hi) >= g.max(0)).all()


def test_gaussian_projection_properties():
    pts, _ = _data(10, n=400, d=8)
    gen = torch.Generator().manual_seed(0)
    p = projection.gaussian_projection(gen, torch.from_numpy(pts), grid_dim=3)
    assert p.matrix.shape == (8, 3) and p.grid_dim == 3
    g = np_(projection.apply(p, torch.from_numpy(pts)))
    assert (np_(p.lo) <= g.min(0)).all() and (np_(p.hi) >= g.max(0)).all()
    again = projection.gaussian_projection(torch.Generator().manual_seed(0),
                                           torch.from_numpy(pts), grid_dim=3)
    assert torch.equal(p.matrix, again.matrix)


# ------------------------------------------------------------ carry-across ----


@pytest.mark.parametrize("cfg_kw", BUILDS, ids=["labelled", "unlabelled", "sat"])
def test_index_from_numpy_round_trip(cfg_kw):
    jcfg, jidx, tcfg, tidx = _built(cfg_kw, seed=11)
    fields = jax.tree.map(np.asarray, jidx)._asdict()
    got = index_from_numpy(fields, tcfg, device="cpu")
    for name in got._fields:
        a, b = getattr(got, name), getattr(tidx, name)
        if name in ("proj", "pyramid"):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), name
        elif b is None:
            assert a is None, name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_index_from_numpy_rejects_wrong_depth():
    jcfg, jidx, tcfg, _ = _built(BUILDS[0], seed=12)
    fields = jax.tree.map(np.asarray, jidx)._asdict()
    fields["pyramid"] = fields["pyramid"][:-1]
    with pytest.raises(ValueError, match="levels"):
        index_from_numpy(fields, tcfg, device="cpu")
