"""The port's baseline backends against the JAX package's: `hopper_gather`
(materialised window + dense `candidate_topk`) against `pallas_gather`, and
`hopper_stacked` (one `tile_count` per pyramid level) against
`pallas_stacked`, on `test_torch_search`'s pair of searchers.  Ids, labels,
counts and Eq.-1 stats exact, distances within DIST_RTOL; inside the port
both baselines equal `hopper` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_results_match, np_
from test_torch_search import K, _pair

from repro.core import batched as jbatched
from repro.core import projection as jproj
from repro.kernels import ops as jops
from repro_torch.core import active_search
from repro_torch.kernels import ops


@pytest.fixture(scope="module")
def l2_pair():
    return _pair(seed=0)


@pytest.fixture(scope="module")
def l1_pair():
    return _pair(seed=1, metric="l1", k_slack=2.0)


@pytest.mark.parametrize("mode", ["refined", "paper"])
@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_hopper_gather_matches_reference(request, mode, metric):
    js, ts, q = request.getfixturevalue(f"{metric}_pair")
    got = ts.with_plan(backend="hopper_gather").search(q, K, mode=mode)
    assert_results_match(got, js.with_plan(backend="pallas_gather").search(jnp.asarray(q), K, mode=mode))


@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_hopper_gather_classify_matches_reference(l2_pair, mode):
    js, ts, q = l2_pair
    got = ts.with_plan(backend="hopper_gather").classify(q, K, mode=mode)
    want = js.with_plan(backend="pallas_gather").classify(jnp.asarray(q), K, mode=mode)
    np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("mode", ["refined", "paper"])
@pytest.mark.parametrize("d_chunk", [None, 1])
def test_hopper_gather_is_bit_equal_to_hopper(l1_pair, mode, d_chunk):
    _, ts, q = l1_pair
    want = ts.with_plan(d_chunk=d_chunk).search(q, K, mode=mode)
    got = ts.with_plan(backend="hopper_gather", d_chunk=d_chunk).search(q, K, mode=mode)
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_gather_candidates_matches_reference(l2_pair):
    js, ts, q = l2_pair
    jgrid = jproj.to_grid_coords(js.index.proj, jnp.asarray(q), js.cfg.grid_size)
    want = jbatched.gather_candidates_batched(js.index, js.cfg, jgrid)
    got = active_search.gather_candidates(ts.index, ts.cfg, torch.from_numpy(np.asarray(jgrid)))
    for field in want._fields:
        np.testing.assert_array_equal(np_(getattr(got, field)), np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_hopper_stacked_count_at_matches_reference(request, metric):
    """Exact counts, radii over every pyramid level, against pallas_stacked
    and against hopper's level-scheduled count."""
    js, ts, q = request.getfixturevalue(f"{metric}_pair")
    radii = np.random.default_rng(2).integers(0, ts.cfg.max_radius + 1, size=len(q)).astype(np.int32)
    got = ts.with_plan(backend="hopper_stacked").count_at(q, radii)
    want = js.with_plan(backend="pallas_stacked").count_at(jnp.asarray(q), radii)
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np_(ts.count_at(q, radii)))


def test_hopper_stacked_counts_only(l2_pair):
    _, ts, q = l2_pair
    with pytest.raises(ValueError, match="does not implement"):
        ts.with_plan(backend="hopper_stacked").search(q, K)


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_tile_count_matches_reference_kernel(l2_pair, metric):
    """ops.tile_count on each pyramid level against the reference's Pallas
    kernel, grid corners included: exact."""
    _, ts, _ = l2_pair
    rng = np.random.default_rng(9)
    g = ts.cfg.padded_size
    q = np.concatenate([np.array([[0, 0], [g - 1e-3, g - 1e-3], [0, g - 1e-3], [g - 1e-3, 0]],
                                 np.float32),
                        rng.uniform(0, g, size=(6, 2)).astype(np.float32)])
    r = rng.uniform(0.5, ts.cfg.max_radius, size=(10,)).astype(np.float32)
    for lv, arr in enumerate(ts.index.pyramid):
        want = jops.tile_count(jnp.asarray(np_(arr)), jnp.asarray(q), jnp.asarray(r), 1 << lv,
                               ts.cfg.tile, metric=metric, interpret=True)
        got = ops.tile_count(arr, torch.from_numpy(q), torch.from_numpy(r), 1 << lv,
                             ts.cfg.tile, metric=metric)
        np.testing.assert_array_equal(np_(got), np.asarray(want), err_msg=f"level {lv}")
