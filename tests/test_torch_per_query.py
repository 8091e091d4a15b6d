"""The port's per-query `torch` backend against the JAX package's `jnp`.

`repro_torch.api.ActiveSearcher` on backend `torch` (plain PyTorch, the
whole batch in lock step) against `repro.api.ActiveSearcher` on backend
`jnp` (a per-query function under `jax.vmap`), both built from the same
numpy points under the identity projection.  Eq.-1 stats, ids, labels,
classes and counts are exact; distances within DIST_RTOL.  Inside the
port, `torch` equals `hopper` (the kernels' plain versions here) in every
field, distances included, at d = 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_results_match, np_
from test_torch_search import K, _pair

from repro.core import active_search as jas
from repro.core import pyramid as jpyr
from repro_torch.core import active_search as tas
from repro_torch.core import batched
from repro_torch.core import projection as tproj
from repro_torch.core import pyramid as tpyr

STATS = ("radius", "count", "iters", "converged")


def _pair_jnp(seed=0, **over):
    """(reference searcher on `jnp`, port searcher on `torch`, queries)."""
    js, ts, q = _pair(seed, **over)
    return js.with_plan(backend="jnp"), ts.with_plan(backend="torch"), q


@pytest.fixture(scope="module")
def l2_pair():
    return _pair_jnp(seed=0)


@pytest.fixture(scope="module")
def l1_pair():
    return _pair_jnp(seed=1, metric="l1", k_slack=2.0)


@pytest.fixture(scope="module")
def sat_pair():
    return _pair_jnp(seed=2, counter="sat", k_slack=2.0)


@pytest.mark.parametrize("mode", ["refined", "paper"])
@pytest.mark.parametrize("pair", ["l2_pair", "l1_pair", "sat_pair"])
def test_torch_search_matches_jnp(request, pair, mode):
    js, ts, q = request.getfixturevalue(pair)
    assert_results_match(ts.search(q, K, mode=mode), js.search(jnp.asarray(q), K, mode=mode))


@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_torch_search_k_past_the_window(mode):
    """k larger than the window's w*row_cap slots: the result pads with
    invalid slots, as `lax.top_k` of a short window does."""
    js, ts, q = _pair_jnp(seed=3, window=4, row_cap=4, r0=3, k_slack=4.0)
    k = 4 * 4 + 5
    got = ts.search(q, k, mode=mode)
    assert_results_match(got, js.search(jnp.asarray(q), k, mode=mode))
    assert not bool(got.valid[:, -5:].any())


@pytest.mark.parametrize("pair", ["l2_pair", "l1_pair"])
def test_torch_adaptive_r0_matches_jnp(request, pair):
    js, ts, q = request.getfixturevalue(pair)
    got = ts.with_plan(adaptive_r0=True).search(q, K)
    assert_results_match(got, js.with_plan(adaptive_r0=True).search(jnp.asarray(q), K))


@pytest.mark.parametrize("mode", ["refined", "paper"])
@pytest.mark.parametrize("pair", ["l2_pair", "sat_pair"])
def test_torch_classify_matches_jnp(request, pair, mode):
    js, ts, q = request.getfixturevalue(pair)
    got = ts.classify(q, K, mode=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np.asarray(js.classify(jnp.asarray(q), K, mode=mode)))


def test_torch_classify_falls_back_on_short_lanes():
    """A window of 8 x 8 cells holding at most 16 rows each: about half the
    lanes are truncated or short of k, so refined classify takes the count
    argmax at the final radius there, as the reference's does, and the
    fallback differs from the window vote on some lane."""
    js, ts, q = _pair_jnp(seed=4, window=8, row_cap=16, r0=3, k_slack=2.0)
    k = 7
    res = ts.search(q, k)
    short = np_((res.valid.sum(dim=1) < k) | res.truncated)
    assert short.any() and not short.all()
    got = np_(ts.classify(q, k))
    np.testing.assert_array_equal(got, np.asarray(js.classify(jnp.asarray(q), k)))
    vote = np_(tas.majority_vote(res.labels, res.valid, ts.cfg.n_classes))
    assert (got[short] != vote[short]).any()


@pytest.mark.parametrize("pair", ["l2_pair", "l1_pair", "sat_pair"])
def test_torch_count_at_matches_jnp(request, pair):
    js, ts, q = request.getfixturevalue(pair)
    radii = np.random.default_rng(5).integers(0, ts.cfg.max_radius + 1, size=len(q)).astype(np.int32)
    got = ts.count_at(q, radii)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np_(got), np.asarray(js.count_at(jnp.asarray(q), radii)))


@pytest.mark.parametrize("mode", ["refined", "paper"])
@pytest.mark.parametrize("pair", ["l2_pair", "l1_pair"])
def test_torch_equals_hopper(request, pair, mode):
    """`torch` and `hopper` on one port index: every field bit for bit,
    distances included, and the same classes and counts."""
    _, ts, q = request.getfixturevalue(pair)
    hop = ts.with_plan(backend="hopper")
    want, got = hop.search(q, K, mode=mode), ts.search(q, K, mode=mode)
    for field in want._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if ts.cfg.n_classes:
        assert torch.equal(ts.classify(q, K, mode=mode), hop.classify(q, K, mode=mode))
    radii = want.radius
    assert torch.equal(ts.count_at(q, radii), hop.count_at(q, radii))


@pytest.mark.parametrize("adaptive_r0", [False, True])
@pytest.mark.parametrize("pair", ["l2_pair", "l1_pair", "sat_pair"])
def test_radius_search_matches_reference(request, pair, adaptive_r0):
    """The per-query Eq.-1 loop against the reference's under vmap, and
    against the batched loop (the kernel's plain version on the pyramid
    counter) lane for lane."""
    js, ts, q = request.getfixturevalue(pair)
    jq = jax.vmap(lambda x: jpyr.radius_search(js.index, js.cfg, x, K, adaptive_r0=adaptive_r0))(
        jax.vmap(lambda x: jas.proj_lib.to_grid_coords(js.index.proj, x, js.cfg.grid_size))(
            jnp.asarray(q)))
    q_grid = tproj.to_grid_coords(ts.index.proj, torch.from_numpy(q), ts.cfg.grid_size)
    got = tpyr.radius_search(ts.index, ts.cfg, q_grid, K, adaptive_r0=adaptive_r0)
    assert sorted(got) == sorted(STATS)
    loop = batched.radius_search_batched(ts.index, ts.cfg, q_grid, K, adaptive_r0=adaptive_r0)
    for field in STATS:
        np.testing.assert_array_equal(np_(got[field]), np.asarray(jq[field]), err_msg=field)
        assert torch.equal(got[field], loop[field]), field


def test_count_total_matches_reference(l1_pair):
    js, ts, q = l1_pair
    q_grid = tproj.to_grid_coords(ts.index.proj, torch.from_numpy(q), ts.cfg.grid_size)
    r = torch.arange(len(q), dtype=torch.int32) * 3
    want = jax.vmap(lambda g, rr: jpyr.count_total(js.index, js.cfg, g, rr))(
        jnp.asarray(np_(q_grid)), jnp.asarray(np_(r)))
    np.testing.assert_array_equal(np_(tpyr.count_total(ts.index, ts.cfg, q_grid, r)),
                                  np.asarray(want))


@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_search_one_matches_reference(l2_pair, mode):
    js, ts, q = l2_pair
    for i in (0, 7, len(q) - 1):
        want = jas.search_one(js.index, js.cfg, jnp.asarray(q[i]), K, mode)
        got = tas.search_one(ts.index, ts.cfg, torch.from_numpy(q[i]), K, mode)
        assert_results_match(got, want)


def test_gather_candidates_matches_reference(l2_pair):
    js, ts, q = l2_pair
    q_grid = tproj.to_grid_coords(ts.index.proj, torch.from_numpy(q), ts.cfg.grid_size)
    want = jax.vmap(lambda g: jas.gather_candidates(js.index, js.cfg, g))(jnp.asarray(np_(q_grid)))
    got = tas.gather_candidates(ts.index, ts.cfg, q_grid)
    for field in want._fields:
        np.testing.assert_array_equal(np_(getattr(got, field)), np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_torch_backend_capabilities():
    from repro import api as japi
    from repro_torch import api as tapi

    t, j = tapi.get_backend("torch"), japi.get_backend("jnp")
    for flag in ("supports_adaptive_r0", "supports_mutation", "supports_d_chunk",
                 "supports_quantized"):
        assert getattr(t, flag) == getattr(j, flag), flag
    assert t.search and t.classify and t.count_at
