"""The port's brute_knn and its `exact` backend against the JAX package's.

On the CPU `ops.brute_knn` runs the plain version (`ref.brute_knn`); it is
held against the reference's Pallas kernel in interpret mode and against
the reference's oracle, over the shapes of the reference's own brute_knn
tests.  Distances within rtol/atol 1e-4, as the reference holds its kernel;
ids equal except where two distances tie within that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import api as tapi
from repro_torch.kernels import brute_knn as bk
from repro_torch.kernels import ops, ref

TOL = 1e-4


def _inputs(seed, b, n, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _assert_knn_close(got, want, q, x):
    """Dists within TOL; where ids differ, the two points lie equally far
    from the query (recomputed in float64) within TOL."""
    (gd, gi), (wd, wi) = [(np_(a), np_(b)) for a, b in (got, want)]
    assert gd.shape == wd.shape and gi.shape == wi.shape
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_array_equal(gi == -1, np.isinf(gd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=TOL, atol=TOL)
    rows, cols = np.nonzero(gi != wi)
    for r, c in zip(rows, cols):
        d64 = [np.linalg.norm(x[i].astype(np.float64) - q[r]) for i in (gi[r, c], wi[r, c])]
        assert abs(d64[0] - d64[1]) <= TOL * (1 + d64[1]), (r, c, d64)


@pytest.mark.parametrize("b,n,d,k", [(4, 100, 8, 5), (2, 1000, 16, 11), (128, 700, 4, 3),
                                     (1, 64, 128, 20)])
def test_brute_knn_matches_reference(b, n, d, k):
    q, x = _inputs(b + n + d + k, b, n, d)
    got = ops.brute_knn(torch.from_numpy(q), torch.from_numpy(x), k, block_q=32, block_n=128)
    kern = jops.brute_knn(jnp.asarray(q), jnp.asarray(x), k, block_q=32, block_n=128,
                          interpret=True)
    oracle = jref.brute_knn(jnp.asarray(q), jnp.asarray(x), k)
    _assert_knn_close(got, kern, q, x)
    _assert_knn_close(got, oracle, q, x)


def test_brute_knn_k_bigger_than_blocks():
    q, x = _inputs(7, 3, 50, 6)
    got = ops.brute_knn(torch.from_numpy(q), torch.from_numpy(x), 7, block_q=2, block_n=16)
    want = jops.brute_knn(jnp.asarray(q), jnp.asarray(x), 7, block_q=2, block_n=16,
                          interpret=True)
    _assert_knn_close(got, want, q, x)


@pytest.mark.parametrize("n,k", [(9, 12), (1, 4), (16, 17)])
def test_brute_knn_k_bigger_than_n_pads(n, k):
    """k > N: the reference's kernel pads with +inf / -1, and so does the port."""
    q, x = _inputs(n + k, 5, n, 6)
    got = ops.brute_knn(torch.from_numpy(q), torch.from_numpy(x), k, block_q=4, block_n=8)
    want = jops.brute_knn(jnp.asarray(q), jnp.asarray(x), k, block_q=4, block_n=8,
                          interpret=True)
    _assert_knn_close(got, want, q, x)
    assert (np_(got[1])[:, n:] == -1).all() and np.isinf(np_(got[0])[:, n:]).all()


@pytest.mark.parametrize("seed", range(6))
def test_brute_knn_random_shapes(seed):
    rng = np.random.default_rng(100 + seed)
    b, n, d = int(rng.integers(1, 9)), int(rng.integers(5, 300)), int(rng.integers(2, 40))
    k = int(rng.integers(1, min(n, 12) + 1))
    q, x = _inputs(seed, b, n, d)
    got = ops.brute_knn(torch.from_numpy(q), torch.from_numpy(x), k, block_q=16, block_n=64)
    want = jops.brute_knn(jnp.asarray(q), jnp.asarray(x), k, block_q=16, block_n=64,
                          interpret=True)
    _assert_knn_close(got, want, q, x)


@pytest.mark.parametrize("d", [2, 5])
def test_brute_knn_ties_take_the_lower_index(d):
    """Integer lattice points: every distance is exact and many tie; ids
    and distances equal the reference's oracle exactly (lower index first)."""
    rng = np.random.default_rng(d)
    q = rng.integers(0, 6, size=(40, d)).astype(np.float32)
    x = rng.integers(0, 6, size=(900, d)).astype(np.float32)
    gd, gi = ops.brute_knn(torch.from_numpy(q), torch.from_numpy(x), 15, block_n=128)
    wd, wi = jref.brute_knn(jnp.asarray(q), jnp.asarray(x), 15)
    np.testing.assert_array_equal(np_(gi), np.asarray(wi))
    np.testing.assert_array_equal(np_(gd), np.asarray(wd))


def test_brute_knn_blocks_do_not_change_the_result():
    q, x = _inputs(11, 9, 700, 3)
    one = ref.brute_knn(torch.from_numpy(q), torch.from_numpy(x), 6)
    for block in (64, 129, 700):
        got = ref.brute_knn(torch.from_numpy(q), torch.from_numpy(x), 6, block=block)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


def test_brute_knn_non_finite_rows_rank_as_padding():
    q, x = _inputs(12, 6, 40, 4)
    x[3] = np.nan
    x[5, 0] = np.inf
    q[2] = np.nan
    gd, gi = ref.brute_knn(torch.from_numpy(q), torch.from_numpy(x), 40)
    gd, gi = np_(gd), np_(gi)
    assert not np.isin(gi, [3, 5]).any()
    np.testing.assert_array_equal(gi == -1, np.isinf(gd))
    assert (gi[2] == -1).all()
    assert (np.isfinite(gd).sum(axis=1)[[0, 1, 3, 4, 5]] == 38).all()


def test_brute_knn_kernel_wrapper_checks():
    """The kernel's wrapper checks its arguments before the device (any
    k >= 0: k > 32 passes them and reaches the device check), and refuses
    CPU tensors without counting a launch."""
    q, x = torch.zeros((2, 3)), torch.zeros((5, 3))
    with pytest.raises(ValueError, match="k >= 0"):
        bk.brute_knn(q, x, -1)
    with pytest.raises(ValueError, match="queries"):
        bk.brute_knn(q, torch.zeros((5, 4)), 2)
    for k in (2, 33, 1000):
        with pytest.raises(ValueError, match="CUDA"):
            bk.brute_knn(q, x, k)
    assert bk.launches == 0
    # the plain version takes any k too, padding past N
    assert ops.brute_knn(q, x, 33)[0].shape == (2, 33)


@pytest.mark.parametrize("b,n,d,k", [(5, 300, 6, 33), (3, 200, 9, 64), (4, 150, 3, 100),
                                     (2, 70, 5, 100)])
def test_brute_knn_large_k_matches_reference(b, n, d, k):
    """k past a warp's 32 lanes, against the reference's kernel (interpret
    mode) and, where k <= N, its oracle (lax.top_k takes no k > N);
    (2, 70, 5, 100) has k > N, padded with +inf / -1 as the kernel pads."""
    q, x = _inputs(b * n + k, b, n, d)
    got = ops.brute_knn(torch.from_numpy(q), torch.from_numpy(x), k, block_q=8, block_n=64)
    kern = jops.brute_knn(jnp.asarray(q), jnp.asarray(x), k, block_q=8, block_n=64,
                          interpret=True)
    _assert_knn_close(got, kern, q, x)
    if k <= n:
        _assert_knn_close(got, jref.brute_knn(jnp.asarray(q), jnp.asarray(x), k), q, x)
    else:
        assert (np_(got[1])[:, n:] == -1).all() and np.isinf(np_(got[0])[:, n:]).all()


@pytest.mark.parametrize("b,n,sms,want", [(4096, 1_000_000, 132, 16), (10_000, 1_000_000, 132, 6),
                                          (100, 1000, 132, 1), (1, 10_000_000, 132, 528)])
def test_brute_knn_splits(b, n, sms, want):
    """Point ranges per query tile: at most two full waves of two resident
    blocks per SM, each range at least MIN_TILES_PER_SPLIT tiles."""
    assert bk.splits_for(b, n, sms) == want


def test_brute_knn_scratch():
    """The kernel's scratch: queries and points transposed to (d, rows
    padded to 4) with a norm per row, and the (B, splits, k) lists."""
    assert [bk.padded_rows(r) for r in (1, 4, 5, 1_000_000, 262_147)] == [
        4, 4, 8, 1_000_000, 262_148]
    splits = bk.splits_for(2048, 1_000_000, 132)
    assert bk.scratch_bytes(2048, 1_000_000, 128, 10, 132) == (
        4 * 129 * (2048 + 1_000_000) + 8 * 2048 * splits * 10)


# ------------------------------------------------------- the exact backend ----


def _searcher(metric="l2"):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(600, 2)).astype(np.float32)
    labels = rng.integers(0, 3, size=600).astype(np.int32)
    cfg = tapi.GridConfig(grid_size=64, tile=8, n_classes=3, window=16, row_cap=16, r0=6,
                          metric=metric)
    s = tapi.ActiveSearcher.build(pts, labels=labels, cfg=cfg,
                                  proj=tapi.identity_projection(torch.from_numpy(pts)),
                                  device="cpu")
    return s.with_plan(backend="exact"), rng.normal(size=(20, 2)).astype(np.float32)


@pytest.mark.parametrize("metric,calls", [("l2", 2), ("l1", 0)])
def test_exact_backend_routes_l2_through_brute_knn(monkeypatch, metric, calls):
    """search and classify on `exact` reach ops.brute_knn for l2 (the
    kernel on the card, its plain version here); l1 stays plain tensor code."""
    seen = []
    real = ops.brute_knn

    def spy(*args, **kw):
        seen.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "brute_knn", spy)
    ex, q = _searcher(metric)
    res = ex.search(q, 5)
    ex.classify(q, 5)
    assert len(seen) == calls
    assert res.ids.shape == (20, 5) and bool(res.valid.all())


def test_exact_knn_l2_is_brute_knn():
    from repro_torch.core import exact

    q, x = _inputs(13, 7, 5000, 3)
    got = exact.knn(torch.from_numpy(q), torch.from_numpy(x), 9)
    want = ref.brute_knn(torch.from_numpy(q), torch.from_numpy(x), 9)
    assert torch.equal(got.ids, want[1]) and torch.equal(got.dists, want[0])
