"""Shared helpers of the port's tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed; each side gets its own copy
(`jnp.asarray` / `torch.from_numpy`) and results come back as numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# f32 distances: the reference's own reductions sit up to an ulp off each
# other (XLA:CPU contracts a*a + b*b into an FMA; sums over d reassociate),
# so distances are held to a relative tolerance and everything else exactly.
DIST_RTOL = 1e-6


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_dists_close(got, want, err_msg: str = "") -> None:
    """Equal +inf pads, finite distances within DIST_RTOL."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want), err_msg=err_msg)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=DIST_RTOL, atol=0,
                               err_msg=err_msg)


def assert_ids_equal_up_to_ties(gi, wi, rows, q, metric, rtol=DIST_RTOL):
    """Selected rows exact, except that near-tied rows may trade places: a
    query whose id list differs must list equally far rows (distances
    recomputed in float64 from rows(b, ids), sorted, within rtol).
    The kernel and the plain version sum a row in different orders, so
    distances an ulp apart may rank the other way."""
    gi, wi = gi.cpu(), wi.cpu()
    for b in (gi != wi).any(dim=1).nonzero().flatten().tolist():
        ds = []
        for ids in (gi[b], wi[b]):
            diff = rows(b, ids.clamp_min(0).long()).double() - q[b].double()
            dist = diff.abs().sum(-1) if metric == "l1" else diff.pow(2).sum(-1).sqrt()
            dist = torch.where(ids >= 0, dist, torch.full_like(dist, float("inf")))
            ds.append(dist.sort().values)
        np.testing.assert_array_equal(np.isinf(np_(ds[0])), np.isinf(np_(ds[1])))
        fin = torch.isfinite(ds[1])
        np.testing.assert_allclose(np_(ds[0][fin]), np_(ds[1][fin]), rtol=rtol, atol=0)


def assert_results_match(got, want) -> None:
    """A port SearchResult against a reference one: every field exact but
    `dists`, which is held to DIST_RTOL; shapes and dtypes equal."""
    for field in want._fields:
        g, w = np_(getattr(got, field)), np_(getattr(want, field))
        assert g.shape == w.shape, (field, g.shape, w.shape)
        assert g.dtype == w.dtype, (field, g.dtype, w.dtype)
        if field == "dists":
            assert_dists_close(g, w, err_msg=field)
        else:
            np.testing.assert_array_equal(g, w, err_msg=field)


INDEX_FIELDS = ("points_sorted", "coords_sorted", "labels_sorted", "ids_sorted", "offsets")


def assert_index_equal(got, want, fields=INDEX_FIELDS) -> None:
    """Two GridIndex (either package, dense or stacked) equal in every
    array, bit for bit."""
    for f in fields:
        np.testing.assert_array_equal(np_(getattr(got, f)), np_(getattr(want, f)), err_msg=f)
    assert len(got.pyramid) == len(want.pyramid)
    for lv, (a, b) in enumerate(zip(got.pyramid, want.pyramid)):
        np.testing.assert_array_equal(np_(a), np_(b), err_msg=f"pyramid[{lv}]")
    for f in ("pyr_tiles", "sat"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np_(a), np_(b), err_msg=f)


def assert_trees_equal(got: dict, want: dict, msg: str = "") -> None:
    """Two `state_to_tree` dicts (either package) equal array for array:
    keys, dtypes, shapes, values."""
    got = {k: np_(v) for k, v in got.items()}
    want = {k: np_(v) for k, v in want.items()}
    assert sorted(got) == sorted(want), (msg, sorted(set(got) ^ set(want)))
    for key, w in want.items():
        g = got[key]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (msg, key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {key}")


def require_cuda() -> torch.device:
    """The card, or skip with the reason (decided inside the test body)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Hopper kernels run only there")
    return torch.device("cuda")
