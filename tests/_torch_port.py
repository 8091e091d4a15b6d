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


def require_cuda() -> torch.device:
    """The card, or skip with the reason (decided inside the test body)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Hopper kernels run only there")
    return torch.device("cuda")
