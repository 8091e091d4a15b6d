"""The port's `models/mamba.py` against the JAX package's: the Mamba
sublayer's prefill (output and decode cache), its training form and its
decode step, on the same weights and inputs.

jamba's SMOKE widths (d_model 64, d_inner 128, d_state 8, d_conv 4, chunk
16).  The reference solves each chunk's recurrence with a log-depth tree,
the port with a loop over the chunk's tokens, so float32 results agree to
F32_TOL, not bit for bit.  Cases: S a multiple of the chunk (two chunks),
S not a multiple (the reference pads the last chunk with identity steps,
dt = 0; the port's last chunk is shorter), a chunk longer than S, and
decode steps after a prefill equal to the training form at the same
positions.  bf16 (the reference's default) is held to BF16_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_
from test_torch_models import BF16_TOL, F32_TOL, _f32, cfg_of

import repro.models.layers as JL
from repro import configs as jconfigs
from repro.models import mamba as JMa
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMa

ARCH = "jamba-v0.1-52b"


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def _params(jcfg, seed=0):
    """The reference's init_mamba; the port's copy stored as the model
    stores it (dt_proj and A_log float32, other matrices ACT_DTYPE)."""
    p = jax.tree.map(np.asarray, JMa.init_mamba(jax.random.PRNGKey(seed), jcfg))

    def port(key, a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(TL.ACT_DTYPE) if t.dim() >= 2 and key not in TMa.F32_WEIGHTS else t
    return jax.tree.map(jnp.asarray, p), {k: port(k, a) for k, a in p.items()}


def _x(jcfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, jcfg.d_model)).astype(np.float32)


def _same_cache(got: dict, want: dict, tol: dict) -> None:
    assert sorted(got) == sorted(want) == ["conv", "ssm"]
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape
        assert str(got[key].dtype).replace("torch.", "") == np.dtype(w.dtype).name, key
        np.testing.assert_allclose(_f32(got[key]), _f32(w), **tol, err_msg=key)


def _check_prefill(jcfg, s, tol, seed=0):
    jp, tp = _params(jcfg, seed)
    x = _x(jcfg, 2, s, seed + 1)
    want, wcache = JMa.mamba_prefill(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, gcache = TMa.mamba_prefill(tp, cfg_of(jcfg), torch.from_numpy(x))
        block = TMa.mamba_block(tp, cfg_of(jcfg), torch.from_numpy(x))
    assert got.dtype == TL.ACT_DTYPE and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_array_equal(np_(block.float()), np_(got.float()))
    _same_cache(gcache, wcache, tol)


@pytest.mark.parametrize("s", [32, 21, 10], ids=["two_chunks", "ragged_last_chunk",
                                                 "chunk_longer_than_s"])
def test_mamba_prefill_matches_reference_f32(s, f32_mode):
    jcfg = jconfigs.get_smoke(ARCH)
    assert jcfg.mamba.chunk == 16
    _check_prefill(jcfg, s, F32_TOL)


def test_mamba_prefill_matches_reference_bf16():
    _check_prefill(jconfigs.get_smoke(ARCH), 21, BF16_TOL, seed=2)


def _check_decode(jcfg, tol, prompt=12, steps=4, seed=3):
    """prefill(prompt) then `steps` decode steps on both sides, each step's
    output and new cache against the reference's; and the decode outputs
    against the training form over all prompt + steps tokens."""
    jp, tp = _params(jcfg, seed)
    x = _x(jcfg, 2, prompt + steps, seed + 1)
    _, wcache = JMa.mamba_prefill(jp, jcfg, jnp.asarray(x[:, :prompt]))
    with torch.no_grad():
        _, gcache = TMa.mamba_prefill(tp, cfg_of(jcfg), torch.from_numpy(x[:, :prompt]))
        full = TMa.mamba_block(tp, cfg_of(jcfg), torch.from_numpy(x))
    outs = []
    for i in range(steps):
        xi = x[:, prompt + i:prompt + i + 1]
        want, wcache = JMa.mamba_decode_step(jp, jcfg, jnp.asarray(xi), wcache)
        with torch.no_grad():
            got, gcache = TMa.mamba_decode_step(tp, cfg_of(jcfg), torch.from_numpy(xi), gcache)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol, err_msg=f"step {i}")
        _same_cache(gcache, wcache, tol)
        outs.append(got)
    return torch.cat(outs, dim=1), full[:, prompt:]


def test_mamba_decode_matches_reference_and_the_training_form_f32(f32_mode):
    dec, full = _check_decode(jconfigs.get_smoke(ARCH), F32_TOL)
    np.testing.assert_allclose(_f32(dec), _f32(full), **F32_TOL)


def test_mamba_decode_matches_reference_bf16():
    """bf16: the decode's rounding points (the conv's products rounded,
    summed in float32; SiLU rounded then lifted) are the reference's."""
    _check_decode(jconfigs.get_smoke(ARCH), BF16_TOL)


def test_mamba_decode_leaves_the_given_cache_alone(f32_mode):
    """mamba_decode_step returns new state tensors; the model writes them
    over its cache (the conv window's shift is read from a fresh
    concatenation, so no copy runs between overlapping views)."""
    jcfg = jconfigs.get_smoke(ARCH)
    _, tp = _params(jcfg)
    cache = TMa.init_mamba_cache(cfg_of(jcfg), 2, device="cpu")
    cache["conv"].normal_(generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.from_numpy(_x(jcfg, 2, 1))
    _, new = TMa.mamba_decode_step(tp, cfg_of(jcfg), x, cache)
    for key in cache:
        assert torch.equal(cache[key], before[key])
        assert new[key].data_ptr() != cache[key].data_ptr()
    np.testing.assert_array_equal(np_(new["conv"][:, :-1]), np_(before["conv"][:, 1:]))


def test_mamba_init_and_cache_shapes_match_reference():
    """init_mamba's leaves and init_mamba_cache's states at the reference's
    shapes and dtypes; A_log = log(1..d_state), D = 1, dt_bias the inverse
    softplus of values in [1e-3, 1e-1]."""
    jcfg = jconfigs.get_smoke(ARCH)
    want = JMa.init_mamba(jax.random.PRNGKey(0), jcfg)
    got = TMa.init_mamba(torch.Generator().manual_seed(0), cfg_of(jcfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for key in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(np_(got[key]), np.asarray(want[key]), rtol=1e-6)
    dt = np_(torch.nn.functional.softplus(got["dt_bias"]))
    assert dt.min() >= 1e-3 - 1e-7 and dt.max() <= 1e-1 + 1e-7
    jc, tc = JMa.init_mamba_cache(jcfg, 3), TMa.init_mamba_cache(cfg_of(jcfg), 3)
    for key in ("conv", "ssm"):
        assert (tuple(tc[key].shape), str(tc[key].dtype)) == \
            (jc[key].shape, "torch." + np.dtype(jc[key].dtype).name)
