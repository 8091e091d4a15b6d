"""The port's `models/xlstm.py` against the JAX package's: the mLSTM
(chunkwise-parallel) and sLSTM (a loop over tokens) blocks' prefill
(output and decode cache), training form and decode step, on the same
weights and inputs.

xlstm-125m's SMOKE widths (d_model 64, 4 heads; mLSTM d_inner 128, sLSTM
84, chunk 16).  Cases: S a multiple of the mLSTM chunk, S not a multiple
(the last chunk padded with identity steps, log_f = 0 and i = 0), a chunk
longer than S, and decode steps after a prefill equal to the training form
at the same positions; float32 to F32_TOL and bf16 (the reference's
default) to BF16_TOL.  The sLSTM's stabiliser starts at m = -10.
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
from repro.models import xlstm as JX
from repro_torch.models import layers as TL
from repro_torch.models import xlstm as TX

ARCH = "xlstm-125m"
KINDS = {  # kind -> (init, prefill, block, decode step, cache init, weights kept float32)
    "mlstm": ("init_mlstm", "mlstm_prefill", "mlstm_block", "mlstm_decode_step",
              "init_mlstm_cache", ()),
    "slstm": ("init_slstm", "slstm_prefill", "slstm_block", "slstm_decode_step",
              "init_slstm_cache", TX.SLSTM_F32_WEIGHTS),
}


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def _fns(mod, kind):
    return [getattr(mod, name) for name in KINDS[kind][:5]]


def _params(jcfg, kind, seed=0):
    """The reference's init; the port's copy stored as the model stores it."""
    p = jax.tree.map(np.asarray, _fns(JX, kind)[0](jax.random.PRNGKey(seed), jcfg))
    if kind == "slstm":   # a non-zero bias, so the test sees where it is added
        p["bias"] = np.random.default_rng(seed).normal(size=p["bias"].shape).astype(np.float32)

    def port(key, a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(TL.ACT_DTYPE) if t.dim() >= 2 and key not in KINDS[kind][5] else t
    return jax.tree.map(jnp.asarray, p), {k: port(k, a) for k, a in p.items()}


def _x(jcfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, jcfg.d_model)).astype(np.float32)


def _same_cache(got: dict, want: dict, tol: dict, what="") -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape
        assert got[key].dtype == torch.float32 and w.dtype == jnp.float32, key
        np.testing.assert_allclose(_f32(got[key]), _f32(w), **tol, err_msg=f"{what} {key}")


def _check_prefill(kind, s, tol, seed=0):
    jcfg = jconfigs.get_smoke(ARCH)
    _, j_prefill, _, _, _ = _fns(JX, kind)
    _, t_prefill, t_block, _, _ = _fns(TX, kind)
    jp, tp = _params(jcfg, kind, seed)
    x = _x(jcfg, 2, s, seed + 1)
    want, wcache = j_prefill(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got, gcache = t_prefill(tp, cfg_of(jcfg), torch.from_numpy(x))
        block = t_block(tp, cfg_of(jcfg), torch.from_numpy(x))
    assert got.dtype == TL.ACT_DTYPE and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_array_equal(np_(block.float()), np_(got.float()))
    _same_cache(gcache, wcache, tol)


@pytest.mark.parametrize("s", [32, 21, 10], ids=["two_chunks", "ragged_last_chunk",
                                                 "chunk_longer_than_s"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_prefill_matches_reference_f32(kind, s, f32_mode):
    assert jconfigs.get_smoke(ARCH).xlstm.chunk == 16
    _check_prefill(kind, s, F32_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_prefill_matches_reference_bf16(kind):
    _check_prefill(kind, 21, BF16_TOL, seed=2)


def _check_decode(kind, tol, prompt=12, steps=4, seed=3):
    jcfg = jconfigs.get_smoke(ARCH)
    _, j_prefill, _, j_step, _ = _fns(JX, kind)
    _, t_prefill, t_block, t_step, _ = _fns(TX, kind)
    jp, tp = _params(jcfg, kind, seed)
    x = _x(jcfg, 2, prompt + steps, seed + 1)
    _, wcache = j_prefill(jp, jcfg, jnp.asarray(x[:, :prompt]))
    with torch.no_grad():
        _, gcache = t_prefill(tp, cfg_of(jcfg), torch.from_numpy(x[:, :prompt]))
        full = t_block(tp, cfg_of(jcfg), torch.from_numpy(x))
    outs = []
    for i in range(steps):
        xi = x[:, prompt + i:prompt + i + 1]
        want, wcache = j_step(jp, jcfg, jnp.asarray(xi), wcache)
        with torch.no_grad():
            got, gcache = t_step(tp, cfg_of(jcfg), torch.from_numpy(xi), gcache)
        np.testing.assert_allclose(_f32(got), _f32(want), **tol, err_msg=f"step {i}")
        _same_cache(gcache, wcache, tol, f"step {i}")
        outs.append(got)
    return torch.cat(outs, dim=1), full[:, prompt:]


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_matches_reference_and_the_training_form_f32(kind, f32_mode):
    dec, full = _check_decode(kind, F32_TOL)
    np.testing.assert_allclose(_f32(dec), _f32(full), **F32_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_decode_matches_reference_bf16(kind):
    _check_decode(kind, BF16_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_init_and_cache_match_reference(kind):
    """The inits' leaves at the reference's shapes (fgate_bias 3, the sLSTM
    bias 0); the caches' states float32 at the reference's shapes, the
    sLSTM's m at -10."""
    jcfg = jconfigs.get_smoke(ARCH)
    j_init, _, _, _, j_cache = _fns(JX, kind)
    t_init, _, _, _, t_cache = _fns(TX, kind)
    want = j_init(jax.random.PRNGKey(0), jcfg)
    got = t_init(torch.Generator().manual_seed(0), cfg_of(jcfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for key in ("fgate_bias", "bias"):
        if key in want:
            np.testing.assert_array_equal(np_(got[key]), np.asarray(want[key]))
    _same_cache(t_cache(cfg_of(jcfg), 3), j_cache(jcfg, 3), dict(rtol=0, atol=0))
