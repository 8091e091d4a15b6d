"""The port's AdamW and gradient compression against the reference's
(`repro/optim/`), on the same float32 trees made from a seed: the cases of
tests/test_optim.py, each also run through the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as hst
from _torch_port import np_

from repro.configs import ARCH_NAMES, get_smoke as jget_smoke
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro_torch.configs import get_smoke
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.utils import tree


# the reference as its train step runs it: jitted (XLA divides by the
# constant 127 as a multiply by its float32 reciprocal, as the port does)
_jcompress_leaf = jax.jit(JC.compress_leaf)
_jcompress_grads = jax.jit(JC.compress_grads)


def _t(tree_np):
    return tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree_np)


def _j(tree_np):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree_np)


def _same(got, want, rtol, atol=0.0):
    g, w = dict(tree.leaves_with_path(got)), dict(tree.leaves_with_path(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(np_(g[k]), np.asarray(w[k]), rtol=rtol, atol=atol, err_msg=k)


def _tree_np(seed):
    """A params-like tree: a stacked block with a matrix, a norm and a
    bias, an embedding and a final norm (decayed and masked names)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"embed": f(16, 8), "final_norm": f(8),
            "blocks": [{"norm1": f(2, 8), "core": {"wq": f(2, 8, 4), "bias": f(2, 4)}}]}


def test_adamw_minimizes_quadratic():
    for lib, conv in ((TA, lambda a: torch.tensor(a)), (JA, jnp.asarray)):
        cfg = lib.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200)
        params = {"x": conv([5.0, -3.0])}
        state = lib.init(params)
        for _ in range(150):
            params, state, _ = lib.update(cfg, {"x": 2 * params["x"]}, state, params)
        assert float(np.abs(np_(params["x"])).max()) < 0.2


def test_clip_by_global_norm():
    clipped, norm = TA.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    jclipped, jnorm = JA.clip_by_global_norm({"a": jnp.asarray([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6 and float(norm) == float(jnorm)
    np.testing.assert_allclose(np_(clipped["a"]), [0.6, 0.8], rtol=1e-5)
    np.testing.assert_array_equal(np_(clipped["a"]), np.asarray(jclipped["a"]))


def test_schedule_warmup_and_cosine():
    cfg = TA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = JA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(TA.schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(TA.schedule(cfg, torch.tensor(10, dtype=torch.int32))) - 1.0) < 1e-6
    assert abs(float(TA.schedule(cfg, torch.tensor(100, dtype=torch.int32))) - 0.1) < 1e-3
    for s in range(0, 120, 7):
        got = float(TA.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(float(JA.schedule(jcfg, jnp.int32(s))), rel=1e-6, abs=1e-9)


def test_decay_mask_excludes_norms():
    params = {"w": torch.ones((2, 2)), "norm1": torch.ones((2,))}
    zero_g = tree.map(torch.zeros_like, params)
    cfg2 = TA.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0, eps=1.0)
    new2, _, _ = TA.update(cfg2, zero_g, TA.init(params), params)
    assert float(new2["w"][0, 0]) < 1.0           # decayed
    assert float(new2["norm1"][0]) == 1.0          # masked
    assert float(params["w"][0, 0]) == 1.0         # the inputs are left as they are


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decay_mask_agrees_on_every_leaf(arch):
    """The port's `_decay_mask` on its train state's param paths equals the
    reference's on the reference's paths, leaf for leaf, at every SMOKE
    config (the two trees have the same paths)."""
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jget_smoke(arch)))
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): JA._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    state = TS.train_state_shapes(get_smoke(arch), TA.AdamWConfig(), TS.StepConfig())
    got = {path: TA._decay_mask(path) for path, _ in tree.leaves_with_path(state["params"])}
    assert got == want
    assert not all(want.values()) and any(want.values())


def test_update_equals_reference_over_five_steps():
    """`update` on the same float32 trees and gradients as the reference's,
    5 steps (warmup, clipping at a small clip_norm, decay and masked
    leaves): params, moments, count and metrics within 1e-6 relative."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=0.5)
    tcfg, jcfg = TA.AdamWConfig(**kw), JA.AdamWConfig(**kw)
    p0 = _tree_np(0)
    tp, jp = _t(p0), _j(p0)
    ts, js = TA.init(tp), JA.init(jp)
    upd = jax.jit(lambda g, s, p: JA.update(jcfg, g, s, p))
    for i in range(5):
        g = _tree_np(100 + i)
        tp, ts, tm = TA.update(tcfg, _t(g), ts, tp)
        jp, js, jm = upd(_j(g), js, jp)
        _same(tp, jp, rtol=1e-6, atol=1e-7)
        _same(ts.mu, js.mu, rtol=1e-6, atol=1e-9)
        _same(ts.nu, js.nu, rtol=1e-6, atol=1e-12)
        assert int(ts.count) == int(js.count) == i + 1
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_compression_error_feedback_unbiased():
    """Sum of dequantized grads ≈ sum of true grads (error feedback); and
    each round, given the reference's residual, equal to the reference's."""
    rng = np.random.default_rng(0)
    err, jerr = torch.zeros((64,)), jnp.zeros((64,))
    total_true, total_hat = np.zeros((64,)), np.zeros((64,))
    for i in range(50):
        g = (rng.normal(size=64) * (1 + i % 5)).astype(np.float32)
        same_hat, same_err = TC.compress_leaf(torch.from_numpy(g), torch.from_numpy(np_(jerr)))
        jg_hat, jerr = _jcompress_leaf(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(np_(same_hat), np.asarray(jg_hat))
        # the residual g + err - g_hat: XLA may fuse the subtraction (an ulp of g)
        np.testing.assert_allclose(np_(same_err), np.asarray(jerr), rtol=0,
                                   atol=2 * np.finfo(np.float32).eps * np.abs(g).max())
        g_hat, err = TC.compress_leaf(torch.from_numpy(g), err)
        total_true += g
        total_hat += np_(g_hat)
    scale = np.abs(total_true).max() / 127
    np.testing.assert_allclose(total_hat, total_true, atol=10 * scale)


@settings(max_examples=20, deadline=None)
@given(seed=hst.integers(0, 2**31 - 1))
def test_compression_residual_bounded(seed):
    g = np.random.default_rng(seed).normal(size=32).astype(np.float32)
    g_hat, err = TC.compress_leaf(torch.from_numpy(g), torch.zeros((32,)))
    jg_hat, _ = _jcompress_leaf(jnp.asarray(g), jnp.zeros((32,)))
    step = float(np.abs(g).max()) / 127
    assert float(err.abs().max()) <= step * 0.51 + 1e-6
    np.testing.assert_array_equal(np_(g_hat), np.asarray(jg_hat))


def test_compress_grads_tree_matches_reference():
    g, e = _tree_np(1), _tree_np(2)
    tg, te = TC.compress_grads(_t(g), _t(e))
    jg, je = _jcompress_grads(_j(g), _j(e))
    _same(tg, jg, rtol=1e-6, atol=1e-7)
    _same(te, je, rtol=1e-5, atol=1e-6)
    _same(TC.init_error(_t(g)), jax.tree.map(np.asarray, JC.init_error(_j(g))), rtol=0)


def test_compressed_training_tracks_uncompressed():
    """Quadratic descent with int8+EF grads stays close to exact descent."""
    cfg = TA.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0)
    p1 = {"x": torch.tensor([4.0, -2.0, 1.0])}
    p2 = tree.map(torch.clone, p1)
    s1, s2 = TA.init(p1), TA.init(p2)
    err = TC.init_error(p1)
    for _ in range(100):
        p1, s1, _ = TA.update(cfg, {"x": 2 * p1["x"]}, s1, p1)
        g2c, err = TC.compress_grads({"x": 2 * p2["x"]}, err)
        p2, s2, _ = TA.update(cfg, g2c, s2, p2)
    np.testing.assert_allclose(np_(p1["x"]), np_(p2["x"]), atol=0.05)
