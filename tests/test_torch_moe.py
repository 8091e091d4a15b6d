"""The port's `models/moe.py` against the JAX package's: `moe_block`'s
output, its Switch aux loss and the router's decisions, on the same
weights and inputs.

The router's decisions are read from both sides as they are made: the
reference's top-k ids from its `jax.lax.top_k` call and its capacity
ranks from its last `jax.nn.one_hot` call (rank_i, with `cap` for a
dropped slot), the port's from `moe.route`, each through a spy that
returns what it wraps.  In float32 (both packages' ACT_DTYPE switched) the
ids and the kept mask are equal and the outputs within F32_TOL; in bf16,
the reference's default, the same on inputs whose router logits have no
near-tie, outputs within BF16_TOL.  Cases: qwen2-moe's SMOKE (padded and
shared experts) and dbrx's (neither), a last group padded with zero rows,
a tie at the k-th place (ties go to the lower index), and a decode batch
of 8 rows over 60 experts whose capacity (4) drops tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_
from test_torch_models import BF16_TOL, F32_TOL, _f32, cfg_of

import repro.models.layers as JL
from repro import configs as jconfigs
from repro.models import moe as JMoE
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def _params(jcfg, seed=0, **overrides):
    """The reference's init_moe, numpy leaves replaced by `overrides`; the
    port's copy of them (matrices in ACT_DTYPE, as the model stores them)."""
    p = jax.tree.map(np.asarray, JMoE.init_moe(jax.random.PRNGKey(seed), jcfg))
    p.update(overrides)

    def port(a):
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(TL.ACT_DTYPE) if t.dim() >= 2 else t
    return jax.tree.map(jnp.asarray, p), jax.tree.map(port, p)


def _run(jcfg, jp, tp, x):
    """Both moe_blocks on x (numpy): (ref y, ref aux, ref ids, ref kept),
    (port y, port aux, port Routing)."""
    seen = {"one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def top_k_spy(a, k):
        seen["top_k"] = top_k(a, k)
        return seen["top_k"]

    def one_hot_spy(a, n, **kw):
        seen["one_hot"].append((a, n))
        return one_hot(a, n, **kw)

    route = TMoE.route

    def route_spy(*args):
        seen["route"] = route(*args)
        return seen["route"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", top_k_spy)
        mp.setattr(jax.nn, "one_hot", one_hot_spy)
        mp.setattr(TMoE, "route", route_spy)
        wy, waux = JMoE.moe_block(jp, jcfg, jnp.asarray(x))
        with torch.no_grad():
            gy, gaux = TMoE.moe_block(tp, cfg_of(jcfg), torch.from_numpy(x))
    rank_i, cap = seen["one_hot"][-1]
    assert cap == TMoE.group_shape(cfg_of(jcfg), x.shape[0] * x.shape[1])[2]
    ids = np.asarray(seen["top_k"][1])
    return (wy, waux, ids, np.asarray(rank_i) < cap), (gy, gaux, seen["route"])


def _check(jcfg, jp, tp, x, tol):
    (wy, waux, ids, kept), (gy, gaux, r) = _run(jcfg, jp, tp, x)
    np.testing.assert_array_equal(np_(r.top_i), ids)
    np.testing.assert_array_equal(np_(r.keep), kept)
    assert gy.shape == wy.shape and gy.dtype == TL.ACT_DTYPE
    np.testing.assert_allclose(_f32(gy), _f32(wy), **tol)
    np.testing.assert_allclose(float(gaux), float(waux), **tol)
    return r, wy, gy


def _x(jcfg, b, s, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 16), (3, 25)], ids=["one_group", "padded_last_group"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_moe_block_matches_reference_f32(arch, shape, f32_mode):
    """Output, aux loss, ids and kept mask; T = 32 tokens (one group) and
    T = 75 (two groups of 64, the last padded), qwen2-moe's padded experts
    never picked."""
    jcfg = jconfigs.get_smoke(arch)
    jp, tp = _params(jcfg)
    r, _, _ = _check(jcfg, jp, tp, _x(jcfg, *shape), F32_TOL)
    assert int(r.top_i.max()) < jcfg.moe.n_experts
    assert r.probs.shape[-1] == jcfg.moe.n_total


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
def test_moe_block_matches_reference_bf16(arch):
    jcfg = jconfigs.get_smoke(arch)
    jp, tp = _params(jcfg, seed=2)
    _check(jcfg, jp, tp, _x(jcfg, 2, 16, seed=3), BF16_TOL)


def _tied_router(jcfg, tie=(3, 5)):
    """A router whose logits put experts 0, 1, 2 first for positive inputs
    and experts `tie` level at the 4th place (identical columns)."""
    d, e = jcfg.d_model, jcfg.moe.n_total
    rng = np.random.default_rng(7)
    router = -np.abs(rng.normal(size=(d, e))).astype(np.float32) * 0.05
    for j, scale in zip((0, 1, 2), (0.5, 0.4, 0.3)):
        router[:, j] = scale / d
    column = np.abs(rng.normal(size=d)).astype(np.float32) * 0.1 / d
    for j in tie:
        router[:, j] = column
    return router


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_router_tie_at_the_kth_place_goes_to_the_lower_index(mode, monkeypatch):
    """Experts 3 and 5 share every token's 4th-largest probability exactly:
    the reference (lax.top_k) and the port both take expert 3, for every
    token, and drop 5."""
    if mode == "f32":
        monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
        monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)
    jcfg = jconfigs.get_smoke("qwen2-moe-a2.7b")
    jp, tp = _params(jcfg, router=_tied_router(jcfg))
    x = np.abs(_x(jcfg, 2, 16, seed=4)) + 0.5
    tol = F32_TOL if mode == "f32" else BF16_TOL
    r, _, _ = _check(jcfg, jp, tp, x, tol)
    assert torch.equal(r.probs[..., 3], r.probs[..., 5])      # a real tie
    np.testing.assert_array_equal(np_(r.top_i)[..., 3], 3)
    np.testing.assert_array_equal(np.sort(np_(r.top_i)[..., :3], -1), [0, 1, 2] * np.ones((1, 32, 3)))


def test_decode_batch_drops_tokens_at_capacity(f32_mode):
    """8 decode rows over 60 experts (padded to 64) at top-4: g = 8 and
    C = max(4, round(8 * 4 / 60 * 1.25)) = 4.  Every row's first choice is
    expert 7, so rows 4-7 lose it (slot-major ranks: first choices first,
    in row order), as in the reference; their outputs lack expert 7's."""
    base = jconfigs.get_smoke("qwen2-moe-a2.7b")
    jcfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=60, n_padded=4, d_expert=16, capacity_factor=1.25))
    rng = np.random.default_rng(8)
    router = rng.normal(size=(jcfg.d_model, 64)).astype(np.float32) * 0.01
    router[:, 7] = 1.0 / jcfg.d_model
    jp, tp = _params(jcfg, router=router)
    x = np.abs(_x(jcfg, 8, 1, seed=9)) + 0.5
    assert TMoE.group_shape(cfg_of(jcfg), 8) == (1, 8, 4)
    r, wy, gy = _check(jcfg, jp, tp, x, F32_TOL)
    first = np_(r.top_i)[0, :, 0]
    np.testing.assert_array_equal(first, 7)
    np.testing.assert_array_equal(np_(r.keep)[0, :, 0], [True] * 4 + [False] * 4)
    # without the cap, exactly the rows that lost a slot come out otherwise
    roomy = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=20.0))
    with torch.no_grad():
        free, _ = TMoE.moe_block(tp, cfg_of(roomy), torch.from_numpy(x))
    whole = np_(r.keep)[0].all(-1)
    assert not whole[4:].any()
    np.testing.assert_allclose(np_(free)[whole], np_(gy)[whole], **F32_TOL)
    for row in np.flatnonzero(~whole):
        assert not np.allclose(np_(free)[row], np_(gy)[row], atol=1e-3), row


def test_init_moe_shapes_and_route_groups():
    """init_moe draws every leaf of the reference's tree at its shape (the
    shared MLP only where shared_d_ff > 0); group_shape is the reference's
    (G, g, C) arithmetic."""
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        jcfg = jconfigs.get_smoke(arch)
        want = jax.eval_shape(lambda: JMoE.init_moe(jax.random.PRNGKey(0), jcfg))
        got = TMoE.init_moe(torch.Generator().manual_seed(0), cfg_of(jcfg))
        assert jax.tree.map(lambda a: tuple(a.shape), got) == \
            jax.tree.map(lambda a: tuple(a.shape), want)
    full = cfg_of(jconfigs.get_config("qwen2-moe-a2.7b"))
    assert TMoE.group_shape(full, 8) == (1, 8, 4)
    assert TMoE.group_shape(full, 16 * 1024) == (32, 512, 43)
    jamba = cfg_of(jconfigs.get_config("jamba-v0.1-52b"))
    assert TMoE.group_shape(jamba, 4096) == (8, 512, 80)
