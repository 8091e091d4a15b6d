"""The port's LM stack against the JAX package's: the configs and their
registry, the shapes' stand-ins, `models/layers.py`, `models/attention.py`
and `models/model.py` (forward, prefill, decode_step, the decode caches)
for all ten architectures; the MoE, Mamba and xLSTM layers alone are in
test_torch_moe.py, test_torch_mamba.py and test_torch_xlstm.py.

The reference's weights (`init_params`) are carried across with
`convert.model_from_numpy`, so both packages compute with the same numbers.
Two modes:
- float32: the reference's `repro.models.layers.ACT_DTYPE` and the port's
  switched to float32 with monkeypatch (no file is edited; the reference
  then computes in float32 end to end).  Held to F32_TOL, greedy tokens
  equal.
- bf16, the reference's default: held to BF16_TOL, the tightest bound that
  held over the seeds tried (2 bf16 ulps of logits below 8, plus one
  relative ulp), far inside the reference's own prefill/decode tolerance
  (rtol 0.15, atol 0.15, tests/test_models.py), and top-1 agreement of at
  least 0.9 over every row compared (the reference's test asks 0.5 of the
  decode rows: bf16 logits tie often, and a tie goes to the first index).
  Archs with recurrent layers (Mamba, xLSTM) are held to BF16_RECURRENT_TOL:
  an ulp flip in a recurrent state is carried along the sequence (the
  scan's order and `exp` differ from XLA's by float32 ulps), which took one
  logit of jamba's SMOKE 0.078 off (seed 1 of 14 seeds tried; xLSTM 0.051
  over 8).
The whole-model reference runs unrolled and without remat (its own
`policy.scan_layers=False`, `remat="none"`: the same equations, op by op).
Scanned, XLA compiles the layer body and keeps fused bf16 intermediates in
float32, which moved qwen2-moe's SMOKE logits up to 0.17 from its own
unrolled forward; the port rounds where the unrolled reference rounds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_

import repro.models.layers as JL
from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import (caches_from_numpy, caches_to_numpy, model_from_numpy,
                                 model_to_numpy)
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.utils import tree as ttree

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -4)
BF16_RECURRENT_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -3)
BF16_TOP1 = 0.9
# every layer an attention layer with a dense SwiGLU MLP
ATTN_ONLY = ("minitron-8b", "stablelm-12b", "stablelm-3b", "internlm2-1.8b",
             "internvl2-1b", "musicgen-medium")
RECURRENT = ("jamba-v0.1-52b", "xlstm-125m")


@pytest.fixture
def f32_mode(monkeypatch):
    """Both packages' activation dtype switched to float32 for one test."""
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def _f32(x) -> np.ndarray:
    """A reference or port array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _batch(cfg, rng, b=2, s=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frame_embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@functools.lru_cache(maxsize=32)
def _init_params(cfg, seed):
    """The reference's `init_params` (float32 whatever ACT_DTYPE is), kept
    for the next test of the same config and seed."""
    return jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _models(cfg, seed=0):
    params = _init_params(cfg, seed)
    return params, model_from_numpy(jax.tree.map(np.asarray, params), cfg_of(cfg), device="cpu")


def unrolled(jcfg):
    """The reference's config run op by op: layers unrolled, no remat."""
    return dataclasses.replace(jcfg, policy=dataclasses.replace(
        jcfg.policy, scan_layers=False, remat="none"))


def _reference(jcfg, mode: str):
    """The reference's forward, prefill and decode_step on `unrolled(jcfg)`,
    called with keywords.  In bf16 op by op; in float32, where XLA's fused
    intermediates round nowhere the port does not, compiled (traced now,
    under this test's ACT_DTYPE), which is faster."""
    ucfg = unrolled(jcfg)
    fns = [functools.partial(f, cfg=ucfg) for f in (JM.forward, JM.prefill, JM.decode_step)]
    if mode == "f32":
        fns[1] = jax.jit(fns[1], static_argnames="cache_len")
        fns[0], fns[2] = jax.jit(fns[0]), jax.jit(fns[2])
    return fns


def cfg_of(jcfg):
    """The port's ModelConfig with every field of the reference's."""
    from repro_torch.models import config as tc

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tc, type(v).__name__)(**{f.name: conv(getattr(v, f.name))
                                                    for f in dataclasses.fields(v)})
        return v
    return conv(jcfg)


# ---------------------------------------------------------------- configs ---


def _fields(cfg) -> dict:
    return {"type": type(cfg).__name__,
            **{f.name: (_fields(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                        else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}}


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_config_registry_matches_reference(arch):
    """CONFIG and SMOKE field for field (nested MoE / Mamba / xLSTM /
    policy too), the parameter counts, and LONG_CONTEXT."""
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for get in ("get_config", "get_smoke"):
        want, got = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert _fields(got) == _fields(want), (arch, get)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.n_repeat, got.hq_eff, got.hkv_eff, got.vocab_eff) == \
            (want.n_repeat, want.hq_eff, want.hkv_eff, want.vocab_eff)
    assert tconfigs.long_context_mode(arch) == jconfigs.long_context_mode(arch)


def test_minitron_8b_size():
    cfg = tconfigs.get_config("minitron-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 8, 128, 16384, 256000)
    assert cfg.param_count() == 9_881_780_224
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_input_specs_match_reference(arch):
    """Every shape's stand-ins: the same structure, shapes and dtypes, on
    the meta device (nothing allocated), the decode caches of every layer
    kind too."""
    cfg = tconfigs.get_config(arch)
    for name in jshapes.SHAPES:
        assert tshapes.SHAPES[name] == tshapes.ShapeSpec(**dataclasses.asdict(jshapes.SHAPES[name]))
        want = jshapes.input_specs(jconfigs.get_config(arch), name)
        got = tshapes.input_specs(cfg, name)
        w_leaves, w_tree = jax.tree.flatten(want)
        g_leaves, g_tree = jax.tree.flatten(got)
        assert g_tree == w_tree, (arch, name)
        for g, w in zip(g_leaves, w_leaves):
            assert g.device.type == "meta"
            assert (tuple(g.shape), _dtype_name(g)) == (tuple(w.shape), np.dtype(w.dtype).name)


# ----------------------------------------------------------------- layers ---


def test_layers_match_reference(f32_mode):
    """rms_norm, rope_angles / apply_rope (half-split), swiglu (SiLU on
    wi's product), the inits' moments and softmax_cross_entropy, at
    float32 and, for the norm and RoPE, at bf16 (equal after rounding)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=32).astype(np.float32)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JL.rms_norm(jnp.asarray(x).astype(dt_j), jnp.asarray(scale), 1e-5)
        got = TL.rms_norm(torch.from_numpy(x).to(dt_t), torch.from_numpy(scale), 1e-5)
        assert got.dtype == dt_t
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6 if dt_t == torch.float32
                                   else 2.0 ** -8, atol=1e-6)
    pos = np.arange(7, dtype=np.int32) * 37
    cj, sj = JL.rope_angles(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope_angles(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_(st), np.asarray(sj), rtol=1e-5, atol=1e-6)
    q = rng.normal(size=(1, 7, 4, 16)).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(q), cj[None, :, None, :], sj[None, :, None, :])
    got = TL.apply_rope(torch.from_numpy(q), ct[None, :, None, :], st[None, :, None, :])
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    w = [rng.normal(size=s).astype(np.float32) * 0.2 for s in ((32, 48), (32, 48), (48, 32))]
    want = JL.swiglu(jnp.asarray(x), *map(jnp.asarray, w))
    got = TL.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the arms are not interchangeable: SiLU gates wi's product
    swapped = TL.swiglu(torch.from_numpy(x), *map(torch.from_numpy, (w[1], w[0], w[2])))
    assert not np.allclose(np_(swapped), np.asarray(want), atol=1e-3)
    logits = rng.normal(size=(3, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 6)).astype(np.int32)
    mask = (rng.random((3, 6)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                        None if m is None else jnp.asarray(m))
        got = TL.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    d = TL.dense_init(gen, (256, 512))
    assert d.dtype == torch.float32 and abs(float(d.std()) - 256 ** -0.5) < 2e-3
    assert abs(float(TL.embed_init(gen, (512, 256)).std()) - 0.02) < 2e-4


# -------------------------------------------------------------- attention ---


def _attn_cfg(n_heads=8, n_kv_heads=2, pad_heads_to=0, pad_kv_heads_to=0, attn_chunk=1024):
    cfg = jconfigs.get_smoke("internlm2-1.8b")
    return dataclasses.replace(
        cfg, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=16,
        policy=dataclasses.replace(cfg.policy, pad_heads_to=pad_heads_to,
                                   pad_kv_heads_to=pad_kv_heads_to, attn_chunk=attn_chunk))


def _attn_params(cfg, seed=0):
    p = JA.init_attention(jax.random.PRNGKey(seed), cfg)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("case", ["gqa_8_2", "chunked_s_gt_chunk", "padded_heads", "mha_padded_kv"])
def test_attention_block_matches_reference(case, f32_mode):
    """attention_block (and prefill_cache's output and cache) at GQA 8/2, a
    chunked causal case with S = 4 chunks of 8, q heads padded 6 -> 8 (the
    pad heads masked), and MHA with both head counts padded."""
    kw, s = {
        "gqa_8_2": (dict(), 12),
        "chunked_s_gt_chunk": (dict(attn_chunk=8), 32),
        "padded_heads": (dict(n_heads=6, n_kv_heads=2, pad_heads_to=8), 12),
        "mha_padded_kv": (dict(n_heads=6, n_kv_heads=6, pad_heads_to=8, pad_kv_heads_to=8), 12),
    }[case]
    jcfg = _attn_cfg(**kw)
    tcfg = cfg_of(jcfg)
    jp, tp = _attn_params(jcfg)
    x = np.random.default_rng(1).normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = JA.attention_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), chunk=jcfg.policy.attn_chunk)
    got = TA.attention_block(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                             chunk=tcfg.policy.attn_chunk)
    np.testing.assert_allclose(np_(got), np.asarray(want), **F32_TOL)
    w_out, w_cache = JA.prefill_cache(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), s + 3)
    g_out, g_cache = TA.prefill_cache(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), s + 3)
    np.testing.assert_allclose(np_(g_out), np.asarray(w_out), **F32_TOL)
    for key in ("k", "v"):
        assert tuple(g_cache[key].shape) == w_cache[key].shape
        np.testing.assert_allclose(np_(g_cache[key]), np.asarray(w_cache[key]), **F32_TOL)
    if jcfg.hq_eff > jcfg.n_heads:
        # the pad heads' weights change nothing
        tp2 = {**tp, "wo": tp["wo"].clone()}
        tp2["wo"][jcfg.n_heads:] += 1.0
        np.testing.assert_array_equal(
            np_(TA.attention_block(tp2, tcfg, torch.from_numpy(x), torch.from_numpy(pos))),
            np_(got))


def test_causal_attention_chunk_must_divide(f32_mode):
    q = torch.zeros((1, 12, 2, 4))
    with pytest.raises(ValueError, match="must divide"):
        TA.causal_attention(q, q, q, chunk=8)


@pytest.mark.parametrize("retrieved", [False, True])
def test_decode_attention_matches_reference(retrieved, f32_mode):
    """decode_attention, and decode_attention_retrieved (local window 4 and
    retrieved positions, some invalid, some inside the window, some past
    pos), from the same prefilled cache; the port writes it in place."""
    jcfg = _attn_cfg()
    tcfg = cfg_of(jcfg)
    jp, tp = _attn_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    s, t = 10, 14
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    _, jcache = JA.prefill_cache(jp, jcfg, jnp.asarray(x), jnp.arange(s, dtype=jnp.int32), t)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    xd = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    pos = s
    if retrieved:
        r = np.array([[0, 3, 9, 12, 2], [1, 1, 8, 5, 13]], np.int32)
        ok = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
        want, wc = JA.decode_attention_retrieved(jp, jcfg, jnp.asarray(xd), jcache, jnp.int32(pos),
                                                 jnp.asarray(r), jnp.asarray(ok), 4)
        got, gc = TA.decode_attention_retrieved(tp, tcfg, torch.from_numpy(xd), tcache, pos,
                                                torch.from_numpy(r), torch.from_numpy(ok), 4)
    else:
        want, wc = JA.decode_attention(jp, jcfg, jnp.asarray(xd), jcache, jnp.int32(pos))
        got, gc = TA.decode_attention(tp, tcfg, torch.from_numpy(xd), tcache, pos)
    np.testing.assert_allclose(np_(got), np.asarray(want), **F32_TOL)
    assert gc["k"] is tcache["k"]
    for key in ("k", "v"):
        np.testing.assert_allclose(np_(tcache[key]), np.asarray(wc[key]), **F32_TOL)
    with pytest.raises(IndexError, match="outside the cache"):
        TA.decode_attention(tp, tcfg, torch.from_numpy(xd), tcache, t)


# ------------------------------------------------------------------ model ---


def _same_caches(got: list, want: list, tol: dict, what: str) -> None:
    """The port's caches (a list of dicts of tensors) against the
    reference's: the same keys, each leaf's shape and dtype, values within
    `tol`."""
    assert [sorted(c) for c in got] == [sorted(c) for c in want], what
    for g, w in zip(got, want):
        for key, leaf in w.items():
            assert (tuple(g[key].shape), _dtype_name(g[key])) == \
                (leaf.shape, np.dtype(leaf.dtype).name), (what, key)
            np.testing.assert_allclose(_f32(g[key]), _f32(leaf), **tol, err_msg=f"{what}: {key}")


def _check_model(arch, mode, seed):
    """forward (logits and the MoE aux loss), prefill of S-2 tokens (every
    cache leaf's shape, dtype and values), and one decode step (the states
    it writes in place too) against the reference (the same weights and
    inputs); the decode from the reference's own cache carried across
    too."""
    if mode == "f32":
        tol = F32_TOL
    else:
        tol = BF16_RECURRENT_TOL if arch in RECURRENT else BF16_TOL
    jcfg = jconfigs.get_smoke(arch)
    fwd, pref, dec = _reference(jcfg, mode)
    params, model = _models(jcfg, seed)
    rng = np.random.default_rng(seed)
    b, s = 2, 16
    batch = _batch(jcfg, rng, b, s)
    jb, tb = _both(batch)
    want, waux = fwd(params, batch=jb)
    with torch.no_grad():
        got, aux = model(tb)
    assert got.dtype == TL.ACT_DTYPE and aux.dtype == torch.float32
    if jcfg.moe is None:
        assert float(aux) == 0.0
    np.testing.assert_allclose(float(aux), float(waux), **tol)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    same = [(_f32(got).argmax(-1) == _f32(want).argmax(-1)).ravel()]

    pre = {k: (v[:, :s - 2] if k in ("tokens", "frame_embeds") else v) for k, v in batch.items()}
    jp, tp = _both(pre)
    wl, wcaches, wh = pref(params, batch=jp, cache_len=s)
    with torch.no_grad():
        gl, gcaches, gh = model.prefill(tp, cache_len=s)
    np.testing.assert_allclose(_f32(gl), _f32(wl), **tol)
    np.testing.assert_allclose(_f32(gh), _f32(wh), **tol)
    same.append(_f32(gl).argmax(-1) == _f32(wl).argmax(-1))
    _same_caches(gcaches, wcaches, tol, "prefill")
    tok = batch["tokens"][:, s - 2]
    wd, wnext, whd = dec(params, caches=wcaches, token=jnp.asarray(tok), pos=jnp.int32(s - 2))
    # the reference's cache carried across, so both decode from the same one
    carried = caches_from_numpy(jax.tree.map(np.asarray, wcaches), device="cpu")
    _same_caches(carried, wcaches, dict(rtol=0, atol=0), "carried")
    with torch.no_grad():
        gd, gnext, ghd = model.decode_step(gcaches, torch.from_numpy(tok), s - 2)
        cd, _, _ = model.decode_step(carried, torch.from_numpy(tok), s - 2)
    assert gnext is gcaches                      # written in place
    _same_caches(gcaches, wnext, tol, "decode")
    _same_caches(carried, wnext, tol, "decode from the carried cache")
    for g in (gd, cd):
        np.testing.assert_allclose(_f32(g), _f32(wd), **tol)
    np.testing.assert_allclose(_f32(ghd), _f32(whd), **tol)
    same.append(_f32(gd).argmax(-1) == _f32(wd).argmax(-1))
    top1 = np.mean(np.concatenate(same))      # over every row compared
    if mode == "f32":
        assert top1 == 1.0
        if jcfg.frontend != "audio":   # the forward's inputs there are frames, not tokens
            # decode == the training forward at the same position
            np.testing.assert_allclose(_f32(gd), _f32(got)[:, s - 2], **tol)
    else:
        assert top1 >= BF16_TOP1, top1


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_model_matches_reference_f32(arch, f32_mode):
    _check_model(arch, "f32", seed=0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_model_matches_reference_bf16(arch, seed):
    _check_model(arch, "bf16", seed)


def test_padded_vocab_masked(f32_mode):
    """pad_vocab_to: the pad columns read -1e30 in both packages and never
    win argmax; the real ones match."""
    base = jconfigs.get_smoke("internlm2-1.8b")
    jcfg = dataclasses.replace(base, policy=dataclasses.replace(base.policy, pad_vocab_to=520))
    params, model = _models(jcfg, seed=3)
    batch = _batch(jcfg, np.random.default_rng(3), 2, 8)
    jb, tb = _both(batch)
    want, _ = JM.forward(params, jcfg, jb)
    with torch.no_grad():
        got, _ = model(tb)
    assert got.shape == (2, 8, 520)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    assert (_f32(got)[..., 512:] == -1e30).all()
    assert (_f32(got).argmax(-1) < 512).all()


def _loss_params(model, tb):
    """The port's training loss (`loss_params`) on the model's weights as
    the reference's parameter tree (`model_to_numpy`)."""
    params = ttree.map(torch.from_numpy, model_to_numpy(model))
    return TM.loss_params(model.cfg, params, tb)


def test_loss_matches_reference(f32_mode):
    jcfg = jconfigs.get_smoke("stablelm-3b")
    params, model = _models(jcfg, seed=4)
    rng = np.random.default_rng(4)
    batch = _batch(jcfg, rng, 2, 8)
    batch["labels"] = rng.integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    batch["mask"] = (rng.random((2, 8)) < 0.7).astype(np.float32)
    jb, tb = _both(batch)
    want, _ = JM.loss_fn(params, jcfg, jb)
    with torch.no_grad():
        got, parts = _loss_params(model, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(parts["aux"]) == 0.0


def test_weights_stored_in_act_dtype():
    """Matrices in ACT_DTYPE (bf16 by default), the norm scales in float32;
    the caches' structure is the reference's."""
    cfg = tconfigs.get_smoke("internlm2-1.8b")
    model = TM.DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), name
    assert len(model.layers) == cfg.n_layers
    caches = TM.init_caches(cfg, 2, 9, device="cpu")
    want = JM.init_caches(jconfigs.get_smoke("internlm2-1.8b"), 2, 9)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in caches] == \
        [{k: v.shape for k, v in c.items()} for c in want]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.DecoderLM(cfg)


def test_moe_loss_carries_the_aux_loss(f32_mode):
    """An MoE model's loss is nll + 0.01 * the sum of its layers' aux
    losses, as the reference's; the aux loss is not 0."""
    jcfg = jconfigs.get_smoke("qwen2-moe-a2.7b")
    params, model = _models(jcfg, seed=5)
    rng = np.random.default_rng(5)
    batch = _batch(jcfg, rng, 2, 8)
    batch["labels"] = rng.integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    jb, tb = _both(batch)
    want, wparts = jax.jit(functools.partial(JM.loss_fn, cfg=unrolled(jcfg)))(params, batch=jb)
    with torch.no_grad():
        got, parts = _loss_params(model, tb)
    assert float(parts["aux"]) > 1.0
    np.testing.assert_allclose(float(parts["aux"]), float(wparts["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# the weights each layer kind stores in float32 (besides the vectors): the
# ones the reference casts to float32 where it uses them
F32_STORED = {"mamba": {"dt_proj", "A_log"}, "slstm": {"r", "bias"}}


def _stored_dtype(name: str, p, kind: str) -> torch.dtype:
    leaf = name.rsplit(".", 1)[-1]
    if p.dim() < 2 or (".core." in name and leaf in F32_STORED.get(kind, ())):
        return torch.float32
    return TL.ACT_DTYPE


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_weight_storage_dtypes(arch):
    """Every weight stored in the dtype the reference casts it to at use:
    Mamba's dt_proj and A_log and the sLSTM's r and bias in float32 (not
    rounded to bf16), the other matrices in ACT_DTYPE, the vectors in
    float32; model_from_numpy keeps those float32 weights' values."""
    jcfg = jconfigs.get_smoke(arch)
    params, model = _models(jcfg, seed=0)
    tcfg = model.cfg
    kinds = {name for name, _ in model.named_parameters()}
    assert len(kinds) == len(jax.tree.leaves(params)) + (jcfg.n_repeat - 1) * sum(
        len(jax.tree.leaves(blk)) for blk in params["blocks"])
    for name, p in model.named_parameters():
        kind = tcfg.pattern[int(name.split(".")[1]) % tcfg.block_period] if name.startswith(
            "layers.") else "attn"
        assert p.dtype == _stored_dtype(name, p, kind), name
    for i, layer in enumerate(model.layers):
        for leaf in F32_STORED.get(layer.kind, ()):
            want = np.asarray(params["blocks"][i % jcfg.block_period]["core"][leaf][
                i // jcfg.block_period])
            np.testing.assert_array_equal(np_(layer.core[leaf]), want)


def _ref_paths(tree) -> dict:
    """A reference tree's leaves by dotted path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_full_config_parameter_shapes_on_meta(arch):
    """Each full CONFIG built on the meta device (nothing allocated): every
    parameter's shape equals the reference's `init_params` leaf, from
    `jax.eval_shape` (nothing allocated either), padded experts and shared
    experts included, and the caches' shapes and dtypes equal the
    reference's `init_caches`."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    model = TM.DecoderLM(tcfg, device="meta")
    want = _ref_paths(jax.eval_shape(functools.partial(JM.init_params, cfg=jcfg),
                                     jax.random.PRNGKey(0)))
    got = {}
    period = tcfg.block_period
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            name = f"blocks.{int(i) % period}.{rest}"
            got.setdefault(name, []).append(tuple(p.shape))
        else:
            got[name] = [tuple(p.shape)]
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for name, shapes in got.items():
        w = want[name].shape
        assert shapes == ([w[1:]] * tcfg.n_repeat if name.startswith("blocks.") else [w]), name
    caches = TM.init_caches(tcfg, 2, 8, device="meta")
    ref = jax.eval_shape(lambda: JM.init_caches(jcfg, 2, 8))
    assert [sorted(c) for c in caches] == [sorted(c) for c in ref]
    for g, w in zip(caches, ref):
        for key, leaf in w.items():
            assert (tuple(g[key].shape), _dtype_name(g[key])) == \
                (leaf.shape, np.dtype(leaf.dtype).name), (arch, key)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_caches_carried_both_ways(arch):
    """init_caches against the reference's (shape, dtype, values: sLSTM's m
    starts at -10), and through caches_to_numpy / caches_from_numpy and
    back: each leaf keeps its shape, its dtype (k, v, conv in ACT_DTYPE,
    the recurrent states in float32, not rounded) and its values."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    want = JM.init_caches(jcfg, 2, 6)
    got = TM.init_caches(tcfg, 2, 6, device="cpu")
    _same_caches(got, want, dict(rtol=0, atol=0), "init_caches")
    rng = np.random.default_rng(0)
    filled = [{k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in c.items()}
              for c in want]
    carried = caches_from_numpy(filled, device="cpu")
    back = caches_to_numpy(carried)
    for f, c, bk in zip(filled, carried, back):
        for key, a in f.items():
            assert c[key].dtype == TM.cache_dtype(key) and bk[key].dtype == np.float32
            if c[key].dtype == torch.float32:
                np.testing.assert_array_equal(bk[key], a)     # not rounded
            else:
                np.testing.assert_array_equal(bk[key], np_(torch.from_numpy(a).to(c[key].dtype)
                                                           .float()))
    again = caches_to_numpy(caches_from_numpy(back, device="cpu"))
    for c, bk in zip(again, back):
        for key, a in bk.items():
            np.testing.assert_array_equal(c[key], a)
