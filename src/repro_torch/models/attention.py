"""GQA attention with KV cache: chunked-causal train/prefill, O(1) decode,
and the retrieval-augmented decode path (core/retrieval_memory).

Port of `repro/models/attention.py`.  Layouts:
  activations  (B, S, d)
  q/k/v        (B, S, H, hd)
  KV cache     (B, T, Hkv, hd)

GQA repeats k/v up to the full query-head count before the score product,
as the reference does.  The products are plain `torch.matmul` /
`torch.einsum` calls at the reference's rounding points (`_sdpa`): the
scores product in `ACT_DTYPE`, cast to float32 and divided by sqrt(hd),
masked with -1e30, a float32 softmax, the probabilities cast back to
`ACT_DTYPE` before P·V.  Neither `F.scaled_dot_product_attention` nor the
port's `flash_attention` kernel rounds at those points, and the reference
model calls no attention kernel, so neither is used here.

Params are mappings of tensors (`wq`, `wk`, `wv`, `wo`), as the reference's
dicts; the model holds them in an `nn.ParameterDict`.  Decode writes the
new k/v into the cache IN PLACE (the reference donates its cache buffers
to the step), so a caller who needs the old cache again clones it first.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import axes
from repro_torch.parallel.axes import constrain
from repro_torch.utils import scan as uscan

_TRAIN_HEADS = ("batch", "seq", "heads", "head_dim")
# decode follows the KV cache's layout (kv heads, or head_dim when they do
# not divide the model axis: parallel/sharding.cache_pspec)
_DECODE_HEADS = ("batch", "seq", "dec_heads", "dec_hd")


def init_attention(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    """The projections, drawn from `gen` (None: empty on `device`)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.hq_eff, cfg.hkv_eff   # padded for TP divisibility
    return {
        "wq": L.dense_init(gen, (d, hq, hd), fan_in=d, device=device),
        "wk": L.dense_init(gen, (d, hkv, hd), fan_in=d, device=device),
        "wv": L.dense_init(gen, (d, hkv, hd), fan_in=d, device=device),
        "wo": L.dense_init(gen, (hq, hd, d), fan_in=cfg.n_heads * hd, device=device),
    }


def _head_mask(cfg: ModelConfig, out: torch.Tensor) -> torch.Tensor:
    """Zero the padded heads' outputs: pad heads contribute nothing, so the
    model's capacity stays exactly the assigned config's."""
    if cfg.hq_eff == cfg.n_heads:
        return out
    mask = (torch.arange(cfg.hq_eff, device=out.device) < cfg.n_heads).to(out.dtype)
    return out * mask[None, None, :, None]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.to(out.dtype).reshape(h * k, d))


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Projections + RoPE.  positions: (S,) int."""
    xd = x.to(L.ACT_DTYPE)
    q = _project(xd, params["wq"])
    k = _project(xd, params["wk"])
    v = _project(xd, params["wv"])
    cos, sin = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos[None, :, None, :], sin[None, :, None, :])
    k = L.apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])
    q = constrain(q, *_TRAIN_HEADS)
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int, logical: tuple = _TRAIN_HEADS) -> torch.Tensor:
    """(B, T, Hkv, hd) -> (B, T, Hq, hd) by repeating each kv head G times,
    pinned to `logical` (the train layout; decode passes the cache's)."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k if logical is _TRAIN_HEADS else constrain(k, *logical)
    return constrain(torch.repeat_interleave(k, n_heads // hkv, dim=2), *logical)


def _sdpa(q, k, v, mask):
    """q (B, S, H, hd); k, v (B, T, H, hd), already GQA-expanded; mask
    (S, T) or (B, S, T) bool, True = attend."""
    hd = q.shape[-1]
    scores = torch.einsum("bshk,bthk->bhst", q, k).to(torch.float32)
    # a device-side constant (torch.full: no host-to-device copy, which
    # would wait for the stream) and a true division, as the reference's
    scores = scores / torch.full((), math.sqrt(hd), dtype=torch.float32, device=q.device)
    m = mask[None, None] if mask.dim() == 2 else mask[:, None]
    scores = torch.where(m, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def causal_attention(q, k, v, chunk: int = 1024) -> torch.Tensor:
    """Causal self-attention over query chunks of `chunk` rows, so the
    (chunk, S) score block, not (S, S), is the peak intermediate.
    q (B, S, Hq, hd); k, v (B, S, Hkv, hd)."""
    b, s, hq, hd = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    dev = q.device
    if s <= chunk:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
        return _sdpa(q, k, v, mask)

    if s % chunk:
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, hq, hd).movedim(1, 0)
    kv_pos = torch.arange(s, dtype=torch.int32, device=dev)

    def step(_, inp):
        qi, ci = inp
        q_pos = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)
        mask = q_pos[:, None] >= kv_pos[None, :]
        return None, _sdpa(qi, k, v, mask)

    _, outs = uscan.scan(step, None, (qc, torch.arange(nc, dtype=torch.int32, device=dev)))
    return outs.movedim(0, 1).reshape(b, s, hq, hd)


def _by_heads(cfg: ModelConfig, fn, q, k, v, *rest, rest_logical: tuple = ()):
    """fn(q, k, v, *rest) on this rank's batch rows and heads.  On a mesh
    the attention products have no DTensor rule over sharded heads, so they
    run on the local shards (q, k, v batch-sharded, the heads over the
    model axis where both head counts divide it, else whole); `rest` is
    placed by `rest_logical`.  Off a mesh, fn(q, k, v, *rest)."""
    split = axes.axis_size("heads")
    h = "heads" if cfg.hq_eff % split == 0 and cfg.hkv_eff % split == 0 else None
    names = ("batch", None, h, None)
    return axes.local_map(fn, (names, names, names, *rest_logical), names, q, k, v, *rest)


def attention_block(params, cfg: ModelConfig, x, positions, chunk: int = 1024) -> torch.Tensor:
    """Full self-attention sublayer (projections + RoPE + causal attention)."""
    q, k, v = _qkv(params, cfg, x, positions)
    out = _by_heads(cfg, lambda q, k, v: causal_attention(q, k, v, chunk=chunk), q, k, v)
    return _out_proj(_head_mask(cfg, out), params["wo"])


# ---------------------------------------------------------------- decode ----


def prefill_cache(params, cfg: ModelConfig, x, positions, cache_len: int):
    """Like attention_block but also materializes the KV cache (B, T, Hkv, hd)."""
    b, s, _ = x.shape
    if s > cache_len:
        raise ValueError(f"a prefill of {s} tokens does not fit a cache of {cache_len}")
    q, k, v = _qkv(params, cfg, x, positions)
    chunk = min(cfg.policy.attn_chunk, s)
    out = _by_heads(cfg, lambda q, k, v: causal_attention(q, k, v, chunk=chunk), q, k, v)
    out = _out_proj(_head_mask(cfg, out), params["wo"])
    # the cache: the prompt's k / v, then zeros up to cache_len (on a mesh
    # each rank builds its batch rows and kv heads)
    names = ("batch", None, "kv_heads", None)

    def cache(a):
        c = torch.zeros((a.shape[0], cache_len, *a.shape[2:]), dtype=L.ACT_DTYPE, device=a.device)
        c[:, :s] = a.to(L.ACT_DTYPE)
        return c

    return out, {"k": axes.local_map(cache, (names,), names, k),
                 "v": axes.local_map(cache, (names,), names, v)}


def _write_cache(cache: dict, k, v, pos: int) -> None:
    """k/v (B, 1, Hkv, hd) into the cache at `pos`, in place.  The
    reference's dynamic_update_slice would clamp a `pos` past the end and
    overwrite the last slot; here that raises.  On a mesh each rank writes
    its shard of the cache (k and v placed as the cache is)."""
    t = cache["k"].shape[1]
    if not 0 <= pos < t:
        raise IndexError(f"decode position {pos} is outside the cache of {t}")
    for key, new in (("k", k), ("v", v)):
        dst = cache[key]
        if axes.is_distributed(dst):
            if any(getattr(p, "dim", None) == 1 for p in dst.placements):
                raise NotImplementedError("decode into a cache sharded over its positions")
            new = new.redistribute(dst.device_mesh, dst.placements).to_local()
            dst = dst.to_local()
        dst[:, pos] = new[:, 0].to(L.ACT_DTYPE)


def decode_attention(params, cfg: ModelConfig, x, cache: dict, pos: int):
    """One-token decode: write k/v at `pos` (in place), attend over
    positions <= pos.  x (B, 1, d); cache {"k", "v"}: (B, T, Hkv, hd)."""
    t = cache["k"].shape[1]
    q, k, v = _qkv(params, cfg, x, torch.full((1,), pos, dtype=torch.int32, device=x.device))
    q = constrain(q, *_DECODE_HEADS)
    _write_cache(cache, k, v, pos)
    mask = (torch.arange(t, dtype=torch.int32, device=x.device) <= pos)[None, :]   # (1, T)

    def attend(q, kc, vc):
        h = q.shape[2]
        return _sdpa(q, _expand_kv(kc, h, _DECODE_HEADS), _expand_kv(vc, h, _DECODE_HEADS), mask)

    out = _head_mask(cfg, _by_heads(cfg, attend, q, cache["k"], cache["v"]))
    return _out_proj(out, params["wo"]), cache


def decode_attention_retrieved(params, cfg: ModelConfig, x, cache: dict, pos: int,
                               retrieved: torch.Tensor, retrieved_ok: torch.Tensor,
                               local_window: int):
    """Sub-quadratic decode: attend over {local window} U {retrieved
    positions} instead of the whole cache, O(w + m) per step.
    retrieved (B, m) int positions from active search; retrieved_ok (B, m)."""
    t = cache["k"].shape[1]
    dev = x.device
    q, k, v = _qkv(params, cfg, x, torch.full((1,), pos, dtype=torch.int32, device=dev))
    _write_cache(cache, k, v, pos)
    w = local_window

    def attend(q, kc, vc, retrieved, retrieved_ok):
        # gather the attended positions: local window (w) + retrieved (m)
        b = q.shape[0]
        local = pos - w + 1 + torch.arange(w, dtype=torch.int64, device=dev)   # (w,), may be <0
        local_ok = local >= 0
        local = local.clamp(0, t - 1)
        retrieved = retrieved.to(torch.int64)
        idx = torch.cat([local.expand(b, w), retrieved.clamp(0, t - 1)], dim=1)   # (B, w+m)
        ok = torch.cat([
            local_ok.expand(b, w),
            # retrieved entries inside the local window would be double
            # counted by the softmax: mask them out
            retrieved_ok & (retrieved <= pos) & (retrieved < pos - w + 1),
        ], dim=1)
        rows = torch.arange(b, device=dev)[:, None]
        kg = kc[rows, idx]                                       # (B, w+m, Hkv, hd)
        vg = vc[rows, idx]
        h = q.shape[2]
        ke = _expand_kv(kg, h, _DECODE_HEADS)
        ve = _expand_kv(vg, h, _DECODE_HEADS)
        return _sdpa(q, ke, ve, ok[:, None, :])

    rows = ("batch", None)
    out = _by_heads(cfg, attend, q, cache["k"], cache["v"], retrieved, retrieved_ok,
                    rest_logical=(rows, rows))
    return _out_proj(_head_mask(cfg, out), params["wo"]), cache
