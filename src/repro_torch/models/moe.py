"""Mixture-of-Experts with GShard-style grouped one-hot dispatch.

Port of `repro/models/moe.py`.  Routing is softmax top-k over the experts;
tokens are split into groups of `g = min(group_size, T)` flattened tokens
(the last one padded with zero rows), each group gives every expert `C`
slots, and the dispatch / combine tensors are (G, g, E, C), so their size
is linear in tokens.  `n_padded` dummy experts (the reference's, for its
model axis) sit at -1e30 before the softmax and are never picked; their
weights exist and are computed over, as in the reference.

The reference's rounding points are kept: the router's product in
`ACT_DTYPE`, the softmax in float32, the experts' SwiGLU with SiLU of `wi`'s
product in float32 rounded back.  Two points need care:
- ties in the top-k: the router's logits are `ACT_DTYPE` values, so two
  experts can share a probability exactly.  `jax.lax.top_k` puts the lower
  index first; `torch.topk` promises no order, and a token's order of
  choices decides its capacity rank.  `route` takes the first k of a
  stable descending sort instead, which breaks ties by index.
- capacity: ranks are slot-major (every token's first choice before any
  second choice), so first choices win capacity races; a token past an
  expert's capacity is dropped for that expert, as in the reference (at
  decode too: 8 rows over 60 experts give C = 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import axes
from repro_torch.parallel.axes import constrain
from repro_torch.utils import tree


def init_moe(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    """Router and expert weights over `n_total` experts (the shared MLP
    too when `shared_d_ff > 0`), drawn from `gen` (None: empty on
    `device`)."""
    mo = cfg.moe
    d, e, de = cfg.d_model, mo.n_total, mo.d_expert
    params = {
        "router": L.dense_init(gen, (d, e), fan_in=d, device=device),
        "wi": L.dense_init(gen, (e, d, de), fan_in=d, device=device),
        "wg": L.dense_init(gen, (e, d, de), fan_in=d, device=device),
        "wo": L.dense_init(gen, (e, de, d), fan_in=de, device=device),
    }
    if mo.shared_d_ff:
        params["shared"] = L.init_mlp(gen, d, mo.shared_d_ff, device)
    return params


def group_shape(cfg: ModelConfig, t: int) -> tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert) for T = t tokens."""
    mo = cfg.moe
    g = min(mo.group_size, t)
    cap = max(4, int(round(g * mo.top_k / max(mo.n_experts, 1) * mo.capacity_factor)))
    return -(-t // g), g, cap


class Routing(NamedTuple):
    """A router's decisions for grouped tokens (G, g, ...)."""

    probs: torch.Tensor   # (G, g, E) float32
    top_w: torch.Tensor   # (G, g, k) float32, renormalised
    top_i: torch.Tensor   # (G, g, k) int64, ties to the lower index
    rank: torch.Tensor    # (G, g, k) float32: slot-major capacity rank
    keep: torch.Tensor    # (G, g, k) bool: rank < capacity


def route(params, cfg: ModelConfig, xt: torch.Tensor, cap: int) -> Routing:
    """The router on grouped tokens xt (G, g, d) in `ACT_DTYPE`."""
    mo = cfg.moe
    e, k = mo.n_total, mo.top_k
    logits = torch.matmul(xt, params["router"].to(xt.dtype)).to(torch.float32)
    if mo.n_padded:
        pad = torch.arange(e, device=xt.device) >= mo.n_experts
        logits = torch.where(pad, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)                        # (G, g, E)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    top_w = top_w / torch.clamp_min(torch.sum(top_w, dim=-1, keepdim=True), 1e-9)
    # slot-major ranks: the cumsum runs over (slot, token), first choices first
    ng, g = xt.shape[:2]
    mask = F.one_hot(top_i, e).to(torch.float32)                 # (G, g, k, E)
    mask_sm = mask.transpose(1, 2).reshape(ng, k * g, e)
    ranks_sm = torch.cumsum(mask_sm, dim=1) - mask_sm            # rank BEFORE self
    ranks = ranks_sm.reshape(ng, k, g, e).transpose(1, 2)        # (G, g, k, E)
    rank = torch.sum(ranks * mask, dim=-1)                       # (G, g, k)
    return Routing(probs, top_w, top_i, rank, rank < cap)


def moe_block(params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), the Switch aux loss ()).  Token order
    preserved."""
    if axes.is_distributed(x):
        return _moe_on_mesh(params, cfg, x)
    b, s, d = x.shape
    t = b * s
    ng, g, cap = group_shape(cfg, t)
    y, aux = moe_groups(params, cfg, group_tokens(x.reshape(t, d), ng, g), cap)
    return y.reshape(ng * g, d)[:t].reshape(b, s, d), aux


def _moe_on_mesh(params, cfg: ModelConfig, x) -> tuple:
    """moe_block on a mesh.  The stable sort and the one-hot dispatch have
    no DTensor rule, so the layer runs on plain tensors with the experts'
    weights gathered whole onto every rank (the experts axis splits no
    compute).  Where each rank's batch rows hold whole GShard groups, each
    rank runs its own rows, as GSPMD places a batch-sharded op, and the
    aux loss takes the load statistics summed over the batch shards; a
    group that spans the shards runs whole on every rank instead, each
    keeping its rows."""
    x = constrain(x, "batch", "seq", "embed")
    b, s, _ = x.shape
    _, g, _ = group_shape(cfg, b * s)
    rows = x.to_local().shape[0]
    w = _weights(params)
    if rows != b and rows * s % g:
        y, aux = axes.replicated_local(lambda w_, h: moe_block(w_, cfg, h), w, x)
        return constrain(y, "batch", "seq", "embed"), aux
    ws = tree.leaves(w)

    def local(h, *leaves):
        r, sq, d = h.shape
        ng, g_, cap = group_shape(cfg, r * sq)
        y, me, ce = _groups(tree.unflatten(w, iter(leaves)), cfg,
                            group_tokens(h.reshape(r * sq, d), ng, g_), cap)
        return y.reshape(ng * g_, d)[:r * sq].reshape(r, sq, d), me[None], ce[None]

    names = ("batch", "seq", "embed")
    y, me, ce = axes.local_map(local, (names, *((None,) * t.dim() for t in ws)),
                               [names, ("batch", None), ("batch", None)], x, *ws)
    shards = b // rows
    return y, aux_loss(cfg, me.sum(0) / shards, ce.sum(0) / shards)


def _weights(params) -> dict:
    """The layer's weights as a dict tree (from a dict or a ParamTree)."""
    out = {k: params[k] for k in ("router", "wi", "wg", "wo")}
    if "shared" in params:
        out["shared"] = {k: params["shared"][k] for k in ("wi", "wg", "wo")}
    return out


def group_tokens(xt: torch.Tensor, ng: int, g: int) -> torch.Tensor:
    """Flattened tokens (T, d) -> (ng, g, d) in `ACT_DTYPE`, the last group
    padded with zero rows."""
    t, d = xt.shape
    if ng * g != t:
        xt = F.pad(xt, (0, 0, 0, ng * g - t))
    return xt.reshape(ng, g, d).to(L.ACT_DTYPE)


def moe_groups(params, cfg: ModelConfig, xt: torch.Tensor,
               cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer on grouped tokens xt (G, g, d), `cap` slots per expert
    in each group -> (y (G, g, d), the Switch aux loss over these groups).
    Groups are independent (each has its own capacity), so a run of whole
    groups gives the same rows as the call over all of them."""
    y, me, ce = _groups(params, cfg, xt, cap)
    return y, aux_loss(cfg, me, ce)


def aux_loss(cfg: ModelConfig, me: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    """The Switch load-balancing loss from the mean router probability
    `me` (E,) and the mean number of picks `ce` (E,) of each expert."""
    mo = cfg.moe
    return torch.sum(me * ce) * (mo.n_experts ** 2) / max(mo.top_k, 1)


def _groups(params, cfg: ModelConfig, xt: torch.Tensor, cap: int) -> tuple:
    """moe_groups' y and the aux loss's statistics over these groups."""
    mo = cfg.moe
    e = mo.n_total
    r = route(params, cfg, xt, cap)

    mask = F.one_hot(r.top_i, e).to(torch.float32)               # (G, g, k, E)
    me = torch.mean(r.probs, dim=(0, 1))                         # (E,)
    ce = torch.mean(torch.sum(mask, dim=2), dim=(0, 1))

    # dispatch / combine: the k slots merged (a token's experts are distinct)
    rank_i = torch.where(r.keep, r.rank, float(cap)).to(torch.int64)   # cap -> dropped
    oh_cap = F.one_hot(rank_i, cap + 1)[..., :cap].to(torch.float32)   # (G, g, k, C)
    dispatch = torch.einsum("GgkE,GgkC->GgEC", mask, oh_cap)            # 0/1
    combine = torch.einsum("GgkE,GgkC->GgEC", mask * r.top_w[..., None], oh_cap)

    xe = torch.einsum("GgEC,Ggd->GECd", dispatch.to(xt.dtype), xt)
    hi = torch.einsum("GECd,Edf->GECf", xe, params["wg"].to(xt.dtype))
    gi = torch.einsum("GECd,Edf->GECf", xe, params["wi"].to(xt.dtype))
    act = F.silu(gi.to(torch.float32)).to(xt.dtype) * hi
    ye = torch.einsum("GECf,Efd->GECd", act, params["wo"].to(xt.dtype))
    y = torch.einsum("GgEC,GECd->Ggd", combine.to(xt.dtype), ye)

    if "shared" in params:
        sh = params["shared"]
        y = y + L.swiglu(xt, sh["wi"], sh["wg"], sh["wo"])
    return y, me, ce
