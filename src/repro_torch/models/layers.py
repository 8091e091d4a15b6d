"""Building blocks shared by every architecture: RMSNorm, RoPE, SwiGLU, inits.

Port of `repro/models/layers.py`.  The reference keeps float32 masters and
casts every matrix to `ACT_DTYPE` (bf16) where it is used; the port stores
the matrices in `ACT_DTYPE` (the same numbers, half the memory) and keeps
the norms' scales in float32.  Norms, RoPE and softmaxes compute in
float32, everything else in `ACT_DTYPE`.  `ACT_DTYPE` is read at every
use, so switching it (to float32, for a test against the reference in
float32) switches the whole model built after it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import axes

ACT_DTYPE = torch.bfloat16


def dense_init(gen: torch.Generator | None, shape, fan_in=None, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """float32 normal / sqrt(fan_in) (fan_in defaults to shape[0]), drawn
    from `gen` on its device; with no generator, an empty float32 tensor on
    `device` (shapes only, for a loader)."""
    if gen is None:
        return torch.empty(shape, device=device)
    fan_in = fan_in if fan_in is not None else shape[0]
    std = scale / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * std


def embed_init(gen: torch.Generator | None, shape, device=None) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * 0.02


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., head_dim//2) float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, head_dim); cos/sin broadcastable (..., 1, head_dim//2).
    Half-split rotation (the first half of the head dim against the second),
    not interleaved pairs."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (..., d) with wi/wg (d, ff), wo (ff, d).  As in the
    reference, SiLU gates `wi`'s product and `wg`'s is the linear arm."""
    h = torch.matmul(x, wg.to(x.dtype))
    g = F.silu(torch.matmul(x, wi.to(x.dtype)).to(torch.float32))
    return torch.matmul(g.to(x.dtype) * h, wo.to(x.dtype))


def init_mlp(gen: torch.Generator | None, d_model: int, d_ff: int, device=None) -> dict:
    return {
        "wi": dense_init(gen, (d_model, d_ff), device=device),
        "wg": dense_init(gen, (d_model, d_ff), device=device),
        "wo": dense_init(gen, (d_ff, d_model), device=device),
    }


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """embed[tokens] (..., d).  On a mesh the index has no DTensor rule, so
    each rank looks its batch rows up in the whole table."""
    rows = ("batch",) + (None,) * (tokens.dim() - 1)
    return axes.local_map(lambda e, t: e[t], ((None, None), rows), rows + (None,),
                          embed, tokens)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL.  logits (..., V) any float dtype; labels (...) int.
    On a mesh the gather of the gold logit has no DTensor rule over a
    sharded vocab, so each rank takes its batch rows with the whole vocab
    (as GSPMD would) and the mean sums across them."""
    rows = ("batch",) + (None,) * (labels.dim() - 1)
    nll = axes.local_map(_token_nll, (rows + (None,), rows), rows, logits, labels)
    if mask is not None:
        m = mask.to(torch.float32)
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)
