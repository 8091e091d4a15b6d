"""Mamba (selective SSM) block: the chunked selective scan.

Port of `repro/models/mamba.py`.  Recurrence (Mamba-1):
  a_t = exp(dt_t * A)          A = -exp(A_log)  (diagonal, negative)
  b_t = dt_t * B_t x_t
  h_t = a_t h_{t-1} + b_t ;  y_t = C_t . h_t + D * x_t ;  out = y * silu(z)

The reference solves the recurrence within each chunk of `chunk` tokens
with `lax.associative_scan`, a log-depth tree; here each chunk's a_t and
b_t, (B, Q, d_inner, d_state) float32, are formed at once and the
recurrence runs as a loop over the chunk's Q tokens, one `addcmul` each,
written straight into the chunk's states.  At jamba's width (d_inner
8192) with 8 rows one such tensor is 1.07 GB: a log-step scan would make
about log2(256) = 8 passes over a, b and their partial products, the loop
makes one pass of small launches.  The two orders of summation differ, so
the port matches the reference to float32 rounding, not bit for bit.  The
last chunk is simply shorter: the reference pads it with identity steps
(dt = 0: a = 1, b = 0), which leave the state as it is.

Stored dtypes follow the reference's use: `dt_proj` and `A_log` in float32
(`F32_WEIGHTS`), the other matrices in `ACT_DTYPE`, the vectors in
float32.  The decode step keeps the reference's rounding points: the
conv's products rounded to `ACT_DTYPE` and summed in float32 (JAX sums
bf16 in float32), SiLU rounded to `ACT_DTYPE` and lifted to float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import axes
from repro_torch.parallel.axes import constrain
from repro_torch.utils import scan as uscan

# weights the reference uses in float32 (the model stores them so)
F32_WEIGHTS = ("dt_proj", "A_log")


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.mamba.expand * cfg.d_model


def init_mamba(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    """The block's weights, drawn from `gen` (None: empty on `device`):
    dt_bias the inverse softplus of U[1e-3, 1e-1], A_log = log(1..d_state)
    per channel (the standard Mamba init)."""
    mc = cfg.mamba
    d, din, dtr = cfg.d_model, _d_inner(cfg), _dt_rank(cfg)
    dev = device if gen is None else gen.device
    if gen is None:
        conv_w = torch.empty((mc.d_conv, din), device=dev)
        dt_bias = torch.empty((din,), device=dev)
    else:
        conv_w = torch.randn((mc.d_conv, din), generator=gen, device=dev) * 0.1
        u = torch.rand((din,), generator=gen, device=dev) * (1e-1 - 1e-3) + 1e-3
        dt_bias = torch.log(torch.expm1(u))
    a = torch.arange(1, mc.d_state + 1, dtype=torch.float32, device=dev).expand(din, mc.d_state)
    return {
        "in_proj": L.dense_init(gen, (d, 2 * din), fan_in=d, device=dev),
        "conv_w": conv_w,
        "conv_b": torch.zeros((din,), device=dev),
        "x_proj": L.dense_init(gen, (din, dtr + 2 * mc.d_state), fan_in=din, device=dev),
        "dt_proj": L.dense_init(gen, (dtr, din), fan_in=dtr, device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(a).contiguous(),
        "D": torch.ones((din,), device=dev),
        "out_proj": L.dense_init(gen, (din, d), fan_in=din, device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, x (B, S, din) left-padded by d_conv - 1,
    w (d_conv, din): the products and their sum in float32 (exact products
    of `ACT_DTYPE` values), rounded to x's dtype, then the bias added."""
    dconv = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, dconv - 1, 0)).to(torch.float32)
    wf = w.to(x.dtype).to(torch.float32)
    out = xp[:, 0:s] * wf[0]
    for j in range(1, dconv):
        out = out + xp[:, j:j + s] * wf[j]
    return out.to(x.dtype) + b.to(x.dtype)


def _ssm_inputs(params, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, din) in ACT_DTYPE -> dt (B, S, din), B_t and C_t (B, S, ds),
    float32, and A (din, ds)."""
    mc = cfg.mamba
    dtr = _dt_rank(cfg)
    proj = torch.matmul(x, params["x_proj"].to(x.dtype)).to(torch.float32)
    dt_in, b_ssm, c_ssm = torch.split(proj, [dtr, mc.d_state, mc.d_state], dim=-1)
    dt = F.softplus(torch.matmul(dt_in, params["dt_proj"].to(torch.float32)) + params["dt_bias"])
    a_mat = -torch.exp(params["A_log"].to(torch.float32))
    return dt, b_ssm, c_ssm, a_mat


def mamba_scan(params, cfg: ModelConfig, x_in: torch.Tensor, h0: torch.Tensor,
               chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x_in (B, S, din) post-conv activations -> (y (B, S, din), h_last)."""
    b, s, din = x_in.shape
    xf = x_in.to(torch.float32)
    dt, b_ssm, c_ssm, a_mat = _ssm_inputs(params, cfg, x_in)
    xb = dt * xf
    q = min(chunk, s)
    h = h0
    ys = []
    for lo in range(0, s, q):
        hi = min(s, lo + q)
        a = torch.exp(dt[:, lo:hi, :, None] * a_mat)                     # (B, Q, din, ds)
        bx = xb[:, lo:hi, :, None] * b_ssm[:, lo:hi, None, :]             # (B, Q, din, ds)
        if bx.requires_grad or h.requires_grad:
            # training: the same sums, each state a new tensor for autograd
            states = []
            for i in uscan.steps(hi - lo):
                h = torch.addcmul(bx[:, i], a[:, i], h)
                states.append(h)
            bx = uscan.stack_steps(states, hi - lo, dim=1)
        else:
            for i in uscan.steps(hi - lo):
                h = torch.addcmul(bx[:, i], a[:, i], h, out=bx[:, i])     # bx[:, i] := h_i
            h = h.clone()                                                 # frees the chunk
        ys.append(torch.einsum("bqds,bqs->bqd", bx, c_ssm[:, lo:hi]))
        del a, bx
    y = torch.cat(ys, dim=1) + xf * params["D"]
    return y.to(x_in.dtype), h


def mamba_prefill(params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Full Mamba sublayer.  x (B, S, d) -> ((B, S, d), decode cache)."""
    mc = cfg.mamba
    b, s, _ = x.shape
    din = _d_inner(cfg)
    xd = x.to(L.ACT_DTYPE)
    xz = torch.matmul(xd, params["in_proj"].to(xd.dtype))
    xz = constrain(xz, "batch", "seq", "inner")
    x_raw, z = torch.split(xz, din, dim=-1)
    # the pad over the sequence has no DTensor plan on some placements:
    # on a mesh the conv runs on each rank's batch rows and channels
    x_in = axes.local_map(_causal_conv, (("batch", "seq", "inner"), (None, "inner"), ("inner",)),
                          ("batch", "seq", "inner"), x_raw, params["conv_w"], params["conv_b"])
    x_in = F.silu(x_in.to(torch.float32)).to(xd.dtype)
    h0 = torch.zeros((b, din, mc.d_state), dtype=torch.float32, device=x.device)
    # on a mesh the token loop's `addcmul`s have no DTensor rule: the scan
    # runs whole on every rank (its inputs gathered), then is pinned again
    y, h_last = axes.replicated_local(
        lambda w, xi, h: mamba_scan(w, cfg, xi, h, mc.chunk), _scan_weights(params), x_in, h0)
    y = y * F.silu(z.to(torch.float32)).to(xd.dtype)
    y = constrain(y, "batch", "seq", "inner")
    out = torch.matmul(y, params["out_proj"].to(xd.dtype))
    cache = {"conv": x_raw[:, s - (mc.d_conv - 1):, :].to(L.ACT_DTYPE).contiguous(),
             "ssm": h_last}
    return out, cache


def _scan_weights(params) -> dict:
    return {k: params[k] for k in ("x_proj", "dt_proj", "dt_bias", "A_log", "D")}


def mamba_block(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training form (no cache)."""
    out, _ = mamba_prefill(params, cfg, x)
    return out


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    mc = cfg.mamba
    din = _d_inner(cfg)
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, din), dtype=L.ACT_DTYPE, device=device),
        "ssm": torch.zeros((batch, din, mc.d_state), dtype=torch.float32, device=device),
    }


def mamba_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x (B, 1, d) -> ((B, 1, d), the new cache); O(1)
    state, and the cache given is not written (the model writes the new
    one over it)."""
    din = _d_inner(cfg)
    xd = x.to(L.ACT_DTYPE)
    xz = torch.matmul(xd, params["in_proj"].to(xd.dtype))
    x_in, z = torch.split(xz, din, dim=-1)                              # (B, 1, din)

    # conv over [cache, x]: a new tensor, so its shifted view overlaps nothing
    window = torch.cat([cache["conv"], x_in], dim=1)                     # (B, dconv, din)
    w = params["conv_w"].to(xd.dtype)
    prod = (window * w[None]).to(torch.float32)
    xc = torch.sum(prod, dim=1, keepdim=True).to(xd.dtype) + params["conv_b"].to(xd.dtype)
    # round through ACT_DTYPE exactly like the prefill path, then lift to float32
    xc = F.silu(xc.to(torch.float32)).to(L.ACT_DTYPE).to(torch.float32)

    dt, b_ssm, c_ssm, a_mat = _ssm_inputs(params, cfg, xc.to(xd.dtype))
    dt = dt[:, 0]                                                        # (B, din)
    a = torch.exp(dt[..., None] * a_mat[None])                           # (B, din, ds)
    bx = (dt * xc[:, 0])[..., None] * b_ssm[:, 0, None, :]               # (B, din, ds)
    h = a * cache["ssm"] + bx
    y = torch.einsum("bds,bs->bd", h, c_ssm[:, 0]) + xc[:, 0] * params["D"]
    y = y[:, None].to(xd.dtype) * F.silu(z.to(torch.float32)).to(xd.dtype)
    out = torch.matmul(y, params["out_proj"].to(xd.dtype))
    return out, {"conv": window[:, 1:], "ssm": h}
