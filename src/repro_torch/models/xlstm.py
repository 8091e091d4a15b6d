"""xLSTM blocks: mLSTM (chunkwise-parallel matrix memory) and sLSTM (scan).

Port of `repro/models/xlstm.py`.
 * mLSTM runs the chunkwise-parallel linear-attention form: a loop over
   chunks (`utils/scan.py`) carries the (B, nh, hd, hd) matrix memory;
   within a chunk the decay-weighted attention is dense (Q, Q) products.
   The input gate is a sigmoid, as in the reference (GLA-style).  The last
   chunk is padded with identity steps (log_f = 0, i = 0), which leave
   the state as it is.
 * sLSTM keeps the paper's exp gating with the m-stabiliser, which starts
   at m = -10.  Its recurrent h-mixing is inherently sequential: the
   reference runs `lax.scan` over every token, here a Python loop of S
   steps of small launches (launch-bound on the card).

Stored dtypes follow the reference's use: the sLSTM's recurrent `r` and
its `bias` in float32 (`SLSTM_F32_WEIGHTS`), the other matrices in
`ACT_DTYPE`.  The states (mLSTM c, n; sLSTM h, c, n, m) are float32.
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
SLSTM_F32_WEIGHTS = ("r", "bias")


def _sqrt_f32(n: int) -> float:
    """sqrt(n) rounded to float32, as `jnp.sqrt` of a Python int gives it."""
    return float(torch.sqrt(torch.tensor(float(n), dtype=torch.float32)))


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dh...->bsh...") as one matmul over the flattened heads."""
    return axes.unflatten_last(torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1)),
                               tuple(w.shape[1:]))


# ------------------------------------------------------------------ mLSTM ---


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    xc = cfg.xlstm
    din = int(xc.proj_factor_mlstm * cfg.d_model)
    nh = xc.n_heads
    din -= din % nh
    return din, nh, din // nh


def init_mlstm(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    din, nh, hd = _mlstm_dims(cfg)
    dev = device if gen is None else gen.device
    return {
        "up": L.dense_init(gen, (d, 2 * din), fan_in=d, device=dev),
        "wq": L.dense_init(gen, (din, nh, hd), fan_in=din, device=dev),
        "wk": L.dense_init(gen, (din, nh, hd), fan_in=din, device=dev),
        "wv": L.dense_init(gen, (din, nh, hd), fan_in=din, device=dev),
        "wif": L.dense_init(gen, (din, nh, 2), fan_in=din, device=dev),
        "fgate_bias": torch.full((nh,), 3.0, device=dev),   # start remembering
        "down": L.dense_init(gen, (din, d), fan_in=din, device=dev),
    }


def _mlstm_gates(params, xm: torch.Tensor):
    """xm (B, S, din) -> q, k, v (B, S, nh, hd) and log_f, i (B, S, nh) float32."""
    q = _heads(xm, params["wq"])
    k = _heads(xm, params["wk"])
    v = _heads(xm, params["wv"])
    gates = _heads(xm, params["wif"]).to(torch.float32)
    i = torch.sigmoid(gates[..., 0])
    # logsigmoid's backward has no DTensor rule: on a mesh it runs whole
    log_f = axes.replicated_local(F.logsigmoid, gates[..., 1] + params["fgate_bias"])
    return q, k, v, log_f, i


def _up(params, x: torch.Tensor):
    xd = x.to(L.ACT_DTYPE)
    xz = constrain(torch.matmul(xd, params["up"].to(xd.dtype)), "batch", "seq", "inner")
    xm, z = torch.chunk(xz, 2, dim=-1)
    return xd, xm, z


def _mlstm_chunk(carry, inp):
    """One chunk of the chunkwise-parallel form: (c, n) carried in.  On a
    mesh it runs on each rank's batch rows (cumsum's backward, a flip, and
    the chunk's products have no DTensor plan on every placement; the
    rows are independent)."""
    parts = (*carry, *inp)
    names = tuple(("batch",) + (None,) * (t.dim() - 1) for t in parts)
    c_new, n_new, h = axes.local_map(_mlstm_chunk_rows, names, [names[0], names[1], names[2]],
                                     *parts)
    return (c_new, n_new), h


def _mlstm_chunk_rows(c_prev, n_prev, qi, ki, vi, lf, ig):
    """_mlstm_chunk on plain tensors -> (c, n, h)."""
    qc = qi.shape[1]
    clf = torch.cumsum(lf, dim=1)                               # (B, Q, nh)
    # intra-chunk: W[t, u] = exp(clf_t - clf_u) * i_u  for u <= t
    rel = clf[:, :, None, :] - clf[:, None, :, :]               # (B, Q, Q, nh)
    tri = torch.tril(torch.ones((qc, qc), dtype=torch.bool, device=qi.device))
    w = torch.where(tri[None, :, :, None], torch.exp(rel), 0.0) * ig[:, None, :, :]
    scores = torch.einsum("bthk,buhk->btuh", qi, ki) * w
    y_intra = torch.einsum("btuh,buhk->bthk", scores, vi)
    n_intra = torch.einsum("btuh,buhk->bthk", w, ki)
    # inter-chunk
    decay_t = torch.exp(clf)                                    # (B, Q, nh)
    y_inter = torch.einsum("bthk,bhkl->bthl", qi * decay_t[..., None], c_prev)
    n_inter = n_prev[:, None] * decay_t[..., None]
    y = y_intra + y_inter
    n_t = n_intra + n_inter
    denom = torch.abs(torch.einsum("bthk,bthk->bth", qi, n_t))
    h = y / torch.clamp_min(denom, 1.0)[..., None]
    # state update to the end of the chunk: exp(clf_Q - clf_u) * i_u
    wk_tail = torch.exp(clf[:, -1:, :] - clf) * ig              # (B, Q, nh)
    decay = torch.exp(clf[:, -1])                               # (B, nh)
    c_new = c_prev * decay[..., None, None] + torch.einsum(
        "buhk,buhl->bhkl", ki * wk_tail[..., None], vi)
    n_new = n_prev * decay[..., None] + torch.einsum("buhk,buh->bhk", ki, wk_tail)
    return c_new, n_new, h


def mlstm_prefill(params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Training/prefill form.  x (B, S, d) -> ((B, S, d), decode cache)."""
    b, s, _ = x.shape
    din, nh, hd = _mlstm_dims(cfg)
    xd, xm, z = _up(params, x)
    q, k, v, log_f, i_gate = _mlstm_gates(params, xm)
    scale = 1.0 / _sqrt_f32(hd)
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    qc = min(cfg.xlstm.chunk, s)
    nc = -(-s // qc)
    s_pad = nc * qc
    if s_pad != s:
        # identity padding: log_f = 0 (f = 1), i = 0 -> the state passes through
        qf, kf, vf = (F.pad(a, (0, 0, 0, 0, 0, s_pad - s)) for a in (qf, kf, vf))
        log_f, i_gate = (F.pad(a, (0, 0, 0, s_pad - s)) for a in (log_f, i_gate))

    def chunks(a):
        return a.reshape(b, nc, qc, *a.shape[2:]).movedim(1, 0)

    c0 = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
    n0 = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
    (c_f, n_f), hs = uscan.scan(_mlstm_chunk, (c0, n0),
                                tuple(chunks(a) for a in (qf, kf, vf, log_f, i_gate)))
    h = hs.movedim(0, 1).reshape(b, s_pad, din)[:, :s].to(xd.dtype)
    out = h * F.silu(z.to(torch.float32)).to(xd.dtype)
    out = torch.matmul(out, params["down"].to(xd.dtype))
    return out, {"c": c_f, "n": n_f}


def mlstm_block(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    out, _ = mlstm_prefill(params, cfg, x)
    return out


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    _, nh, hd = _mlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
    }


def mlstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """x (B, 1, d) -> ((B, 1, d), the new cache); O(1) state update."""
    din, _, hd = _mlstm_dims(cfg)
    xd, xm, z = _up(params, x)
    q, k, v, log_f, i_gate = _mlstm_gates(params, xm)
    qf = q[:, 0].to(torch.float32) / _sqrt_f32(hd)              # (B, nh, hd)
    kf = k[:, 0].to(torch.float32)
    vf = v[:, 0].to(torch.float32)
    f = torch.exp(log_f[:, 0])[..., None]                       # (B, nh, 1)
    i = i_gate[:, 0][..., None]
    c = cache["c"] * f[..., None] + i[..., None] * kf[..., :, None] * vf[..., None, :]
    n = cache["n"] * f + i * kf
    y = torch.einsum("bhk,bhkl->bhl", qf, c)
    denom = torch.abs(torch.einsum("bhk,bhk->bh", qf, n))
    h = (y / torch.clamp_min(denom, 1.0)[..., None]).reshape(x.shape[0], 1, din)
    out = h.to(xd.dtype) * F.silu(z.to(torch.float32)).to(xd.dtype)
    return torch.matmul(out, params["down"].to(xd.dtype)), {"c": c, "n": n}


# ------------------------------------------------------------------ sLSTM ---


def _slstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    xc = cfg.xlstm
    din = int(xc.proj_factor_slstm * cfg.d_model)
    nh = xc.n_heads
    din -= din % nh
    return din, nh, din // nh


def init_slstm(gen: torch.Generator | None, cfg: ModelConfig, device=None) -> dict:
    d = cfg.d_model
    din, nh, hd = _slstm_dims(cfg)
    dev = device if gen is None else gen.device
    return {
        "up": L.dense_init(gen, (d, din), fan_in=d, device=dev),
        "wx": L.dense_init(gen, (din, 4, din), fan_in=din, device=dev),
        "r": L.dense_init(gen, (nh, hd, 4, hd), fan_in=hd, device=dev),
        "bias": torch.zeros((4, din), device=dev),
        "down": L.dense_init(gen, (din, d), fan_in=din, device=dev),
    }


def _slstm_scan(params, cfg: ModelConfig, gx: torch.Tensor, h, c, n, m):
    """gx (B, S, 4, din) float32 input-side gate pre-activations; the
    states (B, din) float32.  -> (h over time (B, S, din), final states)."""
    din, nh, hd = _slstm_dims(cfg)
    b = gx.shape[0]
    r = params["r"].to(torch.float32)
    bias = params["bias"]
    hs = []
    for t in uscan.steps(gx.shape[1]):
        rec = torch.einsum("bhk,hkgl->bghl", h.reshape(b, nh, hd), r).reshape(b, 4, din)
        raw = gx[:, t] + rec + bias
        z = torch.tanh(raw[:, 0])
        i_t = raw[:, 1]
        f_t = raw[:, 2]
        o = torch.sigmoid(raw[:, 3])
        m_new = torch.maximum(f_t + m, i_t)                     # exp-gate stabiliser
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(f_t + m - m_new)
        c = f_p * c + i_p * z
        n = f_p * n + i_p
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return uscan.stack_steps(hs, gx.shape[1], dim=1), (h, c, n, m)


def _slstm_gx(params, x: torch.Tensor):
    xd = x.to(L.ACT_DTYPE)
    xu = torch.matmul(xd, params["up"].to(xd.dtype))
    return xd, _heads(xu, params["wx"]).to(torch.float32)


def slstm_prefill(params, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    b = x.shape[0]
    din, _, _ = _slstm_dims(cfg)
    xd, gx = _slstm_gx(params, x)
    zeros = torch.zeros((b, din), dtype=torch.float32, device=x.device)
    hs, (h, c, n, m) = _slstm_scan(params, cfg, gx, zeros, zeros, zeros, zeros - 10.0)
    out = torch.matmul(hs.to(xd.dtype), params["down"].to(xd.dtype))
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_block(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    out, _ = slstm_prefill(params, cfg, x)
    return out


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    din, _, _ = _slstm_dims(cfg)
    z = torch.zeros((batch, din), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": z - 10.0}


def slstm_decode_step(params, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    xd, gx = _slstm_gx(params, x)
    hs, (h, c, n, m) = _slstm_scan(params, cfg, gx, cache["h"], cache["c"], cache["n"],
                                   cache["m"])
    out = torch.matmul(hs.to(xd.dtype), params["down"].to(xd.dtype))
    return out, {"h": h, "c": c, "n": n, "m": m}
