"""Shared symmetric int8 round-trip helpers.

Port of `repro/utils/quantize.py`, the int8 codec behind the quantized
candidate store (`core/quantized.py`, the `hopper_q8` backend).

Symmetric codebook: `scale = max(|x|) / 127` (eps-floored so all-zero
inputs stay representable), `q = clip(round(x / scale), -127, 127)`.
-128 is never produced, so negation round-trips.
"""

from __future__ import annotations

import torch

# int8 symmetric codebook half-range: values land in [-127, 127]
QMAX = 127
_EPS = 1e-12


def symmetric_scale(max_abs) -> torch.Tensor:
    """Per-group scale from a (broadcastable) max-|x| statistic."""
    m = torch.clamp_min(torch.as_tensor(max_abs, dtype=torch.float32), _EPS)
    # The reference's jitted `max_abs / 127` runs as a multiply by the
    # float32 reciprocal (XLA rewrites division by a constant), and a true
    # division differs in ~4% of cells; the scale moves int8 codes and with
    # them the shortlist, so the port multiplies by the same reciprocal.
    return m * torch.tensor(1.0 / QMAX, dtype=torch.float32, device=m.device)


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes for `x` under an externally chosen (broadcastable) scale;
    round half to even, like `jnp.round`."""
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)


def quantize_symmetric(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q int8, scale float32 scalar)."""
    scale = symmetric_scale(x.abs().max())
    return quantize_with_scale(x, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 reconstruction of int8 codes under a (broadcastable) scale."""
    return q.to(torch.float32) * scale
