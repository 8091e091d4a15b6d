"""Summed-area table (integral image) counter — beyond-paper variant.

Port of `repro/core/integral.py`.  With an L∞ ball (an axis-aligned square)
the per-class count is FOUR gathers into a summed-area table, exact at any
radius:

    count([x0,x1) x [y0,y1)) = S[x1,y1] - S[x0,y1] - S[x1,y0] + S[x0,y0]

Enabled with GridConfig(counter="sat").  No kernel: four gathers per query.
The functions take a batch of queries (leading dim B).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def build_sat(base: torch.Tensor) -> torch.Tensor:
    """(S, S, C) int32 counts -> (S+1, S+1, C) inclusive-prefix SAT with a
    zero border, so count_rect needs no bounds special-casing."""
    sat = torch.cumsum(torch.cumsum(base, dim=0), dim=1).to(torch.int32)
    return F.pad(sat, (0, 0, 1, 0, 1, 0))


def count_rect(
    sat: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, y0: torch.Tensor, y1: torch.Tensor
) -> torch.Tensor:
    """Exact per-class counts (B, C) of base cells in [x0, x1) x [y0, y1).
    Bounds are (B,) integer cell indices, clipped to the grid."""
    s = sat.shape[0] - 1
    x0, x1, y0, y1 = (torch.clamp(t, 0, s).long() for t in (x0, x1, y0, y1))
    return sat[x1, y1] - sat[x0, y1] - sat[x1, y0] + sat[x0, y0]


def count_linf(sat: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-class counts (B, C) of cells whose CENTER lies within L∞ distance
    r (B,) of the continuous positions q (B, 2) — the squares [q-r, q+r]^2.

    A center i+0.5 is inside iff |i + 0.5 - qx| <= r, so the cell-index range
    is [ceil(qx - r - 0.5), floor(qx + r - 0.5)] inclusive."""
    rf = r.to(torch.float32)
    x0 = torch.ceil(q[:, 0] - rf - 0.5).to(torch.int32)
    x1 = torch.floor(q[:, 0] + rf - 0.5).to(torch.int32) + 1
    y0 = torch.ceil(q[:, 1] - rf - 0.5).to(torch.int32)
    y1 = torch.floor(q[:, 1] + rf - 0.5).to(torch.int32) + 1
    empty = (x1 <= x0) | (y1 <= y0)
    out = count_rect(sat, x0, torch.maximum(x1, x0), y0, torch.maximum(y1, y0))
    return torch.where(empty[:, None], torch.zeros_like(out), out)
