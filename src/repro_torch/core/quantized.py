"""QuantizedStore: the CSR candidate store at int8 width (`hopper_q8`).

Port of `repro/core/quantized.py`.  The candidate stage is bound by the
bytes of the store rows it reads; this store holds the SAME CSR-sorted
points at 1 byte per dimension with per-cell symmetric scales
(`utils/quantize.py`):

  cell_scales[c] = max(|x|) over points of cell c / 127     (eps-floored)
  q_points[j]    = clip(round(points_sorted[j] / scale_of_cell(j)))

`row_scales` broadcasts the owning cell's scale to every CSR row, including
the `padded_csr` slack rows (eps scale, zero codes), so span arithmetic
stays identical to the float32 store.  The store is a pure function of the
index; the engine memoises it per handle (`core/engine.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.active_search import padded_csr
from repro_torch.core.grid import GridConfig, GridIndex, cell_id_of
from repro_torch.utils.quantize import quantize_with_scale, symmetric_scale


class QuantizedStore(NamedTuple):
    """int8 view of the padded CSR point store (same row order/indices)."""

    q_points: torch.Tensor     # (n_pad, d) int8 — CSR-sorted points, quantized
    row_scales: torch.Tensor   # (n_pad, 1) float32 — owning cell's scale per row
    cell_scales: torch.Tensor  # (padded_size**2,) float32 — per-cell scale


def quantize_index(index: GridIndex, cfg: GridConfig) -> QuantizedStore:
    """Per-cell symmetric int8 quantization of the padded CSR store."""
    pts, _crd, _lab, _ids, n, n_pad = padded_csr(index, cfg.row_cap)
    g = cfg.padded_size
    dev = pts.device

    cid = cell_id_of(index.coords_sorted, g).long()                # (n,)
    point_max = index.points_sorted.abs().amax(dim=1)              # (n,)
    cell_max = torch.full((g * g,), float("-inf"), device=dev).scatter_reduce_(
        0, cid, point_max, "amax"
    )
    # empty cells stay -inf; floor them so the scale stays finite
    cell_scales = symmetric_scale(torch.clamp_min(cell_max, 0.0))  # (g*g,)

    row_scales = cell_scales[cid]                                  # (n,)
    if n_pad != n:  # padded_csr slack rows: eps scale, zero codes
        row_scales = torch.cat(
            [row_scales, symmetric_scale(0.0).to(dev).expand(n_pad - n)]
        )
    row_scales = row_scales[:, None].contiguous()                  # (n_pad, 1)
    return QuantizedStore(
        q_points=quantize_with_scale(pts, row_scales),
        row_scales=row_scales,
        cell_scales=cell_scales,
    )
