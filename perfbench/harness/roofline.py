"""The least time a search call's candidate stage could take on one H100.

A frozen copy of `chip_smoke.py`'s `bound` and of its distinct-row count
for `csr_candidate_topk` (phase 3), counted from the inputs (the queries'
window spans over the reference's own index), never from the kernel, so
that it reads the same work whatever implements the stage:

  bytes = distinct store rows x d x 4 + B x (window x 8 + d x 4 + k x 8)
  ops   = valid (query, row) pairs x 3d
  least = max(bytes / 3.35 TB/s, ops / 67 TFLOP/s)

The peaks are the H100 SXM data sheet's: HBM3 bandwidth and float32 outside
the tensor cores (the candidate distances are float32 FMA-free sums).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def candidate_work(starts: torch.Tensor, ends: torch.Tensor, n: int, row_cap: int, d: int,
                   k: int, block: int = 4096) -> tuple[float, float]:
    """(bytes, ops) of ranking every query's window: starts / ends (B, w)
    CSR spans over n rows, each window row read from its clamped start for
    row_cap rows; a row shared by several queries' windows is read once."""
    b, w = starts.shape
    n_pad = max(n, row_cap)
    seen = torch.zeros(n_pad, dtype=torch.bool, device=starts.device)
    pairs = 0
    for i in range(0, b, block):
        st, en = starts[i:i + block].to(torch.int64), ends[i:i + block].to(torch.int64)
        j = st.clamp(0, n_pad - row_cap)[:, :, None] + torch.arange(row_cap, device=st.device)
        ok = (j >= st[:, :, None]) & (j < en[:, :, None]) & (j < n)
        pairs += int(ok.sum())
        seen[j[ok]] = True
    distinct = int(seen.sum())
    return distinct * d * 4 + b * (w * 8 + d * 4 + k * 8), 3 * pairs * d
