"""Exact brute-force kNN — the paper's comparator ("original kNN").

Port of `repro/core/exact.py`.  Blocked over the datastore so memory stays
bounded at any N: a loop over N-blocks keeps a running top-k per query.
The l2 distance takes the matrix-product form ‖q‖² − 2q·x + ‖x‖² in full
float32 (TF32 off).  Ties go to the lower point index, as in the
reference's top-k, so the selection uses a stable sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.projection import matmul_f32
from repro_torch.kernels.ref import sqrt_rn


class ExactResult(NamedTuple):
    ids: torch.Tensor    # (B, k) int32
    dists: torch.Tensor  # (B, k) float32


def _pairwise(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """(B, d) x (N, d) -> (B, N) distances."""
    if metric == "l1":
        return (q[:, None, :] - x[None, :, :]).abs().sum(dim=-1)
    qq = (q * q).sum(dim=-1, keepdim=True)
    xx = (x * x).sum(dim=-1)
    d2 = qq - 2.0 * matmul_f32(q, x.T) + xx[None, :]
    return sqrt_rn(torch.clamp_min(d2, 0.0))


def _smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries per row, ascending, lower index first on ties."""
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order), order


def knn(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    metric: str = "l2",
    block: int = 4096,
) -> ExactResult:
    """Exact kNN of `queries` (B, d) against `points` (N, d)."""
    q = queries.to(torch.float32)
    x = points.to(torch.float32)
    b = q.shape[0]
    n = x.shape[0]

    if n <= block:
        vals, idx = _smallest(_pairwise(q, x, metric), min(k, n))
        idx = idx.to(torch.int32)
        if k > n:  # pad to k
            vals = torch.cat([vals, vals.new_full((b, k - n), float("inf"))], dim=1)
            idx = torch.cat([idx, idx.new_full((b, k - n), -1)], dim=1)
        return ExactResult(idx, vals)

    # streaming top-k over blocks; earlier blocks come first in the
    # concatenation, so the stable sort keeps the lower index on ties
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for off in range(0, n, block):
        blk = x[off:off + block]
        ids = torch.arange(off, off + blk.shape[0], dtype=torch.int32, device=q.device)
        cat_d = torch.cat([best_d, _pairwise(q, blk, metric)], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        best_d, sel = _smallest(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return ExactResult(best_i, best_d)


def classify(
    queries: torch.Tensor,
    points: torch.Tensor,
    labels: torch.Tensor,
    k: int,
    n_classes: int,
    metric: str = "l2",
    block: int = 4096,
) -> torch.Tensor:
    """Exact kNN majority-vote classification (B,) int32 — the paper's
    ground truth."""
    res = knn(queries, points, k, metric=metric, block=block)
    neigh = labels[torch.clamp(res.ids, 0, labels.shape[0] - 1).long()]
    onehot = F.one_hot(neigh.long(), n_classes).to(torch.float32)
    votes = (onehot * torch.isfinite(res.dists)[..., None]).sum(dim=1)
    return torch.argmax(votes, dim=-1).to(torch.int32)
