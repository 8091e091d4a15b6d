"""The benchmark's plain reference, part 3: the exact k nearest neighbours in float64.

Brute force over every live point, block by block, with ties broken by the
lower id.  `recall_at_k` is measured against it; it knows nothing of grids.
"""

from __future__ import annotations

import torch


def knn_ids(queries: torch.Tensor, points: torch.Tensor, ids: torch.Tensor, k: int,
            q_block: int = 8192, p_block: int = 1 << 17) -> torch.Tensor:
    """(B, k) ids of the k nearest points by float64 distance.

    points (N, d) and their ids (N,) on one device; queries (B, d)."""
    out = []
    for qb in queries.split(q_block):
        q = qb.to(torch.float64)
        best_d = q.new_full((q.shape[0], 0), float("inf"))
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
        for off in range(0, points.shape[0], p_block):
            x = points[off:off + p_block].to(torch.float64)
            d = (q * q).sum(1, keepdim=True) - 2.0 * q @ x.T + (x * x).sum(1)[None, :]
            blk_ids = ids[off:off + p_block].to(torch.int64)
            kk = min(k, x.shape[0])
            d_top, pos = torch.topk(d, kk, dim=1, largest=False, sorted=False)
            cat_d = torch.cat([best_d, d_top], dim=1)
            cat_i = torch.cat([best_i, blk_ids[pos]], dim=1)
            # lower distance first, then lower id
            order = torch.argsort(cat_i, dim=1, stable=True)
            cat_d, cat_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
            order = torch.argsort(cat_d, dim=1, stable=True)[:, :k]
            best_d, best_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
        out.append(best_i.cpu())
    return torch.cat(out)


def recall(got_ids: torch.Tensor, truth_ids: torch.Tensor) -> float:
    """Mean over queries of |got ∩ truth| / k (pads, -1, never match)."""
    k = truth_ids.shape[1]
    got = got_ids.to(torch.int64)
    hit = (got[:, :, None] == truth_ids[:, None, :]) & (got[:, :, None] >= 0)
    return float(hit.any(dim=2).sum()) / (k * got.shape[0])
