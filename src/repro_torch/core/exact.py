"""Exact brute-force kNN — the paper's comparator ("original kNN").

Port of `repro/core/exact.py`.  The l2 route is the brute_knn kernel
(`kernels/ops.brute_knn`: the hand-written Hopper kernel on the card, its
plain version `kernels/ref.brute_knn` on the CPU): ‖q‖² − 2q·x + ‖x‖² with
a running top-k over the points, lower index first on ties, so the (B, N)
distance matrix never exists.  The l1 route is plain tensor code on both
devices, blocked over the points with the plain version's running top-k
(`ref.streaming_smallest_k`): the reference computes exact l1 in jnp and
has no kernel for it, so the metric decides the route, not the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref


class ExactResult(NamedTuple):
    ids: torch.Tensor    # (B, k) int32
    dists: torch.Tensor  # (B, k) float32


def knn(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    metric: str = "l2",
    block: int = 4096,
) -> ExactResult:
    """Exact kNN of `queries` (B, d) against `points` (N, d).  `block` is
    the plain versions' N-block; the kernel tiles by its own sizes."""
    q = queries.to(torch.float32)
    x = points.to(torch.float32)
    if metric == "l1":
        blocks = ((off, (q[:, None, :] - x[None, off:off + block, :]).abs().sum(dim=-1))
                  for off in range(0, x.shape[0], block))
        dists, ids = ref.streaming_smallest_k(blocks, q.shape[0], k, q.device)
    else:
        dists, ids = ops.brute_knn(q, x, k, block_n=block)
    return ExactResult(ids, dists)


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
