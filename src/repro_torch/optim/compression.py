"""Gradient compression with error feedback.

Port of `repro/optim/compression.py`: int8 per-tensor-scale quantization
plus an error-feedback residual (1-bit-Adam lineage): the residual carries
the quantization error into the next step, so the accumulated update is
unbiased.  The int8 round trip is the shared codec in `utils/quantize.py`,
the same one the quantized candidate store uses.

`compress_grads` is the pure transform a train step applies (on a mesh
its per-tensor scale is the whole leaf's, across its shards).
`compressed_psum` is the reference's `shard_map` building block: the
all-reduce of the int8 payload over a mesh axis's process group, with
explicit collectives.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.parallel import axes
from repro_torch.utils import tree
from repro_torch.utils.quantize import dequantize, quantize_symmetric, quantize_with_scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback compression round: returns (g_hat, new_err)."""
    gf = g.to(torch.float32) + err
    q, scale = quantize_symmetric(gf)
    g_hat = dequantize(q, scale)
    return g_hat, gf - g_hat


def init_error(params: Any) -> Any:
    return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_grads(grads: Any, err: Any) -> tuple[Any, Any]:
    with torch.no_grad(), axes.mixing(grads):
        out = [compress_leaf(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, iter([o[0] for o in out])),
            tree.unflatten(grads, iter([o[1] for o in out])))


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce this rank's gradient `g` over `group` (a mesh axis's
    process group; None = every rank) in int8 with error feedback -> (the
    mean over the group's ranks, this rank's new residual).

    The scale is the group's largest (a max all-reduce), so every rank
    dequantizes the summed codes alike; the codes are summed in int32 and
    the rank count is a sum of ones, as the reference's `psum`s do.
    Traffic: 1 byte/elem int8 codes (carried in int32 here) and two
    scalars, vs 4 bytes/elem for a float32 all-reduce."""
    with torch.no_grad():
        gf = g.to(torch.float32) + err
        _, scale = quantize_symmetric(gf)
        scale = scale.clone()
        dist.all_reduce(scale, dist.ReduceOp.MAX, group=group)
        q = quantize_with_scale(gf, scale)
        g_hat_local = dequantize(q, scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, dist.ReduceOp.SUM, group=group)
        n = torch.ones((), dtype=torch.float32, device=gf.device)
        dist.all_reduce(n, dist.ReduceOp.SUM, group=group)
        return total.to(torch.float32) * scale / n, gf - g_hat_local
