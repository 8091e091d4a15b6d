"""Gradient compression with error feedback.

Port of `repro/optim/compression.py`: int8 per-tensor-scale quantization
plus an error-feedback residual (1-bit-Adam lineage): the residual carries
the quantization error into the next step, so the accumulated update is
unbiased.  The int8 round trip is the shared codec in `utils/quantize.py`,
the same one the quantized candidate store uses.

`compress_grads` is the pure transform a train step applies.  The
reference's `compressed_psum`, the all-reduce of the int8 payload over a
mesh axis, needs a mesh, which the port does not have yet.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils import tree
from repro_torch.utils.quantize import dequantize, quantize_symmetric


def compress_leaf(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback compression round: returns (g_hat, new_err)."""
    gf = g.to(torch.float32) + err
    q, scale = quantize_symmetric(gf)
    g_hat = dequantize(q, scale)
    return g_hat, gf - g_hat


def init_error(params: Any) -> Any:
    return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_grads(grads: Any, err: Any) -> tuple[Any, Any]:
    with torch.no_grad():
        out = [compress_leaf(g, e) for g, e in zip(tree.leaves(grads), tree.leaves(err))]
    return (tree.unflatten(grads, iter([o[0] for o in out])),
            tree.unflatten(grads, iter([o[1] for o in out])))
