"""AdamW: float32 moments, global-norm clip, cosine schedule with warmup,
decoupled weight decay.

Port of `repro/optim/adamw.py`.  The optimizer state has the params' tree
structure (`utils/tree.py`: nested dicts and lists, visited in the
reference's order), so a path here is the reference's path and its
checkpoint keys are the reference's.  `update` is functional, as the
reference's: it returns new params and a new state and leaves its inputs
as they are.  On a mesh the leaves are DTensors (the moments placed as
their params): every update is elementwise on each rank's shards, and the
global norm adds each leaf's whole sum of squares, across its shards, in
the reference's leaf order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.parallel import axes
from repro_torch.parallel.sharding import gather
from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor   # () int32


def init(params: Any) -> OptState:
    """Zero moments in float32 beside each leaf (DTensors placed as their
    leaves on a mesh), count 0 on the params' device."""
    zeros = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    dev = tree.leaves(params)[0].device
    return OptState(mu=zeros, nu=tree.map(torch.clone, zeros),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a () tensor): linear warmup over
    `warmup_steps`, then a cosine down to `min_lr_ratio` of `lr` at
    `total_steps`; float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, s) * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, leaves
    added in the reference's order (a sharded leaf's sum over its shards)."""
    total = None
    for g in tree.leaves(grads):
        sq = gather(torch.sum(torch.square(g.to(torch.float32))))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree.map(lambda g: g * scale.to(g.dtype), grads), norm


_NO_DECAY = ("norm1", "norm2", "final_norm", "bias", "conv_b", "dt_bias", "fgate_bias",
             "A_log", "D")


def _decay_mask(path: tuple) -> bool:
    """Decay matrices only — not norms/biases/gates (standard practice).
    `path` is a leaf's path; its last entry is the leaf's name where the
    leaf sits in a dict."""
    name = path[-1] if isinstance(path[-1], str) else None
    return name not in _NO_DECAY


def update(cfg: AdamWConfig, grads: Any, state: OptState,
           params: Any) -> tuple[Any, OptState, dict]:
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}).
    The gradients are clipped first, then the count goes up by one, and
    the schedule is read at the new count."""
    with torch.no_grad(), axes.mixing(params):
        grads = tree.map(lambda g: g.to(torch.float32), grads)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        count = state.count + 1
        lr = schedule(cfg, count)
        b1, b2 = cfg.b1, cfg.b2

        mu = tree.map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree.map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        del grads
        c = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1.0 - torch.pow(_f32(b1, c), c))
        nu_hat_scale = 1.0 / (1.0 - torch.pow(_f32(b2, c), c))

        def step(path, p, m, v):
            upd = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + cfg.eps)
            if _decay_mask(path):
                upd = upd + cfg.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        new_params = tree.map_with_path(step, params, mu, nu)
    return new_params, OptState(mu, nu, count), {"grad_norm": gnorm, "lr": lr}
