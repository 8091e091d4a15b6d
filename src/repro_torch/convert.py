"""Carry a built index, a mutable index's state, or a model's weights and
decode caches across from the JAX package as numpy arrays.

The index is the port's "weights": the tests build it once with the
reference, turn it into numpy (`jax.tree.map(np.asarray, index)._asdict()`)
and load it here, so that both packages search the very same arrays.  A
mutable state travels as the reference's `mutable.state_to_tree` dict; a
sharded index as the stacked index's arrays, and a sharded mutation state
as one such dict per shard plus the global `next_id`.  A model travels as
the reference's `init_params` tree (layers stacked by period position) and
its decode caches as the reference's period-stacked list, both ways; a
train state as the reference's {"params", "opt", "step"[, "err"]} tree,
both ways.  Nothing here imports the reference: it takes plain arrays.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import mutable as mut
from repro_torch.core.grid import GridConfig, GridIndex, as_tensor, resolve_device
from repro_torch.core.projection import Projection
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import DecoderLM, cache_dtype
from repro_torch.optim import adamw
from repro_torch.utils import tree as tree_util


def projection_from_numpy(matrix, lo, hi, device=None) -> Projection:
    """A Projection from its (d, gd) matrix and (gd,) extents, float32, on
    `device` (None = the card)."""
    dev = resolve_device(device)
    return Projection(*(as_tensor(np.asarray(a), torch.float32, dev) for a in (matrix, lo, hi)))


def index_from_numpy(
    fields: Mapping[str, np.ndarray | Sequence[np.ndarray]],
    cfg: GridConfig,
    device=None,
) -> GridIndex:
    """The port's GridIndex from the fields of a reference GridIndex as numpy
    arrays: proj (matrix, lo, hi), points_sorted, coords_sorted,
    labels_sorted, ids_sorted, offsets, pyramid (a sequence), sat and
    pyr_tiles (either may be None).  Float fields become float32 and
    integer fields int32, on `device` (None = the card)."""
    dev = resolve_device(device)
    f32 = lambda a: as_tensor(np.asarray(a), torch.float32, dev)  # noqa: E731
    i32 = lambda a: None if a is None else as_tensor(np.asarray(a), torch.int32, dev)  # noqa: E731
    pyramid = tuple(i32(a) for a in fields["pyramid"])
    _check_levels(len(pyramid), cfg)
    return GridIndex(
        proj=Projection(*(f32(a) for a in fields["proj"])),
        points_sorted=f32(fields["points_sorted"]),
        coords_sorted=f32(fields["coords_sorted"]),
        labels_sorted=i32(fields["labels_sorted"]),
        ids_sorted=i32(fields["ids_sorted"]),
        offsets=i32(fields["offsets"]),
        pyramid=pyramid,
        sat=i32(fields.get("sat")),
        pyr_tiles=i32(fields.get("pyr_tiles")),
    )


def mutable_from_numpy(
    tree: Mapping[str, np.ndarray], cfg: GridConfig, device=None
) -> mut.MutableIndex:
    """The port's MutableIndex from the reference's `state_to_tree` dict as
    numpy arrays (the same keys), in the reference's dtypes, on `device`
    (None = the card).  The state goes on growing in the port exactly as
    it would have in the reference."""
    state = mut.state_from_tree(tree, device=device)
    _check_levels(len(state.pyramid), cfg)
    return state


def sharded_index_from_numpy(
    fields: Mapping[str, np.ndarray | Sequence[np.ndarray]],
    cfg: GridConfig,
    device=None,
) -> GridIndex:
    """The port's stacked sharded GridIndex from the fields of the
    reference's `build_sharded_index` / `stacked_snapshot` result as numpy
    arrays: the same fields as `index_from_numpy`, each with a leading
    shard dimension, on `device` (None = the card)."""
    if np.ndim(fields["offsets"]) != 2:
        raise ValueError(
            f"a stacked index has (n_shards, G*G + 1) offsets; got shape "
            f"{np.shape(fields['offsets'])}"
        )
    return index_from_numpy(fields, cfg, device=device)


def sharded_mutable_from_numpy(
    trees: Sequence[Mapping[str, np.ndarray]],
    next_id: int,
    cfg: GridConfig,
    device=None,
) -> dist.ShardedMutable:
    """The port's ShardedMutable from the reference's per-shard
    `state_to_tree` dicts (shard order) and its global `next_id`, on
    `device` (None = the card)."""
    states = tuple(mutable_from_numpy(t, cfg, device=device) for t in trees)
    return dist.ShardedMutable(states=states, next_id=int(next_id))


def model_from_numpy(tree: Mapping, cfg: ModelConfig, device=None) -> DecoderLM:
    """The port's DecoderLM from the reference's `init_params` tree as numpy
    arrays (`jax.tree.map(np.asarray, params)`): `embed`, `final_norm`,
    `lm_head` (unless the embeddings are tied) and `blocks`, a list over
    period positions whose nested dicts of leaves carry a leading
    (n_repeat,) axis (an MoE layer's `ffn.shared` too, and its padded
    experts' weights).  Layer i takes repeat i // period of position i %
    period.  Each weight is stored in the model's dtype for it (a matrix
    rounded to `ACT_DTYPE` as the reference rounds it at use, the weights
    it uses in float32 kept so); on `device` (None = the card)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, device="meta").to_empty(device=dev)
    f32 = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    state = {"embed": f32(tree["embed"]), "final_norm": f32(tree["final_norm"])}
    if not cfg.tie_embeddings:
        state["lm_head"] = f32(tree["lm_head"])

    def add(prefix: str, node, r: int) -> None:
        if isinstance(node, Mapping):
            for key, child in node.items():
                add(f"{prefix}.{key}", child, r)
        else:
            state[prefix] = f32(node[r])

    period = cfg.block_period
    for i in range(cfg.n_layers):
        add(f"layers.{i}", tree["blocks"][i % period], i // period)
    model.load_state_dict(state, strict=True)
    return model


def model_to_numpy(model: DecoderLM) -> dict:
    """The reference's `init_params` tree of the model's weights as float32
    numpy arrays, the inverse of `model_from_numpy` (a weight stored in
    bf16 comes back as the float32 value it rounds to, exactly)."""
    cfg = model.cfg
    f32 = lambda t: t.detach().to("cpu", torch.float32).numpy()  # noqa: E731

    def nested(layer) -> dict:
        out: dict = {}
        for name, param in layer.named_parameters():
            *path, leaf = name.split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = f32(param)
        return out

    period = cfg.block_period
    blocks = []
    for p in range(period):
        per_repeat = [nested(model.layers[r * period + p]) for r in range(cfg.n_repeat)]
        blocks.append(_stack(per_repeat))
    tree = {"embed": f32(model.embed), "final_norm": f32(model.final_norm), "blocks": blocks}
    if not cfg.tie_embeddings:
        tree["lm_head"] = f32(model.lm_head)
    return tree


def _stack(trees: list) -> dict:
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _tensors(node, dev: torch.device):
    """Nested dicts / lists of arrays as tensors on `dev`, dtypes kept."""
    if isinstance(node, Mapping):
        return {k: _tensors(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tensors(v, dev) for v in node]
    return torch.from_numpy(np.array(node)).to(dev)


def train_state_from_numpy(state: Mapping, device=None) -> dict:
    """The port's train state (`launch/steps.py`) from the reference's as
    numpy arrays (`jax.tree.map(np.asarray, state)`): "params", "opt" (any
    (mu, nu, count) triple, such as the reference's OptState), "step" and,
    with compressed gradients, "err"; dtypes kept (float32 masters and
    moments, int32 counters), on `device` (None = the card)."""
    dev = resolve_device(device)
    mu, nu, count = state["opt"]
    out = {"params": _tensors(state["params"], dev),
           "opt": adamw.OptState(_tensors(mu, dev), _tensors(nu, dev), _tensors(count, dev)),
           "step": _tensors(state["step"], dev)}
    if "err" in state:
        out["err"] = _tensors(state["err"], dev)
    return out


def train_state_to_numpy(state: Mapping) -> dict:
    """The port's train state as the same structure of numpy arrays (the
    reference's leaves, path for path: `utils.tree.leaves_with_path`)."""
    return tree_util.map(lambda t: t.detach().cpu().numpy(), dict(state))


def caches_from_numpy(caches: Sequence[Mapping[str, np.ndarray]], device=None) -> list:
    """The port's decode caches from the reference's: a list over period
    positions of the kind's states (attention k, v; Mamba conv, ssm;
    mLSTM c, n; sLSTM h, c, n, m), each with a leading (n_repeat,) axis.
    Every state is carried in the reference's dtype for it
    (`model.cache_dtype`: k, v and conv in `ACT_DTYPE`, the recurrent
    states in float32), on `device` (None = the card)."""
    dev = resolve_device(device)
    return [{key: torch.from_numpy(np.array(a, np.float32)).to(dev, cache_dtype(key))
             for key, a in c.items()} for c in caches]


def caches_to_numpy(caches: Sequence[Mapping[str, torch.Tensor]]) -> list:
    """The port's decode caches as the reference's structure of float32
    numpy arrays (every bf16 value is exactly a float32 one;
    `caches_from_numpy` rounds nothing on the way back)."""
    return [{key: a.detach().to("cpu", torch.float32).numpy() for key, a in c.items()}
            for c in caches]


def _check_levels(n: int, cfg: GridConfig) -> None:
    if n != cfg.levels:
        raise ValueError(f"pyramid has {n} levels; cfg expects {cfg.levels}")
