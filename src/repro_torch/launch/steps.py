"""Step factories: train_step / prefill_step / serve_step and the retrieval
serve step, on one device or over a mesh.

Port of `repro/launch/steps.py`.  The reference's factories return jitted
functions with explicit in/out shardings over a mesh, and donate the state
or the caches to the step.  Eager PyTorch has neither: a factory here
returns a plain function on the device its inputs live on.  The train
step builds a new state (the old one is freed once the caller drops it);
the serve steps update the decode caches in place, as
`DecoderLM.decode_step` does.  The reference's `lower_cell`, the dry
run's entry point, has no counterpart yet.  The serve factories keep the
reference's signatures: the `m` of `retrieval=(m, local_window)` shapes
the reference's jitted step, and nothing reads it here.

With `mesh` (a `launch.mesh.Mesh`; one rank per device) a factory's step
takes the reference's layouts: the state's leaves are DTensors placed by
`train_state_specs` (`init_train_state(..., mesh=)` or
`checkpoint.store.restore(..., placements=)` make such a state), the
batch is placed by `sharding.batch_specs`, the decode caches by
`cache_specs`, the logits come out as `fit_pspec(P(dp, mdl))` and the
hidden states as `P(dp, None)`; the serving model's weights are DTensors
(`model_from_params`).  The step bodies run under the reference's
`axis_rules(mesh, default_rules(...))`, so the models' `constrain` calls
place the activations.  Inputs that are plain tensors (the same on every
rank) are split without communication.

The train state is the reference's tree: {"params": the `init_params`
tree in float32 (layers stacked by period position), "opt": an
`adamw.OptState` with the params' structure, "step": () int32}, plus
"err" (the error-feedback residuals) when gradients are compressed.  So
`checkpoint/store.py` writes it under the reference's keys, and either
package restores the other's checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.core import retrieval_memory as rmem
from repro_torch.core.engine import ActiveSearcher
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression
from repro_torch.parallel import axes
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P
from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class StepConfig:
    accum: int = 1                 # gradient-accumulation microbatches
    compress_grads: bool = False   # int8 error-feedback gradient compression
    aux_weight: float = 0.01
    # the loss runs on a copy of the float32 masters cast once a step
    # (`model.compute_copy`); the masters stay in the optimizer
    bf16_compute_copy: bool = True


# ----------------------------------------------------------------- state ----


def train_state_specs(state: dict, cfg: ModelConfig, mesh) -> dict:
    """The train state's PartitionSpecs: the optimizer's moments (and the
    error-feedback residuals) as their params, the counters replicated."""
    pspecs = sh.param_specs(state["params"], cfg, mesh)
    specs = {"params": pspecs, "opt": adamw.OptState(mu=pspecs, nu=pspecs, count=P()),
             "step": P()}
    if "err" in state:
        specs["err"] = pspecs
    return specs


def train_state_shardings(state: dict, cfg: ModelConfig, mesh) -> dict:
    """`train_state_specs` on `mesh`: where `checkpoint.store.restore`
    places each leaf of a restored train state."""
    return sh.named(mesh, train_state_specs(state, cfg, mesh))


def init_train_state(generator: torch.Generator | None, cfg: ModelConfig,
                     opt_cfg: adamw.AdamWConfig, step_cfg: StepConfig, device=None,
                     mesh=None) -> dict:
    """The train state on `device` (None = the card; "meta" for shapes
    only), weights drawn from `generator` (`model.init_params`).  With
    `mesh`, on the mesh's device: each rank draws every weight as one
    device would, a layer at a time, and keeps only its shards, so its
    leaves (DTensors placed by `train_state_specs`) hold the one-device
    values; the counters are plain tensors, the same on every rank."""
    if mesh is None:
        params = M.init_params(cfg, device, generator)
    else:
        params = _init_sharded_params(generator, cfg, mesh)
    dev = params["final_norm"].device
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if step_cfg.compress_grads:
        state["err"] = compression.init_error(params)
    return state


def _init_sharded_params(generator, cfg: ModelConfig, mesh) -> dict:
    shapes = M.init_params(cfg, "meta")
    specs = dict(tree.leaves_with_path(sh.param_specs(shapes, cfg, mesh)))

    def keep(path, leaf):
        spec = specs[path]
        if path[0] == "blocks":          # a layer's leaf: its stack axis is not drawn
            spec = P(*spec[1:])
        return sh.local_part(leaf, mesh, spec).clone()

    local = M.init_params(cfg, mesh.device, generator, local=keep)
    return tree.map_with_path(lambda path, t, like: sh.from_shard(t, mesh, specs[path], like.shape),
                              local, shapes)


def train_state_shapes(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                       step_cfg: StepConfig) -> dict:
    """The train state's structure, shapes and dtypes on the meta device:
    nothing is allocated (a checkpoint restore's structure donor)."""
    return init_train_state(None, cfg, opt_cfg, step_cfg, device="meta")


# ------------------------------------------------------------- train step ----


def _microbatches(batch: dict, accum: int) -> list[dict]:
    """The batch's rows in `accum` consecutive runs, as the reference's
    reshape to (accum, B // accum, ...) splits them."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} % accum {accum}")
    m = b // accum
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(accum)]


def on_mesh(mesh, cfg: ModelConfig, batch_size: int):
    """The context of a step on `mesh`: the reference's axis rules for a
    batch of `batch_size`, and plain tensors (constants, masks) taken as
    replicated where they meet DTensors.  Nothing when `mesh` is None."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(axes.axis_rules(mesh, axes.default_rules(cfg, mesh, batch_size)))
    stack.enter_context(implicit_replication())
    return stack


def _place(mesh, values, specs):
    """Plain tensors (the same on every rank) placed by `specs`; DTensors
    redistributed to them."""
    def one(v, spec):
        if axes.is_distributed(v):
            return v.redistribute(mesh.device_mesh, sh.placements(spec, mesh))
        return sh.distribute(v, mesh, spec)

    return tree.map(one, values, specs)


def _unsharded_over_data(t):
    """A weight gathered over the FSDP ('data') axis, its model-axis
    sharding kept: the compute copy the batch-sharded activations meet (the
    ZeRO-3 schedule), so each product is column- or row-parallel over
    'model' only."""
    from torch.distributed.tensor import Replicate

    if not axes.is_distributed(t):
        return t
    names = t.device_mesh.mesh_dim_names
    whole = [Replicate() if n == "data" else p for n, p in zip(names, t.placements)]
    return t.redistribute(t.device_mesh, whole)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    step_cfg: StepConfig = StepConfig(), mesh=None) -> Callable:
    """(state, batch) -> (new state, metrics {"loss", "nll", "aux",
    "grad_norm", "lr"}, () tensors).

    The loss's gradient is taken on the compute copy (or, with
    `bf16_compute_copy=False`, on the float32 masters themselves) and
    lands in float32 on the masters.  With accumulation (`step_cfg.accum`
    if > 1, else `cfg.policy.accum`) the microbatches' gradients are
    summed in float32 and divided by their count; the metrics are the
    last microbatch's, as the reference's scan carries them out.  Then
    compression where asked, then `adamw.update`.

    With `mesh` the state's leaves are DTensors (`train_state_specs`) and
    `batch` holds the whole global batch on every rank: each microbatch is
    placed by `batch_specs`, the compute copy is gathered over 'data' (its
    model-axis shards kept), and the gradients come back reduced onto the
    masters' shards.  The metrics are plain tensors, the same on every
    rank."""
    accum = step_cfg.accum if step_cfg.accum > 1 else max(cfg.policy.accum, 1)

    def compute(params):
        used = M.compute_copy(params) if step_cfg.bf16_compute_copy else params
        return used if mesh is None else tree.map(_unsharded_over_data, used)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        masters = tree.leaves(params)
        b = next(iter(batch.values())).shape[0]
        for p in masters:
            p.requires_grad_(True)
        try:
            with on_mesh(mesh, cfg, b):
                for mb in _microbatches(batch, accum):
                    if mesh is not None:
                        mb = _place(mesh, mb, sh.batch_specs(mb, mesh, cfg))
                    used = compute(params)
                    loss, parts = M.loss_params(cfg, used, mb, step_cfg.aux_weight)
                    del used
                    loss.backward()
                    metrics = {"loss": loss.detach(), "nll": parts["nll"].detach(),
                               "aux": parts["aux"].detach()}
                    del loss, parts
            # a leaf the loss never reads (the embedding under an audio
            # frontend) gets a zero gradient, as the reference's does
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in masters]
        finally:
            for p in masters:
                p.grad = None
                p.requires_grad_(False)
        if mesh is not None:
            metrics = {k: sh.gather(v) for k, v in metrics.items()}
            grads = [g if g.placements == p.placements else g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, masters)]
        if accum > 1:
            # XLA divides by a constant as a multiply by its float32
            # reciprocal (exact for a power of two)
            grads = [g.mul_(1.0 / accum) for g in grads]
        grads = tree.unflatten(params, iter(grads))

        new_state = dict(state)
        if step_cfg.compress_grads:
            grads, new_state["err"] = compression.compress_grads(grads, state["err"])
        new_params, opt, opt_metrics = adamw.update(opt_cfg, grads, state["opt"], params)
        del grads
        new_state["params"] = new_params
        new_state["opt"] = opt
        new_state["step"] = state["step"] + 1
        return new_state, {**metrics, **opt_metrics}

    return train_step


# ------------------------------------------------------ prefill and serve ----


def _serve_out(mesh, cfg: ModelConfig, logits, caches, hidden):
    """The reference's out shardings: logits fit_pspec(P(dp, mdl)),
    hidden P(dp, None), the caches as they are."""
    b = logits.shape[0]
    dp = sh.dp_axes_for(b, mesh, cfg.policy.dp_only)
    mdl = "model" if "model" in mesh.axis_names else None
    spec = sh.fit_pspec(P(dp, mdl), (b, logits.shape[1]), mesh)
    logits = logits.redistribute(mesh.device_mesh, sh.placements(spec, mesh))
    hidden = hidden.redistribute(mesh.device_mesh, sh.placements(P(dp, None), mesh))
    return logits, caches, hidden


def make_prefill_step(cfg: ModelConfig, mesh=None) -> Callable:
    """(model, batch) -> (logits (B, V), caches, hidden (B, d)):
    `DecoderLM.prefill` without gradients.  With `mesh` the model's
    weights are DTensors (`model_from_params`), the batch is placed by
    `batch_specs` and the outputs by the reference's out shardings."""

    def prefill_step(model: M.DecoderLM, batch: dict):
        with torch.no_grad():
            if mesh is None:
                return model.prefill(batch)
            with on_mesh(mesh, cfg, next(iter(batch.values())).shape[0]):
                batch = _place(mesh, batch, sh.batch_specs(batch, mesh, cfg))
                return _serve_out(mesh, cfg, *model.prefill(batch))

    return prefill_step


def _decode_inputs(mesh, cfg: ModelConfig, caches, token, rows: tuple):
    """A decode step's inputs placed as the reference's in shardings: the
    token P(dp), the caches by `cache_specs`, each of `rows` P(dp, None)."""
    b = token.shape[0]
    dp = sh.dp_axes_for(b, mesh, cfg.policy.dp_only)
    caches = _place(mesh, caches, sh.cache_specs(caches, cfg, mesh, b))
    token = _place(mesh, token, P(dp))
    return caches, token, [None if r is None else _place(mesh, r, P(dp, None)) for r in rows]


def make_serve_step(cfg: ModelConfig, retrieval: tuple[int, int] | None = None,
                    mesh=None) -> Callable:
    """One decode step: (model, caches, token, pos[, retrieved, ok]) ->
    (logits (B, V), caches, hidden (B, d)), the caches updated in place.
    retrieval=(m, local_window) takes the positions of the active-search
    retrieval memory (m a row) and attends to them and the local window.
    Only local_window is read.  With `mesh` the inputs are placed as the
    reference's in shardings (`_decode_inputs`) and the caches returned
    are DTensors placed by `cache_specs` (pass them to the next step)."""

    def serve_step(model: M.DecoderLM, caches, token, pos, retrieved=None, retrieved_ok=None):
        with torch.no_grad(), on_mesh(mesh, cfg, token.shape[0]):
            if mesh is not None:
                caches, token, (retrieved, retrieved_ok) = _decode_inputs(
                    mesh, cfg, caches, token, (retrieved, retrieved_ok))
            if retrieval is None:
                out = model.decode_step(caches, token, pos)
            else:
                out = model.decode_step(caches, token, pos,
                                        retrieved=(retrieved, retrieved_ok, retrieval[1]))
            return out if mesh is None else _serve_out(mesh, cfg, *out)

    return serve_step


def _query(embed, wq0, token) -> torch.Tensor:
    x = L.embed_lookup(embed, token)[:, None, :].to(torch.bfloat16)
    q0 = attn._project(x, wq0)                                    # (B, 1, H, hd)
    return rmem.query_summary(q0[:, 0])


def retrieval_query(model: M.DecoderLM, token: torch.Tensor) -> torch.Tensor:
    """The retrieval serve step's query (B, hd), float32: `token` (B,)
    embedded in bf16, layer 0's query projection (no norm, no RoPE) and its
    summary over the heads.  With DTensor weights every rank computes the
    whole batch's queries as one device does (a replicated DTensor), so
    each row is the one-device row, bit for bit."""
    with torch.no_grad():
        return axes.replicated_local(_query, model.embed, model.layers[0].core["wq"],
                                     token.to(model.device))


def retrieve(model: M.DecoderLM, index, token: torch.Tensor, pos,
             mem_cfg: rmem.RetrievalMemoryConfig):
    """The retrieval serve step's search: `retrieval_query` over the memory
    index on `mem_cfg.plan` for `mem_cfg.n_retrieved` positions ->
    (positions (B, m) int32, clamped at 0; ok (B, m): valid and before
    `pos`).  On a mesh (inside a step's axis rules) each rank searches its
    own batch rows of the replicated index (`to_local`: the search kernels
    have no DTensor rule), and both come back batch-sharded."""
    searcher = ActiveSearcher.from_index(index, mem_cfg.grid, plan=mem_cfg.plan,
                                         device=index.device)

    def search(q):
        res = searcher.search(q, mem_cfg.n_retrieved)
        positions = torch.clamp_min(res.ids, 0)
        return positions, res.valid & (positions < int(pos))

    rows = ("batch", None)
    return axes.local_map(search, (rows,), [rows, rows], retrieval_query(model, token))


def make_retrieval_serve_step(cfg: ModelConfig, mem_cfg: rmem.RetrievalMemoryConfig | None = None,
                              mesh=None) -> Callable:
    """The long-context serve step with the paper's active search inside:
    (model, caches, index, token, pos) -> (logits (B, V), caches, hidden
    (B, d)).  Each step searches the memory index of key summaries
    (`retrieve`: on `hopper`, one radius_search_loop and one
    csr_candidate_topk launch, on every rank of a mesh), then decodes
    attending only to the local window and the retrieved positions.  With
    `mesh` the index is replicated (every rank holds it whole) and the
    rest is placed as in `make_serve_step`."""
    mem_cfg = mem_cfg or rmem.RetrievalMemoryConfig()

    def serve_step(model: M.DecoderLM, caches, index, token, pos):
        with torch.no_grad(), on_mesh(mesh, cfg, token.shape[0]):
            if mesh is not None:
                caches, token, _ = _decode_inputs(mesh, cfg, caches, token, ())
            positions, ok = retrieve(model, index, token, pos, mem_cfg)
            out = model.decode_step(caches, token, pos,
                                    retrieved=(positions, ok, mem_cfg.local_window))
            return out if mesh is None else _serve_out(mesh, cfg, *out)

    return serve_step
