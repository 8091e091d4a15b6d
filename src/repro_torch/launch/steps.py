"""Step factories: train_step / prefill_step / serve_step and the retrieval
serve step, on one device.

Port of `repro/launch/steps.py`.  The reference's factories return jitted
functions with explicit in/out shardings over a mesh, and donate the state
or the caches to the step.  Eager PyTorch has neither: a factory here
returns a plain function on the device its inputs live on.  The train
step builds a new state (the old one is freed once the caller drops it);
the serve steps update the decode caches in place, as
`DecoderLM.decode_step` does.  The reference's `lower_cell`, the dry
run's entry point, has no counterpart yet.  The serve factories keep the
reference's signatures: `cfg`, and the `m` of `retrieval=(m,
local_window)`, shape the reference's jitted step and its shardings, and
nothing reads them here (the model and the arguments carry the shapes).

The train state is the reference's tree: {"params": the `init_params`
tree in float32 (layers stacked by period position), "opt": an
`adamw.OptState` with the params' structure, "step": () int32}, plus
"err" (the error-feedback residuals) when gradients are compressed.  So
`checkpoint/store.py` writes it under the reference's keys, and either
package restores the other's checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import retrieval_memory as rmem
from repro_torch.core.engine import ActiveSearcher
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression
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


def init_train_state(generator: torch.Generator | None, cfg: ModelConfig,
                     opt_cfg: adamw.AdamWConfig, step_cfg: StepConfig, device=None) -> dict:
    """The train state on `device` (None = the card; "meta" for shapes
    only), weights drawn from `generator` (`model.init_params`)."""
    params = M.init_params(cfg, device, generator)
    dev = params["final_norm"].device
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if step_cfg.compress_grads:
        state["err"] = compression.init_error(params)
    return state


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


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    step_cfg: StepConfig = StepConfig()) -> Callable:
    """(state, batch) -> (new state, metrics {"loss", "nll", "aux",
    "grad_norm", "lr"}, () tensors).

    The loss's gradient is taken on the compute copy (or, with
    `bf16_compute_copy=False`, on the float32 masters themselves) and
    lands in float32 on the masters.  With accumulation (`step_cfg.accum`
    if > 1, else `cfg.policy.accum`) the microbatches' gradients are
    summed in float32 and divided by their count; the metrics are the
    last microbatch's, as the reference's scan carries them out.  Then
    compression where asked, then `adamw.update`."""
    accum = step_cfg.accum if step_cfg.accum > 1 else max(cfg.policy.accum, 1)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        masters = tree.leaves(params)
        for p in masters:
            p.requires_grad_(True)
        try:
            for mb in _microbatches(batch, accum):
                used = M.compute_copy(params) if step_cfg.bf16_compute_copy else params
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


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(model, batch) -> (logits (B, V), caches, hidden (B, d)):
    `DecoderLM.prefill` without gradients.  `cfg` is not read."""

    def prefill_step(model: M.DecoderLM, batch: dict):
        with torch.no_grad():
            return model.prefill(batch)

    return prefill_step


def make_serve_step(cfg: ModelConfig, retrieval: tuple[int, int] | None = None) -> Callable:
    """One decode step: (model, caches, token, pos[, retrieved, ok]) ->
    (logits (B, V), caches, hidden (B, d)), the caches updated in place.
    retrieval=(m, local_window) takes the positions of the active-search
    retrieval memory (m a row) and attends to them and the local window.
    Only local_window is read; `cfg` and m mirror the reference."""

    def serve_step(model: M.DecoderLM, caches, token, pos, retrieved=None, retrieved_ok=None):
        with torch.no_grad():
            if retrieval is None:
                return model.decode_step(caches, token, pos)
            return model.decode_step(caches, token, pos,
                                     retrieved=(retrieved, retrieved_ok, retrieval[1]))

    return serve_step


def retrieval_query(model: M.DecoderLM, token: torch.Tensor) -> torch.Tensor:
    """The retrieval serve step's query (B, hd), float32: `token` (B,)
    embedded in bf16, layer 0's query projection (no norm, no RoPE) and its
    summary over the heads."""
    with torch.no_grad():
        x = model.embed[token.to(model.device)][:, None, :].to(torch.bfloat16)
        q0 = attn._project(x, model.layers[0].core["wq"])             # (B, 1, H, hd)
        return rmem.query_summary(q0[:, 0])


def retrieve(model: M.DecoderLM, index, token: torch.Tensor, pos,
             mem_cfg: rmem.RetrievalMemoryConfig):
    """The retrieval serve step's search: `retrieval_query` over the memory
    index on `mem_cfg.plan` for `mem_cfg.n_retrieved` positions ->
    (positions (B, m) int32, clamped at 0; ok (B, m): valid and before
    `pos`)."""
    searcher = ActiveSearcher.from_index(index, mem_cfg.grid, plan=mem_cfg.plan,
                                         device=index.device)
    res = searcher.search(retrieval_query(model, token), mem_cfg.n_retrieved)
    positions = torch.clamp_min(res.ids, 0)
    return positions, res.valid & (positions < int(pos))


def make_retrieval_serve_step(cfg: ModelConfig,
                              mem_cfg: rmem.RetrievalMemoryConfig | None = None) -> Callable:
    """The long-context serve step with the paper's active search inside:
    (model, caches, index, token, pos) -> (logits (B, V), caches, hidden
    (B, d)).  Each step searches the memory index of key summaries
    (`retrieve`: on `hopper`, one radius_search_loop and one
    csr_candidate_topk launch), then decodes attending only to the local
    window and the retrieved positions.  `cfg` is not read."""
    mem_cfg = mem_cfg or rmem.RetrievalMemoryConfig()

    def serve_step(model: M.DecoderLM, caches, index, token, pos):
        positions, ok = retrieve(model, index, token, pos, mem_cfg)
        with torch.no_grad():
            return model.decode_step(caches, token, pos,
                                     retrieved=(positions, ok, mem_cfg.local_window))

    return serve_step
