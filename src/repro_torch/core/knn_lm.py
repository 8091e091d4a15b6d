"""kNN-LM head: the paper's retrieval primitive as a production LM feature.

Port of `repro/core/knn_lm.py`.  Khandelwal-style kNN-LM: a datastore maps
hidden states h_t -> next token y_{t+1}.  At serve time the LM distribution
is interpolated with a kNN distribution obtained by active search over the
datastore:

    p(y) = lam * p_knn(y) + (1 - lam) * p_lm(y)
    p_knn(y)  propto  sum_{(h_i, y_i) in topk(h)} 1[y_i = y] * exp(-d(h, h_i) / T)

The datastore rides in GridIndex.labels_sorted (token ids are per-point
payloads, NOT class channels — the grid itself stays single-channel, so
vocab size never touches grid memory).  The search goes through the facade
on the config's plan (`hopper` by default, on the index's device); the
softmax and the scatter into the vocabulary are plain tensor code, as the
reference's are plain JAX.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import mutable as mut
from repro_torch.core.active_search import SearchResult
from repro_torch.core.engine import ActiveSearcher, ExecutionPlan
from repro_torch.core.grid import GridConfig, GridIndex, as_tensor, build_index
from repro_torch.core.projection import Projection, pca_projection


@dataclasses.dataclass(frozen=True)
class KNNLMConfig:
    k: int = 16
    lam: float = 0.25        # interpolation weight on the kNN distribution
    temperature: float = 1.0  # distance softmax temperature
    # HOW datastore searches execute (backend, chunked streaming)
    plan: ExecutionPlan = ExecutionPlan()
    grid: GridConfig = dataclasses.field(
        default_factory=lambda: GridConfig(
            grid_size=1024, tile=16, window=32, row_cap=32, r0=8, k_slack=4.0
        )
    )


def build_datastore(
    keys: torch.Tensor, next_tokens: torch.Tensor, cfg: KNNLMConfig,
    proj: Projection | None = None,
) -> GridIndex:
    """keys: (N, d) hidden states; next_tokens: (N,) int32 payload tokens;
    built on the keys' device."""
    if proj is None:
        proj = pca_projection(keys, grid_dim=2)
    return build_index(keys, cfg.grid, proj.to(keys.device),
                       labels=next_tokens.to(device=keys.device, dtype=torch.int32))


def extend_datastore(
    index: GridIndex, cfg: KNNLMConfig, keys, next_tokens
) -> GridIndex:
    """Grow the datastore ONLINE with fresh (hidden, next-token) pairs.

    The new keys are projected with the datastore's EXISTING projection
    (no PCA re-fit — keys far outside the fitted extents clamp to the grid
    edge, which active search tolerates) and delta-applied via
    `core.mutable` instead of rebuilding the index.

    This one-shot helper re-opens the slack layout each call; a caller that
    grows REPEATEDLY should hold the state across batches instead (an
    `ActiveSearcher` handle via `.insert`, or a `core.mutable.MutableIndex`
    directly)."""
    state = mut.from_index(index, cfg.grid)
    state = mut.insert(state, cfg.grid, keys,
                       labels=as_tensor(next_tokens, torch.int32, index.device))
    return mut.snapshot(state, cfg.grid)


def logprobs_from_result(res: SearchResult, cfg: KNNLMConfig, vocab_size: int) -> torch.Tensor:
    """log p_knn over the vocab from a datastore search's (B, k) result ->
    (B, vocab): the softmax of -dist / T over the valid neighbours,
    scatter-added onto their tokens."""
    temp = torch.full((), cfg.temperature, dtype=torch.float32, device=res.dists.device)
    w = torch.where(res.valid, -res.dists / temp, torch.full_like(res.dists, -math.inf))
    w = torch.softmax(w, dim=-1)                      # (B, k)
    w = torch.where(res.valid, w, torch.zeros_like(w))
    tok = torch.clamp(res.labels, 0, vocab_size - 1).long()
    p = torch.zeros((w.shape[0], vocab_size), dtype=torch.float32, device=w.device)
    p = p.scatter_add(1, tok, w)                      # (B, vocab)
    # A query can retrieve NOTHING (sparse datastore, empty candidate
    # window): softmax over all -inf is nan and the scatter leaves p == 0.
    # No evidence -> the uninformative distribution, so p_knn stays a
    # normalized distribution for every lane and interpolation stays finite.
    any_valid = res.valid.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, p, torch.full_like(p, 1.0 / vocab_size))
    return torch.log(torch.clamp_min(p, 1e-20))


def knn_logprobs(
    index: GridIndex, cfg: KNNLMConfig, hidden, vocab_size: int
) -> torch.Tensor:
    """log p_knn over the vocab.  hidden: (B, d) -> (B, vocab), on the
    index's device."""
    searcher = ActiveSearcher.from_index(index, cfg.grid, plan=cfg.plan, device=index.device)
    res = searcher.search(hidden, cfg.k, mode="refined")
    return logprobs_from_result(res, cfg, vocab_size)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """log_softmax over the last axis in x's own dtype, rounded where
    `jax.nn.log_softmax` rounds: the shift, exp and log each in x's dtype,
    the sum in float32.  For bf16 logits one fused `torch.log_softmax`
    rounds once instead, and so differs from the reference on many
    entries by a bf16 ulp or more."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    total = torch.exp(shifted).sum(dim=-1, keepdim=True, dtype=torch.float32)
    return shifted - torch.log(total.to(x.dtype))


def interpolate(lm_logits: torch.Tensor, knn_logp: torch.Tensor, cfg: KNNLMConfig) -> torch.Tensor:
    """log( lam * p_knn + (1-lam) * p_lm ), numerically via logaddexp.

    As in the reference, log p_lm stays in the logits' dtype (bf16 for the
    model's logits) until logaddexp promotes it to float32, and log(1 - lam)
    is rounded to that dtype before it is added."""
    lm_logp = log_softmax(lm_logits)
    f32 = dict(dtype=torch.float32, device=knn_logp.device)
    log_lam = torch.log(torch.full((), cfg.lam, **f32))
    log_rest = torch.log1p(torch.full((), -cfg.lam, **f32)).to(lm_logp.dtype)
    return torch.logaddexp(log_lam + knn_logp, (log_rest + lm_logp).to(torch.float32))


def knn_lm_logits(
    index: GridIndex, cfg: KNNLMConfig, hidden, lm_logits: torch.Tensor
) -> torch.Tensor:
    """One-call API: interpolated log-probabilities (B, vocab)."""
    knn_lp = knn_logprobs(index, cfg, hidden, lm_logits.shape[-1])
    return interpolate(lm_logits, knn_lp, cfg)
