"""Retrieval-augmented attention memory — beyond-paper long-context feature.

Port of `repro/core/retrieval_memory.py`.  Memorizing-Transformers-style:
at decode time a token attends to (a) a local window of recent KV entries
and (b) the top-m PAST positions retrieved by active search over a grid
index built on per-token key summaries.  Per-step cost is
O(local_window + m) instead of O(S): the paper's N-independent search is
what makes 500k-token decode sub-quadratic for attention models.

The index key for a token is a summary of its attention keys (mean over KV
heads), projected to grid space; the query summary is the mean over query
heads.  Retrieval returns POSITIONS; the attention layer gathers their K/V.
Searches go through the facade on the config's plan (`hopper` by default),
on the index's device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mutable as mut
from repro_torch.core.engine import ActiveSearcher, ExecutionPlan
from repro_torch.core.grid import GridConfig, GridIndex, build_index
from repro_torch.core.projection import Projection


@dataclasses.dataclass(frozen=True)
class RetrievalMemoryConfig:
    n_retrieved: int = 64     # m: positions fetched per decode step
    local_window: int = 512   # recent tokens attended exactly
    plan: ExecutionPlan = ExecutionPlan()  # HOW retrieval searches execute
    grid: GridConfig = dataclasses.field(
        default_factory=lambda: GridConfig(
            grid_size=2048, tile=16, window=32, row_cap=64, r0=8, k_slack=4.0,
            max_iters=12,
        )
    )


def key_summary(k_heads: torch.Tensor) -> torch.Tensor:
    """(S, n_kv, hd) -> (S, hd): the per-token index key."""
    return k_heads.to(torch.float32).mean(dim=-2)


def query_summary(q_heads: torch.Tensor) -> torch.Tensor:
    """(B, n_q, hd) -> (B, hd)."""
    return q_heads.to(torch.float32).mean(dim=-2)


def make_projection(generator: torch.Generator, head_dim: int) -> Projection:
    """Fixed random projection shared by keys and queries (data-independent,
    so the index can be extended without re-fitting extents), drawn from
    `generator` on its device.  The reference draws from a JAX PRNG key,
    which no torch generator reproduces: carry its matrix across with
    `convert.projection_from_numpy` where the two must agree."""
    dev = generator.device
    mat = torch.randn((head_dim, 2), generator=generator, dtype=torch.float32, device=dev)
    mat = mat / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32, device=dev))
    # attention keys are RMS-normed activations: |summary| is O(1); generous extents
    lo = torch.full((2,), -4.0, dtype=torch.float32, device=dev)
    hi = torch.full((2,), 4.0, dtype=torch.float32, device=dev)
    return Projection(mat, lo, hi)


def build_memory_index(
    keys: torch.Tensor, cfg: RetrievalMemoryConfig, proj: Projection
) -> GridIndex:
    """keys: (S, hd) per-token key summaries.  ids_sorted are positions."""
    return build_index(keys.to(torch.float32), cfg.grid, proj.to(keys.device))


def extend_memory_index(
    index: GridIndex, cfg: RetrievalMemoryConfig, new_keys
) -> GridIndex:
    """Append (key, position) pairs ONLINE — the streaming-decode path.

    Positions continue from the current end of the memory (ids are the
    global point ids, which this module uses as token positions), and the
    grid/pyramid are delta-updated via `core.mutable` instead of rebuilt —
    `make_projection` is data-independent precisely so extents never need
    re-fitting.  Bit-identical to `build_memory_index` over the
    concatenated keys.

    One-shot helper: re-opens the slack layout each call.  A decode loop
    appending every step should hold the `core.mutable.MutableIndex` (or an
    `ActiveSearcher` via `.insert`) across steps to reuse free slots."""
    state = mut.from_index(index, cfg.grid)
    return mut.snapshot(mut.insert(state, cfg.grid, new_keys), cfg.grid)


def retrieve_positions(
    index: GridIndex, cfg: RetrievalMemoryConfig, q_sum
) -> tuple[torch.Tensor, torch.Tensor]:
    """q_sum: (B, hd) -> positions (B, m) int32 and validity (B, m) bool."""
    searcher = ActiveSearcher.from_index(index, cfg.grid, plan=cfg.plan, device=index.device)
    res = searcher.search(q_sum, cfg.n_retrieved, mode="refined")
    return torch.clamp_min(res.ids, 0), res.valid
