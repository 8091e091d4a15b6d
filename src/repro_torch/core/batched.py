"""Batched, kernel-backed active search — the `hopper*` execution paths.

Port of `repro/core/batched.py`.  The whole batch moves through the
paper's algorithm together on hand-written Hopper kernels (CPU tensors
take their plain versions, `kernels/ops.py`):

  1. Eq.-1 radius adaptation for the whole batch: ONE `radius_search_loop`
     launch runs every query's loop and recount on the card, each count at
     the query's own pyramid level; `tile_count_multilevel` counts at given
     radii in one launch (count_at, classify), and `batched_counts_stacked`
     keeps the per-level `tile_count` stack as the `hopper_stacked`
     baseline;
  2. the candidate stage as a pluggable `CandidatePipeline`:
       "fused"  (default) — `csr_candidate_topk` reads candidate rows
                straight from the CSR-sorted store and emits (dists, GLOBAL
                CSR rows), so record assembly is one (B, k) gather per field;
       "gather" — one (B, w*row_cap) gather of the window's records, then
                the dense `candidate_topk` (`hopper_gather`: benchmark
                baseline and second oracle, bit-equal to "fused");
  3. the quantized stage (`search_q8` / `classify_q8`, `hopper_q8`): the
     int8 `csr_shortlist_q8` keeps the best `rerank_k` rows by approximate
     score, and `candidate_topk` re-ranks them exactly in float32.

`search`/`classify` take `chunk_size=` to stream large batches through
fixed-size launches; results are bit-identical for any value.  Reach these
paths through `repro_torch.api.ActiveSearcher` with
`ExecutionPlan(backend="hopper" | "hopper_gather" | "hopper_q8")`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.core import integral as integral_lib
from repro_torch.core import projection as proj_lib
from repro_torch.core import pyramid as pyr
from repro_torch.core.active_search import (
    SearchResult,
    _metric_dist,
    empty_result,
    gather_candidates,
    majority_vote,
    padded_csr,
    run_chunked,
    window_spans,
)
from repro_torch.core.grid import GridConfig, GridIndex
from repro_torch.kernels import ops
from repro_torch.kernels.ref import take_slots, window_slots
from repro_torch.utils.spans import span


# --------------------------------------------------------------- counting ----


def _pyr_tiles(index: GridIndex) -> torch.Tensor:
    if index.pyr_tiles is None:
        raise ValueError(
            "GridIndex.pyr_tiles is missing (pre-layout index): the count "
            "path needs the pyramid pre-cut into T-tiles.  Wrap the index "
            "once via repro_torch.api.ActiveSearcher.from_index(index, cfg)."
        )
    return index.pyr_tiles


def batched_counts(
    index: GridIndex,
    cfg: GridConfig,
    q_grid: torch.Tensor,
    radii: torch.Tensor,
) -> torch.Tensor:
    """Per-class circle counts (B, C) int32 for a batch of queries and
    integer radii.

    Pyramid counter: ONE `tile_count_multilevel` launch; each query is
    counted at its `level_for_radius` level (count_at, classify).  The sat
    counter reads four cells of the integral image per query."""
    if cfg.counter == "sat":
        return integral_lib.count_linf(index.sat, q_grid, radii)
    levels = pyr.level_for_radius(radii, cfg)
    return ops.tile_count_multilevel(
        _pyr_tiles(index), q_grid.contiguous(), radii.to(torch.float32), levels, cfg.tile,
        cfg.level_nblks, metric=cfg.metric,
    )


def batched_counts_stacked(
    index: GridIndex,
    cfg: GridConfig,
    q_grid: torch.Tensor,
    radii: torch.Tensor,
) -> torch.Tensor:
    """The per-level counting path: `tile_count` on EVERY pyramid level
    (one launch each), then each query's own level selected from the
    (L, B, C) stack.  L-fold more kernel work than `batched_counts`; kept
    as the `hopper_stacked` benchmark baseline and as a second oracle for
    the level-scheduled kernel."""
    if cfg.counter == "sat":
        return batched_counts(index, cfg, q_grid, radii)
    levels = pyr.level_for_radius(radii, cfg)
    q, r = q_grid.contiguous(), radii.to(torch.float32)
    per_level = torch.stack([
        ops.tile_count(arr, q, r, 1 << lv, cfg.tile, metric=cfg.metric)
        for lv, arr in enumerate(index.pyramid)
    ])                                                      # (L, B, C)
    return torch.take_along_dim(per_level, levels.long()[None, :, None], dim=0)[0]


def lockstep_radius_loop(count, r0: torch.Tensor, k: int, k_hi: int, r_max: int,
                         max_iters: int, masked: bool) -> dict:
    """Eq. 1 for a whole batch in lock step, one count pass per iteration.

    `count(radii, active)` gives each lane's total count (B,) int32 at its
    integer radius; `active` is the live-lane mask when `masked`, else
    None.  Finished lanes freeze while the rest iterate; the loop asks the
    device once per pass whether a lane is still live.  A lane that hits
    keeps its in-loop count; the others are counted once more at their
    final radius (only they when `masked`, every lane otherwise).  The sat
    counter's host loop and the pyramid counter's plain version
    (`ref.radius_search_loop`) run it."""
    b = r0.shape[0]
    dev = r0.device
    i32 = dict(dtype=torch.int32, device=dev)
    r = r0.to(torch.int32)
    t = torch.zeros((b,), **i32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best = torch.full((b,), r_max + 1, **i32)
    n_hit = torch.zeros((b,), **i32)

    while True:
        active = (t < max_iters) & ~done
        if not bool(active.any()):
            break
        n = count(r, active if masked else None)  # parked lanes are frozen below
        hit = (n >= k) & (n <= k_hi)
        best_new = torch.where(n >= k, torch.minimum(best, r), best)
        r_new = torch.round(r.to(torch.float32) * pyr.eq1_ratio(k, n)).to(torch.int32)
        r_new = torch.where(n == 0, r * 2, r_new)
        r_new = torch.clamp(r_new, 1, r_max)
        step = torch.where(n < k, 1, -1).to(torch.int32)
        r_new = torch.where((r_new == r) & ~hit, r + step, r_new)
        r_next = torch.where(hit, r, torch.clamp(r_new, 1, r_max))
        t = torch.where(active, t + 1, t)
        r = torch.where(active, r_next, r)
        # a lane that hits at radius r keeps r as its final radius, so the
        # in-loop count IS the final count — capture it here
        n_hit = torch.where(active & hit, n, n_hit)
        done = torch.where(active, hit, done)
        best = torch.where(active, best_new, best)

    converged = done
    r_final = torch.where(
        converged, r, torch.where(best <= r_max, best, torch.full_like(best, r_max))
    )
    if masked:
        n_final = torch.where(converged, n_hit, count(r_final, ~converged))
    else:
        n_final = count(r_final, None)
    return {
        "radius": r_final,
        "count": n_final,
        "iters": t,
        "converged": converged,
    }


def radius_search_batched(
    index: GridIndex,
    cfg: GridConfig,
    q_grid: torch.Tensor,
    k: int,
    adaptive_r0: bool = False,
    early_exit: bool = True,
) -> dict[str, torch.Tensor]:
    """Eq. 1 for a whole batch: radius, count, iters, converged (B,), lane
    for lane the reference's.  The reference's count of the 2x2-cover
    tile loads its TPU kernel elides follows from iters and converged
    alone: `kernels.ref.dmas_skipped`.

    Pyramid counter: ONE `ops.radius_search_loop` call.  On the card that
    is one launch that runs every lane's loop and recount, with no host
    read; on the CPU the plain lock-step loop, where each pass counts the
    live lanes and finished lanes freeze.

    early_exit=False is the reference's unmasked schedule (every lane
    counted every pass and recounted at the end): the same radius, count,
    iters and converged.  On the card it runs the same kernel.

    The sat counter keeps the lock-step loop on the host (an O(1)
    integral-image lookup, no tiles to skip; one sync per pass).

    adaptive_r0=True seeds each lane's start radius from the pyramid's top
    levels (`pyramid.seed_radius`) instead of the global cfg.r0.
    """
    b = q_grid.shape[0]
    k_hi = max(k, math.ceil(k * cfg.k_slack))
    if adaptive_r0:
        r0 = pyr.seed_radius(index, cfg, q_grid, k)
    else:
        r0 = torch.full((b,), cfg.r0, dtype=torch.int32, device=q_grid.device)
    if cfg.counter == "sat":
        return lockstep_radius_loop(
            lambda r, _active: integral_lib.count_linf(index.sat, q_grid, r).sum(
                dim=-1, dtype=torch.int32),
            r0, k, k_hi, cfg.max_radius, cfg.max_iters, masked=False,
        )
    return ops.radius_search_loop(
        _pyr_tiles(index), q_grid.contiguous(), r0, k, k_hi, cfg.max_radius, cfg.max_iters,
        cfg.tile, cfg.level_nblks, metric=cfg.metric, early_exit=early_exit,
    )


# ----------------------------------------------------------------- gather ----


# -------------------------------------------------------- candidate stage ----


@dataclasses.dataclass(frozen=True)
class CandidatePipeline:
    """One pluggable candidate stage: spans in, ranked global rows out.

    select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk)
        -> (dists (B, k) float32 with +inf pads,
            gidx  (B, k) int32 GLOBAL CSR rows with -1 pads)

    Every pipeline implements the same masking and tie-break contract
    (clamped span starts, row-major candidate order, first-index ties).
    """

    name: str
    select: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    description: str = ""


_CANDIDATE_PIPELINES: dict[str, CandidatePipeline] = {}


def register_candidate_pipeline(pipeline: CandidatePipeline) -> None:
    """Register (or replace) a candidate-stage pipeline under its name."""
    _CANDIDATE_PIPELINES[pipeline.name] = pipeline


def get_candidate_pipeline(name: str) -> CandidatePipeline:
    try:
        return _CANDIDATE_PIPELINES[name]
    except KeyError:
        raise ValueError(
            f"unknown candidate pipeline {name!r}; registered: "
            f"{sorted(_CANDIDATE_PIPELINES)}"
        ) from None


def registered_candidate_pipelines() -> tuple[str, ...]:
    return tuple(sorted(_CANDIDATE_PIPELINES))


def _fused_select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk):
    """csr_candidate_topk: candidate rows read straight from the CSR store;
    the stage writes only the (B, k) result pair."""
    pts, crd, _lab, _ids, n, _n_pad = padded_csr(index, cfg.row_cap)
    start, end = spans
    if mode == "paper":
        return ops.csr_candidate_topk(
            crd, start, end, q_grid.contiguous(), k, n, cfg.row_cap,
            metric=cfg.metric, radii=radius.to(torch.float32),
            center_cells=True, d_chunk=d_chunk,
        )
    return ops.csr_candidate_topk(
        pts, start, end, queries.to(torch.float32).contiguous(), k, n,
        cfg.row_cap, metric=cfg.metric, d_chunk=d_chunk,
    )


def _gather_select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk):
    """gather_candidates + dense candidate_topk, with the selected
    LOCAL slots mapped back to global CSR rows so both pipelines share one
    record-assembly step."""
    cand = gather_candidates(index, cfg, q_grid, spans=spans)
    if mode == "paper":
        centers = torch.floor(cand.coords) + 0.5                    # (B, C, 2)
        gd = _metric_dist(centers, q_grid[:, None, :], cfg.metric)
        valid = cand.valid & (gd <= radius[:, None].to(torch.float32))
        rank_points, rank_queries = centers, q_grid
    else:
        valid = cand.valid
        rank_points, rank_queries = cand.points, queries.to(torch.float32)
    # the fused kernel's d_chunk decomposition (None: one block), so both
    # pipelines give the same float for the same row
    outd, outi = ops.candidate_topk(
        rank_points.contiguous(), valid, rank_queries.contiguous(), k,
        metric=cfg.metric, d_chunk=d_chunk,
    )
    _pts, _crd, _lab, _ids, n, n_pad = padded_csr(index, cfg.row_cap)
    flat, _valid = window_slots(spans[0], spans[1], n_pad, n, cfg.row_cap)
    return outd, take_slots(flat, outi)


register_candidate_pipeline(CandidatePipeline(
    name="fused",
    select=_fused_select,
    description="csr_candidate_topk: candidate rows read from the CSR store "
                "inside the kernel, no (B, w*row_cap, d) intermediate",
))
register_candidate_pipeline(CandidatePipeline(
    name="gather",
    select=_gather_select,
    description="one (B, w*row_cap) gather of the window's records + dense "
                "candidate_topk (benchmark baseline / second oracle)",
))


# ---------------------------------------------------- quantized (q8) stage ---


def q8_shortlist(
    index: GridIndex,
    store,  # QuantizedStore
    cfg: GridConfig,
    queries: torch.Tensor,
    rerank_k: int,
    spans: tuple[torch.Tensor, torch.Tensor] | None = None,
    d_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The coarse int8 stage alone: approximate scores + global CSR
    shortlist (B, rerank_k).  `search_q8` is the full coarse -> re-rank
    path; this is exposed for the tests and chip_smoke's containment
    count."""
    if spans is None:
        q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)
        spans = window_spans(index, cfg, q_grid)
    start, end = spans
    return ops.csr_shortlist_q8(
        store.q_points, store.row_scales, start, end,
        queries.to(torch.float32).contiguous(), rerank_k,
        index.points_sorted.shape[0], cfg.row_cap, metric=cfg.metric,
        d_chunk=d_chunk,
    )


def _q8_select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk,
               *, store, rerank_k):
    """int8 coarse shortlist -> exact float32 re-rank of `rerank_k` rows.

    Not a registered CandidatePipeline: pipelines promise bit-equal
    interchange, the q8 stage promises recall.  Paper mode delegates to the
    fused stage (it ranks 2-d cell centers; nothing to gain from int8).

    The shortlist is sorted ascending by global CSR row (stable, -1 pads
    last) before the re-rank, so `candidate_topk`'s first-index tie-break
    means lowest global row: the fused kernel's tie-break, since its window
    enumerates valid rows in ascending CSR order.  With the same d_chunk
    decomposition both compute the same distance, so wherever the shortlist
    contains the exact top-k the result equals `hopper` bit for bit."""
    if mode == "paper":
        return _fused_select(index, cfg, q_grid, queries, spans, k, mode, radius, d_chunk)
    pts, _crd, _lab, _ids, _n, n_pad = padded_csr(index, cfg.row_cap)
    _scores, sli = q8_shortlist(index, store, cfg, queries, rerank_k,
                                spans=spans, d_chunk=d_chunk)
    # approximate scores only chose the shortlist; the re-rank is exact
    key = torch.where(sli >= 0, sli, torch.full_like(sli, n_pad))
    sl = torch.gather(sli, 1, torch.sort(key, dim=1, stable=True).indices)
    cand = pts[torch.clamp_min(sl, 0).long()]               # (B, rerank_k, d)
    outd, outi = ops.candidate_topk(
        cand, sl >= 0, queries.to(torch.float32).contiguous(), k,
        metric=cfg.metric, d_chunk=d_chunk,
    )
    return outd, take_slots(sl, outi)


def resolve_rerank_k(cfg: GridConfig, k: int, rerank_k: int | None) -> int:
    """The shortlist length the q8 path runs with.

    None -> min(max(4k, 32), window*row_cap); explicit values must be >= k
    (a shortlist shorter than k cannot return k exact rows) and are capped
    at the window."""
    cap = cfg.window * cfg.row_cap
    if rerank_k is None:
        return min(max(4 * k, 32), cap)
    if rerank_k < k:
        raise ValueError(
            f"rerank_k={rerank_k} < k={k}: the exact re-rank can only "
            f"return rows the shortlist contains"
        )
    return min(rerank_k, cap)


# -------------------------------------------------------------- entry points -


def _search_impl(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str,
    select: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    d_chunk: int | None,
    adaptive_r0: bool,
) -> SearchResult:
    with span("asnn.project"):
        q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)  # (B, 2)
    with span("asnn.loop"):
        stats = radius_search_batched(index, cfg, q_grid, k, adaptive_r0=adaptive_r0)
    r = stats["radius"]
    with span("asnn.windows"):
        start, end = window_spans(index, cfg, q_grid)               # (B, w)
        truncated = ((2 * r + 1) > cfg.window) | torch.any(end - start > cfg.row_cap, dim=-1)

    with span("asnn.select"):
        outd, outi = select(index, cfg, q_grid, queries, (start, end), k, mode, r, d_chunk)

    # record assembly: one (B, k) gather per field from the padded CSR arrays
    with span("asnn.assemble"):
        _pts, _crd, lab, ids, _n, _n_pad = padded_csr(index, cfg.row_cap)
        sel_valid = torch.isfinite(outd)
        idx = torch.clamp_min(outi, 0).long()
        none = torch.full_like(outi, -1)
        return SearchResult(
            ids=torch.where(sel_valid, ids[idx], none),
            dists=outd,
            labels=torch.where(sel_valid, lab[idx], none),
            valid=sel_valid,
            radius=stats["radius"],
            count=stats["count"],
            iters=stats["iters"],
            converged=stats["converged"],
            truncated=truncated,
        )


def search(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    chunk_size: int | None = None,
    pipeline: str = "fused",
    d_chunk: int | None = None,
    adaptive_r0: bool = False,
) -> SearchResult:
    """Batched kernel-backed active search: queries (B, d) -> SearchResult
    with leading B (the facade's `ActiveSearcher.search` contract)."""
    pipe = get_candidate_pipeline(pipeline)  # eager: bad names raise here
    return run_chunked(
        lambda q: _search_impl(index, cfg, q, k, mode, pipe.select, d_chunk, adaptive_r0),
        queries,
        chunk_size,
        empty=lambda: empty_result(k, queries.device),
    )


def _classify_impl(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str,
    select: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    d_chunk: int | None,
    adaptive_r0: bool,
) -> torch.Tensor:
    q_grid = proj_lib.to_grid_coords(index.proj, queries, cfg.grid_size)

    if mode == "paper":
        stats = radius_search_batched(index, cfg, q_grid, k, adaptive_r0=adaptive_r0)
        counts = batched_counts(index, cfg, q_grid, stats["radius"])
        return torch.argmax(counts, dim=-1).to(torch.int32)

    res = _search_impl(index, cfg, queries, k, "refined", select, d_chunk, adaptive_r0)
    refined = majority_vote(res.labels, res.valid, cfg.n_classes)
    # graceful degradation: where the window vote is under-sampled (fewer
    # than k valid candidates, or candidates were dropped), fall back to the
    # count argmax at the final radius
    fallback = torch.argmax(
        batched_counts(index, cfg, q_grid, res.radius), dim=-1
    ).to(torch.int32)
    short = res.valid.sum(dim=1) < k
    return torch.where(short | res.truncated, fallback, refined)


def classify(
    index: GridIndex,
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    chunk_size: int | None = None,
    pipeline: str = "fused",
    d_chunk: int | None = None,
    adaptive_r0: bool = False,
) -> torch.Tensor:
    """Batched kNN classification (B,) int32: the Eq.-1 loop on the
    radius_search_loop kernel, the final-radius counts on
    tile_count_multilevel."""
    if cfg.n_classes <= 0:
        raise ValueError("classify() needs an index built with n_classes > 0")
    pipe = get_candidate_pipeline(pipeline)  # eager: bad names raise here
    return run_chunked(
        lambda q: _classify_impl(index, cfg, q, k, mode, pipe.select, d_chunk, adaptive_r0),
        queries,
        chunk_size,
        empty=lambda: torch.zeros((0,), dtype=torch.int32, device=queries.device),
    )


def search_q8(
    index: GridIndex,
    store,  # QuantizedStore (core.quantized.quantize_index(index, cfg))
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    rerank_k: int | None = None,
    chunk_size: int | None = None,
    d_chunk: int | None = None,
    adaptive_r0: bool = False,
) -> SearchResult:
    """Quantized-candidate active search (the `hopper_q8` backend): the
    counting and span stages of `search`, then the int8 shortlist and its
    exact float32 re-rank.  Returned distances are exact; only WHICH rows
    made the shortlist is approximate (a recall contract).  Paper mode is
    exact (it delegates to the fused stage)."""
    select = functools.partial(_q8_select, store=store,
                               rerank_k=resolve_rerank_k(cfg, k, rerank_k))
    return run_chunked(
        lambda q: _search_impl(index, cfg, q, k, mode, select, d_chunk, adaptive_r0),
        queries,
        chunk_size,
        empty=lambda: empty_result(k, queries.device),
    )


def classify_q8(
    index: GridIndex,
    store,  # QuantizedStore
    cfg: GridConfig,
    queries: torch.Tensor,
    k: int,
    mode: str = "refined",
    rerank_k: int | None = None,
    chunk_size: int | None = None,
    d_chunk: int | None = None,
    adaptive_r0: bool = False,
) -> torch.Tensor:
    """Quantized-candidate kNN classification (the `hopper_q8` backend):
    `classify`'s contract with `search_q8` as the refined-vote stage."""
    if cfg.n_classes <= 0:
        raise ValueError("classify() needs an index built with n_classes > 0")
    select = functools.partial(_q8_select, store=store,
                               rerank_k=resolve_rerank_k(cfg, k, rerank_k))
    return run_chunked(
        lambda q: _classify_impl(index, cfg, q, k, mode, select, d_chunk, adaptive_r0),
        queries,
        chunk_size,
        empty=lambda: torch.zeros((0,), dtype=torch.int32, device=queries.device),
    )
