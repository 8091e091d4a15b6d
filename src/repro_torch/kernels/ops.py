"""Dispatch between each Hopper kernel and its plain PyTorch version.

A tensor on the CPU goes to the plain version (`ref.py`); a CUDA tensor
goes to the kernel, which launches or raises — there is no fallback from
the card to the plain version.  Port of `repro/kernels/ops.py`, whose
`interpret` switch has no counterpart here: the device decides.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import brute_knn as _bk
from repro_torch.kernels import candidate_topk as _ctk
from repro_torch.kernels import csr_candidate_topk as _csr
from repro_torch.kernels import csr_candidate_topk_q8 as _q8
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import radius_search_loop as _rsl
from repro_torch.kernels import ref
from repro_torch.kernels import tile_count as _tc
from repro_torch.kernels import tile_count_multilevel as _tcm


def tile_count(level_arr: torch.Tensor, queries, radii, scale, tile, metric="l2"):
    fn = _tc.tile_count if level_arr.is_cuda else ref.tile_count
    return fn(level_arr, queries, radii, scale, tile, metric=metric)


def tile_count_multilevel(
    tiles: torch.Tensor, queries, radii, levels, tile, nblks, metric="l2",
    active=None,
):
    fn = _tcm.tile_count_multilevel if tiles.is_cuda else ref.tile_count_multilevel
    return fn(tiles, queries, radii, levels, tile, nblks, metric=metric, active=active)


def radius_search_loop(
    tiles: torch.Tensor, queries, r0, k, k_hi, r_max, max_iters, tile, nblks, metric="l2",
    early_exit=True,
):
    """radius, count, iters and converged on either device (the plain
    version's own count of skipped tile loads is left out)."""
    if tiles.is_cuda:
        return _rsl.radius_search_loop(tiles, queries, r0, k, k_hi, r_max, max_iters, tile,
                                       nblks, metric=metric, early_exit=early_exit)
    out = ref.radius_search_loop(tiles, queries, r0, k, k_hi, r_max, max_iters, tile, nblks,
                                 metric=metric, early_exit=early_exit)
    return {key: out[key] for key in ("radius", "count", "iters", "converged")}


def csr_candidate_topk(
    store: torch.Tensor, starts, ends, queries, k, n, row_cap, metric="l2",
    radii=None, center_cells=False, d_chunk=None,
):
    fn = _csr.csr_candidate_topk if store.is_cuda else ref.csr_candidate_topk
    return fn(
        store, starts, ends, queries, k, n, row_cap, metric=metric,
        radii=radii, center_cells=center_cells, d_chunk=d_chunk,
    )


def candidate_topk(candidates: torch.Tensor, valid, queries, k, metric="l2", d_chunk=512):
    fn = _ctk.candidate_topk if candidates.is_cuda else ref.candidate_topk
    return fn(candidates, valid, queries, k, metric=metric, d_chunk=d_chunk)


def csr_shortlist_q8(
    q_store: torch.Tensor, row_scales, starts, ends, queries, rerank_k, n,
    row_cap, metric="l2", d_chunk=None,
):
    fn = _q8.csr_shortlist_q8 if q_store.is_cuda else ref.csr_shortlist_q8
    return fn(
        q_store, row_scales, starts, ends, queries, rerank_k, n, row_cap,
        metric=metric, d_chunk=d_chunk,
    )


def brute_knn(queries: torch.Tensor, points, k, block_q=128, block_n=512):
    """Exact l2 kNN (dists, ids).  The kernel tiles by its own fixed sizes,
    so `block_q` / `block_n` shape only the plain version, whose N-block is
    `block_n` (it holds (B, block_n + k) at a time)."""
    if queries.is_cuda:
        return _bk.brute_knn(queries, points, k)
    return ref.brute_knn(queries, points, k, block=block_n)


def flash_attention(q: torch.Tensor, k, v, causal=True, block_q=512, block_k=512):
    """Attention (B, S, H, hd) in q's dtype.  Raises, as the reference
    does, when a sequence does not divide its block; the kernel itself
    tiles by its own fixed sizes."""
    _fa.check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    fn = _fa.flash_attention if q.is_cuda else ref.flash_attention
    return fn(q, k, v, causal=causal)
