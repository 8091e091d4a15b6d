"""Hopper kernel: int8 CSR candidate scoring -> top-`rerank_k` shortlist.

Wrapper of `csrc/csr_candidate_topk_q8.cu`, the port of the TPU kernel
`repro/kernels/csr_candidate_topk_q8.py::csr_shortlist_q8`: the coarse half
of `hopper_q8`, reading the int8 store (`core/quantized.py`) at d + 4 bytes
per row instead of 4*d.  The plain version is `ref.csr_shortlist_q8`
(equal bit for bit: the scoring is integer); `ops.csr_shortlist_q8` picks
between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.candidate_topk import TOPK_CHUNK, TOPK_SHARED_BYTES
from repro_torch.kernels.ref import check_q8_args, q8_d_chunks

SOURCE = "csr_candidate_topk_q8"
launches = 0              # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).csr_shortlist_q8_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(d: int, w: int, row_cap: int) -> int:
    """Shared memory of one block: the float query, a chunk of staged
    scores, and the top-k's buffer and list.  It does not grow with the
    window (w, row_cap)."""
    del w, row_cap
    return 4 * d + 4 * TOPK_CHUNK + TOPK_SHARED_BYTES


def csr_shortlist_q8(
    q_store: torch.Tensor,     # (n_pad, d) int8 — quantized CSR store
    row_scales: torch.Tensor,  # (n_pad, 1) float32 — per-row cell scales
    starts: torch.Tensor,      # (B, w) int32 — window-row span starts
    ends: torch.Tensor,        # (B, w) int32 — window-row span ends
    queries: torch.Tensor,     # (B, d) float32
    rerank_k: int,
    n: int,                    # live CSR rows (store rows >= n are padding)
    row_cap: int,
    metric: str = "l2",
    d_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores (B, rerank_k) float32 with +inf pads, idx (B, rerank_k)
    int32 GLOBAL CSR rows with -1 pads), best-first, from the CUDA kernel.
    CUDA tensors only."""
    global launches
    check_q8_args(q_store, row_scales, starts, ends, queries, rerank_k, row_cap)
    dev = q_store.device
    if dev.type != "cuda":
        raise ValueError(f"the csr_shortlist_q8 kernel takes CUDA tensors, got {dev}")
    n_pad, d = q_store.shape
    b, w = starts.shape
    _build.check_tensor(q_store, "q_store", torch.int8, (n_pad, d), dev)
    _build.check_tensor(row_scales, "row_scales", torch.float32, (n_pad, 1), dev)
    _build.check_tensor(starts, "starts", torch.int32, (b, w), dev)
    _build.check_tensor(ends, "ends", torch.int32, (b, w), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, d), dev)
    out_d = torch.empty((b, rerank_k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, rerank_k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    dc = q8_d_chunks(d, d_chunk)[0][1]  # the plain version's chunk width
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            q_store.data_ptr(), row_scales.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), queries.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), b, w, row_cap, d, n_pad, n, rerank_k, dc,
            int(metric == "l1"), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return out_d, out_i
