"""Hopper kernel: fused CSR gather -> distance -> top-k.

Wrapper of `csrc/csr_candidate_topk.cu`, the port of the TPU kernel
`repro/kernels/csr_candidate_topk.py::csr_candidate_topk`.  Each query's
candidate rows are read straight from the CSR-sorted store; the only
device-memory output is the (B, k) result pair.  The plain version is
`ref.csr_candidate_topk`; `ops.csr_candidate_topk` picks between them by
device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.candidate_topk import (
    TILE_DIMS, TILE_ROWS, TOPK_CHUNK, TOPK_SHARED_BYTES, staged_bytes,
)
from repro_torch.kernels.ref import check_csr_args

SOURCE = "csr_candidate_topk"
launches = 0              # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).csr_candidate_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(d: int, w: int, row_cap: int) -> int:
    """Shared memory of one block: at d >= TILE_DIMS the ring of staged
    tiles (rows of TILE_DIMS + 4 floats) and their row numbers, below it a
    chunk of staged distances; the query, and the top-k's buffer and list.
    It does not grow with the window (w, row_cap)."""
    del w, row_cap
    staged = staged_bytes(TILE_ROWS) if d >= TILE_DIMS else 4 * TOPK_CHUNK
    return staged + 4 * d + TOPK_SHARED_BYTES


def csr_candidate_topk(
    store: torch.Tensor,    # (n_pad, d) float32 — CSR-sorted ranking vectors
    starts: torch.Tensor,   # (B, w) int32 — window-row span starts
    ends: torch.Tensor,     # (B, w) int32 — window-row span ends
    queries: torch.Tensor,  # (B, d) float32 — per-query ranking vectors
    k: int,
    n: int,                 # live CSR rows (store rows >= n are padding)
    row_cap: int,
    metric: str = "l2",
    radii: torch.Tensor | None = None,  # (B,) float32 — paper-mode circle mask
    center_cells: bool = False,         # rank floor(store)+0.5 cell centers
    d_chunk: int | None = None,         # split the d-accumulation (None = one sum)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (B, k) float32 with +inf pads, idx (B, k) int32 GLOBAL CSR
    rows with -1 pads) from the CUDA kernel.  CUDA tensors only."""
    global launches
    check_csr_args(store, starts, ends, queries, row_cap, radii)
    dev = store.device
    if dev.type != "cuda":
        raise ValueError(f"the csr_candidate_topk kernel takes CUDA tensors, got {dev}")
    n_pad, d = store.shape
    b, w = starts.shape
    _build.check_tensor(store, "store", torch.float32, (n_pad, d), dev)
    _build.check_tensor(starts, "starts", torch.int32, (b, w), dev)
    _build.check_tensor(ends, "ends", torch.int32, (b, w), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, d), dev)
    if radii is not None:
        _build.check_tensor(radii, "radii", torch.float32, (b,), dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return out_d, out_i
    dc = d if d_chunk is None else max(1, min(d_chunk, d))
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            store.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            queries.data_ptr(), None if radii is None else radii.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), b, w, row_cap, d, n_pad, n,
            k, dc, int(metric == "l1"), int(center_cells),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return out_d, out_i
