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
from repro_torch.kernels.ref import MAX_SHARED_BYTES, check_csr_args

SOURCE = "csr_candidate_topk"
STATIC_SHARED_BYTES = 64  # the arg-min's per-warp scratch in the source
launches = 0              # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).csr_candidate_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(d: int, w: int, row_cap: int) -> int:
    """Dynamic shared memory of one block: the query plus w*row_cap
    (distance, row) pairs."""
    return 4 * d + 8 * w * row_cap


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
    smem = shared_bytes(d, w, row_cap)
    if smem + STATIC_SHARED_BYTES > MAX_SHARED_BYTES:
        raise ValueError(
            f"window of {w}x{row_cap} slots at d={d} needs {smem} bytes of "
            f"shared memory per block; the card allows {MAX_SHARED_BYTES}"
        )
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
