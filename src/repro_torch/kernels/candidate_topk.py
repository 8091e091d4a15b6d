"""Hopper kernel: dense candidate distance -> top-k (LOCAL slots).

Wrapper of `csrc/candidate_topk.cu`, the port of the TPU kernel
`repro/kernels/candidate_topk.py::candidate_topk`.  `hopper_gather` ranks
its materialised (B, w*row_cap, d) window with it and `hopper_q8` re-ranks
its (B, rerank_k, d) shortlist.  The plain version is
`ref.candidate_topk`; `ops.candidate_topk` picks between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import MAX_SHARED_BYTES, check_dense_args

SOURCE = "candidate_topk"
STATIC_SHARED_BYTES = 64  # the arg-min's per-warp scratch (kernel_common.cuh)
launches = 0              # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).candidate_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def shared_bytes(d: int, c: int) -> int:
    """Dynamic shared memory of one block: the query plus C distances."""
    return 4 * (d + c)


def candidate_topk(
    candidates: torch.Tensor,  # (B, C, d) float32
    valid: torch.Tensor,       # (B, C) bool
    queries: torch.Tensor,     # (B, d) float32
    k: int,
    metric: str = "l2",
    d_chunk: int | None = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (B, k) float32 with +inf pads, idx (B, k) int32 LOCAL slots
    with -1 pads) from the CUDA kernel.  CUDA tensors only."""
    global launches
    check_dense_args(candidates, valid, queries)
    dev = candidates.device
    if dev.type != "cuda":
        raise ValueError(f"the candidate_topk kernel takes CUDA tensors, got {dev}")
    b, c, d = candidates.shape
    smem = shared_bytes(d, c)
    if smem + STATIC_SHARED_BYTES > MAX_SHARED_BYTES:
        raise ValueError(
            f"{c} candidates at d={d} need {smem} bytes of shared memory per "
            f"block; the card allows {MAX_SHARED_BYTES}"
        )
    _build.check_tensor(candidates, "candidates", torch.float32, (b, c, d), dev)
    _build.check_tensor(valid, "valid", torch.bool, (b, c), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, d), dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return out_d, out_i
    dc = d if d_chunk is None else max(1, min(d_chunk, d))
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            candidates.data_ptr(), valid.data_ptr(), queries.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), b, c, d, k, dc,
            int(metric == "l1"), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return out_d, out_i
