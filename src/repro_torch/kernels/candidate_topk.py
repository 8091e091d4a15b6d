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
from repro_torch.kernels.ref import check_dense_args

SOURCE = "candidate_topk"
launches = 0              # kernel launches so far (chip_smoke resets and reads it)
# Static shared memory of the three candidate kernels (the csr wrappers
# import these): csrc/kernel_common.cuh's top-k (TopkShared: a buffer of
# 512 and a list of 128 (value, slot) pairs, the threshold pair, two
# counters) and the TOPK_CHUNK float32 scores a kernel stages before it
# offers them.  chip_smoke.py holds both against ptxas's count.
TOPK_SHARED_BYTES = 8 * (512 + 128) + 16
TOPK_CHUNK = 4096
# kernel_common.cuh's staged walk (STAGE_RING, STAGE_TR, STAGE_TD): rows of
# d >= TILE_DIMS floats reach shared memory TILE_DIMS dims at a time, in
# tiles of TILE_ROWS slots, through a ring of STAGES slots; a staged row
# takes TILE_DIMS + 4 floats
STAGES, TILE_ROWS, TILE_DIMS = 2, 256, 32


def staged_bytes(tile_rows: int) -> int:
    """The staged walk's ring (tile_rows rows per slot) and the row numbers
    of the tiles in flight (TILE_ROWS per slot)."""
    return STAGES * (tile_rows * (TILE_DIMS + 4) + TILE_ROWS) * 4


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).candidate_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_rows(c: int) -> int:
    """Ring rows per slot: a whole tile, or a window of one partial tile's
    slots rounded up to a warp (csrc/candidate_topk.cu's launcher)."""
    return min(TILE_ROWS, max(32, -(-c // 32) * 32))


def shared_bytes(d: int, c: int) -> int:
    """Shared memory of one block: at d >= TILE_DIMS the staged walk's ring
    and row numbers, below it a chunk of staged distances; the query, and
    the top-k's buffer and list.  It does not grow with the candidates (C)
    past one tile."""
    staged = staged_bytes(tile_rows(c)) if d >= TILE_DIMS else 4 * TOPK_CHUNK
    return staged + 4 * d + TOPK_SHARED_BYTES


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
