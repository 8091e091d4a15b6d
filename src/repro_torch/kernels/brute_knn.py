"""Hopper kernel: exact l2 kNN by brute force.

Wrapper of `csrc/brute_knn.cu`, the port of the TPU kernel
`repro/kernels/brute_knn.py::brute_knn`.  The `exact` backend's l2 route
(`core/exact.py`) runs it.  The plain version is `ref.brute_knn`;
`ops.brute_knn` picks between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "brute_knn"
QUERY_TILE = 128        # queries per block (BK_BQ in the source)
POINT_TILE = 128        # points per streamed tile (BK_BN in the source)
BLOCKS_PER_SM = 2       # resident blocks of 256 threads (__launch_bounds__)
WAVES = 2               # blocks per resident slot that splits_for aims at
MIN_TILES_PER_SPLIT = 16
launches = 0            # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).brute_knn_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_args(queries: torch.Tensor, points: torch.Tensor, k: int) -> None:
    if queries.ndim != 2 or points.ndim != 2 or queries.shape[1] != points.shape[1]:
        raise ValueError(
            f"brute_knn takes queries (B, d) and points (N, d), got "
            f"{tuple(queries.shape)} and {tuple(points.shape)}"
        )
    if queries.shape[1] < 1:
        raise ValueError("brute_knn needs d >= 1")
    if k < 0:
        raise ValueError(f"brute_knn takes k >= 0, got k={k}")
    if points.shape[0] > 2**31 - 1 - POINT_TILE:
        raise ValueError(f"{points.shape[0]} points overflow the kernel's int32 ids")


def padded_rows(r: int) -> int:
    """Rows of a transposed copy (bk_padded in the source): r rounded up to
    a multiple of 4, so each of its rows starts on a 16-byte boundary."""
    return -(-r // 4) * 4


def scratch_bytes(b: int, n: int, d: int, k: int, sms: int) -> int:
    """Device scratch of one call: the transposed queries and points with
    their norms, and the (B, splits, k) partial lists."""
    bp, np_ = padded_rows(b), padded_rows(n)
    return 4 * (d + 1) * (bp + np_) + 8 * b * splits_for(b, n, sms) * k


def splits_for(b: int, n: int, sms: int) -> int:
    """Point ranges per query tile: as many blocks as WAVES full waves of
    the card's resident slots hold without starting a partial one, while
    each range keeps at least MIN_TILES_PER_SPLIT tiles of points."""
    q_tiles = max(1, -(-b // QUERY_TILE))
    tiles = -(-n // POINT_TILE)
    want = WAVES * BLOCKS_PER_SM * sms // q_tiles
    return max(1, min(want, tiles // MIN_TILES_PER_SPLIT))


def brute_knn(
    queries: torch.Tensor,  # (B, d)
    points: torch.Tensor,   # (N, d)
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists (B, k) float32 ascending with +inf pads, ids (B, k) int32 with
    -1 pads) from the CUDA kernel.  CUDA tensors only; inputs are cast to
    float32, as the reference's wrapper casts them."""
    global launches
    check_args(queries, points, k)
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"the brute_knn kernel takes CUDA tensors, got {dev}")
    q = queries.to(torch.float32).contiguous()
    x = points.to(torch.float32).contiguous()
    b, d = q.shape
    n = x.shape[0]
    _build.check_tensor(x, "points", torch.float32, (n, d), dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or k == 0:
        return out_d, out_i
    splits = splits_for(b, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    # scratch: queries and points transposed to (d, rows padded to 4) with
    # their squared norms (the kernel's pre-pass writes them), and each
    # point range's partial lists
    bp, np_ = padded_rows(b), padded_rows(n)
    qt = torch.empty((d, bp), dtype=torch.float32, device=dev)
    xt = torch.empty((d, np_), dtype=torch.float32, device=dev)
    qn = torch.empty((bp,), dtype=torch.float32, device=dev)
    xn = torch.empty((np_,), dtype=torch.float32, device=dev)
    part_d = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), x.data_ptr(), qt.data_ptr(), xt.data_ptr(), qn.data_ptr(),
            xn.data_ptr(), part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), b, n, d, k, splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return out_d, out_i
