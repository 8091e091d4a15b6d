"""Hopper kernel: circle count from ONE pyramid level.

Wrapper of `csrc/tile_count.cu`, the port of the TPU kernel
`repro/kernels/tile_count.py::tile_count`.  `hopper_stacked`'s count_at
(`core/batched.py::batched_counts_stacked`) launches it once per pyramid
level and selects each query's own level afterwards.  The plain version is
`ref.tile_count`; `ops.tile_count` picks between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "tile_count"
launches = 0       # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once: count_at launches once per level
def _launcher():
    fn = _build.load(SOURCE).tile_count_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_count(
    level_arr: torch.Tensor,  # (S, S, C) int32 — one pyramid level
    queries: torch.Tensor,    # (B, 2) float32 — positions in BASE-pixel units
    radii: torch.Tensor,      # (B,) float32 — radii in base-pixel units
    scale: int,               # 2**level
    tile: int,                # T — window side in level cells
    metric: str = "l2",
) -> torch.Tensor:
    """Circle-masked counts (B, C) int32 over the clamped T x T window of
    one level, from the CUDA kernel.  CUDA tensors only."""
    global launches
    dev = level_arr.device
    if dev.type != "cuda":
        raise ValueError(f"the tile_count kernel takes CUDA tensors, got {dev}")
    if level_arr.ndim != 3 or level_arr.shape[0] != level_arr.shape[1] \
            or level_arr.shape[0] < tile:
        raise ValueError(
            f"level shape {tuple(level_arr.shape)} is not (S, S, C) with S >= tile={tile}"
        )
    s, _, c = level_arr.shape
    b = queries.shape[0]
    _build.check_tensor(level_arr, "level_arr", torch.int32, (s, s, c), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, 2), dev)
    _build.check_tensor(radii, "radii", torch.float32, (b,), dev)
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            level_arr.data_ptr(), queries.data_ptr(), radii.data_ptr(),
            out.data_ptr(), b, s, tile, c, scale, int(metric == "l1"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return out
