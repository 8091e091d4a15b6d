"""Hopper kernel: level-scheduled circle count over the whole pyramid.

Wrapper of `csrc/tile_count_multilevel.cu`, the port of the TPU kernel
`repro/kernels/tile_count_multilevel.py::tile_count_multilevel`.  Each
Eq.-1 iteration counts every query's circle at the query's own pyramid
level in ONE launch, reading the query's T x T window from the flattened
tile array (`GridIndex.pyr_tiles`).  The plain version is
`ref.tile_count_multilevel`; `ops.tile_count_multilevel` picks between
them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import check_tile_layout

SOURCE = "tile_count_multilevel"
launches = 0       # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once: the Eq.-1 loop launches every iteration
def _launcher():
    fn = _build.load(SOURCE).tile_count_multilevel_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_count_multilevel(
    tiles: torch.Tensor,     # (sum_l nblk_l^2, T, T, C) int32 flattened pyramid
    queries: torch.Tensor,   # (B, 2) float32, base-pixel units
    radii: torch.Tensor,     # (B,) float32, base-pixel units
    levels: torch.Tensor,    # (B,) int32 pyramid level per query
    tile: int,
    nblks: tuple[int, ...],  # per-level block counts S_l // T
    metric: str = "l2",
    active: torch.Tensor | None = None,  # (B,) bool lane mask (None = all live)
) -> torch.Tensor:
    """Level-scheduled circle counts (B, C) int32 from the CUDA kernel;
    parked lanes (active False) give 0.  CUDA tensors only."""
    global launches
    check_tile_layout(tiles, tile, nblks)
    dev = tiles.device
    if dev.type != "cuda":
        raise ValueError(f"the tile_count_multilevel kernel takes CUDA tensors, got {dev}")
    b, c = queries.shape[0], tiles.shape[-1]
    _build.check_tensor(tiles, "tiles", torch.int32, tuple(tiles.shape), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, 2), dev)
    _build.check_tensor(radii, "radii", torch.float32, (b,), dev)
    _build.check_tensor(levels, "levels", torch.int32, (b,), dev)
    if active is not None:
        _build.check_tensor(active, "active", torch.bool, (b,), dev)
    out = torch.empty((b, c), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            tiles.data_ptr(), queries.data_ptr(), radii.data_ptr(),
            levels.data_ptr(), None if active is None else active.data_ptr(),
            out.data_ptr(), b, tile, c, len(nblks), int(metric == "l1"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return out
