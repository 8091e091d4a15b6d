"""Hopper kernel: the whole Eq.-1 radius loop in one launch.

Wrapper of `csrc/radius_search_loop.cu`, the port of the TPU kernel
`repro/kernels/tile_count_multilevel.py::tile_count_multilevel` together
with the `lax.while_loop` that launches it once per iteration
(`repro/core/batched.py::radius_search_batched`).  One launch runs every
lane's loop and its recount on the card; nothing is read back to the host.
The plain version is `ref.radius_search_loop`, the lock-step loop of
`core/batched.py`;
`ops.radius_search_loop` picks between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import check_tile_layout

SOURCE = "radius_search_loop"
launches = 0       # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once: every search chunk launches it
def _launcher():
    fn = _build.load(SOURCE).radius_search_loop_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def radius_search_loop(
    tiles: torch.Tensor,     # (sum_l nblk_l^2, T, T, C) int32 flattened pyramid
    queries: torch.Tensor,   # (B, 2) float32, base-pixel units
    r0: torch.Tensor,        # (B,) int32 start radii
    k: int,
    k_hi: int,
    r_max: int,
    max_iters: int,
    tile: int,
    nblks: tuple[int, ...],  # per-level block counts S_l // T
    metric: str = "l2",
    early_exit: bool = True,
) -> dict:
    """radius, count, iters (B,) int32, converged (B,) bool and the scalar
    tile_dmas_skipped, from the CUDA kernel.  CUDA tensors only.

    Lanes iterate on their own, so the lock-step schedule's statistic is
    recovered on the card: the lock-step loop runs max(iters) passes, and
    lane b is parked in max(iters) - iters[b] of them and skips its
    recount when it converged, 4 tile loads each:
    4 * (B * max(iters) - sum(iters)) + 4 * sum(converged), or 0 when
    `early_exit` is False (the reference's unmasked schedule, whose other
    outputs are the same)."""
    global launches
    check_tile_layout(tiles, tile, nblks)
    dev = tiles.device
    if dev.type != "cuda":
        raise ValueError(f"the radius_search_loop kernel takes CUDA tensors, got {dev}")
    b, c = queries.shape[0], tiles.shape[-1]
    _build.check_tensor(tiles, "tiles", torch.int32, tuple(tiles.shape), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, 2), dev)
    _build.check_tensor(r0, "r0", torch.int32, (b,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {
        "radius": torch.empty((b,), **i32),
        "count": torch.empty((b,), **i32),
        "iters": torch.empty((b,), **i32),
        "converged": torch.empty((b,), dtype=torch.bool, device=dev),
    }
    if b == 0:
        return {**out, "tile_dmas_skipped": torch.zeros((), **i32)}
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            tiles.data_ptr(), queries.data_ptr(), r0.data_ptr(), out["radius"].data_ptr(),
            out["count"].data_ptr(), out["iters"].data_ptr(), out["converged"].data_ptr(),
            b, tile, c, len(nblks), k, k_hi, r_max, max_iters, int(metric == "l1"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    if early_exit:
        it = out["iters"]
        parked = b * it.max() - it.sum(dtype=torch.int32)
        skipped = 4 * (parked + out["converged"].sum(dtype=torch.int32))
    else:
        skipped = torch.zeros((), **i32)
    return {**out, "tile_dmas_skipped": skipped.to(torch.int32)}
