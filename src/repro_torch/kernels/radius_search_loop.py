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
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import check_tile_layout
from repro_torch.utils import trace

SOURCE = "radius_search_loop"
launches = 0       # kernel launches so far (chip_smoke resets and reads it)


@functools.cache  # bound once: every search chunk launches it
def _launcher():
    fn = _build.load(SOURCE).radius_search_loop_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# The launch is the operator `torch.ops.repro_torch.radius_search_loop`,
# with a CUDA kernel only: fake tensors (the dry run) get the outputs'
# shapes from its fake, and the counter its formulas.  It is registered on
# the dispatcher directly (`Library.impl`): `torch.library.custom_op`'s
# extra layers cost the host several times more per launch, on search
# paths that the host's launches bound (chip_smoke.py 11c times a launch
# through the operator against a direct call of `_launch`).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("radius_search_loop(Tensor tiles, Tensor queries, Tensor r0, int k, int k_hi, "
            "int r_max, int max_iters, int tile, int n_levels, bool l1) "
            "-> (Tensor, Tensor, Tensor, Tensor)")


def _launch(tiles: torch.Tensor, queries: torch.Tensor, r0: torch.Tensor, k: int, k_hi: int,
            r_max: int, max_iters: int, tile: int, n_levels: int, l1: bool
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the kernel on checked CUDA tensors -> radius, count,
    iters (B,) int32 and converged (B,) bool."""
    global launches
    dev = tiles.device
    b, c = queries.shape[0], tiles.shape[-1]
    i32 = dict(dtype=torch.int32, device=dev)
    radius, count, iters = (torch.empty((b,), **i32) for _ in range(3))
    converged = torch.empty((b,), dtype=torch.bool, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(
            tiles.data_ptr(), queries.data_ptr(), r0.data_ptr(), radius.data_ptr(),
            count.data_ptr(), iters.data_ptr(), converged.data_ptr(),
            b, tile, c, n_levels, k, k_hi, r_max, max_iters, int(l1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    return radius, count, iters, converged


_LIB.impl("radius_search_loop", _launch, "CUDA")
_OP = torch.ops.repro_torch.radius_search_loop.default


@torch.library.register_fake("repro_torch::radius_search_loop")
def _(tiles, queries, r0, k, k_hi, r_max, max_iters, tile, n_levels, l1):
    b = queries.shape[0]
    return (*(queries.new_empty((b,), dtype=torch.int32) for _ in range(3)),
            queries.new_empty((b,), dtype=torch.bool))


def _passes(max_iters: int) -> int:
    return max_iters + 1                       # the loop's passes and the recount


@register_flop_formula(torch.ops.repro_torch.radius_search_loop)
def _flops(tiles, queries, r0, k, k_hi, r_max, max_iters, tile, n_levels, l1, out_shape=None):
    """Every lane in every pass: ten float operations per cell of its T x T
    window (the circle mask) and C adds (chip_smoke's operation count, at
    the most passes the loop can run: a trace has no data)."""
    return queries[0] * _passes(max_iters) * tile * tile * (10 + tiles[-1])


@trace.register_bytes(torch.ops.repro_torch.radius_search_loop)
def _bytes(tiles, queries, r0, k, k_hi, r_max, max_iters, tile, n_levels, l1, out_shape=None):
    """Every lane reads its T x T window of C int32 counts in every pass
    (at most max_iters and the recount), its query and start radius once,
    and writes its four outputs."""
    b = queries[0]
    return b * _passes(max_iters) * tile * tile * tiles[-1] * 4 + b * (8 + 4) + b * (3 * 4 + 1)


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

    The launch is the operator `torch.ops.repro_torch.radius_search_loop`
    (CUDA only; on fake tensors it gives the output shapes, and the dry
    run counts its FLOP and byte formulas).

    Lanes iterate on their own, so the lock-step schedule's statistic is
    recovered on the card: the lock-step loop runs max(iters) passes, and
    lane b is parked in max(iters) - iters[b] of them and skips its
    recount when it converged, 4 tile loads each:
    4 * (B * max(iters) - sum(iters)) + 4 * sum(converged), or 0 when
    `early_exit` is False (the reference's unmasked schedule, whose other
    outputs are the same)."""
    check_tile_layout(tiles, tile, nblks)
    dev = tiles.device
    if dev.type != "cuda":
        raise ValueError(f"the radius_search_loop kernel takes CUDA tensors, got {dev}")
    b = queries.shape[0]
    _build.check_tensor(tiles, "tiles", torch.int32, tuple(tiles.shape), dev)
    _build.check_tensor(queries, "queries", torch.float32, (b, 2), dev)
    _build.check_tensor(r0, "r0", torch.int32, (b,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    if b == 0:
        empty = torch.empty((0,), **i32)
        return {"radius": empty, "count": empty.clone(), "iters": empty.clone(),
                "converged": torch.empty((0,), dtype=torch.bool, device=dev),
                "tile_dmas_skipped": torch.zeros((), **i32)}
    radius, count, iters, converged = _OP(tiles, queries, r0, k, k_hi, r_max, max_iters, tile,
                                          len(nblks), metric == "l1")
    out = {"radius": radius, "count": count, "iters": iters, "converged": converged}
    if early_exit:
        parked = b * iters.max() - iters.sum(dtype=torch.int32)
        skipped = 4 * (parked + converged.sum(dtype=torch.int32))
    else:
        skipped = torch.zeros((), **i32)
    return {**out, "tile_dmas_skipped": skipped.to(torch.int32)}
