"""Hopper kernel: flash attention (online softmax), causal or full.

Wrapper of `csrc/flash_attention.cu`, the port of the TPU kernel
`repro/kernels/flash_attention.py::flash_attention`.  Every head dim
1-1024 runs on the tensor cores (mma.sync, three-pass TF32: float32
accuracy), padded to one of the variants in TC_VARIANTS.  Up to hd = 64 a
block of 4 warps owns 64 query rows of one head and streams 64-key tiles
of K and V through a two-stage cp.async ring in shared memory, and the
probabilities stay in registers.  hd 65-256 (minitron-8b's 128,
stablelm-12b's 160) run on 8-warp blocks of 128 rows with P·V's loops
interchanged and, past 128, shorter key tiles.  hd 257-1024 split each
row group's head dim across warps: the warps that share 16 query rows
each compute a partial Q·Kᵀ over their own columns and sum the partials
in slice order, so all of them hold the same scores, then each runs P·V
for its columns.  (batch, head) sits on grid.x, so B·H is not held to
grid.y's 65,535; query tiles sit on grid.y, one launch per 65,535 of them
(MAX_TILES_PER_LAUNCH), so S is not held to it either.
No path of the system calls it (the reference's models compute attention
in plain jnp); `chip_smoke.py` times it at musicgen-medium's,
stablelm-12b's and minitron-8b's attention widths and at hd = 512.  The
plain version is `ref.flash_attention`; `ops.flash_attention` picks
between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention"
MAX_HEAD_DIM = 1024  # the widest variant's padded head dim (fa_padded_hd)
MAX_TILES_PER_LAUNCH = 65_535  # query tiles on grid.y (FA_MAX_TILES)
# Variants by padded head dim: (warps of a block, warps of a row group that
# split its head dim, key rows per K and V tile, where the query tile
# lives), as fa_variant in the source.  A block holds 16 query rows per
# row group.  "registers": split once into registers; "raw": float32 in
# shared memory, split at each k-step.
TC_VARIANTS = {16: (4, 1, 64, "registers"), 32: (4, 1, 64, "registers"),
               64: (4, 1, 64, "registers"), 128: (8, 1, 32, "raw"), 160: (8, 1, 32, "raw"),
               256: (8, 1, 16, "raw"), 512: (8, 4, 16, "registers"),
               1024: (8, 8, 8, "registers")}
launches = 0        # kernel launches so far (chip_smoke resets and reads it)
last_grids = 0      # grids the last launch started: one per MAX_TILES_PER_LAUNCH query tiles


@functools.cache  # bound once, not on every launch
def _launcher():
    fn = _build.load(SOURCE).flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def padded_head_dim(hd: int) -> int:
    """The head dim of the kernel variant that takes hd, padded with zero
    columns: 16, 32, 64, 128, 160, 256, 512 or 1024 (fa_padded_hd in the
    source)."""
    return next(p for p in TC_VARIANTS if hd <= p)


def query_tile(hd: int) -> int:
    """Query rows per block of the variant that takes hd."""
    warps, slices, _, _ = TC_VARIANTS[padded_head_dim(hd)]
    return 16 * warps // slices


def shared_bytes(hd: int) -> int:
    """Dynamic shared memory of one block: two stages of a K tile (key-tile
    rows of padded_head_dim + 8 floats) and a V tile (rows of + 4), the
    float32 query tile (query-tile rows of + 8) where it is not in
    registers and, where warps split the head dim, each warp's partial
    scores (16 rows x the key tile)."""
    hdp = padded_head_dim(hd)
    warps, slices, bk, qmode = TC_VARIANTS[hdp]
    qtile = {"registers": 0, "raw": 1}[qmode] * query_tile(hd) * (hdp + 8)
    partial = warps * 16 * bk if slices > 1 else 0
    return 4 * (2 * bk * ((hdp + 8) + (hdp + 4)) + qtile + partial)


def check_blocks(s: int, t: int, block_q: int, block_k: int) -> None:
    """The reference's rule: each sequence must divide its block."""
    bq, bk = min(block_q, s), min(block_k, t)
    if -(-s // bq) * bq != s or -(-t // bk) * bk != t:
        raise ValueError(f"seq {s}/{t} must divide blocks {bq}/{bk}")


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(
            f"flash_attention takes q (B, S, H, hd) and k, v (B, T, H, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd):
        raise ValueError(f"k and v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes 1 <= hd <= {MAX_HEAD_DIM}, got {hd}")


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, H, hd)
    v: torch.Tensor,  # (B, T, H, hd)
    causal: bool = True,
    _tiles_per_launch: int = MAX_TILES_PER_LAUNCH,  # smaller: several launches at a small S
) -> torch.Tensor:
    """Attention (B, S, H, hd) in q's dtype from the CUDA kernel, computed
    in float32 (bf16 inputs are cast up and the output cast back, as the
    reference's wrapper does around its kernel).  CUDA tensors only."""
    global launches, last_grids
    check_args(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash_attention kernel takes CUDA tensors, got {dev}")
    b, s, h, hd = q.shape
    t = k.shape[1]
    qf, kf, vf = (x.to(torch.float32).contiguous() for x in (q, k, v))
    _build.check_tensor(kf, "k", torch.float32, (b, t, h, hd), dev)
    _build.check_tensor(vf, "v", torch.float32, (b, t, h, hd), dev)
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=dev)
    if b * h * s == 0:
        return out.to(q.dtype)
    launch = _launcher()
    grids = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = launch(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(), b, s, t, h,
            hd, int(causal), 1.0 / hd ** 0.5, max(1, min(_tiles_per_launch, MAX_TILES_PER_LAUNCH)),
            ctypes.byref(grids), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check_launch(SOURCE, err)
    launches += 1
    last_grids = grids.value
    return out.to(q.dtype)
