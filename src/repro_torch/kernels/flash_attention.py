"""Hopper kernel: flash attention (online softmax), causal or full.

Wrapper of `csrc/flash_attention.cu`, the port of the TPU kernel
`repro/kernels/flash_attention.py::flash_attention`.  Up to hd = 256 both
products run on the tensor cores (mma.sync, three-pass TF32: float32
accuracy): a block of 4 warps owns 64 query rows of one head and streams
64-key tiles of K and V through a two-stage cp.async ring in shared
memory, and the probabilities stay in registers; head dims 129-256
(stablelm-12b's 160) run on 8-warp blocks of 128 rows with shorter key
tiles (TC_VARIANTS).  Head dims 257-1024 take a simple kernel in float32
FMAs, one warp per query row.  Both kernels put (batch, head) on grid.x,
so B·H is not held to grid.y's 65,535; the tensor-core kernel puts its
query tiles on grid.y and launches once per 65,535 of them
(MAX_TILES_PER_LAUNCH), so S is not held to it either.
No path of the system calls it (the reference's models compute attention
in plain jnp); `chip_smoke.py` times it at musicgen-medium's,
stablelm-12b's and minitron-8b's attention widths.  The plain version is
`ref.flash_attention`; `ops.flash_attention` picks between them by device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention"
TC_HEAD_DIM = 256   # the widest tensor-core variant's padded head dim
MAX_HEAD_DIM = 1024  # the FMA route's widest variant (fw_padded_hd)
MAX_TILES_PER_LAUNCH = 65_535  # tensor-core route: query tiles on grid.y (FA_MAX_TILES)
# Tensor-core variants by padded head dim: (warps of 16 query rows, key rows
# per K and V tile, where the query tile lives), as fa_warps, fa_key_tile and
# fa_q_mode in the source.  "registers": split once into registers; "split":
# split once, hi and lo in shared memory; "raw": float32 in shared memory,
# split at each k-step.
TC_VARIANTS = {16: (4, 64, "registers"), 32: (4, 64, "registers"), 64: (4, 64, "registers"),
               128: (4, 64, "split"), 160: (8, 32, "raw"), 256: (8, 16, "raw")}
WIDE_KEY_TILE = 16  # FW_BK in the source: K and V rows staged by the FMA route
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
    columns: 16, 32, 64, 128, 160 or 256 on the tensor cores (fa_padded_hd
    in the source), 512 or 1024 on the FMA route (fw_padded_hd)."""
    return next(p for p in (*TC_VARIANTS, 512, MAX_HEAD_DIM) if hd <= p)


def wide_route(hd: int) -> bool:
    """Whether the launch takes the float32-FMA kernel: hd > 256."""
    return hd > TC_HEAD_DIM


def query_tile(hd: int) -> int:
    """Query rows per block of the tensor-core variant that takes hd."""
    return 16 * TC_VARIANTS[padded_head_dim(hd)][0]


def shared_bytes(hd: int) -> int:
    """Dynamic shared memory of one block.  Tensor-core route: two stages
    of a K tile (key-tile rows of padded_head_dim + 8 floats) and a V tile
    (rows of + 4), and the query tile (query-tile rows of + 8) where it is
    not in registers: its TF32 hi and lo halves ("split") or its float32
    values ("raw").  FMA route: a K and a V tile of 16 rows of
    padded_head_dim floats."""
    hdp = padded_head_dim(hd)
    if wide_route(hd):
        return 4 * 2 * WIDE_KEY_TILE * hdp
    warps, bk, qmode = TC_VARIANTS[hdp]
    qtile = {"registers": 0, "split": 2, "raw": 1}[qmode] * 16 * warps * (hdp + 8)
    return 4 * (2 * bk * ((hdp + 8) + (hdp + 4)) + qtile)


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
