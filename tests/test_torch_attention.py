"""The port's flash_attention against the JAX package's.

On the CPU `ops.flash_attention` runs the plain version
(`ref.flash_attention`); it is held against the reference's Pallas kernel
in interpret mode and against the reference's oracle, over the sweep of
the reference's own flash_attention tests: rtol/atol 2e-5 in float32 (3e-5
against the reference's kernel on its random-shape sweep, the tolerance the
reference gives its kernel there) and 2e-2 in bf16.  The card's kernel
computes both products in three-pass TF32; that arithmetic is emulated in
numpy here and held to the reference's oracle at the same 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_, require_cuda

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _qkv(seed, b, s, t, h, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, h, hd), (b, t, h, hd))]


def _both(arrays, causal, block, jdtype=jnp.float32, tdtype=torch.float32):
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdtype) for a in arrays),
                              causal=causal, block_q=block, block_k=block)
    jin = [jnp.asarray(a, jdtype) for a in arrays]
    kern = jops.flash_attention(*jin, causal=causal, block_q=block, block_k=block,
                                interpret=True)
    oracle = jref.flash_attention(*jin, causal=causal)
    return got, kern, oracle


@pytest.mark.parametrize("b,s,t,h,hd,causal", [
    (2, 64, 64, 4, 32, True),
    (1, 128, 128, 2, 64, True),
    (2, 32, 96, 3, 16, False),
    (1, 256, 256, 1, 128, True),
    (1, 64, 64, 2, 512, True),
    (1, 32, 64, 1, 1000, False),
])
def test_flash_attention_matches_reference(b, s, t, h, hd, causal):
    got, kern, oracle = _both(_qkv(s + t + hd, b, s, t, h, hd), causal, 32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, hd)
    np.testing.assert_allclose(np_(got), np.asarray(kern), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np_(got), np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_matches_reference():
    got, kern, oracle = _both(_qkv(3, 1, 64, 64, 2, 32), True, 16, jnp.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for want in (kern, oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("seed", range(6))
def test_flash_attention_random_shapes(seed):
    rng = np.random.default_rng(200 + seed)
    bq = int(rng.choice([8, 16, 32]))
    nq, nk = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    h, hd = int(rng.integers(1, 4)), int(rng.choice([16, 32, 64]))
    causal = bool(rng.integers(0, 2)) and nq == nk
    got, kern, oracle = _both(_qkv(seed, 1, bq * nq, bq * nk, h, hd), causal, bq)
    np.testing.assert_allclose(np_(got), np.asarray(oracle), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np_(got), np.asarray(kern), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("s,hd,causal", [(128, 160, True), (128, 160, False),
                                          (256, 256, True), (64, 256, False),
                                          (128, 129, True), (64, 131, False), (128, 200, True)])
def test_flash_attention_wide_heads_match_reference(s, hd, causal):
    """Head dims past 128 (stablelm-12b's 160; 129 and 131, which the card
    copies 4 bytes at a time; 200 and 256), which the card runs on its
    HDP = 160 and 256 tensor-core variants, against the reference's kernel
    in interpret mode and its oracle."""
    got, kern, oracle = _both(_qkv(s + hd, 1, s, s, 2, hd), causal, 64)
    assert tuple(got.shape) == (1, s, 2, hd)
    np.testing.assert_allclose(np_(got), np.asarray(kern), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np_(got), np.asarray(oracle), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,t,block", [(48, 48, 32), (64, 40, 32), (30, 30, 7)])
def test_flash_attention_blocks_must_divide(s, t, block):
    q, k, v = _qkv(0, 1, s, t, 1, 16)
    with pytest.raises(ValueError, match="must divide blocks") as theirs:
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                             block_q=block, block_k=block, interpret=True)
    with pytest.raises(ValueError, match="must divide blocks") as ours:
        ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=False, block_q=block, block_k=block)
    assert str(ours.value) == str(theirs.value)


def test_flash_attention_causal_first_row_is_its_value():
    """Under the causal mask the first query sees only the first key."""
    q, k, v = _qkv(4, 1, 16, 16, 2, 8)
    got = np_(ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), block_q=16,
                                  block_k=16))
    np.testing.assert_allclose(got[:, 0], v[:, 0], rtol=1e-6, atol=1e-6)


def test_flash_attention_kernel_wrapper_checks():
    """The kernel's wrapper checks shapes and the head dim before the
    device, and refuses CPU tensors without counting a launch.  The
    sequence is not capped: past grid.y's 65,535 query tiles the
    tensor-core route launches again."""
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="hd <= 1024"):
        fa.flash_attention(*(torch.zeros((1, 8, 1, 1025)),) * 3)
    assert fa.MAX_TILES_PER_LAUNCH == 65_535
    # hd = 160 and 257 (a column-split variant), B*H past grid.y's 65,535,
    # and S past 65,535 query tiles at hd = 16 and 129 pass the checks and
    # reach the device check
    for shape in ((1, 8, 1, 160), (1, 8, 1, 257), (1100, 1, 64, 16), (1, 4, 70_000, 16),
                  (1, 64 * 65_535 + 64, 1, 16), (1, 64 * 65_535 + 64, 1, 129)):
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention(*(torch.zeros(1).expand(shape),) * 3)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(x, torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(x, x, x)
    assert fa.launches == 0


def test_flash_attention_shared_bytes():
    """Per variant: two stages of a K tile (rows of HDP + 8 floats) and a V
    tile (HDP + 4) of the variant's key rows; the float32 query tile (rows
    of HDP + 8) where it is not in registers; and, where warps split the
    head dim, each warp's partial scores (16 rows x the key tile).  Every
    variant fits a block's 232,448 bytes, and the wrapper's table gives
    what the source's fa_shared_bytes does."""
    ring = {hdp: 2 * bk * ((hdp + 8) + (hdp + 4))
            for hdp, (_, _, bk, _) in fa.TC_VARIANTS.items()}
    assert fa.shared_bytes(16) == 4 * ring[16] == 4 * 2 * 64 * (24 + 20)
    assert fa.shared_bytes(64) == fa.shared_bytes(36) == 4 * 2 * 64 * (72 + 68)
    assert fa.shared_bytes(128) == fa.shared_bytes(65) == 4 * (2 * 32 * (136 + 132) + 128 * 136)
    assert fa.shared_bytes(160) == fa.shared_bytes(129) == 4 * (2 * 32 * (168 + 164) + 128 * 168)
    assert fa.shared_bytes(256) == fa.shared_bytes(200) == 4 * (2 * 16 * (264 + 260) + 128 * 264)
    # the split variants keep their query fragments in registers
    assert fa.shared_bytes(512) == fa.shared_bytes(257) == 4 * (
        ring[512] + 8 * 16 * 16) == 4 * (2 * 16 * (520 + 516) + 8 * 16 * 16)
    assert fa.shared_bytes(1024) == fa.shared_bytes(1000) == 4 * (
        2 * 8 * (1032 + 1028) + 8 * 16 * 8)
    for hdp in fa.TC_VARIANTS:
        assert fa.shared_bytes(hdp) <= 232_448


def test_flash_attention_wide_route():
    """Every head dim 1-1024 has a tensor-core variant, padded to the first
    of 16, 32, 64, 128, 160, 256, 512 and 1024 that holds it.  Up to 64 a
    block is 4 warps of 64 rows with the query fragments in registers;
    65-256 take 8 warps of 128 rows; past 256 each row group's head dim is
    split across its warps, 128 columns each, with the query fragments in
    registers (4 slices at HDP = 512, 32 rows; 8 at 1024, 16 rows)."""
    pads = [fa.padded_head_dim(hd) for hd in range(1, fa.MAX_HEAD_DIM + 1)]
    assert pads == sorted(pads) and set(pads) == set(fa.TC_VARIANTS)
    assert [fa.padded_head_dim(hd) for hd in (1, 16, 17, 33, 65, 128, 129, 160, 161, 256,
                                              257, 512, 513, 1000, 1024)] == [
        16, 16, 32, 64, 128, 128, 160, 160, 256, 256, 512, 512, 1024, 1024, 1024]
    assert [fa.query_tile(hd) for hd in (16, 64, 128, 129, 256, 257, 1024)] == [
        64, 64, 128, 128, 128, 32, 16]
    for hdp, (warps, slices, bk, qmode) in fa.TC_VARIANTS.items():
        assert warps % slices == 0 and (hdp // slices) % 8 == 0 and bk % 8 == 0
        assert (slices > 1) == (hdp > 256) and (warps == 8) == (hdp > 64)
        assert (qmode == "registers") == (hdp <= 64 or slices > 1)
        assert slices == 1 or hdp // slices == 128


# ------------------------------------------- three-pass TF32, emulated ----


def _tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on finite float32: 10 mantissa bits, ties away
    from zero (the kernel's rounding of every operand)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a: np.ndarray, b: np.ndarray, passes: int, slices: int = 1) -> np.ndarray:
    """a @ b as the tensor cores compute it from TF32 operands: hi·hi alone
    (one pass) or lo·hi + hi·lo + hi·hi (three), each product exact and the
    sums in float32.  With `slices`, the contraction is cut into that many
    equal column slices, each slice's product taken alone and the partials
    summed in slice order 0, 1, ..., as the column-split variants do."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    width = a.shape[-1] // slices
    out = None
    for i in range(slices):
        cols = slice(i * width, (i + 1) * width)
        part = ah[..., cols] @ bh[..., cols, :]
        if passes == 3:
            part = al[..., cols] @ bh[..., cols, :] + ah[..., cols] @ bl[..., cols, :] + part
        out = part if out is None else out + part
    return out


def _attention_tf32(q, k, v, causal: bool, passes: int) -> np.ndarray:
    """The kernel's arithmetic over one key tile spanning every key: scores
    from TF32 products (the head dim zero-padded to the variant's and cut
    into its slices), p = exp(s - max) unnormalised, P·V from TF32
    products, divided by the row sum at the end."""
    hd = q.shape[-1]
    hdp = fa.padded_head_dim(hd)
    slices = fa.TC_VARIANTS[hdp][1]
    qh, kh, vh = (np.moveaxis(x, 2, 1) for x in (q, k, v))  # (B, H, ., hd)
    qp, kp = (np.pad(x, [(0, 0)] * 3 + [(0, hdp - hd)]) for x in (qh, kh))
    s = _matmul_tf32(qp, np.swapaxes(kp, -1, -2), passes, slices) * np.float32(1 / np.sqrt(hd))
    if causal:
        keep = np.arange(q.shape[1])[:, None] >= np.arange(k.shape[1])[None, :]
        s = np.where(keep, s, np.float32(-1e30))
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    out = _matmul_tf32(p, vh, passes) / p.sum(-1, keepdims=True)
    return np.moveaxis(out, 1, 2)


@pytest.mark.parametrize("b,s,t,h,hd,causal", [
    (2, 64, 64, 4, 32, True),
    (1, 128, 128, 2, 64, True),
    (2, 32, 96, 3, 16, False),
    (1, 256, 256, 1, 128, True),
    (1, 128, 128, 2, 160, True),
    (1, 64, 64, 1, 256, False),
    (1, 64, 64, 2, 512, True),
    (1, 32, 48, 1, 1024, False),
])
def test_three_pass_tf32_meets_the_float32_tolerance(b, s, t, h, hd, causal):
    """The kernel's numerics on the CPU, over the reference tests' shapes,
    the wide heads' 160- and 256-term contractions and the column-split
    variants' 512 and 1024 (partial scores per slice, summed in slice
    order): three-pass TF32 products (lo·hi + hi·lo + hi·hi) stay within
    the float32 tolerance 2e-5 of the reference's oracle; one pass (hi·hi)
    does not."""
    q, k, v = _qkv(s + t + hd, b, s, t, h, hd)
    want = np.asarray(jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    three = _attention_tf32(q, k, v, causal, passes=3)
    np.testing.assert_allclose(three, want, rtol=2e-5, atol=2e-5)
    one = _attention_tf32(q, k, v, causal, passes=1)
    assert not np.allclose(one, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128, 160, 512])
def test_gpu_flash_attention_over_several_launches(causal, hd):
    """Query tiles split over several launches (2 tiles each: S of 5 tiles
    is 3 launches), heaviest tiles first: within 2e-5 of the plain version,
    one counted call of 3 grids."""
    dev = require_cuda()
    rng = np.random.default_rng(300)
    s = 4 * fa.query_tile(hd) + 44
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 3, hd)).astype(np.float32)).to(dev)
               for _ in range(3))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, _tiles_per_launch=2)
    assert fa.last_grids == 3
    want = tref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    np.testing.assert_allclose(np_(got), np_(want), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_gpu_flash_attention_many_heads_split_head_dim():
    """B·H = 70,400 (past grid.y's 65,535) at hd = 512, whose row groups
    split the head dim across warps: (batch, head) on grid.x, one launch,
    within 2e-5 of the plain version."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(301)
    q, k, v = (torch.randn((1100, 8, 64, 512), generator=gen, device=dev) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.last_grids == 1
    want = tref.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(np_(got), np_(want), rtol=2e-5, atol=2e-5)
