"""Projection front-end: original d-dim space -> low-dim grid space.

Port of `repro/core/projection.py`.  A projection is data — (matrix, lo,
hi) float32 tensors — so the index of one framework can be carried to the
other (`repro_torch/convert.py`).  Every matrix product here runs in full
float32: TF32 is switched off for the product.  Points are projected
without one (`apply`), in a fixed summation order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Projection(NamedTuple):
    """Affine map  x -> x @ matrix  with grid extents [lo, hi] per grid dim."""

    matrix: torch.Tensor  # (d, gd) float32
    lo: torch.Tensor      # (gd,) float32
    hi: torch.Tensor      # (gd,) float32

    @property
    def grid_dim(self) -> int:
        return self.matrix.shape[1]

    def to(self, device) -> "Projection":
        return Projection(*(t.to(device) for t in self))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in full float32 (TF32 off on the card, whatever the global
    setting says)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def apply(proj: Projection, x: torch.Tensor) -> torch.Tensor:
    """Project points (..., d) into grid space (..., gd).

    Each coordinate is the sum of its d products in one fixed pairwise
    order, in elementwise operations only, so a point's coordinates do not
    depend on the batch it is projected in, nor on the device: a point
    inserted later lands where a rebuild puts it, bit for bit.  A GEMM's
    summation order changes with the row count on the card (cuBLAS picks
    its algorithm by shape), which moved inserted d = 128 points an ulp
    from a rebuild's.  Rows go through in blocks of _APPLY_ROWS, which
    bounds the (rows, d, gd) products held at once."""
    d, gd = proj.matrix.shape
    flat = x.to(torch.float32).reshape(-1, d)
    out = flat.new_zeros((0, gd))
    if flat.shape[0]:
        out = torch.cat([_sum_products(blk, proj.matrix) for blk in flat.split(_APPLY_ROWS)])
    return out.reshape(x.shape[:-1] + (gd,))


_APPLY_ROWS = 1 << 16


def _sum_products(x: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """x (n, d) @ mat (d, gd) as x[:, i] * mat[i] summed by halves: the
    products padded with zeros to a power of two (adding 0 is exact), then
    the first half added to the second until one row is left."""
    p = x[:, :, None] * mat                                     # (n, d, gd)
    width = 1 << max(p.shape[1] - 1, 0).bit_length()
    if width != p.shape[1]:
        p = torch.cat([p, p.new_zeros((p.shape[0], width - p.shape[1], p.shape[2]))], dim=1)
    while p.shape[1] > 1:
        half = p.shape[1] // 2
        p = p[:, :half] + p[:, half:]
    return p[:, 0]


def _extents(g: torch.Tensor, margin: float) -> tuple[torch.Tensor, torch.Tensor]:
    lo = g.amin(dim=0)
    hi = g.amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-6)
    return lo - margin * span, hi + margin * span


def identity_projection(points: torch.Tensor, margin: float = 0.01) -> Projection:
    """Paper-faithful: grid space IS the data space (d == gd)."""
    d = points.shape[-1]
    mat = torch.eye(d, dtype=torch.float32, device=points.device)
    lo, hi = _extents(points.to(torch.float32), margin)
    return Projection(mat, lo, hi)


def gaussian_projection(
    generator: torch.Generator | None,
    points: torch.Tensor,
    grid_dim: int = 2,
    margin: float = 0.01,
) -> Projection:
    """Random Gaussian projection (Johnson-Lindenstrauss style) to `grid_dim`.

    The matrix is drawn on `generator`'s device and moved to the points'."""
    d = points.shape[-1]
    gen_device = generator.device if generator is not None else "cpu"
    mat = torch.randn((d, grid_dim), generator=generator, dtype=torch.float32,
                      device=gen_device).to(points.device)
    mat = mat / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                        device=points.device))
    g = matmul_f32(points.to(torch.float32), mat)
    lo, hi = _extents(g, margin)
    return Projection(mat, lo, hi)


def pca_projection(points: torch.Tensor, grid_dim: int = 2, margin: float = 0.01) -> Projection:
    """Top-`grid_dim` principal directions — a better-behaved learned projection.

    One eigendecomposition of the (d, d) covariance; d is the embedding dim
    (<= a few thousand), never N.  Eigenvector signs are arbitrary, so this
    builder is held to the reference by its properties, not bit for bit."""
    x = points.to(torch.float32)
    mu = x.mean(dim=0, keepdim=True)
    xc = x - mu
    cov = matmul_f32(xc.T, xc) / x.shape[0]
    _, vecs = torch.linalg.eigh(cov)                   # ascending eigenvalues
    mat = vecs[:, -grid_dim:].flip(1).contiguous()     # (d, gd), top first
    g = matmul_f32(x, mat)
    lo, hi = _extents(g, margin)
    return Projection(mat, lo, hi)


def to_grid_coords(proj: Projection, x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Continuous grid coordinates in [0, grid_size) per grid dim, float32.

    Pixel (i, j) covers [i, i+1) x [j, j+1); a point's pixel is floor(coords).
    The upper clip `grid_size - 1e-3` is rounded to float32 first, as the
    reference's weakly typed constant is.
    """
    g = apply(proj, x)
    span = torch.clamp_min(proj.hi - proj.lo, 1e-6)
    c = (g - proj.lo) / span * grid_size
    top = torch.tensor(grid_size - 1e-3, dtype=torch.float32, device=c.device)
    return torch.minimum(torch.clamp_min(c, 0.0), top)


def to_cells(proj: Projection, x: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Integer cell indices (..., gd) int32 in [0, grid_size)."""
    return torch.floor(to_grid_coords(proj, x, grid_size)).to(torch.int32)
