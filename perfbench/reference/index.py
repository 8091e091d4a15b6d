"""The benchmark's plain reference, part 1: the grid index built from raw points.

The semantics of the port's plain PyTorch versions (`repro_torch/core/grid.py`,
`core/projection.py`, `kernels/ref.py::level_for_radius`, as of commit
edff663), written again here so that the yardstick does not move when the
program does.  It imports nothing of the program, of JAX or of the JAX
package: it works out again, from the points the benchmark made, everything
the program derives from them (projection, cells, pyramid).

The geometry is in float64 (`precision="float64"`): a point's grid
coordinates are its exact projection up to float64 rounding, not the
program's float32 summation order, so a point within a float32 rounding of
a cell edge may fall on the other side than in the program, and the check
counts the queries that this moves (`compare.py`).  The projection's matrix
is the configuration's: the top two eigenvectors of the float32 covariance,
as `torch.linalg.eigh` gives them, signs included (the program's
`pca_projection` takes them so too).

`precision="tf32"` is the control: every float32 input of a product is
rounded to TF32 (10 mantissa bits) first, products run with TF32 allowed,
and the geometry is float32, as a port that moved its arithmetic onto
TF32 would compute it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

PRECISIONS = ("float64", "tf32")


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """The grid of one configuration: the same fields and derived sizes as
    the program's `GridConfig` (copied, not imported)."""

    grid_size: int = 1024
    tile: int = 16
    n_classes: int = 0
    window: int = 32
    row_cap: int = 32
    r0: int = 100
    max_iters: int = 16
    k_slack: float = 1.0
    metric: str = "l2"
    counter: str = "pyramid"

    def __post_init__(self):
        if self.tile <= 3 or self.metric != "l2" or self.counter != "pyramid":
            raise ValueError(f"the reference covers tile > 3, l2 and the pyramid counter, "
                             f"got {self}")

    @property
    def n_channels(self) -> int:
        return max(self.n_classes, 1)

    @property
    def levels(self) -> int:
        return max(1, math.ceil(math.log2(max(self.grid_size, self.tile) / self.tile)) + 1)

    @property
    def padded_size(self) -> int:
        return self.tile * (1 << (self.levels - 1))

    @property
    def max_radius(self) -> int:
        return self.padded_size


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even): the 13 low
    mantissa bits cleared, as the tensor cores read their inputs."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def prepare(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (float32 as sent) in float64, or rounded to TF32 for the control."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    x = x.to(torch.float32)
    return round_tf32(x) if precision == "tf32" else x.to(torch.float64)


class Projection(NamedTuple):
    matrix: torch.Tensor  # (d, 2), in the precision's dtype
    lo: torch.Tensor      # (2,)
    hi: torch.Tensor      # (2,)


def _matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _extents(g: torch.Tensor, margin: float):
    lo, hi = g.amin(dim=0), g.amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-6)
    return lo - margin * span, hi + margin * span


def apply(proj: Projection, x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (n, d) projected to the grid plane, in the precision's arithmetic."""
    return _matmul(prepare(x, precision), proj.matrix, precision == "tf32")


def identity_projection(points: torch.Tensor, precision: str = "float64",
                        margin: float = 0.01) -> Projection:
    x = prepare(points, precision)
    mat = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return Projection(mat, *_extents(x, margin))


def pca_projection(points: torch.Tensor, precision: str = "float64",
                   margin: float = 0.01) -> Projection:
    """Top two principal directions of the points' float32 covariance."""
    tf32 = precision == "tf32"
    x = round_tf32(points.to(torch.float32)) if tf32 else points.to(torch.float32)
    xc = x - x.mean(dim=0, keepdim=True)
    cov = _matmul(xc.T, xc, tf32) / x.shape[0]
    _, vecs = torch.linalg.eigh(cov)
    mat = vecs[:, -2:].flip(1).contiguous()
    mat = round_tf32(mat) if tf32 else mat.to(torch.float64)
    proj = Projection(mat, mat.new_zeros(2), mat.new_ones(2))
    return Projection(mat, *_extents(apply(proj, points, precision), margin))


def make_projection(kind: str, points: torch.Tensor, precision: str = "float64") -> Projection:
    if kind == "pca":
        return pca_projection(points, precision)
    if kind == "identity":
        return identity_projection(points, precision)
    raise ValueError(f"unknown projection {kind!r}; expected 'pca' or 'identity'")


def to_grid_coords(proj: Projection, x: torch.Tensor, grid_size: int,
                   precision: str = "float64", rows: int = 1 << 16) -> torch.Tensor:
    """Continuous grid coordinates in [0, grid_size - 1e-3] per grid dim."""
    span = torch.clamp_min(proj.hi - proj.lo, 1e-6)
    out = []
    for blk in x.reshape(-1, x.shape[-1]).split(rows):
        c = (apply(proj, blk, precision) - proj.lo) / span * grid_size
        out.append(torch.clamp(c, 0.0, grid_size - 1e-3))
    return torch.cat(out) if out else proj.lo.new_zeros((0, 2))


class Index(NamedTuple):
    proj: Projection
    precision: str
    points: torch.Tensor   # (N, d) CSR order, in the precision's dtype
    coords: torch.Tensor   # (N, 2)
    labels: torch.Tensor   # (N,) int32
    ids: torch.Tensor      # (N,) int32
    offsets: torch.Tensor  # (G*G + 1,) int32
    pyramid: tuple         # level l: (S_l, S_l, C) int32


def build_index(points: torch.Tensor, cfg: GridConfig, proj: Projection,
                labels: torch.Tensor | None = None, ids: torch.Tensor | None = None,
                precision: str = "float64") -> Index:
    """CSR buckets in row-major cell order (stable: arrival order within a
    cell) and the count pyramid."""
    n, dev, g = points.shape[0], points.device, cfg.padded_size
    coords = to_grid_coords(proj, points, cfg.grid_size, precision)
    cell = torch.floor(coords).to(torch.int32)
    cid = cell[:, 0] * g + cell[:, 1]
    order = torch.argsort(cid, stable=True)
    offsets = torch.searchsorted(cid[order], torch.arange(g * g + 1, dtype=torch.int32,
                                                          device=dev), side="left")
    if labels is None:
        labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=dev)
    labels, ids = labels.to(dev, torch.int32), ids.to(dev, torch.int32)
    c = cfg.n_channels
    chan = labels if cfg.n_classes > 0 else torch.zeros_like(labels)
    base = torch.bincount(cid.long() * c + chan.long(), minlength=g * g * c)
    level = base.to(torch.int32).reshape(g, g, c)
    pyramid = [level]
    for _ in range(cfg.levels - 1):
        s = level.shape[0] // 2
        level = level.reshape(s, 2, s, 2, c).sum(dim=(1, 3), dtype=torch.int32)
        pyramid.append(level)
    return Index(proj, precision, prepare(points[order], precision), coords[order], labels[order],
                 ids[order], offsets.to(torch.int32), tuple(pyramid))
