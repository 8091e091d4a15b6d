"""GridIndex: the paper's "image" of the data set, built with sorts.

Port of `repro/core/grid.py`.  The paper rasterizes N points onto a G x G
image whose pixels hold point counts (one image per class for
classification).  The index keeps that structure, built by sort-based
bucketization:

  cell_id = quantize(project(x));  order = stable_argsort(cell_id);
  offsets = searchsorted(cell_id[order], arange(G*G + 1))

which yields a CSR layout: points of cell c are `points_sorted[offsets[c] :
offsets[c + 1]]`.  Base-level counts are `diff(offsets)`; a count PYRAMID
(mip chain) on top gives O(1) circle counts at any radius (pyramid.py).

Stored arrays keep the reference's dtypes (float32 / int32); indices are
widened to int64 only where they index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import integral as integral_lib
from repro_torch.core import projection as proj_lib
from repro_torch.core.projection import Projection


def resolve_device(device=None) -> torch.device:
    """`device=None` means the card; a CUDA device without a card raises
    (the port never carries on quietly on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU through the kernels' plain versions"
        )
    return dev


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array (copied) or tensor as a `dtype` tensor on `device`."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return torch.as_tensor(x).to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static configuration of a grid index (hashable)."""

    grid_size: int = 1024        # requested G (paper: 3000)
    tile: int = 16               # pyramid tile side T checked per count
    n_classes: int = 0           # 0 = unlabeled (single count channel)
    window: int = 32             # candidate-gather window side (base cells)
    row_cap: int = 32            # max candidates gathered per window row
    r0: int = 100                # paper's initial radius (pixels)
    max_iters: int = 16          # Eq.-1 iteration cap
    k_slack: float = 1.0         # accept n in [k, k_slack * k]; 1.0 = paper-exact
    metric: str = "l2"           # "l2" | "l1" (paper discusses both)
    counter: str = "pyramid"     # "pyramid" | "sat" (exact L-inf counts, integral.py)

    def __post_init__(self):
        # level_for_radius picks the level where a T-cell window contains the
        # circle via 2**l >= 2r / (tile - 3); tile <= 3 leaves no margin.
        if self.tile <= 3:
            raise ValueError(
                f"tile={self.tile} is too small: the pyramid window needs a "
                "positive containment margin (tile/2 - 1.5), so tile must "
                "be >= 4"
            )
        if self.metric not in ("l2", "l1"):
            raise ValueError(
                f"unknown metric {self.metric!r}; expected 'l2' or 'l1'"
            )
        if self.counter not in ("pyramid", "sat"):
            raise ValueError(
                f"unknown counter {self.counter!r}; expected 'pyramid' or 'sat'"
            )
        if self.r0 <= 0:
            raise ValueError(
                f"r0={self.r0} must be a positive start radius (pixels)"
            )
        if self.r0 > self.max_radius:
            raise ValueError(
                f"r0={self.r0} exceeds max_radius={self.max_radius} (the "
                f"largest radius countable from the top pyramid tile for "
                f"grid_size={self.grid_size}, tile={self.tile})"
            )

    @property
    def n_channels(self) -> int:
        return max(self.n_classes, 1)

    @property
    def levels(self) -> int:
        """Number of pyramid levels so the TOP level is exactly `tile` wide."""
        return max(1, math.ceil(math.log2(max(self.grid_size, self.tile) / self.tile)) + 1)

    @property
    def padded_size(self) -> int:
        """G padded so padded_size == tile * 2**(levels-1) (clean mip chain)."""
        return self.tile * (1 << (self.levels - 1))

    @property
    def max_radius(self) -> int:
        """Any radius up to this is countable from the top pyramid tile."""
        return self.padded_size

    @property
    def max_candidates(self) -> int:
        return self.window * self.row_cap

    @property
    def level_nblks(self) -> tuple[int, ...]:
        """Per-level T-block counts S_l // tile — static layout of the
        flattened tile array read by the radius_search_loop and
        tile_count_multilevel kernels."""
        return tuple(1 << (self.levels - 1 - l) for l in range(self.levels))


class GridIndex(NamedTuple):
    """The built index: tensors on one device."""

    proj: Projection
    points_sorted: torch.Tensor  # (N, d) float32 — original points, CSR order
    coords_sorted: torch.Tensor  # (N, 2) float32 — continuous grid coords, CSR order
    labels_sorted: torch.Tensor  # (N,) int32 — class label (or 0), CSR order
    ids_sorted: torch.Tensor     # (N,) int32 — original (or global) point index
    offsets: torch.Tensor        # (padded_size**2 + 1,) int32 CSR cell offsets
    pyramid: tuple[torch.Tensor, ...]  # level l: (S_l, S_l, C) int32
    sat: torch.Tensor | None = None    # (S+1, S+1, C) summed-area table (counter="sat")
    pyr_tiles: torch.Tensor | None = None  # (sum_l nblk_l^2, T, T, C) int32

    @property
    def n_points(self) -> int:
        return self.points_sorted.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points_sorted.device

    def to(self, device) -> "GridIndex":
        """The same index with every tensor on `device`."""
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return GridIndex(
            proj=self.proj.to(device),
            points_sorted=move(self.points_sorted),
            coords_sorted=move(self.coords_sorted),
            labels_sorted=move(self.labels_sorted),
            ids_sorted=move(self.ids_sorted),
            offsets=move(self.offsets),
            pyramid=tuple(move(a) for a in self.pyramid),
            sat=move(self.sat),
            pyr_tiles=move(self.pyr_tiles),
        )


def cell_id_of(coords: torch.Tensor, padded_size: int) -> torch.Tensor:
    """Row-major flat cell id (int32) from continuous grid coords (..., 2)."""
    cell = torch.floor(coords).to(torch.int32)
    return cell[..., 0] * padded_size + cell[..., 1]


def build_pyramid(base: torch.Tensor, levels: int) -> tuple[torch.Tensor, ...]:
    """Mip chain of count sums.  base: (S, S, C) int32, S = tile * 2**(levels-1)."""
    out = [base]
    cur = base
    for _ in range(levels - 1):
        s = cur.shape[0] // 2
        cur = cur.reshape(s, 2, s, 2, cur.shape[-1]).sum(dim=(1, 3), dtype=torch.int32)
        out.append(cur)
    return tuple(out)


def flatten_pyramid_tiles(pyramid: tuple[torch.Tensor, ...], tile: int) -> torch.Tensor:
    """Flatten a mip chain into one (sum_l nblk_l^2, T, T, C) tile array.

    Level l's (S_l, S_l, C) image becomes nblk_l^2 row-major (T, T, C)
    tiles (nblk_l = S_l // T); levels are concatenated in order, so tile
    (bx, by) of level l lives at row offset_l + bx * nblk_l + by.
    """
    blocks = []
    for arr in pyramid:
        s, _, c = arr.shape
        nb = s // tile
        blocks.append(
            arr.reshape(nb, tile, nb, tile, c)
            .permute(0, 2, 1, 3, 4)
            .reshape(nb * nb, tile, tile, c)
        )
    return torch.cat(blocks, dim=0).contiguous()


def build_index(
    points: torch.Tensor,
    cfg: GridConfig,
    proj: Projection,
    labels: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
) -> GridIndex:
    """Build the paper's image + CSR buckets + count pyramid on the points'
    device.  `ids` lets a shard record GLOBAL point indices."""
    n = points.shape[0]
    dev = points.device
    g = cfg.padded_size
    coords = proj_lib.to_grid_coords(proj, points, cfg.grid_size)  # in [0, grid_size)
    cid = cell_id_of(coords, g)

    order = torch.argsort(cid, stable=True)
    cid_sorted = cid[order]
    offsets = torch.searchsorted(
        cid_sorted, torch.arange(g * g + 1, dtype=torch.int32, device=dev),
        side="left",
    ).to(torch.int32)

    if labels is None:
        labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=dev)
    labels = labels.to(device=dev, dtype=torch.int32)
    ids = ids.to(device=dev, dtype=torch.int32)

    c = cfg.n_channels
    chan = labels if cfg.n_classes > 0 else torch.zeros_like(labels)
    flat = cid.long() * c + chan.long()
    base = torch.bincount(flat, minlength=g * g * c).to(torch.int32)
    base = base.reshape(g, g, c)
    pyramid = build_pyramid(base, cfg.levels)

    return GridIndex(
        proj=proj,
        points_sorted=points[order].to(torch.float32),
        coords_sorted=coords[order].to(torch.float32),
        labels_sorted=labels[order],
        ids_sorted=ids[order],
        offsets=offsets,
        pyramid=pyramid,
        sat=integral_lib.build_sat(base) if cfg.counter == "sat" else None,
        pyr_tiles=(
            flatten_pyramid_tiles(pyramid, cfg.tile)
            if cfg.counter == "pyramid" else None
        ),
    )


def base_counts(index: GridIndex) -> torch.Tensor:
    """(S, S) total base-level counts (sum over class channels)."""
    return index.pyramid[0].sum(dim=-1, dtype=torch.int32)


def validate_invariants(index: GridIndex, cfg: GridConfig) -> dict[str, bool]:
    """Cheap structural invariants of a built index."""
    n = index.n_points
    offs = index.offsets
    cid = cell_id_of(index.coords_sorted, cfg.padded_size)
    chain_ok = all(
        bool(torch.equal(build_pyramid(index.pyramid[lv], 2)[1], index.pyramid[lv + 1]))
        for lv in range(len(index.pyramid) - 1)
    )
    tiles_ok = index.pyr_tiles is None or bool(
        torch.equal(index.pyr_tiles, flatten_pyramid_tiles(index.pyramid, cfg.tile))
    )
    return {
        "offsets_end_is_n": int(offs[-1]) == n,
        "offsets_monotone": bool(torch.all(offs[1:] >= offs[:-1])),
        "pyramid_mass_is_n": all(int(level.sum()) == n for level in index.pyramid),
        "cells_sorted": bool(torch.all(cid[1:] >= cid[:-1])),
        "base_matches_offsets": bool(torch.equal(
            base_counts(index).reshape(-1), offs[1:] - offs[:-1]
        )),
        "pyramid_chain_consistent": chain_ok,
        "tiles_match_pyramid": tiles_ok,
    }
