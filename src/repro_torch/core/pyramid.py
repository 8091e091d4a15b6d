"""Circle counts from the mip pyramid — the paper's "zoom" made shape-static.

Port of `repro/core/pyramid.py`, batched: every function takes B queries.
Pick the pyramid level l where the circle's diameter fits a fixed T x T
tile, read ONE (T, T, C) window around the query, mask cell centers by the
circle, and sum.  Cost is O(T^2 * C) regardless of r and N — level
selection IS the zoom.  The hot loop reaches the same count through the
`radius_search_loop` kernel (core/batched.py); the functions here serve
the start-radius seed, the plain per-level count and the per-query
backend's Eq.-1 loop (`radius_search`, the `torch` backend).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import integral as integral_lib
from repro_torch.core.grid import GridConfig, GridIndex
from repro_torch.kernels import ref
from repro_torch.kernels.ref import eq1_ratio


def level_for_radius(r: torch.Tensor, cfg: GridConfig) -> torch.Tensor:
    """Smallest level whose T-cell window FULLY contains the circle (int32).

    The reference computes ceil(log2(max(2r / (T - 3), 1))) in float32.
    For the integer radii every caller passes, that is the smallest l with
    (T - 3) * 2**l >= 2r, which `ref.level_for_radius` evaluates in
    integers so that no device's log2 can move a level (tests check every
    r in [0, max_radius] against the reference)."""
    return ref.level_for_radius(r, cfg.tile, cfg.levels)


def _count_at_level(
    arr: torch.Tensor, level: int, q: torch.Tensor, r: torch.Tensor, cfg: GridConfig
) -> torch.Tensor:
    """Masked circle counts (B, C) from one pyramid level arr (S, S, C)."""
    t = cfg.tile
    s = arr.shape[0]
    scale = 1 << level
    qx, qy = q[:, 0], q[:, 1]
    cx = torch.floor(qx / scale).to(torch.int32)
    cy = torch.floor(qy / scale).to(torch.int32)
    ox = torch.clamp(cx - t // 2, 0, s - t)
    oy = torch.clamp(cy - t // 2, 0, s - t)
    ar = torch.arange(t, device=q.device)
    xs = (ox[:, None] + ar).long()                       # (B, T)
    ys = (oy[:, None] + ar).long()
    window = arr[xs[:, :, None], ys[:, None, :]]          # (B, T, T, C)

    # cell centers in base-pixel units
    arf = ar.to(torch.float32)
    ci = (ox[:, None] + arf + 0.5) * scale                # (B, T)
    cj = (oy[:, None] + arf + 0.5) * scale
    rf = r.to(torch.float32)[:, None, None]
    dx = (ci - qx[:, None])[:, :, None]
    dy = (cj - qy[:, None])[:, None, :]
    if cfg.metric == "l1":
        mask = dx.abs() + dy.abs() <= rf
    else:
        mask = dx * dx + dy * dy <= rf * rf
    return (window * mask[..., None]).sum(dim=(1, 2), dtype=torch.int32)


def count_in_circle(
    index: GridIndex, cfg: GridConfig, q: torch.Tensor, r: torch.Tensor
) -> torch.Tensor:
    """Per-class counts (B, C) of points whose pixel center lies within
    radius r (B,) of the continuous grid positions q (B, 2).

    counter="pyramid": one T x T window at level l(r) (L2/L1 mask).
    counter="sat": EXACT L-inf (square) count from the summed-area table."""
    if cfg.counter == "sat":
        return integral_lib.count_linf(index.sat, q, r)
    level = level_for_radius(r, cfg)
    out = torch.zeros((q.shape[0], cfg.n_channels), dtype=torch.int32, device=q.device)
    for lv, arr in enumerate(index.pyramid):
        sel = level == lv
        out = torch.where(sel[:, None], _count_at_level(arr, lv, q, r, cfg), out)
    return out


def count_total(
    index: GridIndex, cfg: GridConfig, q: torch.Tensor, r: torch.Tensor
) -> torch.Tensor:
    """Total circle counts (B,) int32 over every class channel."""
    return count_in_circle(index, cfg, q, r).sum(dim=-1, dtype=torch.int32)


def seed_radius(
    index: GridIndex, cfg: GridConfig, q: torch.Tensor, k: int
) -> torch.Tensor:
    """Per-query Eq.-1 start radii (B,) int32 from the pyramid's top levels.

    Probe the circle count at the largest window-contained radius of the
    top level (and of the level below it, whose finer probe wins whenever
    it already sees >= k points), then apply ONE Eq.-1 step.  Queries whose
    probes see no mass fall back to the global cfg.r0.  Changes only WHERE
    the radius loop starts, never what it returns.
    """
    b = q.shape[0]
    r_max = cfg.max_radius
    top = cfg.levels - 1

    def eq1_step(r_probe: int, n_probe: torch.Tensor) -> torch.Tensor:
        return torch.round(float(r_probe) * eq1_ratio(k, n_probe)).to(torch.int32)

    def probe(level: int, r_probe: int) -> torch.Tensor:
        rr = torch.full((b,), r_probe, dtype=torch.int32, device=q.device)
        return _count_at_level(index.pyramid[level], level, q, rr, cfg).sum(
            dim=-1, dtype=torch.int32
        )

    # largest radius whose circle is FULLY contained by the T-cell window at
    # level l (the level_for_radius margin, inverted): r = (T - 3) * 2**l / 2
    r1 = ((cfg.tile - 3) << top) // 2
    n1 = probe(top, r1)
    est = eq1_step(r1, n1)
    if top >= 1:
        r2 = ((cfg.tile - 3) << (top - 1)) // 2
        n2 = probe(top - 1, r2)
        est = torch.where(n2 >= k, eq1_step(r2, n2), est)
    return torch.where(
        n1 > 0, torch.clamp(est, 1, r_max), torch.full_like(est, cfg.r0)
    )


def radius_search(
    index: GridIndex, cfg: GridConfig, q: torch.Tensor, k: int,
    adaptive_r0: bool = False,
) -> dict[str, torch.Tensor]:
    """The paper's Eq. 1, r_{t+1} = round(r_t * sqrt(k / n_t)), for the
    queries q (B, 2): radius, count, iters and converged (B,), lane for
    lane what the reference's per-query `lax.while_loop` gives under vmap.

    The lanes run in lock step (`batched.lockstep_radius_loop`, unmasked:
    every lane counted each pass, finished lanes frozen, every lane
    recounted at its final radius).  Counts come from `count_in_circle`,
    the pyramid's T x T window or the summed-area table, never the
    flattened tiles, so this loop is an oracle of the `radius_search_loop`
    kernel independent of its tile layout.  adaptive_r0=True seeds the
    start radii with `seed_radius` instead of cfg.r0."""
    # imported here: core.batched imports this module
    from repro_torch.core.batched import lockstep_radius_loop

    if adaptive_r0:
        r0 = seed_radius(index, cfg, q, k)
    else:
        r0 = torch.full((q.shape[0],), cfg.r0, dtype=torch.int32, device=q.device)
    return lockstep_radius_loop(
        lambda r, _active: count_total(index, cfg, q, r), r0, k,
        max(k, math.ceil(k * cfg.k_slack)), cfg.max_radius, cfg.max_iters, masked=False,
    )
