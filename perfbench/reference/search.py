"""The benchmark's plain reference, part 2: active search over a reference index.

The semantics of the port's per-query pipeline in plain PyTorch (the `torch`
backend: `repro_torch/core/active_search.py::_search_torch`,
`core/pyramid.py::radius_search` / `count_in_circle`,
`core/batched.py::lockstep_radius_loop`, `kernels/ref.py::eq1_ratio` /
`smallest_k` / `window_slots`, as of commit edff663), in the index's
precision: float64 for the reference, TF32-rounded float32 for the
control.  Counts come from the pyramid's T x T window around each query,
never from the program's tile layout; the candidates are the window's CSR
rows; the ranking is the L2 distance in the original space.  Every lane is
computed as alone, so a block of queries gives the rows the whole batch
would.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.index import GridConfig, Index, prepare, to_grid_coords

FIELDS = ("ids", "dists", "labels", "valid", "radius", "count", "iters", "converged",
          "truncated")


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in x's dtype (the float64 root rounded)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def level_for_radius(r: torch.Tensor, cfg: GridConfig) -> torch.Tensor:
    """Smallest level l with (T - 3) * 2**l >= 2r, in integers."""
    two_r = 2 * r.to(torch.int64)
    level = torch.zeros_like(two_r)
    for j in range(cfg.levels - 1):
        level += ((cfg.tile - 3) << j) < two_r
    return level.to(torch.int32)


def _count_at_level(arr, level: int, q, r, cfg: GridConfig) -> torch.Tensor:
    t, s, scale = cfg.tile, arr.shape[0], 1 << level
    qx, qy = q[:, 0], q[:, 1]
    ox = torch.clamp(torch.floor(qx / scale).to(torch.int32) - t // 2, 0, s - t)
    oy = torch.clamp(torch.floor(qy / scale).to(torch.int32) - t // 2, 0, s - t)
    ar = torch.arange(t, device=q.device)
    xs, ys = (ox[:, None] + ar).long(), (oy[:, None] + ar).long()
    window = arr[xs[:, :, None], ys[:, None, :]]
    arf = ar.to(q.dtype)
    ci = (ox[:, None] + arf + 0.5) * scale
    cj = (oy[:, None] + arf + 0.5) * scale
    rf = r.to(q.dtype)[:, None, None]
    dx, dy = (ci - qx[:, None])[:, :, None], (cj - qy[:, None])[:, None, :]
    mask = dx * dx + dy * dy <= rf * rf
    return (window * mask[..., None]).sum(dim=(1, 2), dtype=torch.int32)


def count_total(index: Index, cfg: GridConfig, q, r) -> torch.Tensor:
    """Points (B,) whose pixel centre lies within radius r of q, read at the
    pyramid level where the circle fits one T x T window."""
    level = level_for_radius(r, cfg)
    out = torch.zeros((q.shape[0], cfg.n_channels), dtype=torch.int32, device=q.device)
    for lv, arr in enumerate(index.pyramid):
        out = torch.where((level == lv)[:, None], _count_at_level(arr, lv, q, r, cfg), out)
    return out.sum(dim=-1, dtype=torch.int32)


def eq1_ratio(k: int, n: torch.Tensor, dtype) -> torch.Tensor:
    nf = torch.clamp_min(n, 1).to(dtype)
    return sqrt_rn(torch.full_like(nf, float(k)) / nf)


def radius_loop(index: Index, cfg: GridConfig, q, k: int) -> dict:
    """Eq. 1, r <- round(r * sqrt(k / n)), every lane counted each pass,
    finished lanes frozen, every lane recounted at its final radius."""
    b, dev = q.shape[0], q.device
    k_hi, r_max = max(k, math.ceil(k * cfg.k_slack)), cfg.max_radius
    i32 = dict(dtype=torch.int32, device=dev)
    r = torch.full((b,), cfg.r0, **i32)
    t = torch.zeros((b,), **i32)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    best = torch.full((b,), r_max + 1, **i32)
    while True:
        active = (t < cfg.max_iters) & ~done
        if not bool(active.any()):
            break
        n = count_total(index, cfg, q, r)
        hit = (n >= k) & (n <= k_hi)
        best_new = torch.where(n >= k, torch.minimum(best, r), best)
        r_new = torch.round(r.to(q.dtype) * eq1_ratio(k, n, q.dtype)).to(torch.int32)
        r_new = torch.clamp(torch.where(n == 0, r * 2, r_new), 1, r_max)
        step = torch.where(n < k, 1, -1).to(torch.int32)
        r_new = torch.where((r_new == r) & ~hit, r + step, r_new)
        r_next = torch.where(hit, r, torch.clamp(r_new, 1, r_max))
        t = torch.where(active, t + 1, t)
        r = torch.where(active, r_next, r)
        done = torch.where(active, hit, done)
        best = torch.where(active, best_new, best)
    r_final = torch.where(done, r, torch.where(best <= r_max, best, torch.full_like(best, r_max)))
    return {"radius": r_final, "count": count_total(index, cfg, q, r_final), "iters": t,
            "converged": done}


def window_spans(index: Index, cfg: GridConfig, q_grid):
    """CSR [start, end) (B, w) of the w window rows around each query cell."""
    g, w = cfg.padded_size, cfg.window
    x0 = torch.clamp(torch.floor(q_grid[:, 0]).to(torch.int64) - w // 2, 0, g - w)
    y0 = torch.clamp(torch.floor(q_grid[:, 1]).to(torch.int64) - w // 2, 0, g - w)
    rows = x0[:, None] + torch.arange(w, device=q_grid.device)
    return index.offsets[rows * g + y0[:, None]], index.offsets[rows * g + y0[:, None] + w]


def window_slots(start, end, n: int, row_cap: int):
    """CSR row (B, w*row_cap) of every window slot and whether it is valid:
    row i covers row_cap rows from its span start clamped to [0, n_pad -
    row_cap], where the store is padded to at least row_cap rows."""
    b, w = start.shape
    n_pad = max(n, row_cap)
    s_cl = torch.clamp(start.to(torch.int64), 0, max(n_pad - row_cap, 0))
    j = s_cl[:, :, None] + torch.arange(row_cap, device=start.device)
    ok = (j >= start[:, :, None]) & (j < end[:, :, None]) & (j < n)
    return j.reshape(b, w * row_cap), ok.reshape(b, w * row_cap)


def smallest_k(dist: torch.Tensor, k: int):
    b, c = dist.shape
    k_eff = min(k, c)
    order = torch.sort(dist, dim=1, stable=True).indices[:, :k_eff]
    dists = torch.gather(dist, 1, order)
    if k_eff < k:
        dists = torch.cat([dists, dists.new_full((b, k - k_eff), float("inf"))], dim=1)
        order = torch.cat([order, order.new_full((b, k - k_eff), -1)], dim=1)
    return dists, torch.where(torch.isfinite(dists), order, torch.full_like(order, -1))


def search(index: Index, cfg: GridConfig, queries: torch.Tensor, k: int) -> dict:
    """The refined search result of a block of queries, field by field
    (FIELDS): the window's candidates ranked by L2 distance in the
    original space, in the index's precision."""
    q = prepare(queries, index.precision)
    q_grid = to_grid_coords(index.proj, queries, cfg.grid_size, index.precision)
    out = radius_loop(index, cfg, q_grid, k)
    r = out["radius"]
    start, end = window_spans(index, cfg, q_grid)
    out["truncated"] = ((2 * r + 1) > cfg.window) | torch.any(end - start > cfg.row_cap, dim=-1)
    n = index.points.shape[0]
    rows, valid = window_slots(start, end, n, cfg.row_cap)
    safe = torch.clamp(rows, 0, max(n - 1, 0))
    diff = index.points[safe] - q[:, None, :]
    dist = sqrt_rn(torch.clamp_min((diff * diff).sum(dim=-1), 0.0))
    dists, slots = smallest_k(torch.where(valid, dist, torch.full_like(dist, float("inf"))), k)
    sel = torch.isfinite(dists)
    pick = torch.gather(safe, 1, torch.clamp_min(slots, 0))
    none = torch.full(pick.shape, -1, dtype=torch.int32, device=pick.device)
    out.update(ids=torch.where(sel, index.ids[pick], none), dists=dists,
               labels=torch.where(sel, index.labels[pick], none), valid=sel)
    return out


def search_blocked(index: Index, cfg: GridConfig, queries, k: int,
                   block_bytes: int = 4 << 30) -> dict:
    """`search` over blocks of queries sized so that a block's gathered
    candidates and their temporaries stay near `block_bytes`; the fields
    concatenated, on the host."""
    item = index.points.element_size()
    per_query = cfg.window * cfg.row_cap * (index.points.shape[1] + 2) * item * 3
    per = max(1, block_bytes // per_query)
    parts = [search(index, cfg, blk, k) for blk in queries.split(per)]
    return {f: torch.cat([p[f].cpu() for p in parts]) for f in FIELDS}
