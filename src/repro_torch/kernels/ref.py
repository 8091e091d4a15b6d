"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Mirrors `repro/kernels/ref.py`.  Each function computes exactly what its
Hopper kernel computes; `ops.py` runs these for tensors on the CPU, the
tests hold them against the JAX package, and `chip_smoke.py` holds each
kernel against its plain version on the card.  They also carry the
argument checks that the kernel wrappers share.
"""

from __future__ import annotations

import torch

from repro_torch.core.projection import matmul_f32


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's vectorized CPU sqrt can miss the correctly rounded float32
    result by an ulp; CUDA's sqrtf, XLA's and the kernels' do not.  The
    float64 root rounded to float32 is the correctly rounded one (53 bits
    leave room for the double rounding)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def level_tile_offsets(nblks: tuple[int, ...]) -> tuple[int, ...]:
    """Start row of each level in the flattened tile array."""
    offs, acc = [], 0
    for nb in nblks:
        offs.append(acc)
        acc += nb * nb
    return tuple(offs)


def check_tile_layout(tiles: torch.Tensor, tile: int, nblks: tuple[int, ...]) -> None:
    nb_total = sum(nb * nb for nb in nblks)
    if tiles.ndim != 4 or tiles.shape[0] != nb_total or tuple(tiles.shape[1:3]) != (tile, tile):
        raise ValueError(
            f"tiles shape {tuple(tiles.shape)} does not match nblks={nblks}, tile={tile}"
        )


def check_csr_args(store, starts, ends, queries, row_cap, radii) -> None:
    n_pad, d = store.shape
    b, w = starts.shape
    if n_pad < row_cap:
        raise ValueError(
            f"store has {n_pad} rows but row_cap={row_cap}; pad the store "
            f"(active_search.padded_csr) so every span slice is in bounds"
        )
    if tuple(ends.shape) != (b, w):
        raise ValueError(f"ends shape {tuple(ends.shape)} != starts {(b, w)}")
    if tuple(queries.shape) != (b, d):
        raise ValueError(
            f"queries shape {tuple(queries.shape)} does not match spans batch "
            f"{b} x store dim {d}"
        )
    if radii is not None and tuple(radii.shape) != (b,):
        raise ValueError(
            f"radii shape {tuple(radii.shape)} does not match spans batch ({b},)"
        )


def check_dense_args(candidates, valid, queries) -> None:
    b, c, d = candidates.shape
    if tuple(valid.shape) != (b, c):
        raise ValueError(f"valid shape {tuple(valid.shape)} != candidates {(b, c)}")
    if tuple(queries.shape) != (b, d):
        raise ValueError(
            f"queries shape {tuple(queries.shape)} does not match candidates "
            f"batch {b} x dim {d}"
        )


def check_q8_args(q_store, row_scales, starts, ends, queries, rerank_k, row_cap) -> None:
    n_pad = q_store.shape[0]
    w = starts.shape[1]
    if q_store.dtype != torch.int8:
        raise ValueError(f"q_store must be int8, got {q_store.dtype}")
    if tuple(row_scales.shape) != (n_pad, 1):
        raise ValueError(
            f"row_scales shape {tuple(row_scales.shape)} != ({n_pad}, 1); one "
            f"scale per padded CSR row (core/quantized.py)"
        )
    check_csr_args(q_store, starts, ends, queries, row_cap, None)
    if not 1 <= rerank_k <= w * row_cap:
        raise ValueError(
            f"rerank_k={rerank_k} must be in [1, window*row_cap = "
            f"{w * row_cap}] (the shortlist is drawn from one window)"
        )


def d_chunks(d: int, d_chunk: int | None) -> list[tuple[int, int]]:
    """(start, width) of each feature-dim block the distance sums over."""
    dc = d if d_chunk is None else max(1, min(d_chunk, d))
    return [(c0, min(dc, d - c0)) for c0 in range(0, d, dc)]


# q8 query codes are clipped to +/-QCLIP cell-ranges; with diff bounded by
# QCLIP + 127, a chunk of Q8_MAX_CHUNK dims sums |diff|^2 in int32 with ~3x
# headroom: 512 * (1023 + 127)^2 < 2^31.  Copies of the reference's
# constants (repro/kernels/csr_candidate_topk_q8.py).
QCLIP = 1023
Q8_MAX_CHUNK = 512


def q8_d_chunks(d: int, d_chunk: int | None) -> list[tuple[int, int]]:
    """(start, width) of each int32 accumulation chunk of a q8 score: the
    chunk is always capped at Q8_MAX_CHUNK (the overflow bound), and
    d_chunk only tightens it."""
    dc = min(d if d_chunk is None else max(1, min(d_chunk, d)), Q8_MAX_CHUNK)
    return [(c0, min(dc, d - c0)) for c0 in range(0, d, dc)]


def _circle_mask(ci, cj, qx, qy, r, metric):
    """Cell centers (ci, cj) inside the circle around (qx, qy); float32."""
    dx = ci - qx
    dy = cj - qy
    if metric == "l1":
        return dx.abs() + dy.abs() <= r
    return dx * dx + dy * dy <= r * r


def tile_count(
    level_arr: torch.Tensor,  # (S, S, C) int32 — one pyramid level
    queries: torch.Tensor,    # (B, 2) float32 — positions in BASE-pixel units
    radii: torch.Tensor,      # (B,) float32 — radii in base-pixel units
    scale: int,               # 2**level
    tile: int,                # T — window side in level cells
    metric: str = "l2",
) -> torch.Tensor:
    """Circle-masked counts (B, C) from one level: count of points whose
    level-cell center lies within radius of the query, over the clamped
    T x T window.  Matches pyramid._count_at_level."""
    s = level_arr.shape[0]
    q = queries.to(torch.float32)
    r = radii.to(torch.float32)
    cx = torch.floor(q[:, 0] / scale).to(torch.int64)
    cy = torch.floor(q[:, 1] / scale).to(torch.int64)
    ox = torch.clamp(cx - tile // 2, 0, s - tile)
    oy = torch.clamp(cy - tile // 2, 0, s - tile)
    ar = torch.arange(tile, device=q.device)
    xs = ox[:, None] + ar                                   # (B, T)
    ys = oy[:, None] + ar
    window = level_arr[xs[:, :, None], ys[:, None, :]]      # (B, T, T, C)
    ci = (xs.to(torch.float32) + 0.5) * scale
    cj = (ys.to(torch.float32) + 0.5) * scale
    mask = _circle_mask(ci[:, :, None], cj[:, None, :], q[:, 0, None, None],
                        q[:, 1, None, None], r[:, None, None], metric)
    return (window * mask[..., None]).sum(dim=(1, 2), dtype=torch.int32)


def tile_count_multilevel(
    tiles: torch.Tensor,     # (sum_l nblk_l^2, T, T, C) int32 flattened pyramid
    queries: torch.Tensor,   # (B, 2) float32, base-pixel units
    radii: torch.Tensor,     # (B,) float32, base-pixel units
    levels: torch.Tensor,    # (B,) int32 pyramid level per query
    tile: int,
    nblks: tuple[int, ...],  # per-level block counts S_l // T
    metric: str = "l2",
    active: torch.Tensor | None = None,  # (B,) bool lane mask (None = all live)
) -> torch.Tensor:
    """Level-scheduled counts (B, C): each query counted at its OWN level.

    Reads each query's clamped T x T window at its level straight from the
    flattened tile layout (tile off_l + (x//T)*nblk_l + (y//T), in-tile
    (x%T, y%T)), masks by the circle and sums.  Parked lanes (active False)
    give 0."""
    check_tile_layout(tiles, tile, nblks)
    dev = queries.device
    nblk_tab = torch.tensor(nblks, dtype=torch.int64, device=dev)
    off_tab = torch.tensor(level_tile_offsets(nblks), dtype=torch.int64, device=dev)

    lv = torch.clamp(levels.to(torch.int64), 0, len(nblks) - 1)
    nblk = nblk_tab[lv]                                     # (B,)
    scale = (1 << lv).to(torch.float32)
    q = queries.to(torch.float32)
    r = radii.to(torch.float32)
    s_l = nblk * tile
    cx = torch.floor(q[:, 0] / scale).to(torch.int64)
    cy = torch.floor(q[:, 1] / scale).to(torch.int64)
    ox = torch.minimum(torch.clamp_min(cx - tile // 2, 0), s_l - tile)
    oy = torch.minimum(torch.clamp_min(cy - tile // 2, 0), s_l - tile)
    ar = torch.arange(tile, device=dev)
    xs = (ox[:, None] + ar)[:, :, None]                     # (B, T, 1)
    ys = (oy[:, None] + ar)[:, None, :]                     # (B, 1, T)
    tid = off_tab[lv][:, None, None] + (xs // tile) * nblk[:, None, None] + ys // tile
    vals = tiles[tid, xs % tile, ys % tile]                 # (B, T, T, C)

    sc = scale[:, None, None]
    mask = _circle_mask((xs.to(torch.float32) + 0.5) * sc,
                        (ys.to(torch.float32) + 0.5) * sc,
                        q[:, 0, None, None], q[:, 1, None, None],
                        r[:, None, None], metric)
    out = (vals * mask[..., None]).sum(dim=(1, 2), dtype=torch.int32)
    if active is not None:
        out = torch.where(active[:, None], out, torch.zeros_like(out))
    return out


def level_for_radius(r: torch.Tensor, tile: int, n_levels: int) -> torch.Tensor:
    """Smallest pyramid level whose T-cell window FULLY contains the circle
    of integer radius r (int32): the smallest l with (T - 3) * 2**l >= 2r,
    at most n_levels - 1, in integers (the reference's float32
    ceil(log2(...)) gives the same level for every integer radius)."""
    if r.is_floating_point():
        raise TypeError("level_for_radius takes integer radii (pixels)")
    two_r = 2 * r.to(torch.int64)
    level = torch.zeros_like(two_r)
    for j in range(n_levels - 1):
        level += ((tile - 3) << j) < two_r
    return level.to(torch.int32)


def eq1_ratio(k: int, n: torch.Tensor) -> torch.Tensor:
    """sqrt(k / max(n, 1)) in float32, the factor of Eq. 1.

    Both steps round as the reference's do: the division is tensor by
    tensor (`k / tensor` in PyTorch multiplies by a rounded reciprocal) and
    the root is correctly rounded (`sqrt_rn`); an ulp here can move a
    rounded radius."""
    nf = torch.clamp_min(n, 1).to(torch.float32)
    return sqrt_rn(torch.full_like(nf, float(k)) / nf)


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
    """The Eq.-1 loop on the pyramid counter, the whole batch in lock step:
    each pass is one `tile_count_multilevel` over every lane at its own
    radius's level, parked lanes masked when `early_exit` (the reference's
    schedule; `early_exit=False` counts every lane every pass and gives
    the same radius, count, iters and converged).  The schedule is
    core/batched.py's `lockstep_radius_loop`, which owns Eq. 1.

    Returns radius, count, iters, converged and, as the reference's loop
    does, `tile_dmas_skipped`: the 2x2-cover tile loads its TPU kernel
    elides, counted pass by pass here, 4 per lane a masked count leaves
    out (0 when `early_exit` is False).  `ops.radius_search_loop` returns
    the first four alone, as the kernel does; `dmas_skipped` gives the
    count from them."""
    # imported here: core.batched imports this module
    from repro_torch.core.batched import lockstep_radius_loop

    check_tile_layout(tiles, tile, nblks)
    skipped = torch.zeros((), dtype=torch.int32, device=queries.device)

    def count(r, active):
        nonlocal skipped
        if active is not None:
            skipped = skipped + 4 * (~active).sum(dtype=torch.int32)
        levels = level_for_radius(r, tile, len(nblks))
        return tile_count_multilevel(
            tiles, queries, r.to(torch.float32), levels, tile, nblks, metric=metric,
            active=active,
        ).sum(dim=-1, dtype=torch.int32)

    out = lockstep_radius_loop(count, r0, k, k_hi, r_max, max_iters, masked=early_exit)
    return {**out, "tile_dmas_skipped": skipped}


def dmas_skipped(iters: torch.Tensor, converged: torch.Tensor, early_exit: bool = True
                 ) -> torch.Tensor:
    """The reference's `tile_dmas_skipped` (int32 scalar) from the loop's
    per-lane outputs: its lock-step loop runs max(iters) passes, and lane
    b is parked in max(iters) - iters[b] of them and skips its recount
    when it converged, 4 tile loads each:
    4 * (B * max(iters) - sum(iters)) + 4 * sum(converged), or 0 when
    `early_exit` is False (the unmasked schedule skips nothing)."""
    zero = torch.zeros((), dtype=torch.int32, device=iters.device)
    if not early_exit or iters.numel() == 0:
        return zero
    parked = iters.shape[0] * iters.max() - iters.sum(dtype=torch.int32)
    return (4 * (parked + converged.sum(dtype=torch.int32))).to(torch.int32)


def window_slots(starts, ends, n_pad: int, n: int, row_cap: int):
    """Global CSR row of every window slot, and whether it is valid.

    Window row i covers the row_cap store rows from its span start clamped
    to [0, n_pad - row_cap]; slot (i, t) is valid when its row lies in
    [starts[:, i], ends[:, i]) and below the live count n.  Returns flat
    (B, w*row_cap) int64 rows and the (B, w*row_cap) bool mask, row-major
    (the candidate order every kernel ranks in)."""
    b, w = starts.shape
    s_cl = torch.clamp(starts.to(torch.int64), 0, max(n_pad - row_cap, 0))
    j = s_cl[:, :, None] + torch.arange(row_cap, device=starts.device)  # (B, w, cap)
    ok = (j >= starts[:, :, None]) & (j < ends[:, :, None]) & (j < n)
    return j.reshape(b, w * row_cap), ok.reshape(b, w * row_cap)


def window_runs(starts, ends, n_pad: int, n: int, row_cap: int):
    """Each window row's run of valid slots, as csr_candidate_topk.cu scans
    them.  Window row i covers the row_cap store rows from its clamped start
    cs (window_slots); its valid rows are one run, [max(cs, start),
    min(cs + row_cap, end, n)).  Returns (B, w) int64 `lo`, the run's first
    slot within its row, and `length`, and the (B, w + 1) int64 exclusive
    prefix of the lengths, whose last column is V, the window's valid slots."""
    st, en = starts.to(torch.int64), ends.to(torch.int64)
    cs = torch.clamp(st, 0, max(n_pad - row_cap, 0))
    first = torch.maximum(cs, st)
    last = torch.minimum(torch.minimum(cs + row_cap, en), torch.full_like(en, n))
    length = torch.clamp_min(last - first, 0)
    prefix = torch.nn.functional.pad(torch.cumsum(length, dim=1), (1, 0))
    return first - cs, length, prefix


def chunked_distance(
    cand: torch.Tensor,     # (B, C, d) float32
    queries: torch.Tensor,  # (B, d) float32
    metric: str,
    d_chunk: int | None,
) -> torch.Tensor:
    """l1 / l2 distances (B, C): summed per `d_chunk` block, then across
    blocks in order, as the kernels sum (csrc/kernel_common.cuh).  Every
    float32 candidate ranking of this module goes through it, so two plain
    versions given the same row give the same float."""
    diff = cand - queries[:, None, :].to(torch.float32)
    acc = None
    for c0, dc in d_chunks(cand.shape[-1], d_chunk):
        part = diff[:, :, c0:c0 + dc]
        s = part.abs().sum(dim=-1) if metric == "l1" else (part * part).sum(dim=-1)
        acc = s if acc is None else acc + s
    return acc if metric == "l1" else sqrt_rn(torch.clamp_min(acc, 0.0))


def smallest_k(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row of dist (B, C), smaller slot first on
    ties: (dists (B, k) with +inf pads, slots (B, k) int64 with -1 where
    the distance is +inf); k may exceed C."""
    b, c = dist.shape
    k_eff = min(k, c)
    order = torch.sort(dist, dim=1, stable=True).indices[:, :k_eff]
    dists = torch.gather(dist, 1, order)
    if k_eff < k:  # k exceeds the candidates: pad like the kernels do
        pad = k - k_eff
        dists = torch.cat([dists, dists.new_full((b, pad), float("inf"))], dim=1)
        order = torch.cat([order, order.new_full((b, pad), -1)], dim=1)
    return dists, torch.where(torch.isfinite(dists), order, torch.full_like(order, -1))


def take_slots(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """rows (B, C) at the selected slots (B, k), -1 where the slot is -1,
    as int32: maps ranked slots to GLOBAL CSR rows."""
    g = torch.gather(rows, 1, torch.clamp_min(slots, 0).long())
    return torch.where(slots >= 0, g, torch.full_like(g, -1)).to(torch.int32)


def candidate_topk(
    candidates: torch.Tensor,  # (B, C, d) float32
    valid: torch.Tensor,       # (B, C) bool
    queries: torch.Tensor,     # (B, d) float32
    k: int,
    metric: str = "l2",
    d_chunk: int | None = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest distances among valid dense candidates.
    Returns dists (B, k) float32 (+inf pads) and idx (B, k) int32 LOCAL
    candidate slots (-1 pads), smaller slot first on ties."""
    check_dense_args(candidates, valid, queries)
    dist = chunked_distance(candidates.to(torch.float32), queries, metric, d_chunk)
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    dists, slots = smallest_k(dist, k)
    return dists, slots.to(torch.int32)


def csr_candidate_topk(
    store: torch.Tensor,    # (n_pad, d) float32 — CSR-sorted ranking vectors
    starts: torch.Tensor,   # (B, w) int32 window-row span starts
    ends: torch.Tensor,     # (B, w) int32 window-row span ends
    queries: torch.Tensor,  # (B, d) float32
    k: int,
    n: int,                 # live CSR rows
    row_cap: int,
    metric: str = "l2",
    radii: torch.Tensor | None = None,  # (B,) float32 paper-mode circle mask
    center_cells: bool = False,
    d_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-gather plain version: materialize the (B, w*row_cap) window,
    rank it with first-index ties, and map the selected slots back to
    GLOBAL CSR row indices.  The distance is summed per `d_chunk` block,
    then across blocks, as the kernel sums it.
    Returns dists (B, k) float32 (inf pads) and idx (B, k) int32 (-1 pads)."""
    check_csr_args(store, starts, ends, queries, row_cap, radii)
    flat, valid = window_slots(starts, ends, store.shape[0], n, row_cap)
    cand = store[flat]                                      # (B, w*cap, d)
    if center_cells:
        cand = torch.floor(cand) + 0.5
    dist = chunked_distance(cand, queries, metric, d_chunk)
    if radii is not None:
        valid = valid & (dist <= radii[:, None].to(torch.float32))
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    dists, slots = smallest_k(dist, k)
    return dists, take_slots(flat, slots)


def csr_shortlist_q8(
    q_store: torch.Tensor,     # (n_pad, d) int8 — quantized CSR store
    row_scales: torch.Tensor,  # (n_pad, 1) float32 — per-row cell scales
    starts: torch.Tensor,      # (B, w) int32 window-row span starts
    ends: torch.Tensor,        # (B, w) int32 window-row span ends
    queries: torch.Tensor,     # (B, d) float32
    rerank_k: int,
    n: int,                    # live CSR rows
    row_cap: int,
    metric: str = "l2",
    d_chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 shortlist: approximate scores of every window slot from
    integer arithmetic, and the best `rerank_k` of them.

    Per valid slot with row scale s: qs = clip(round(q / s), ±QCLIP),
    diff = code - qs in int32, summed in int32 within each `q8_d_chunks`
    chunk; l2 adds the chunks as float32 in order and scores s * sqrt(acc),
    l1 scores s * (int32 total).  Integer scoring is exact, so the kernel
    must equal this bit for bit.  Returns scores (B, rerank_k) float32
    (+inf pads) and GLOBAL CSR rows (B, rerank_k) int32 (-1 pads),
    best-first."""
    check_q8_args(q_store, row_scales, starts, ends, queries, rerank_k, row_cap)
    flat, valid = window_slots(starts, ends, q_store.shape[0], n, row_cap)
    cand = q_store[flat].to(torch.int32)                    # (B, C, d)
    s = row_scales[flat]                                    # (B, C, 1)
    # tensor / tensor: a true division, as the reference's kernel divides
    qs = torch.clamp(torch.round(queries.to(torch.float32)[:, None, :] / s),
                     -QCLIP, QCLIP).to(torch.int32)
    diff = cand - qs
    acc = 0
    for c0, dc in q8_d_chunks(q_store.shape[1], d_chunk):
        part = diff[:, :, c0:c0 + dc]
        if metric == "l1":
            acc = acc + part.abs().sum(dim=-1, dtype=torch.int32)
        else:
            acc = acc + (part * part).sum(dim=-1, dtype=torch.int32).to(torch.float32)
    if metric == "l1":
        score = s[:, :, 0] * acc.to(torch.float32)
    else:
        score = s[:, :, 0] * sqrt_rn(acc)
    score = torch.where(valid, score, torch.full_like(score, float("inf")))
    dists, slots = smallest_k(score, rerank_k)
    return dists, take_slots(flat, slots)


def streaming_smallest_k(blocks, b: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of a (B, N) distance matrix that arrives as
    (offset, (B, m) block) pairs in index order, keeping (B, k + m) at a
    time: (dists (B, k) ascending, ids (B, k) int32).  Earlier blocks come
    first in each concatenation and the sort is stable, so ties keep the
    lower index.  Non-finite distances rank as +inf, and every +inf slot
    (k > N included) gives id -1."""
    inf = float("inf")
    best_d = torch.full((b, 0), inf, dtype=torch.float32, device=device)
    best_i = torch.full((b, 0), -1, dtype=torch.int64, device=device)
    for off, d in blocks:
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, inf))
        ids = torch.arange(off, off + d.shape[1], device=device)
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d, best_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
    if best_d.shape[1] < k:  # k exceeds N: pad
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, best_d.new_full((b, pad), inf)], dim=1)
        best_i = torch.cat([best_i, best_i.new_full((b, pad), -1)], dim=1)
    ids = torch.where(torch.isfinite(best_d), best_i, torch.full_like(best_i, -1))
    return best_d, ids.to(torch.int32)


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """‖x‖² of each row (N, d) -> (N,): each square rounded, then the
    squares added in feature order, as the brute_knn kernel sums them.  A
    reduction's own order would move ‖x‖² by ulps, and in ‖q‖² − 2q·x +
    ‖x‖² those ulps are ulps of ‖x‖², not of the distance."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for c in range(x.shape[1]):
        acc = acc + x[:, c] * x[:, c]
    return acc


def brute_knn(
    queries: torch.Tensor,  # (B, d) float32
    points: torch.Tensor,   # (N, d) float32
    k: int,
    block: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact l2 kNN: (dists (B, k) float32 ascending, ids (B, k) int32).

    The distance is sqrt(max(‖q‖² − 2q·x + ‖x‖², 0)) with the product in
    full float32 (TF32 off), ranked on the square-rooted value, lower
    index first on ties, over N-blocks of `block` points
    (`streaming_smallest_k`: non-finite distances and k > N give +inf /
    -1)."""
    q = queries.to(torch.float32)
    x = points.to(torch.float32)
    qq, xx = sq_norms(q)[:, None], sq_norms(x)
    blocks = ((off, sqrt_rn(torch.clamp_min(
        qq - 2.0 * matmul_f32(q, x[off:off + block].T) + xx[None, off:off + block], 0.0)))
        for off in range(0, x.shape[0], block))
    return streaming_smallest_k(blocks, q.shape[0], k, q.device)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, H, hd)
    v: torch.Tensor,  # (B, T, H, hd)
    causal: bool = True,
) -> torch.Tensor:
    """Plain softmax attention in float32, (B, S, H, hd) in q's dtype:
    scores divided by sqrt(hd), causal positions q >= k kept and the rest
    set to -1e30, as the reference's oracle computes it."""
    qf, kf, vf = (t.to(torch.float32).permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, ., hd)
    hd = q.shape[-1]
    s = matmul_f32(qf, kf.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    if causal:
        sq, tk = q.shape[1], k.shape[1]
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return matmul_f32(p, vf).permute(0, 2, 1, 3).to(q.dtype)
