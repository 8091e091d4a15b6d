"""The comparison that decides `correct`: the program's answers against the reference's.

Two numbers, each held to a limit of its own (`perfbench/limits/<cell>.json`):

- `query_mismatch`: the share of the checked queries whose answer differs
  from the float64 reference's: any Eq.-1 output (radius, count, iters,
  converged, truncated), a rank valid on one side only, or a rank whose
  distance differs by more than DIST_TOL of the reference's.  The program
  computes its geometry in float32, so a point or query within a float32
  rounding of a cell edge can sit in the next cell and move a query's
  circle counts or window: sound runs read a small share, never 0 by
  design; the limit sits between their readings and the control's.
- `id_gap`: the widest relative gap between each returned distance and the
  float64 distance from the query to the point whose id came with it (an id
  that is not live, a label that is not the point's, or a pad that is not
  -1 / inf reads 1): whether the ids, labels and distances belong together.
"""

from __future__ import annotations

import torch

LOOP_FIELDS = ("radius", "count", "iters", "converged", "truncated")
NAMES = ("query_mismatch", "id_gap")
# a rank's distance may differ by this share of the reference's: sound float32
# distances read under 1e-6 of the float64 ones, the TF32 control's 1e-4 and more
DIST_TOL = 1e-5
TINY = 1e-30


def numbers(got: dict, want: dict, queries: torch.Tensor, vectors: torch.Tensor,
            labels: torch.Tensor, live: torch.Tensor) -> dict:
    """The numbers for one answered batch, all tensors on one device:
    `query_mismatch` as (queries that differ, queries), `id_gap` a float.

    got / want: the program's and the reference's fields (B, ...); queries
    (B, d) as sent; vectors (M, d), labels (M,) and live (M,) bool indexed by
    id: every point the benchmark ever made, and whether it was in the index
    when the batch was answered."""
    b = want["radius"].shape[0]
    if any(got[f].shape != want[f].shape for f in want):
        return {"query_mismatch": (b, b), "id_gap": 1.0}
    loop = torch.zeros(b, dtype=torch.bool, device=want["radius"].device)
    for f in LOOP_FIELDS:
        loop |= (got[f].reshape(b, -1) != want[f].reshape(b, -1)).any(dim=1)
    gv, wv = got["valid"], want["valid"]
    gd, wd = got["dists"].to(torch.float64), want["dists"].to(torch.float64)
    rel = torch.where(gv & wv, (gd - wd).abs() / wd.abs().clamp_min(TINY), torch.zeros_like(gd))
    rel = torch.nan_to_num(rel, nan=1.0)
    slots = (gv != wv).any(dim=1)
    far = (rel > DIST_TOL).any(dim=1)
    differ = loop | slots | far
    same = rel[~differ]

    ids = got["ids"].to(torch.int64)
    known = (ids >= 0) & (ids < live.shape[0])
    safe = torch.where(known, ids, torch.zeros_like(ids))
    ok_id = known & live[safe] & (got["labels"].to(torch.int64) == labels[safe].to(torch.int64))
    d64 = _dist64(queries, vectors, safe, gv)
    id_rel = (gd - d64).abs() / d64.clamp_min(TINY)
    pad_ok = (ids == -1) & (got["labels"] == -1) & torch.isinf(got["dists"])
    id_gap = torch.where(gv, torch.where(ok_id, id_rel, torch.ones_like(id_rel)),
                         torch.where(pad_ok, torch.zeros_like(id_rel), torch.ones_like(id_rel)))
    return {"query_mismatch": (int(differ.sum()), b), "id_gap": _finite_max(id_gap),
            # diagnostics, held to no limit: why queries differ, and the
            # rank distances' gaps over the queries that match
            "loop_differs": (int(loop.sum()), b), "valid_differs": (int(slots.sum()), b),
            "dist_differs": (int(far.sum()), b),
            "matched_dist_gap": _finite_max(same)}


def _dist64(queries, vectors, ids, valid) -> torch.Tensor:
    """float64 distance (B, k) from each query to the point of each id."""
    q = queries.to(torch.float64)[:, None, :]
    x = vectors[ids.reshape(-1)].to(torch.float64).reshape(ids.shape + (vectors.shape[1],))
    d = ((x - q) ** 2).sum(dim=-1).sqrt()
    return torch.where(valid, d, torch.zeros_like(d))


def _finite_max(x: torch.Tensor) -> float:
    """The largest entry, with NaN read as 1 (a NaN distance is an error)."""
    x = torch.nan_to_num(x, nan=1.0)
    return float(x.max()) if x.numel() else 0.0


def combine(readings: list[dict]) -> dict:
    """Several answered batches' numbers as one reading each: a share over
    all their queries, the worst of a gap."""
    out = {}
    for name in dict.fromkeys(n for r in readings for n in r):
        vals = [r[name] for r in readings if name in r]
        if isinstance(vals[0], tuple):
            out[name] = sum(v[0] for v in vals) / max(1, sum(v[1] for v in vals))
        else:
            out[name] = float(max(vals))
    return out
