"""One searcher handle over every execution path (exported as `repro_torch.api`).

Port of `repro/core/engine.py`:

  plan = ExecutionPlan(backend="hopper", chunk_size=2048)
  s = ActiveSearcher.build(points, labels=labels,
                           cfg=GridConfig(n_classes=3), plan=plan)
  res   = s.search(queries, k=11)            # batched SearchResult
  preds = s.classify(queries, k=11)
  cnts  = s.count_at(queries, radii)         # (B, C) circle counts
  s2    = s.with_plan(backend="exact")       # same index, new execution plan
  s3    = s.insert(more_points)              # streaming growth (core/mutable.py)
  live  = s3.delete(stale_ids).snapshot()    # frozen handle, isolated from s3

HOW a search executes lives in the frozen `ExecutionPlan` (backend name,
chunked streaming, accumulation cap, adaptive start radius); WHAT is
searched lives in the (index, cfg) pair the handle carries, on the
handle's device.  Backends are uniform `BackendImpl` adapters resolved
from a registry: `hopper` (the main path, the default), `hopper_gather`
(materialised-window baseline), `hopper_q8` (int8 shortlist + exact
re-rank), `hopper_stacked` (count-only, per-level baseline), `torch` (the
per-query pipeline in plain PyTorch, the reference's `jnp`), `exact` (the
brute-force comparator) and `sharded` (per-shard `torch` searches merged
by (distance, global id), on a `build_sharded` handle: core/distributed.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.core import batched
from repro_torch.core import distributed as dist
from repro_torch.core import exact as exact_lib
from repro_torch.core import mutable as mut
from repro_torch.core import projection as proj_lib
from repro_torch.core import pyramid as pyr
from repro_torch.core import quantized as qz
from repro_torch.core.active_search import (
    SearchResult,
    _classify_torch,
    _search_torch,
    empty_result,
    majority_vote,
    run_chunked,
)
from repro_torch.core.grid import (
    GridConfig,
    GridIndex,
    as_tensor,
    build_index,
    flatten_pyramid_tiles,
    resolve_device,
)
from repro_torch.utils.spans import span

_MODES = ("refined", "paper")


# ------------------------------------------------------------------ plan -----


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """HOW a search executes — frozen and hashable.

    backend:    registered backend name ("hopper" | "exact" | anything added
                via `register_backend`).
    chunk_size: stream query batches through fixed-size chunks so every
                launch keeps one shape.  Bit-identical for any value.
    d_chunk:    split the candidate distance sum into blocks of d_chunk
                features, summed per block and then across blocks (kernel
                backends only; None = one sum).
    adaptive_r0: seed each query's Eq.-1 start radius from the pyramid's
                top levels (`pyramid.seed_radius`) instead of cfg.r0;
                backends that run the Eq.-1 loop only.
    rerank_k:   shortlist depth of the quantized candidate stage (backends
                with `supports_quantized`, i.e. "hopper_q8"): the int8 pass
                keeps the best `rerank_k` rows by approximate score and the
                exact float32 re-rank ranks only those.  None =
                min(max(4k, 32), window*row_cap) at call time; must be >= k
                (checked at the search call) and is capped at the window.
    """

    backend: str = "hopper"
    chunk_size: int | None = None
    d_chunk: int | None = None
    adaptive_r0: bool = False
    rerank_k: int | None = None

    def __post_init__(self):
        if self.chunk_size is not None and self.chunk_size <= 0:
            raise ValueError(
                f"chunk_size must be positive, got {self.chunk_size}"
            )
        if self.d_chunk is not None and self.d_chunk <= 0:
            raise ValueError(
                f"d_chunk must be positive, got {self.d_chunk}"
            )
        if self.rerank_k is not None and self.rerank_k <= 0:
            raise ValueError(
                f"rerank_k must be positive, got {self.rerank_k}"
            )


# -------------------------------------------------------------- registry -----


@dataclasses.dataclass(frozen=True)
class BackendImpl:
    """Uniform adapter a backend registers.  Each callable takes the
    searcher handle first:

      search(searcher, queries, k, mode)   -> SearchResult   (batched)
      classify(searcher, queries, k, mode) -> (B,) int32
      count_at(searcher, q_grid, radii)    -> (B, C) int32 circle counts

    Any of the three may be None; the facade raises eagerly when an op is
    missing.  `supports_d_chunk` gates `plan.d_chunk`,
    `supports_adaptive_r0` gates `plan.adaptive_r0`,
    `supports_quantized` gates `plan.rerank_k`, and `supports_mutation`
    gates the facade's insert/delete (core/mutable.py deltas): backends
    that can serve the refreshed snapshot declare True, count-only
    baselines opt out.
    """

    search: Callable[..., SearchResult] | None = None
    classify: Callable[..., torch.Tensor] | None = None
    count_at: Callable[..., torch.Tensor] | None = None
    supports_d_chunk: bool = False
    supports_adaptive_r0: bool = False
    supports_mutation: bool = False
    supports_quantized: bool = False
    description: str = ""


_REGISTRY: dict[str, BackendImpl] = {}


def register_backend(name: str, impl: BackendImpl) -> None:
    """Register (or replace) an execution backend under `name`."""
    if not isinstance(impl, BackendImpl):
        raise TypeError(f"impl must be a BackendImpl, got {type(impl).__name__}")
    _REGISTRY[name] = impl


def get_backend(name: str) -> BackendImpl:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{sorted(_REGISTRY)}"
        ) from None


def registered_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ------------------------------------------------------------------ handle ---


@dataclasses.dataclass(frozen=True, eq=False)
class ActiveSearcher:
    """The one handle: (index, cfg) = WHAT is searched, plan = HOW.

    Frozen and cheap to re-plan: `with_plan` returns a new handle sharing
    the same index tensors.  Queries are moved to the index's device.  A
    handle from `build_sharded` carries a STACKED index (a leading shard
    dimension; `sharded` is true) and a per-shard mutation state, or, built
    on a mesh, this rank's shard with the `mesh` and `axis` it lives on."""

    index: GridIndex
    cfg: GridConfig
    plan: ExecutionPlan = ExecutionPlan()
    # streaming-mutation state (core/mutable.py; distributed.ShardedMutable
    # on sharded handles): None for frozen handles; set by insert/delete so
    # successive mutations reuse the slack layout
    mutable: Any = None
    # a sharded handle's mesh and axis (one shard per rank of `axis`)
    mesh: Any = None
    axis: str | None = None

    # -------------------------------------------------------- construction --
    @classmethod
    def build(
        cls,
        points,
        *,
        labels=None,
        ids=None,
        cfg: GridConfig | None = None,
        plan: ExecutionPlan | None = None,
        proj: proj_lib.Projection | None = None,
        device=None,
    ) -> "ActiveSearcher":
        """Build the paper's grid image + CSR buckets on `device` (None =
        the card) and wrap them in a handle.  proj defaults to a PCA
        projection to the grid plane."""
        dev = resolve_device(device)
        cfg = cfg or GridConfig()
        pts = as_tensor(points, torch.float32, dev)
        if labels is not None:
            labels = as_tensor(labels, torch.int32, dev)
        if ids is not None:
            ids = as_tensor(ids, torch.int32, dev)
        proj = proj_lib.pca_projection(pts, grid_dim=2) if proj is None else proj.to(dev)
        index = build_index(pts, cfg, proj, labels=labels, ids=ids)
        return cls(index=index, cfg=cfg, plan=plan or ExecutionPlan())

    @classmethod
    def from_index(
        cls,
        index: GridIndex,
        cfg: GridConfig,
        plan: ExecutionPlan | None = None,
        device=None,
    ) -> "ActiveSearcher":
        """Wrap an already-built GridIndex, moved to `device` (None = the
        card).  A pre-layout index (pyr_tiles=None) is laid out here, once."""
        index = index.to(resolve_device(device))
        if cfg.counter == "pyramid" and index.pyr_tiles is None:
            index = index._replace(
                pyr_tiles=flatten_pyramid_tiles(index.pyramid, cfg.tile)
            )
        return cls(index=index, cfg=cfg, plan=plan or ExecutionPlan())

    @classmethod
    def build_sharded(
        cls,
        points,
        *,
        n_shards: int | None = None,
        mesh: Any = None,
        axis: str | None = None,
        labels=None,
        ids=None,
        cfg: GridConfig | None = None,
        plan: ExecutionPlan | None = None,
        proj: proj_lib.Projection | None = None,
        device=None,
    ) -> "ActiveSearcher":
        """One grid per shard with GLOBAL point ids; searches merge the
        per-shard top-k lists (backend "sharded", core/distributed.py).
        With `n_shards` every shard is on `device` (None = the card); with
        `mesh` and `axis` (every rank passing the same points) shard s is
        built and kept only on rank s of `axis`, on the mesh's device.
        proj defaults to a PCA projection of all the points, shared by
        every shard."""
        dev = mesh.device if mesh is not None else resolve_device(device)
        cfg = cfg or GridConfig()
        pts = as_tensor(points, torch.float32, dev)
        proj = proj_lib.pca_projection(pts, grid_dim=2) if proj is None else proj
        index = dist.build_sharded_index(pts, cfg, proj, n_shards, labels, ids=ids, device=dev,
                                         mesh=mesh, axis=axis)
        plan = dataclasses.replace(plan or ExecutionPlan(), backend="sharded")
        return cls(index=index, cfg=cfg, plan=plan, mesh=mesh, axis=axis)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def sharded(self) -> bool:
        """True for a `build_sharded` handle (its index stacked, or one
        rank's shard of a mesh)."""
        return self.mesh is not None or self.index.offsets.dim() == 2

    def with_plan(
        self, plan: ExecutionPlan | None = None, **overrides
    ) -> "ActiveSearcher":
        """Same index, new execution plan (full plan or field overrides).

        Switching `backend=` drops the `d_chunk`, `adaptive_r0` and
        `rerank_k` knobs when the new backend does not support them (unless
        explicitly overridden too)."""
        if plan is not None and overrides:
            raise ValueError("pass a full ExecutionPlan OR field overrides")
        if plan is None and "backend" in overrides:
            impl = _REGISTRY.get(overrides["backend"])
            if impl is not None:
                if not impl.supports_d_chunk and "d_chunk" not in overrides:
                    overrides = {**overrides, "d_chunk": None}
                if (not impl.supports_adaptive_r0
                        and "adaptive_r0" not in overrides):
                    overrides = {**overrides, "adaptive_r0": False}
                if not impl.supports_quantized and "rerank_k" not in overrides:
                    overrides = {**overrides, "rerank_k": None}
        new = plan if plan is not None else dataclasses.replace(self.plan, **overrides)
        return dataclasses.replace(self, plan=new)

    # ------------------------------------------------------------- mutation --
    def _check_mutation(self) -> None:
        """Eager capability validation: the plan's backend must be able to
        serve the refreshed snapshot a mutation produces."""
        impl = get_backend(self.plan.backend)
        if not impl.supports_mutation:
            mutable_backends = [
                n for n in registered_backends()
                if get_backend(n).supports_mutation
            ]
            raise ValueError(
                f"backend {self.plan.backend!r} does not support mutation "
                f"(BackendImpl.supports_mutation); insert/delete need one "
                f"of {mutable_backends}"
            )

    def _mutable_state(self):
        """Current mutation state, opening the index on first use (per-shard
        MutableIndex states for sharded handles, one state for dense)."""
        if self.mutable is not None:
            return self.mutable
        if self.sharded:
            return dist.open_sharded(self.index, self.cfg, mesh=self.mesh, axis=self.axis)
        return mut.from_index(self.index, self.cfg)

    def _carry_mutation_stats(self, new, compactions: int, compact_s: float):
        """Accumulate the compaction accounting on the NEW handle (kept in
        its __dict__, beside the cached properties; sharded handles carry
        theirs inside ShardedMutable instead)."""
        prev = self.__dict__.get(
            "_mutation_stats", {"compactions": 0, "compact_s": 0.0}
        )
        object.__setattr__(new, "_mutation_stats", {
            "compactions": prev["compactions"] + compactions,
            "compact_s": prev["compact_s"] + compact_s,
        })
        return new

    def insert(self, points, *, labels=None, ids=None) -> "ActiveSearcher":
        """Streaming insert: delta-update the grid, pyramid, and dirty tiles
        (core/mutable.py) and return a NEW handle over the grown index, on
        this handle's device.

        This handle is unchanged (every update writes new tensors); the
        returned one carries the refreshed dense snapshot plus the slack
        state, so chained inserts keep reusing free bucket slots.  Being a
        new object, it also starts with cold cached properties, so `exact`
        and `hopper_q8` derive their views of the grown contents afresh.
        Results are bit-identical to rebuilding from the union of the
        points.

        Sharded handles route every point to its owning shard (grid-cell
        ownership, core/distributed.py) and delta-insert per shard; the
        same insert == rebuild parity holds on the "sharded" backend."""
        self._check_mutation()
        if self.sharded:
            state = dist.sharded_insert(self._mutable_state(), self.cfg, points,
                                        labels=labels, ids=ids)
            return dataclasses.replace(
                self, index=dist.stacked_snapshot(state, self.cfg), mutable=state
            )
        with span("asnn.insert"):
            state, report = mut.insert_tracked(self._mutable_state(), self.cfg, points,
                                               labels=labels, ids=ids)
            new = dataclasses.replace(
                self, index=mut.snapshot(state, self.cfg), mutable=state
            )
            return self._carry_mutation_stats(new, report.compactions, report.compact_s)

    def delete(self, ids) -> "ActiveSearcher":
        """Delete by global point id; returns a NEW handle (see `insert`).
        On sharded handles the ids are matched globally (strict accounting
        across shards) and tombstoned on whichever shards carry them."""
        self._check_mutation()
        if self.sharded:
            state = dist.sharded_delete(self._mutable_state(), self.cfg, ids)
            return dataclasses.replace(
                self, index=dist.stacked_snapshot(state, self.cfg), mutable=state
            )
        with span("asnn.delete"):
            state = mut.delete(self._mutable_state(), self.cfg, ids)
            new = dataclasses.replace(
                self, index=mut.snapshot(state, self.cfg), mutable=state
            )
            return self._carry_mutation_stats(new, 0, 0.0)

    def snapshot(self) -> "ActiveSearcher":
        """A frozen handle over the current contents.

        Drops the slack state: later insert/delete on either handle cannot
        affect the other (updates write new tensors and never touch the
        ones a snapshot holds, so a snapshot taken mid-serving stays valid
        while the source keeps mutating).

        On a SHARDED handle this also merges the per-shard stores into ONE
        dense handle (plan switched to the "torch" backend) whose index is
        bit-identical to an unsharded `build_index` over the same points —
        cells are wholly shard-owned, so the merge reproduces the global
        CSR order exactly (distributed.merge_to_dense)."""
        if not self.sharded:
            return dataclasses.replace(self, mutable=None)
        stacked = (self.index if self.mesh is None
                   else dist.gather_stacked(self.index, self.mesh, self.axis))
        dense = dist.merge_to_dense(stacked, self.cfg)
        return dataclasses.replace(self.with_plan(backend="torch"), index=dense, mutable=None,
                                   mesh=None, axis=None)

    # ------------------------------------------------------------- dispatch --
    def _impl(self, op: str) -> Callable:
        """Resolve the plan's backend and validate the plan EAGERLY, so
        every backend raises the same errors for the same misuses."""
        impl = get_backend(self.plan.backend)
        if self.plan.d_chunk is not None and not impl.supports_d_chunk:
            raise ValueError(
                f"d_chunk= only applies to kernel candidate-ranking "
                f"backends; backend {self.plan.backend!r} does not "
                f"support it"
            )
        if self.plan.adaptive_r0 and not impl.supports_adaptive_r0:
            raise ValueError(
                f"adaptive_r0= only applies to backends that run the Eq.-1 "
                f"radius loop; backend {self.plan.backend!r} does not "
                f"support it"
            )
        if self.plan.rerank_k is not None and not impl.supports_quantized:
            raise ValueError(
                f"rerank_k= only applies to quantized-candidate backends "
                f"(BackendImpl.supports_quantized); backend "
                f"{self.plan.backend!r} does not support it"
            )
        fn = getattr(impl, op)
        if fn is None:
            raise ValueError(
                f"backend {self.plan.backend!r} does not implement {op}()"
            )
        return fn

    @staticmethod
    def _check_mode(mode: str) -> None:
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {_MODES}")

    # ------------------------------------------------------------------ ops --
    def search(self, queries, k: int, mode: str = "refined") -> SearchResult:
        """Batched active search: queries (B, d) -> SearchResult, leading B.

        mode="paper":   members of the final Eq.-1 circle, ranked by
                        grid-pixel distance.
        mode="refined": candidates re-ranked by the true metric in the
                        original space (recommended).
        """
        with span("asnn.search"):
            self._check_mode(mode)
            fn = self._impl("search")
            q = as_tensor(queries, torch.float32, self.device)
            return run_chunked(
                lambda c: fn(self, c, k, mode), q, self.plan.chunk_size,
                empty=lambda: empty_result(k, self.device),
            )

    def classify(self, queries, k: int, mode: str = "refined") -> torch.Tensor:
        """kNN classification: (B, d) -> (B,) int32 class predictions."""
        self._check_mode(mode)
        if self.cfg.n_classes <= 0:
            raise ValueError("classify() needs an index built with n_classes > 0")
        fn = self._impl("classify")
        q = as_tensor(queries, torch.float32, self.device)
        return run_chunked(
            lambda c: fn(self, c, k, mode), q, self.plan.chunk_size,
            empty=lambda: torch.zeros((0,), dtype=torch.int32, device=self.device),
        )

    def count_at(self, queries, radii) -> torch.Tensor:
        """Per-class circle counts (B, C) at the given integer radii
        (pixels).  queries are ORIGINAL-space (B, d); projection happens
        here.  plan.chunk_size streams (q_grid, radius) pairs."""
        fn = self._impl("count_at")
        q = as_tensor(queries, torch.float32, self.device)
        q_grid = proj_lib.to_grid_coords(self.index.proj, q, self.cfg.grid_size)
        c = self.cfg.n_channels
        return run_chunked(
            lambda qr: fn(self, qr[0], qr[1]),
            (q_grid, as_tensor(radii, torch.int32, self.device)),
            self.plan.chunk_size,
            empty=lambda: torch.zeros((0, c), dtype=torch.int32, device=self.device),
        )

    def stats(self) -> dict[str, Any]:
        """Static facts about the handle: index shape/memory + plan."""
        idx, cfg = self.index, self.cfg
        nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
        if self.mutable is None:
            mutation_stats = {}
        elif self.sharded:
            mutation_stats = dist.sharded_stats(self.mutable)
        else:
            mutation_stats = {
                "free_bucket_slots": int(self.mutable.free_bucket_slots),
                "spill_used": int(self.mutable.spill_used),
                "spill_capacity": self.mutable.spill_capacity,
                **self.__dict__.get(
                    "_mutation_stats", {"compactions": 0, "compact_s": 0.0}
                ),
            }
        return {
            # LIVE record count from the CSR offsets: a sharded handle sums
            # the per-shard live prefixes (its pow2 pad rows do not count)
            "n_points": dist.live_points(idx, self.mesh, self.axis),
            "dim": int(idx.points_sorted.shape[-1]),
            "grid_size": cfg.grid_size,
            "padded_size": cfg.padded_size,
            "levels": cfg.levels,
            "n_classes": cfg.n_classes,
            "metric": cfg.metric,
            "counter": cfg.counter,
            "backend": self.plan.backend,
            "plan": self.plan,
            "device": str(self.device),
            "sharded": self.sharded,
            "pyramid_bytes": sum(nbytes(a) for a in idx.pyramid),
            "pyr_tiles_bytes": 0 if idx.pyr_tiles is None else nbytes(idx.pyr_tiles),
            "csr_bytes": sum(
                nbytes(a) for a in (idx.points_sorted, idx.coords_sorted,
                                    idx.labels_sorted, idx.ids_sorted, idx.offsets)
            ),
            "mutable": self.mutable is not None,
            **mutation_stats,
        }

    @functools.cached_property
    def _exact_ordered(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """CSR arrays restored to original-id order, so the exact comparator
        sees the datastore as the caller supplied it (same tie breaks as an
        `exact.knn(points, ...)` call).  Computed once per handle."""
        index = self.index
        order = torch.argsort(index.ids_sorted, stable=True)
        return (
            index.points_sorted[order],
            index.labels_sorted[order],
            index.ids_sorted[order],
        )

    @functools.cached_property
    def _quantized_store(self) -> qz.QuantizedStore:
        """The handle's int8 candidate store (core/quantized.py), computed
        once per handle: the store is a pure function of the index, which
        the frozen handle never changes."""
        return qz.quantize_index(self.index, self.cfg)


# ------------------------------------------------------ built-in backends ----


def _torch_search(s: ActiveSearcher, queries, k, mode):
    return _search_torch(s.index, s.cfg, queries, k, mode,
                         adaptive_r0=s.plan.adaptive_r0)


def _torch_classify(s: ActiveSearcher, queries, k, mode):
    return _classify_torch(s.index, s.cfg, queries, k, mode,
                           adaptive_r0=s.plan.adaptive_r0)


def _torch_count_at(s: ActiveSearcher, q_grid, radii):
    return _count_torch(s.index, s.cfg, q_grid, radii)


def _count_torch(index: GridIndex, cfg: GridConfig, q_grid, radii):
    return pyr.count_in_circle(index, cfg, q_grid, radii)


def _hopper_search(s: ActiveSearcher, queries, k, mode, pipeline="fused"):
    return batched.search(
        s.index, s.cfg, queries, k, mode=mode, pipeline=pipeline,
        d_chunk=s.plan.d_chunk, adaptive_r0=s.plan.adaptive_r0,
    )


def _hopper_classify(s: ActiveSearcher, queries, k, mode, pipeline="fused"):
    return batched.classify(
        s.index, s.cfg, queries, k, mode=mode, pipeline=pipeline,
        d_chunk=s.plan.d_chunk, adaptive_r0=s.plan.adaptive_r0,
    )


def _hopper_count_at(s: ActiveSearcher, q_grid, radii):
    return batched.batched_counts(s.index, s.cfg, q_grid, radii)


def _hopper_q8_search(s: ActiveSearcher, queries, k, mode):
    return batched.search_q8(
        s.index, s._quantized_store, s.cfg, queries, k, mode=mode,
        rerank_k=s.plan.rerank_k, d_chunk=s.plan.d_chunk,
        adaptive_r0=s.plan.adaptive_r0,
    )


def _hopper_q8_classify(s: ActiveSearcher, queries, k, mode):
    return batched.classify_q8(
        s.index, s._quantized_store, s.cfg, queries, k, mode=mode,
        rerank_k=s.plan.rerank_k, d_chunk=s.plan.d_chunk,
        adaptive_r0=s.plan.adaptive_r0,
    )


def _hopper_stacked_count_at(s: ActiveSearcher, q_grid, radii):
    return batched.batched_counts_stacked(s.index, s.cfg, q_grid, radii)


def _exact_search(s: ActiveSearcher, queries, k, mode):
    """Brute-force comparator folded into the uniform SearchResult: the
    paper-stat fields are defaulted since exact kNN has no Eq.-1 loop.
    `mode` is accepted for interface uniformity."""
    pts, labels, ids = s._exact_ordered
    res = exact_lib.knn(queries, pts, k, metric=s.cfg.metric)
    b = res.ids.shape[0]
    valid = torch.isfinite(res.dists) & (res.ids >= 0)
    pos = torch.clamp(res.ids, 0, pts.shape[0] - 1).long()
    none = torch.full_like(res.ids, -1)
    i32 = dict(dtype=torch.int32, device=pts.device)
    return SearchResult(
        ids=torch.where(valid, ids[pos], none),
        dists=torch.where(valid, res.dists, torch.full_like(res.dists, float("inf"))),
        labels=torch.where(valid, labels[pos], none),
        valid=valid,
        radius=torch.zeros((b,), **i32),
        count=valid.sum(dim=1, dtype=torch.int32),
        iters=torch.zeros((b,), **i32),
        converged=torch.ones((b,), dtype=torch.bool, device=pts.device),
        truncated=torch.zeros((b,), dtype=torch.bool, device=pts.device),
    )


def _exact_classify(s: ActiveSearcher, queries, k, mode):
    pts, labels, _ = s._exact_ordered
    return exact_lib.classify(
        queries, pts, labels, k, s.cfg.n_classes, metric=s.cfg.metric,
    )


def _sharded_search(s: ActiveSearcher, queries, k, mode):
    if not s.sharded:
        raise ValueError(
            "backend 'sharded' needs a handle from ActiveSearcher.build_sharded"
        )
    return dist.sharded_search(s.index, s.cfg, queries, k, mode=mode,
                               adaptive_r0=s.plan.adaptive_r0, mesh=s.mesh, axis=s.axis)


def _sharded_classify(s: ActiveSearcher, queries, k, mode):
    """Majority vote over the globally merged top-k.

    There is NO count-based fallback for short/truncated lanes: Eq. 1
    converges to a DIFFERENT radius on every shard, so "per-class counts at
    the final radius" has no global definition.  mode="paper" (pure count
    argmax) is rejected for the same reason."""
    if mode != "refined":
        raise ValueError("backend 'sharded' classifies in mode='refined' only")
    res = _sharded_search(s, queries, k, "refined")
    return majority_vote(res.labels, res.valid, s.cfg.n_classes)


register_backend("torch", BackendImpl(
    search=_torch_search, classify=_torch_classify, count_at=_torch_count_at,
    supports_adaptive_r0=True, supports_mutation=True,
    description="per-query reference pipeline in plain PyTorch, the whole "
                "batch in lock step (core/active_search.py, core/pyramid.py); "
                "no kernel",
))
register_backend("hopper", BackendImpl(
    search=_hopper_search, classify=_hopper_classify, count_at=_hopper_count_at,
    supports_d_chunk=True, supports_adaptive_r0=True, supports_mutation=True,
    description="batched kernel pipeline: the whole Eq.-1 loop in one "
                "radius_search_loop launch + fused csr_candidate_topk, both "
                "hand-written for Hopper (core/batched.py, csrc/)",
))
register_backend("hopper_gather", BackendImpl(
    search=functools.partial(_hopper_search, pipeline="gather"),
    classify=functools.partial(_hopper_classify, pipeline="gather"),
    count_at=_hopper_count_at, supports_d_chunk=True, supports_adaptive_r0=True,
    supports_mutation=True,
    description="benchmark baseline / second oracle: the same counting, but "
                "the candidate stage gathers the (B, w*row_cap) window and "
                "ranks it with the dense candidate_topk kernel",
))
register_backend("hopper_q8", BackendImpl(
    search=_hopper_q8_search, classify=_hopper_q8_classify,
    count_at=_hopper_count_at, supports_d_chunk=True,
    supports_adaptive_r0=True, supports_mutation=True, supports_quantized=True,
    description="quantized candidate stage: the int8 csr_shortlist_q8 "
                "kernel keeps the best rerank_k rows, then candidate_topk "
                "re-ranks them exactly in float32 (recall contract against "
                "the exact backends; core/quantized.py + core/batched.py)",
))
register_backend("hopper_stacked", BackendImpl(
    count_at=_hopper_stacked_count_at,
    description="count-only benchmark baseline: one tile_count launch per "
                "pyramid level + select",
))
register_backend("exact", BackendImpl(
    search=_exact_search, classify=_exact_classify, supports_mutation=True,
    description="brute-force kNN — the paper's 'original kNN' comparator "
                "(core/exact.py): l2 on the hand-written brute_knn kernel, "
                "l1 in plain tensor code",
))
register_backend("sharded", BackendImpl(
    search=_sharded_search, classify=_sharded_classify,
    supports_adaptive_r0=True, supports_mutation=True,
    description="per-shard `torch` searchers over a stacked index on one device "
                "+ (dist, global id) lexicographic top-k merge; mutation routed "
                "by grid-cell ownership (core/distributed.py; build via "
                "build_sharded); no kernel",
))


__all__ = [
    "ActiveSearcher",
    "BackendImpl",
    "ExecutionPlan",
    "SearchResult",
    "get_backend",
    "register_backend",
    "registered_backends",
    "resolve_device",
]
