"""The port's sharded tier (core/distributed.py and the facade's `sharded`
backend) against the JAX package's.

The reference places one shard per device of a mesh and merges under
shard_map; the port stacks every shard on one device.  The tests hold the
two to the same arrays and results on the same numpy inputs: routing, the
stacked index (built here from the reference's own mesh-free pieces, and
at one shard also through its mesh path), the search (at one shard
against `sharded_search` on a one-device mesh, at four against an oracle
that runs the reference's per-shard `jnp` searcher and merges with
`np.lexsort` on (dist, id) — `local_query`'s body without the all_gather),
every per-shard mutation state array for array, the dense merge, and the
facade's insert / delete / snapshot against a sharded rebuild.
Tolerances: everything exact but f32 distances (DIST_RTOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import (
    assert_dists_close,
    assert_index_equal,
    assert_results_match,
    assert_trees_equal,
    np_,
    require_cuda,
)
from jax.sharding import Mesh

from repro import api as japi
from repro.core import distributed as D
from repro.core import engine as jeng
from repro.core import mutable as jm
from repro.core.grid import GridConfig as JGridConfig
from repro.core.grid import build_index as jbuild
from repro.core.projection import identity_projection as jidentity
from repro_torch import api as tapi
from repro_torch.convert import (
    projection_from_numpy,
    sharded_index_from_numpy,
    sharded_mutable_from_numpy,
)
from repro_torch.core import distributed as TD
from repro_torch.core import grid as tgrid
from repro_torch.core import mutable as tm

CFG_KW = dict(grid_size=64, tile=8, n_classes=3, window=16, row_cap=32, r0=4, k_slack=2.0)
JCFG, TCFG = JGridConfig(**CFG_KW), tgrid.GridConfig(**CFG_KW)
S = 4        # shards of the build and search tests
S_MUT = 2    # shards of the mutation tests: the reference compiles each op once per shard


@pytest.fixture(autouse=True, scope="module")
def _fresh_jit_caches():
    # as tests/test_sharded_mutable.py: many one-off shapes (per-shard
    # snapshots grow after every insert); start from empty caches
    jax.clear_caches()
    yield


def _data(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    return pts, rng.integers(0, 3, size=n).astype(np.int32)


def _proj(pts):
    jp = jidentity(jnp.asarray(pts))
    return jp, projection_from_numpy(*map(np.asarray, jp), device="cpu")


def _queries(seed, pts, b=8):
    """Half random, half at the data extents (clamped grid-corner windows)."""
    rng = np.random.default_rng(seed)
    lo, hi = float(pts.min()), float(pts.max())
    corners = np.asarray([[lo, lo], [hi, hi], [lo, hi], [hi, lo]], np.float32)[: b - b // 2]
    return np.concatenate([rng.normal(size=(b // 2, 2)).astype(np.float32), corners])


def _ref_stacked(pts, labels, jp, n_shards, cfg=JCFG, ids=None):
    """The reference's stacked index from its mesh-free pieces: routing,
    one `build_index` per shard, `stack_shard_indexes`."""
    ids = np.arange(len(pts), dtype=np.int32) if ids is None else ids
    owner = np.asarray(D.shard_of_points(jnp.asarray(pts), cfg, jp, n_shards))
    return D.stack_shard_indexes([
        jbuild(jnp.asarray(pts[owner == s]), cfg, jp, labels=jnp.asarray(labels[owner == s]),
               ids=jnp.asarray(ids[owner == s]))
        for s in range(n_shards)
    ])


def _carry(jidx, cfg=TCFG):
    return sharded_index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), cfg, device="cpu")


def _oracle(jidx, cfg, q, k, mode="refined", adaptive_r0=False):
    """`local_query`'s body without the all_gather: the reference's
    per-shard jnp searchers, merged on the host by (dist, id), the
    diagnostics reduced across shards."""
    plan = jeng.ExecutionPlan(backend="jnp", adaptive_r0=adaptive_r0)
    res = [jeng.ActiveSearcher(index=jax.tree.map(lambda a: a[s], jidx), cfg=cfg, plan=plan)
           .search(jnp.asarray(q), k, mode=mode) for s in range(jidx.offsets.shape[0])]
    d = np.concatenate([np.asarray(r.dists) for r in res], axis=1)
    i = np.concatenate([np.asarray(r.ids) for r in res], axis=1)
    lab = np.concatenate([np.asarray(r.labels) for r in res], axis=1)
    order = np.stack([np.lexsort((ii, dd)) for dd, ii in zip(d, i)])[:, :k]
    top_d = np.take_along_axis(d, order, 1)
    ok = np.isfinite(top_d)
    stat = lambda f: np.stack([np.asarray(getattr(r, f)) for r in res])  # noqa: E731
    return japi.SearchResult(
        ids=np.where(ok, np.take_along_axis(i, order, 1), -1).astype(np.int32),
        dists=top_d, labels=np.where(ok, np.take_along_axis(lab, order, 1), -1).astype(np.int32),
        valid=ok, radius=stat("radius").max(0), count=stat("count").sum(0, dtype=np.int32),
        iters=stat("iters").max(0), converged=stat("converged").all(0),
        truncated=stat("truncated").any(0),
    )


def _ref_states(sm):
    return [{k: np.asarray(v) for k, v in jm.state_to_tree(st).items()} for st in sm.states]


def assert_sharded_state_equal(tsm, jsm, msg=""):
    assert tsm.n_shards == jsm.n_shards and tsm.next_id == jsm.next_id, msg
    assert tsm.compactions == jsm.compactions, msg
    for s, (ts, js) in enumerate(zip(tsm.states, jsm.states)):
        assert_trees_equal(tm.state_to_tree(ts), jm.state_to_tree(js), f"{msg} shard {s}")


# ------------------------------------------------------------------ routing --


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("spread", [0.05, 1.5])
def test_routing_matches_reference(n_shards, spread):
    pts, _ = _data(0, 256, spread)
    jp, tp = _proj(pts)
    want = np.asarray(D.shard_of_points(jnp.asarray(pts), JCFG, jp, n_shards))
    got = np_(TD.shard_of_points(torch.from_numpy(pts), TCFG, tp, n_shards))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


# -------------------------------------------------------------------- build --


@pytest.fixture(scope="module")
def stack4():
    """300 points (not a power of two: the tails are padded) and the
    reference's stacked index over S = 4 shards."""
    pts, labels = _data(1, 300)
    jp, tp = _proj(pts)
    return pts, labels, tp, _ref_stacked(pts, labels, jp, S)


def test_build_matches_reference_stack(stack4):
    """At S = 4 the port's stacked index equals the reference's stacked
    per-shard builds in every field (proj, pad tail, pyramid, tiles)."""
    pts, labels, tp, want = stack4
    got = TD.build_sharded_index(pts, TCFG, tp, S, labels=labels, device="cpu")
    assert_index_equal(got, want)
    for a, b in zip(got.proj, want.proj):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    assert got.points_sorted.shape[:2] == (S, 128)
    assert TD.n_shards_of(got) == S
    # the dense shards are views of the stack, pad tail included
    assert_index_equal(TD.shard(got, 2), jax.tree.map(lambda a: a[2], want))


def test_one_shard_matches_the_reference_mesh_path():
    """At S = 1, build and search equal the reference's build_sharded_index
    and sharded_search on a one-device mesh."""
    pts, labels = _data(2, 320)
    jp, tp = _proj(pts)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jidx = D.build_sharded_index(jnp.asarray(pts), JCFG, jp, mesh, "data", jnp.asarray(labels))
    tidx = TD.build_sharded_index(pts, TCFG, tp, 1, labels=labels, device="cpu")
    assert_index_equal(tidx, jidx)
    q = _queries(3, pts)
    for mode in ("refined", "paper"):
        want = D.sharded_search(jidx, JCFG, D.replicate_queries(jnp.asarray(q), mesh), 8,
                                mesh, "data", mode=mode)
        assert_results_match(TD.sharded_search(tidx, TCFG, torch.from_numpy(q), 8, mode=mode),
                             want)


@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("mode", ["refined", "paper"])
def test_four_shard_search_matches_per_shard_oracle(stack4, metric, mode):
    kw = {**CFG_KW, "metric": metric}
    jcfg, tcfg = JGridConfig(**kw), tgrid.GridConfig(**kw)
    pts, _, _, jidx = stack4   # the metric is not part of the index
    q = _queries(5, pts)
    for adaptive_r0 in (False, True):
        got = TD.sharded_search(_carry(jidx, tcfg), tcfg, torch.from_numpy(q), 8, mode=mode,
                                adaptive_r0=adaptive_r0)
        assert_results_match(got, _oracle(jidx, jcfg, q, 8, mode, adaptive_r0))


def test_merge_tiebreak_is_global_id_order():
    """Two points equidistant from the query in different cells: the merged
    top-k orders the tie by GLOBAL id, not shard position or CSR order
    (ids [3, 7] where CSR order says [7, 3])."""
    cfg = tgrid.GridConfig(grid_size=32, tile=8, window=16, row_cap=16, r0=4, k_slack=2.0)
    pts = np.asarray([[0.5, 0.0], [-0.5, 0.0], [4.0, 4.0], [-4.0, -4.0]], np.float32)
    _, tp = _proj(pts)
    s = tapi.ActiveSearcher.build_sharded(pts, n_shards=S, cfg=cfg, proj=tp,
                                          ids=np.asarray([3, 7, 11, 12], np.int32), device="cpu")
    res = s.search(np.zeros((1, 2), np.float32), 2)
    d = np_(res.dists[0])
    assert d[0] == d[1], d
    np.testing.assert_array_equal(np_(res.ids[0]), [3, 7])


def test_merge_topk_is_numpy_lexsort_on_tied_lists():
    """`merge_topk` equals numpy's lexsort on (dist, id) on lists with many
    exact ties, with non-finite lanes last and -1 where a lane is not
    valid."""
    rng = np.random.default_rng(6)
    d = rng.integers(0, 4, size=(16, 15)).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf
    i = np.stack([rng.permutation(100)[:15] for _ in range(16)]).astype(np.int32)
    lab = rng.integers(0, 3, size=d.shape).astype(np.int32)
    order = np.stack([np.lexsort((ii, dd)) for dd, ii in zip(d, i)])[:, :5]
    want_d = np.take_along_axis(d, order, 1)
    ok = np.isfinite(want_d)
    ids, dists, labels, valid = TD.merge_topk(torch.from_numpy(d), torch.from_numpy(i),
                                              torch.from_numpy(lab), 5)
    assert_dists_close(dists, want_d)
    np.testing.assert_array_equal(np_(valid), ok)
    np.testing.assert_array_equal(np_(ids), np.where(ok, np.take_along_axis(i, order, 1), -1))
    np.testing.assert_array_equal(np_(labels), np.where(ok, np.take_along_axis(lab, order, 1), -1))


# ----------------------------------------------------------------- mutation --


def _opened(seed=7, n=320, n1=256, spill_capacity=None):
    pts, labels = _data(seed, n)
    jp, tp = _proj(pts)
    jidx = _ref_stacked(pts[:n1], labels[:n1], jp, S_MUT)
    jsm = D.open_sharded(jidx, JCFG, spill_capacity=spill_capacity)
    tsm = TD.open_sharded(_carry(jidx), TCFG, spill_capacity=spill_capacity)
    return pts, labels, jp, tp, jsm, tsm


def test_open_insert_delete_snapshot_match_reference():
    """open_sharded, sharded_insert, stacked_snapshot, merge_to_dense and
    sharded_delete against the reference's, state by state array for
    array; the dense merge also equals build_index over the points in
    arrival order."""
    pts, labels, _, tp, jsm, tsm = _opened()
    assert_sharded_state_equal(tsm, jsm, "open_sharded")
    jsm = D.sharded_insert(jsm, JCFG, jnp.asarray(pts[256:]), labels=jnp.asarray(labels[256:]))
    tsm = TD.sharded_insert(tsm, TCFG, pts[256:], labels=labels[256:])
    assert_sharded_state_equal(tsm, jsm, "sharded_insert")
    jsnap, tsnap = D.stacked_snapshot(jsm, JCFG), TD.stacked_snapshot(tsm, TCFG)
    assert_index_equal(tsnap, jsnap)
    dense = TD.merge_to_dense(tsnap, TCFG)
    assert_index_equal(dense, D.merge_to_dense(jsnap, JCFG))
    assert_index_equal(dense, tgrid.build_index(torch.from_numpy(pts), TCFG, tp,
                                                labels=torch.from_numpy(labels)))

    ids = np.asarray([5, 301, 77, 260, 3], np.int32)
    jsm = D.sharded_delete(jsm, JCFG, jnp.asarray(ids))
    tsm = TD.sharded_delete(tsm, TCFG, ids)
    assert_sharded_state_equal(tsm, jsm, "sharded_delete")
    assert tsm.n_live == jsm.n_live == 320 - 5
    assert TD.sharded_stats(tsm) == D.sharded_stats(jsm)
    # the reference's states carried across keep growing as the port's own
    carried = sharded_mutable_from_numpy(_ref_states(jsm), jsm.next_id, TCFG, device="cpu")
    assert_sharded_state_equal(carried, jsm, "carried")
    more, more_ids = pts[:4] + 0.01, np.arange(1000, 1004, dtype=np.int32)
    for a, b in zip(TD.sharded_insert(carried, TCFG, more, ids=more_ids).states,
                    TD.sharded_insert(tsm, TCFG, more, ids=more_ids).states):
        assert_trees_equal(tm.state_to_tree(a), tm.state_to_tree(b), "carried, then grown")


def test_shard_local_compaction_matches_reference():
    """Overflow ONE shard's spill log: it compacts alone, every sibling
    keeps its exact state object, and the states equal the reference's."""
    pts, labels, jp, _, jsm, tsm = _opened(seed=8, n=256, n1=256, spill_capacity=4)
    owner = np.asarray(D.shard_of_points(jnp.asarray(pts), JCFG, jp, S_MUT))
    mine = np.nonzero(owner == 0)[0][:16]
    assert len(mine) >= 8
    tsm2, jsm2, rounds = tsm, jsm, 0
    while tsm2.compactions == 0 and rounds < 40:
        tsm2 = TD.sharded_insert(tsm2, TCFG, pts[mine], labels=labels[mine])
        jsm2 = D.sharded_insert(jsm2, JCFG, jnp.asarray(pts[mine]), labels=jnp.asarray(labels[mine]))
        rounds += 1
    assert tsm2.compactions == 1 and tsm2.compact_s > 0.0, rounds
    for s in range(1, S_MUT):
        assert tsm2.states[s] is tsm.states[s], f"sibling {s} was touched"
    assert_sharded_state_equal(tsm2, jsm2, "after a shard-local compaction")


def test_sharded_delete_strict_accounting():
    pts, labels = _data(9, 128)
    _, tp = _proj(pts)
    s = tapi.ActiveSearcher.build_sharded(pts, n_shards=S, labels=labels, cfg=TCFG, proj=tp,
                                          device="cpu")
    with pytest.raises(KeyError, match="not live"):
        s.delete(np.asarray([3, 999], np.int32))
    s2 = s.delete(np.asarray([3], np.int32))
    with pytest.raises(KeyError, match="not live"):
        s2.delete(np.asarray([3], np.int32))
    # lenient: unknown ids are ignored
    sm = TD.sharded_delete(s2.mutable, TCFG, np.asarray([3, 999, 4], np.int32), strict=False)
    assert sm.n_live == 126


# ------------------------------------------------------------------- facade --


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_facade_mutation_equals_sharded_rebuild(metric):
    """build_sharded(P1).insert(P2).delete(D) == build_sharded of the
    survivors: every field of search (both modes) and of classify; the
    snapshot equals the dense build_index of the survivors."""
    cfg = tgrid.GridConfig(**{**CFG_KW, "metric": metric})
    pts, labels = _data(11, 384)
    _, tp = _proj(pts)
    dead = np.random.default_rng(12).choice(384, size=48, replace=False).astype(np.int32)
    keep = np.setdiff1d(np.arange(384), dead).astype(np.int32)
    build = lambda p, lab, **kw: tapi.ActiveSearcher.build_sharded(  # noqa: E731
        p, n_shards=S, labels=lab, cfg=cfg, proj=tp, device="cpu", **kw)
    grown = build(pts[:288], labels[:288]).insert(pts[288:], labels=labels[288:]).delete(dead)
    ref = build(pts[keep], labels[keep], ids=keep)
    assert grown.plan.backend == "sharded" and grown.sharded
    assert_index_equal(grown.index, ref.index)
    q = _queries(13, pts)
    for mode in ("refined", "paper"):
        assert_results_match(grown.search(q, 8, mode=mode), ref.search(q, 8, mode=mode))
    np.testing.assert_array_equal(np_(grown.classify(q, 8)), np_(ref.classify(q, 8)))
    for kw in ({"chunk_size": 3}, {"adaptive_r0": True}):
        assert_results_match(grown.with_plan(**kw).search(q, 8), ref.with_plan(**kw).search(q, 8))
    st = grown.stats()
    assert st["n_points"] == 336 and sum(st["shard_points"]) == 336 and st["n_shards"] == S
    assert st["sharded"] and st["mutable"] and st["compactions"] == 0

    snap = grown.snapshot()
    assert snap.plan.backend == "torch" and not snap.sharded and snap.mutable is None
    dense = tgrid.build_index(torch.from_numpy(pts[keep]), cfg, tp,
                              labels=torch.from_numpy(labels[keep]), ids=torch.from_numpy(keep))
    assert_index_equal(snap.index, dense)
    assert_results_match(snap.search(q, 8),
                         tapi.ActiveSearcher.from_index(dense, cfg, device="cpu")
                         .with_plan(backend="torch").search(q, 8))


def test_sharded_backend_contract():
    pts, labels = _data(16, 128)
    _, tp = _proj(pts)
    s = tapi.ActiveSearcher.build_sharded(pts, n_shards=2, labels=labels, cfg=TCFG, proj=tp,
                                          device="cpu")
    impl = tapi.get_backend("sharded")
    assert impl.supports_mutation and impl.supports_adaptive_r0 and impl.count_at is None
    with pytest.raises(ValueError, match="refined"):
        s.classify(pts[:4], 5, mode="paper")
    dense = tapi.ActiveSearcher.build(pts, labels=labels, cfg=TCFG, proj=tp, device="cpu")
    with pytest.raises(ValueError, match="build_sharded"):
        dense.with_plan(backend="sharded").search(pts[:4], 5)
    with pytest.raises(ValueError, match="n_shards"):
        TD.build_sharded_index(pts, TCFG, tp, 0, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        sharded_index_from_numpy({"offsets": np.zeros(5, np.int32)}, TCFG, device="cpu")
    assert s.search(np.zeros((0, 2), np.float32), 5).ids.shape == (0, 5)


@pytest.mark.gpu
def test_gpu_sharded_tier_equals_the_cpu():
    """On the card: the sharded handle's build, search, classify, insert,
    delete and snapshot equal the same calls on the CPU, field for field."""
    dev = require_cuda()
    pts, labels = _data(17, 4096)
    _, tp = _proj(pts)
    q = _queries(18, pts, b=64)
    runs = {}
    for d in ("cpu", dev):
        s = tapi.ActiveSearcher.build_sharded(pts[:3584], n_shards=S, labels=labels[:3584],
                                              cfg=TCFG, proj=tp.to(d), device=d)
        s = s.insert(pts[3584:], labels=labels[3584:]).delete(np.arange(0, 4096, 7, dtype=np.int32))
        assert s.device.type == torch.device(d).type
        runs[str(d)] = (s.search(q, 11), s.classify(q, 11), s.snapshot().index)
    (cs, cc, ci), (gs, gc, gi) = runs["cpu"], runs[str(dev)]
    assert_results_match(gs, cs)
    np.testing.assert_array_equal(np_(gc), np_(cc))
    assert_index_equal(gi, ci)
