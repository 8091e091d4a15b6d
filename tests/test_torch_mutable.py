"""The port's mutable index (core/mutable.py and the facade's insert /
delete / snapshot) against the JAX package's.

Both packages open the same built index; the same numpy batches then go
through `repro.core.mutable` and `repro_torch.core.mutable`, and the two
states are held equal array for array through `state_to_tree` (dtype,
shape and every element).  The snapshot must equal the port's own
`build_index` of the survivors bit for bit, the facade's insert == rebuild
must hold on every port backend that can search, and a snapshot must keep
its results while its source goes on mutating: PyTorch tensors are
mutable, so that isolation is the port's to keep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import (
    assert_index_equal,
    assert_results_match,
    assert_trees_equal,
    np_,
    require_cuda,
)

from repro import api as japi
from repro.core import grid as jgrid
from repro.core import mutable as jm
from repro.core import projection as jproj
from repro_torch import api as tapi
from repro_torch.convert import index_from_numpy, mutable_from_numpy
from repro_torch.core import grid as tgrid
from repro_torch.core import mutable as tm
from repro_torch.core.projection import apply as project

CFG_KW = dict(grid_size=128, tile=16, n_classes=3, window=48, row_cap=48, r0=8, k_slack=2.0)
SMALL_KW = dict(grid_size=64, tile=8, window=16, row_cap=32, r0=4, k_slack=2.0)
JCFG, TCFG = jgrid.GridConfig(**CFG_KW), tgrid.GridConfig(**CFG_KW)
JSMALL, TSMALL = jgrid.GridConfig(**SMALL_KW), tgrid.GridConfig(**SMALL_KW)
# the reference's backend names and the port's (package docstring)
BACKEND_MAP = {"jnp": "torch", "pallas": "hopper", "pallas_gather": "hopper_gather",
               "pallas_q8": "hopper_q8", "pallas_stacked": "hopper_stacked", "exact": "exact",
               "sharded": "sharded"}


def _data(seed, n, scale=1.0, d=2):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    return pts, rng.integers(0, 3, size=n).astype(np.int32)


def _open(pts, labels, cfgs=(JCFG, TCFG), proj_pts=None, **layout):
    """The same built index opened for mutation in both packages."""
    jcfg, tcfg = cfgs
    proj = jproj.identity_projection(jnp.asarray(pts if proj_pts is None else proj_pts))
    jidx = jgrid.build_index(jnp.asarray(pts), jcfg, proj,
                             labels=None if labels is None else jnp.asarray(labels))
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), tcfg, device="cpu")
    return jm.from_index(jidx, jcfg, **layout), tm.from_index(tidx, tcfg, **layout)


def assert_state_equal(js, ts, msg=""):
    """Array for array through state_to_tree: keys, dtypes, shapes, values."""
    assert_trees_equal(tm.state_to_tree(ts), jm.state_to_tree(js), msg)


# ------------------------------------------------------ state, array by array


def test_from_index_state_matches_reference():
    pts, labels = _data(0, 1500)
    js, ts = _open(pts, labels)
    assert_state_equal(js, ts, "from_index")
    js, ts = _open(pts, labels, slack=0.3, min_slack=2, spill_capacity=77, next_id=4000)
    assert_state_equal(js, ts, "from_index(slack=0.3, min_slack=2, ...)")


@pytest.mark.parametrize("case", ["fit", "spill", "new_cell", "custom_ids"])
def test_insert_state_matches_reference(case):
    """Inserts that fit their bucket's slack, overflow it into the spill
    log, open a cell that was empty at layout time, and carry their own
    ids: the same state as the reference's, and a snapshot equal to the
    port's own rebuild of the union."""
    pts, labels = _data(1, 1200)
    base, more = pts[:1000], pts[1000:]
    lab_b, lab_m = labels[:1000], labels[1000:]
    ids = None
    if case == "fit":        # a few points on top of existing ones: slack absorbs them
        more, lab_m = base[:40] + 1e-4, lab_b[:40]
    elif case == "spill":    # 80 points into one crowded cell: past its slack
        more, lab_m = np.repeat(base[:1], 80, axis=0), np.zeros(80, np.int32)
    elif case == "new_cell":  # far points: cells with no bucket at all
        more = (np.random.default_rng(2).normal(size=(60, 2)) * 0.5 + 3.2).astype(np.float32)
        lab_m = labels[:60]
    else:
        ids = np.arange(5000, 5000 + len(more), dtype=np.int32)[::-1].copy()
    allp = np.concatenate([base, more])
    js, ts = _open(base, lab_b, proj_pts=allp)
    jk = {"labels": jnp.asarray(lab_m)} | ({} if ids is None else {"ids": jnp.asarray(ids)})
    tk = {"labels": lab_m} | ({} if ids is None else {"ids": ids})
    js2 = jm.insert(js, JCFG, jnp.asarray(more), **jk)
    ts2 = tm.insert(ts, TCFG, more, **tk)
    assert_state_equal(js2, ts2, case)
    if case in ("spill", "new_cell"):
        assert int(ts2.spill_used) > 0
    elif case == "fit":
        assert int(ts2.spill_used) == 0
    assert all(tm.validate_mutable(ts2, TCFG).values())
    # the snapshot is the port's own rebuild of the union
    all_ids = None if ids is None else np.concatenate([np.arange(1000, dtype=np.int32), ids])
    rebuilt = tgrid.build_index(torch.from_numpy(allp), TCFG, ts.proj,
                                labels=torch.from_numpy(np.concatenate([lab_b, lab_m])),
                                ids=None if all_ids is None else torch.from_numpy(all_ids))
    assert_index_equal(tm.snapshot(ts2, TCFG), rebuilt)
    assert int(ts2.next_id) == int(js2.next_id)


@pytest.mark.parametrize("strict", [True, False])
def test_delete_state_matches_reference(strict):
    pts, labels = _data(3, 1500)
    js, ts = _open(pts, labels)
    kill = np.random.default_rng(4).choice(1500, size=400, replace=False).astype(np.int32)
    if not strict:   # unknown ids are ignored
        kill = np.concatenate([kill, np.array([9999, 123456], np.int32)])
    js2 = jm.delete(js, JCFG, jnp.asarray(kill), strict=strict)
    ts2 = tm.delete(ts, TCFG, kill, strict=strict)
    assert_state_equal(js2, ts2, f"delete strict={strict}")
    keep = np.setdiff1d(np.arange(1500), kill)
    rebuilt = tgrid.build_index(torch.from_numpy(pts[keep]), TCFG, ts.proj,
                                labels=torch.from_numpy(labels[keep]),
                                ids=torch.from_numpy(keep.astype(np.int32)))
    assert_index_equal(tm.snapshot(ts2, TCFG), rebuilt)


def test_delete_unknown_id_strict_raises_as_reference():
    pts, _ = _data(5, 100)
    js, ts = _open(pts, None, cfgs=(JSMALL, TSMALL))
    with pytest.raises(KeyError, match="1 of 2 ids are not live"):
        jm.delete(js, JSMALL, jnp.asarray([5, 9999], jnp.int32))
    with pytest.raises(KeyError, match="1 of 2 ids are not live"):
        tm.delete(ts, TSMALL, np.array([5, 9999], np.int32))
    assert tm.delete(ts, TSMALL, np.zeros(0, np.int32)) is ts


def test_delete_colliding_ids_matches_reference():
    """A caller-supplied duplicate of a live id: delete(id) kills both
    carriers in both packages, and the strict check counts ids, not slots."""
    pts, _ = _data(6, 100)
    js, ts = _open(pts, None, cfgs=(JSMALL, TSMALL))
    js = jm.insert(js, JSMALL, jnp.asarray(pts[5:6] + 0.01), ids=jnp.asarray([5], jnp.int32))
    ts = tm.insert(ts, TSMALL, pts[5:6] + 0.01, ids=np.array([5], np.int32))
    assert_state_equal(js, ts, "duplicate id inserted")
    js = jm.delete(js, JSMALL, jnp.asarray([5], jnp.int32))
    ts = tm.delete(ts, TSMALL, np.array([5], np.int32))
    assert_state_equal(js, ts, "both carriers deleted")
    assert int(ts.n_live) == 99
    np.testing.assert_array_equal(np_(tm.ids_live_mask(ts, np.array([4, 5, 6], np.int32))),
                                  np.asarray(jm.ids_live_mask(js, jnp.asarray([4, 5, 6]))))


def test_interleaved_sequence_matches_reference():
    """Mixed rounds from an EMPTY index: the state after every step equals
    the reference's, and the end equals a rebuild of the survivors."""
    pts, labels = _data(7, 900)
    proj = jproj.identity_projection(jnp.asarray(pts))
    jidx = jgrid.build_index(jnp.zeros((0, 2), jnp.float32), JCFG, proj,
                             labels=jnp.zeros((0,), jnp.int32))
    js = jm.from_index(jidx, JCFG)
    ts = tm.from_index(index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), TCFG,
                                        device="cpu"), TCFG)
    steps = [("insert", slice(0, 300)), ("insert", slice(300, 700)),
             ("delete", np.arange(100, 250, dtype=np.int32)), ("insert", slice(700, 900)),
             ("delete", np.arange(600, 650, dtype=np.int32))]
    for i, (op, arg) in enumerate(steps):
        if op == "insert":
            js = jm.insert(js, JCFG, jnp.asarray(pts[arg]), labels=jnp.asarray(labels[arg]))
            ts = tm.insert(ts, TCFG, pts[arg], labels=labels[arg])
        else:
            js = jm.delete(js, JCFG, jnp.asarray(arg))
            ts = tm.delete(ts, TCFG, arg)
        assert_state_equal(js, ts, f"step {i} {op}")
    keep = np.r_[0:100, 250:600, 650:900]
    rebuilt = tgrid.build_index(torch.from_numpy(pts[keep]), TCFG, ts.proj,
                                labels=torch.from_numpy(labels[keep]),
                                ids=torch.from_numpy(keep.astype(np.int32)))
    snap = tm.snapshot(ts, TCFG)
    assert_index_equal(snap, rebuilt)
    assert all(tgrid.validate_invariants(snap, TCFG).values())


@pytest.mark.parametrize("policy", ["raise", "compact", "tracked"])
def test_overflow_matches_reference(policy):
    """A spill log of 4 slots and 64 points into fresh cells: `raise`
    raises in both packages with the same message; `compact` (and
    `insert_tracked`, which reports one compaction) re-layout and retry
    into the same state as the reference's."""
    pts, _ = _data(8, 500)
    far = (np.random.default_rng(9).normal(size=(64, 2)) * 3).astype(np.float32)
    allp = np.concatenate([pts, far])
    js, ts = _open(pts, None, proj_pts=allp, spill_capacity=4)
    if policy == "raise":
        with pytest.raises(jm.BucketOverflow) as jerr:
            jm.insert(js, JCFG, jnp.asarray(far), on_overflow="raise")
        with pytest.raises(tm.BucketOverflow) as terr:
            tm.insert(ts, TCFG, far, on_overflow="raise")
        assert str(terr.value) == str(jerr.value)
        return
    if policy == "compact":
        js2, ts2 = jm.insert(js, JCFG, jnp.asarray(far)), tm.insert(ts, TCFG, far)
    else:
        js2, jrep = jm.insert_tracked(js, JCFG, jnp.asarray(far))
        ts2, trep = tm.insert_tracked(ts, TCFG, far)
        assert trep.compactions == jrep.compactions == 1 and trep.compact_s > 0
        ts3, rep0 = tm.insert_tracked(ts2, TCFG, far[:2] + 0.01)
        assert rep0 == (0, 0.0)
    assert_state_equal(js2, ts2, policy)
    assert ts2.spill_capacity == 64 and ts.spill_capacity == 4
    rebuilt = tgrid.build_index(torch.from_numpy(allp), TCFG, ts.proj)
    assert_index_equal(tm.snapshot(ts2, TCFG), rebuilt)


def test_overflow_retry_survives_slack_retightening():
    """compact() shrinks bucket slack, so points that FIT the old layout can
    spill in the fresh one: the retry's spill log covers the whole batch."""
    pts = np.zeros((100, 2), np.float32) + 0.5
    far = (np.random.default_rng(10).normal(size=(8, 2)) * 3 + 10).astype(np.float32)
    js, ts = _open(pts, None, proj_pts=np.concatenate([pts, far]), spill_capacity=4)
    js = jm.delete(js, JCFG, jnp.arange(90, dtype=jnp.int32))
    ts = tm.delete(ts, TCFG, np.arange(90, dtype=np.int32))
    batch = np.concatenate([np.zeros((40, 2), np.float32) + 0.5, far])
    js2, ts2 = jm.insert(js, JCFG, jnp.asarray(batch)), tm.insert(ts, TCFG, batch)
    assert_state_equal(js2, ts2, "retry")
    assert int(ts2.n_live) == 58


@pytest.mark.parametrize("op", ["compact", "rebuild"])
def test_compact_and_rebuild_match_reference(op):
    pts, labels = _data(11, 800)
    js, ts = _open(pts, labels)
    js = jm.insert(js, JCFG, jnp.asarray(pts[:50] + 0.01), labels=jnp.asarray(labels[:50]))
    ts = tm.insert(ts, TCFG, pts[:50] + 0.01, labels=labels[:50])
    js = jm.delete(js, JCFG, jnp.arange(0, 200, dtype=jnp.int32))
    ts = tm.delete(ts, TCFG, np.arange(0, 200, dtype=np.int32))
    js2, ts2 = getattr(jm, op)(js, JCFG), getattr(tm, op)(ts, TCFG)
    assert_state_equal(js2, ts2, op)
    assert_index_equal(tm.snapshot(ts2, TCFG), tm.snapshot(ts, TCFG))
    assert int(ts2.spill_used) == 0 and int(ts2.next_id) == int(ts.next_id)
    assert all(tm.validate_mutable(ts2, TCFG).values())


def test_sat_counter_matches_reference():
    kw = {**SMALL_KW, "counter": "sat"}
    jcfg, tcfg = jgrid.GridConfig(**kw), tgrid.GridConfig(**kw)
    pts, _ = _data(12, 400)
    js, ts = _open(pts[:300], None, cfgs=(jcfg, tcfg), proj_pts=pts)
    js = jm.insert(js, jcfg, jnp.asarray(pts[300:]))
    ts = tm.insert(ts, tcfg, pts[300:])
    assert_state_equal(js, ts, "sat")
    snap = tm.snapshot(ts, tcfg)
    assert snap.pyr_tiles is None
    assert_index_equal(snap, jm.snapshot(js, jcfg))
    assert_index_equal(snap, tgrid.build_index(torch.from_numpy(pts), tcfg, ts.proj))


def test_dirty_tile_refresh_and_full_reflatten():
    """A small insert re-gathers only the dirty tiles; a batch touching a
    quarter of the tile rows re-flattens them all: both give the tiles of
    the delta-updated pyramid, as the reference's do."""
    pts, _ = _data(13, 600)
    js, ts = _open(pts, None, cfgs=(JSMALL, TSMALL))
    for batch in (pts[:3] + 0.01, (np.random.default_rng(14).uniform(-3, 3, (400, 2))
                                   .astype(np.float32))):
        js = jm.insert(js, JSMALL, jnp.asarray(batch))
        ts = tm.insert(ts, TSMALL, batch)
        assert_state_equal(js, ts, f"batch of {len(batch)}")
        assert torch.equal(ts.pyr_tiles, tgrid.flatten_pyramid_tiles(ts.pyramid, 8))


def test_insert_equals_rebuild_under_a_dense_projection():
    """d = 37 under a Gaussian projection, whose product sums 37 terms: a
    point's coordinates must not depend on the batch it is projected in,
    so the inserted points land where the rebuild puts them, bit for bit;
    rows projected one at a time equal the batch's."""
    rng = np.random.default_rng(25)
    pts = torch.from_numpy((rng.normal(size=(900, 37)) * 2).astype(np.float32))
    proj = tapi.gaussian_projection(torch.Generator().manual_seed(3), pts)
    one_by_one = torch.cat([project(proj, pts[i:i + 1]) for i in range(0, 900, 97)])
    assert torch.equal(one_by_one, project(proj, pts)[::97])
    state = tm.from_index(tgrid.build_index(pts[:700], TSMALL, proj), TSMALL)
    for lo in range(700, 900, 50):
        state = tm.insert(state, TSMALL, pts[lo:lo + 50])
    assert_index_equal(tm.snapshot(state, TSMALL), tgrid.build_index(pts, TSMALL, proj))


def test_state_round_trips_through_state_to_tree():
    pts, labels = _data(15, 600)
    _, ts = _open(pts, labels)
    ts = tm.delete(tm.insert(ts, TCFG, pts[:80] * 0.9, labels=labels[:80]), TCFG,
                   np.arange(10, dtype=np.int32))
    back = tm.state_from_tree({k: np_(v) for k, v in tm.state_to_tree(ts).items()},
                              device="cpu")
    assert_index_equal(tm.snapshot(back, TCFG), tm.snapshot(ts, TCFG))
    more = pts[100:150] * 1.05
    assert_index_equal(tm.snapshot(tm.insert(back, TCFG, more), TCFG),
                       tm.snapshot(tm.insert(ts, TCFG, more), TCFG))


def test_jax_state_carried_into_the_port_keeps_growing():
    """A state built and grown by the reference, carried across with
    `mutable_from_numpy`, then grown further in both packages: equal at
    every step."""
    pts, labels = _data(16, 1400)
    js, _ = _open(pts[:1000], labels[:1000], proj_pts=pts, spill_capacity=32)
    js = jm.insert(js, JCFG, jnp.asarray(pts[1000:1200]), labels=jnp.asarray(labels[1000:1200]))
    js = jm.delete(js, JCFG, jnp.arange(0, 1200, 7, dtype=jnp.int32))
    ts = mutable_from_numpy({k: np.asarray(v) for k, v in jm.state_to_tree(js).items()},
                            TCFG, device="cpu")
    assert_state_equal(js, ts, "carried")
    js2, jrep = jm.insert_tracked(js, JCFG, jnp.asarray(pts[1200:]),
                                  labels=jnp.asarray(labels[1200:]))
    ts2, trep = tm.insert_tracked(ts, TCFG, pts[1200:], labels=labels[1200:])
    assert trep.compactions == jrep.compactions
    assert_state_equal(js2, ts2, "grown in both")
    assert_index_equal(tm.snapshot(ts2, TCFG), jm.snapshot(js2, JCFG))
    with pytest.raises(ValueError, match="levels"):
        mutable_from_numpy({k: np.asarray(v) for k, v in jm.state_to_tree(js).items()},
                           tgrid.GridConfig(**{**CFG_KW, "grid_size": 256}), device="cpu")


# ------------------------------------------------------------------ facade --


def _handles(seed=17, n=1200, n1=900):
    """(reference handle grown by insert, port handle grown by insert, port
    handle rebuilt from the union, queries)."""
    pts, labels = _data(seed, n)
    q = np.random.default_rng(seed + 1).normal(size=(16, 2)).astype(np.float32)
    jproj_ = jproj.identity_projection(jnp.asarray(pts))
    jidx = jgrid.build_index(jnp.asarray(pts[:n1]), JCFG, jproj_, labels=jnp.asarray(labels[:n1]))
    jgrown = japi.ActiveSearcher.from_index(jidx, JCFG).insert(
        jnp.asarray(pts[n1:]), labels=jnp.asarray(labels[n1:]))
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), TCFG, device="cpu")
    tgrown = tapi.ActiveSearcher.from_index(tidx, TCFG, device="cpu").insert(
        pts[n1:], labels=labels[n1:])
    tref = tapi.ActiveSearcher.build(pts, labels=labels, cfg=TCFG, proj=tidx.proj, device="cpu")
    return jgrown, tgrown, tref, q


@pytest.fixture(scope="module")
def grown():
    return _handles()


def test_facade_insert_equals_rebuild_on_every_backend(grown):
    """build(P1).insert(P2) equals build(P1 ∪ P2) — every field of search
    in both modes, classify, and adaptive_r0 where the backend takes it —
    on every port backend that can search; and each equals the reference's
    grown handle on its counterpart backend."""
    jgrown, tgrown, tref, q = grown
    assert_index_equal(tgrown.index, tref.index)
    # every backend that searches a dense handle (`sharded` searches only a
    # build_sharded handle: tests/test_torch_sharded.py)
    names = [n for n in tapi.registered_backends()
             if tapi.get_backend(n).search is not None and n != "sharded"]
    assert set(names) == {"torch", "hopper", "hopper_gather", "hopper_q8", "exact"}
    reverse = {v: k for k, v in BACKEND_MAP.items()}
    for name in names:
        impl = tapi.get_backend(name)
        a, b = tgrown.with_plan(backend=name), tref.with_plan(backend=name)
        j = jgrown.with_plan(backend=reverse[name])
        for mode in ("refined", "paper"):
            got = a.search(q, 8, mode=mode)
            want = b.search(q, 8, mode=mode)
            for field in want._fields:
                assert torch.equal(getattr(got, field), getattr(want, field)), (name, mode, field)
            if name != "exact":
                assert_results_match(got, j.search(jnp.asarray(q), 8, mode=mode))
            assert torch.equal(a.classify(q, 8, mode=mode), b.classify(q, 8, mode=mode)), name
        np.testing.assert_array_equal(np_(a.classify(q, 8)), np.asarray(j.classify(jnp.asarray(q), 8)))
        if impl.supports_adaptive_r0:
            got = a.with_plan(adaptive_r0=True).search(q, 8)
            want = b.with_plan(adaptive_r0=True).search(q, 8)
            for field in want._fields:
                assert torch.equal(getattr(got, field), getattr(want, field)), (name, field)
        if impl.count_at is not None:
            radii = np.arange(16, dtype=np.int32) * 2
            assert torch.equal(a.count_at(q, radii), b.count_at(q, radii)), name


def test_facade_count_at_on_hopper_stacked_after_insert(grown):
    """`hopper_stacked` refuses mutation but counts on a mutated pyramid."""
    _, tgrown, tref, q = grown
    radii = np.arange(16, dtype=np.int32) * 3
    got = tgrown.with_plan(backend="hopper_stacked").count_at(q, radii)
    assert torch.equal(got, tref.with_plan(backend="hopper_stacked").count_at(q, radii))


def test_facade_stats_match_reference(grown):
    jgrown, tgrown, _, _ = grown
    want, got = jgrown.stats(), tgrown.stats()
    for key in ("n_points", "mutable", "free_bucket_slots", "spill_used", "spill_capacity",
                "compactions"):
        assert got[key] == want[key], key
    assert tgrown.snapshot().stats()["mutable"] is False


def test_facade_delete_then_exact_forgets_points():
    """Deleted points are gone from `exact`, whose cached original-order
    view must not survive the mutation; the source handle keeps its own."""
    pts, labels = _data(18, 600)
    s = tapi.ActiveSearcher.build(pts, labels=labels, cfg=TCFG,
                                  plan=tapi.ExecutionPlan(backend="exact"),
                                  proj=tapi.identity_projection(torch.from_numpy(pts)),
                                  device="cpu")
    q = pts[:4]
    before = s.search(q, 1)
    assert "_exact_ordered" in s.__dict__
    np.testing.assert_array_equal(np_(before.ids[:, 0]), np.arange(4))
    s2 = s.delete(np.arange(4, dtype=np.int32))
    assert "_exact_ordered" not in s2.__dict__
    assert not np.intersect1d(np_(s2.search(q, 1).ids), np.arange(4)).size
    after = s.search(q, 1)
    for field in before._fields:
        assert torch.equal(getattr(after, field), getattr(before, field)), field


@pytest.mark.parametrize("backend", ["hopper", "torch", "hopper_q8"])
def test_snapshot_isolation_under_continued_mutation(backend):
    """A frozen snapshot keeps its results while the source goes on
    inserting and deleting: no update writes a tensor a snapshot holds."""
    pts, labels = _data(19, 800)
    s = tapi.ActiveSearcher.build(
        pts, labels=labels, cfg=TCFG, plan=tapi.ExecutionPlan(backend=backend),
        proj=tapi.identity_projection(torch.from_numpy(np.concatenate([pts, pts * 2]))),
        device="cpu")
    q = np.random.default_rng(20).normal(size=(8, 2)).astype(np.float32)
    frozen = s.snapshot()
    want = frozen.search(q, 8)
    held = [t.clone() for t in frozen.index if isinstance(t, torch.Tensor)]
    live = s
    for step in range(3):
        live = live.insert(pts[:100] * (1.1 + step), labels=labels[:100])
        live = live.delete(live.index.ids_sorted[:10])
        got = frozen.search(q, 8)
        for field in want._fields:
            assert torch.equal(getattr(got, field), getattr(want, field)), (step, field)
    now = [t for t in frozen.index if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(held, now))
    assert live.index.n_points == 800 + 3 * 100 - 3 * 10
    assert frozen.stats()["mutable"] is False and live.stats()["mutable"] is True


def test_two_inserts_from_one_parent_do_not_see_each_other():
    pts, _ = _data(21, 300)
    s = tapi.ActiveSearcher.build(pts, cfg=TCFG, proj=tapi.identity_projection(
        torch.from_numpy(pts)), device="cpu")
    a = s.insert(pts[:10] + 0.01)
    parent_state = {k: v.clone() for k, v in tm.state_to_tree(a.mutable).items()}
    b = a.insert(pts[:5] + 0.02)
    c = a.insert(pts[5:12] + 0.03)
    assert (a.index.n_points, b.index.n_points, c.index.n_points) == (310, 315, 317)
    for key, v in tm.state_to_tree(a.mutable).items():
        assert torch.equal(v, parent_state[key]), key
    # each child holds its own batch and not its sibling's
    has = lambda h, x: np.isin(np_(h.index.points_sorted[:, 0]), x[:, 0])  # noqa: E731
    assert has(b, pts[:5] + 0.02).sum() == 5 and not has(b, pts[5:12] + 0.03).any()
    assert has(c, pts[5:12] + 0.03).sum() == 7 and not has(c, pts[:5] + 0.02).any()
    frozen = a.snapshot()
    d = frozen.insert(pts[:5] + 0.04)
    assert d.index.n_points == 315 and a.index.n_points == 310


def test_hopper_stacked_refuses_mutation_as_reference():
    """Capability, not name: the reference's message, listing the backends
    that can mutate, on insert and on delete."""
    pts, labels = _data(22, 64)
    kw = dict(grid_size=32, tile=8, window=8, row_cap=16, r0=4)
    s = tapi.ActiveSearcher.build(pts, labels=labels, cfg=tgrid.GridConfig(**kw),
                                  plan=tapi.ExecutionPlan(backend="hopper_stacked"),
                                  proj=tapi.identity_projection(torch.from_numpy(pts)),
                                  device="cpu")
    assert not tapi.get_backend("hopper_stacked").supports_mutation
    msg = ("backend 'hopper_stacked' does not support mutation "
           "(BackendImpl.supports_mutation); insert/delete need one of "
           "['exact', 'hopper', 'hopper_gather', 'hopper_q8', 'sharded', 'torch']")
    with pytest.raises(ValueError) as err:
        s.insert(pts[:2])
    assert str(err.value) == msg
    with pytest.raises(ValueError, match="supports_mutation"):
        s.delete(np.array([0], np.int32))


def test_supports_mutation_matches_reference():
    for jname, tname in BACKEND_MAP.items():
        assert (tapi.get_backend(tname).supports_mutation
                == japi.get_backend(jname).supports_mutation), (jname, tname)


@pytest.mark.gpu
def test_gpu_insert_then_search_equals_rebuild():
    """On the card: the facade's insert and delete, then search on every
    mutable backend, equal to a rebuild of the survivors (the kernels run
    on the mutated tiles and CSR arrays)."""
    dev = require_cuda()
    pts, labels = _data(23, 20_000)
    q = np.random.default_rng(24).normal(size=(256, 2)).astype(np.float32)
    proj = tapi.identity_projection(torch.from_numpy(pts).to(dev))
    s = tapi.ActiveSearcher.build(pts[:16_000], labels=labels[:16_000], cfg=TCFG, proj=proj,
                                  device=dev)
    grown = s.insert(pts[16_000:], labels=labels[16_000:]).delete(np.arange(0, 20_000, 9))
    keep = np.setdiff1d(np.arange(20_000), np.arange(0, 20_000, 9)).astype(np.int32)
    ref = tapi.ActiveSearcher.build(pts[keep], labels=labels[keep], ids=keep, cfg=TCFG,
                                    proj=proj, device=dev)
    assert_index_equal(grown.index, ref.index)
    for name in ("hopper", "hopper_gather", "hopper_q8", "torch", "exact"):
        a, b = grown.with_plan(backend=name), ref.with_plan(backend=name)
        for mode in ("refined", "paper"):
            got, want = a.search(q, 8, mode=mode), b.search(q, 8, mode=mode)
            for field in want._fields:
                assert torch.equal(getattr(got, field), getattr(want, field)), (name, field)
        assert torch.equal(a.classify(q, 8), b.classify(q, 8)), name
