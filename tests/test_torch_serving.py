"""The port's search side of serving against the JAX package's: the kNN-LM
head (core/knn_lm.py), retrieval memory (core/retrieval_memory.py), the
checkpoint store (checkpoint/store.py) and the dynamic batching queue
(launch/serve.py::DynamicBatcher).

Datastores are built by the reference and carried across with
`convert.index_from_numpy` (the PCA projection's eigenvector signs are
not pinned, and JAX's PRNG has no torch counterpart), so both packages
search the same arrays.  Tolerances: ids, positions, validity, states and
stats exact; f32 distances to DIST_RTOL; kNN-LM probabilities to 1e-5
relative on the same support (tied tokens may be scatter-added in another
order).
"""

import asyncio
import os

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

from repro.checkpoint.store import CheckpointManager as JCheckpointManager
from repro.core import knn_lm as jknn
from repro.core import mutable as jm
from repro.core import retrieval_memory as jrm
from repro.core.grid import GridConfig as JGridConfig
from repro.core.grid import build_index as jbuild
from repro.core.projection import identity_projection as jidentity
from repro.launch.serve import DynamicBatcher as JDynamicBatcher
from repro_torch import api as tapi
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.convert import index_from_numpy, mutable_from_numpy, projection_from_numpy
from repro_torch.core import grid as tgrid
from repro_torch.core import knn_lm as tknn
from repro_torch.core import mutable as tm
from repro_torch.core import retrieval_memory as trm
from repro_torch.launch.serve import DynamicBatcher, ServeConfig, _pow2

VOCAB, D_MODEL = 512, 16
P_RTOL = 1e-5


COORD_FREE = ("points_sorted", "labels_sorted", "ids_sorted", "offsets")


def _carry(jidx, cfg):
    return index_from_numpy(jax.tree.map(np.asarray, jidx)._asdict(), cfg, device="cpu")


def assert_index_matches_reference(got, want):
    """A GridIndex the port projected itself against the reference's: the
    grid coords within DIST_RTOL (the port sums a point's d products in
    another order than XLA's dot), every other array exact."""
    assert_index_equal(got, want, fields=COORD_FREE)
    assert_dists_close(got.coords_sorted, want.coords_sorted)


# ------------------------------------------------------------------ kNN-LM ---


@pytest.fixture(scope="module")
def datastore():
    """2048 (hidden, next token) pairs over vocab 512, k = 16, built by
    the reference (default grid) and carried into the port."""
    rng = np.random.default_rng(0)
    keys = rng.normal(size=(2048, D_MODEL)).astype(np.float32)
    toks = rng.integers(0, VOCAB, size=2048).astype(np.int32)
    jcfg, tcfg = jknn.KNNLMConfig(k=16, lam=0.3), tknn.KNNLMConfig(k=16, lam=0.3)
    jidx = jknn.build_datastore(jnp.asarray(keys), jnp.asarray(toks), jcfg)
    return keys, toks, jcfg, tcfg, jidx, _carry(jidx, tcfg.grid)


def _hidden(keys):
    """Stored keys, fresh queries, and one absurdly far query whose window
    retrieves nothing."""
    rng = np.random.default_rng(1)
    fresh = rng.normal(size=(4, D_MODEL)).astype(np.float32)
    return np.concatenate([keys[[17, 400]], fresh, np.full((1, D_MODEL), 1e4, np.float32)])


def assert_probs_close(got_logp, want_logp):
    """exp of two log-prob arrays: the same support, values to P_RTOL."""
    got, want = np.exp(np_(got_logp).astype(np.float64)), np.exp(np.asarray(want_logp, np.float64))
    np.testing.assert_array_equal(got > 1e-19, want > 1e-19)
    np.testing.assert_allclose(got, want, rtol=P_RTOL, atol=0)


def test_knn_logprobs_matches_reference(datastore):
    keys, _, jcfg, tcfg, jidx, tidx = datastore
    h = _hidden(keys)
    want = jknn.knn_logprobs(jidx, jcfg, jnp.asarray(h), vocab_size=VOCAB)
    got = tknn.knn_logprobs(tidx, tcfg, torch.from_numpy(h), VOCAB)
    assert got.shape == (len(h), VOCAB) and got.dtype == torch.float32
    assert_probs_close(got, want)
    p = np.exp(np_(got).astype(np.float64))
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-5)
    # the far lane retrieved nothing: the uninformative distribution
    res = tapi.ActiveSearcher.from_index(tidx, tcfg.grid, device="cpu").search(h, tcfg.k)
    assert not bool(res.valid[-1].any()) and bool(res.valid[:-1].any(dim=1).all())
    np.testing.assert_allclose(p[-1], 1.0 / VOCAB, rtol=1e-6)
    # a stored key puts mass on its own token
    assert p[0, datastore[1][17]] > 1.0 / VOCAB


def test_interpolate_and_knn_lm_logits_match_reference(datastore):
    keys, _, jcfg, tcfg, jidx, tidx = datastore
    h = _hidden(keys)
    lm = np.random.default_rng(2).normal(size=(len(h), VOCAB)).astype(np.float32) * 3.0
    want = jknn.knn_lm_logits(jidx, jcfg, jnp.asarray(h), jnp.asarray(lm))
    got = tknn.knn_lm_logits(tidx, tcfg, torch.from_numpy(h), torch.from_numpy(lm))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=P_RTOL, atol=1e-6)
    np.testing.assert_allclose(np.exp(np_(got).astype(np.float64)).sum(-1), 1.0, atol=1e-5)
    knn_lp = torch.log_softmax(torch.from_numpy(lm[::-1].copy()), dim=-1)
    np.testing.assert_allclose(
        np_(tknn.interpolate(torch.from_numpy(lm), knn_lp, tcfg)),
        np.asarray(jknn.interpolate(jnp.asarray(lm), jnp.asarray(np_(knn_lp)), jcfg)),
        rtol=P_RTOL, atol=1e-6)


def test_interpolate_and_knn_lm_logits_with_bf16_logits_match_reference(datastore):
    """The model's logits are bf16, and the reference takes their
    log_softmax in bf16, rounding log(1 - lam) + log p_lm to bf16 too;
    only logaddexp promotes to float32.  Tolerance: one bf16 ulp of the
    reference's LM log-probability (a one-ulp change of that term moves
    logaddexp's output by at most one ulp), plus a float32 ulp."""
    keys, _, jcfg, tcfg, jidx, tidx = datastore
    h = _hidden(keys)
    lm = np.random.default_rng(4).normal(size=(len(h), VOCAB)).astype(np.float32) * 3.0
    lm_j, lm_t = jnp.asarray(lm).astype(jnp.bfloat16), torch.from_numpy(lm).to(torch.bfloat16)
    want_lm = np.asarray(jax.nn.log_softmax(lm_j, axis=-1).astype(jnp.float32))
    bf16_ulp = np.spacing(np.abs(want_lm)) * 2.0 ** 16
    knn_lp = np.log(np.random.default_rng(5).dirichlet(np.ones(VOCAB), len(h))).astype(np.float32)
    pairs = [
        (tknn.interpolate(lm_t, torch.from_numpy(knn_lp), tcfg),
         jknn.interpolate(lm_j, jnp.asarray(knn_lp), jcfg)),
        (tknn.knn_lm_logits(tidx, tcfg, torch.from_numpy(h), lm_t),
         jknn.knn_lm_logits(jidx, jcfg, jnp.asarray(h), lm_j)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        want = np.asarray(want)
        err = np.abs(np_(got) - want)
        assert (err <= bf16_ulp + np.spacing(np.abs(want))).all(), float(err.max())
    got_lm = tknn.log_softmax(lm_t)
    assert got_lm.dtype == torch.bfloat16
    assert (np.abs(np_(got_lm.float()) - want_lm) <= bf16_ulp).all()


def test_extend_datastore_matches_reference_and_build(datastore):
    keys, toks, jcfg, tcfg, jidx, tidx = datastore
    rng = np.random.default_rng(3)
    more = rng.normal(size=(96, D_MODEL)).astype(np.float32)
    more_toks = rng.integers(0, VOCAB, size=96).astype(np.int32)
    got = tknn.extend_datastore(tidx, tcfg, more, more_toks)
    assert_index_matches_reference(
        got, jknn.extend_datastore(jidx, jcfg, jnp.asarray(more), jnp.asarray(more_toks)))
    # a datastore the port built itself, grown, == a build over the
    # concatenation with the datastore's projection, bit for bit
    own = tknn.build_datastore(torch.from_numpy(keys), torch.from_numpy(toks), tcfg,
                               proj=tidx.proj)
    union = tknn.build_datastore(torch.from_numpy(np.concatenate([keys, more])),
                                 torch.from_numpy(np.concatenate([toks, more_toks])),
                                 tcfg, proj=tidx.proj)
    assert_index_equal(tknn.extend_datastore(own, tcfg, more, more_toks), union)


def test_logprobs_from_a_batcher_result_equal_knn_logprobs(datastore):
    """The serving split: a DynamicBatcher's SearchResult through
    `logprobs_from_result` equals the one-call `knn_logprobs`."""
    keys, _, _, tcfg, _, tidx = datastore
    h = _hidden(keys)
    q = DynamicBatcher(tapi.ActiveSearcher.from_index(tidx, tcfg.grid, plan=tcfg.plan,
                                                      device="cpu"), k=tcfg.k)
    fut = q.submit(h)
    q.drain()
    np.testing.assert_array_equal(np_(tknn.logprobs_from_result(fut.result(timeout=0), tcfg, VOCAB)),
                                  np_(tknn.knn_logprobs(tidx, tcfg, h, VOCAB)))
    assert ServeConfig(knn=tcfg).knn.k == 16


# -------------------------------------------------------- retrieval memory ---


@pytest.fixture(scope="module")
def memory():
    rng = np.random.default_rng(4)
    jcfg = jrm.RetrievalMemoryConfig(n_retrieved=8)
    tcfg = trm.RetrievalMemoryConfig(n_retrieved=8)
    jproj = jrm.make_projection(jax.random.PRNGKey(0), head_dim=16)
    tproj = projection_from_numpy(*map(np.asarray, jproj), device="cpu")
    keys = (rng.normal(size=(512, 16)) * 0.3).astype(np.float32)
    jidx = jrm.build_memory_index(jnp.asarray(keys), jcfg, jproj)
    tidx = trm.build_memory_index(torch.from_numpy(keys), tcfg, tproj)
    return keys, jcfg, tcfg, jidx, tidx


def test_memory_index_and_retrieval_match_reference(memory):
    keys, jcfg, tcfg, jidx, tidx = memory
    assert_index_matches_reference(tidx, jidx)
    q = np.concatenate([keys[100:102], np.random.default_rng(5).normal(size=(6, 16)) * 0.3]
                       ).astype(np.float32)
    jpos, jok = jrm.retrieve_positions(jidx, jcfg, jnp.asarray(q))
    pos, ok = trm.retrieve_positions(tidx, tcfg, torch.from_numpy(q))
    np.testing.assert_array_equal(np_(pos), np.asarray(jpos))
    np.testing.assert_array_equal(np_(ok), np.asarray(jok))
    assert pos.dtype == torch.int32 and 100 in np_(pos[0])


def test_extend_memory_index_matches_reference_and_build(memory):
    keys, jcfg, tcfg, jidx, tidx = memory
    new = (np.random.default_rng(6).normal(size=(40, 16)) * 0.3).astype(np.float32)
    got = trm.extend_memory_index(tidx, tcfg, new)
    assert_index_matches_reference(got, jrm.extend_memory_index(jidx, jcfg, jnp.asarray(new)))
    assert_index_equal(got, trm.build_memory_index(
        torch.from_numpy(np.concatenate([keys, new])), tcfg, tidx.proj))
    np.testing.assert_array_equal(np.sort(np_(got.ids_sorted)), np.arange(552))


def test_summaries_and_projection():
    rng = np.random.default_rng(7)
    k_heads = rng.normal(size=(32, 8, 16)).astype(np.float32)
    q_heads = rng.normal(size=(4, 32, 16)).astype(np.float32)
    # means of 8 / 32 normal values, summed in another order than XLA's:
    # within a few ulps of the largest term (|x| < 6), not of a mean near 0
    np.testing.assert_allclose(np_(trm.key_summary(torch.from_numpy(k_heads))),
                               np.asarray(jrm.key_summary(jnp.asarray(k_heads))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(trm.query_summary(torch.from_numpy(q_heads))),
                               np.asarray(jrm.query_summary(jnp.asarray(q_heads))),
                               rtol=1e-6, atol=1e-6)
    assert trm.key_summary(torch.from_numpy(k_heads).to(torch.bfloat16)).dtype == torch.float32
    gen = torch.Generator().manual_seed(3)
    proj = trm.make_projection(gen, 16)
    again = trm.make_projection(torch.Generator().manual_seed(3), 16)
    np.testing.assert_array_equal(np_(proj.matrix), np_(again.matrix))
    want = torch.randn((16, 2), generator=torch.Generator().manual_seed(3)) / 4.0
    np.testing.assert_array_equal(np_(proj.matrix), np_(want))
    np.testing.assert_array_equal(np_(proj.lo), [-4.0, -4.0])
    np.testing.assert_array_equal(np_(proj.hi), [4.0, 4.0])


# -------------------------------------------------------------- checkpoint ---


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g), "b": torch.zeros(16)},
        "opt": [torch.ones(3), torch.tensor(7, dtype=torch.int32)],
        "step": torch.tensor(42, dtype=torch.int32),
    }


def _leaves(tree):
    return [tree["params"]["b"], tree["params"]["w"], tree["opt"][0], tree["opt"][1],
            tree["step"]]


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree, blocking=True)
    like = {"params": {"w": torch.empty((8, 16), device="meta"), "b": np.zeros(16)},
            "opt": [torch.empty(3, device="meta"), 0], "step": torch.empty((), device="meta")}
    got = mgr.restore(10, like, device="cpu")
    assert list(got) == list(like) and isinstance(got["opt"], list)
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        np.testing.assert_array_equal(np_(a), np_(b))


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.latest_step() == 4
    assert mgr.list_steps() == [3, 4]


def test_checkpoint_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree())
    mgr.wait()
    assert mgr.latest_step() == 5


def test_checkpoint_no_tmp_dirs_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    bad = _tree()
    bad["params"]["w"] = torch.zeros((9, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, bad, device="cpu")


def test_checkpoint_format_is_the_reference_s(tmp_path):
    """A tree saved by either package restores in the other, key for key."""
    jtree = {"params": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)},
             "opt": [jnp.ones(2), jnp.int32(7)], "step": jnp.int32(3)}
    JCheckpointManager(str(tmp_path / "j")).save(1, jtree, blocking=True)
    like = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), jtree)
    got = CheckpointManager(str(tmp_path / "j")).restore(1, like, device="cpu")
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jax.tree.map(np_, got))):
        np.testing.assert_array_equal(np.asarray(a), b)
    CheckpointManager(str(tmp_path / "t")).save(2, _tree(), blocking=True)
    back = JCheckpointManager(str(tmp_path / "t")).restore(
        2, jax.tree.map(lambda t: jax.ShapeDtypeStruct(t.shape, np_(t).dtype), _tree(),
                        is_leaf=lambda t: isinstance(t, torch.Tensor)))
    for a, b in zip(_leaves(_tree()), _leaves(back)):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


@pytest.fixture(scope="module")
def mutable_pair():
    """The same mutated state in both packages (a built index, one insert)."""
    rng = np.random.default_rng(8)
    cfg_kw = dict(grid_size=64, tile=8, n_classes=3, window=16, row_cap=32, r0=4, k_slack=2.0)
    jcfg, tcfg = JGridConfig(**cfg_kw), tgrid.GridConfig(**cfg_kw)
    pts = rng.normal(size=(600, 2)).astype(np.float32)
    labels = rng.integers(0, 3, size=600).astype(np.int32)
    jproj = jidentity(jnp.asarray(pts))
    jidx = jbuild(jnp.asarray(pts[:500]), jcfg, jproj, labels=jnp.asarray(labels[:500]))
    js = jm.insert(jm.from_index(jidx, jcfg), jcfg, jnp.asarray(pts[500:]),
                   labels=jnp.asarray(labels[500:]))
    tree = {k: np.asarray(v) for k, v in jm.state_to_tree(js).items()}
    return tcfg, jcfg, js, tree


def test_mutable_checkpoint_from_the_reference_restores_in_the_port(tmp_path, mutable_pair):
    tcfg, _, _, tree = mutable_pair
    JCheckpointManager(str(tmp_path)).save(3, tree, blocking=True)
    got = CheckpointManager(str(tmp_path)).restore_mutable_index(3, device="cpu")
    want = mutable_from_numpy(tree, tcfg, device="cpu")
    assert_trees_equal(tm.state_to_tree(got), tm.state_to_tree(want), "restored")
    # and it keeps growing exactly as the carried state does
    more = np.random.default_rng(9).normal(size=(20, 2)).astype(np.float32)
    assert_trees_equal(tm.state_to_tree(tm.insert(got, tcfg, more)),
                       tm.state_to_tree(tm.insert(want, tcfg, more)), "grown")


def test_mutable_checkpoint_from_the_port_restores_in_the_reference(tmp_path, mutable_pair):
    tcfg, jcfg, js, tree = mutable_pair
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_mutable_index(4, mutable_from_numpy(tree, tcfg, device="cpu"), blocking=True)
    back = JCheckpointManager(str(tmp_path)).restore_mutable_index(4)
    assert_trees_equal(jm.state_to_tree(back), jm.state_to_tree(js), "reference restore")
    again = mgr.restore_mutable_index(4, device="cpu")
    assert_index_equal(tm.snapshot(again, tcfg), jm.snapshot(js, jcfg))


# ---------------------------------------------------------- DynamicBatcher ---


QKW = dict(grid_size=64, tile=8, n_classes=3, window=16, row_cap=8, r0=4, k_slack=2.0)
QJCFG, QTCFG = JGridConfig(**QKW), tgrid.GridConfig(**QKW)


def _searcher(seed=10, n=512, scale=1.0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    jproj = jidentity(jnp.asarray(pts))
    jidx = jbuild(jnp.asarray(pts), QJCFG, jproj, labels=jnp.asarray(labels))
    return (tapi.ActiveSearcher.from_index(_carry(jidx, QTCFG), QTCFG, device="cpu"),
            jidx)


def _q(rng, n, scale=1.0):
    return (rng.normal(size=(n, 2)) * scale).astype(np.float32)


def test_queue_padded_search_and_classify_bit_identical_ragged_sizes():
    """Every ragged request size round-trips the queue bit-identically to a
    direct unpadded call — every SearchResult field, and classify — sliced
    to exactly the submitted rows."""
    s, _ = _searcher()
    rng = np.random.default_rng(11)
    for n in range(1, 10):  # crosses the 1/2/4/8/16 pow2 boundaries
        queries = _q(rng, n)
        q = DynamicBatcher(s, k=5)
        fut = q.submit(queries)
        fut_c = q.submit(queries, op="classify")
        q.drain()
        got = fut.result(timeout=0)
        assert all(f.shape[0] == n for f in got)
        assert_results_match(got, s.search(queries, 5))
        for f in got._fields:  # bit for bit, distances too
            np.testing.assert_array_equal(np_(getattr(got, f)),
                                          np_(getattr(s.search(queries, 5), f)), err_msg=f)
        np.testing.assert_array_equal(np_(fut_c.result(timeout=0)), np_(s.classify(queries, 5)))
        assert q.stats["pad_rows"] == 2 * (_pow2(n) - n) and q.stats["batches"] == 2


def test_queue_coalesces_and_slices_per_request():
    s, _ = _searcher()
    rng = np.random.default_rng(12)
    q = DynamicBatcher(s, k=5, max_batch=64)
    sizes = (1, 3, 5, 2)
    queries = [_q(rng, n) for n in sizes]
    futs = [q.submit(x) for x in queries]
    q.drain()
    assert q.stats["batches"] == 1
    assert q.stats["pad_rows"] == _pow2(sum(sizes)) - sum(sizes)
    assert len(q.stats["latencies_s"]) == len(sizes)
    for x, fut in zip(queries, futs):
        assert_results_match(fut.result(timeout=0), s.search(x, 5))
    # max_batch closes a batch once it is reached
    q2 = DynamicBatcher(s, k=5, max_batch=4)
    for x in queries:
        q2.submit(x)
    q2.drain()
    assert q2.stats["batches"] == 3 and q2.stats["batch_rows"] == 11


def test_queue_pads_never_inflate_truncation_stats():
    """truncated_rows counts the REAL rows only: replicated pad rows (which
    truncate whenever the last real row does) are excluded."""
    s, _ = _searcher(seed=7, scale=0.05)  # clustered: buckets overflow row_cap = 8
    queries = _q(np.random.default_rng(7), 5, scale=0.05)
    direct = int(s.search(queries, 5).truncated.sum())
    assert direct > 0, "fixture should truncate"
    assert bool(s.search(queries, 5).truncated[-1])
    q = DynamicBatcher(s, k=5)
    q.submit(queries)
    q.drain()
    assert q.stats["pad_rows"] == 3
    assert q.stats["truncated_rows"] == direct


def test_queue_inserts_drain_between_search_batches():
    s, _ = _searcher()
    rng = np.random.default_rng(13)
    queries = _q(rng, 4)
    new_pts = _q(rng, 32)
    new_labels = rng.integers(0, 3, size=32).astype(np.int32)
    q = DynamicBatcher(s, k=5)
    f1 = q.submit(queries)
    assert q.offer_insert(new_pts, labels=new_labels) == 32
    assert q.stats["insert_backlog"] == 32
    assert q.step()  # the search batch FIRST (the insert still queued)
    assert q.stats["insert_backlog"] == 32
    assert_results_match(f1.result(timeout=0), s.search(queries, 5))
    assert q.step()  # the backlog drains between batches
    assert q.stats["insert_backlog"] == 0 and q.stats["inserts_applied"] == 32
    assert q.stats["insert_backlog_peak"] == 32
    f2 = q.submit(queries)
    q.drain()
    assert not q.step()
    assert_results_match(f2.result(timeout=0), s.insert(new_pts, labels=new_labels).search(queries, 5))


def test_queue_matches_the_reference_queue():
    """The same submit / insert sequence through the reference's
    DynamicBatcher: equal results, equal stats (latencies aside)."""
    from repro import api as japi

    s, jidx = _searcher(seed=14)
    js = japi.ActiveSearcher.from_index(jidx, QJCFG)
    rng = np.random.default_rng(15)
    tq, jq = DynamicBatcher(s, k=5, max_batch=8), JDynamicBatcher(js, k=5, max_batch=8)
    futs = []
    for step in range(6):
        x = _q(rng, int(rng.integers(1, 6)))
        op = "classify" if step == 3 else "search"
        futs.append((op, tq.submit(x, op=op), jq.submit(x, op=op)))
        if step in (1, 4):
            pts = _q(rng, 24)
            lab = rng.integers(0, 3, size=24).astype(np.int32)
            assert tq.offer_insert(pts, labels=lab) == jq.offer_insert(jnp.asarray(pts),
                                                                     labels=jnp.asarray(lab))
        if step == 2:
            tq.step(), jq.step()
    tq.drain()
    jq.drain()
    for op, tf, jf in futs:
        if op == "search":
            assert_results_match(tf.result(timeout=0), jf.result(timeout=0))
        else:
            np.testing.assert_array_equal(np_(tf.result(timeout=0)), np.asarray(jf.result(timeout=0)))
    ts, jst = dict(tq.stats), dict(jq.stats)
    assert len(ts.pop("latencies_s")) == len(jst.pop("latencies_s"))
    assert ts == jst


def test_queue_rejects_bad_input_and_runs_under_asyncio():
    s, _ = _searcher()
    with pytest.raises(ValueError, match="max_batch"):
        DynamicBatcher(s, k=5, max_batch=0)
    q = DynamicBatcher(s, k=5)
    with pytest.raises(ValueError, match="op must be"):
        q.submit(np.zeros((2, 2), np.float32), op="count")
    with pytest.raises(ValueError, match="queries must be"):
        q.submit(np.zeros((0, 2), np.float32))
    fut = q.submit(np.zeros((3, 2), np.float32))

    async def serve():
        task = asyncio.ensure_future(q.run_async())
        while not fut.done():
            await asyncio.sleep(0.001)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task

    asyncio.run(asyncio.wait_for(serve(), timeout=60))
    assert fut.result(timeout=0).ids.shape == (3, 5)


@pytest.mark.gpu
def test_gpu_knn_lm_and_retrieval_equal_the_cpu(datastore, memory):
    """On the card (the `hopper` plan's kernels): the kNN-LM head, the
    batcher and retrieval equal the CPU's plain versions."""
    dev = require_cuda()
    keys, _, _, tcfg, _, tidx = datastore
    h = torch.from_numpy(_hidden(keys))
    cpu = tknn.knn_logprobs(tidx, tcfg, h, VOCAB)
    gpu = tknn.knn_logprobs(tidx.to(dev), tcfg, h.to(dev), VOCAB)
    assert gpu.device.type == "cuda"
    assert_probs_close(gpu, np_(cpu))
    q = DynamicBatcher(tapi.ActiveSearcher.from_index(tidx, tcfg.grid, device=dev), k=tcfg.k)
    fut = q.submit(h)
    q.drain()
    assert_results_match(fut.result(timeout=0),
                         tapi.ActiveSearcher.from_index(tidx, tcfg.grid, device="cpu").search(h, 16))
    mkeys, _, mcfg, _, midx = memory
    mq = torch.from_numpy(mkeys[:8])
    for got, want in zip(trm.retrieve_positions(midx.to(dev), mcfg, mq.to(dev)),
                         trm.retrieve_positions(midx, mcfg, mq)):
        np.testing.assert_array_equal(np_(got), np_(want))
