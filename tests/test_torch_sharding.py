"""The port's sharding rules (`repro_torch/parallel/sharding.py`, `axes.py`)
against the reference's, in one process on shape-only meshes: every
function's PartitionSpec for every leaf, the ten architectures' full
train states and decode caches, and specs -> DTensor placements."""

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as hst
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_NAMES, get_config as jget_config, shapes as jshapes
from repro.launch import steps as JS
from repro.optim import adamw as JA
from repro.parallel import axes as jaxes
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config, shapes as tshapes
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.parallel import axes
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P
from repro_torch.utils import tree


class FakeMesh:
    """Shape-only stand-in, as tests/test_sharding.py's (the rules read
    only `.shape` and `.axis_names`)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "2x2": FakeMesh({"data": 2, "model": 2}),
    "4x2": FakeMesh({"data": 4, "model": 2}),
}


def _same(got, want, msg=""):
    """A port spec equal to the reference's, entry for entry."""
    assert isinstance(got, sh.PartitionSpec), (msg, got)
    assert tuple(got) == tuple(want), (msg, got, want)


def _ref_leaves(specs):
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))


def test_partition_spec_keeps_the_reference_equality():
    cases = [(), (None,), ("data",), (("data",),), (("pod", "data"), None),
             ("data", None), ((), "model"), (["data", "model"],)]
    for entries in cases:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P("a") == P(("a",)) and P("a") != P("a", None)
    assert P(("a",)) == JP(("a",)) and P("a", None) == JP("a", None)
    assert tree.leaves({"x": P("a", None), "y": [P()]}) == [P("a", None), P()]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_dp_axes_and_rules(mesh):
    m = MESHES[mesh]
    assert sh.dp_axes(m) == jsh.dp_axes(m)
    for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 3):
        for dp_only in (False, True):
            assert sh.dp_axes_for(b, m, dp_only) == jsh.dp_axes_for(b, m, dp_only), (b, dp_only)
    _same(sh.logits_spec(m), jsh.logits_spec(m))
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for b in (1, 8, 256):
            rules = axes.default_rules(cfg, m, b)
            assert rules == jaxes.default_rules(jcfg, m, b), (arch, b)
            for shape, logical in [((b, 4096, cfg.hq_eff, cfg.head_dim),
                                    ("batch", "seq", "heads", "head_dim")),
                                   ((b, 1, cfg.hkv_eff, cfg.head_dim),
                                    ("batch", "seq", "dec_heads", "dec_hd")),
                                   ((b, 64, cfg.vocab_eff), ("batch", "seq", "vocab")),
                                   ((b, 4, 8, cfg.d_model), ("batch", "experts", None, "embed")),
                                   ((b, 7, 3 * cfg.d_model), ("batch", "seq", "inner"))]:
                _same(axes.spec_for(shape, logical, m, rules),
                      jaxes.spec_for(shape, logical, m, rules), (arch, shape, logical))


def test_fit_pspec_cases_of_the_reference():
    m, m3 = MESHES["16x16"], MESHES["2x16x16"]
    for spec, shape, mesh in [(("data", "model"), (32, 64), m),
                              (("data", "model", None), (4096, 8, 128), m),
                              ((None, "model", None), (4096, 8, 128), m),
                              (("model",), (7,), m),
                              ((("pod", "data"), None), (64, 10), m3),
                              ((("pod", "data"), None), (10, 64), m3)]:
        _same(sh.fit_pspec(P(*spec), shape, mesh), jsh.fit_pspec(JP(*spec), shape, mesh),
              (spec, shape))


@settings(max_examples=50, deadline=None)
@given(
    dims=hst.lists(hst.integers(1, 512), min_size=1, max_size=4),
    seed=hst.integers(0, 2**31 - 1),
)
def test_fit_pspec_agrees_and_is_always_legal(dims, seed):
    """The reference's property test, run on both packages: the same
    spec, and every sharded dim divides the product of its axes."""
    mesh = MESHES["2x16x16"]
    rng = np.random.default_rng(seed)
    names = ["data", "model", "pod"]
    entries = [None if rng.random() < 0.4 else names[rng.integers(0, 3)] for _ in dims]
    seen = set()
    for i, e in enumerate(entries):
        if e in seen:
            entries[i] = None
        elif e is not None:
            seen.add(e)
    got = sh.fit_pspec(P(*entries), tuple(dims), mesh)
    _same(got, jsh.fit_pspec(JP(*entries), tuple(dims), mesh), entries)
    used = set()
    for size, entry in zip(dims, tuple(got) + (None,) * (len(dims) - len(got))):
        ax = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        prod = 1
        for a in ax:
            assert a not in used
            used.add(a)
            prod *= mesh.shape[a]
        assert size % prod == 0, (size, ax)


_REF_STATES: dict = {}


def _ref_state(arch):
    if arch not in _REF_STATES:
        _REF_STATES[arch] = JS.train_state_shapes(jget_config(arch), JA.AdamWConfig(),
                                                  JS.StepConfig())
    return _REF_STATES[arch]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_state_specs_equal_the_reference(arch, mesh):
    """Every leaf of the CONFIG train state (params, moments, counters)
    gets the reference's spec, and the param leaves their paths' specs."""
    m = MESHES[mesh]
    cfg = get_config(arch)
    state = TS.train_state_shapes(cfg, TA.AdamWConfig(), TS.StepConfig())
    got = TS.train_state_specs(state, cfg, m)
    want = JS.train_state_specs(_ref_state(arch), jget_config(arch), m)
    got_leaves, want_leaves = tree.leaves(got), _ref_leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree.leaves(state))
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        _same(g, w, (arch, mesh, i))
    for (path, leaf), spec in zip(tree.leaves_with_path(state["params"]),
                                  tree.leaves(got["params"])):
        _same(sh.fit_pspec(sh.param_pspec(path, leaf, cfg, m), tuple(leaf.shape), m), spec, path)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_batch_and_cache_specs_equal_the_reference(mesh):
    """batch_specs of the train / prefill inputs, cache_specs of the
    decode_32k and long_500k caches, for every architecture."""
    m = MESHES[mesh]
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name in ("train_4k", "prefill_32k"):
            got = sh.batch_specs(tshapes.batch_specs(cfg, tshapes.SHAPES[name]), m, cfg)
            want = jsh.batch_specs(jshapes.batch_specs(jcfg, jshapes.SHAPES[name]), m, jcfg)
            for g, w in zip(tree.leaves(got), _ref_leaves(want)):
                _same(g, w, (arch, name))
        for name in ("decode_32k", "long_500k"):
            b = tshapes.SHAPES[name].global_batch
            caches = tshapes.decode_specs(cfg, tshapes.SHAPES[name])["caches"]
            jcaches = jshapes.decode_specs(jcfg, jshapes.SHAPES[name])["caches"]
            got, want = sh.cache_specs(caches, cfg, m, b), jsh.cache_specs(jcaches, jcfg, m, b)
            assert len(tree.leaves(got)) == len(_ref_leaves(want))
            for g, w in zip(tree.leaves(got), _ref_leaves(want)):
                _same(g, w, (arch, name))


def test_cache_specs_decode_vs_long():
    """tests/test_sharding.py's case: the batch takes DP; at B = 1 the
    cache's sequence dim takes it."""
    cfg, m = get_config("minitron-8b"), MESHES["16x16"]
    kv = sh.cache_specs(TM.init_caches(cfg, 128, 1024, device="meta"), cfg, m, 128)[0]["k"]
    assert kv[1] == "data"
    kv1 = sh.cache_specs(TM.init_caches(cfg, 1, 4096, device="meta"), cfg, m, 1)[0]["k"]
    assert kv1[1] is None and kv1[2] == "data"


class _NamedMesh(FakeMesh):
    """A shape-only mesh with a coordinate, for `placements` and
    `local_part` without a process group."""

    def __init__(self, shape: dict, coords: dict):
        super().__init__(shape)
        self.coords = coords

    def coordinate(self, axis):
        return self.coords[axis]


def test_placements_round_trip_and_order():
    from torch.distributed.tensor import Replicate, Shard

    m = MESHES["2x16x16"]
    for spec in [P(), P("data", None), P(None, "model"), P(("pod", "data"), "model"),
                 P("model", ("pod", "data"), None), P(None, None, "pod")]:
        pl = sh.placements(spec, m)
        assert len(pl) == 3
        ndim = max(len(spec), 3)
        want = tuple(spec) + (None,) * (ndim - len(spec))
        assert tuple(sh.spec_of(pl, m, ndim)) == want, spec
    assert sh.placements(P(("pod", "data"), "model"), m) == [Shard(0), Shard(0), Shard(1)]
    assert sh.placements(P(None, "data"), m) == [Replicate(), Shard(1), Replicate()]
    assert sh.replicated(m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(P(("data", "pod")), m)
    with pytest.raises(ValueError, match="twice"):
        sh.placements(P("data", "data"), m)


def test_local_part_is_the_dtensor_split():
    """local_part over a (2, 2) mesh: a dim sharded over both axes splits
    data-major, as DTensor splits it; the shards tile the whole."""
    full = torch.arange(8 * 6).reshape(8, 6)
    for spec in [P("data", "model"), P(("data", "model"), None), P(None, "data")]:
        pieces = {}
        for d in range(2):
            for mo in range(2):
                mesh = _NamedMesh({"data": 2, "model": 2}, {"data": d, "model": mo})
                pieces[(d, mo)] = sh.local_part(full, mesh, spec)
        if spec == P(("data", "model"), None):
            got = torch.cat([pieces[(d, mo)] for d in range(2) for mo in range(2)])
            assert torch.equal(got, full)
        elif spec == P("data", "model"):
            rows = [torch.cat([pieces[(d, mo)] for mo in range(2)], dim=1) for d in range(2)]
            assert torch.equal(torch.cat(rows), full)
        else:
            assert torch.equal(torch.cat([pieces[(d, 0)] for d in range(2)], dim=1), full)
            assert torch.equal(pieces[(0, 0)], pieces[(0, 1)])


def test_constrain_is_a_no_op_off_a_mesh():
    x = torch.ones(2, 3)
    assert axes.constrain(x, "batch", "embed") is x
    with axes.axis_rules(MESHES["2x2"], {"batch": "data"}):
        assert axes.constrain(x, "batch", "embed") is x          # a plain tensor
        with pytest.raises(ValueError, match="2 names for rank-3"):
            axes.constrain(torch.ones(2, 3, 4), "batch", "embed")
        assert axes.axis_size("batch") == 2 and axes.axis_size("heads") == 1
    assert axes.current_rules() is None
    assert axes.local_map(lambda a: a + 1, (("batch", None),), ("batch", None), x).sum() == 12


def test_stored_array_reads_each_leaf_and_its_slices(tmp_path):
    """A checkpoint's leaves read through `stored_array` (mapped from the
    file where stored, loaded where compressed) equal np.load's, and a
    mesh restore's slices are `local_slices` of them."""
    from repro_torch.checkpoint.store import stored_array

    rng = np.random.default_rng(0)
    arrays = {"params/w": rng.normal(size=(8, 6)).astype(np.float32), "step": np.int32(12),
              "empty": np.zeros((0, 3), np.float32), "fortran": np.asfortranarray(
                  rng.normal(size=(4, 6))), "one": np.array([3.5], np.float32)}
    for save in (np.savez, np.savez_compressed):
        path = str(tmp_path / f"{save.__name__}.npz")
        save(path, **arrays)
        for key, want in arrays.items():
            got = stored_array(path, key)
            assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want), key
            np.testing.assert_array_equal(got, want, err_msg=key)
    whole = stored_array(str(tmp_path / "savez.npz"), "params/w")
    for d in range(2):
        for mo in range(2):
            mesh = _NamedMesh({"data": 2, "model": 2}, {"data": d, "model": mo})
            spec = P("data", "model")
            np.testing.assert_array_equal(
                sh.local_part(whole, mesh, spec),
                arrays["params/w"][4 * d:4 * d + 4, 3 * mo:3 * mo + 3])
    uneven = _NamedMesh({"data": 4}, {"data": 3})
    assert sh.local_slices((5, 2), uneven, P("data")) == (slice(5, 5), slice(0, 2))
