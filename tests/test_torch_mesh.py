"""The port's device mesh on four `gloo` ranks on the CPU
(tests/_torch_mesh_ranks.py) against the reference's mesh path on four
forced host devices (a subprocess, as in tests/test_distributed.py) and
against the port on one device: the sharded tier and its facade
mutations, `compressed_psum`, train steps on a 2 x 2 mesh, the elastic
restore across meshes and packages, the serve steps, the MoE layer, and
the train CLI.

Everything runs once per module (`mesh_run`); each rank program and the
reference's scripts have their own time limit, so a hung rank fails the
module fast."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _torch_port import assert_dists_close
from test_torch_steps import hold_normwise, hold_params

import _torch_mesh_ranks as R
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.utils import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEARCH_FIELDS = ("ids", "labels", "valid", "radius", "count", "iters", "converged", "truncated")

TIER_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro import api
from repro.core import distributed as D
from repro.core.grid import GridConfig
from repro.core.projection import identity_projection
from repro.optim.compression import compressed_psum

work = sys.argv[1]
inp = np.load(work + "/inputs.npz")
devs = np.asarray(jax.devices())
mesh4 = Mesh(devs.reshape(4), ("data",))
pts = jnp.asarray(inp["points"])
s = api.ActiveSearcher.build_sharded(pts, mesh=mesh4, axis="data",
                                     labels=jnp.asarray(inp["labels"]),
                                     cfg=GridConfig(**TIER_CFG), proj=identity_projection(pts))
q = D.replicate_queries(jnp.asarray(inp["queries"]), mesh4)
out = {}
for tag in ("build", "insert", "delete"):
    if tag == "insert":
        s = s.insert(jnp.asarray(inp["new_points"]), labels=jnp.asarray(inp["new_labels"]))
    elif tag == "delete":
        s = s.delete(jnp.asarray(inp["dead_ids"]))
    res = s.search(q, 8)
    out.update({tag + "/" + f: np.asarray(getattr(res, f)) for f in res._fields})
np.savez(work + "/ref_tier.npz", **out)

fn = shard_map(lambda g, e: tuple(x[None] for x in compressed_psum(g[0], e[0], "dp")),
               mesh=Mesh(devs.reshape(4), ("dp",)), in_specs=(P("dp"), P("dp")),
               out_specs=(P("dp"), P("dp")), check_rep=False)
mean, err = fn(jnp.asarray(inp["psum_g"]), jnp.asarray(inp["psum_err"]))
np.savez(work + "/ref_psum.npz", mean=np.asarray(mean), err=np.asarray(err))
"""

TRAIN_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as JL
from repro.checkpoint.store import CheckpointManager
from repro.configs import get_smoke
from repro.data import pipeline as dp
from repro.launch import steps as st
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw

work = sys.argv[1]
JL.ACT_DTYPE = jnp.float32
mesh = make_host_mesh(2, 2)
opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
for arch, n, accum in (("internlm2-1.8b", 3, 2), ("qwen2-moe-a2.7b", 1, 1)):
    cfg = get_smoke(arch)
    sc = st.StepConfig(accum=accum, bf16_compute_copy=False)
    state = st.init_train_state(jax.random.PRNGKey(0), cfg, opt, sc, mesh)
    _, _, _, jit_for = st.make_train_step(cfg, opt, mesh, sc)
    mgr = CheckpointManager(work + "/traj/" + arch, keep=10)
    batches, fn = {}, None
    for i in range(n):
        mgr.save(i, state, blocking=True)
        dc = dp.DataConfig(global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
        b = dp.add_frontend_inputs(dp.synth_batch(dc, i), cfg, i)
        batches.update({str(i) + "/" + k: v for k, v in b.items()})
        jb = jax.tree.map(jnp.asarray, b)
        with mesh:
            if fn is None:
                fn = jit_for(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jb))
            state, metrics = fn(state, jb)
    mgr.save(n, state, blocking=True)
    np.savez(work + "/traj/" + arch + "_batches.npz", **batches)
"""

REFERENCE_RESTORE = """
import sys
import jax, numpy as np
from repro.checkpoint.store import CheckpointManager
from repro.configs import get_smoke
from repro.launch import steps as st
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw

ckpt = sys.argv[1]
cfg = get_smoke("internlm2-1.8b")
sc = st.StepConfig(accum=2, bf16_compute_copy=False)
abstract = st.train_state_shapes(cfg, adamw.AdamWConfig(), sc)
with np.load(ckpt + "/step_7/arrays.npz") as z:
    want = {k: z[k] for k in z.files}
for shape in ((2, 2), (4, 1)):
    mesh = make_host_mesh(*shape)
    got = CheckpointManager(ckpt).restore(
        7, abstract, shardings=st._ns(mesh, st.train_state_specs(abstract, cfg, mesh)))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                       for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), want[key], err_msg=key)
print("reference restored the mesh checkpoint")
"""


def _reference(script: str, *args, timeout=420) -> subprocess.Popen:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    code = f"TIER_CFG = {R.TIER_CFG!r}\n" + textwrap.dedent(script)
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc: subprocess.Popen, timeout=420) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every rank program and reference script, once: returns the
    directory of their outputs."""
    work = str(tmp_path_factory.mktemp("mesh"))
    rng = np.random.default_rng(0)
    np.savez(os.path.join(work, "inputs.npz"),
             points=rng.normal(size=(4096, 2)).astype(np.float32),
             labels=rng.integers(0, 3, size=4096).astype(np.int32),
             queries=rng.normal(size=(16, 2)).astype(np.float32),
             new_points=rng.normal(size=(256, 2)).astype(np.float32),
             new_labels=rng.integers(0, 3, size=256).astype(np.int32),
             dead_ids=np.concatenate([np.arange(0, 4096, 7), np.arange(4096, 4352, 5)]).astype(
                 np.int32),
             psum_g=rng.normal(size=(4, 64)).astype(np.float32),
             psum_err=(0.01 * rng.normal(size=(4, 64))).astype(np.float32))
    refs = [_reference(TIER_REFERENCE, work), _reference(TRAIN_REFERENCE, work)]
    try:
        R.spawn(R.tier, 4, os.path.join(work, "tier"))
        R.spawn(R.serve, 4, os.path.join(work, "serve"))
        R.spawn(R.moe, 4, os.path.join(work, "moe"))
    finally:
        for ref in refs:
            _finish(ref)
    train = os.path.join(work, "train")
    R.spawn(R.train, 4, train, os.path.join(work, "traj"))
    restore = _reference(REFERENCE_RESTORE, os.path.join(train, "mesh_ckpt"))
    try:
        R.spawn(R.one_by_one, 1, os.path.join(work, "one"), os.path.join(train, "mesh_ckpt"))
        R.spawn(R.cli, 4, os.path.join(work, "cli"))
    finally:
        assert "reference restored the mesh checkpoint" in _finish(restore)
    return work


def _load(*parts) -> dict:
    with np.load(os.path.join(*parts)) as z:
        return {k: z[k] for k in z.files}


def test_sharded_tier_equals_the_reference_mesh(mesh_run):
    """build_sharded on a 4-rank ("data",) mesh, then insert and delete
    through the facade: every rank's merged results equal the reference's
    4-device results (ids, labels, counts and statistics exactly,
    distances within DIST_RTOL), and the live count is the points left."""
    want = _load(mesh_run, "ref_tier.npz")
    for rank in range(4):
        got = _load(mesh_run, "tier", f"tier_{rank}.npz")
        for tag in ("build", "insert", "delete"):
            for f in SEARCH_FIELDS:
                np.testing.assert_array_equal(got[f"{tag}/{f}"], want[f"{tag}/{f}"],
                                              err_msg=f"{rank} {tag} {f}")
            assert_dists_close(got[f"{tag}/dists"], want[f"{tag}/dists"], f"{rank} {tag}")
        dead = _load(mesh_run, "inputs.npz")["dead_ids"]
        assert int(got["delete/n_points"]) == 4096 + 256 - len(dead)


def test_compressed_psum_equals_the_reference_shard_map(mesh_run):
    """The int8 all-reduce with error feedback over four ranks: the mean
    and each rank's residual equal the reference's shard_map, bit for bit."""
    want = _load(mesh_run, "ref_psum.npz")
    for rank in range(4):
        got = _load(mesh_run, "tier", f"psum_{rank}.npz")
        np.testing.assert_array_equal(got["mean"], want["mean"][rank])
        np.testing.assert_array_equal(got["err"], want["err"][rank])


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


@pytest.mark.parametrize("arch", list(R.TRAIN_STEPS))
def test_train_steps_on_2x2_hold(mesh_run, arch, f32_mode):
    """Each step of the reference's 2 x 2 trajectory (float32, internlm2
    with two microbatches; qwen2-moe's experts on the model axis), run by
    the port on a 2 x 2 mesh from the reference's state: the parameters
    held (`hold_params`) against the reference's next state and against
    the port's one-device step from the same state, the moments normwise,
    the loss within 1e-5."""
    cfg = get_smoke(arch)
    traj = os.path.join(mesh_run, "traj", arch)
    like = R._like(arch)
    mgr = CheckpointManager(traj, keep=10)
    batches = _load(mesh_run, "traj", f"{arch}_batches.npz")
    one_step = TS.make_train_step(cfg, R.OPT, R.STEP_CFG[arch])
    for i in range(R.TRAIN_STEPS[arch]):
        got = _load(mesh_run, "train", f"{arch}_{i}.npz")
        lr = float(got["metric/lr"])
        params = {k: v for k, v in got.items() if k.startswith("params/")}
        want = _load(traj, f"step_{i + 1}", "arrays.npz")
        hold_params(params, {k: want[k] for k in params}, lr)
        for part, rel in (("opt/mu", 1e-4), ("opt/nu", 2e-4)):
            keys = [k for k in got if k.startswith(part)]
            hold_normwise({k: got[k] for k in keys}, {k: want[k] for k in keys}, rel)
        assert int(got["step"]) == int(want["step"]) == i + 1
        batch = {k.split("/")[1]: torch.from_numpy(v) for k, v in batches.items()
                 if k.startswith(f"{i}/")}
        one, metrics = one_step(mgr.restore(i, like, device="cpu"), batch)
        one = {"/".join(map(str, p)): t.numpy() for p, t in tree.leaves_with_path(one)}
        hold_params(params, {k: one[k] for k in params}, lr)
        assert float(got["metric/loss"]) == pytest.approx(float(metrics["loss"]), rel=1e-5)


def test_elastic_restore_across_meshes_and_packages(mesh_run):
    """A 2 x 2 mesh's checkpoint restores onto 4 x 1 (each rank's shards
    the same slices: checked in the ranks) and onto 1 x 1, bit-equal to
    what was written; the reference restores it onto its 2 x 2 and 4 x 1
    meshes (checked in its script)."""
    want = _load(mesh_run, "train", "mesh_ckpt", "step_7", "arrays.npz")
    for name in (("train", "elastic_4x1.npz"), ("one", "elastic_1x1.npz")):
        got = _load(mesh_run, *name)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ref_after = _load(mesh_run, "traj", "internlm2-1.8b", "step_3", "arrays.npz")
    for k in want:
        np.testing.assert_array_equal(want[k], ref_after[k], err_msg=k)


SERVE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("step", ["prefill", "serve", "retrieval"])
def test_serve_steps_on_2x2_equal_one_device(mesh_run, step):
    """make_prefill_step, make_serve_step and make_retrieval_serve_step on
    a 2 x 2 mesh (weights placed by param_specs, caches by cache_specs,
    the memory index replicated) against the same steps on one device,
    float32: logits, hiddens and caches within 1e-5; the retrieved
    positions equal."""
    out = _load(mesh_run, "serve", "serve.npz")
    keys = [k[len(f"{step}/one/"):] for k in out if k.startswith(f"{step}/one/")]
    assert keys
    for k in keys:
        got, want = out[f"{step}/mesh/{k}"], out[f"{step}/one/{k}"]
        if k.endswith(("positions", "ok")):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **SERVE_TOL)
    if step == "retrieval":
        assert any(out[f"retrieval/one/{i}/ok"].any() for i in range(3))


@pytest.mark.parametrize("shape", ["whole_groups", "groups_across_shards"])
def test_moe_block_on_2x2_equals_one_device(mesh_run, shape):
    """qwen2-moe's moe_block on a 2 x 2 mesh against one device, float32:
    the output, the aux loss and the gradients of the input and of every
    weight within 1e-5.  Where each rank's batch rows hold whole GShard
    groups the layer runs on them (no replicated call); a group spanning
    the batch shards runs whole on every rank."""
    out = _load(mesh_run, "moe", "moe.npz")
    assert int(out[f"{shape}/mesh/replicated"]) == (shape == "groups_across_shards")
    assert int(out[f"{shape}/one/replicated"]) == 0
    keys = [k[len(f"{shape}/one/"):] for k in out
            if k.startswith(f"{shape}/one/") and not k.endswith("replicated")]
    assert {"y", "aux", "dx", "d/router", "d/wi"} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(out[f"{shape}/mesh/{k}"], out[f"{shape}/one/{k}"],
                                   err_msg=k, **SERVE_TOL)


def test_train_cli_on_a_2x2_mesh(mesh_run):
    """`train.main --data 2 --model 2` in a four-rank process group: two
    steps, a checkpoint after each (written by rank 0), restorable on one
    device."""
    ckpt = os.path.join(mesh_run, "cli", "ckpt")
    mgr = CheckpointManager(ckpt)
    assert mgr.list_steps() == [1, 2]
    cfg = get_smoke("internlm2-1.8b")
    like = TS.train_state_shapes(cfg, R.OPT, TS.StepConfig())
    state = mgr.restore(2, like, device="cpu")
    assert int(state["step"]) == 2
    assert all(torch.isfinite(t).all() for t in tree.leaves(state["params"]))
