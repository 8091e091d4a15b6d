"""The port's fault tolerance and train loop (`repro_torch/launch/ft.py`,
`train.py`): the cases of tests/test_ft.py (timer, guard, restarts,
resume, injected failure, restore onto another device), and checkpoints
carried across packages both ways, at internlm2's SMOKE size."""

import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_, require_cuda
from test_torch_steps import hold_params

import repro.models.layers as JL
from repro.checkpoint.store import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke as jget_smoke
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw as JA
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.launch import ft
from repro_torch.launch import steps as st
from repro_torch.launch import train as TT
from repro_torch.models import layers as TL
from repro_torch.optim import adamw
from repro_torch.utils import tree

ARCH = "internlm2-1.8b"
QUIET = dict(log=lambda *_: None)


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def test_step_timer_flags_stragglers():
    t = ft.StepTimer(threshold=2.0, warmup=2)
    for i in range(5):
        t.record(i, 0.1)
    assert t.record(5, 0.5).is_straggler
    assert not t.record(6, 0.1).is_straggler
    assert t.straggler_steps == [5]


def test_step_timer_reshard_after_persistent_slowness():
    t = ft.StepTimer(threshold=1.5, warmup=1)
    t.record(0, 0.1)
    t.record(1, 0.1)
    for i in range(2, 8):
        t.record(i, 1.0)
    assert t.should_reshard(patience=5)


def test_preemption_guard_sets_drain():
    with ft.PreemptionGuard(signals=(signal.SIGUSR1,)) as g:
        assert not g.draining
        os.kill(os.getpid(), signal.SIGUSR1)
        assert g.draining


def test_run_with_restarts_retries_then_succeeds():
    calls = {"n": 0}

    def loop():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return 7

    restarts = []
    out = ft.run_with_restarts(loop, max_restarts=5, backoff_s=0.01,
                               on_restart=lambda k, e: restarts.append(k))
    assert out == 7 and restarts == [1, 2]


def test_run_with_restarts_gives_up():
    def loop():
        raise RuntimeError("always")

    with pytest.raises(RuntimeError):
        ft.run_with_restarts(loop, max_restarts=2, backoff_s=0.01)


# ------------------------------------------------------- train-loop drills ---


def _tc(lib, path, **kw):
    kw.setdefault("steps", 6)
    kw.setdefault("batch", 2)
    kw.setdefault("seq", 32)
    kw.setdefault("ckpt_dir", str(path))
    kw.setdefault("ckpt_every", 2)
    kw.setdefault("log_every", 100)
    return lib.TrainConfig(**kw)


def test_train_resumes_from_checkpoint(tmp_path):
    cfg = get_smoke(ARCH)
    out1 = TT.train_loop(cfg, _tc(TT, tmp_path, steps=4), "cpu", **QUIET)
    assert out1["final_step"] == 4 and len(out1["losses"]) == 4
    # the second run continues to 6 from the step-4 checkpoint, not step 0
    out2 = TT.train_loop(cfg, _tc(TT, tmp_path, steps=6), "cpu", **QUIET)
    assert out2["final_step"] == 6 and len(out2["losses"]) == 2
    # a 6-step run stopped after its step-4 checkpoint resumes equal to
    # one never stopped (the schedule is the same: total_steps 6)
    with pytest.raises(RuntimeError, match="injected fault at step 4"):
        TT.train_loop(cfg, _tc(TT, tmp_path / "cut", fail_at=4), "cpu", **QUIET)
    resumed = TT.train_loop(cfg, _tc(TT, tmp_path / "cut"), "cpu", **QUIET)
    whole = TT.train_loop(cfg, _tc(TT, tmp_path / "whole"), "cpu", **QUIET)
    assert resumed["losses"] == whole["losses"][4:]


def test_injected_failure_recovers(tmp_path):
    cfg = get_smoke(ARCH)
    tc = _tc(TT, tmp_path, steps=6, fail_at=3)
    log = []
    out = TT.run(cfg, tc, "cpu", max_restarts=2, log=log.append)
    assert out["final_step"] == 6
    assert tc.fail_at == -1                       # the fault fires once
    assert any("injected fault at step 3" in line for line in log)
    assert any("resumed from checkpoint step 2" in line for line in log)


def test_restore_onto_another_device(tmp_path):
    """A checkpoint written on the CPU restores onto a structure donor on
    the meta device (nothing allocated) as tensors on the CPU, equal to
    the run's final state leaf for leaf."""
    cfg = get_smoke(ARCH)
    out = TT.train_loop(cfg, _tc(TT, tmp_path, steps=2), "cpu", **QUIET)
    like = st.train_state_shapes(cfg, adamw.AdamWConfig(), st.StepConfig())
    state = CheckpointManager(str(tmp_path)).restore(2, like, device="cpu")
    got, want = dict(tree.leaves_with_path(state)), dict(tree.leaves_with_path(out["state"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(np_(got[k]), np_(want[k]))


@pytest.mark.gpu
def test_restore_onto_the_card(tmp_path):
    dev = require_cuda()
    cfg = get_smoke(ARCH)
    out = TT.train_loop(cfg, _tc(TT, tmp_path, steps=2), "cpu", **QUIET)
    like = st.train_state_shapes(cfg, adamw.AdamWConfig(), st.StepConfig())
    state = CheckpointManager(str(tmp_path)).restore(2, like, device=dev)
    for (k, a), (_, b) in zip(tree.leaves_with_path(state), tree.leaves_with_path(out["state"])):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(np_(a), np_(b), err_msg=str(k))


def test_cli_trains_and_refuses_a_mesh(tmp_path, capsys):
    TT.main(["--device", "cpu", "--smoke", "--steps", "2", "--seq", "16", "--batch", "2",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).list_steps() == [1, 2]
    with pytest.raises(SystemExit):
        TT.main(["--device", "cpu", "--smoke", "--data", "2"])
    assert "need 2 devices for mesh (2, 1), have 1 ranks" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.main(["--smoke", "--steps", "1"])


# ------------------------------------------------------ across packages ---


def _reference_loop(path, steps):
    return JT.train_loop(jget_smoke(ARCH), _tc(JT, path, steps=steps), make_host_mesh(1, 1),
                         **QUIET)


def _same_state(got: dict, want: dict, lr: float) -> None:
    """Moments normwise within 2**-5 of each leaf's largest (the train loop's
    step runs on the bf16 compute copy, whose gradients come back rounded
    to bf16: tests/test_torch_steps.py), counters equal, parameters as a
    train step's are held (`hold_params`)."""
    assert int(got["step"]) == int(want["step"])
    assert int(got["opt"].count) == int(want["opt"].count)
    for part in ("mu", "nu"):
        for (k, a), (_, b) in zip(tree.leaves_with_path(getattr(got["opt"], part)),
                                  tree.leaves_with_path(getattr(want["opt"], part))):
            assert np.abs(a - b).max() <= 2**-5 * max(np.abs(b).max(), 1e-30), (part, k)
    hold_params(got["params"], want["params"], lr)


def _np_state(state) -> dict:
    return tree.map(lambda a: np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                                         else a), dict(state))


def test_port_resumes_a_reference_checkpoint(tmp_path, f32_mode):
    """The reference's train_loop writes the step-2 checkpoint on its way
    to step 3; the port's train_loop resumes from it, and its step (index
    2) gives the reference's loss within 1e-5 and its final state (the
    parameters as `hold_params` holds a step's)."""
    ref = _reference_loop(tmp_path / "ref", 3)
    os.makedirs(tmp_path / "port")
    shutil.copytree(tmp_path / "ref" / "step_2", tmp_path / "port" / "step_2")
    log = []
    out = TT.train_loop(get_smoke(ARCH), _tc(TT, tmp_path / "port", steps=3), "cpu",
                        log=log.append)
    assert "[train] resumed from checkpoint step 2" in log
    assert out["final_step"] == 3 and len(out["losses"]) == 1
    assert out["losses"][0] == pytest.approx(ref["losses"][2], rel=1e-5)
    lr = float(JA.schedule(JA.AdamWConfig(total_steps=3, warmup_steps=1), jnp.int32(3)))
    _same_state(_np_state(out["state"]), jax.tree.map(np.asarray, ref["state"]), lr)


def test_reference_resumes_a_port_checkpoint(tmp_path, f32_mode):
    """The reverse: the port's 3-step run writes the step-2 checkpoint and
    stops (an injected fault); the reference's CheckpointManager restores
    it leaf for leaf onto its own state's structure, and the reference's
    train_loop resumes from it to the loss the port's uninterrupted run
    takes at that step."""
    with pytest.raises(RuntimeError, match="injected fault at step 2"):
        TT.train_loop(get_smoke(ARCH), _tc(TT, tmp_path, steps=3, fail_at=2), "cpu", **QUIET)
    port = {"state": CheckpointManager(str(tmp_path)).restore(2, st.train_state_shapes(
        get_smoke(ARCH), adamw.AdamWConfig(), st.StepConfig()), device="cpu")}
    jcfg = jget_smoke(ARCH)
    mesh = make_host_mesh(1, 1)
    jsc = JS.StepConfig()
    abstract = JS.train_state_shapes(jcfg, JA.AdamWConfig(), jsc)
    restored = JCheckpointManager(str(tmp_path)).restore(
        2, abstract, shardings=JS._ns(mesh, JS.train_state_specs(abstract, jcfg, mesh)))
    got = dict(tree.leaves_with_path(jax.tree.map(np.asarray, restored)))
    want = dict(tree.leaves_with_path(_np_state(port["state"])))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    ref = _reference_loop(tmp_path, 3)
    assert ref["final_step"] == 3 and len(ref["losses"]) == 1
    cont = TT.train_loop(get_smoke(ARCH), _tc(TT, tmp_path / "cont", steps=3), "cpu", **QUIET)
    assert ref["losses"][0] == pytest.approx(cont["losses"][2], rel=1e-5)
