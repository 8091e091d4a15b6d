"""The port's train step (`repro_torch/launch/steps.py`) against the
reference's (`repro/launch/steps.py`, jitted on a 1x1 host mesh), at SMOKE
sizes in float32 ACT_DTYPE in both packages.

A train step is held as a function of the state: along the reference's
own trajectory of three steps, the port's step from the reference's state
before each step gives the reference's state after it (the first step
from the fresh state, then two with moments).  Two float32 programs that
sum in other orders do not follow one trajectory for long: AdamW divides
each gradient element by its own running size, so an element whose
gradient is at float32's noise floor (a cancellation to ~1e-9 while the
leaf's largest are ~1e-3) can take an update of up to the learning rate
of either sign.  So the parameters are held within 1e-5 but for such
elements, each within 2.5 learning rates and together at most 1e-4 of the
parameters; the moments, which carry the gradients, normwise per leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_

import repro.models.layers as JL
from repro.configs import ARCH_NAMES, get_smoke as jget_smoke
from repro.data import pipeline as JP
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.optim import adamw as JA
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import mamba as TMa
from repro_torch.launch import steps as TS
from repro_torch.optim import adamw as TA
from repro_torch.utils import tree



@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def _batch(cfg, step, batch=4, seq=16):
    dc = JP.DataConfig(global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size)
    return JP.add_frontend_inputs(JP.synth_batch(dc, step), cfg, step)


def _opt(lib):
    return lib.AdamWConfig(warmup_steps=1, total_steps=10)


def _reference_run(arch, n_steps=3, **step_kw):
    """The reference's trajectory: [(state before, batch, state after,
    metrics)] as numpy, from init_train_state(PRNGKey(0)); each run once
    per module (all in float32 ACT_DTYPE)."""
    key = (arch, n_steps, tuple(sorted(step_kw.items())))
    if key not in _RUNS:
        _RUNS[key] = _run_reference(arch, n_steps, **step_kw)
    return _RUNS[key]


_RUNS: dict = {}


def _run_reference(arch, n_steps, **step_kw):
    jcfg = jget_smoke(arch)
    mesh = make_host_mesh(1, 1)
    jsc = JS.StepConfig(**step_kw)
    state = JS.init_train_state(jax.random.PRNGKey(0), jcfg, _opt(JA), jsc, mesh)
    _, _, _, jit_for = JS.make_train_step(jcfg, _opt(JA), mesh, jsc)
    fn, out = None, []
    for i in range(n_steps):
        hb = _batch(jcfg, i)
        jb = jax.tree.map(jnp.asarray, hb)
        with mesh:
            if fn is None:
                fn = jit_for(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jb))
            before = jax.tree.map(np.asarray, state)
            state, metrics = fn(state, jb)
        out.append((before, hb, jax.tree.map(np.asarray, state),
                    {k: float(v) for k, v in metrics.items()}))
    return out


def _port_step(arch, before, hb, **step_kw):
    state = convert.train_state_from_numpy(before, device="cpu")
    step = TS.make_train_step(get_smoke(arch), _opt(TA), TS.StepConfig(**step_kw))
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in hb.items()})
    return convert.train_state_to_numpy(state), {k: float(v) for k, v in metrics.items()}


# a train step's parameters against the reference's (also tests/test_torch_train.py):
# within PARAM_ATOL, but for the elements whose gradient sits at float32's
# noise floor, where AdamW's per-element normalisation turns the two
# programs' rounding into updates of up to the learning rate
PARAM_ATOL = 1e-5
NOISE_FLOOR_SHARE = 1e-4


def hold_params(got: dict, want: dict, lr: float) -> int:
    """Parameters within PARAM_ATOL but for noise-floor elements (each
    within 2.5 lr, at most NOISE_FLOOR_SHARE of all); returns their count."""
    g, w = dict(tree.leaves_with_path(got)), dict(tree.leaves_with_path(want))
    assert g.keys() == w.keys()
    off = total = 0
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        d = np.abs(g[k].astype(np.float64) - w[k])
        assert float(d.max()) <= 2.5 * lr + PARAM_ATOL, (k, float(d.max()))
        off += int((d > PARAM_ATOL).sum())
        total += d.size
    assert off <= NOISE_FLOOR_SHARE * total, (off, total)
    return off


def hold_normwise(got: dict, want: dict, rel: float) -> None:
    """Each leaf's largest difference within `rel` of its largest value."""
    for k, w in tree.leaves_with_path(want):
        d = np.abs(dict(tree.leaves_with_path(got))[k].astype(np.float64) - w)
        assert float(d.max()) <= rel * max(float(np.abs(w).max()), 1e-30), (k, float(d.max()))


def _hold_step(got_state, got_m, want_state, want_m, metric_rtol, grad_norm_rtol, moment_rel):
    for k, v in want_m.items():
        rtol = grad_norm_rtol if k == "grad_norm" else metric_rtol
        assert got_m[k] == pytest.approx(v, rel=rtol, abs=1e-7), k
    assert int(got_state["step"]) == int(want_state["step"])
    assert int(got_state["opt"].count) == int(want_state["opt"].count)
    hold_normwise(got_state["opt"].mu, want_state["opt"].mu, moment_rel)
    hold_normwise(got_state["opt"].nu, want_state["opt"].nu, 2 * moment_rel)
    if "err" in want_state:
        # a residual is at most half an int8 step; an element on a rounding
        # boundary takes the other code, and its residual moves one step
        hold_normwise(got_state["err"], want_state["err"], 2.05)
    return hold_params(got_state["params"], want_state["params"], want_m["lr"])


ARCHS = ["internlm2-1.8b", "qwen2-moe-a2.7b", "jamba-v0.1-52b", "xlstm-125m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference_float32(arch, f32_mode):
    """bf16_compute_copy=False: three steps, each from the reference's
    state: loss, nll, aux, grad_norm and lr within 1e-5, the moments
    within 1e-4 of each leaf's largest, the parameters within 1e-5."""
    for before, hb, after, metrics in _reference_run(arch, bf16_compute_copy=False):
        got, got_m = _port_step(arch, before, hb, bf16_compute_copy=False)
        _hold_step(got, got_m, after, metrics, 1e-5, 1e-5, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference_bf16_copy(arch, f32_mode):
    """bf16_compute_copy=True: the loss runs on the same bf16-rounded
    weights in both (loss, nll, aux within 1e-5); the gradients come back
    through the cast rounded to bf16, so grad_norm is held to one bf16
    ulp (2**-8) and the moments to 2**-5 of each leaf's largest (rounded
    cotangents summed in bf16 where a weight is used twice, and the
    embedding's scatter-add); the parameters within 1e-5."""
    for before, hb, after, metrics in _reference_run(arch, bf16_compute_copy=True):
        got, got_m = _port_step(arch, before, hb, bf16_compute_copy=True)
        _hold_step(got, got_m, after, metrics, 1e-5, 2**-8, 2**-5)


def test_compute_copy_rounds_what_the_reference_rounds(f32_mode):
    """jamba (Mamba's A_log and D, norms, biases): the compute copy's
    dtypes equal the reference's `_compute_copy`'s leaf for leaf (every
    block leaf and embed / lm_head in bf16, final_norm float32; the
    serving storage rule would keep A_log, D and the vectors in float32);
    the step-0 loss equals the reference's; and the gradients of those
    leaves come back through the cast rounded to bf16, as the
    reference's.  (At SMOKE sizes the loss moves by only ~2e-6 when A_log
    and D stay float32, below what a comparison with the reference's
    float32 sums resolves, so the dtypes and gradients carry the check.)"""
    arch = "jamba-v0.1-52b"
    before, hb, _, metrics = _reference_run(arch, bf16_compute_copy=True)[0]
    want = jax.eval_shape(JS._compute_copy, jax.tree.map(jnp.asarray, before["params"]))
    masters = tree.map(lambda a: a.requires_grad_(True),
                       convert.train_state_from_numpy(before, device="cpu")["params"])
    copy = TM.compute_copy(masters)
    w_dt = {p: str(leaf.dtype) for p, leaf in tree.leaves_with_path(
        jax.tree.map(lambda a: np.zeros((), a.dtype), want))}
    g_dt = {p: str(leaf.dtype).replace("torch.", "") for p, leaf in tree.leaves_with_path(copy)}
    assert g_dt == w_dt
    assert [p for p, d in g_dt.items() if d == "float32"] == [("final_norm",)]
    core = ("blocks", 0, "core")
    assert g_dt[core + ("A_log",)] == g_dt[core + ("D",)] == "bfloat16"
    assert TMa.F32_WEIGHTS == ("dt_proj", "A_log")        # what serving keeps in float32

    loss, _ = TM.loss_params(get_smoke(arch), copy, {k: torch.from_numpy(v)
                                                     for k, v in hb.items()})
    assert float(loss) == pytest.approx(metrics["loss"], rel=1e-6)
    loss.backward()
    for path, p in tree.leaves_with_path(masters):
        g = p.grad
        rounded = torch.equal(g, g.to(torch.bfloat16).to(torch.float32))
        assert rounded == (path != ("final_norm",)), path
        assert g.abs().max() > 0, path


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b"])
def test_accumulation_reports_the_last_microbatch(arch, f32_mode):
    """accum 2: the summed, halved gradients give the reference's step,
    and the metrics are the last microbatch's loss / nll / aux (not the
    mean), as the reference's scan carries them out."""
    for before, hb, after, metrics in _reference_run(arch, n_steps=2, accum=2,
                                                     bf16_compute_copy=False):
        got, got_m = _port_step(arch, before, hb, accum=2, bf16_compute_copy=False)
        _hold_step(got, got_m, after, metrics, 1e-5, 1e-5, 1e-4)
        params = convert.train_state_from_numpy(before, device="cpu")["params"]
        last = {k: torch.from_numpy(v[2:]) for k, v in hb.items()}
        first = {k: torch.from_numpy(v[:2]) for k, v in hb.items()}
        with torch.no_grad():
            l_last, parts = TM.loss_params(get_smoke(arch), params, last)
            l_first = TM.loss_params(get_smoke(arch), params, first)[0]
        assert got_m["loss"] == pytest.approx(float(l_last), rel=1e-6)
        assert got_m["aux"] == pytest.approx(float(parts["aux"]), rel=1e-6, abs=1e-9)
        assert abs(got_m["loss"] - float(l_last + l_first) / 2) > 1e-5


def test_compressed_gradients_equal_reference(f32_mode):
    """compress_grads (int8 error feedback) with the MoE aux loss: the
    error state "err" and the step as the reference's; a gradient element
    on an int8 rounding boundary may take the next code, so the moments
    are held to two int8 steps (2/127) of each leaf's largest, and a
    residual to one step (twice the leaf's largest residual)."""
    arch = "qwen2-moe-a2.7b"
    for before, hb, after, metrics in _reference_run(arch, compress_grads=True,
                                                     bf16_compute_copy=False):
        got, got_m = _port_step(arch, before, hb, compress_grads=True, bf16_compute_copy=False)
        assert set(got) == set(after) == {"params", "opt", "step", "err"}
        _hold_step(got, got_m, after, metrics, 1e-5, 1e-5, 2 / 127)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_state_layout_equals_reference(arch):
    """train_state_shapes (the meta device): the reference's paths, shapes
    and dtypes, with and without compression."""
    for compress in (False, True):
        jsc = JS.StepConfig(compress_grads=compress)
        want = JS.train_state_shapes(jget_smoke(arch), _opt(JA), jsc)
        got = TS.train_state_shapes(get_smoke(arch), _opt(TA), TS.StepConfig(
            compress_grads=compress))
        w = {p: (tuple(a.shape), str(a.dtype)) for p, a in tree.leaves_with_path(want)}
        g = {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
             for p, a in tree.leaves_with_path(got)}
        assert g == w
        assert all(a.device.type == "meta" for a in tree.leaves(got))


def test_init_params_draws_as_the_model(f32_mode):
    """init_params draws DecoderLM's numbers from the same generator, and
    model_to_numpy gives them back as the reference's stacked tree."""
    cfg = get_smoke("jamba-v0.1-52b")
    params = TM.init_params(cfg, "cpu", torch.Generator().manual_seed(3))
    model = TM.DecoderLM(cfg, "cpu", torch.Generator().manual_seed(3))
    want = dict(tree.leaves_with_path(tree.map(np_, params)))
    got = dict(tree.leaves_with_path(convert.model_to_numpy(model)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    back = convert.model_to_numpy(convert.model_from_numpy(convert.model_to_numpy(model), cfg,
                                                            device="cpu"))
    for k in want:
        np.testing.assert_array_equal(dict(tree.leaves_with_path(back))[k], want[k])


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_remat_changes_no_number(arch):
    """"full" and "dots" recompute inside the backward: the loss and every
    gradient equal "none"'s bit for bit (bf16 compute, the real rounding)."""
    cfg = get_smoke(arch)
    params = TM.init_params(cfg, "cpu", torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0, batch=2, seq=16).items()}
    out = {}
    for remat in ("none", "full", "dots"):
        masters = tree.map(lambda a: a.clone().requires_grad_(True), params)
        loss, _ = TM.loss_params(cfg, TM.compute_copy(masters), batch, remat=remat)
        loss.backward()
        out[remat] = (float(loss), [np_(p.grad) for p in tree.leaves(masters)])
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            np.testing.assert_array_equal(a, b)
