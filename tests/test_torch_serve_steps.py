"""The port's prefill, serve and retrieval serve steps
(`repro_torch/launch/steps.py`) against the reference's
(`repro/launch/steps.py`) at internlm2's SMOKE size in float32 ACT_DTYPE
in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np_

import repro.models.layers as JL
from repro.configs import get_smoke as jget_smoke
from repro.core import engine as jeng
from repro.core import retrieval_memory as jrmem
from repro.core.grid import GridConfig as JGridConfig
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import retrieval_memory as trmem
from repro_torch.core.grid import GridConfig as TGridConfig
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


def _lm(arch="internlm2-1.8b"):
    jcfg = jget_smoke(arch)
    params = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    model = convert.model_from_numpy(jax.tree.map(np.asarray, params), get_smoke(arch),
                                     device="cpu")
    return jcfg, params, model


def test_prefill_and_serve_steps_equal_reference(f32_mode):
    """make_prefill_step then two make_serve_step decode steps, plain and
    with retrieved positions: logits and hiddens within the model
    tolerance of the reference's steps."""
    jcfg, params, model = _lm()
    mesh = make_host_mesh(1, 1)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12), dtype=np.int32)
    jpre = JS.make_prefill_step(jcfg, mesh)[0]
    tpre = TS.make_prefill_step(get_smoke("internlm2-1.8b"))
    jl, jc, jh = jpre(params, {"tokens": jnp.asarray(prompt)})
    tl, tc, th = tpre(model, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(np_(tl), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(np_(th), np.asarray(jh), **F32_TOL)
    for retrieval in (None, (3, 4)):
        js = JS.make_serve_step(jcfg, mesh, retrieval)[0]
        ts = TS.make_serve_step(get_smoke("internlm2-1.8b"), retrieval)
        jcaches = jax.tree.map(lambda a: jnp.pad(a, [(0, 0)] * 2 + [(0, 4)] + [(0, 0)] * 2),
                               jc)
        tcaches = convert.caches_from_numpy(jax.tree.map(np.asarray, jcaches), device="cpu")
        for i, pos in enumerate((12, 13)):
            token = np.asarray([5 + i, 7 + i], np.int32)
            args = ()
            if retrieval is not None:
                ret = np.asarray([[0, 3, 9], [1, 2, 11]], np.int32)
                ok = np.asarray([[True, True, False], [True, True, True]])
                args = (ret, ok)
            with mesh:
                jl, jcaches, jh = js(params, jcaches, jnp.asarray(token), jnp.int32(pos),
                                     *map(jnp.asarray, args))
            tl, tcaches, th = ts(model, tcaches, torch.from_numpy(token), pos,
                                 *map(torch.from_numpy, args))
            np.testing.assert_allclose(np_(tl), np.asarray(jl), **F32_TOL)
            np.testing.assert_allclose(np_(th), np.asarray(jh), **F32_TOL)


def test_retrieval_serve_step_equals_reference(f32_mode):
    """make_retrieval_serve_step over a memory index of 256 key summaries
    (the reference's projection carried across): the retrieved positions
    equal the reference's search's, and the step's logits and hidden are
    within the model tolerance of the reference's step."""
    arch = "internlm2-1.8b"
    jcfg, params, model = _lm(arch)
    cfg = get_smoke(arch)
    mesh = make_host_mesh(1, 1)
    t_len, prompt_len = 256, 200
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, (2, prompt_len), dtype=np.int32)
    _, jc, _ = JM.prefill(params, jcfg, {"tokens": jnp.asarray(prompt)}, cache_len=t_len)
    keys = rng.normal(size=(t_len, cfg.head_dim)).astype(np.float32)
    # the default grid is sized for 500k positions: a small one for 256
    grid = dict(grid_size=64, tile=8, window=16, row_cap=16, r0=4, k_slack=4.0, max_iters=12)
    jmem = jrmem.RetrievalMemoryConfig(n_retrieved=8, local_window=4,
                                       grid=JGridConfig(**grid))
    tmem = trmem.RetrievalMemoryConfig(n_retrieved=8, local_window=4,
                                       grid=TGridConfig(**grid))
    jproj = jrmem.make_projection(jax.random.PRNGKey(4), cfg.head_dim)
    jindex = jrmem.build_memory_index(jnp.asarray(keys), jmem, jproj)
    tindex = trmem.build_memory_index(
        torch.from_numpy(keys), tmem,
        convert.projection_from_numpy(*map(np.asarray, jproj), device="cpu"))
    jstep = JS.make_retrieval_serve_step(jcfg, mesh, jmem)[0]
    tstep = TS.make_retrieval_serve_step(cfg, tmem)
    jcaches = jc
    tcaches = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    for i, pos in enumerate((prompt_len, prompt_len + 1)):
        token = np.asarray([3 + i, 11 + i], np.int32)
        # the reference's search, as its step runs it
        x = params["embed"][jnp.asarray(token)][:, None, :].astype(jnp.bfloat16)
        q0 = jnp.einsum("bsd,dhk->bshk", x,
                        params["blocks"][0]["core"]["wq"][0].astype(jnp.bfloat16))
        res = jeng.ActiveSearcher.from_index(jindex, jmem.grid, plan=jmem.plan).search(
            jnp.mean(q0[:, 0].astype(jnp.float32), axis=1), jmem.n_retrieved)
        want_pos = np.maximum(np.asarray(res.ids), 0)
        want_ok = np.asarray(res.valid) & (want_pos < pos)
        got_pos, got_ok = TS.retrieve(model, tindex, torch.from_numpy(token), pos, tmem)
        np.testing.assert_array_equal(np_(got_pos), want_pos)
        np.testing.assert_array_equal(np_(got_ok), want_ok)
        assert want_ok.any()
        with mesh:
            jl, jcaches, jh = jstep(params, jcaches, jindex, jnp.asarray(token), jnp.int32(pos))
        tl, tcaches, th = tstep(model, tcaches, tindex, torch.from_numpy(token), pos)
        np.testing.assert_allclose(np_(tl), np.asarray(jl), **F32_TOL)
        np.testing.assert_allclose(np_(th), np.asarray(jh), **F32_TOL)
