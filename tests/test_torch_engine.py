"""The port's LM serving path against the JAX package's: `Engine.generate`
with and without the kNN-LM head, `build_datastore_from_model`, the online
queue -> drain -> grown datastore, and the `serve` CLI.

internlm2-1.8b's SMOKE config (and, for the generate test of every layer
kind, qwen2-moe's, jamba's and xlstm's) with the reference's weights
carried across (`convert.model_from_numpy`), in float32 mode (both packages'
`ACT_DTYPE` switched with monkeypatch, as in test_torch_models.py), where
the greedy tokens must be equal.  The head's datastore is the reference's,
carried across with `convert.index_from_numpy`, so both search the same
arrays; the port searches on `hopper` (its kernels' plain versions on the
CPU), the reference on `jnp`.  Hidden states are held to F32_TOL, ids,
labels and tokens exactly.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_dists_close, assert_index_equal, np_, require_cuda

import repro.models.layers as JL
from repro.configs import get_smoke as jget_smoke
from repro.core import knn_lm as jknn
from repro.launch import serve as jserve
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro_torch.configs import get_smoke
from repro_torch.convert import index_from_numpy, model_from_numpy
from repro_torch.core import knn_lm as tknn
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
K = 4


def _make_lm(arch: str) -> dict:
    """The reference's weights in both packages (float32 mode must be on),
    and a datastore the reference harvested from its model (8 sequences of
    33 tokens: 256 pairs)."""
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    params = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    corpus = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(8, 33),
                                               dtype=np.int32)
    jknn_cfg, tknn_cfg = jknn.KNNLMConfig(k=K), tknn.KNNLMConfig(k=K)
    jstore = jserve.build_datastore_from_model(jcfg, params, corpus, jknn_cfg)
    tstore = index_from_numpy(jax.tree.map(np.asarray, jstore)._asdict(), tknn_cfg.grid,
                              device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model, corpus=corpus,
                jknn=jknn_cfg, tknn=tknn_cfg, jstore=jstore, tstore=tstore,
                mesh=make_host_mesh(1, 1))


@pytest.fixture
def f32_mode(monkeypatch):
    monkeypatch.setattr(JL, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "ACT_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def lm():
    """Both packages in float32 mode for the module; internlm2's SMOKE."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "ACT_DTYPE", jnp.float32)
        mp.setattr(TL, "ACT_DTYPE", torch.float32)
        yield _make_lm(ARCH)


def _prompts(seed, cfg, b=2, s=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)


def _engines(lm, knn: bool, max_new=5):
    jsc = jserve.ServeConfig(max_new_tokens=max_new, knn=lm["jknn"] if knn else None)
    tsc = tserve.ServeConfig(max_new_tokens=max_new, knn=lm["tknn"] if knn else None)
    je = jserve.Engine(lm["jcfg"], lm["params"], lm["mesh"], jsc,
                       datastore=lm["jstore"] if knn else None)
    te = tserve.Engine(lm["tcfg"], lm["model"], tsc,
                       datastore=lm["tstore"] if knn else None, device="cpu")
    return je, te


def _same_generation(got, want):
    toks, hiddens = got
    np.testing.assert_array_equal(np_(toks), want[0])
    assert toks.dtype == torch.int32 and len(hiddens) == len(want[1])
    for g, w in zip(hiddens, want[1]):
        np.testing.assert_allclose(np_(g), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("knn", [False, True], ids=["lm_only", "knn_head"])
def test_generate_matches_reference(lm, knn):
    """Greedy tokens equal the reference Engine's, with and without the
    kNN-LM head; the per-step hiddens agree; the stats count the tokens."""
    je, te = _engines(lm, knn)
    prompts = _prompts(1, lm["jcfg"])
    want = je.generate(prompts)
    got = te.generate(prompts)
    _same_generation(got, want)
    assert te.stats["tokens"] == 2 * 5 and te.stats["prefill_s"] > 0
    # greedy is deterministic across engines
    np.testing.assert_array_equal(np_(_engines(lm, knn)[1].generate(prompts)[0]), want[0])


def _in_corpus_order(store):
    """(keys, labels) of a datastore of either package, in corpus order
    (through ids_sorted)."""
    ids = np_(store.ids_sorted)
    keys = np.empty(np_(store.points_sorted).shape, np.float32)
    labels = np.empty(store.n_points, np.int32)
    keys[ids], labels[ids] = np_(store.points_sorted), np_(store.labels_sorted)
    return keys, labels


def test_build_datastore_from_model_matches_reference(lm, monkeypatch):
    """The harvested keys (in corpus order) within F32_TOL of the
    reference's, the labels exactly corpus[:, 1:]; batching the corpus
    (HARVEST_BATCH 16: one forward; 3: three) changes nothing."""
    w_keys, w_labels = _in_corpus_order(lm["jstore"])
    np.testing.assert_array_equal(w_labels, lm["corpus"][:, 1:].reshape(-1))
    stores = []
    for batch in (16, 3):
        monkeypatch.setattr(tserve, "HARVEST_BATCH", batch)
        stores.append(tserve.build_datastore_from_model(lm["tcfg"], lm["model"], lm["corpus"],
                                                        lm["tknn"]))
        g_keys, g_labels = _in_corpus_order(stores[-1])
        np.testing.assert_allclose(g_keys, w_keys, **F32_TOL)
        np.testing.assert_array_equal(g_labels, w_labels)
    assert_index_equal(stores[1], stores[0])
    with pytest.raises(ValueError, match="built for"):
        tserve.build_datastore_from_model(get_smoke("minitron-8b"), lm["model"], lm["corpus"],
                                          lm["tknn"])


def test_build_datastore_from_model_over_two_attention_chunks(lm):
    """A corpus of S = 2 * attn_chunk tokens, which the reference's causal
    attention takes (S % chunk == 0), harvests on both packages alike: the
    forward runs over all S tokens, not S - 1."""
    chunk = 16
    jcfg = dataclasses.replace(lm["jcfg"], policy=dataclasses.replace(lm["jcfg"].policy,
                                                                      attn_chunk=chunk))
    tcfg = dataclasses.replace(lm["tcfg"], policy=dataclasses.replace(lm["tcfg"].policy,
                                                                      attn_chunk=chunk))
    model = model_from_numpy(jax.tree.map(np.asarray, lm["params"]), tcfg, device="cpu")
    corpus = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(3, 2 * chunk),
                                               dtype=np.int32)
    w_keys, w_labels = _in_corpus_order(
        jserve.build_datastore_from_model(jcfg, lm["params"], corpus, lm["jknn"]))
    g_keys, g_labels = _in_corpus_order(
        tserve.build_datastore_from_model(tcfg, model, corpus, lm["tknn"]))
    assert g_keys.shape == (3 * (2 * chunk - 1), tcfg.d_model)
    np.testing.assert_allclose(g_keys, w_keys, **F32_TOL)
    np.testing.assert_array_equal(g_labels, w_labels)


def test_online_growth_matches_reference(lm):
    """queue_datastore_pairs -> drain_datastore on both engines with the
    same pairs (the reference's decode stream): the grown datastores equal
    array for array (grid coords within DIST_RTOL); then a second generate
    searches the grown datastore and its tokens equal the reference's."""
    je, te = _engines(lm, knn=True, max_new=6)
    prompts = _prompts(2, lm["jcfg"])
    j_toks, j_hid = je.generate(prompts)
    _same_generation(te.generate(prompts), (j_toks, j_hid))
    n0 = te.datastore.n_points
    added = te.queue_datastore_pairs([torch.from_numpy(np.array(h)) for h in j_hid],
                                     torch.from_numpy(np.array(j_toks)))
    assert added == je.queue_datastore_pairs(j_hid, j_toks) == 2 * 5
    assert te.datastore_queue().stats["insert_backlog"] == added
    assert te.drain_datastore() == je.drain_datastore() == added
    assert te.datastore.n_points == n0 + added
    want = je.datastore
    assert_index_equal(te.datastore, want,
                       fields=("points_sorted", "labels_sorted", "ids_sorted", "offsets"))
    assert_dists_close(te.datastore.coords_sorted, want.coords_sorted)
    # the grown labels hold the stream's next tokens, in step-major order
    ids, labels = np_(te.datastore.ids_sorted), np_(te.datastore.labels_sorted)
    np.testing.assert_array_equal(labels[np.argsort(ids)][n0:], j_toks[:, 1:].T.reshape(-1))
    prompts2 = _prompts(3, lm["jcfg"])
    _same_generation(te.generate(prompts2), je.generate(prompts2))
    assert te.drain_datastore() == 0
    with pytest.raises(ValueError, match="needs a kNN-LM datastore"):
        _engines(lm, knn=False)[1].extend_datastore(j_hid, j_toks)


def _serve(*args, timeout=240):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=timeout)


def test_serve_cli_on_the_cpu():
    """`--device cpu --knn --knn-online` serves two batches and grows the
    datastore between them; without --device it needs a card."""
    out = _serve("--device", "cpu", "--knn", "--knn-online", "--batch", "2",
                 "--prompt-len", "8", "--max-new", "4", "--datastore-size", "512")
    assert out.returncode == 0, out.stderr
    assert "datastore: 512 keys" in out.stdout
    assert "grew online: +6 pairs -> 518 keys" in out.stdout
    assert "generated (2, 4) tokens" in out.stdout
    if not torch.cuda.is_available():
        bare = _serve("--batch", "2", "--prompt-len", "8", "--max-new", "2")
        assert bare.returncode != 0 and "device='cpu'" in bare.stderr


def test_serve_refuses_what_it_cannot_run(lm):
    """No card and no --device: Engine and main raise rather than run on
    the CPU.  Bad flags exit before any model is built."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.Engine(lm["tcfg"], lm["model"], tserve.ServeConfig())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--max-new", "2"])
    with pytest.raises(SystemExit, match="requires --knn"):
        tserve.main(["--knn-online", "--device", "cpu"])
    with pytest.raises(SystemExit, match="cannot serve datastore searches"):
        tserve.main(["--knn", "--knn-backend", "hopper_stacked", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown backend"):
        tserve.main(["--knn", "--knn-backend", "pallas", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b", "xlstm-125m"])
def test_generate_with_the_head_matches_reference_every_layer_kind(arch, f32_mode):
    """MoE (qwen2-moe: padded and shared experts), Mamba + attention + MoE
    (jamba) and mLSTM + sLSTM (xlstm): the datastore the reference
    harvests, then Engine.generate with the kNN-LM head, greedy tokens
    equal to the reference's and the hiddens within F32_TOL; the port's own
    harvest equal to the reference's in corpus order."""
    lm = _make_lm(arch)
    w_keys, w_labels = _in_corpus_order(lm["jstore"])
    g_keys, g_labels = _in_corpus_order(tserve.build_datastore_from_model(
        lm["tcfg"], lm["model"], lm["corpus"], lm["tknn"]))
    np.testing.assert_allclose(g_keys, w_keys, **F32_TOL)
    np.testing.assert_array_equal(g_labels, w_labels)
    je, te = _engines(lm, knn=True)
    prompts = _prompts(5, lm["jcfg"])
    _same_generation(te.generate(prompts), je.generate(prompts))


@pytest.mark.parametrize("b, s, batch", [(10, 32, 3), (9, 32, 3), (12, 33, 3), (65, 33, 16)],
                         ids=["whole_groups", "short_tail_joins", "s_coprime_to_g", "wide_65x33"])
def test_moe_harvest_cuts_only_between_groups(b, s, batch, f32_mode, monkeypatch):
    """An MoE model's harvest runs layer-major and cuts its MoE layers'
    tokens only between the reference's groups (g = 64 tokens at
    qwen2-moe's SMOKE), so every GShard group and its capacity drops are
    the reference's one-forward groups: with a capacity factor of 0.5
    (drops in every group) and HARVEST_BATCH `batch`, the keys equal the
    reference's.  S * 3 = 96 or 99 tokens a batch are not whole groups,
    and 65 x 33 (2,145 tokens, the last group padded) is a corpus whose
    whole groups no batch of fewer than 64 whole sequences holds."""
    base = jget_smoke("qwen2-moe-a2.7b")
    jcfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), moe=dataclasses.replace(
        get_smoke("qwen2-moe-a2.7b").moe, capacity_factor=0.5))
    params = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    model = model_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    corpus = np.random.default_rng(6).integers(0, jcfg.vocab_size, size=(b, s), dtype=np.int32)
    knn = tknn.KNNLMConfig(k=K)
    monkeypatch.setattr(tserve, "HARVEST_BATCH", batch)
    w_keys, w_labels = _in_corpus_order(
        jserve.build_datastore_from_model(jcfg, params, corpus, jknn.KNNLMConfig(k=K)))
    g_keys, g_labels = _in_corpus_order(tserve.build_datastore_from_model(
        tcfg, model, corpus, knn))
    np.testing.assert_allclose(g_keys, w_keys, **F32_TOL)
    np.testing.assert_array_equal(g_labels, w_labels)
    # the cuts matter: 3 sequences (96 or 99 tokens) alone re-form the groups
    with torch.no_grad():
        cut = model.hidden_states({"tokens": torch.from_numpy(corpus[:3])})[:, :-1]
    assert not np.allclose(np_(cut).reshape(-1, tcfg.d_model), w_keys[:3 * (s - 1)], atol=1e-3)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_serve_cli_serves_every_layer_kind(arch):
    """`--arch` with MoE, Mamba and xLSTM layers serves on the CPU with the
    head and online growth."""
    out = _serve("--device", "cpu", "--arch", arch, "--knn", "--knn-online", "--batch", "2",
                 "--prompt-len", "8", "--max-new", "4", "--datastore-size", "512")
    assert out.returncode == 0, out.stderr
    assert "datastore: 512 keys" in out.stdout
    assert "grew online: +6 pairs -> 518 keys" in out.stdout
    assert "generated (2, 4) tokens" in out.stdout


@pytest.mark.gpu
def test_gpu_engine_equals_the_cpu(lm):
    """On the card, float32 mode: the same tokens as the CPU with the kNN-LM
    head on `hopper` (its two kernels launched once per pick), and the
    online growth equal to the CPU's."""
    dev = require_cuda()
    from repro_torch.kernels import csr_candidate_topk, radius_search_loop

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        engines = [tserve.Engine(lm["tcfg"], model_from_numpy(
            jax.tree.map(np.asarray, lm["params"]), lm["tcfg"], device=d),
            tserve.ServeConfig(max_new_tokens=5, knn=lm["tknn"]), lm["tstore"], device=d)
            for d in ("cpu", dev)]
        prompts = _prompts(4, lm["jcfg"])
        want = engines[0].generate(prompts)
        radius_search_loop.launches = csr_candidate_topk.launches = 0
        got = engines[1].generate(prompts)
        assert radius_search_loop.launches == csr_candidate_topk.launches == 5
        assert got[0].device.type == "cuda"
        np.testing.assert_array_equal(np_(got[0]), np_(want[0]))
        for g, w in zip(got[1], want[1]):
            np.testing.assert_allclose(np_(g), np_(w), **F32_TOL)
        for e in engines:
            e.extend_datastore([h.to(e.device) for h in want[1]], want[0])
        assert_index_equal(engines[1].datastore, engines[0].datastore)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
