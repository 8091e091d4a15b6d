"""The port's data pipeline (`repro_torch/data/pipeline.py`): the cases
of tests/test_data.py, and every batch equal to the reference's, array
for array (numpy in both packages)."""

import numpy as np
import pytest

from repro.configs import get_smoke as jget_smoke
from repro.data import pipeline as JP
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig, Prefetcher, add_frontend_inputs, synth_batch


def test_step_determinism():
    cfg = DataConfig(global_batch=8, seq_len=32, vocab_size=128, seed=3)
    a, b = synth_batch(cfg, 7), synth_batch(cfg, 7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], synth_batch(cfg, 8)["tokens"])


def test_labels_are_shifted_tokens():
    b = synth_batch(DataConfig(global_batch=2, seq_len=16, vocab_size=64), 0)
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_hosts_partition_the_global_batch():
    full = synth_batch(DataConfig(global_batch=8, seq_len=8, vocab_size=32), 5)
    rows = [synth_batch(DataConfig(global_batch=8, seq_len=8, vocab_size=32, n_hosts=2,
                                   host_id=h), 5)["tokens"] for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(rows, axis=0), full["tokens"])


@pytest.mark.parametrize("kw", [dict(global_batch=8, seq_len=32, vocab_size=128, seed=3),
                                dict(global_batch=8, seq_len=8, vocab_size=32, n_hosts=2,
                                     host_id=1),
                                dict(global_batch=4, seq_len=64, vocab_size=92544, seed=11,
                                     zipf_a=1.1)],
                         ids=["one_host", "second_of_two_hosts", "wide_vocab"])
def test_synth_batch_equals_reference(kw):
    for step in (0, 1, 17):
        got = synth_batch(DataConfig(**kw), step)
        want = JP.synth_batch(JP.DataConfig(**kw), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-1b", "internlm2-1.8b"])
def test_frontend_inputs_equal_reference(arch):
    dc = dict(global_batch=2, seq_len=8, vocab_size=256)
    got = add_frontend_inputs(synth_batch(DataConfig(**dc), 3), get_smoke(arch), 3, seed=5)
    want = JP.add_frontend_inputs(JP.synth_batch(JP.DataConfig(**dc), 3), jget_smoke(arch), 3,
                                  seed=5)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if arch == "musicgen-medium":
        assert got["frame_embeds"].shape == (2, 8, get_smoke(arch).d_model)
    if arch == "internvl2-1b":
        assert got["vision_embeds"].shape == (2, get_smoke(arch).n_frontend_tokens,
                                              get_smoke(arch).d_model)


def test_prefetcher_order_and_restart():
    """Batches come in step order from `start_step`, each equal to
    synth_batch (and the reference's) at its step; a new prefetcher at a
    later start_step picks up there."""
    cfg = DataConfig(global_batch=2, seq_len=8, vocab_size=32, prefetch=2)
    mcfg = get_smoke("musicgen-medium")
    for start in (10, 13):
        pf = Prefetcher(cfg, model_cfg=mcfg, start_step=start)
        got = [next(pf) for _ in range(3)]
        pf.close()
        assert [s for s, _ in got] == [start, start + 1, start + 2]
        for s, b in got:
            want = JP.add_frontend_inputs(
                JP.synth_batch(JP.DataConfig(global_batch=2, seq_len=8, vocab_size=32), s),
                jget_smoke("musicgen-medium"), s, 0)
            for k in want:
                np.testing.assert_array_equal(b[k], want[k])
