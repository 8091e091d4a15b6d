"""The mesh program's repairs that the dry run's 16 x 16 traces found,
run with values on four `gloo` ranks on the CPU (tests/_torch_mesh_ranks.py
`repairs`) against the port on one device: a decode into caches sharded
over their positions, jamba's and xlstm's prefill and train steps on
2 x 2, and a prefill whose kv heads do not divide the model axis.  One
rank program runs once per module."""

import os

import numpy as np
import pytest
from test_torch_steps import hold_normwise, hold_params

import _torch_mesh_ranks as R

TOL = dict(rtol=1e-5, atol=1e-5)
STATE_REL = 1e-5     # a recurrent state leaf: its largest difference over its largest value


@pytest.fixture(scope="module")
def repairs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("repairs"))
    R.spawn(R.repairs, 4, work)
    with np.load(os.path.join(work, "repairs.npz")) as z:
        return {k: z[k] for k in z.files}


def _pairs(out: dict, prefix: str) -> list:
    keys = [k[len(prefix) + len("/one/"):] for k in out if k.startswith(prefix + "/one/")]
    assert keys, prefix
    return [(k, out[f"{prefix}/mesh/{k}"], out[f"{prefix}/one/{k}"]) for k in keys]


@pytest.mark.parametrize("step", ["serve", "retrieval"])
def test_decode_at_batch_1_into_position_sharded_caches(repairs, step):
    """Batch 1 on 2 x 2: the caches' positions are sharded over 'data', so
    each write goes to the rank holding the position; four decodes across
    the shard boundary give one device's logits, hiddens and caches."""
    assert bool(repairs[f"b1_{step}/positions_sharded"])
    assert int(repairs["b1_position_writes"]) > 0
    for k, got, want in _pairs(repairs, f"b1_{step}"):
        np.testing.assert_allclose(got, want, err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_recurrent_prefill_on_2x2_equals_one_device(repairs, arch):
    """Mamba's causal conv and the mLSTM chunk under `local_map`: the
    prefill's logits and hidden within 1e-5, each cache leaf normwise
    within STATE_REL (a state sums 32 tokens' terms, whose row-parallel
    products add their partial sums in another order on the mesh)."""
    for k, got, want in _pairs(repairs, f"{arch}/prefill"):
        if k.startswith("cache/"):
            hold_normwise({k: got}, {k: want}, STATE_REL)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_recurrent_train_step_on_2x2_holds(repairs, arch):
    """One train step on 2 x 2 from the one-device state: the parameters
    held (`hold_params`) against one device's step, the loss within 1e-5."""
    pairs = _pairs(repairs, f"{arch}/train")
    metric = {k[len("metric/"):]: (g, w) for k, g, w in pairs if k.startswith("metric/")}
    params = {k: (g, w) for k, g, w in pairs if not k.startswith("metric/")}
    hold_params({k: g for k, (g, _) in params.items()}, {k: w for k, (_, w) in params.items()},
                float(metric["lr"][1]))
    np.testing.assert_allclose(*metric["loss"], rtol=1e-5)


def test_prefill_where_kv_heads_do_not_divide_the_model_axis(repairs):
    """minitron SMOKE with 3 kv heads (6 heads) on 2 x 2: the k and v
    projections' flattened heads, split two ways, are replicated before
    they are unflattened (DTensor cannot unflatten them otherwise);
    logits, hidden and the first cache within 1e-5 of one device."""
    assert int(repairs["kv_split_replicated"]) > 0
    for k, got, want in _pairs(repairs, "kv_split"):
        np.testing.assert_allclose(got, want, err_msg=k, **TOL)
