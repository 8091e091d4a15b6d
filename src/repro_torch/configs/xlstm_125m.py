"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517; unverified).

12L d_model=768 4H d_ff=0 (xLSTM blocks carry their own projections),
vocab=50304.  Pattern: one sLSTM per 6 layers (offset 2), mLSTM elsewhere.
long_500k: NATIVE (recurrent state is O(1)/token).

A copy of `repro/configs/xlstm_125m.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy, XLSTMConfig

LONG_CONTEXT = "native"

_PATTERN = tuple("slstm" if i == 2 else "mlstm" for i in range(6))

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    block_period=6,
    pattern=_PATTERN,
    xlstm=XLSTMConfig(n_heads=4, chunk=256),
    # 125M params: replicate them, shard the batch over every axis (pure DP).
    # TP here would shard nh=4 / hd=384 contraction dims -> all-reduce storms
    # (measured: 85 GiB temp, collective-bound; EXPERIMENTS.md §Perf).
    policy=ParallelismPolicy(dp_only=True, remat="dots", scan_layers=True),
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke",
    family="ssm",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    block_period=6,
    pattern=_PATTERN,
    xlstm=XLSTMConfig(n_heads=4, chunk=16),
)
