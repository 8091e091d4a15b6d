"""musicgen-medium [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284; hf).  48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.

The EnCodec frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d).  long_500k: SKIP (full attention).

A copy of `repro/configs/musicgen_medium.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    frontend="audio",
    # 24 MHA heads don't divide model=16: pad to 32 (masked pad heads) —
    # without this, replicated attention costs 16x redundant compute and the
    # head_dim fallback cost 78 s of all-reduce (EXPERIMENTS.md §Perf it. 1)
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=4,
                             pad_heads_to=32, pad_kv_heads_to=32),
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_ff=256,
    vocab_size=256,
    frontend="audio",
)
