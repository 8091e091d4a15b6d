"""internlm2-1.8b [dense] — GQA (arXiv:2403.17297; hf).

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
long_500k: SKIP (pure full attention).

A copy of `repro/configs/internlm2_1_8b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    head_dim=128,
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=4),
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
)
