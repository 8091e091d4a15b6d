"""stablelm-3b [dense] — (hf:stabilityai/stablelm family; unverified).

32L d_model=2560 32H (GQA kv=32 = full MHA) d_ff=6912 vocab=50304.
long_500k: SKIP (pure full attention).

A copy of `repro/configs/stablelm_3b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=4),
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_ff=256,
    vocab_size=512,
)
