"""stablelm-12b [dense] — (hf:stabilityai/stablelm-2-12b family; hf).

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
long_500k: SKIP (pure full attention).

A copy of `repro/configs/stablelm_12b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=8),
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
)
