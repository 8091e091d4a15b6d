"""internvl2-1b [vlm] — InternViT + InternLM2 backbone (arXiv:2404.16821; hf).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The InternViT
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (B, 256, d) occupying the first 256 positions.
long_500k: SKIP (pure full attention).

A copy of `repro/configs/internvl2_1b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    frontend="vision",
    n_frontend_tokens=256,
    # 14 heads -> pad to 16; vocab 151655 -> pad to 151808 (16*9488): the
    # unpadded CE materialized a replicated-on-vocab 20 GiB logits tensor
    # (EXPERIMENTS.md §Perf it. 3)
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=4,
                             pad_heads_to=16, pad_vocab_to=151808),
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    frontend="vision",
    n_frontend_tokens=8,
)
