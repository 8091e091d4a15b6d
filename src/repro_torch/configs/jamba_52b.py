"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE every other
layer, 16 experts top-2 (arXiv:2403.19887; hf).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
long_500k: NATIVE (attention is 4/32 layers; Mamba state is O(1)/token).

A copy of `repro/configs/jamba_52b.py`; the port never imports the reference
package."""

from repro_torch.models.config import (
    MambaConfig,
    ModelConfig,
    MoEConfig,
    ParallelismPolicy,
)

LONG_CONTEXT = "native"

# Jamba block: period 8, attention at in-block index 4, MoE on odd layers.
_PATTERN = tuple("mamba" if i != 4 else "attn" for i in range(8))
_MOE = tuple(i % 2 == 1 for i in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    block_period=8,
    pattern=_PATTERN,
    moe_layers=_MOE,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, group_size=512),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    # accum=16: the mamba chunk tensors (B,Q,din,ds) dominate temp memory;
    # halving the microbatch brings 26.6 -> inside 16 GiB HBM.
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=16),
)

SMOKE = ModelConfig(
    name="jamba-52b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    block_period=8,
    pattern=_PATTERN,
    moe_layers=_MOE,
    # capacity_factor 4: drop-free at smoke scale (prefill/decode consistency)
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, group_size=64,
                  capacity_factor=4.0),
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16),
)
