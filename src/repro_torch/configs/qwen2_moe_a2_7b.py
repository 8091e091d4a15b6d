"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4, fine-grained experts
(hf:Qwen/Qwen1.5-MoE-A2.7B; hf).

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936.
Experts padded 60 -> 64 for model-axis divisibility (router never picks the
pad; DESIGN.md §4).  Shared experts = one fused MLP of 4*1408 = 5632.
long_500k: SKIP (pure full attention).

A copy of `repro/configs/qwen2_moe_a2_7b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, MoEConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    moe=MoEConfig(
        n_experts=60,
        n_padded=4,
        top_k=4,
        d_expert=1408,
        shared_d_ff=5632,
        group_size=512,
    ),
    moe_layers=(True,),
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=4),
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_ff=64,
    vocab_size=512,
    # capacity_factor 4: drop-free at smoke scale (prefill/decode consistency)
    moe=MoEConfig(n_experts=6, n_padded=2, top_k=4, d_expert=64, shared_d_ff=256,
                  group_size=64, capacity_factor=4.0),
    moe_layers=(True,),
)
