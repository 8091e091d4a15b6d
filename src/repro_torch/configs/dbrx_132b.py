"""dbrx-132b [moe] — 16 experts top-4, fine-grained
(hf:databricks/dbrx-base; unverified).

40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 vocab=100352, MoE all layers.
long_500k: SKIP (pure full attention).

A copy of `repro/configs/dbrx_132b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, MoEConfig, ParallelismPolicy

LONG_CONTEXT = "skip"

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752, group_size=512),
    moe_layers=(True,),
    # accum=16 keeps the 40L x 6144 activations inside 16 GiB HBM.
    policy=ParallelismPolicy(remat="full", scan_layers=True, accum=16),
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=4, d_expert=128, group_size=64),
    moe_layers=(True,),
)
