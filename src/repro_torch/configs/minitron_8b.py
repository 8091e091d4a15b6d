"""minitron-8b [dense] — pruned Nemotron (arXiv:2407.14679; hf).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
long_500k: SKIP natively (pure full attention); served via the beyond-paper
active-search retrieval-memory path (DESIGN.md §5).

A copy of `repro/configs/minitron_8b.py`; the port never imports the reference
package."""

from repro_torch.models.config import ModelConfig, ParallelismPolicy

LONG_CONTEXT = "retrieval"

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    rope_theta=1_000_000.0,
    # §Perf hillclimb (b): remat="dots" removes the fwd-recompute TP
    # all-reduces (X 4.77->4.09 s) and 21%% of compute; accum=16 keeps the
    # saved dot outputs inside 16 GiB HBM (8.2 GiB temp).
    policy=ParallelismPolicy(remat="dots", scan_layers=True, accum=16),
)

SMOKE = ModelConfig(
    name="minitron-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
)
