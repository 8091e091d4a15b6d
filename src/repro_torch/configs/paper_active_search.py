"""The paper's own experimental setup (§3): randomly generated 2-D points,
3 classes, k=11, 100 query points, 3000x3000 image, r0=100 pixels.

A copy of `repro/configs/paper_active_search.py`; the port never imports
the reference package."""

from repro_torch.core.grid import GridConfig

K = 11
N_CLASSES = 3
N_QUERIES = 100

PAPER_GRID = GridConfig(
    grid_size=3000,
    tile=16,
    n_classes=N_CLASSES,
    window=128,
    row_cap=64,
    r0=100,
    max_iters=16,
    k_slack=1.0,   # the paper's exact n == k stopping rule
    metric="l2",
)

# production profile: generous acceptance band, smaller initial radius
PROD_GRID = GridConfig(
    grid_size=1024,
    tile=16,
    n_classes=0,
    window=64,
    row_cap=64,
    r0=8,
    max_iters=12,
    k_slack=4.0,
    metric="l2",
)
