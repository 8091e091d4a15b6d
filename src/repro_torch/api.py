"""`repro_torch.api` — the public searcher API (thin re-export of core/engine.py).

  from repro_torch import api
  s = api.ActiveSearcher.build(points, labels=labels,
                               cfg=api.GridConfig(n_classes=3),
                               plan=api.ExecutionPlan(backend="hopper"))
  res = s.search(queries, k=11)
  s2 = s.insert(more_points)                 # streaming growth, a new handle

Backend names map from the reference's as the package docstring states
(`pallas` -> `hopper`, ...).
"""

from repro_torch.core.engine import (
    ActiveSearcher,
    BackendImpl,
    ExecutionPlan,
    SearchResult,
    get_backend,
    register_backend,
    registered_backends,
)
from repro_torch.core.grid import GridConfig, GridIndex, build_index
from repro_torch.core.projection import (
    Projection,
    gaussian_projection,
    identity_projection,
    pca_projection,
)

__all__ = [
    "ActiveSearcher",
    "BackendImpl",
    "ExecutionPlan",
    "SearchResult",
    "get_backend",
    "register_backend",
    "registered_backends",
    "GridConfig",
    "GridIndex",
    "build_index",
    "Projection",
    "identity_projection",
    "gaussian_projection",
    "pca_projection",
]
