"""blobs: isotropic Gaussian clusters, ANN-Benchmarks' synthetic `random-*` data sets.

ANN-Benchmarks (ann_benchmarks/datasets.py, `random_float`) draws them with
scikit-learn's `make_blobs(n_samples, n_features, centers, random_state=1)`:
cluster centres uniform in `center_box` (-10, 10) per coordinate, every
point its centre plus normal noise of `cluster_std` 1.0, the samples shared
evenly among the centres.  This is the same recipe drawn with torch's
generators on the device, so the set has the published distribution and
sizes but not scikit-learn's bits.
"""

import torch


def make(gen: torch.Generator, fixed: torch.Generator, m: int, d: int, centers: int,
         cluster_std: float = 1.0, center_box: tuple = (-10.0, 10.0)) -> torch.Tensor:
    """m points (m, d) float32: point i belongs to centre i mod `centers`.
    The centres come from `fixed` (the data set's own stream), so that fresh
    points drawn later from `gen` share the data set's clusters."""
    lo, hi = (float(v) for v in center_box)
    mu = torch.rand((centers, d), generator=fixed, device=fixed.device) * (hi - lo) + lo
    which = torch.arange(m, device=gen.device) % centers
    noise = torch.randn((m, d), generator=gen, device=gen.device) * float(cluster_std)
    return mu.to(gen.device)[which] + noise
