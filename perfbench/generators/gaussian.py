"""gaussian: standard normal points, the paper's "randomly generated" 2-D data.

A frozen copy of `chip_smoke.py` phase 2's draw (`torch.randn` on the card).
"""

import torch


def make(gen: torch.Generator, fixed: torch.Generator, m: int, d: int) -> torch.Tensor:
    """m points (m, d) float32 on `gen`'s device; the distribution has no
    parameters of its own, so `fixed` is not read."""
    del fixed
    return torch.randn((m, d), generator=gen, device=gen.device)
