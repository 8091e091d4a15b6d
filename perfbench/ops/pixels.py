"""pixels: one `ActiveSearcher.search` of `batch` pixels of the configuration's image a call.

The grid is the paper's image (3000 x 3000 pixels over the data's extent,
the 1% margin included, as the identity projection lays it out).  A user
who draws the classification map progressively asks for the neighbours of
every pixel, `batch` pixels a call, in an order drawn from the run's seed,
so that each call covers the whole map thinly and every call does the same
work; a cycle is the whole image's calls, less the pixels that do not fill
a last call.  Each pixel is sampled at one point within it, drawn from the
configuration's data seed (a pixel's centre would sit exactly on the
circle of a whole radius around a neighbouring pixel centre, where the
Eq.-1 count depends on the last bit of rounding).  The points are worked
out in float64 from the base points' extent by the benchmark itself and
sent as float32 from the host's pinned memory, so the program's own call
moves them to the card.  Checks, recall and the candidate stage's work are
the search operation's, on the pixels the call answered.
"""

from __future__ import annotations

from pathlib import Path

import torch

from perfbench.harness.cell import load_module
from perfbench.harness.traffic import generator

_search = load_module(Path(__file__).resolve().parents[2], "ops", "search")
MARGIN = 0.01


class Op(_search.Op):
    def __init__(self, tr):
        self.tr, self.k, self.last = tr, tr.k, None
        base = tr.base()[0].to(torch.float64)
        lo, hi = base.amin(dim=0), base.amax(dim=0)
        span = torch.clamp_min(hi - lo, 1e-6)
        lo, span = lo - MARGIN * span, span * (1 + 2 * MARGIN)
        size = int(tr.grid["grid_size"])
        dev = tr.device
        ij = torch.cartesian_prod(torch.arange(size, device=dev), torch.arange(size, device=dev))
        jitter = torch.rand(ij.shape, generator=generator(dev, tr.data_seed, "jitter"),
                            device=dev, dtype=torch.float64)
        points = (lo + (ij + jitter) / size * span).to(torch.float32)
        order = torch.randperm(size * size, generator=generator(dev, tr.seed, "pixel-order"),
                               device=dev)
        self.calls = size * size // tr.batch
        q = points[order[:self.calls * tr.batch]].reshape(self.calls, tr.batch, 2).cpu()
        self.pixels = q.pin_memory() if dev.type == "cuda" else q
        self.queries = self.pixels[0]

    def call_at(self, step: int) -> int:
        return step % self.calls

    def run(self, ctx, searcher, step: int):
        self.now = self.call_at(step)
        self.last = ctx.call("search", lambda: searcher.search(self.pixels[self.now], self.k),
                             self.tr.batch)
        return searcher

    def take(self) -> dict:
        return {**super().take(), "call": torch.tensor(self.now)}

    def at_step(self, step: int) -> dict:
        return {"call": torch.tensor(self.call_at(step))}

    def asked(self, got: dict):
        c = int(got["call"])
        return self.pixels[c], ("pixels", c)
