"""The one traffic generator: a cell's data set, query set and steps, made from the seed.

A configuration file (`perfbench/configs/<config>.json`) names its data
generator (`perfbench/generators/<generator>.py`, a `make` function), the
data set's sizes and its own fixed `seed`: the data set and its queries are
one draw of `n + queries` points split by that seed, as a published set
is, so every run sees the same points.  A run's --seed orders them (the
points' arrival order, which is their ids and their order within a grid
cell, and the queries' order), places the checked calls, and draws what
the steps' operations draw (fresh points, retired ids).

A traffic mix (`perfbench/traffic/<mix>.json`) is data:

  batch            queries a search call sends (a prefix of the run's order)
  k                neighbours asked for (default: the configuration's)
  step             the operations of one step, in order, each
                   {"op": <name>, ...its parameters}: perfbench/ops/<name>.py
  checked_calls    answers checked at shares of the window drawn from the
                   seed, besides the window's last (default 3)
  max_steps_per_s  the most steps a second that operations draw inputs for
                   before the window (default 1000)

Everything is drawn on the device from `torch.Generator`s seeded by (seed,
stream, ...), so the same seed gives the same inputs on every run and the
reference can make them again after the window.
"""

from __future__ import annotations

import hashlib

import torch

MIX_KEYS = {"batch", "k", "step", "checked_calls", "max_steps_per_s"}
WARMUP_STEPS = 2     # set-up runs the traffic's first two steps


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of one run: any whole `seed`, however
    large, and any stream name give a seed `manual_seed` takes."""
    digest = hashlib.sha256(":".join(str(p) for p in (seed, *parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *parts))


def check_mix(mix: dict, name: str) -> None:
    unknown = set(mix) - MIX_KEYS
    steps = mix.get("step", [{"op": "search"}])
    if unknown or "batch" not in mix or not steps or any("op" not in s for s in steps):
        raise ValueError(f"traffic {name}: needs 'batch' and ops with an 'op', may have "
                         f"{sorted(MIX_KEYS)}, has unknown {sorted(unknown)}")


class Traffic:
    """The inputs of one run of one cell.  `make_points` is the data
    generator's `make`; `make_op(entry)` builds one operation of the step."""

    def __init__(self, config: dict, mix: dict, seed: int, device, make_points, make_op):
        data = config["data"]
        self.n, self.d = int(data["n"]), int(data["d"])
        self.n_queries = int(data["queries"])
        self.data_seed = int(data["seed"])
        self.params = data.get("params", {})
        self.make_points = make_points
        self.grid = config["grid"]
        self.n_classes = int(self.grid.get("n_classes", 0))
        self.batch = int(mix["batch"])
        self.k = int(mix.get("k", config["k"]))
        self.checked_calls = int(mix.get("checked_calls", 3))
        self.max_steps_per_s = float(mix.get("max_steps_per_s", 1000))
        self.warmup_steps = WARMUP_STEPS
        self.seed, self.device = seed, torch.device(device)
        self._set = None
        self.ops = [make_op(entry, self) for entry in mix.get("step", [{"op": "search"}])]

    @property
    def mutates(self) -> bool:
        return any(op.mutates for op in self.ops)

    def points(self, m: int, seed: int, *stream):
        """m fresh points of the data set's distribution, drawn from the
        stream (seed, *stream), and uniform labels where the grid has classes."""
        gen = generator(self.device, seed, *stream)
        fixed = generator(self.device, self.data_seed, "distribution")
        x = self.make_points(gen, fixed, m, self.d, **self.params).to(torch.float32)
        labels = None
        if self.n_classes:
            labels = torch.randint(0, self.n_classes, (m,), generator=gen, device=self.device,
                                   dtype=torch.int32)
        return x, labels

    def _order(self, m: int, seed: int, stream: str) -> torch.Tensor:
        return torch.randperm(m, generator=generator(self.device, seed, stream),
                              device=self.device)

    def _data_set(self):
        """The configuration's one draw, split into base points and queries."""
        if self._set is None:
            x, labels = self.points(self.n + self.n_queries, self.data_seed, "data")
            split = self._order(self.n + self.n_queries, self.data_seed, "split")
            base, query = split[self.n_queries:], split[:self.n_queries]
            self._set = (x[base], None if labels is None else labels[base], x[query])
        return self._set

    def base(self):
        """The data set's N points in this run's arrival order (ids 0..N-1),
        and their labels."""
        x, labels, _ = self._data_set()
        order = self._order(self.n, self.seed, "order")
        return x[order], None if labels is None else labels[order]

    def queries(self) -> torch.Tensor:
        """The queries a search call sends: the first `batch` of the query
        set in this run's order."""
        if self.batch > self.n_queries:
            raise ValueError(f"a call of {self.batch} queries from a set of {self.n_queries}")
        q = self._data_set()[2]
        return q[self._order(self.n_queries, self.seed, "query-order")][:self.batch].contiguous()

    def forget(self) -> None:
        """Drop the cached draw (it is made again on demand)."""
        self._set = None

    def check_fractions(self) -> list[float]:
        """When, as shares of the window, the checked calls start."""
        gen = generator("cpu", self.seed, "checks")
        return sorted(torch.rand(self.checked_calls, generator=gen).tolist())
