"""Find a cell's files by the names in `BENCHMARK.json`.

A cell names a configuration and a traffic mix; the harness reads

  the configuration   the file its `configs` entry names (perfbench/configs/),
  its data generator  perfbench/generators/<data.generator>.py, a `make` function,
  the traffic mix     perfbench/traffic/<traffic>.json,
  each operation      perfbench/ops/<op>.py of the mix's step, an `Op` class,
  the limits          perfbench/limits/<cell>.json (what `correct` holds to),
  each metric         perfbench/metrics/<metric>.py, a `read(run)` function,

so that a configuration, a generator, a mix, an operation or a metric is
added by adding files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

from perfbench.harness import traffic as traffic_lib

BENCH_DIR = "perfbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: tuple[str, ...]
    per_layer: tuple[str, ...]
    units: dict
    root: Path

    def traffic(self, seed: int, device) -> traffic_lib.Traffic:
        """The inputs of one run of this cell."""
        make_points = load_module(self.root, "generators", self.config["data"]["generator"]).make

        def make_op(entry, tr):
            params = {k: v for k, v in entry.items() if k != "op"}
            return load_module(self.root, "ops", entry["op"]).Op(tr, **params)

        return traffic_lib.Traffic(self.config, self.mix, seed, device, make_points, make_op)


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise FileNotFoundError(f"the benchmark has no file {path}") from None


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    mix = _load_json(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    traffic_lib.check_mix(mix, w["traffic"])
    limits = _load_json(root / BENCH_DIR / "limits" / f"{name}.json")
    metrics = bench["end_to_end"] + bench["per_layer"]
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix, limits=limits,
        end_to_end=tuple(m["name"] for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m["name"] for m in bench["per_layer"] if _applies(m, name)),
        units={m["name"]: m["unit"] for m in metrics}, root=Path(root),
    )


def load_module(root: Path, folder: str, name: str):
    """perfbench/<folder>/<name>.py as a module."""
    path = Path(root) / BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{folder} has no {name!r}: no file {path}")
    module_name = f"perfbench_{folder}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(root: Path, metric: str):
    """The `read(run)` function of perfbench/metrics/<metric>.py."""
    return load_module(root, "metrics", metric).read
