"""A configuration, a traffic mix and a per-layer metric are added as files
only: the harness finds each by the name BENCHMARK.json gives it."""

import json

from small_bench import make_root, run_small
from perfbench.harness import cell as cell_lib


def test_every_name_in_the_benchmark_resolves():
    from small_bench import REPO

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cell_lib.load_cell(REPO, w["name"])
        assert cell.config["name"] == w["config"] and cell.end_to_end and cell.per_layer
        for name in cell.end_to_end + cell.per_layer:
            assert callable(cell_lib.load_reader(REPO, name))


UNIFORM = '''"""uniform: points uniform in [-1, 1)^d."""

import torch


def make(gen, fixed, m, d):
    del fixed
    return 2 * torch.rand((m, d), generator=gen, device=gen.device) - 1
'''

NEAREST = '''"""nearest: one search for the single nearest neighbour, timed as its own kind."""

from pathlib import Path

from perfbench.harness.cell import load_module

_search = load_module(Path(__file__).resolve().parents[2], "ops", "search")


class Op(_search.Op):
    def __init__(self, tr):
        super().__init__(tr, k=1)

    def run(self, ctx, searcher, step):
        self.last = ctx.call("nearest", lambda: searcher.search(self.queries, 1),
                             self.queries.shape[0])
        return searcher
'''


def test_a_dummy_config_generator_mix_op_and_metric_added_as_files(tmp_path):
    root = make_root(tmp_path)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "small-2d.json").read_text())
    cfg.update(name="dummy-2d", k=5)
    cfg["data"].update(n=3000, generator="uniform")
    (pb / "configs" / "dummy-2d.json").write_text(json.dumps(cfg))
    (pb / "generators" / "uniform.py").write_text(UNIFORM)
    (pb / "ops" / "nearest.py").write_text(NEAREST)
    (pb / "traffic" / "dummy.json").write_text(json.dumps(
        {"batch": 40, "step": [{"op": "nearest"}, {"op": "replace", "rows": 16}]}))
    (pb / "limits" / "dummy.cell.json").write_text((pb / "limits" / "small.b64.json").read_text())
    (pb / "metrics" / "dummy_calls.py").write_text(
        '"""dummy_calls: nearest-neighbour calls in the window."""\n\n\n'
        'def read(run):\n    return float(len(run.times("nearest")))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-2d", "source": "x",
                             "file": "perfbench/configs/dummy-2d.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-2d",
                               "traffic": "dummy", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cell_lib.load_cell(root, "dummy.cell")
    assert cell.config["k"] == 5 and cell.mix["batch"] == 40 and "dummy_calls" in cell.end_to_end
    out = run_small(root, "dummy.cell", seconds=0.3)
    assert out["correct"] and out["metrics"]["dummy_calls"]["value"] >= 1
    assert out["failed"] == 0 and list(out)[-1] == "checks"
    x = cell.traffic(3, "cpu").base()[0]
    assert x.abs().max() <= 1 and x.shape == (3000, 2)
