"""A small copy of the benchmark for the CPU tests.

`make_root` copies `perfbench/` into a temporary checkout root and writes a
BENCHMARK.json whose cells run the same harness on the CPU at a size a test
holds: the two configurations cut to thousands of points, the mixes to 64
queries.  The program runs through its plain versions on the CPU.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]



# each small cell stands for the benchmark's cells of the same kind
STANDS_FOR = {"rand100.b10k": "small.b64", "rand100.k100.b10k": "small.b64",
              "paper2d.map64k": "small2d.map", "paper2d.churn": "small.churn"}


def make_root(dst: Path) -> Path:
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = dst / "perfbench"
    blobs = json.loads((pb / "configs" / "random-s-100.json").read_text())
    blobs["data"].update(n=3000, d=16, queries=64)
    blobs["data"]["params"]["centers"] = 30
    blobs["grid"].update(grid_size=64, window=16, row_cap=16, r0=2)
    blobs["plan"]["chunk_size"] = 32
    paper = json.loads((pb / "configs" / "paper-2d.json").read_text())
    paper["data"].update(n=4000, queries=64)
    paper["grid"].update(grid_size=100, window=16, row_cap=16, r0=4)
    (pb / "configs" / "small-l2.json").write_text(json.dumps(blobs))
    (pb / "configs" / "small-2d.json").write_text(json.dumps(paper))
    (pb / "traffic" / "s64.json").write_text(json.dumps({"batch": 64}))
    (pb / "traffic" / "smap.json").write_text(json.dumps(
        {"batch": 64, "step": [{"op": "pixels"}]}))
    (pb / "traffic" / "schurn.json").write_text(json.dumps(
        {"batch": 64, "step": [{"op": "search"}, {"op": "replace", "rows": 32}],
         "checked_calls": 3, "max_steps_per_s": 200}))
    bench["configs"] = [
        {"name": "small-l2", "source": "x", "file": "perfbench/configs/small-l2.json",
         "reduced": [], "why": "x"},
        {"name": "small-2d", "source": "x", "file": "perfbench/configs/small-2d.json",
         "reduced": [], "why": "x"}]
    bench["workloads"] = [
        {"name": "small.b64", "config": "small-l2", "traffic": "s64", "chips": 1, "why": "x"},
        {"name": "small.churn", "config": "small-2d", "traffic": "schurn", "chips": 1, "why": "x"},
        {"name": "small2d.b64", "config": "small-2d", "traffic": "s64", "chips": 1, "why": "x"},
        {"name": "small2d.map", "config": "small-2d", "traffic": "smap", "chips": 1, "why": "x"}]
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"] = sorted({STANDS_FOR[w] for w in metric["workloads"]})
    # the small cells hold to the limits of the cells they stand for
    for real, small in STANDS_FOR.items():
        (pb / "limits" / f"{small}.json").write_text((pb / "limits" / f"{real}.json").read_text())
    (pb / "limits" / "small2d.b64.json").write_text(
        (pb / "limits" / "paper2d.churn.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def run_small(root: Path, name: str, seed: int = 2**31 + 7, seconds: float = 0.5,
              trace: bool = False) -> dict:
    from perfbench.harness import cell as cell_lib
    from perfbench.harness import runner

    return runner.run_cell(cell_lib.load_cell(root, name), seed, seconds, trace, root,
                           device="cpu")


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels run only there")
    return torch.device("cuda")
