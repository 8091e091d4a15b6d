"""Nothing a run imports is JAX's or the JAX package's, by whole top-level
name (the port's name begins with the JAX package's), and the reference
imports nothing of the program."""

import subprocess
import sys
import types

from small_bench import REPO
from perfbench.harness import runner


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reproduce", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert not set(runner.forbidden_modules()) & {"repro_torch", "reproduce", "jaxtyping"}
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert {"repro", "jax"} <= set(runner.forbidden_modules())


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in "
         "sys.modules}))"], cwd=REPO, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{REPO}:{REPO / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program_or_jax():
    names = _top_level_after("import perfbench.reference.compare, perfbench.reference.exact, "
                             "perfbench.reference.index, perfbench.reference.search")
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_imports_nothing_of_jax(bench_root):
    names = _top_level_after(
        "import sys\nsys.path.insert(0, 'perfbench/tests')\nfrom small_bench import run_small\n"
        f"from pathlib import Path\nrun_small(Path({str(bench_root)!r}), 'small.churn', "
        "seconds=0.3)")
    assert "repro_torch" in names and not names & {"repro", "jax", "jaxlib", "flax"}
