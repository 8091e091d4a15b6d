"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points refuse to fall back to the CPU without being asked."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the suite imports both packages; the port must not)
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.convert import index_from_numpy, mutable_from_numpy, projection_from_numpy
from repro_torch.core import mutable

ROOT = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_port_imports_neither_jax_nor_reference():
    mods = ["repro_torch", "repro_torch.api", *_port_modules()]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 57 and "repro_torch.core.mutable" in mods
    assert {"repro_torch.core.distributed", "repro_torch.core.knn_lm",
            "repro_torch.core.retrieval_memory", "repro_torch.checkpoint.store",
            "repro_torch.launch.serve", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.model", "repro_torch.models.moe",
            "repro_torch.models.mamba", "repro_torch.models.xlstm",
            "repro_torch.configs.shapes",
            "repro_torch.configs.minitron_8b", "repro_torch.configs.xlstm_125m",
            "repro_torch.utils.scan", "repro_torch.launch.mesh", "repro_torch.parallel.sharding",
            "repro_torch.parallel.axes", "repro_torch.launch.steps",
            "repro_torch.optim.compression"} <= set(mods)


def test_chip_smoke_imports_neither_jax_nor_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "repro" not in roots, sorted(names)
    assert "repro_torch" in roots


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    pts = np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ActiveSearcher.build(pts)
    built = api.ActiveSearcher.build(pts, cfg=api.GridConfig(grid_size=32, tile=8, r0=4),
                                     device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ActiveSearcher.from_index(built.index, built.cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        projection_from_numpy(np.eye(2), np.zeros(2), np.ones(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_from_numpy({}, built.cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mutable_from_numpy({}, built.cfg)
    tree = {k: v.numpy() for k, v in mutable.state_to_tree(
        mutable.from_index(built.index, built.cfg)).items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mutable.state_from_tree(tree)
    # a handle's insert stays on the handle's device: the CPU only when the
    # handle was built there on request
    grown = built.insert(pts[:5] + 0.01)
    assert {t.device.type for t in mutable.state_to_tree(grown.mutable).values()} == {"cpu"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ActiveSearcher.build(pts).insert(pts[:5])


def test_mesh_defaults_to_the_card(tmp_path):
    """A mesh needs a started process group of its size, and its device
    defaults to the card: without one it raises rather than settling on
    the CPU."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2, 2)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh(1, 1)
        with pytest.raises(RuntimeError, match="need 4 devices for mesh"):
            make_host_mesh(2, 2, device="cpu")
        mesh = make_host_mesh(1, 1, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.device.type == "cpu"
    finally:
        dist.destroy_process_group()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs a plain version: CPU tensors raise."""
    from repro_torch.kernels import csr_candidate_topk as csr
    from repro_torch.kernels import tile_count_multilevel as tcm

    with pytest.raises(ValueError, match="CUDA"):
        tcm.tile_count_multilevel(torch.zeros((1, 4, 4, 1), dtype=torch.int32),
                                  torch.zeros((1, 2)), torch.ones(1),
                                  torch.zeros(1, dtype=torch.int32), 4, (1,))
    with pytest.raises(ValueError, match="CUDA"):
        csr.csr_candidate_topk(torch.zeros((4, 2)), torch.zeros((1, 1), dtype=torch.int32),
                               torch.ones((1, 1), dtype=torch.int32), torch.zeros((1, 2)),
                               2, 4, 4)
    assert tcm.launches == 0 and csr.launches == 0


@pytest.mark.parametrize("name", ["tile_count", "candidate_topk", "csr_candidate_topk_q8",
                                  "radius_search_loop"])
def test_slice2_kernel_wrappers_refuse_cpu_tensors(name):
    """The wrappers of tile_count, candidate_topk, csr_shortlist_q8 and
    radius_search_loop raise on CPU tensors and count no launch."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    i32 = dict(dtype=torch.int32)
    calls = {
        "tile_count": lambda: mod.tile_count(torch.zeros((4, 4, 1), **i32), torch.zeros((1, 2)),
                                             torch.ones(1), 1, 4),
        "candidate_topk": lambda: mod.candidate_topk(torch.zeros((1, 3, 2)),
                                                     torch.ones((1, 3), dtype=torch.bool),
                                                     torch.zeros((1, 2)), 2),
        "csr_candidate_topk_q8": lambda: mod.csr_shortlist_q8(
            torch.zeros((4, 2), dtype=torch.int8), torch.ones((4, 1)),
            torch.zeros((1, 1), **i32), torch.ones((1, 1), **i32), torch.zeros((1, 2)), 2, 4, 4),
        "radius_search_loop": lambda: mod.radius_search_loop(
            torch.zeros((1, 4, 4, 1), **i32), torch.zeros((1, 2)), torch.ones(1, **i32),
            2, 2, 4, 16, 4, (1,)),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[name]()
    assert mod.launches == 0
