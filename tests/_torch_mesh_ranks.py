"""Rank programs of tests/test_torch_mesh.py: each runs in one of several
processes (one rank each) over a `gloo` process group on the CPU, started
by `spawn` with a FileStore under the test's directory.  This module
imports only the port (the processes never load JAX)."""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.core import distributed as D
from repro_torch.core import retrieval_memory as rmem
from repro_torch.core.grid import GridConfig
from repro_torch.core.projection import identity_projection
from repro_torch.launch import steps as st
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.compression import compressed_psum
from repro_torch.parallel import sharding as sh
from repro_torch.utils import tree

TIER_CFG = dict(grid_size=128, tile=16, n_classes=3, window=48, row_cap=48, r0=6, k_slack=2.0)
OPT = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
# float32 end to end (no bf16 compute copy), as tests/test_torch_steps.py's float32 case
STEP_CFG = {"internlm2-1.8b": st.StepConfig(accum=2, bf16_compute_copy=False),
            "qwen2-moe-a2.7b": st.StepConfig(bf16_compute_copy=False)}
TRAIN_STEPS = {"internlm2-1.8b": 3, "qwen2-moe-a2.7b": 1}
MEMORY_GRID = dict(grid_size=64, tile=8, window=16, row_cap=16, r0=4, k_slack=4.0, max_iters=12)


def _entry(fn, rank: int, world: int, workdir: str, args: tuple) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        fn(rank, workdir, *args)
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, workdir: str, *args, timeout: float = 300.0) -> None:
    """fn(rank, workdir, *args) on `world` ranks; fails (killing every
    rank) when one fails or the ranks outlast `timeout` seconds."""
    import multiprocessing as mp
    import time

    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, workdir, args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [open(os.path.join(workdir, n)).read() for n in sorted(os.listdir(workdir))
              if n.startswith("error_")]
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, (codes, "".join(errors) or "timed out")


def _flat(state) -> dict:
    return {"/".join(map(str, p)): sh.gather(leaf).detach().cpu().numpy()
            for p, leaf in tree.leaves_with_path(state)}


def _save(workdir: str, name: str, arrays: dict) -> None:
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, name), **arrays)


# ------------------------------------------------------- the sharded tier ---


def tier(rank: int, workdir: str) -> None:
    """The facade on a 4-rank ("data",) mesh: build, search, insert,
    search, delete, search; every rank saves what it returns.  Then
    `compressed_psum` over the four ranks."""
    inp = np.load(os.path.join(workdir, "..", "inputs.npz"))
    mesh = make_mesh({"data": dist.get_world_size()}, device="cpu")
    pts = torch.from_numpy(inp["points"])
    s = api.ActiveSearcher.build_sharded(inp["points"], mesh=mesh, axis="data",
                                         labels=inp["labels"], cfg=GridConfig(**TIER_CFG),
                                         proj=identity_projection(pts))
    q = D.replicate_queries(inp["queries"] if rank == 0 else np.zeros_like(inp["queries"]), mesh)
    out = {}
    for tag in ("build", "insert", "delete"):
        if tag == "insert":
            s = s.insert(inp["new_points"], labels=inp["new_labels"])
        elif tag == "delete":
            s = s.delete(inp["dead_ids"])
        res = s.search(q, 8)
        out.update({f"{tag}/{f}": getattr(res, f).numpy() for f in res._fields})
        out[f"{tag}/n_points"] = np.asarray(s.stats()["n_points"])
    np.savez(os.path.join(workdir, f"tier_{rank}.npz"), **out)
    mean, err = compressed_psum(torch.from_numpy(inp["psum_g"][rank]),
                                torch.from_numpy(inp["psum_err"][rank]))
    np.savez(os.path.join(workdir, f"psum_{rank}.npz"), mean=mean.numpy(), err=err.numpy())


# ----------------------------------------------------------- train steps ---


def _like(arch: str) -> dict:
    return st.train_state_shapes(get_smoke(arch), OPT, STEP_CFG[arch])


def train(rank: int, workdir: str, trajectories: str) -> None:
    """From each state of the reference's trajectory (its checkpoints,
    restored onto the 2 x 2 mesh), one port step on the mesh; saves each
    result whole.  Then the elastic restore: the mesh state written as a
    checkpoint and restored onto a 4 x 1 mesh, bit-equal."""
    L.ACT_DTYPE = torch.float32
    mesh = make_host_mesh(2, 2, device="cpu")
    for arch, n in TRAIN_STEPS.items():
        cfg = get_smoke(arch)
        mgr = CheckpointManager(os.path.join(trajectories, arch), keep=10)
        batches = np.load(os.path.join(trajectories, f"{arch}_batches.npz"))
        like = _like(arch)
        step = st.make_train_step(cfg, OPT, STEP_CFG[arch], mesh=mesh)
        for i in range(n):
            state = mgr.restore(i, like, placements=st.train_state_shardings(like, cfg, mesh))
            batch = {k.split("/")[1]: torch.from_numpy(v) for k, v in batches.items()
                     if k.startswith(f"{i}/")}
            state, metrics = step(state, batch)
            _save(workdir, f"{arch}_{i}.npz", {**_flat(state),
                                               **{f"metric/{k}": v.numpy()
                                                  for k, v in metrics.items()}})
    # elastic: the last internlm2 state on 2 x 2 -> a checkpoint -> 4 x 1
    cfg = get_smoke("internlm2-1.8b")
    like = _like("internlm2-1.8b")
    state = CheckpointManager(os.path.join(trajectories, "internlm2-1.8b"), keep=10).restore(
        3, like, placements=st.train_state_shardings(like, cfg, mesh))
    ckpt = CheckpointManager(os.path.join(workdir, "mesh_ckpt"))
    ckpt.save(7, state)
    whole = _flat(state)
    mesh41 = make_host_mesh(4, 1, device="cpu")
    back = ckpt.restore(7, like, placements=st.train_state_shardings(like, cfg, mesh41))
    specs = dict(tree.leaves_with_path(st.train_state_specs(like, cfg, mesh41)))
    for path, leaf in tree.leaves_with_path(back):
        key = "/".join(map(str, path))
        want = torch.from_numpy(whole[key])
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        part = sh.local_part(want, mesh41, specs[path]) if want.dim() else want
        assert torch.equal(local, part), key
        assert np.array_equal(sh.gather(leaf).numpy(), whole[key]), key
    _save(workdir, "elastic_4x1.npz", _flat(back))


def one_by_one(rank: int, workdir: str, ckpt_dir: str) -> None:
    """The 2 x 2 mesh's checkpoint restored onto a 1 x 1 mesh (one rank)."""
    cfg = get_smoke("internlm2-1.8b")
    mesh = make_host_mesh(1, 1, device="cpu")
    like = _like("internlm2-1.8b")
    state = CheckpointManager(ckpt_dir).restore(
        7, like, placements=st.train_state_shardings(like, cfg, mesh))
    _save(workdir, "elastic_1x1.npz", _flat(state))


# ----------------------------------------------------------- serve steps ---


def serve(rank: int, workdir: str) -> None:
    """The prefill, serve and retrieval serve steps on 2 x 2 against the
    same steps on one device (each rank runs both), float32."""
    L.ACT_DTYPE = torch.float32
    arch = "internlm2-1.8b"
    cfg = get_smoke(arch)
    mesh = make_host_mesh(2, 2, device="cpu")
    params = M.init_params(cfg, "cpu", torch.Generator().manual_seed(2))
    one = M.model_from_params(cfg, params)
    on_mesh = M.model_from_params(cfg, sh.distribute_tree(
        params, sh.param_specs(params, cfg, mesh), mesh))
    g = torch.Generator().manual_seed(3)
    out = {}
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (4, 12), generator=g)}
    for tag, res in (("one", st.make_prefill_step(cfg)(one, prompt)),
                     ("mesh", st.make_prefill_step(cfg, mesh=mesh)(on_mesh, prompt))):
        logits, caches, hidden = res
        out[f"prefill/{tag}/logits"], out[f"prefill/{tag}/hidden"] = (
            sh.gather(logits).numpy(), sh.gather(hidden).numpy())
        out[f"prefill/{tag}/k"] = sh.gather(caches[0]["k"]).numpy()
    t_len = 64
    caches = M.init_caches(cfg, 4, t_len, "cpu")
    caches = [{k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in c.items()}
              for c in caches]
    clone = lambda cs: [{k: v.clone() for k, v in c.items()} for c in cs]  # noqa: E731
    keys = torch.randn((t_len, cfg.head_dim), generator=g)
    mem = rmem.RetrievalMemoryConfig(n_retrieved=8, local_window=4,
                                     grid=GridConfig(**MEMORY_GRID))
    index = rmem.build_memory_index(keys, mem, rmem.make_projection(g, cfg.head_dim))
    tokens = torch.randint(0, cfg.vocab_size, (3, 4), generator=g)
    for tag, model, m in (("one", one, None), ("mesh", on_mesh, mesh)):
        for name, fn, args in (
                ("serve", st.make_serve_step(cfg, mesh=m), ()),
                ("retrieval", st.make_retrieval_serve_step(cfg, mem, mesh=m), (index,))):
            cs = clone(caches)
            for i in range(3):
                pos = 40 + i
                logits, cs, hidden = fn(model, cs, *args, tokens[i], pos)
                out[f"{name}/{tag}/{i}/logits"] = sh.gather(logits).numpy()
                out[f"{name}/{tag}/{i}/hidden"] = sh.gather(hidden).numpy()
                if name == "retrieval":
                    with st.on_mesh(m, cfg, 4):
                        positions, ok = st.retrieve(model, index, tokens[i], pos, mem)
                    out[f"{name}/{tag}/{i}/positions"] = sh.gather(positions).numpy()
                    out[f"{name}/{tag}/{i}/ok"] = sh.gather(ok).numpy()
            out[f"{name}/{tag}/k"] = sh.gather(cs[0]["k"]).numpy()
    _save(workdir, "serve.npz", out)


def moe(rank: int, workdir: str) -> None:
    """qwen2-moe's moe_block on 2 x 2 against one device, float32, forward
    and backward, at two shapes: each rank's batch rows holding whole
    GShard groups (run on its rows) and a group spanning the batch shards
    (run whole on every rank; `replicated` counts those calls)."""
    from repro_torch.models import moe as MO
    from repro_torch.parallel import axes

    L.ACT_DTYPE = torch.float32
    cfg = get_smoke("qwen2-moe-a2.7b")
    mesh = make_host_mesh(2, 2, device="cpu")
    g = torch.Generator().manual_seed(4)
    params = MO.init_moe(g, cfg)
    specs = sh.param_specs({"ffn": params}, cfg, mesh)["ffn"]
    rows = sh.P("data", None, None)
    calls = []
    whole = axes.replicated_local
    axes.replicated_local = lambda *a: calls.append(1) or whole(*a)
    out = {}
    for tag, shape in (("whole_groups", (4, 32)), ("groups_across_shards", (4, 16))):
        x = torch.randn((*shape, cfg.d_model), generator=g)
        probe = torch.randn((*shape, cfg.d_model), generator=g)
        for where, m in (("one", None), ("mesh", mesh)):
            place = (lambda t, spec: t) if m is None else (
                lambda t, spec: sh.distribute(t, m, spec))
            w = tree.map(lambda t, spec: place(t, spec).detach().requires_grad_(), params, specs)
            h = place(x, rows).detach().requires_grad_()
            del calls[:]
            with st.on_mesh(m, cfg, shape[0]):
                y, aux = MO.moe_block(w, cfg, h)
                sh.gather((y * place(probe, rows)).sum() + aux).backward()
            out[f"{tag}/{where}/replicated"] = np.asarray(len(calls))
            out[f"{tag}/{where}/y"] = sh.gather(y).detach().numpy()
            out[f"{tag}/{where}/aux"] = sh.gather(aux).detach().numpy()
            out[f"{tag}/{where}/dx"] = sh.gather(h.grad).numpy()
            for p, t in tree.leaves_with_path(w):
                out[f"{tag}/{where}/d/" + "/".join(map(str, p))] = sh.gather(t.grad).numpy()
    axes.replicated_local = whole
    _save(workdir, "moe.npz", out)


# ------------------------------------------------------------ train CLI ----


def cli(rank: int, workdir: str) -> None:
    """train.main on a 2 x 2 mesh in this process group."""
    TT.main(["--device", "cpu", "--smoke", "--steps", "2", "--seq", "16", "--batch", "4",
             "--data", "2", "--model", "2", "--ckpt-dir", os.path.join(workdir, "ckpt"),
             "--ckpt-every", "1"])
