"""End-to-end training loop: data pipeline -> train step ->
checkpoint/restart -> fault tolerance, on one device or a (data, model)
mesh of ranks.

Port of `repro/launch/train.py`, with its flags and defaults, plus
`--device` (default "cuda", with no fallback to the CPU) and `--backend`:

  python -m repro_torch.launch.train --arch internlm2-1.8b --steps 20 --ckpt-dir build/ckpt
  python -m repro_torch.launch.train --device cpu --smoke --steps 20   # no card
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --data 2 --model 2 --steps 20

A mesh of `--data` x `--model` ranks needs that many processes, one per
device, started by `torchrun` (which sets RANK / WORLD_SIZE / MASTER_ADDR
/ MASTER_PORT; the process group is started here, `nccl` on the card and
`gloo` on the CPU unless `--backend` says otherwise), or by a caller that
started the process group itself.  A world size that differs from data x
model exits with the reference's "need n devices".  Every rank reads the
same global batches, rank 0 logs and writes the checkpoints.

Fault-tolerance drills (exercised in tests):
  * SIGTERM mid-run -> checkpoint + clean exit; rerun resumes at that step.
  * --fail-at k injects a fault at step k (once); the supervisor restarts
    from the last checkpoint (node-failure recovery).
The checkpoints are the reference's format and keys, so a run resumes
from a checkpoint the reference's train loop wrote, and the reverse.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.core.grid import resolve_device
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.launch import ft
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 256
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    compress_grads: bool = False
    accum: int = 1
    fail_at: int = -1          # inject a fault at this step (tests)
    lr: float = 3e-4


def train_loop(cfg, tc: TrainConfig, device=None, log=print, mesh=None) -> dict:
    """One supervised run on `device` (None = the card), or on `mesh` (a
    `launch.mesh.Mesh`; every rank calls this together and the state's
    leaves are DTensors); resumes from the newest checkpoint in
    `tc.ckpt_dir` if there is one (onto the mesh, whatever wrote it).
    Returns the final state, this run's losses and step seconds, the final
    step and the straggler steps."""
    dev = resolve_device(device) if mesh is None else mesh.device
    opt_cfg = adamw.AdamWConfig(lr=tc.lr, total_steps=tc.steps,
                                warmup_steps=max(tc.steps // 20, 1))
    step_cfg = st.StepConfig(accum=tc.accum, compress_grads=tc.compress_grads)
    step_fn = st.make_train_step(cfg, opt_cfg, step_cfg, mesh=mesh)

    mgr = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        like = st.train_state_shapes(cfg, opt_cfg, step_cfg)
        where = None if mesh is None else st.train_state_shardings(like, cfg, mesh)
        state = mgr.restore(start, like, device=dev, placements=where)
        log(f"[train] resumed from checkpoint step {start}")
    else:
        state = st.init_train_state(torch.Generator(device=dev).manual_seed(tc.seed), cfg,
                                    opt_cfg, step_cfg, dev, mesh=mesh)

    dc = DataConfig(global_batch=tc.batch, seq_len=tc.seq, vocab_size=cfg.vocab_size,
                    seed=tc.seed)
    pf = Prefetcher(dc, model_cfg=cfg, start_step=start)
    timer = ft.StepTimer()
    losses: list[float] = []
    seconds: list[float] = []

    try:
        with ft.PreemptionGuard() as guard:
            for step, host_batch in pf:
                if step >= tc.steps:
                    break
                if step == tc.fail_at:
                    raise RuntimeError(f"injected fault at step {step}")
                batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
                t0 = time.time()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                stats = timer.record(step, time.time() - t0)
                losses.append(loss)
                seconds.append(stats.seconds)
                if step % tc.log_every == 0:
                    log(
                        f"[train] step {step:5d} loss {loss:8.4f} "
                        f"gnorm {float(metrics['grad_norm']):7.3f} "
                        f"lr {float(metrics['lr']):.2e} "
                        f"{stats.seconds*1e3:7.1f} ms"
                        + ("  STRAGGLER" if stats.is_straggler else "")
                    )
                next_step = step + 1
                if mgr is not None and (next_step % tc.ckpt_every == 0 or guard.draining):
                    mgr.save(next_step, state)
                if guard.draining:
                    log(f"[train] preempted: drained at step {next_step}")
                    break
    finally:
        pf.close()
        if mgr is not None:
            mgr.wait()

    return {"state": state, "losses": losses, "seconds": seconds,
            "final_step": int(state["step"]), "stragglers": timer.straggler_steps}


def run(cfg, tc: TrainConfig, device=None, max_restarts: int = 3, log=print,
        mesh=None) -> dict:
    """Supervised training with restart-from-checkpoint on failure; the
    injected fault fires once (on every rank of a mesh alike)."""
    out: dict = {}

    def attempt():
        nonlocal out
        out = train_loop(cfg, tc, device=device, log=log, mesh=mesh)
        return out["final_step"]

    ft.run_with_restarts(
        attempt,
        max_restarts=max_restarts,
        on_restart=lambda k, e: (
            log(f"[train] restart {k} after: {type(e).__name__}: {e}"),
            setattr(tc, "fail_at", -1),
        ),
    )
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="mesh data-axis size (1: one device)")
    ap.add_argument("--model", type=int, default=1, help="mesh model-axis size (1: one device)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override smoke d_model (scale to ~100M params)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'; no fallback")
    ap.add_argument("--backend", default=None,
                    help="the process group's backend on a mesh: nccl (the card's "
                         "default, one rank per card), gloo (the CPU's default; also "
                         "several ranks sharing a card)")
    args = ap.parse_args(argv)
    n = args.data * args.model
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != n:
        ap.error(f"need {n} devices for mesh ({args.data}, {args.model}), have {world} "
                 f"ranks (start one per device: torchrun --nproc-per-node {n})")

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(
            cfg,
            d_model=args.d_model,
            head_dim=args.d_model // cfg.n_heads,
            d_ff=(4 * args.d_model if cfg.d_ff else 0),
        )
    if args.layers:
        per = cfg.block_period
        cfg = dataclasses.replace(cfg, n_layers=max(per, args.layers // per * per))

    tc = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        compress_grads=args.compress, accum=args.accum, fail_at=args.fail_at,
    )
    if n == 1:
        out = run(cfg, tc, device=args.device)
    else:
        out = _run_on_mesh(cfg, tc, args)
        if out is None:             # not rank 0
            return
    print(
        f"[train] done: {out['final_step']} steps, "
        f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}"
    )


def _run_on_mesh(cfg, tc: TrainConfig, args) -> dict | None:
    """`run` on a (data, model) mesh of this process group's ranks,
    starting the group (from torchrun's environment) when the caller has
    not; this rank's card is LOCAL_RANK's (modulo the cards present).
    Rank 0's result; None on the other ranks."""
    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group(args.backend or ("nccl" if dev.type == "cuda" else "gloo"))
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                              % torch.cuda.device_count())
    try:
        mesh = make_host_mesh(args.data, args.model, device=dev.type)
        first = dist.get_rank() == 0
        out = run(cfg, tc, log=print if first else (lambda *_: None), mesh=mesh)
        return out if first else None
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
