"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors
over a fake process group, and report memory / cost / roofline terms.
Nothing is allocated on any device: the inputs are fake tensors.

Port of `repro/launch/dryrun.py`.  Where the reference forces 512 host
devices (XLA_FLAGS) and lowers + compiles each cell, the port starts a fake
process group of the production mesh's size (256, or 512 for 2 x 16 x 16)
in a process of its own (a process group is process-global), traces the
cell's step once as rank 0 (`steps.lower_cell`) and counts what runs
(`utils/trace.py`); `roofline.py` turns the counts into the reference's
terms on an H100 model.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k \\
      --smoke --device cpu        # the SMOKE config on 2 x 2 on the CPU, in seconds

The fake tensors lie on the card's device type (`--device cuda`, the
default; nothing touches the card) or on the CPU (`--device cpu`; a
retrieval cell traces on the card's type only, since its search's plain
CPU versions read data on the host).  Up to 8 cells run at once, each in
a process with its own fake group.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys
import time
import traceback

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke, long_context_mode
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_fake_mesh, mesh_chips, production_shape


def probe_costs(cfg, shape: str, mesh, retrieval, device="cuda") -> dict:
    """Per-chip costs by affine depth extrapolation, as the reference's.

    The reference re-lowers the model at depth 1 and 2 periods with every
    chunk loop unrolled, because XLA's cost_analysis counts a while-loop
    body once, and extrapolates total(R) = f1 + (R-1) * (f2 - f1).  An
    eager trace runs every layer and every loop, so it has no undercount to
    correct: the same extrapolation (at `scan_layers=False`, accum 1, one
    attention chunk) must give the full-depth trace's counts wherever those
    settings are the cell's own (on a mesh, DTensor gathers a stacked leaf
    of one layer without the concatenation it needs for more, so the bytes
    of a one-period probe sit slightly under the line).  `mesh` None: one
    device."""
    chips = 1 if mesh is None else mesh_chips(mesh)
    roofs = []
    for k in (1, 2):
        pol = dataclasses.replace(
            cfg.policy, scan_layers=False, accum=1, attn_chunk=1 << 30
        )
        pcfg = dataclasses.replace(
            cfg, n_layers=k * cfg.block_period, policy=pol
        )
        lowered, _ = st.lower_cell(pcfg, shape, mesh, retrieval=retrieval, device=device)
        roofs.append(rl.from_trace(lowered.counts, chips))
    r1, r2 = roofs
    rep = cfg.n_repeat

    def affine(a, b):
        return a + (rep - 1) * (b - a)

    coll_kinds = {
        k: int(affine(r1.coll_by_kind.get(k, 0), r2.coll_by_kind.get(k, 0)))
        for k in set(r1.coll_by_kind) | set(r2.coll_by_kind)
    }
    corrected = rl.Roofline(
        flops=affine(r1.flops, r2.flops),
        hbm_bytes=affine(r1.hbm_bytes, r2.hbm_bytes),
        coll_bytes=affine(r1.coll_bytes, r2.coll_bytes),
        coll_by_kind=coll_kinds,
        chips=chips,
        fused_hbm_bytes=affine(r1.fused_hbm_bytes, r2.fused_hbm_bytes),
    ).finalize()
    return corrected.as_dict()


def cell_plan(arch: str, shape: str) -> str:
    """'run' | 'skip' | 'retrieval' for this (arch, shape) cell."""
    if shape != "long_500k":
        return "run"
    mode = long_context_mode(arch)
    if mode == "native":
        return "run"
    if mode == "retrieval":
        return "retrieval"   # beyond-paper: active-search retrieval memory
    return "skip"


def run_cell(
    arch: str,
    shape: str,
    multi_pod: bool,
    step_cfg: st.StepConfig = st.StepConfig(),
    verbose: bool = True,
    device="cuda",
    smoke: bool = False,
) -> dict:
    """One cell's record (the reference's keys).  `lower_s` is the trace's
    host seconds; `compile_s` is 0 (eager PyTorch compiles nothing).  The
    mesh is a fake process group of the production mesh's size, started
    here in this process (`make_fake_mesh`).  `smoke` traces the arch's
    SMOKE config on a 2 x 2 (2 x 2 x 2) mesh instead, whose widths are cut
    for a few devices, not for 16 along the model axis."""
    plan = cell_plan(arch, shape)
    mesh_shape = production_shape(multi_pod)
    if smoke:
        mesh_shape = dict.fromkeys(mesh_shape, 2)
    mesh_name = "x".join(str(v) for v in mesh_shape.values())
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "plan": plan}
    if plan == "skip":
        rec["status"] = "SKIP (pure full attention; DESIGN.md §5)"
        return rec

    cfg = get_smoke(arch) if smoke else get_config(arch)
    mesh = make_fake_mesh(mesh_shape, device)
    chips = mesh_chips(mesh)
    retrieval = (64, 512) if plan == "retrieval" else None

    t0 = time.time()
    lowered, kind = st.lower_cell(
        cfg, shape, mesh, step_cfg=step_cfg, retrieval=retrieval, device=device
    )
    t1 = time.time()

    roof = rl.from_trace(lowered.counts, chips)
    mem = rl.memory_analysis_dict(lowered.counts)
    mf = rl.model_flops(cfg, SHAPES[shape], kind)

    # the probes (single-pod roofline table only; two more traces at depth
    # 1 and 2 periods)
    corrected = None
    if not multi_pod:
        t3 = time.time()
        corrected = probe_costs(cfg, shape, mesh, retrieval, device)
        rec["probe_s"] = round(time.time() - t3, 2)

    rec.update(
        status="OK",
        kind=kind,
        lower_s=round(t1 - t0, 2),
        compile_s=0.0,
        roofline_raw=roof.as_dict(),
        roofline=corrected or roof.as_dict(),
        memory=mem,
        model_flops_total=mf,
        retrieval=plan == "retrieval",
        loop_trips=lowered.loop_trips,
        calls={k: v for k, v in lowered.counts.calls.items() if k.startswith("repro_torch.")},
    )
    use = rec["roofline"]
    rec["model_flops_ratio"] = (
        mf / (use["flops_per_chip"] * chips) if use["flops_per_chip"] else None
    )
    if verbose:
        print(
            f"[{mesh_name}] {arch:18s} {shape:12s} {kind:7s} OK  "
            f"trace {t1-t0:6.1f}s  "
            f"C/M/X = {use['compute_s']*1e3:.1f}/{use['memory_s']*1e3:.1f}/"
            f"{use['collective_s']*1e3:.1f} ms  "
            f"bottleneck={use['bottleneck']}  "
            f"6ND/HLO={rec['model_flops_ratio'] if rec['model_flops_ratio'] is None else round(rec['model_flops_ratio'], 3)}  "
            f"mem: {mem['temp_size_in_bytes']/2**30:.2f} GiB temp",
            flush=True,
        )
    return rec


def _cell_record(arch, shape, multi_pod, accum, device, smoke) -> tuple[dict, bool]:
    """run_cell in a worker; a failure becomes a FAIL record."""
    import logging

    logging.disable(logging.WARNING)   # DTensor's notes on mesh-dim redistributions
    try:
        return run_cell(arch, shape, multi_pod, st.StepConfig(accum=accum), device=device,
                        smoke=smoke), False
    except Exception as e:  # a failing cell is a bug in the system
        print(f"FAIL {arch} {shape} multi_pod={multi_pod}", flush=True)
        traceback.print_exc()
        return {
            "arch": arch, "shape": shape,
            "mesh": ("2x2x2" if multi_pod else "2x2") if smoke else
                    ("2x16x16" if multi_pod else "16x16"),
            "status": f"FAIL: {type(e).__name__}: {e}",
        }, True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake tensors' device type (nothing is allocated)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's SMOKE config, on a 2 x 2 (2 x 2 x 2) mesh")
    args = ap.parse_args()

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    jobs = [(arch, shape, multi_pod) for arch, shape in cells for multi_pod in meshes]

    t0 = time.time()
    records, failures = [], 0
    # a fresh process per cell: each starts its own fake group (process-global);
    # the longest traces (train, then prefill) start first, records are
    # written as cells finish
    order = {"train_4k": 0, "prefill_32k": 1}
    jobs.sort(key=lambda job: order.get(job[1], 2))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(min(8, os.cpu_count() or 1), mp_context=ctx,
                                                max_tasks_per_child=1) as pool:
        futures = [pool.submit(_cell_record, arch, shape, multi_pod, args.accum, args.device,
                               args.smoke) for arch, shape, multi_pod in jobs]
        for fut in concurrent.futures.as_completed(futures):
            rec, failed = fut.result()
            failures += failed
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    ok = sum(1 for r in records if r.get("status") == "OK")
    skip = sum(1 for r in records if str(r.get("status", "")).startswith("SKIP"))
    print(f"\ndry-run: {ok} OK, {skip} SKIP, {failures} FAIL / {len(records)} cells "
          f"in {time.time() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
