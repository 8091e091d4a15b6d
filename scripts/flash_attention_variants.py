#!/usr/bin/env python3
"""Build flash_attention.cu with other variant entries and time them on the card.

    python3 scripts/flash_attention_variants.py \\
        --try 512=8,2,8,FA_Q_RAW,1,16,false,true --try 512=8,4,16,FA_Q_RAW,4,16,false,true \\
        --shape 4096,4,512 [--shape S,H,HD ...] [--parent OLD.cu] [--sass 16,32,64]

Run from the root of a checkout on a machine with one card and the CUDA
toolkit.  Each --try HDP=ENTRY builds src/repro_torch/csrc/flash_attention.cu
with fa_variant's entry for that padded head dim replaced by ENTRY (the
fields of FaVariant, in order: warps, slices, key_tile, q_mode, pv_group,
kk_unroll, rolled_copies, wide), through the macros FA_TRY_HDP and
FA_TRY_VARIANT;
"base" is the source as it stands, and --parent another copy of the source
(for instance `git show HEAD:src/repro_torch/csrc/flash_attention.cu`).
Every build is one nvcc with the port's flags, all started together, into
build/flash_attention_variants/.  Then, per build, ptxas's registers and
spills of each instance; per --sass head dim, whether each build's SASS
of that instance is identical to the parent's (addresses stripped; the
base's diff, if any, goes to chiprun_out/flash_attention_variants/); and per
--shape (batch 1, float32, causal), every build held against the plain
version within 2e-5 and timed in turns (builds in order, then reversed; L2
flushed before each timed call; median of --reps), with SDPA's
memory-efficient backend beside.  One JSON line per result, then the
card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_by_entry  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_attention_variants"
DIFFS = ROOT / "chiprun_out" / "flash_attention_variants"  # base-vs-parent SASS diffs


def build_all(builds: dict) -> dict:
    """name -> (source, macro lines); one nvcc each, all at once, the macros
    in a pre-included header (nvcc splits a -D value at its commas); name ->
    ptxas log."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, defs) in builds.items():
        header = OUT / f"{name}.h"
        header.write_text("".join(f"#define {d}\n" for d in defs))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
               "--pre-include", str(header), "-o", str(OUT / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
    return logs


def sass(name: str, hdp: int) -> list | None:
    """The SASS of flash_attention_kernel<hdp> in a build, addresses stripped."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(OUT / f"{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", text):
        if func.startswith(f"_Z22flash_attention_kernelILi{hdp}E"):
            lines = (re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split(";")[0].strip()
                     for ln in func.splitlines()[1:])
            return [ln for ln in lines if ln]
    return None


def launcher(name: str):
    fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--try", dest="tries", action="append", default=[],
                        metavar="HDP=ENTRY")
    parser.add_argument("--shape", action="append", default=[], metavar="S,H,HD")
    parser.add_argument("--parent", type=Path)
    parser.add_argument("--sass", default="", metavar="HDP,...")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_variants: no CUDA device", file=sys.stderr)
        return 2

    builds = {"base": (SOURCE, [])}
    if args.parent:
        builds["parent"] = (args.parent.resolve(), [])
    for i, entry in enumerate(args.tries):
        hdp, fields = entry.split("=", 1)
        builds[f"try{i}"] = (SOURCE, [f"FA_TRY_HDP {hdp}", f"FA_TRY_VARIANT {fields}"])
    logs = build_all(builds)
    for name, log in logs.items():
        regs = {}
        for ent, info in ptxas_by_entry(log).items():
            if m := re.search(r"flash_attention_kernelILi(\d+)E", ent):
                regs[f"HDP={m[1]}"] = info
        print(json.dumps({"build": name, "defines": builds[name][1], "ptxas": regs}), flush=True)
    for hdp in (int(x) for x in args.sass.split(",") if x):
        want = sass("parent", hdp)
        same = {}
        for name in builds:
            got = sass(name, hdp)
            same[name] = want is not None and got == want
            if name == "base" and not same[name] and want and got:
                DIFFS.mkdir(parents=True, exist_ok=True)
                (DIFFS / f"sass_hdp{hdp}.diff").write_text("\n".join(difflib.unified_diff(
                    want, got, "parent", "base", lineterm="")))
        print(json.dumps({"sass_hdp": hdp, "identical_to_parent": same}), flush=True)

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev = torch.device("cuda")
    fns = {name: launcher(name) for name in builds}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, q, k, v):
        out = torch.empty_like(q)
        grids = ctypes.c_int(0)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
                 q.shape[1], k.shape[1], q.shape[2], q.shape[3], 1, 1.0 / q.shape[3] ** 0.5,
                 65_535, ctypes.byref(grids), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    def time_ms(f) -> float:
        f()
        torch.cuda.synchronize()
        events = []
        for _ in range(args.reps):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in events]))

    for shape in args.shape:
        s, h, hd = (int(x) for x in shape.split(","))
        q, k, v = (torch.randn((1, s, h, hd), generator=gen, device=dev) for _ in range(3))
        want = ref.flash_attention(q, k, v, causal=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        rec = {"shape": [1, s, h, hd], "causal": True, "sdpa_ms": time_ms(sdpa)}
        times = {name: [] for name in builds}
        for name in [*builds, *reversed(builds)]:
            times[name].append(time_ms(lambda: call(fns[name], q, k, v)))
        for name in builds:
            got = call(fns[name], q, k, v)
            rec[name] = {"ms": times[name], "max_abs_err": float((got - want).abs().max()),
                         "within_2e-5": bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))}
        print(json.dumps(rec), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
