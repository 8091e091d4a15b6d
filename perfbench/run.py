"""Run one cell of the PyTorch port's benchmark and print its result line.

  python3 perfbench/run.py --workload rand100.b10k --seed 7 --seconds 20 --trace 0

From the root of a checkout that holds `src/repro_torch` (the program) and
`BENCHMARK.json`.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, and last `checks`: each number the correctness check compares,
beside its limit (also the last lines of standard error).  Without a CUDA
card, or with fewer than the cell asks for, it prints no result and exits 2.
The port's kernels are built once into `build/repro_torch/` of the checkout.
"""

import time

_CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_age_s() -> float:
    """Seconds since this process started (interpreter start-up included),
    from /proc; 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def main() -> int:
    clock0 = _CLOCK0 - process_age_s()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    # every cache of the program at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    t = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    from perfbench.harness import cell as cell_lib
    from perfbench.harness import runner

    cell = cell_lib.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch.api  # noqa: F401  (the program, imported inside set-up)

    marks = {"start_s": t - clock0, "torch_import_s": t_torch - t,
             "program_import_s": time.perf_counter() - t_torch}
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), ROOT,
                          clock0=clock0, marks=marks)
    found = runner.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}: nothing of JAX or the JAX package may "
              f"run here", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
