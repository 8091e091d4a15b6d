"""The control's readings, the upper ends the correctness limits are set from.

  python3 perfbench/control.py --workload paper2d.churn --seeds 11-13 --steps 650

The control takes the program's place: the plain reference itself,
computed in TF32 (every float32 input of a product rounded to 10 mantissa
bits, TF32 matmuls, float32 geometry), answering the calls that a run of
--steps steps checks, held to the float64 reference as the program's
answers are.  It prints one JSON line of the numbers per seed and one of
their smallest (the upper reading of each limit; the lower readings are the
largest of sound runs of `run.py`).  The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def control_readings(cell, seed: int, steps: int, device) -> dict:
    """The control's numbers for one seed: the TF32 reference's answers at
    the steps a run of `steps` steps would check, held to the float64
    reference as the program's are."""
    import torch

    from perfbench.harness import runner

    dev = torch.device(device)
    tr = cell.traffic(seed, dev)
    last = tr.warmup_steps + steps - 1
    at = sorted({tr.warmup_steps + int(f * steps) for f in tr.check_fractions()} | {last})
    for op in tr.ops:
        op.prepare(last + 1)
    keys = [(s, j) for s in at for j, op in enumerate(tr.ops) if op.answers]
    if tr.mutates:
        keys += [(last + 1, 0)]
    control = runner.references(cell, tr, keys, dev, precision="tf32")
    checked = []
    for key in keys:
        ref = control(key)
        for j, op in enumerate(tr.ops):
            if op.answers and (key[1] == j or key[0] == last + 1):
                checked.append((key, j, op.control(ref, op.at_step(key[0]))))
    del control
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, _ = runner.check(cell, tr, checked, last, runner.Run(), False, dev)
    return readings


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 11-13 or 5,9,40")
    parser.add_argument("--steps", type=int, default=250,
                        help="the steps of the run whose checked calls it answers")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from perfbench.harness import cell as cell_lib

    cell = cell_lib.load_cell(ROOT, args.workload)
    rows = []
    for seed in seeds_of(args.seeds):
        t0 = time.perf_counter()
        rows.append(control_readings(cell, seed, args.steps, args.device))
        print(json.dumps({"workload": cell.name, "seed": seed, **rows[-1],
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": cell.name, "seeds": len(rows), "reading": "min",
                      **{n: min(r[n] for r in rows) for n in rows[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
