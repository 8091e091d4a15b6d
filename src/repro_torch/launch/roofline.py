"""Roofline terms from a traced dry-run step, on an H100 hardware model.

Port of `repro/launch/roofline.py`.  Three terms per (arch x shape x mesh)
cell, as the reference's:

    compute    = FLOPs_per_chip / peak_FLOPs_per_chip
    memory     = HBM_bytes_per_chip / HBM_bw_per_chip
    collective = collective_bytes_per_chip / link_bw

The reference reads them from XLA's compiled program: `cost_analysis()`
for FLOPs and bytes, and the optimized HLO text for the collectives
(`collective_bytes`) and the materialized buffers (`fused_bytes`,
`_shape_bytes`).  Those three parse XLA's HLO text and have no
counterpart here: eager PyTorch compiles no program to read.  The port's
counts come from running the step once on fake tensors
(`utils/trace.py`), and `from_trace` maps them onto the same terms:

    flops            the matrix-product FLOPs of `torch.utils.
                     flop_counter`'s formulas, plus the formulas the Hopper
                     kernels register (their upper bounds from shapes);
    hbm_bytes        each executed op's inputs and outputs: nothing is
                     fused in eager mode, so this is the eager program's own
                     traffic, not an upper bound over a fused one;
    fused_hbm_bytes  the output bytes the ops write;
    coll_bytes       the receive-side output bytes of each collective,
                     under the reference's five kind names.

Hardware model: NVIDIA H100 SXM (the data sheet, dense, at 700 W): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, 450 GB/s of NVLink each
way per card.  The reference uses one link rate for every mesh axis, and
so does the port; a 256-card mesh also crosses hosts (InfiniBand or
Ethernet between nodes of 8 cards, slower than NVLink), which one rate
models only roughly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

PEAK_FLOPS = 989e12        # bf16 FLOP/s per card (dense, tensor cores)
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # bytes/s per card, NVLink, each way


@dataclasses.dataclass
class Roofline:
    flops: float               # per-chip FLOPs
    hbm_bytes: float           # per-chip bytes the eager ops read and write
    coll_bytes: float          # per-chip collective bytes (receive side)
    coll_by_kind: dict[str, int]
    chips: int
    fused_hbm_bytes: float = 0.0   # bytes written (the ops' outputs)
    compute_s: float = 0.0
    memory_s: float = 0.0          # from fused bytes when available
    memory_upper_s: float = 0.0    # from all bytes
    collective_s: float = 0.0
    bottleneck: str = ""

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_upper_s = self.hbm_bytes / HBM_BW
        mem_bytes = self.fused_hbm_bytes or self.hbm_bytes
        self.memory_s = mem_bytes / HBM_BW
        self.collective_s = self.coll_bytes / LINK_BW
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.bottleneck = max(terms, key=terms.get)
        return self

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: max of the three terms (full overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "fused_hbm_bytes_per_chip": self.fused_hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_upper_s": self.memory_upper_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
        }


def from_trace(counts, chips: int) -> Roofline:
    """The roofline of one traced step (a `utils.trace.TraceCounts`, per
    rank) on `chips` cards."""
    return Roofline(
        flops=float(counts.flops),
        hbm_bytes=float(counts.bytes),
        coll_bytes=float(counts.coll_bytes),
        coll_by_kind={k: int(v) for k, v in counts.coll.items()},
        chips=chips,
        fused_hbm_bytes=float(counts.out_bytes),
    ).finalize()


def model_flops(cfg, shape, kind: str) -> float:
    """Useful-work FLOPs: 6 * N_active * tokens (the standard 6ND estimate)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens   # forward only
    # decode: one token per sequence; attention reads the cache but 2ND
    # stays the useful-FLOPs yardstick
    return 2.0 * n_active * shape.global_batch


def memory_analysis_dict(counts) -> dict[str, float]:
    """The reference's `memory_analysis` keys that mean something for a
    traced eager step, per rank:

      argument_size_in_bytes  the step's inputs (state or weights, batch,
                              caches, index) held by this rank;
      output_size_in_bytes    the storages of the step's outputs;
      temp_size_in_bytes      the peak bytes held during the step, less
                              the arguments.

    `generated_code_size_in_bytes` (compiled code) and
    `alias_size_in_bytes` (outputs aliased onto donated inputs) are left
    out: eager PyTorch compiles no code, and the port donates nothing.  So
    a train step's peak holds the old and the new train state together,
    where XLA's donated step writes the new state over the old one: a
    real difference of the port, which the temp bytes show."""
    return {
        "argument_size_in_bytes": float(counts.argument_bytes),
        "output_size_in_bytes": float(counts.output_bytes),
        "temp_size_in_bytes": float(counts.peak_bytes - counts.argument_bytes),
    }
