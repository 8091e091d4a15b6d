"""csr_candidate_topk_roofline: the least time of a search call's candidate work (perfbench/harness/roofline.py,
counted from the inputs) over the candidate kernel's device time per call, in percent."""

from perfbench.harness import roofline
from perfbench.harness.stats import kernel_ms_per_call


def read(run):
    ms = kernel_ms_per_call(run, "search", "csr_candidate_topk_kernel")
    if ms is None or run.candidate_work is None:
        return None
    return 100.0 * roofline.bound_s(*run.candidate_work) / (ms / 1e3)
