"""candidate_device_ms: device ms of the fused candidate kernel per search call (traced window)."""

from perfbench.harness.stats import kernel_ms_per_call


def read(run):
    return kernel_ms_per_call(run, "search", "csr_candidate_topk_kernel")
