"""loop_device_ms: device ms of the Eq.-1 loop kernel per search call (traced window)."""

from perfbench.harness.stats import kernel_ms_per_call


def read(run):
    return kernel_ms_per_call(run, "search", "radius_search_loop_kernel")
