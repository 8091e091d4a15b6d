"""The stage split (perfbench/harness/stages.py): on synthetic kineto
records by hand, and on traced CPU runs of the small cells."""

import pytest
from torch.autograd import DeviceType

from small_bench import REPO  # noqa: F401  (puts the repository on the path)
from perfbench.harness import cell as cell_lib
from perfbench.harness import stages


class Ev:
    def __init__(self, name, start, end, dev=DeviceType.CPU, corr=0, tid=1):
        self._v = (name, start, end - start, dev, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})()})()


def _cuda(name, start, end, corr):
    return Ev(name, start, end, DeviceType.CUDA, corr)


def _events():
    """One search call (100-500) and one insert call (600-900) in a window
    of 0-1000; a loop kernel launched at 200 runs 260-300, a candidate
    kernel launched at 400 runs 420-470, a snapshot copy launched at 700
    runs 820-860; the program's device-side range of `asnn.select` spans
    the candidate kernel and is no device work."""
    return [
        Ev("bench.window", 0, 1000),
        Ev("bench.search", 100, 500), Ev("asnn.search", 110, 490),
        Ev("asnn.project", 120, 150), Ev("asnn.loop", 150, 250),
        Ev("asnn.windows", 250, 300), Ev("asnn.select", 300, 450),
        Ev("asnn.assemble", 450, 480),
        Ev("cudaLaunchKernel", 200, 210, corr=1), _cuda("radius_search_loop_kernel", 260, 300, 1),
        Ev("cudaLaunchKernel", 400, 410, corr=2), _cuda("csr_candidate_topk_kernel", 420, 470, 2),
        _cuda("asnn.select", 420, 470, 2),
        Ev("bench.insert", 600, 900), Ev("asnn.insert", 610, 890),
        Ev("asnn.snapshot", 690, 720), Ev("cudaMemcpyAsync", 700, 705, corr=3),
        _cuda("Memcpy DtoD (Device -> Device)", 820, 860, 3),
    ]


def test_a_program_range_on_the_device_is_an_annotation():
    assert stages.kind(_cuda("asnn.select", 0, 1, 1)) == "gpu_user_annotation"
    assert stages.kind(_cuda("radius_search_loop_kernel", 0, 1, 1)) == "kernel"
    assert stages.kind(Ev("asnn.select", 0, 1)) == "cpu_op"


def test_split_by_hand():
    got = stages.split(Prof(_events()))
    # search call 100-500, busy 260-300 and 420-470: idle 310, cut at the spans
    # 100-150 outside any loop or select (facade), 150-250 loop, 250-260 windows
    # (facade), 300-420 select, 470-500 assemble and the call's end (facade)
    assert got["loop_idle_ms"] == pytest.approx(100e-6)
    assert got["candidate_idle_ms"] == pytest.approx(120e-6)
    assert got["facade_idle_ms"] == pytest.approx(90e-6)
    assert got["search_idle_ms"] == pytest.approx(310e-6)
    assert got["calls"] == {"search": 1, "insert": 1}
    # the snapshot's extent runs to its copy's end: 690 to 860
    assert got["snapshot_ms"] == pytest.approx(170e-6)
    assert "compact_ms" not in got and got["compact_spans"] == 0
    assert got["span_ms"]["asnn.select"] == {"n": 1, "mean": pytest.approx(170e-6)}
    assert got["idle_ms_per_call"]["search: asnn.loop"] == pytest.approx(100e-6)
    assert got["idle_ms_per_call"]["insert: asnn.insert"] == pytest.approx((300 - 30 - 40 - 20) * 1e-6)


def test_snapshots_inside_a_compaction_count_as_the_compaction():
    ev = _events() + [Ev("bench.insert", 920, 990), Ev("asnn.insert", 925, 985),
                      Ev("asnn.compact", 930, 970), Ev("asnn.snapshot", 935, 950)]
    got = stages.split(Prof(ev))
    assert got["snapshot_ms"] == pytest.approx(170e-6)
    assert got["compact_ms"] == pytest.approx(40e-6) and got["compact_spans"] == 1


def test_no_window_no_split():
    assert stages.split(Prof([Ev("asnn.search", 0, 10)])) is None


@pytest.mark.parametrize("name", ["small.b64", "small2d.map", "small.churn"])
def test_traced_cpu_run_splits_the_search_calls(bench_root, name):
    """On the CPU no device work runs, so a search call is idle throughout:
    the three idle shares add up to the calls' whole time."""
    line, got = stages.traced_run(cell_lib.load_cell(bench_root, name), 2**31 + 11, 0.5,
                                  bench_root, device="cpu")
    assert line["correct"]
    assert got["calls"]["search"] == line["window"]["steps"]
    parts = got["facade_idle_ms"] + got["loop_idle_ms"] + got["candidate_idle_ms"]
    assert parts == pytest.approx(got["search_idle_ms"], rel=1e-9)
    assert got["loop_idle_ms"] > 0 and got["candidate_idle_ms"] > 0 and got["facade_idle_ms"] > 0
    for stage in ("asnn.search", "asnn.project", "asnn.loop", "asnn.windows", "asnn.select",
                  "asnn.assemble"):
        assert got["span_ms"][stage]["n"] >= got["calls"]["search"], stage
    if name == "small.churn":
        assert got["snapshot_ms"] > 0
        assert ("compact_ms" in got) == (got["compact_spans"] > 0)
    else:
        assert "snapshot_ms" not in got
