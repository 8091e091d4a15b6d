"""The metric arithmetic: a rate over the whole window, a p95 over every
call (never a median of chunks), and the roofline's count by hand."""

import statistics

import pytest
import torch

from small_bench import REPO
from perfbench.harness import cell as cell_lib
from perfbench.harness import roofline
from perfbench.harness.runner import Run
from perfbench.harness.trace import Trace


def _read(name, run):
    return cell_lib.load_reader(REPO, name)(run)


def _run(search_s, update_s=()):
    run = Run()
    run.calls = [("search", s, 100) for s in search_s]
    run.calls += [("insert", s, 10) for s in update_s] + [("delete", s, 10) for s in update_s]
    run.window_s = sum(search_s) + 2 * sum(update_s) + 0.5
    return run


def test_qps_is_every_query_over_the_whole_window():
    run = _run([0.01] * 30, update_s=[0.02] * 30)
    assert _read("qps", run) == pytest.approx(3000 / (0.3 + 1.2 + 0.5))


def test_p95_is_over_every_call():
    # one slow call in each block of 20 moves the p95 of all calls; the
    # median of per-block p95s would not see the same number
    times = [0.001 * (1 + (i % 20 == 0) * 9) for i in range(200)]
    run = _run(times)
    want = 1e3 * statistics.quantiles(times, n=20, method="inclusive")[18]
    assert _read("batch_ms_p95", run) == pytest.approx(want)
    assert _read("batch_ms_p95", _run([0.004])) == pytest.approx(4.0)
    assert _read("update_ms_p95", run) is None
    run = _run([0.001], update_s=[0.01, 0.03])
    assert _read("update_ms_p95", run) == pytest.approx(1e3 * statistics.quantiles(
        [0.01, 0.03, 0.01, 0.03], n=20, method="inclusive")[18])


def test_readers_return_nothing_without_their_source():
    run = _run([0.01])
    for name in ("launches_per_batch", "device_idle_share", "loop_device_ms",
                 "candidate_device_ms", "csr_candidate_topk_roofline", "compactions",
                 "recall_at_k", "loop_iters_mean", "peak_mem_gib"):
        assert _read(name, run) is None, name


def test_trace_readers():
    run = _run([0.01] * 4)
    run.trace = Trace(window_s=2.0, busy_s=1.5, spans={"search": 4}, launches={"search": 40},
                      kernel_s={"search": {"void csr_candidate_topk_kernel<true>(...)": 0.008,
                                           "radius_search_loop_kernel<16>": 0.002}},
                      device_ops=[], idle_gaps=[])
    run.candidate_work = (3.35e9, 0.0)          # 1 ms of bytes
    assert _read("launches_per_batch", run) == 10
    assert _read("device_idle_share", run) == pytest.approx(25.0)
    assert _read("candidate_device_ms", run) == pytest.approx(2.0)
    assert _read("loop_device_ms", run) == pytest.approx(0.5)
    assert _read("csr_candidate_topk_roofline", run) == pytest.approx(50.0)


def test_candidate_work_by_hand():
    # 2 queries, windows of 2 rows over 10 store rows, row_cap 3:
    # q0 rows [0,2) and [4,9) -> rows 0,1 | 4,5,6 (capped at 3)
    # q1 rows [1,3) and [8,10) -> rows 1,2 | 8,9
    starts = torch.tensor([[0, 4], [1, 8]], dtype=torch.int32)
    ends = torch.tensor([[2, 9], [3, 10]], dtype=torch.int32)
    nbytes, ops = roofline.candidate_work(starts, ends, n=10, row_cap=3, d=4, k=2)
    distinct = 8                                # 0 1 2 4 5 6 8 9
    pairs = 5 + 4
    assert nbytes == distinct * 4 * 4 + 2 * (2 * 8 + 4 * 4 + 2 * 8)
    assert ops == 3 * pairs * 4
    # the last window row starts within row_cap of the end: clamped, not past it
    nbytes, ops = roofline.candidate_work(torch.tensor([[9]]), torch.tensor([[10]]), n=10,
                                          row_cap=3, d=1, k=1)
    assert ops == 3 and nbytes == 1 * 4 + (8 + 4 + 8)
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
