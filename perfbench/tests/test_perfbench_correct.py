"""`correct` comes out true for the program and false for the control and
for each fault a cell can have, planted under the timed path.

The cells here are small copies run on the CPU (the program's plain
versions); on the card the same harness drives the kernels."""

import pytest
import torch

from small_bench import make_root, require_cuda, run_small
from perfbench.harness import cell as cell_lib
from perfbench.reference import compare

CELLS = ("small.b64", "small.churn", "small2d.b64", "small2d.map")


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(bench_root, name):
    out = run_small(bench_root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(compare.NAMES)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(bench_root, name):
    from perfbench import control

    cell = cell_lib.load_cell(bench_root, name)
    got = control.control_readings(cell, 2**31 + 99, steps=8, device="cpu")
    assert any(got[n] > cell.limits[n] for n in compare.NAMES), got


def _searcher():
    from repro_torch.core.engine import ActiveSearcher

    return ActiveSearcher


def test_a_step_that_leaves_the_state_unchanged_fails(bench_root, monkeypatch):
    cls = _searcher()
    monkeypatch.setattr(cls, "insert", lambda self, points, labels=None, ids=None: self)
    monkeypatch.setattr(cls, "delete", lambda self, ids: self)
    assert not run_small(bench_root, "small.churn")["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_fails(bench_root, monkeypatch, name):
    cls = _searcher()
    search = cls.search

    def half(self, queries, k, mode="refined"):
        res = search(self, queries[: queries.shape[0] // 2], k, mode)
        return type(res)(*(torch.cat([f, f]) for f in res))

    monkeypatch.setattr(cls, "search", half)
    assert not run_small(bench_root, name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_fails(bench_root, monkeypatch, name):
    cls = _searcher()
    search = cls.search

    def altered(self, queries, k, mode="refined"):
        res = search(self, queries, k, mode)
        ids = res.ids.clone()
        ids[ids.shape[0] // 3, k // 2] += 1
        return res._replace(ids=ids)

    monkeypatch.setattr(cls, "search", altered)
    assert not run_small(bench_root, name)["correct"]


@pytest.mark.gpu
def test_a_cell_on_the_card(tmp_path):
    """On the card: a short run of the small copies drives the kernels and
    holds them to the reference."""
    require_cuda()
    from perfbench.harness import runner

    root = make_root(tmp_path)
    for name in CELLS:
        out = runner.run_cell(cell_lib.load_cell(root, name), 11, 0.5, True, root,
                              device="cuda")
        assert out["correct"], (name, out["checks"])
        assert out["device"]["busy_s"] > 0


def test_a_call_that_raises_ends_the_window_and_is_counted(bench_root, monkeypatch):
    cls = _searcher()
    search, calls = cls.search, []

    def flaky(self, queries, k, mode="refined"):
        calls.append(1)
        if len(calls) == 3:     # the window's first call, after two warm-up steps
            raise KeyError("planted")
        return search(self, queries, k, mode)

    monkeypatch.setattr(cls, "search", flaky)
    out = run_small(bench_root, "small.b64")
    assert out["failed"] == 1 and out["attempted"] >= 1 and not out["correct"]
