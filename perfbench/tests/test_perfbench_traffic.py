"""The traffic generator: the same seed gives the same inputs, the data
generators draw the published distributions, and a churn step keeps the
live set's size and retires live ids only."""

import json

import pytest
import torch

from small_bench import REPO
from perfbench.harness import cell as cell_lib
from perfbench.harness.traffic import Traffic, check_mix, generator, stream_seed


def _traffic(mix: str, seed: int, config: str, grid_size: int | None = None) -> Traffic:
    cfg = json.loads((REPO / "perfbench" / "configs" / f"{config}.json").read_text())
    cfg["data"].update(n=3000, queries=100)
    if grid_size:
        cfg["grid"]["grid_size"] = grid_size
    mx = json.loads((REPO / "perfbench" / "traffic" / f"{mix}.json").read_text())
    mx["batch"] = 100
    for entry in mx.get("step", []):
        if "rows" in entry:
            entry["rows"] = 64
    make_points = cell_lib.load_module(REPO, "generators", cfg["data"]["generator"]).make

    def make_op(entry, tr):
        params = {k: v for k, v in entry.items() if k != "op"}
        return cell_lib.load_module(REPO, "ops", entry["op"]).Op(tr, **params)

    return Traffic(cfg, mx, seed, "cpu", make_points, make_op)


@pytest.mark.parametrize("config,mix", [("random-s-100", "b10k"), ("paper-2d", "map64k"),
                                        ("paper-2d", "churn")])
def test_inputs_are_a_function_of_the_seed(config, mix):
    seed = 2**31 + 12345          # more than 32 signed bits hold
    a, b, c = (_traffic(mix, s, config) for s in (seed, seed, seed + 1))
    for x, y, z in ((a.base()[0], b.base()[0], c.base()[0]), (a.queries(), b.queries(),
                                                              c.queries())):
        assert torch.equal(x, y)
        # another seed: the configuration's one data set, in another order
        assert not torch.equal(x, z)
        assert torch.equal(torch.sort(x[:, 0]).values, torch.sort(z[:, 0]).values)
    assert a.check_fractions() == b.check_fractions() != c.check_fractions()
    if a.mutates:
        for op_a, op_b, op_c in zip(a.ops, b.ops, c.ops):
            for op in (op_a, op_b, op_c):
                op.prepare(5)
            if op_a.mutates:
                assert torch.equal(op_a.x, op_b.x) and torch.equal(op_a.dead, op_b.dead)
                assert not torch.equal(op_a.x, op_c.x)


def test_blobs_draw_the_published_recipe():
    tr = _traffic("b10k", 1, "random-s-100")
    x = tr.base()[0]
    assert x.shape == (3000, 100)
    gen = lambda s: generator("cpu", 1, s)  # noqa: E731
    make = cell_lib.load_module(REPO, "generators", "blobs").make
    pts = make(gen("a"), gen("fixed"), 2000, 100, centers=1000)
    centres = torch.rand((1000, 100), generator=gen("fixed")) * 20 - 10
    noise = pts - centres[torch.arange(2000) % 1000]
    assert 0.95 < noise.std().item() < 1.05 and abs(noise.mean().item()) < 0.01
    assert centres.min() >= -10 and centres.max() <= 10


def test_map_pixels_are_one_point_in_each_pixel_and_each_call_distinct():
    cfg_size = 30
    tr = _traffic("map64k", 9, "paper-2d", grid_size=cfg_size)
    op = tr.ops[0]
    x = tr.base()[0].double()
    lo, hi = x.amin(0), x.amax(0)
    span = hi - lo
    lo, span = lo - 0.01 * span, span * 1.02
    assert op.pixels.shape == (cfg_size * cfg_size // 100, 100, 2)
    px = torch.floor((op.pixels.reshape(-1, 2).double() - lo) / span * cfg_size).long()
    cells = px[:, 0] * cfg_size + px[:, 1]
    assert px.min() >= 0 and px.max() < cfg_size
    assert len(set(cells.tolist())) == cells.numel()          # a pixel once a cycle
    assert op.call_at(op.calls) == 0 and op.call_at(op.calls + 2) == 2
    again = _traffic("map64k", 10, "paper-2d", grid_size=cfg_size).ops[0]
    assert not torch.equal(again.pixels, op.pixels)
    assert torch.equal(torch.sort(again.pixels.reshape(-1, 2)[:, 0]).values,
                       torch.sort(op.pixels.reshape(-1, 2)[:, 0]).values)


def test_churn_step_retires_live_ids_and_keeps_the_size():
    tr = _traffic("churn", 5, "paper-2d")
    op = next(o for o in tr.ops if o.mutates)
    steps = 3 * op.cycle + 2              # past a cycle's end: a fresh permutation
    op.prepare(steps)
    live = set(range(tr.n))
    table = torch.arange(tr.n, dtype=torch.int32)
    for step in range(steps):
        dead = set(op.dead[step].tolist())
        assert len(dead) == op.rows and dead <= live
        live = (live - dead) | set(op.ids[step].tolist())
        ids, x, labels = op.replay(table, step)
        assert set(table.tolist()) == live and len(live) == tr.n
        assert x.shape == (op.rows, tr.d) and labels.shape == (op.rows,)
        assert torch.equal(ids, op.ids[step])


def test_stream_seeds_differ_and_fit_63_bits():
    seeds = {stream_seed(s, part) for s in (0, 1, 2**33) for part in ("base", "queries")}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)


def test_mix_rejects_unknown_keys_and_ops_without_a_name():
    with pytest.raises(ValueError):
        check_mix({"batch": 1, "mode": "paper"}, "x")
    with pytest.raises(ValueError):
        check_mix({"batch": 1, "step": [{"rows": 2}]}, "x")
