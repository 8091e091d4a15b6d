"""The port's dry run (`repro_torch/launch/{roofline,dryrun}.py`,
`steps.lower_cell`, `utils/trace.py`) against the reference's dry run and
against itself, at SMOKE sizes on the CPU.

The reference is lowered on the one default host device (its dry run
forces 512 only when `repro.launch.dryrun` runs as a script); importing
that module sets XLA_FLAGS, which is restored for the tests that spawn
subprocesses.  The port's traces run on fake CPU tensors; its fake process
groups are started in this process and destroyed after the module."""

import dataclasses
import math
import os
import re

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import retrieval_memory as rm
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_fake_mesh, mesh_chips
from repro_torch.optim import adamw
from repro_torch.utils import trace

# a SMOKE train / prefill cell: B = 4 sequences of 128 tokens, one device
SMOKE_CELL = dict(B=4, S=128)
# internlm2-1.8b SMOKE, train, accum 1: both packages' matrix-product FLOPs
INTERNLM2_SMOKE_TRAIN_FLOPS = 1_610_612_736
# qwen2-moe SMOKE (G = 8 groups of 64 tokens, E = 8 experts of C = 171
# slots, d = 128, shared MLP of 256, 2 layers): the reference's
# dot_generals count 2 x 2 x 512 x 128 x 256 more, the port's remat
# recompute of each layer's shared-MLP output product (torch.utils.checkpoint
# stops at the last saved tensor; XLA drops a recompute whose output no
# backward reads), and 6 x 2 x 8 x 64 x 4 x 171 less, the reference's
# dot_generals of combine's (mask, one-hot, weight) product, which the port
# multiplies elementwise (no FLOP formula)
QWEN2_MOE_GAP = 2 * 2 * 512 * 128 * 256 - 6 * 2 * 8 * 64 * 4 * 171


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module, XLA_FLAGS as it was before."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.fixture(scope="module")
def fake_2x2():
    """A (data 2, model 2) mesh over an in-process fake group of 4."""
    yield make_fake_mesh({"data": 2, "model": 2}, "cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------ equal to the reference ----


def test_cell_plan_equals_reference_for_every_cell(ref_dryrun):
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            assert TD.cell_plan(arch, shape) == ref_dryrun.cell_plan(arch, shape), (arch, shape)


def test_model_flops_equal_reference_for_every_cell_and_kind():
    from repro.configs import get_config as jget_config
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.launch import roofline as jrl

    for arch in ARCH_NAMES:
        for name, shape in SHAPES.items():
            for kind in ("train", "prefill", "decode"):
                got = rl.model_flops(get_config(arch), shape, kind)
                want = jrl.model_flops(jget_config(arch), JSHAPES[name], kind)
                assert got == want, (arch, name, kind)


def test_roofline_terms_and_bottleneck_on_h100():
    r = rl.Roofline(
        flops=989e12 * 0.5,        # 0.5 s compute
        hbm_bytes=3.35e12 * 0.2,   # 0.2 s memory
        coll_bytes=450e9 * 0.8,    # 0.8 s collective
        coll_by_kind={}, chips=256,
    ).finalize()
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert abs(r.compute_s - 0.5) < 1e-9
    assert abs(r.memory_s - 0.2) < 1e-9
    assert abs(r.collective_s - 0.8) < 1e-9
    assert r.bottleneck == "collective"
    assert r.step_time_s == r.collective_s
    m = rl.Roofline(flops=989e12, hbm_bytes=3.35e12 * 4, coll_bytes=0.0, coll_by_kind={},
                    chips=1, fused_hbm_bytes=3.35e12 * 2).finalize()
    assert (m.memory_s, m.memory_upper_s, m.bottleneck, m.step_time_s) == (2.0, 4.0, "memory", 2.0)


_DOT = re.compile(
    r"stablehlo\.dot_general\s+%\S+,\s+%\S+,\s*(?:batching_dims = \[[\d, ]*\] x \[[\d, ]*\],\s*)?"
    r"contracting_dims = \[([\d, ]*)\] x \[[\d, ]*\].*?:\s*\(tensor<([\dx]+)x\w+>, "
    r"tensor<[\dx]+x\w+>\)\s*->\s*tensor<([\dx]+)x\w+>")


def _dot_general_flops(text: str) -> int:
    """2 x output elements x contracted size over every dot_general."""
    total = 0
    for m in _DOT.finditer(text):
        lhs = [int(x) for x in m.group(2).split("x")]
        out = [int(x) for x in m.group(3).split("x")]
        k = math.prod(lhs[int(c)] for c in m.group(1).split(",") if c.strip())
        total += 2 * math.prod(out) * k
    return total


def _reference_flops(arch: str, kind: str) -> int:
    """The reference's lowered cell (1 x 1 host mesh, scans unrolled, accum
    1) at SMOKE_CELL: its dot_general FLOPs."""
    from repro.configs import get_smoke as jget_smoke
    from repro.configs import shapes as jshp
    from repro.launch import steps as jst
    from repro.launch.mesh import make_host_mesh
    from repro.utils import scan as juscan

    cfg = jget_smoke(arch)
    cfg = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, scan_layers=False, accum=1))
    name = f"smoke_{kind}"
    jshp.SHAPES[name] = jshp.ShapeSpec(name, SMOKE_CELL["S"], SMOKE_CELL["B"], kind)
    try:
        with juscan.unroll_scans():
            lowered, got_kind = jst.lower_cell(cfg, name, make_host_mesh(1, 1))
    finally:
        del jshp.SHAPES[name]
    assert got_kind == kind
    return _dot_general_flops(lowered.as_text())


def _port_flops(arch: str, kind: str) -> float:
    lowered, got_kind = st.lower_cell(get_smoke(arch),
                                      ShapeSpec("smoke", SMOKE_CELL["S"], SMOKE_CELL["B"], kind),
                                      device="cpu")
    assert got_kind == kind
    return lowered.counts.flops


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_lower_cell_flops_equal_reference_dot_generals(kind):
    want = _reference_flops("internlm2-1.8b", kind)
    assert _port_flops("internlm2-1.8b", kind) == want
    if kind == "train":
        assert want == INTERNLM2_SMOKE_TRAIN_FLOPS


def test_moe_flop_gap_to_reference_is_pinned():
    want = _reference_flops("qwen2-moe-a2.7b", "train")
    assert want - _port_flops("qwen2-moe-a2.7b", "train") == -QWEN2_MOE_GAP


# ---------------------------------------------------- agreement in the port --


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one_device", "fake_2x2"])
def test_probe_extrapolation_equals_full_depth_trace(on_mesh, request):
    """An eager trace has no scan undercount: the reference's depth probes
    (1 and 2 periods, accum 1, one attention chunk) extrapolate to the
    full-depth trace's roofline exactly.  On a mesh the FLOPs and every
    collective do; DTensor gathers a one-layer stack without the
    concatenation a deeper one needs, so the probes' bytes sit over."""
    mesh = request.getfixturevalue("fake_2x2") if on_mesh else None
    cfg = dataclasses.replace(get_smoke("internlm2-1.8b"), n_layers=3)
    shape = ShapeSpec("probe", 32, 4, "train")
    full, _ = st.lower_cell(cfg, shape, mesh, device="cpu")
    raw = rl.from_trace(full.counts, 1 if mesh is None else mesh_chips(mesh)).as_dict()
    probed = TD.probe_costs(cfg, shape, mesh, None, device="cpu")
    assert raw["flops_per_chip"] > 0
    if mesh is None:
        assert probed == raw
        return
    assert raw["coll_bytes_per_chip"] > 0
    for key in ("flops_per_chip", "coll_bytes_per_chip", "coll_by_kind", "compute_s",
                "collective_s"):
        assert probed[key] == raw[key], key
    assert 0 < probed["hbm_bytes_per_chip"] - raw["hbm_bytes_per_chip"] < 1e-2 * raw["hbm_bytes_per_chip"]


def _real_step_flops(cfg, shape):
    """FlopCounterMode over one real CPU step of the cell (random weights)."""
    gen = torch.Generator().manual_seed(0)
    b, s = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            state = st.init_train_state(gen, cfg, adamw.AdamWConfig(), st.StepConfig(), "cpu")
            st.make_train_step(cfg, adamw.AdamWConfig())(state, {"tokens": tokens,
                                                                  "labels": tokens})
        else:
            from repro_torch.models.model import DecoderLM

            st.make_prefill_step(cfg)(DecoderLM(cfg, "cpu", gen), {"tokens": tokens})
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind,accum", [("internlm2-1.8b", "train", 4),
                                              ("jamba-v0.1-52b", "prefill", 1)])
def test_fake_trace_flops_equal_a_real_run(arch, kind, accum):
    """The trace's FLOPs equal FlopCounterMode's over a real run, with the
    microbatch loop (accum 4) and the Mamba token loop (16 tokens a chunk)
    each extrapolated from 1 and 2 iterations."""
    cfg = get_smoke(arch)
    cfg = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, accum=accum))
    shape = ShapeSpec("real", 16 if kind == "train" else 32, 4, kind)
    lowered, _ = st.lower_cell(cfg, shape, device="cpu")
    assert len(lowered.traces) == 2
    assert lowered.counts.flops == _real_step_flops(cfg, shape) > 0


def test_capped_loops_extrapolate_to_the_uncapped_trace():
    """Every count (calls, bytes, FLOPs, peak) of a Mamba prefill traced with
    its token loops cut to 1 and 2 iterations equals the uncapped trace's."""
    cfg = get_smoke("jamba-v0.1-52b")
    shape = ShapeSpec("loops", 32, 2, "prefill")
    lowered, _ = st.lower_cell(cfg, shape, device="cpu")
    assert lowered.loop_trips == cfg.mamba.chunk
    whole = st._trace_cell(cfg, shape, None, adamw.AdamWConfig(), st.StepConfig(), None, "cpu")
    got = lowered.counts
    assert dict(got.calls) == dict(whole.calls)
    for field in ("flops", "bytes", "out_bytes", "peak_bytes", "argument_bytes", "output_bytes"):
        assert getattr(got, field) == getattr(whole, field), field


def test_collective_bytes_by_kind_against_hand_counts(fake_2x2):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = fake_2x2.device_mesh

    def step(a, p):
        a.redistribute(dm, [Replicate(), Replicate()])          # all-gather over data
        p.redistribute(dm, [Replicate(), Replicate()])          # all-reduce over model
        p.redistribute(dm, [Replicate(), Shard(0)])             # reduce-scatter over model
        # all-to-all over data (DTensor's Shard(0) -> Shard(1) on a CPU mesh
        # gathers instead: gloo has no all-to-all)
        funcol.all_to_all_single(a.to_local(), None, None, fake_2x2.group("data"))

    with FakeTensorMode():
        a = DTensor.from_local(torch.empty((4, 8)), dm, [Shard(0), Replicate()], run_check=False)
        p = DTensor.from_local(torch.empty((8, 8)), dm, [Replicate(), Partial()], run_check=False)
        _, c = trace.count_step(step, a, p)
    f32 = 4
    assert c.coll == {"all-gather": 8 * 8 * f32, "all-reduce": 8 * 8 * f32,
                      "reduce-scatter": 4 * 8 * f32, "all-to-all": 8 * 4 * f32,
                      "collective-permute": 0}
    assert c.flops == 0


def _loop_inputs(b=5, t=16, c=2, levels=3):
    tiles = torch.zeros((sum(4 ** lv for lv in range(levels)), t, t, c), dtype=torch.int32)
    return tiles, torch.rand((b, 2)) * 32, torch.full((b,), 3, dtype=torch.int32)


def _csr_inputs(b=3, w=4, d=6, n=40):
    gen = torch.Generator().manual_seed(0)
    store = torch.rand((n, d), generator=gen)
    starts = torch.randint(0, n, (b, w), generator=gen, dtype=torch.int32)
    return store, starts, torch.clamp(starts + 2, max=n), torch.rand((b, d), generator=gen)


def test_kernel_ops_fake_outputs_match_the_plain_versions():
    tiles, q, r0 = _loop_inputs()
    want = ref.radius_search_loop(tiles, q, r0, 3, 4, 64, 5, 16, (4, 2, 1))
    store, starts, ends, qs = _csr_inputs()
    want_d, want_i = ref.csr_candidate_topk(store, starts, ends, qs, 7, 40, 8)
    with FakeTensorMode() as fm:
        fake = [fm.from_tensor(x) for x in (tiles, q, r0, store, starts, ends, qs)]
        got = torch.ops.repro_torch.radius_search_loop(*fake[:3], 3, 4, 64, 5, 16, 3, False)
        got_c = torch.ops.repro_torch.csr_candidate_topk(*fake[3:], None, 7, 40, 8, 6, False,
                                                          False)
    for g, key in zip(got, ("radius", "count", "iters", "converged")):
        assert (g.shape, g.dtype) == (want[key].shape, want[key].dtype), key
    assert [(g.shape, g.dtype) for g in got_c] == [(want_d.shape, want_d.dtype),
                                                    (want_i.shape, want_i.dtype)]
    # on a real CPU tensor the op has no kernel: no fallback to the plain version
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.radius_search_loop(tiles, q, r0, 3, 4, 64, 5, 16, 3, False)


def test_kernel_formulas_against_hand_counts():
    tiles, q, r0 = _loop_inputs(b=5, t=16, c=2)
    store, starts, ends, qs = _csr_inputs(b=3, w=4, d=6)
    with FakeTensorMode() as fm:
        fake = [fm.from_tensor(x) for x in (tiles, q, r0, store, starts, ends, qs)]
        _, loop = trace.count_step(torch.ops.repro_torch.radius_search_loop,
                                   *fake[:3], 3, 4, 64, 5, 16, 3, False)
        _, csr = trace.count_step(torch.ops.repro_torch.csr_candidate_topk,
                                  *fake[3:], None, 7, 40, 8, 6, False, False)
        with FlopCounterMode(display=False) as fc:
            torch.ops.repro_torch.csr_candidate_topk(*fake[3:], None, 7, 40, 8, 6, False, False)
    passes = 5 + 1                              # max_iters and the recount
    assert loop.flops == 5 * passes * 16 * 16 * (10 + 2)
    assert loop.bytes == 5 * passes * 16 * 16 * 2 * 4 + 5 * 12 + 5 * 13
    assert csr.flops == fc.get_total_flops() == 3 * 4 * 8 * 3 * 6
    assert csr.bytes == 3 * 4 * 8 * 6 * 4 + 2 * 3 * 4 * 4 + 3 * 6 * 4 + 3 * 7 * 8
    assert loop.calls == {"repro_torch.radius_search_loop": 1}


def test_index_abstract_shapes_equal_a_built_memory_index():
    cfg = get_smoke("minitron-8b")
    mem = rm.RetrievalMemoryConfig(grid=dataclasses.replace(rm.RetrievalMemoryConfig().grid,
                                                            grid_size=64))
    keys = torch.randn((300, cfg.head_dim), generator=torch.Generator().manual_seed(1))
    built = rm.build_memory_index(keys, mem, rm.make_projection(torch.Generator(), cfg.head_dim))
    built = built._replace(pyr_tiles=built.pyr_tiles)
    got = st.index_abstract(cfg, 300, mem, "cpu")
    flat = lambda ix: [(t.shape, t.dtype) for t in trace.local_tensors(list(ix))]  # noqa: E731
    assert flat(got) == flat(built)


@pytest.mark.parametrize("on_mesh", [False, True], ids=["one_device", "fake_2x2"])
def test_retrieval_cell_traces_one_call_of_each_kernel(on_mesh, monkeypatch, request):
    """The retrieval serve step on fake tensors, the search's two kernels as
    on the card (their ops in place of the CPU's plain versions, whose loop
    reads data): one call of each, credited with their formulas.  On a
    mesh the one row leaves the data axis spare, which shards the cache's
    positions (as long_500k's on 16 x 16): one rank writes the new one."""
    def loop(tiles, queries, r0, k, k_hi, r_max, max_iters, tile, nblks, metric="l2",
             early_exit=True):
        out = torch.ops.repro_torch.radius_search_loop(tiles, queries, r0, k, k_hi, r_max,
                                                       max_iters, tile, len(nblks), False)
        return dict(zip(("radius", "count", "iters", "converged"), out))

    def csr(store, starts, ends, queries, k, n, row_cap, metric="l2", radii=None,
            center_cells=False, d_chunk=None):
        return torch.ops.repro_torch.csr_candidate_topk(store, starts, ends, queries, radii, k, n,
                                                        row_cap, store.shape[1], False, False)

    monkeypatch.setattr(ops, "radius_search_loop", loop)
    monkeypatch.setattr(ops, "csr_candidate_topk", csr)
    cfg = get_smoke("minitron-8b")
    mesh = request.getfixturevalue("fake_2x2") if on_mesh else None
    lowered, kind = st.lower_cell(cfg, ShapeSpec("long", 4096, 1, "decode"), mesh,
                                  retrieval=(64, 512), device="cpu")
    c = lowered.counts
    assert kind == "decode"
    assert c.calls["repro_torch.radius_search_loop"] == c.calls["repro_torch.csr_candidate_topk"] == 1
    grid = rm.RetrievalMemoryConfig().grid
    assert c.flops_by_op["repro_torch.csr_candidate_topk"] == (
        grid.window * grid.row_cap * 3 * cfg.head_dim)
    assert c.flops_by_op["repro_torch.radius_search_loop"] == (
        (grid.max_iters + 1) * grid.tile ** 2 * (10 + grid.n_channels))
