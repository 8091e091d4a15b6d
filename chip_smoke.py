#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with one card and the CUDA
toolkit.  It builds the eight Hopper kernels from src/repro_torch/csrc
with nvcc (one process per source, all at once) and prints one JSON line
per phase:

  0  device: name, count, power limit; every kernel built for sm_90a, with
     build seconds and ptxas's registers / shared memory / spills;
  1  each kernel against its plain PyTorch version on the card, on random
     inputs at the shapes of phases 2-4 (the Eq.-1 loop's five stats,
     counts, int8 shortlists,
     paper-mode and d=2 results exact; d=128 float distances within rtol
     1e-5, ids equal up to near-ties, which are counted), and
     candidate_topk bit-equal to csr_candidate_topk on the same rows (d =
     128 at d_chunk None, 48 and 5; d = 37 at d_chunk 5);
     the three candidate kernels past their old shared-memory caps
     (windows of 32,768 and 65,536 slots, C = 65,536), on unaligned rows
     (d = 2, 9, 13, 37 in float32, 130 in int8), at d_chunk = 5, with k and
     rerank_k = 1, 257 and past (or all of) the window, spans clamped at
     the store's ends, queries with no valid slot and a live count below
     the store; candidate_topk also over three tiles with a partial last
     one and on windows 4 bytes past a 16-byte boundary (4-byte copies at
     d = 128), at the re-rank shape too;
     radius_search_loop on indexes of 1M points at phase 2's and a phase-3
     chunk's shapes (l2, l1, adaptive_r0, early_exit off, 40 channels,
     T = 8) and on edge cases (n = 0 on every pass, radii at 1 and at
     r_max, counts of exactly k and k_hi, lanes out of iterations, Eq.-1
     products on a half);
     both count kernels at 40 channels (PROD_GRID's pyramid shape);
     tile_count's two instances (T = 8 and 16) at 40 channels with one
     query and with 4097; brute_knn
     at d = 2 / 128 / 40, k = 32, 33, 64, 257 at d = 9 and 128, k = 1000 at
     a small N, k > N, no points (all pads), non-finite rows, and integer
     lattices (k up to 64; exact, ties to the lower index); flash_attention
     over head dims 16-1024 on the tensor cores (hd = 36: a multiple of 4,
     not of 8; 129, 131, 257 and 301: 4-byte copies; 160, 200, 256; 384,
     512, 1000 and 1024 with the head dim split across warps), ragged
     tiles (causal with S < T too), causal and full, bf16, query tiles
     split over three launches at hd = 64, 128, 160 and 512, 70,000 heads,
     and B·H = 70,400 at hd = 16, 160 and 512; ptxas's registers and
     spills of each of its variants (none may spill);
  2  the paper's setup at full scale (PAPER_GRID, 1M 2-D points, 4096
     queries): build, search, classify in both modes on `hopper`, recall
     and class agreement against `exact`, launch counts (a search: one
     radius_search_loop, one csr_candidate_topk, no tile_count_multilevel),
     the search's Eq.-1 stats equal to the lock-step loop's, `count_at` at
     the final radii on tile_count_multilevel (totals equal to the loop's
     counts), and the first 256 queries re-run on the CPU through the
     plain versions (exactly equal); `exact` on the brute_knn kernel (its only launches), held
     against the plain version it replaced (ids equal on >= 99.9% of
     queries, squared distances within 8 ulps of ‖q‖² + ‖x‖²; the first
     chunk's share of id lists equal to float64 distances), both timed,
     with torch.topk(torch.cdist(q, x)) timed beside them (`two_call_ms`:
     two library calls, no single one computes kNN);
     then `hopper_stacked.count_at` at the loop's final radii
     (equal to `hopper`'s, one tile_count launch per level),
     `hopper_gather` (both modes equal to `hopper` in every field) and
     `hopper_q8` (paper mode equal to `hopper`, refined recall, device
     time and idle share); the loop kernel timed at this path's shape, its
     bound over the distinct in-circle cells of all passes together; the count
     kernels timed at the loop's first pass, exact against their plain
     versions, each also by device_ms (below);
  3  a SIFT1M-shaped datastore (1M points, d=128, 10,000 queries; planted
     data, nothing downloaded): PROD_GRID, PCA projection, k=10, chunks of
     2048; recall against `exact` (on brute_knn, checked and timed as in
     phase 2), a 256-query CPU cross-check (ids
     equal for >= 99% of queries); then `hopper_q8` on the same index at
     full size (recall, the share of lanes whose shortlist holds
     `hopper`'s top-10 and those lanes equal to `hopper` in every field,
     candidate bytes float32 against int8, times, idle share, peak memory,
     its own CPU cross-check) and `hopper_gather` on one chunk (equal to
     `hopper`); launches and `count_at` as in phase 2 (one
     radius_search_loop per chunk); the loop kernel and the candidate
     kernels timed on one chunk, each output held
     against its plain version's as in phase 1, with `gathered_ms` (every
     valid (query, row) pair's row read once: the floor when queries share
     nothing in L2) beside the distinct-row bound, and each kernel's
     registers and shared memory; candidate_topk at the q8 re-rank's shape
     and at hopper_gather's, each with device_ms and `two_call_ms`
     (torch.cdist, the invalid slots masked, torch.topk: no single call
     computes the function); csr_candidate_topk's timed chunk also gives
     the share of its window slots the walk skips (ref.window_runs) and,
     at seed 0, is held to ROW2_SLACK times its figure in PERF.md's
     kernel table (row 2), taken on the same data;
  4  flash_attention, which no path of the system calls, at
     musicgen-medium's attention width (24 heads, head_dim 64) and a 32,768
     sequence, float32, causal, and at S = 4096 at stablelm-12b's width
     (32 heads, head_dim 160), minitron-8b's (32 heads, head_dim 128) and
     4 heads of head_dim 512 (the head dim split across warps): four
     counted calls,
     their times, every head held against the plain version (causal, and
     full at S = 4096), and scaled_dot_product_attention timed on the same
     tensors as a yardstick (`slower_than_library` says which way each
     shape falls); bound_ms is the three-pass TF32 tensor-core bound of
     each call, fp32_fma_bound_ms the float32 FMA units' beside it;
  5  the mutable index at full scale, through the facade: at PAPER_GRID
     (phase 2's 1M points and 4096 queries) a build from all but 8 x
     2048 points, 8 inserts of 2048 and 4 deletes of 2048 ids (half built,
     half inserted); the handle's index equal to `build_index` of the
     survivors in every field (tiles included) and `validate_mutable` all
     true; search (both modes) and classify (both modes) on `hopper`,
     `hopper_gather`, `hopper_q8`, `torch` and `exact`, and count_at on
     `hopper` and `hopper_stacked`, every field equal between the mutated
     and the rebuilt handle; `torch` equal to `hopper` in every field; the
     seven kernels of those paths each launched on the mutated handles;
     then 262,144 points spread uniformly over the grid, which overflow
     the spill log: one compaction, and a rebuild equal again.  At the
     SIFT1M-shaped scale (phase 3's PROD_GRID, d = 128) one insert and one
     delete of 2048, `hopper` and `hopper_q8` on a 2048-query chunk equal
     to a rebuild's.  Each prints insert, delete and snapshot times, the
     rebuild's (the work the delta path avoids), the state's bytes against
     the frozen index's, the peak memory and `torch`'s search time beside
     `hopper`'s, with the card's name and power limit;
  6  the sharded tier and the search side of serving, at full width:
     6a PAPER_GRID, 1M random 2-D points over 4 shards on the one card
     (4096 queries, k = 11): the stacked index equal to `build_index` of
     each shard's routed points, the `sharded` search (no kernel: its
     shards search on `torch`, as the reference's on `jnp`) equal to a
     host merge of the per-shard `torch` results, two inserts of 2048 and
     a delete of 2048 equal to a sharded rebuild in every field of the
     index, search (both modes) and classify, snapshot() equal to
     `build_index` of the live points in arrival order; times of search,
     insert, delete and merge_to_dense, and recall@11 against `exact`;
     6b the kNN-LM head at minitron-8b's width (d = 4096, vocab 256,000),
     KNN_LM_PAIRS synthetic pairs made on the card, KNNLMConfig's
     defaults (`hopper`), a decode stream of 256 requests of 1-8 rows
     through DynamicBatcher(max_batch=64) with 4 inserts of 2048 pairs
     between batches: each request equal to an unpadded call on the
     handle that served it, each p_knn row summing to 1 within 1e-5, one
     radius_search_loop and one csr_candidate_topk per batch, the grown
     datastore equal to `build_index` of the union; decode rows/s, ms per
     batch, insert ms, pad rows, recall@16, peak memory, and
     csr_candidate_topk at a batch's shape against its plain version, with
     the share of its window slots the walk skips;
     6c retrieval memory at minitron-8b's long_500k (524,288 positions,
     8 KV heads of 128, 32 query heads; RetrievalMemoryConfig's defaults)
     in 64 decode steps of 8 rows, one launch of each path kernel a step,
     two steps held against the CPU's plain versions, recall@64 against
     `exact`, extend_memory_index of 1024 positions equal to the build
     over the concatenation; 6d that memory's mutable state saved and
     restored through CheckpointManager (under build/, removed after),
     then one insert of 1024 into the restored and the live state: equal
     in every field; bytes, save and restore seconds;
  7  the LM serving path (models/, launch/serve.py's Engine): 7a
     minitron-8b's widths at depth 2 in float32 (the port's ACT_DTYPE
     switched for the phase), a prefill of 64 tokens and 4 decode steps on
     the card and through the same module on the CPU, logits and hidden
     states within rtol 1e-4 (atol 1e-4), decode equal to the training
     forward; 7b minitron-8b's CONFIG at full width and depth (32 layers,
     9.88 B parameters in bf16, random weights from the seed): prefill of
     S-2 tokens plus one decode step against the forward (the reference's
     own tolerance), build_datastore_from_model over 256 random sequences
     of 1,025 tokens (262,144 pairs at d = 4096, labels corpus[:, 1:] in
     order), Engine.generate with the kNN-LM head (KNNLMConfig's defaults,
     `hopper`) on 8 prompts of 512 tokens, 32 greedy tokens, one
     radius_search_loop and one csr_candidate_topk per pick, `hopper` equal
     to `torch` at every pick (ids up to counted near-ties, distances
     within rtol 1e-5), recall@16 against `exact`, the online
     queue -> drain (248 pairs; n_points and labels exact) and a second
     generate over the grown datastore; parameters and bytes, harvest
     seconds and tokens/s, prefill ms, decode ms per step with the
     device-busy share and both kernels' device ms per step from a traced
     run, insert ms, tokens/s of each generate, peak memory;
  8  the MoE, Mamba and xLSTM layers on that path: 8a in float32, card
     against CPU at rtol / atol 1e-4: one moe_block at qwen2-moe-a2.7b's
     width (60 experts padded to 64, 2048 x 1408, top-4, a shared MLP of
     5632) and one at jamba-v0.1-52b's (16 x 4096 x 14,336, top-2; 11.3 GB
     of float32 weights on each side), the router's top-k ids and kept
     mask equal; one Mamba sublayer at jamba's width (d_inner 8192): a
     prefill of 64 tokens, 4 decode steps, the training form, decode equal
     to it; xlstm-125m whole as 7a (atol 1e-3: 12 layers); 8b
     qwen2-moe-a2.7b's CONFIG at full width and depth (24 layers, 15.15 B
     parameters: param_count() plus the 4 padded experts of every layer
     and the norms) through 7b's steps: prefill / decode against the
     forward held in float32 with the same weights, alone on the card, at
     a drop-free capacity factor (n_experts / top_k: every group's
     capacity its size; the bf16 gaps, there and at the real 1.25,
     printed); a harvest of 256 x 1,024 tokens (layer-major: an MoE
     layer runs whole GShard groups at a time); two counted generates of 8 x 512 prompts and 32
     tokens, `hopper` equal to `torch` at every pick, the online flow, a
     traced decode run with its cudaLaunchKernel calls per step; 8c the
     same for jamba-v0.1-52b at
     full width with its depth cut to one period (8 of 32 layers,
     `reduced` in its line; consistency in float32 as 8b) and for
     xlstm-125m whole (consistency in bf16 as 7b), with 32 sequences and
     16 new tokens, and the selective scan's and the sLSTM loop's share of
     one prefill (CUDA events around each call);
  9  the training path (optim/, data/pipeline.py, launch/steps.py,
     launch/train.py) and the retrieval serve step: 9a internlm2-1.8b's
     widths at depth 2 in float32, card against CPU, 3 steps of
     make_train_step (bf16_compute_copy off, accum 2) on the same
     synthetic batches: loss, grad_norm, lr, moments and parameters within
     rtol / atol 1e-4 (the parameters but for the few whose gradient sits
     at float32's noise floor, which AdamW's per-element normalisation
     turns into updates of up to the learning rate), and remat "full"
     against "none"; 9b internlm2-1.8b's CONFIG at full width and depth
     (1.89 B parameters, float32 masters and moments) through
     launch/train.py's `run`: the bf16 compute copy, remat full, accum 4,
     20 steps of 8 x 1,024 synthetic tokens, the loss falling, with one
     checkpoint (step 12; each is 22.7 GB, and a call may write 45 GiB to
     the machine's disk) under build/ (kept for phase 10, removed after
     it); then a fresh run
     from that checkpoint with a fault injected at step 15, restarted by
     the supervisor to step 20, its losses held against the uninterrupted
     run's; step ms, tokens/s, peak memory and 6·N·tokens a step as a
     share of the bf16 peak; 9c make_retrieval_serve_step at minitron-8b's
     CONFIG with a cache of 262,144 positions (random K/V from the seed)
     and the memory index over layer 0's key summaries: 16 counted steps,
     one radius_search_loop and one csr_candidate_topk each, `hopper`
     equal to `torch` on each step's query (ids up to counted near-ties),
     the logits against decode_step given the same positions; 9d
     qwen2-moe-a2.7b's CONFIG harvested over 256 x 1,023 tokens (512
     groups of 512, the last padded, which no batch of whole sequences
     holds) against one forward over the whole corpus on the card;
 10  the device mesh, four ranks spawned on the one card over gloo (CUDA
     tensors, each on cuda:0; NCCL refuses two ranks a device): 10a which
     c10d collectives gloo takes CUDA tensors in (those the mesh path
     needs must all work); 10b phase 6a's datastore on a 4-rank ("data",)
     mesh, each rank building only its shard: the merged search and the
     search after 6a's inserts and delete equal 6a's in every field, no
     kernel launched, search ms and index bytes a rank; 10c 9b's step-12
     checkpoint restored onto a 2 x 2 (data, model) mesh, each rank's
     shards equal to the same slices of the checkpoint's arrays, then 9b's
     next two steps with its settings, their losses within 1e-4 of 9b's
     and every parameter shard moved, step ms and each rank's peak
     memory, then 9b's checkpoint removed and the mesh's state saved
     (each leaf gathered, rank 0 writing it) and every rank's shards
     checked against the file, save ms and the host memory each rank
     added while saving;
     10d make_serve_step and make_retrieval_serve_step on that mesh with
     the restored weights (8 x 4,096 random cached positions, 8 decode
     steps): in float32 the logits against one rank's within 1e-3
     (MESH_F32_TOL) and the retrieved positions
     equal, every rank launching both path kernels (counted per rank),
     then in bf16 the mesh's logits no further (1.5x) from float32's than
     one rank's; 10e compressed_psum over the ranks against the same
     formula on the host, bit for bit; 10f one nccl rank: 9a's
     configuration on a 1 x 1 mesh, three steps bit-equal to no mesh;
     the phase's seconds;
 11  the dry run (launch/dryrun.py, launch/roofline.py, steps.lower_cell):
     after every other phase, 11a, the five cells at once, each in a
     child process of its own (a fake process group is process-global),
     run_cell on fake CUDA tensors over fake
     groups of 256 ranks (16 x 16) for internlm2-1.8b's train_4k,
     prefill_32k and decode_32k and minitron-8b's long_500k (the
     retrieval cell: one traced call of each search kernel's op), and of
     512 (2 x 16 x 16) for internlm2-1.8b's decode_32k: each OK, with its
     compute / memory / collective ms on the H100 data sheet, bottleneck,
     6·N·D ratio, temp bytes a rank and trace seconds; then in a child of
     its own 11b internlm2-1.8b's CONFIG at 9b's one-card cut (8 x 1,024,
     accum 4) traced by lower_cell and run for real: the traced FLOPs equal
     FlopCounterMode's over a real step, the traced peak within 10% of
     max_memory_allocated over one, the measured step time beside the
     roofline's; 11c the retrieval serve step at 9c's shape traced (one
     call of each kernel's op) and run (exactly one launch of each under
     torch.profiler; counted), each kernel's credited FLOPs and bytes
     beside its device ms, and the host microseconds of a launch through
     its operator against a direct call of the function registered as its
     CUDA kernel.

Kernel times: `ms` is the median of 10 timed wrapper calls (CUDA events
around the call, the L2 flushed before each), so a launch-bound kernel's
`ms` holds the host's time in its wrapper; `device_ms` (the loop kernel,
both count kernels, csr_candidate_topk and candidate_topk) is the median of
the kernel's own durations over 50 back-to-back flushed calls traced by
torch.profiler, the device alone.

Each path runs with every launch counter set to 0 just before it and read
just after (phase 5: before the first insert, and after the mutated
handle's searches; phase 6b: before the decode stream and after it, the
checks of each batch's requests taken off again; phases 7b, 8b and 8c:
around each counted generate; 9c: around its counted steps; 10d: on each
rank, around its float32 retrieval serve steps; 11c: around its profiled
step); a kernel of the path that was never launched fails the run.
Then one {"kernels": [...]} line (per kernel: launches on the paths,
largest error against the plain version, kernel time (and device_ms where
taken) and plain time, the bound
over the distinct bytes and the operations the timed call needs, and the
library call's time where one PyTorch call computes the same function),
the card's name and
power limit as nvidia-smi prints them, and the final {"ok": true, ...}
line.  Any failed check raises and the
script exits non-zero; so does a machine without a card, or a directory
without the repo's src/.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

DEV = torch.device("cuda")
# H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth, float32 outside the
# tensor cores, dense TF32 on the tensor cores.  bound_ms = max(bytes /
# HBM, operations / rate), with each distinct input byte read once and each
# output byte written once; the rate is FP32's, but flash_attention's
# products run on the tensor cores in three-pass TF32 (three TF32
# operations per float32 one).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_TENSOR_OPS_PER_S = 495e12
# kernel name -> (wrapper module and CUDA source under repro_torch, the TPU kernel it replaces)
KERNELS = {
    "radius_search_loop": ("radius_search_loop", "src/repro/kernels/tile_count_multilevel.py:95"),
    "tile_count_multilevel": ("tile_count_multilevel", "src/repro/kernels/tile_count_multilevel.py:95"),
    "csr_candidate_topk": ("csr_candidate_topk", "src/repro/kernels/csr_candidate_topk.py:148"),
    "tile_count": ("tile_count", "src/repro/kernels/tile_count.py:111"),
    "candidate_topk": ("candidate_topk", "src/repro/kernels/candidate_topk.py:72"),
    "csr_shortlist_q8": ("csr_candidate_topk_q8", "src/repro/kernels/csr_candidate_topk_q8.py:179"),
    "brute_knn": ("brute_knn", "src/repro/kernels/brute_knn.py:77"),
    "flash_attention": ("flash_attention", "src/repro/kernels/flash_attention.py:89"),
}
SOURCES = tuple(src for src, _ in KERNELS.values())
FUSED_PATH = ("radius_search_loop", "csr_candidate_topk")  # the kernels `hopper` searches on
NO_PATH = ("flash_attention",)  # no path of the system calls it: phase 4 only
# the kernels phases 6-9 launch besides phases 2, 3 and 5: the kNN-LM
# head's and retrieval memory's `hopper` searches (9c: the retrieval serve
# step's), and `exact` as their recall reference (the `sharded` backend
# launches none: its shards search on `torch`)
PATHS = {name: "phases 2, 3, 5, 6, 7, 8, 9, 10, 11" for name in FUSED_PATH}
PATHS["brute_knn"] = "phases 2, 3, 5, 6, 7, 8"
F32_EPS = float(np.finfo(np.float32).eps)
LOOP_STATS = ("radius", "count", "iters", "converged")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_by_entry(log: str) -> dict:
    """ptxas's registers, static shared memory and spill bytes of each
    entry function it compiled, keyed by the function's (mangled) name."""
    entries: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m[1]
            entries[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            entries[name].update(spill_store_bytes=int(m[1]), spill_load_bytes=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            entries[name].update(registers=int(m[1]), static_smem_bytes=int(smem[1]) if smem else 0)
    return entries


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory and spill stores of a source's entry
    functions, as lists in ptxas's order."""
    entries = ptxas_by_entry(log).values()
    return {key: [e.get(key, 0) for e in entries]
            for key in ("registers", "static_smem_bytes", "spill_store_bytes")}


def ptxas_of(source: str) -> dict:
    """ptxas's registers, static shared memory and spills of each entry
    function of a source built in this run, keyed by its mangled name."""
    from repro_torch.kernels import _build

    return ptxas_by_entry(_build.BUILD_LOG.get(source, {}).get("ptxas", ""))


def check_candidate_static_smem() -> None:
    """The candidate wrappers' shared_bytes count the static arrays of
    kernel_common.cuh's top-k and of the staged score chunk by constants
    (candidate_topk.TOPK_SHARED_BYTES, TOPK_CHUNK): hold them against
    ptxas's static shared memory of every candidate entry function.  The
    staged instances (csr_candidate_topk_kernel<true>,
    candidate_topk_kernel<true>) stage rows, not scores; csr_candidate_topk
    adds the prefix of its window rows' runs (PREFIX_SHARED_BYTES).  A
    source built by an earlier run in this checkout has no ptxas report
    (phase 0 marks it cached); a fresh checkout builds and checks all three."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.candidate_topk import TOPK_CHUNK, TOPK_SHARED_BYTES
    from repro_torch.kernels.csr_candidate_topk import PREFIX_SHARED_BYTES

    for source in ("candidate_topk", "csr_candidate_topk", "csr_candidate_topk_q8"):
        if source not in _build.BUILD_LOG:
            continue
        entries = ptxas_of(source)
        check(bool(entries), f"no ptxas report for {source}")
        for entry, info in entries.items():
            want = TOPK_SHARED_BYTES + (0 if "ILb1E" in entry else 4 * TOPK_CHUNK)
            want += PREFIX_SHARED_BYTES if source == "csr_candidate_topk" else 0
            got = info.get("static_smem_bytes")
            check(got == want, f"{entry}: ptxas gives {got} bytes of static shared memory, "
                               f"the wrappers count {want}")


def kernel_records(prof) -> list[tuple[str, float]]:
    """(name, ms) of each device record (kernels, copies, fills) in a
    finished torch.profiler trace, from its raw kineto records."""
    from torch.autograd import DeviceType

    return [(evt.name(), evt.duration_ns() / 1e6) for evt in prof.profiler.kineto_results.events()
            if evt.device_type() == DeviceType.CUDA]


def device_profile(fn, runs: int = 3) -> dict:
    """Device time of one call from torch.profiler traces: the kernels'
    summed time and the five largest kernels by name, from `runs` traced
    calls.  The tracer can drop records (one search's sum once read 6.17 ms
    where its neighbours read 7.5-7.7), and a call launches the same
    kernels every time, so only the traces with the most records count;
    of those, the one with the median sum."""
    from torch.profiler import ProfilerActivity, profile

    samples = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        records = kernel_records(prof)
        by_name: dict[str, float] = {}
        for name, ms in records:
            by_name[name] = by_name.get(name, 0.0) + ms
        samples.append((len(records), sum(by_name.values()), by_name))
    most = max(n for n, _, _ in samples)
    whole = sorted((s for s in samples if s[0] == most), key=lambda s: s[1])
    by_name = whole[len(whole) // 2][2]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    busy = sum(by_name.values())
    return {"device_busy_ms": busy if busy > 0 else None,
            "top_kernels_ms": {name[:60]: ms for name, ms in top}}


def time_ms(fn, reps: int = 10):
    """(median device time of one call, the warm-up call's result), with
    the 50 MB L2 flushed before each timed call (the main path finds its
    inputs cold)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    out = fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events])), out


def device_ms(fn, kernel: str, reps: int = 50, tries: int = 3) -> float:
    """Median device time of one launch of `kernel` (its entry function's
    name): `fn`, a wrapper's call, runs `reps` times back to back under
    torch.profiler, with the L2 flushed before each call as in time_ms, and
    only the kernel's own CUDA durations count, so neither the flush nor
    the host's time in the wrapper does (a launch-bound kernel's timed call
    is mostly the host's).  The durations come from the trace's raw kineto
    records.  The tracer has been seen to drop records (18 of 50 once); a
    run that keeps fewer than a fifth is taken again, at most `tries`
    times."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    name = re.compile(rf"\b{kernel}\b")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = [ms for kname, ms in kernel_records(prof) if name.search(kname)]
        if len(times) >= reps // 5:
            return float(np.median(times))
    raise AssertionError(f"device_ms: {len(times)} launches of {kernel} traced of {reps}, "
                         f"{tries} times")


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def circle_cells(q_grid, radii, levels, tile, nblks, metric) -> torch.Tensor:
    """The pyramid cells a count at these radii reads, keyed by
    (level, x, y), one key per lane and cell: each lane's clamped T x T
    window at its level (the plain version's window arithmetic), only the
    cells whose centres lie in the circle, since the count kernels load
    only those."""
    dev = q_grid.device
    lv = levels.long()
    side = torch.tensor(nblks, device=dev)[lv] * tile
    scale = (1 << lv).float()
    org = [torch.minimum((torch.floor(q_grid[:, a] / scale).long() - tile // 2).clamp_min(0),
                         side - tile) for a in (0, 1)]
    ar = torch.arange(tile, device=dev)
    xs, ys = (org[0][:, None] + ar)[:, :, None], (org[1][:, None] + ar)[:, None, :]
    sc, r = scale[:, None, None], radii.float()[:, None, None]
    dx = (xs.float() + 0.5) * sc - q_grid[:, 0, None, None]
    dy = (ys.float() + 0.5) * sc - q_grid[:, 1, None, None]
    inside = dx.abs() + dy.abs() <= r if metric == "l1" else dx * dx + dy * dy <= r * r
    s0 = nblks[0] * tile
    return ((lv[:, None, None] * s0 + xs) * s0 + ys)[inside]


def loop_args(tiles, q_grid, r0, k, k_hi, cfg) -> tuple:
    return (tiles, q_grid, r0, k, k_hi, cfg.max_radius, cfg.max_iters, cfg.tile,
            cfg.level_nblks)


def hold_loop(mods, label, args, metric, early_exit=True) -> dict:
    """The loop kernel and its plain version (the lock-step loop) on the
    same card tensors, all four outputs exactly equal, and the reference's
    tile_dmas_skipped from the kernel's outputs (`ref.dmas_skipped`) equal
    to the lock-step loop's own count; returns the plain version's stats."""
    from repro_torch.kernels import ref

    got = mods["radius_search_loop"].radius_search_loop(*args, metric=metric,
                                                        early_exit=early_exit)
    want = ref.radius_search_loop(*args, metric=metric, early_exit=early_exit)
    same_loop_stats(got, want, f"radius_search_loop {label}")
    check(torch.equal(ref.dmas_skipped(got["iters"], got["converged"], early_exit),
                      want["tile_dmas_skipped"]),
          f"radius_search_loop {label}: tile_dmas_skipped differs from the lock-step loop's")
    return want


def same_loop_stats(got: dict, want: dict, what: str) -> None:
    for key in LOOP_STATS:
        check(torch.equal(got[key], want[key]), f"{what}: {key} differs")


def loop_passes(args, metric) -> tuple[dict, list]:
    """The plain version's schedule with its count passes recorded: the
    lock-step loop (core/batched.py) counting through
    ref.tile_count_multilevel, as ref.radius_search_loop does; returns its
    stats and each pass's (radii, live-lane mask), the recount included."""
    from repro_torch.core.batched import lockstep_radius_loop
    from repro_torch.kernels import ref

    tiles, q, r0, k, k_hi, r_max, max_iters, tile, nblks = args
    passes: list = []

    def count(r, active):
        passes.append((r, active))
        levels = ref.level_for_radius(r, tile, len(nblks))
        return ref.tile_count_multilevel(tiles, q, r.float(), levels, tile, nblks,
                                         metric=metric, active=active).sum(-1, dtype=torch.int32)

    return lockstep_radius_loop(count, r0, k, k_hi, r_max, max_iters, masked=True), passes


def time_loop(mods, index, cfg, q_grid, k, shape: str) -> dict:
    """The loop kernel at a path's shape (the global r0), exact against the
    plain version, timed beside it (the wrapper's call with the L2
    flushed, as every kernel here; and the launch alone).  The bound's
    bytes are the distinct cells (C int32 each) that the live lanes of all
    passes of the lock-step schedule and the recount read, counted once
    over the union of the passes (a lane that stays on one level re-reads
    its window from cache) and only inside each pass's circle (the kernel
    loads no other cell), plus the queries and start radii read once and
    the four outputs written once; the operations are ten float operations
    per cell of every live lane's window (the mask) and C adds per cell
    read."""
    from repro_torch.kernels import ref

    b, c, t = q_grid.shape[0], cfg.n_channels, cfg.tile
    k_hi = max(k, math.ceil(k * cfg.k_slack))
    r0 = torch.full((b,), cfg.r0, dtype=torch.int32, device=q_grid.device)
    args = loop_args(index.pyr_tiles, q_grid.contiguous(), r0, k, k_hi, cfg)
    want = hold_loop(mods, shape, args, cfg.metric)
    recorded, passes = loop_passes(args, cfg.metric)
    same_loop_stats(recorded, want, f"the recorded lock-step loop at {shape}")
    kernel = mods["radius_search_loop"].radius_search_loop
    ms, _ = time_ms(lambda: kernel(*args, metric=cfg.metric))
    plain_ms, _ = time_ms(lambda: ref.radius_search_loop(*args, metric=cfg.metric), reps=3)
    # the launch alone, without the wrapper's host time
    kernel_ms = device_ms(lambda: kernel(*args, metric=cfg.metric), "radius_search_loop_kernel")
    cells = [circle_cells(q_grid[act], r[act], ref.level_for_radius(r, t, cfg.levels)[act],
                          t, cfg.level_nblks, cfg.metric) for r, act in passes]
    distinct = int(torch.unique(torch.cat(cells)).numel())
    read = sum(int(x.numel()) for x in cells)
    lane_passes = sum(int(act.sum()) for _, act in passes)
    b_ms, b_by = bound(distinct * c * 4 + b * (8 + 4) + b * (3 * 4 + 1),
                       lane_passes * t * t * 10 + read * c)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "device_ms": kernel_ms, "max_abs_err": 0.0, "shape": shape,
            "passes": len(passes),
            "lane_passes": lane_passes, "cells_read_all_passes": read,
            "distinct_cells_all_passes": distinct,
            "library": "none"}, want


def same_stats(stats: dict, res, what: str, lanes=slice(None)) -> None:
    """A search's Eq.-1 fields equal to loop stats of the same queries."""
    for key in ("radius", "count", "iters", "converged"):
        check(torch.equal(stats[key], getattr(res, key)[lanes]), f"{what}: {key} differs")


def count_at_run(label, searcher, queries, res, mods, chunks: int) -> dict:
    """hopper's count_at at a search's final radii, counted: one
    tile_count_multilevel launch per chunk and nothing else, and each
    lane's total equal to the loop kernel's count (a converged lane's count
    is the count at its final radius; the others were recounted there)."""
    reset(mods)
    cnt = searcher.count_at(queries, res.radius)
    torch.cuda.synchronize()
    launches = counts(mods)
    check(launches["tile_count_multilevel"] == chunks and sum(launches.values()) == chunks,
          f"{label}: count_at launched {launches}, expected {chunks} tile_count_multilevel")
    check(torch.equal(cnt.sum(dim=-1, dtype=torch.int32), res.count),
          f"{label}: count_at's totals differ from the loop kernel's counts")
    return launches


def sha256_of(*tensors) -> str:
    """A digest of the tensors' values: equal digests in two runs (a parent
    and a change) show equal outputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ----------------------------------------------------------------- phase 1 ---


def compare_topk(got, want, store, queries, metric, rtol):
    """Kernel (dists, ids) against plain: distances within rtol, ids equal
    except near-ties — rows whose id lists differ must rank equally far
    rows (recomputed in float64).  Returns (max abs dist error, swaps)."""
    (gd, gi), (wd, wi) = got, want
    check(torch.equal(torch.isinf(gd), torch.isinf(wd)), "pad pattern differs")
    fin = torch.isfinite(wd)
    err = float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(torch.allclose(gd[fin], wd[fin], rtol=rtol, atol=0), f"dists differ ({err})")
    differ = (gi != wi)
    rows = differ.any(dim=1).nonzero().flatten()
    for r in rows.tolist():
        ids = torch.stack([gi[r], wi[r]]).long()
        ok = ids >= 0
        diff = store[ids.clamp_min(0)].double() - queries[r].double()
        d64 = diff.abs().sum(-1) if metric == "l1" else diff.pow(2).sum(-1).sqrt()
        d64 = torch.where(ok, d64, torch.full_like(d64, float("inf")))
        a, b = d64.sort(dim=1).values
        check(torch.allclose(a, b, rtol=rtol, atol=0), f"row {r}: ids differ beyond a tie")
    return err, int(differ.sum())


def compare_knn(got, want, queries, points, min_equal_rows=0.999):
    """brute_knn (dists, ids) against its plain version: the same pads,
    squared distances within 8 float32 ulps of ‖q‖² + max‖x‖² (the form
    cancels, and the product sums in another order than torch.matmul's),
    ids equal on at least `min_equal_rows` of the queries, and every row
    whose ids differ ranks equally far points within that scale
    (recomputed in float64).  Returns (max abs dist error, share of equal
    id rows, rows that differ)."""
    (gd, gi), (wd, wi) = got, want
    check(torch.equal(torch.isinf(gd), torch.isinf(wd)), "brute_knn pad pattern differs")
    check(torch.equal(gi == -1, torch.isinf(gd)), "brute_knn: ids and +inf pads disagree")
    xx = points.double().pow(2).sum(1)
    tol = 8 * F32_EPS * (queries.double().pow(2).sum(1, keepdim=True)
                         + torch.cat([xx[torch.isfinite(xx)], xx.new_zeros(1)]).max())
    fin = torch.isfinite(wd)
    err2 = (gd.double() ** 2 - wd.double() ** 2).abs()
    check(bool((err2 <= tol)[fin].all()), "brute_knn squared distances beyond 8 ulps")
    err = float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0
    same = (gi == wi).all(dim=1)
    frac = float(same.float().mean())
    check(frac >= min_equal_rows, f"brute_knn: only {frac:.5f} of id rows equal")
    rows = (~same).nonzero().flatten()
    for r in rows.tolist():
        ids = torch.stack([gi[r], wi[r]]).long()
        d2 = (points[ids.clamp_min(0)].double() - queries[r].double()).pow(2).sum(-1)
        d2 = torch.where(ids >= 0, d2, torch.full_like(d2, float("inf")))
        a, b = d2.sort(dim=1).values
        check(bool(((a == b) | ((a - b).abs() <= tol[r])).all()),
              f"brute_knn row {r}: ids differ beyond a near-tie")
    return err, frac, int(rows.numel())


def compare_dense(got, want, cand, queries, metric, rtol):
    """compare_topk for candidate_topk's LOCAL slots over dense candidates
    (B, C, d): slots become rows of the flattened (B*C, d) candidates."""
    b, c, d = cand.shape
    off = torch.arange(b, device=cand.device)[:, None] * c

    def flat(ids):
        return torch.where(ids >= 0, ids + off, torch.full_like(off, -1).expand_as(ids))

    return compare_topk((got[0], flat(got[1])), (want[0], flat(want[1])),
                        cand.reshape(b * c, d), queries, metric, rtol)


def two_call_topk(cand, valid, queries, k):
    """candidate_topk's function in PyTorch calls, the yardstick timed
    beside the kernel (no single call computes it): torch.cdist's
    distances, the invalid slots set to +inf, then torch.topk."""
    dist = torch.cdist(queries[:, None, :], cand).squeeze(1)
    return torch.topk(dist.masked_fill(~valid, float("inf")), k, dim=1, largest=False)


def check_equal_pair(got, want, what: str) -> None:
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what} not exactly equal")


def same_result(a, b, what: str, lanes=None) -> None:
    """Every SearchResult field bit-equal (on `lanes`, or all of them)."""
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if lanes is not None:
            x, y = x[lanes], y[lanes]
        check(torch.equal(x, y), f"{what}: {field} differs")


def phase1_loop(seed, cfgs, mods, rows: list, b=4096, n=1_000_000, chunk=2048) -> None:
    """radius_search_loop against ref.radius_search_loop on the card, all
    five stats exactly equal: on indexes of 1M random points at phase 2's
    shape (PAPER_GRID, 4096 queries, k = 11) and at a phase-3 chunk's
    (PROD_GRID, 2048 queries, k = 10), l2 and l1, from the global r0 and
    from adaptive_r0's seeds, early_exit off; 40 channels at PROD_GRID's
    pyramid shape, T = 8 at PROD_GRID's grid; and on PAPER_GRID-shaped edge cases: an empty pyramid
    (n = 0 on every pass: radii double to r_max, every lane runs out of
    iterations), a dense one (radii clamp at 1), counts landing on k and on
    k_hi, and Eq.-1 products r * sqrt(k / n) that fall on a half (k = 1,
    n = 4 at odd r, n = 16 at r = 2 mod 4), which round half to even."""
    import dataclasses

    from repro_torch import api
    from repro_torch.core import projection, pyramid
    from repro_torch.kernels import ref

    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    i32 = dict(dtype=torch.int32, device=DEV)

    def index_of(cfg, spread):
        pts = torch.randn((n, 2), generator=gen, device=DEV) * spread
        labels = torch.randint(0, cfg.n_channels, (n,), generator=gen, **i32)
        return api.ActiveSearcher.build(pts, labels=labels if cfg.n_classes else None, cfg=cfg,
                                        proj=projection.identity_projection(pts),
                                        device=DEV).index

    def grid_of(index, cfg, m, spread):
        q = torch.randn((m, 2), generator=gen, device=DEV) * spread
        return projection.to_grid_coords(index.proj, q, cfg.grid_size).contiguous()

    def held(label, tiles, q_grid, r0, k, k_hi, cfg, early_exit=True, **cover):
        want = hold_loop(mods, label, loop_args(tiles, q_grid, r0, k, k_hi, cfg), cfg.metric,
                         early_exit=early_exit)
        it, conv, rad = want["iters"], want["converged"], want["radius"]
        rows.append({"case": label, "B": q_grid.shape[0], "C": tiles.shape[-1],
                     "levels": cfg.levels, "metric": cfg.metric, "k": k, "k_hi": k_hi,
                     "max_iters": cfg.max_iters, "early_exit": early_exit, "exact": True,
                     "converged": int(conv.sum()),
                     "out_of_iters": int(((it == cfg.max_iters) & ~conv).sum()),
                     "at_radius_1": int((rad == 1).sum()),
                     "at_r_max": int((rad == cfg.max_radius).sum()),
                     "tile_dmas_skipped": int(want["tile_dmas_skipped"]), **cover})
        return want

    def start(cfg, m):
        return torch.full((m,), cfg.r0, **i32)

    paper, prod = cfgs["PAPER_GRID"], cfgs["PROD_GRID"]
    for name, base, k, m, spread in (
            ("PAPER_GRID", paper, 11, b, 1.0), ("PROD_GRID_chunk", prod, 10, chunk, 50.0),
            ("PROD_GRID_40_channels", dataclasses.replace(prod, n_classes=40), 10, chunk, 50.0),
            # T = 8: the kernel's instance for a tile side other than 16
            ("PROD_GRID_tile8", dataclasses.replace(prod, tile=8), 10, chunk, 50.0)):
        index = index_of(base, spread)
        q_grid = grid_of(index, base, m, spread)
        for metric in ("l2", "l1"):
            cfg = dataclasses.replace(base, metric=metric)
            k_hi = max(k, math.ceil(k * cfg.k_slack))
            held(f"{name}_{metric}", index.pyr_tiles, q_grid, start(cfg, m), k, k_hi, cfg)
            held(f"{name}_{metric}_adaptive_r0", index.pyr_tiles, q_grid,
                 pyramid.seed_radius(index, cfg, q_grid, k), k, k_hi, cfg)
        held(f"{name}_no_early_exit", index.pyr_tiles, q_grid, start(base, m), k,
             max(k, math.ceil(k * base.k_slack)), base, early_exit=False)
        if base is paper:
            paper_index, paper_grid = index, q_grid
        else:
            del index

    # edge cases on PAPER_GRID's pyramid shape, phase 2's queries
    shape = paper_index.pyr_tiles.shape[:-1]
    q_grid = paper_grid
    r0 = torch.randint(1, paper.max_radius + 1, (b,), generator=gen, **i32)
    want = held("empty_pyramid", torch.zeros(shape + (1,), **i32), q_grid, r0, 11, 11, paper)
    check(bool((want["radius"] == paper.max_radius).all() & (want["count"] == 0).all()
               & (want["iters"] == paper.max_iters).all()),
          "empty pyramid: a lane did not end at r_max after max_iters with count 0")
    want = held("dense_pyramid", torch.ones(shape + (3,), **i32), q_grid, r0, 1, 1, paper)
    check(bool((want["radius"] == 1).all()), "dense pyramid: a lane did not clamp at r = 1")
    sparse = (torch.rand(shape + (1,), generator=gen, device=DEV) < 0.05).int()
    del paper_index

    def first_pass(r):
        lv = pyramid.level_for_radius(r, paper)
        return ref.tile_count_multilevel(sparse, q_grid, r.float(), lv, paper.tile,
                                         paper.level_nblks).sum(-1)

    r_small = torch.randint(1, 31, (b,), generator=gen, **i32)
    n1 = first_pass(r_small)
    vals = torch.sort(n1[n1 > 0]).values
    k_lo = int(vals[len(vals) // 2])
    above = vals[vals > k_lo]
    k_hi = int(above[len(above) // 2])
    want = held("sparse_k_and_k_hi", sparse, q_grid, r_small, k_lo, k_hi, paper,
                first_pass_at_k=int((n1 == k_lo).sum()), first_pass_at_k_hi=int((n1 == k_hi).sum()))
    conv = want["converged"]
    check(bool((conv & (want["count"] == k_lo)).any() & (conv & (want["count"] == k_hi)).any()),
          "no lane converged with a count of exactly k and of exactly k_hi")
    r_odd = 2 * torch.randint(0, 8, (b,), generator=gen, **i32) + 1
    r_odd[b // 2:] += 1                             # and even radii, 2 mod 4 among them
    n1 = first_pass(r_odd)
    ties = int((((n1 == 4) & (r_odd % 2 == 1)) | ((n1 == 16) & (r_odd % 4 == 2))).sum())
    check(ties > 0, "no first pass falls on a half")
    held("half_even_ties", sparse, q_grid, r_odd, 1, 1, paper, first_pass_ties=ties)


def fa_route(fa, hd: int) -> str:
    """Which flash_attention variant takes head dim hd, in words."""
    hdp = fa.padded_head_dim(hd)
    warps, slices, bk, qmode = fa.TC_VARIANTS[hdp]
    split = f", the head dim split across {slices} warps" if slices > 1 else ""
    return (f"tensor cores, HDP = {hdp}: {warps} warps, {fa.query_tile(hd)} rows, "
            f"{bk}-key tiles, query tile {qmode}{split}")


def phase1(seed, cfgs, mods, b=4096, n=1_000_000, b128=256):
    from repro_torch.core import pyramid
    from repro_torch.kernels import ref

    tcm, csr = mods["tile_count_multilevel"], mods["csr_candidate_topk"]
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"phase": 1, **{name: [] for name in KERNELS}}
    max_err = {name: 0.0 for name in KERNELS}
    phase1_loop(seed, cfgs, mods, out["radius_search_loop"], b=b, n=n)

    for name, cfg in cfgs.items():
        c = cfg.n_channels
        tiles = torch.randint(0, 4, (sum(nb * nb for nb in cfg.level_nblks), cfg.tile,
                                     cfg.tile, c), generator=gen, device=dev, dtype=torch.int32)
        g = cfg.padded_size
        q = torch.rand((b, 2), generator=gen, device=dev) * g
        q[:8] = torch.tensor([[0, 0], [g - 1e-3, g - 1e-3], [0, g - 1e-3], [g - 1e-3, 0],
                              [g / 2, 0], [0, g / 2], [g - 1e-3, g / 2], [g / 2, g - 1e-3]],
                             device=dev)
        radii = torch.randint(0, cfg.max_radius + 1, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        active = torch.rand((b,), generator=gen, device=dev) < 0.5
        for metric in ("l2", "l1"):
            for lv_name, lv in (("own", pyramid.level_for_radius(radii, cfg)),
                                ("every", (torch.arange(b, device=dev) % cfg.levels).int())):
                for act in (None, active):
                    args = (tiles, q, radii.float(), lv, cfg.tile, cfg.level_nblks)
                    got = tcm.tile_count_multilevel(*args, metric=metric, active=act)
                    want = ref.tile_count_multilevel(*args, metric=metric, active=act)
                    check(torch.equal(got, want),
                          f"tile_count_multilevel {name} {metric} {lv_name} differs")
        out["tile_count_multilevel"].append({"grid": name, "B": b, "C": c,
                                             "levels": cfg.levels, "exact": True})

    # both count kernels past 32 channels: 40 at PROD_GRID's pyramid shape
    # (the 1024 grid: 224 MB of tiles), every level, exact
    many, wide_c = cfgs["PROD_GRID"], 40
    tiles = torch.randint(0, 4, (sum(nb * nb for nb in many.level_nblks), many.tile, many.tile,
                                 wide_c), generator=gen, device=dev, dtype=torch.int32)
    g = many.padded_size
    q = torch.rand((b, 2), generator=gen, device=dev) * g
    radii = torch.randint(0, many.max_radius + 1, (b,), generator=gen, device=dev,
                          dtype=torch.int32).float()
    lv = (torch.arange(b, device=dev) % many.levels).int()
    for metric in ("l2", "l1"):
        args = (tiles, q, radii, lv, many.tile, many.level_nblks)
        check(torch.equal(tcm.tile_count_multilevel(*args, metric=metric),
                          ref.tile_count_multilevel(*args, metric=metric)),
              f"tile_count_multilevel at {wide_c} channels {metric} differs")
    out["tile_count_multilevel"].append({"grid": "PROD_GRID", "B": b, "C": wide_c,
                                         "levels": many.levels, "exact": True})
    del tiles
    for lvl in range(many.levels):
        side = g >> lvl
        level = torch.randint(0, 4, (side, side, wide_c), generator=gen, device=dev,
                              dtype=torch.int32)
        args = (level, q, radii, 1 << lvl, many.tile)
        check(torch.equal(mods["tile_count"].tile_count(*args), ref.tile_count(*args)),
              f"tile_count at {wide_c} channels, level {lvl}, differs")
    out["tile_count"].append({"grid": "PROD_GRID", "B": b, "C": wide_c, "levels": many.levels,
                              "metrics": ["l2"], "exact": True})

    # csr_candidate_topk: paper-mode / refined d=2 at PAPER_GRID's window,
    # refined d=128 at PROD_GRID's, plus k > w*row_cap and the live boundary
    def spans(b, w, rcap, n):
        st = torch.randint(0, n, (b, w), generator=gen, device=dev, dtype=torch.int32)
        ln = torch.randint(0, rcap + 8, (b, w), generator=gen, device=dev, dtype=torch.int32)
        return st, torch.minimum(st + ln, torch.tensor(n, device=dev)).int()

    paper, prod = cfgs["PAPER_GRID"], cfgs["PROD_GRID"]
    cases = []
    crd = torch.rand((n, 2), generator=gen, device=dev) * paper.grid_size
    st, en = spans(b, paper.window, paper.row_cap, n)
    qg = torch.rand((b, 2), generator=gen, device=dev) * paper.grid_size
    rad = torch.randint(1, 200, (b,), generator=gen, device=dev).float()
    cases.append(("d2_paper", (crd, st, en, qg, 11, n, paper.row_cap),
                  dict(radii=rad, center_cells=True), 0.0))
    cases.append(("d2_refined", (crd, st, en, qg, 11, n, paper.row_cap), {}, 0.0))
    pts = torch.randn((n, 128), generator=gen, device=dev)
    st, en = spans(b128, prod.window, prod.row_cap, n)
    q128 = torch.randn((b128, 128), generator=gen, device=dev)
    for metric in ("l2", "l1"):
        cases.append((f"d128_refined_{metric}", (pts, st, en, q128, 10, n, prod.row_cap),
                      dict(metric=metric), 1e-5))
    st, en = spans(b128, 2, 4, 4096)
    cases.append(("k_exceeds_window", (pts[:4096], st, en, q128, 11, 4096, 4), {}, 1e-5))
    st, en = spans(b128, prod.window, prod.row_cap, 4096)
    cases.append(("live_boundary", (pts[:4096], st, en, q128, 10, 3000, prod.row_cap), {}, 1e-5))
    for label, args, kw, rtol in cases:
        got = csr.csr_candidate_topk(*args, **kw)
        want = ref.csr_candidate_topk(*args, **kw)
        if rtol == 0.0:
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"csr_candidate_topk {label} not exactly equal")
            err, swaps = 0.0, 0
        else:
            err, swaps = compare_topk(got, want, args[0], args[3], kw.get("metric", "l2"), rtol)
        if label == "live_boundary":
            live = got[1][got[1] >= 0]
            check(bool((live < 3000).all()), "a pad row surfaced past the live count")
        max_err["csr_candidate_topk"] = max(max_err["csr_candidate_topk"], err)
        out["csr_candidate_topk"].append({"case": label, "B": args[1].shape[0],
                                          "w": args[1].shape[1], "row_cap": args[6],
                                          "d": args[0].shape[1], "k": args[4],
                                          "smem_bytes": csr.shared_bytes(args[0].shape[1],
                                                                         args[1].shape[1], args[6]),
                                          "max_abs_err": err, "tie_swaps": swaps})

    # tile_count: every level of PAPER_GRID's pyramid shape, l1 and l2, the
    # grid corners among the queries
    tc = mods["tile_count"]
    c = paper.n_channels
    g = paper.padded_size
    q = torch.rand((b, 2), generator=gen, device=dev) * g
    q[:4] = torch.tensor([[0, 0], [g - 1e-3, g - 1e-3], [0, g - 1e-3], [g - 1e-3, 0]], device=dev)
    radii = torch.rand((b,), generator=gen, device=dev) * paper.max_radius
    for lv in range(paper.levels):
        side = g >> lv
        level = torch.randint(0, 4, (side, side, c), generator=gen, device=dev, dtype=torch.int32)
        for metric in ("l2", "l1"):
            args = (level, q, radii, 1 << lv, paper.tile)
            check(torch.equal(tc.tile_count(*args, metric=metric),
                              ref.tile_count(*args, metric=metric)),
                  f"tile_count level {lv} {metric} differs")
    out["tile_count"].append({"grid": "PAPER_GRID", "B": b, "C": c, "levels": paper.levels,
                              "metrics": ["l2", "l1"], "exact": True})
    # both instances (T = 16 with shifts, the generic one at T = 8) at 40
    # channels (lanes 0-31, then 0-7, write them), one query and a batch
    # that is not a multiple of the queries per block, scales 1 and 4
    side = 512
    level = torch.randint(0, 4, (side, side, wide_c), generator=gen, device=dev, dtype=torch.int32)
    for tt in (8, 16):
        for scale in (1, 4):
            for bq in (1, 4097):
                qq = torch.rand((bq, 2), generator=gen, device=dev) * (side * scale)
                rq = torch.rand((bq,), generator=gen, device=dev) * (tt * scale / 2)
                for metric in ("l2", "l1"):
                    args = (level, qq, rq, scale, tt)
                    check(torch.equal(tc.tile_count(*args, metric=metric),
                                      ref.tile_count(*args, metric=metric)),
                          f"tile_count T={tt} scale={scale} B={bq} {metric} differs")
    out["tile_count"].append({"level": [side, side, wide_c], "T": [8, 16], "scale": [1, 4],
                              "B": [1, 4097], "metrics": ["l2", "l1"], "exact": True})
    del level

    # csr_shortlist_q8: a random int8 store with per-row scales; queries
    # large enough that some codes clip at QCLIP.  Bit-equal.
    q8 = mods["csr_shortlist_q8"]

    def q8_store(rows, d):
        codes = torch.randint(-127, 128, (rows, d), generator=gen, device=dev).to(torch.int8)
        return codes, torch.rand((rows, 1), generator=gen, device=dev) * 0.05 + 0.001

    codes128, scales128 = q8_store(n, 128)
    codes2, scales2 = q8_store(n, 2)
    st128, en128 = spans(b128, prod.window, prod.row_cap, n)
    st2, en2 = spans(b, paper.window, paper.row_cap, n)
    stb, enb = spans(b128, prod.window, prod.row_cap, 4096)
    q2 = torch.randn((b, 2), generator=gen, device=dev) * 2.0
    qcases = []
    for metric in ("l2", "l1"):
        for dc in (None, 48):
            qcases.append((f"d128_{metric}_dchunk{dc}", (codes128, scales128, st128, en128,
                                                         q128 * 2.0, 40, n, prod.row_cap),
                           dict(metric=metric, d_chunk=dc)))
        for dc in (None, 1):
            qcases.append((f"d2_{metric}_dchunk{dc}", (codes2, scales2, st2, en2, q2, 44, n,
                                                       paper.row_cap),
                           dict(metric=metric, d_chunk=dc)))
    qcases.append(("live_boundary", (codes128[:4096], scales128[:4096], stb, enb, q128 * 2.0,
                                     40, 3000, prod.row_cap), {}))
    for label, args, kw in qcases:
        got = q8.csr_shortlist_q8(*args, **kw)
        check_equal_pair(got, ref.csr_shortlist_q8(*args, **kw), f"csr_shortlist_q8 {label}")
        if label == "live_boundary":
            live = got[1][got[1] >= 0]
            check(bool((live < 3000).all()), "q8: a pad row surfaced past the live count")
        out["csr_shortlist_q8"].append({"case": label, "B": args[2].shape[0],
                                        "w": args[2].shape[1], "row_cap": args[7],
                                        "d": args[0].shape[1], "rerank_k": args[5],
                                        "exact": True})

    # candidate_topk: dense candidates at the gather shape (C = w*row_cap at
    # d=128 and at d=2) and the q8 re-rank shape (C = rerank_k)
    ctk = mods["candidate_topk"]
    dcases = [
        ("gather_d128_l2", (b128, prod.window * prod.row_cap, 128), 10, "l2", 1e-5),
        ("gather_d128_l1", (b128, prod.window * prod.row_cap, 128), 10, "l1", 1e-5),
        ("rerank_d128", (2048, 40, 128), 10, "l2", 1e-5),
        ("gather_d2", (b, paper.window * paper.row_cap, 2), 11, "l2", 0.0),
        ("gather_d2_l1", (b, paper.window * paper.row_cap, 2), 11, "l1", 0.0),
    ]
    for label, shape, k, metric, rtol in dcases:
        cand = torch.randn(shape, generator=gen, device=dev)
        valid = torch.rand(shape[:2], generator=gen, device=dev) < 0.8
        qd = torch.randn((shape[0], shape[2]), generator=gen, device=dev)
        args = (cand, valid, qd, k)
        got = ctk.candidate_topk(*args, metric=metric)
        want = ref.candidate_topk(*args, metric=metric)
        if rtol == 0.0:
            check_equal_pair(got, want, f"candidate_topk {label}")
            err, swaps = 0.0, 0
        else:
            err, swaps = compare_dense(got, want, cand, qd, metric, rtol)
        max_err["candidate_topk"] = max(max_err["candidate_topk"], err)
        out["candidate_topk"].append({"case": label, "B": shape[0], "C": shape[1], "d": shape[2],
                                      "k": k, "metric": metric,
                                      "smem_bytes": ctk.shared_bytes(shape[2], shape[1]),
                                      "max_abs_err": err, "tie_swaps": swaps})
        del cand

    # candidate_topk and csr_candidate_topk on the SAME rows: the fused
    # window's rows, materialised, give bit-equal distances and rows
    st, en = spans(b128, prod.window, prod.row_cap, n)
    flat, valid = ref.window_slots(st, en, n, n, prod.row_cap)
    cand = pts[flat]
    for dc in (None, 48, 5):
        fused = csr.csr_candidate_topk(pts, st, en, q128, 10, n, prod.row_cap, d_chunk=dc)
        dense = ctk.candidate_topk(cand, valid, q128, 10, d_chunk=dc or 128)
        check(torch.equal(dense[0], fused[0])
              and torch.equal(ref.take_slots(flat, dense[1]), fused[1]),
              f"candidate_topk and csr_candidate_topk differ on the same rows (d_chunk={dc})")
    out["candidate_topk"].append({"case": "same_rows_as_csr_candidate_topk", "B": b128,
                                  "C": prod.window * prod.row_cap, "d": 128,
                                  "d_chunks": [None, 48, 5], "bit_equal": True})
    # past the old kernels' shared-memory caps (4*d + 8*w*row_cap and
    # 4*d + 4*C <= 232,448 bytes): windows of 32,768 and 65,536 slots; spans
    # clamped at the store's start (< 0) and end (> n_pad - row_cap), a
    # quarter of the queries with no valid slot, a live count below the
    # store; unaligned rows (d = 2, 9, 13 in float32, 130 in int8), d_chunk =
    # 5, k and rerank_k = 1, 257 and past (or, for rerank_k, all of) the window
    def wide_spans(b, w, rcap, n):
        st = torch.randint(-8, n, (b, w), generator=gen, device=dev, dtype=torch.int32)
        st[:, 0] = n - 3  # clamped at the store's end
        ln = torch.randint(0, rcap + 8, (b, w), generator=gen, device=dev, dtype=torch.int32)
        en = torch.minimum(st + ln, torch.tensor(n, device=dev)).int()
        en[: b // 4] = st[: b // 4]
        return st, en

    def runs_of_scales(rows):  # per-cell scales: runs of 16 rows share one
        return (torch.rand((rows // 16 + 1, 1), generator=gen, device=dev) * 0.05 + 0.001
                ).repeat_interleave(16, dim=0)[:rows].contiguous()

    wcases = []
    st32, en32 = wide_spans(64, 512, 64, 200_000)
    st64, en64 = wide_spans(32, 1024, 64, 400_000)
    sts, ens = wide_spans(256, 64, 64, 50_000)
    x16 = torch.randn((200_000, 16), generator=gen, device=dev)
    x9, x13 = (torch.randn((50_000, dd), generator=gen, device=dev) for dd in (9, 13))
    q64 = torch.randn((64, 16), generator=gen, device=dev)
    wcases.append(("window_32768_d16", (x16, st32, en32, q64, 10, 199_993, 64), {}, 1e-5))
    wcases.append(("window_32768_d2_paper", (crd[:200_000], st32, en32, qg[:64], 11,
                                             199_993, 64),
                   dict(radii=rad[:64], center_cells=True), 0.0))
    for kk in (1, 257, 1024 * 64 + 3):
        wcases.append((f"window_65536_d128_k{kk}", (pts[:400_000], st64, en64, q128[:32], kk,
                                                    399_993, 64), {}, 1e-5))
    for metric in ("l2", "l1"):
        wcases.append((f"d9_dchunk5_{metric}", (x9, sts, ens, q128[:, :9].contiguous(), 10,
                                                49_993, 64), dict(metric=metric, d_chunk=5), 1e-5))
    wcases.append(("d13_k257", (x13, sts, ens, q128[:, :13].contiguous(), 257, 49_993, 64), {},
                   1e-5))
    # d = 37: staged rows that are not 16-byte aligned (4-byte copies), a
    # partial last stage, and chunk boundaries inside stages
    x37 = torch.randn((50_000, 37), generator=gen, device=dev)
    wcases.append(("d37_dchunk5", (x37, sts, ens, q128[:, :37].contiguous(), 10, 49_993, 64),
                   dict(d_chunk=5), 1e-5))
    for label, args, kw, rtol in wcases:
        got = csr.csr_candidate_topk(*args, **kw)
        want = ref.csr_candidate_topk(*args, **kw)
        if rtol == 0.0:
            check_equal_pair(got, want, f"csr_candidate_topk {label}")
            err, swaps = 0.0, 0
        else:
            err, swaps = compare_topk(got, want, args[0], args[3], kw.get("metric", "l2"), rtol)
        live = got[1][got[1] >= 0]
        check(bool((live < args[5]).all()), f"csr_candidate_topk {label}: a pad row surfaced")
        max_err["csr_candidate_topk"] = max(max_err["csr_candidate_topk"], err)
        out["csr_candidate_topk"].append({"case": label, "B": args[1].shape[0],
                                          "w": args[1].shape[1], "row_cap": args[6],
                                          "d": args[0].shape[1], "k": args[4],
                                          "smem_bytes": csr.shared_bytes(args[0].shape[1],
                                                                         args[1].shape[1], args[6]),
                                          "max_abs_err": err, "tie_swaps": swaps})
        del got, want
    # the same rows once more at d = 37: both kernels stage them by 4-byte
    # copies, with chunk boundaries inside stages
    flat37, valid37 = ref.window_slots(sts, ens, 50_000, 49_993, 64)
    q37 = q128[:, :37].contiguous()
    fused = csr.csr_candidate_topk(x37, sts, ens, q37, 10, 49_993, 64, d_chunk=5)
    dense = ctk.candidate_topk(x37[flat37], valid37, q37, 10, d_chunk=5)
    check(torch.equal(dense[0], fused[0]) and torch.equal(ref.take_slots(flat37, dense[1]), fused[1]),
          "candidate_topk and csr_candidate_topk differ on the same rows (d = 37, d_chunk = 5)")
    out["candidate_topk"].append({"case": "same_rows_as_csr_candidate_topk", "B": 256,
                                  "C": 64 * 64, "d": 37, "d_chunks": [5], "bit_equal": True})
    del flat37, valid37, fused, dense

    c16 = torch.randint(-127, 128, (200_000, 16), generator=gen, device=dev).to(torch.int8)
    c130 = torch.randint(-127, 128, (50_000, 130), generator=gen, device=dev).to(torch.int8)
    s16, s130, s128 = runs_of_scales(200_000), runs_of_scales(50_000), runs_of_scales(400_000)
    qw = []
    qw.append(("window_32768_d16", (c16, s16, st32, en32, q64 * 2.0, 40, 199_993, 64), {}))
    for rk in (1, 257, 1024 * 64):
        qw.append((f"window_65536_d128_rk{rk}", (codes128[:400_000], s128, st64, en64,
                                                 q128[:32] * 2.0, rk, 399_993, 64), {}))
    q130 = torch.randn((256, 130), generator=gen, device=dev) * 2.0
    for metric in ("l2", "l1"):
        for dc in (None, 5):
            qw.append((f"d130_{metric}_dchunk{dc}", (c130, s130, sts, ens, q130, 40, 49_993, 64),
                       dict(metric=metric, d_chunk=dc)))
    for label, args, kw in qw:
        got = q8.csr_shortlist_q8(*args, **kw)
        check_equal_pair(got, ref.csr_shortlist_q8(*args, **kw), f"csr_shortlist_q8 {label}")
        live = got[1][got[1] >= 0]
        check(bool((live < args[6]).all()), f"q8 {label}: a pad row surfaced")
        out["csr_shortlist_q8"].append({"case": label, "B": args[2].shape[0],
                                        "w": args[2].shape[1], "row_cap": args[7],
                                        "d": args[0].shape[1], "rerank_k": args[5],
                                        "smem_bytes": q8.shared_bytes(args[0].shape[1],
                                                                      args[2].shape[1], args[7]),
                                        "exact": True})
    del x16, x9, x13, x37, c16, c130, s16, s130, s128

    # candidate_topk past the old cap (C = 65,536), on unaligned rows (d = 9
    # and 13 read directly, 37 staged by 4-byte copies), three tiles with a
    # partial last one, and on windows that start 4 bytes past a 16-byte
    # boundary (a slice of a larger tensor: 4-byte copies at d = 128), at
    # the re-rank shape and with d_chunk = 5
    for label, shape, kk, dc, offset in (
            ("C65536_d4_k1", (16, 65_536, 4), 1, 512, 0),
            ("C65536_d4_k257", (16, 65_536, 4), 257, 512, 0),
            ("C65536_d4_k_past_C", (16, 65_536, 4), 65_539, 512, 0),
            ("C65536_d128_k257", (8, 65_536, 128), 257, 512, 0),
            ("C4096_d9_dchunk5", (64, 4096, 9), 10, 5, 0),
            ("C4096_d13_k257", (64, 4096, 13), 257, 512, 0),
            ("C4096_d37_dchunk5", (64, 4096, 37), 10, 5, 0),
            ("C600_d128_k_past_C", (256, 600, 128), 603, 512, 0),
            ("misaligned_rerank_d128", (2048, 40, 128), 10, 128, 1),
            ("misaligned_C600_d128_dchunk5", (256, 600, 128), 10, 5, 1)):
        numel = shape[0] * shape[1] * shape[2]
        cand_w = torch.randn((numel + offset,), generator=gen, device=dev)[offset:].view(shape)
        valid_w = torch.rand(shape[:2], generator=gen, device=dev) < 0.8
        valid_w[0] = False  # a query with no valid candidate
        qd = torch.randn((shape[0], shape[2]), generator=gen, device=dev)
        got = ctk.candidate_topk(cand_w, valid_w, qd, kk, d_chunk=dc)
        want = ref.candidate_topk(cand_w, valid_w, qd, kk, d_chunk=dc)
        err, swaps = compare_dense(got, want, cand_w, qd, "l2", 1e-5)
        max_err["candidate_topk"] = max(max_err["candidate_topk"], err)
        out["candidate_topk"].append({"case": label, "B": shape[0], "C": shape[1], "d": shape[2],
                                      "k": kk, "d_chunk": dc, "metric": "l2",
                                      "base_offset_bytes": 4 * offset,
                                      "smem_bytes": ctk.shared_bytes(shape[2], shape[1]),
                                      "max_abs_err": err, "tie_swaps": swaps})
        del cand_w, valid_w, got, want
    del pts, crd, codes128, codes2, cand

    # brute_knn: random points at the exact paths' d (2, 128) and k (11,
    # 10), the tests' d, k past a warp's 32 lanes (33, 64, 257 at d = 9 and
    # 128; 1000 at a small N), k > N, no points at all, non-finite rows, and
    # integer lattices where every distance is exact and ties take the lower
    # index (and the all-pad cases, which are exact too)
    bk = mods["brute_knn"]
    kcases = [("d2_k11", 4096, 262_147, 2, 11, "normal"), ("d128_k10", 1000, 65_537, 128, 10, "normal"),
              ("d40_k20", 300, 5000, 40, 20, "normal"), ("k_exceeds_n", 37, 13, 7, 20, "normal"),
              ("no_points", 5, 0, 3, 4, "empty"),
              ("non_finite_rows", 64, 500, 4, 8, "nan"), ("k1000_small_n", 20, 1500, 4, 1000, "normal"),
              ("lattice_d2", 500, 3000, 2, 11, "lattice"), ("lattice_d5", 200, 3000, 5, 20, "lattice"),
              ("lattice_d3_k64", 300, 3000, 3, 64, "lattice")]
    kcases += [(f"d{kd}_k{kk}", 1000, 5000, kd, kk, "normal") for kd in (9, 128) for kk in (32, 33, 64, 257)]
    for label, kb, kn, kd, kk, kind in kcases:
        if kind == "lattice":
            kq = torch.randint(0, 8, (kb, kd), generator=gen, device=dev).float()
            kx = torch.randint(0, 8, (kn, kd), generator=gen, device=dev).float()
        else:
            kq = torch.randn((kb, kd), generator=gen, device=dev)
            kx = torch.randn((kn, kd), generator=gen, device=dev)
        if kind == "nan":
            kx[3] = float("nan")
            kx[5, 0] = float("inf")
        got = bk.brute_knn(kq, kx, kk)
        want = ref.brute_knn(kq, kx, kk)
        bit = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if kind in ("lattice", "empty"):
            check(bit, f"brute_knn {label} not exactly equal")
        if kind == "nan":
            check(not bool(((got[1] == 3) | (got[1] == 5)).any()), "brute_knn ranked a non-finite row")
        err, frac, differ = compare_knn(got, want, kq, kx)
        max_err["brute_knn"] = max(max_err["brute_knn"], err)
        out["brute_knn"].append({"case": label, "B": kb, "N": kn, "d": kd, "k": kk,
                                 "max_abs_err": err, "id_rows_equal": frac,
                                 "rows_differ": differ, "bit_equal": bit})

    # flash_attention: the reference tests' shapes, ragged tiles (100 / 70
    # rows), head dims 16-1024 on the tensor cores, causal and full, bf16;
    # float32 within 2e-5
    fa = mods["flash_attention"]
    fcases = [(2, 64, 64, 4, 32, True, torch.float32), (2, 32, 96, 3, 16, False, torch.float32),
              (1, 256, 256, 1, 128, True, torch.float32), (1, 100, 100, 2, 48, True, torch.float32),
              (1, 100, 70, 2, 20, False, torch.float32), (1, 64, 64, 2, 32, True, torch.bfloat16),
              (1, 70, 100, 2, 20, True, torch.float32), (1, 128, 128, 2, 36, True, torch.float32),
              # wide heads on the tensor cores: stablelm-12b's hd = 160, 129
              # and 131 (4-byte copies), 200 and 256, ragged, causal with
              # S < T, bf16
              (1, 256, 256, 2, 160, True, torch.float32), (1, 200, 130, 2, 160, False, torch.float32),
              (1, 256, 256, 2, 256, True, torch.float32), (1, 100, 100, 2, 129, True, torch.float32),
              (1, 100, 70, 2, 131, False, torch.float32), (1, 70, 100, 2, 160, True, torch.float32),
              (1, 130, 130, 1, 200, False, torch.float32), (1, 100, 70, 2, 256, False, torch.float32),
              (1, 70, 100, 1, 200, True, torch.float32), (1, 64, 64, 2, 160, True, torch.bfloat16),
              (1, 100, 70, 2, 256, False, torch.bfloat16),
              # hd 257-1024, the head dim split across warps: 257 and 301
              # (4-byte copies), 384, 512, 1000, 1024, ragged, causal with
              # S < T, bf16
              (1, 96, 96, 1, 512, True, torch.float32), (1, 40, 70, 1, 1000, False, torch.float32),
              (1, 100, 70, 2, 257, False, torch.float32), (1, 70, 100, 2, 301, True, torch.float32),
              (1, 130, 130, 2, 384, True, torch.float32), (1, 64, 64, 2, 384, True, torch.bfloat16),
              (1, 100, 70, 2, 512, False, torch.bfloat16), (1, 50, 90, 1, 1024, True, torch.float32),
              (1, 90, 50, 1, 1024, False, torch.float32), (1, 40, 40, 1, 1024, True, torch.bfloat16),
              # 70,000 heads
              (1, 4, 4, 70_000, 16, False, torch.float32),
              # B·H = 70,400 (> grid.y's 65,535)
              (1100, 8, 8, 64, 16, True, torch.float32), (1100, 8, 8, 64, 160, True, torch.float32),
              (1100, 8, 8, 64, 512, True, torch.float32)]
    for fb, fs, ft, fh, fhd, causal, dtype in fcases:
        fq, fk, fv = (torch.randn((fb, n_, fh, fhd), generator=gen, device=dev).to(dtype)
                      for n_ in (fs, ft, ft))
        got = fa.flash_attention(fq, fk, fv, causal=causal)
        want = ref.flash_attention(fq, fk, fv, causal=causal)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        check(got.dtype == dtype and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention {(fb, fs, ft, fh, fhd, causal, dtype)} differs")
        err = float((got.float() - want.float()).abs().max())
        max_err["flash_attention"] = max(max_err["flash_attention"], err)
        out["flash_attention"].append({"shape": [fb, fs, ft, fh, fhd], "causal": causal,
                                       "dtype": str(dtype), "tol": tol, "max_abs_err": err,
                                       "route": fa_route(fa, fhd)})
    # query tiles over several launches: 2 tiles per launch, S of 5 tiles,
    # so 3 launches (heaviest first), one counted call; at hd = 64, 128, 160, 512
    for causal, fhd in ((c, d) for d in (64, 128, 160, 512) for c in (True, False)):
        fs = 4 * fa.query_tile(fhd) + 44
        fq, fk, fv = (torch.randn((2, fs, 3, fhd), generator=gen, device=dev) for _ in range(3))
        got = fa.flash_attention(fq, fk, fv, causal=causal, _tiles_per_launch=2)
        grids = fa.last_grids
        want = ref.flash_attention(fq, fk, fv, causal=causal)
        check(grids == 3, f"flash_attention at 2 tiles per launch started {grids} grids, not 3")
        check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
              f"flash_attention over 3 launches (causal={causal}, hd={fhd}) differs")
        err = float((got - want).abs().max())
        max_err["flash_attention"] = max(max_err["flash_attention"], err)
        out["flash_attention"].append({"shape": [2, fs, fs, 3, fhd], "causal": causal,
                                       "dtype": "torch.float32", "tol": 2e-5, "max_abs_err": err,
                                       "route": fa_route(fa, fhd), "tiles_per_launch": 2,
                                       "grids": grids})
    # registers and spills of each head-dim variant (flash_attention_kernel<HDP>);
    # none may spill (a rerun that reuses the built library has no report)
    from repro_torch.kernels import _build
    variants = {}
    for entry, info in ptxas_by_entry(_build.BUILD_LOG.get("flash_attention", {})
                                      .get("ptxas", "")).items():
        if m := re.search(r"flash_attention_kernelILi(\d+)E", entry):
            variants[f"HDP={m[1]}"] = info
        check(info.get("spill_store_bytes", 0) == 0 and info.get("spill_load_bytes", 0) == 0,
              f"flash_attention variant {entry} spills: {info}")
    out["flash_attention_variants"] = variants
    emit(out)
    return max_err


# ------------------------------------------------------------ phases 2, 3 ----


def recall(got: torch.Tensor, truth: torch.Tensor, k: int) -> float:
    g, t = to_np(got), to_np(truth)
    hits = [len(set(a[a >= 0]) & set(b[b >= 0])) for a, b in zip(g, t)]
    return float(np.sum(hits) / (k * len(g)))


def counts(mods) -> dict:
    return {name: mod.launches for name, mod in mods.items()}


def reset(mods) -> None:
    for mod in mods.values():
        mod.launches = 0


def on_card(*tensors) -> bool:
    return all(t.device.type == DEV.type for t in tensors)


def idle(prof: dict, search_ms: float) -> dict:
    busy = prof["device_busy_ms"]
    share = None if busy is None else max(0.0, 1.0 - busy / search_ms)
    return {**prof, "device_idle_share": share}


def search_wall_ms(searcher, queries, k, reps: int = 5) -> dict:
    """Host-clock time of whole searches (each ends in a synchronize):
    median, min and max of `reps` runs."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        searcher.search(queries, k)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return {"median": float(np.median(walls)), "min": min(walls), "max": max(walls)}


def run_main_path(label, searcher, queries, k, mods, classify: bool, expect=None):
    """Search (and classify) on the card with the launch counters zeroed
    just before; returns the results, timings and the counts just after,
    then the wall time of five more searches (not counted).  Every kernel
    in `expect` (default: all) must have launched, a search one
    radius_search_loop per chunk and no tile_count_multilevel."""
    searcher.search(queries, k)                             # warm-up, not counted
    torch.cuda.synchronize()
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    res = searcher.search(queries, k)
    torch.cuda.synchronize()
    per_search = counts(mods)
    chunks = -(-queries.shape[0] // (searcher.plan.chunk_size or queries.shape[0]))
    check(per_search["radius_search_loop"] == chunks and per_search["tile_count_multilevel"] == 0,
          f"{label}: a search launched {per_search}, expected one radius_search_loop per "
          f"chunk ({chunks}) and no tile_count_multilevel")
    check(on_card(*res), f"{label}: search output left the card")
    out = {"search": res, "per_search": per_search}
    if classify:
        out["paper"] = searcher.classify(queries, k, mode="paper")
        out["refined"] = searcher.classify(queries, k, mode="refined")
        torch.cuda.synchronize()
        check(on_card(out["paper"], out["refined"]), f"{label}: classes left the card")
    out["launches"] = counts(mods)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for name in expect or mods:
        check(out["launches"][name] > 0, f"{label}: kernel {name} was never launched on its path")
    out["search_wall_ms"] = search_wall_ms(searcher, queries, k)
    return out


def float64_agreement(queries, points, ids, k, block=65_536) -> float:
    """Share of queries whose ids equal their k nearest points by float64
    distance (lower index first on ties): how exact `exact` is, given that
    its float32 ‖q‖² − 2q·x + ‖x‖² cancels."""
    q = queries.double()
    best_d = torch.empty((q.shape[0], 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for off in range(0, points.shape[0], block):
        blk = points[off:off + block].double()
        d = torch.cdist(q, blk, compute_mode="use_mm_for_euclid_dist")
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, torch.arange(off, off + blk.shape[0],
                                                device=q.device).expand(q.shape[0], -1)], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d, best_i = torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)
    return float((best_i == ids.long()).all(dim=1).float().mean())


def run_exact(label, searcher, queries, k, mods, classify: bool):
    """The `exact` backend on the card, its search (and classify) counted
    with the launch counters zeroed just before and read just after: only
    brute_knn may launch, once per chunk of each call.  Then its wall time
    (median of 3); the plain version — the route `exact` took before the
    kernel — over the same chunks, timed once on the host clock (the
    "before"); both outputs held against each other on every query; and
    the kernel and the plain version timed at the path's chunk shape.
    Returns (search result, classes, launches, record)."""
    from repro_torch.kernels import ref

    ex = searcher.with_plan(backend="exact")
    ex.search(queries, k)                                   # warm-up, not counted
    torch.cuda.synchronize()
    reset(mods)
    truth = ex.search(queries, k)
    cls = ex.classify(queries, k) if classify else None
    torch.cuda.synchronize()
    launches = counts(mods)
    chunk = ex.plan.chunk_size or queries.shape[0]
    calls = (2 if classify else 1) * -(-queries.shape[0] // chunk)
    check(launches["brute_knn"] == calls and sum(launches.values()) == calls,
          f"{label} exact: launched {launches}, expected {calls} brute_knn")
    check(on_card(truth.ids, truth.dists), f"{label} exact: output left the card")
    wall = search_wall_ms(ex, queries, k, reps=3)

    pts = ex._exact_ordered[0]
    bk = mods["brute_knn"].brute_knn
    parts = queries.split(chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [ref.brute_knn(qc, pts, k) for qc in parts]
    torch.cuda.synchronize()
    plain_wall = 1e3 * (time.perf_counter() - t0)
    got = [bk(qc, pts, k) for qc in parts]
    err, frac, differ = compare_knn(
        (torch.cat([g[0] for g in got]), torch.cat([g[1] for g in got])),
        (torch.cat([w[0] for w in want]), torch.cat([w[1] for w in want])), queries, pts)
    f64 = float64_agreement(parts[0], pts, got[0][1], k)
    del got, want

    qt = parts[0].contiguous()
    b, d = qt.shape
    n = pts.shape[0]
    ms, _ = time_ms(lambda: bk(qt, pts, k))
    plain_ms, _ = time_ms(lambda: ref.brute_knn(qt, pts, k), reps=2)
    # yardstick only (the port never calls it): no single PyTorch call
    # computes kNN, so two library calls, the (B, N) float32 distance matrix
    # and a top-k over it
    two_call_ms, _ = time_ms(lambda: torch.topk(torch.cdist(qt, pts), k, largest=False), reps=3)
    # the call's device time by kernel: the transposing pre-pass, the main
    # kernel and the merge over point ranges
    parts_ms = device_profile(lambda: bk(qt, pts, k))["top_kernels_ms"]
    # bytes: points and queries read once, (dists, ids) written once;
    # operations: 2d per (query, point) pair for the product and 3 for
    # ‖q‖² − 2q·x + ‖x‖² (the root and the top-k test, taken only by the
    # pairs that reach them, are not counted)
    b_ms, b_by = bound((n + b) * d * 4 + b * k * 8, b * n * (2 * d + 3))
    record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "two_call_ms": two_call_ms,
              "two_calls": "torch.topk(torch.cdist(q, x), k, largest=False)",
              "device_kernels_ms": parts_ms,
              "scratch_bytes": mods["brute_knn"].scratch_bytes(
                  b, n, d, k, torch.cuda.get_device_properties(DEV).multi_processor_count),
              "max_abs_err": err, "shape": f"B={b} N={n} d={d} k={k}",
              "id_rows_equal_to_plain": frac, "rows_differ": differ,
              "first_chunk_id_rows_equal_to_float64": f64,
              "exact_search_wall_ms": wall, "plain_route_wall_ms": plain_wall}
    return truth, cls, launches, record


def phase2(seed, api, cfg, k, mods, timings, n=1_000_000, b=4096):
    from repro_torch.core import batched, projection, pyramid
    from repro_torch.core.active_search import padded_csr, window_spans
    from repro_torch.kernels import ref

    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    pts = torch.randn((n, 2), generator=gen, device=dev)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randn((b, 2), generator=gen, device=dev)

    t0 = time.perf_counter()
    s = api.ActiveSearcher.build(pts, labels=labels, cfg=cfg,
                                 proj=projection.identity_projection(pts), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(s.device.type == DEV.type, "index is not on the card")

    run = run_main_path("phase 2", s, q, k, mods, classify=True, expect=FUSED_PATH)
    res = run["search"]

    # after the counted run: where one search's device time goes, and the
    # Eq.-1 stats with the DMA-skip counter
    prof = device_profile(lambda: s.search(q, k))
    q_grid = projection.to_grid_coords(s.index.proj, q, cfg.grid_size)
    stats = batched.radius_search_batched(s.index, cfg, q_grid, k)
    same_stats(stats, res, "phase 2 radius_search_batched")
    # the loop kernel at this path's shape, exact against the lock-step
    # loop, whose stats equal the search's; count_at on the one-pass kernel
    timings["radius_search_loop"], plain_stats = time_loop(mods, s.index, cfg, q_grid, k,
                                                           f"PAPER_GRID B={b}")
    same_stats(plain_stats, res, "phase 2 ref.radius_search_loop")
    check(torch.equal(plain_stats["tile_dmas_skipped"],
                      ref.dmas_skipped(stats["iters"], stats["converged"])),
          "phase 2: tile_dmas_skipped differs from the lock-step loop's")
    count_launches = count_at_run("phase 2", s, q, res, mods, chunks=1)

    truth, truth_cls, exact_launches, exact_rec = run_exact("phase 2", s, q, k, mods, classify=True)

    # the first 256 queries again on the CPU, through the plain versions
    cpu = api.ActiveSearcher.from_index(s.index, cfg, device="cpu")
    before = counts(mods)
    qc = q[:256].cpu()
    rc = cpu.search(qc, k)
    check(counts(mods) == before, "the CPU run launched a kernel")
    for field in ("ids", "labels", "valid", "radius", "count", "iters", "converged", "truncated"):
        check(torch.equal(getattr(rc, field), getattr(res, field)[:256].cpu()),
              f"phase 2 CPU cross-check: {field} differs")
    dist_err = float((rc.dists - res.dists[:256].cpu()).nan_to_num(0.0).abs().max())
    check(torch.allclose(rc.dists, res.dists[:256].cpu(), rtol=1e-6, atol=0),
          "phase 2 CPU cross-check: dists differ")
    for mode in ("paper", "refined"):
        check(torch.equal(cpu.classify(qc, k, mode=mode), run[mode][:256].cpu()),
              f"phase 2 CPU cross-check: {mode} classes differ")

    # kernel timing at this path's shape: the loop's first count pass, its
    # output held exactly against the plain version's
    radii = torch.full((b,), float(cfg.r0), device=dev)
    levels = pyramid.level_for_radius(radii.int(), cfg)
    args = (s.index.pyr_tiles, q_grid.contiguous(), radii, levels, cfg.tile, cfg.level_nblks)
    ms, got = time_ms(lambda: mods["tile_count_multilevel"].tile_count_multilevel(*args))
    dev_ms = device_ms(lambda: mods["tile_count_multilevel"].tile_count_multilevel(*args),
                       "tile_count_multilevel_kernel")
    plain_ms, want = time_ms(lambda: ref.tile_count_multilevel(*args))
    check(torch.equal(got, want), "tile_count_multilevel differs at phase 2's first pass")
    cells = cfg.tile * cfg.tile
    c = cfg.n_channels
    read = circle_cells(q_grid, radii, levels, cfg.tile, cfg.level_nblks, cfg.metric)
    distinct = int(torch.unique(read).numel())
    b_ms, b_by = bound(distinct * c * 4 + b * (2 * 4 + 4 + 4) + b * c * 4,
                       b * cells * 10 + read.numel() * c)
    timings["tile_count_multilevel"] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                                        "bound_ms": b_ms,
                                        "bound_by": b_by, "max_abs_err": 0.0,
                                        "shape": f"PAPER_GRID B={b}",
                                        "distinct_cells": distinct}

    # the candidate kernel at this path's (paper-mode) shape, exact against
    # the plain version
    _, crd, _, _, n_live, _ = padded_csr(s.index, cfg.row_cap)
    st, en = window_spans(s.index, cfg, q_grid)
    cargs = (crd, st, en, q_grid.contiguous(), k, n_live, cfg.row_cap)
    ckw = dict(radii=stats["radius"].float(), center_cells=True)
    csr_ms, got = time_ms(lambda: mods["csr_candidate_topk"].csr_candidate_topk(*cargs, **ckw))
    want = ref.csr_candidate_topk(*cargs, **ckw)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "csr_candidate_topk differs at phase 2's paper-mode shape")

    # tile_count at the same first pass (one level for every lane), exact
    lv0 = int(levels[0])
    check(bool((levels == lv0).all()), "the first pass spans several levels")
    targs = (s.index.pyramid[lv0], q_grid.contiguous(), radii, 1 << lv0, cfg.tile)
    tc_ms, got = time_ms(lambda: mods["tile_count"].tile_count(*targs))
    tc_dev_ms = device_ms(lambda: mods["tile_count"].tile_count(*targs), "tile_count_kernel")
    tc_plain_ms, want = time_ms(lambda: ref.tile_count(*targs))
    check(torch.equal(got, want), "tile_count differs at phase 2's first pass")
    timings["tile_count"] = {"ms": tc_ms, "device_ms": tc_dev_ms, "plain_ms": tc_plain_ms,
                             "bound_ms": b_ms,
                             "bound_by": b_by, "max_abs_err": 0.0,
                             "shape": f"PAPER_GRID B={b} level {lv0}", "distinct_cells": distinct}

    # hopper_stacked: count_at at the loop's final radii, one tile_count
    # launch per pyramid level, equal to hopper's level-scheduled count
    stacked = s.with_plan(backend="hopper_stacked")
    reset(mods)
    cnt = stacked.count_at(q, res.radius)
    torch.cuda.synchronize()
    stacked_launches = counts(mods)
    check(stacked_launches["tile_count"] == cfg.levels
          and sum(stacked_launches.values()) == cfg.levels,
          f"hopper_stacked.count_at launched {stacked_launches}")
    check(on_card(cnt) and torch.equal(cnt, s.count_at(q, res.radius)),
          "hopper_stacked.count_at differs from hopper's")

    # hopper_gather: both modes equal to hopper in every field
    gather = s.with_plan(backend="hopper_gather")
    run_g = run_main_path("phase 2 hopper_gather", gather, q, k, mods, classify=False,
                          expect=("radius_search_loop", "candidate_topk"))
    same_result(run_g["search"], res, "phase 2 hopper_gather refined")
    paper = s.search(q, k, mode="paper")
    same_result(gather.search(q, k, mode="paper"), paper, "phase 2 hopper_gather paper")

    # hopper_q8: paper mode (the fused stage) equal to hopper; refined recall
    q8s = s.with_plan(backend="hopper_q8")
    run_q = run_main_path("phase 2 hopper_q8", q8s, q, k, mods, classify=False,
                          expect=("radius_search_loop", "csr_shortlist_q8", "candidate_topk"))
    prof_q = device_profile(lambda: q8s.search(q, k))
    same_result(q8s.search(q, k, mode="paper"), paper, "phase 2 hopper_q8 paper")
    torch.cuda.synchronize()

    emit({
        "phase": 2, "config": "PAPER_GRID", "n": n, "d": 2, "B": b, "k": k,
        "build_s": build_s, "search_ms": run["search_wall_ms"],
        "search_sha256": sha256_of(*res), "q8_search_sha256": sha256_of(*run_q["search"]),
        "queries_per_s": 1e3 * b / run["search_wall_ms"]["median"],
        "launches_per_search": run["per_search"], "launches_phase": run["launches"],
        **idle(prof, run["search_wall_ms"]["median"]),
        "mean_iters": float(res.iters.float().mean()),
        "converged_frac": float(res.converged.float().mean()),
        "truncated_frac": float(res.truncated.float().mean()),
        "tile_dmas_skipped": int(ref.dmas_skipped(stats["iters"], stats["converged"])),
        "timed_pass_distinct_cells": distinct,
        "recall_at_k_vs_exact": recall(res.ids, truth.ids, k),
        "class_agreement_vs_exact": {
            m: float((run[m] == truth_cls).float().mean()) for m in ("paper", "refined")},
        "exact": {"launches_search_classify": exact_launches, **exact_rec},
        "cpu_crosscheck": {"queries": 256, "exact": True, "max_dist_abs_err": dist_err},
        "csr_candidate_topk_paper_mode_ms": csr_ms,
        "peak_mem_gb": run["peak_mem_gb"],
        "index_bytes": {key: v for key, v in s.stats().items() if key.endswith("_bytes")},
        "hopper_stacked": {"count_at_equal": True, "launches_per_count_at": stacked_launches},
        "hopper_gather": {"equal_to_hopper": ["refined", "paper"],
                          "launches_per_search": run_g["per_search"],
                          "search_ms": run_g["search_wall_ms"], "peak_mem_gb": run_g["peak_mem_gb"]},
        "hopper_q8": {"paper_equal_to_hopper": True,
                      "rerank_k": batched.resolve_rerank_k(cfg, k, None),
                      "recall_at_k_vs_exact": recall(run_q["search"].ids, truth.ids, k),
                      "launches_per_search": run_q["per_search"],
                      "search_ms": run_q["search_wall_ms"],
                      **idle(prof_q, run_q["search_wall_ms"]["median"]),
                      "peak_mem_gb": run_q["peak_mem_gb"]},
        "count_at": {"launches": count_launches, "totals_equal_loop_counts": True},
        "radius_search_loop": timings["radius_search_loop"],
    })
    timings["brute_knn_d2"] = exact_rec
    return [run["launches"], count_launches, stacked_launches, run_g["launches"],
            run_q["launches"], exact_launches]


# csr_candidate_topk's device ms at phase 3's timed chunk in PERF.md's
# kernel table, row 2 (seed 0's data), from before the kernel walked only
# the valid slots of a window; at seed 0 the chunk is held to ROW2_SLACK
# times it (another seed's chunk is other data)
ROW2_CHUNK_MS = 1.394
ROW2_SLACK = 1.03


def skipped_share(st, en, n_pad: int, n: int, row_cap: int, pairs: int, what: str) -> float:
    """The share of the window slots csr_candidate_topk's walk skips, 1 -
    V / (B * w * row_cap), V the valid slots counted from the runs the
    kernel scans (ref.window_runs); held equal to the `pairs` the caller
    counted slot by slot."""
    from repro_torch.kernels import ref

    v = int(ref.window_runs(st, en, n_pad, n, row_cap)[2][:, -1].sum())
    check(v == pairs, f"{what}: ref.window_runs counts {v} valid slots, the slots {pairs}")
    return 1.0 - v / (st.numel() * row_cap)


def phase3(seed, api, cfg, k, mods, timings, n=1_000_000, b=10_000, chunk=2048):
    from repro_torch.core import batched, projection
    from repro_torch.core.active_search import gather_candidates, padded_csr, window_spans
    from repro_torch.kernels import ref

    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    d = 128

    def planted(m):
        # bench_accuracy's generator: neighborhoods live in the first two dims
        x = torch.randn((m, d), generator=gen, device=dev) * 0.3
        x[:, :2] = torch.randn((m, 2), generator=gen, device=dev) * 50.0
        return x

    pts, q = planted(n), planted(b)
    t0 = time.perf_counter()
    s = api.ActiveSearcher.build(pts, cfg=cfg, plan=api.ExecutionPlan(chunk_size=chunk),
                                 proj=projection.pca_projection(pts), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    run = run_main_path("phase 3", s, q, k, mods, classify=False, expect=FUSED_PATH)
    res = run["search"]
    prof = device_profile(lambda: s.search(q, k))
    stats = batched.radius_search_batched(
        s.index, cfg, projection.to_grid_coords(s.index.proj, q, cfg.grid_size), k)
    same_stats(stats, res, "phase 3 radius_search_batched (one launch, 10,000 lanes)")
    count_launches = count_at_run("phase 3", s, q, res, mods, chunks=-(-b // chunk))
    truth, _, exact_launches, exact_rec = run_exact("phase 3", s, q, k, mods, classify=False)
    timings["brute_knn"] = exact_rec

    cpu = api.ActiveSearcher.from_index(s.index, cfg, plan=s.plan, device="cpu")
    before = counts(mods)
    rc = cpu.search(q[:256].cpu(), k)
    check(counts(mods) == before, "the CPU run launched a kernel")
    gpu_ids, gpu_d = res.ids[:256].cpu(), res.dists[:256].cpu()
    same = (rc.ids == gpu_ids).all(dim=1)
    frac = float(same.float().mean())
    check(frac >= 0.99, f"phase 3 CPU cross-check: only {frac:.4f} of id lists equal")
    agree = same[:, None] & torch.isfinite(gpu_d)
    check(torch.allclose(rc.dists[agree], gpu_d[agree], rtol=1e-5, atol=0),
          "phase 3 CPU cross-check: dists differ where ids agree")

    # kernel timing at this path's shape: one chunk's candidate stage, its
    # output held against the plain version's (rtol 1e-5, near-ties counted)
    qc = q[:chunk].contiguous()
    q_grid = projection.to_grid_coords(s.index.proj, qc, cfg.grid_size)
    loop_rec, plain_stats = time_loop(mods, s.index, cfg, q_grid, k, f"PROD_GRID B={chunk}")
    same_stats(plain_stats, res, "phase 3 chunk ref.radius_search_loop", lanes=slice(0, chunk))
    timings["radius_search_loop"]["chunk_shape"] = loop_rec
    pts_pad, _, _, _, n_live, n_pad = padded_csr(s.index, cfg.row_cap)
    st, en = window_spans(s.index, cfg, q_grid)
    args = (pts_pad, st, en, qc, k, n_live, cfg.row_cap)
    ms, got = time_ms(lambda: mods["csr_candidate_topk"].csr_candidate_topk(*args))
    csr_dev_ms = device_ms(lambda: mods["csr_candidate_topk"].csr_candidate_topk(*args),
                           "csr_candidate_topk_kernel")
    plain_ms, want = time_ms(lambda: ref.csr_candidate_topk(*args), reps=3)
    err, swaps = compare_topk(got, want, pts_pad, qc, "l2", 1e-5)
    csr_sha = sha256_of(*got)
    # the distance work is per (query, row) pair; the bytes are the distinct
    # store rows the chunk's windows hold, since overlapping windows share rows
    s_cl = st.long().clamp(0, max(n_pad - cfg.row_cap, 0))
    j = s_cl[:, :, None] + torch.arange(cfg.row_cap, device=dev)
    valid = (j >= st[:, :, None]) & (j < en[:, :, None]) & (j < n_live)
    pairs = int(valid.sum())
    distinct = int(torch.unique(j[valid]).numel())
    skipped = skipped_share(st, en, n_pad, n_live, cfg.row_cap, pairs, "phase 3")
    check(seed != 0 or csr_dev_ms <= ROW2_SLACK * ROW2_CHUNK_MS,
          f"phase 3: csr_candidate_topk takes {csr_dev_ms:.4f} ms at the timed chunk, over "
          f"{ROW2_SLACK} x row 2's {ROW2_CHUNK_MS} ms")
    b_ms, b_by = bound(distinct * d * 4 + chunk * (cfg.window * 8 + d * 4 + k * 8),
                       3 * pairs * d)
    # gathered_ms: every (query, row) pair's row read from device memory,
    # the floor when the chunk's queries share no row in L2
    timings["csr_candidate_topk"] = {
        "ms": ms, "device_ms": csr_dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "gathered_ms": 1e3 * pairs * d * 4 / HBM_BYTES_PER_S,
        "max_abs_err": err, "shape": f"PROD_GRID d={d} B={chunk}", "output_sha256": csr_sha,
        "valid_pairs": pairs, "distinct_rows": distinct, "tie_swaps": swaps,
        "skipped_share": skipped, "row2_device_ms": ROW2_CHUNK_MS,
        "smem_bytes": mods["csr_candidate_topk"].shared_bytes(d, cfg.window, cfg.row_cap),
        "ptxas": ptxas_of("csr_candidate_topk"),
    }

    # ---- hopper_q8 on the same index, at full size
    q8s = s.with_plan(backend="hopper_q8")
    run_q = run_main_path("phase 3 hopper_q8", q8s, q, k, mods, classify=False,
                          expect=("radius_search_loop", "csr_shortlist_q8", "candidate_topk"))
    res_q = run_q["search"]
    prof_q = device_profile(lambda: q8s.search(q, k))
    store = q8s._quantized_store
    rk = batched.resolve_rerank_k(cfg, k, None)
    # lanes whose shortlist holds hopper's top-k are hopper's, bit for bit
    _, sl = batched.q8_shortlist(s.index, store, cfg, q, rk)
    ids_pad = padded_csr(s.index, cfg.row_cap)[3]
    sl_ids = torch.where(sl >= 0, ids_pad[sl.clamp_min(0).long()], torch.full_like(sl, -2))
    covered = ((res.ids[:, :, None] == sl_ids[:, None, :]).any(-1) | ~res.valid).all(-1)
    same_result(res_q, res, "phase 3 hopper_q8 on covered lanes", lanes=covered)

    cpu_q8 = api.ActiveSearcher.from_index(s.index, cfg, plan=q8s.plan, device="cpu")
    before = counts(mods)
    rcq = cpu_q8.search(q[:256].cpu(), k)
    check(counts(mods) == before, "the CPU run launched a kernel")
    same_q = (rcq.ids == res_q.ids[:256].cpu()).all(dim=1)
    frac_q = float(same_q.float().mean())
    check(frac_q >= 0.99, f"phase 3 hopper_q8 CPU cross-check: only {frac_q:.4f} of id lists equal")

    # the int8 shortlist on the timed chunk, bit-equal to its plain version;
    # its bytes are the distinct int8 rows and their scales
    qargs = (store.q_points, store.row_scales, st, en, qc, rk, n_live, cfg.row_cap)
    q8_ms, got = time_ms(lambda: mods["csr_shortlist_q8"].csr_shortlist_q8(*qargs))
    q8_plain_ms, want = time_ms(lambda: ref.csr_shortlist_q8(*qargs), reps=3)
    check_equal_pair(got, want, "csr_shortlist_q8 at phase 3's chunk")
    b_ms, b_by = bound(distinct * (d + 4) + chunk * (cfg.window * 8 + d * 4 + rk * 8),
                       6 * pairs * d)
    timings["csr_shortlist_q8"] = {
        "ms": q8_ms, "plain_ms": q8_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "gathered_ms": 1e3 * pairs * (d + 4) / HBM_BYTES_PER_S,
        "max_abs_err": 0.0, "shape": f"PROD_GRID d={d} B={chunk} rerank_k={rk}",
        "smem_bytes": mods["csr_shortlist_q8"].shared_bytes(d, cfg.window, cfg.row_cap),
        "ptxas": ptxas_of("csr_candidate_topk_q8"),
    }
    check_candidate_static_smem()

    # candidate_topk at the re-rank shape: the chunk's sorted shortlist rows
    sl_c = got[1]
    key = torch.where(sl_c >= 0, sl_c, torch.full_like(sl_c, n_pad))
    sl_c = torch.gather(sl_c, 1, torch.sort(key, dim=1, stable=True).indices)
    rr = (pts_pad[sl_c.clamp_min(0).long()], sl_c >= 0, qc, k)
    ctk = mods["candidate_topk"]
    rr_ms, got = time_ms(lambda: ctk.candidate_topk(*rr, d_chunk=d))
    rr_dev_ms = device_ms(lambda: ctk.candidate_topk(*rr, d_chunk=d), "candidate_topk_kernel")
    rr_plain_ms, want = time_ms(lambda: ref.candidate_topk(*rr, d_chunk=d))
    rr_two_ms, _ = time_ms(lambda: two_call_topk(*rr))
    rr_err, rr_swaps = compare_dense(got, want, rr[0], qc, "l2", 1e-5)
    rr_sha = sha256_of(*got)
    rows = int(rr[1].sum())
    rr_bound = bound(rows * d * 4 + chunk * (rk + d * 4 + k * 8), 3 * rows * d)
    # and at the gather shape: the chunk's whole materialised window
    cand = gather_candidates(s.index, cfg, q_grid, spans=(st, en))
    ga = (cand.points, cand.valid, qc, k)
    del cand
    ga_ms, got = time_ms(lambda: ctk.candidate_topk(*ga, d_chunk=d))
    ga_dev_ms = device_ms(lambda: ctk.candidate_topk(*ga, d_chunk=d), "candidate_topk_kernel")
    ga_plain_ms, want = time_ms(lambda: ref.candidate_topk(*ga, d_chunk=d), reps=3)
    ga_two_ms, _ = time_ms(lambda: two_call_topk(*ga), reps=3)
    ga_err, ga_swaps = compare_dense(got, want, ga[0], qc, "l2", 1e-5)
    ga_sha = sha256_of(*got)
    ga_bound = bound(pairs * d * 4 + chunk * (cfg.window * cfg.row_cap + d * 4 + k * 8),
                     3 * pairs * d)
    del ga, got, want
    timings["candidate_topk"] = {
        "ms": rr_ms, "device_ms": rr_dev_ms, "plain_ms": rr_plain_ms, "bound_ms": rr_bound[0],
        "bound_by": rr_bound[1], "two_call_ms": rr_two_ms, "max_abs_err": max(rr_err, ga_err),
        "shape": f"PROD_GRID d={d} B={chunk} C={rk} (hopper_q8 re-rank)",
        "tie_swaps": rr_swaps + ga_swaps,
        "smem_bytes": ctk.shared_bytes(d, rk), "ptxas": ptxas_of("candidate_topk"),
        "output_sha256": rr_sha,
        "gather_shape": {"shape": f"B={chunk} C={cfg.window * cfg.row_cap}", "ms": ga_ms,
                         "device_ms": ga_dev_ms, "plain_ms": ga_plain_ms,
                         "bound_ms": ga_bound[0], "bound_by": ga_bound[1],
                         "two_call_ms": ga_two_ms, "max_abs_err": ga_err,
                         "output_sha256": ga_sha,
                         "smem_bytes": ctk.shared_bytes(d, cfg.window * cfg.row_cap)},
    }

    # ---- hopper_gather on one chunk, equal to hopper in every field
    gather = s.with_plan(backend="hopper_gather")
    run_g = run_main_path("phase 3 hopper_gather", gather, qc, k, mods, classify=False,
                          expect=("radius_search_loop", "candidate_topk"))
    same_result(run_g["search"], type(res)(*(f[:chunk] for f in res)), "phase 3 hopper_gather")

    emit({
        "phase": 3, "config": "PROD_GRID, SIFT1M-shaped planted data", "n": n, "d": d,
        "B": b, "k": k, "chunk_size": chunk, "build_s": build_s,
        "search_ms": run["search_wall_ms"],
        "search_sha256": sha256_of(*res), "q8_search_sha256": sha256_of(*res_q),
        "queries_per_s": 1e3 * b / run["search_wall_ms"]["median"],
        "launches_per_search": run["per_search"],
        **idle(prof, run["search_wall_ms"]["median"]),
        "mean_iters": float(res.iters.float().mean()),
        "converged_frac": float(res.converged.float().mean()),
        "truncated_frac": float(res.truncated.float().mean()),
        "tile_dmas_skipped": int(ref.dmas_skipped(stats["iters"], stats["converged"])),
        "recall_at_k_vs_exact": recall(res.ids, truth.ids, k),
        "exact": {"launches_search": exact_launches, **exact_rec},
        "count_at": {"launches": count_launches, "totals_equal_loop_counts": True},
        "radius_search_loop_chunk": loop_rec,
        "cpu_crosscheck": {"queries": 256, "id_lists_equal_frac": frac},
        "timed_chunk": {"valid_pairs": pairs, "distinct_rows": distinct,
                        "max_abs_err": err, "tie_swaps": swaps,
                        **{name: timings[name] for name in ("csr_candidate_topk",
                                                             "csr_shortlist_q8")}},
        "peak_mem_gb": run["peak_mem_gb"],
        "index_bytes": {key: v for key, v in s.stats().items() if key.endswith("_bytes")},
        "hopper_q8": {
            "rerank_k": rk, "search_ms": run_q["search_wall_ms"],
            "queries_per_s": 1e3 * b / run_q["search_wall_ms"]["median"],
            "launches_per_search": run_q["per_search"],
            **idle(prof_q, run_q["search_wall_ms"]["median"]),
            "recall_at_k_vs_exact": recall(res_q.ids, truth.ids, k),
            "recall_at_k_vs_hopper": recall(res_q.ids, res.ids, k),
            "shortlist_contains_hopper_topk_frac": float(covered.float().mean()),
            "covered_lanes_bit_equal_to_hopper": True,
            "candidate_bytes_timed_chunk": {
                "valid_pairs": pairs, "fp32": pairs * d * 4, "int8": pairs * (d + 4),
                "int8_plus_rerank": pairs * (d + 4) + chunk * rk * d * 4,
                "ratio": pairs * d * 4 / (pairs * (d + 4)),
                "ratio_with_rerank": pairs * d * 4 / (pairs * (d + 4) + chunk * rk * d * 4)},
            "store_bytes": sum(t.numel() * t.element_size() for t in store),
            "peak_mem_gb": run_q["peak_mem_gb"],
            "cpu_crosscheck": {"queries": 256, "id_lists_equal_frac": frac_q},
        },
        "hopper_gather_one_chunk": {"B": chunk, "equal_to_hopper": True,
                                    "launches_per_search": run_g["per_search"],
                                    "search_ms": run_g["search_wall_ms"],
                                    "peak_mem_gb": run_g["peak_mem_gb"]},
    })
    return [run["launches"], count_launches, run_q["launches"], run_g["launches"],
            exact_launches]


# ----------------------------------------------------------------- phase 4 ---


def phase4(seed, mods, timings, s=32_768, h=24, hd=64, s_check=4096,
           widths=(("stablelm-12b", 4096, 32, 160), ("minitron-8b", 4096, 32, 128),
                   ("hd512", 4096, 4, 512))):
    """flash_attention at musicgen-medium's attention width (24 heads, kv
    24, head_dim 64; src/repro/configs/musicgen_medium.py) and prefill_32k's
    sequence (src/repro/configs/shapes.py), batch 1, float32, causal; and
    at S = 4096 at stablelm-12b's width (32 heads, head_dim 160;
    src/repro/configs/stablelm_12b.py), minitron-8b's (32 heads, head_dim
    128; src/repro/configs/minitron_8b.py) and a head_dim of 512 with 4
    heads (each row group's head dim split across 2 warps), each beside SDPA.  No path of the system
    calls it, so the phase's four calls at full width are its run, counted
    as the paths are."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ref

    fa = mods["flash_attention"]
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)

    def qkv(n, heads=h, dim=hd):
        return [torch.randn((1, n, heads, dim), generator=gen, device=DEV) for _ in range(3)]

    def sdpa_ms(q, k, v):
        """Yardstick only (the port never calls it): SDPA's memory-efficient
        backend on the same float32 tensors, (B, H, S, hd) views."""
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        lib_ms, lib_out = time_ms(sdpa, reps=5)
        return lib_ms, lib_out.transpose(1, 2)

    def tf32_bound(q):
        """The function's bound on this card, causal: three TF32
        tensor-core products per float32 operation; the FMA units' beside."""
        _, n, heads, dim = q.shape
        pairs = heads * n * (n + 1) // 2
        b_ms, b_by = bound(4 * q.numel() * 4, 3 * pairs * 4 * dim, TF32_TENSOR_OPS_PER_S)
        fma_ms, _ = bound(4 * q.numel() * 4, pairs * 4 * dim)
        return b_ms, b_by, fma_ms, pairs

    # every head at S = 4096, causal and full, against the plain version
    small = qkv(s_check)
    errs = {}
    for causal in (True, False):
        got = fa.flash_attention(*small, causal=causal)
        want = ref.flash_attention(*small, causal=causal)
        check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
              f"flash_attention differs at S={s_check} causal={causal}")
        errs[f"S{s_check}_{'causal' if causal else 'full'}"] = float((got - want).abs().max())
    del small, got, want

    q, k, v = qkv(s)
    wide = {name: qkv(n, heads, dim) for name, n, heads, dim in widths}
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    out = fa.flash_attention(q, k, v, causal=True)
    outs = {name: fa.flash_attention(*wide[name], causal=True) for name in wide}
    torch.cuda.synchronize()
    launches = counts(mods)
    calls = 1 + len(widths)
    check(launches["flash_attention"] == calls and sum(launches.values()) == calls,
          f"phase 4 launched {launches}")
    check(tuple(out.shape) == (1, s, h, hd) and out.dtype == torch.float32
          and bool(torch.isfinite(out).all()), "phase 4 output is not finite (1, S, H, hd) float32")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms, _ = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), reps=5)

    # the plain version head by head (one call would hold 24 x S x S float32
    # scores, 103 GB); heads are independent, so each head's output is held
    # against the kernel's
    def plain():
        return [ref.flash_attention(q[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1])
                for i in range(h)]

    plain_ms, want = time_ms(plain, reps=2)
    for i, w in enumerate(want):
        check(torch.allclose(out[:, :, i:i + 1], w, rtol=2e-5, atol=2e-5),
              f"flash_attention head {i} differs at S={s}")
    errs[f"S{s}_causal_all_heads"] = max(float((out[:, :, i:i + 1] - w).abs().max())
                                         for i, w in enumerate(want))
    del want
    lib_ms, lib_out = sdpa_ms(q, k, v)
    lib_err = float((lib_out - out).abs().max())
    del lib_out

    # the S = 4096 widths: every head against the plain version, causal (the
    # counted call's output) and full, timed beside their bound and SDPA
    records = {}
    for name, n, heads, dim in widths:
        wq, wk, wv = wide[name]
        err = {}
        for causal in (True, False):
            got = outs[name] if causal else fa.flash_attention(wq, wk, wv, causal=False)
            want = ref.flash_attention(wq, wk, wv, causal=causal)
            check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                  f"flash_attention differs at {name}'s width causal={causal}")
            err["causal" if causal else "full"] = float((got - want).abs().max())
            del got, want
        w_ms, _ = time_ms(lambda: fa.flash_attention(wq, wk, wv, causal=True), reps=5)
        w_plain_ms, _ = time_ms(lambda: ref.flash_attention(wq, wk, wv, causal=True), reps=2)
        w_lib_ms, _ = sdpa_ms(wq, wk, wv)
        w_bound, w_by, w_fma_ms, _ = tf32_bound(wq)
        records[name] = {
            "shape": f"{name} (1, {n}, {heads}, {dim}) float32 causal",
            "route": fa_route(fa, dim),
            "padded_head_dim": fa.padded_head_dim(dim), "ms": w_ms, "plain_ms": w_plain_ms,
            "bound_ms": w_bound, "bound_by": w_by, "bound": "three-pass TF32 on the tensor cores",
            "fp32_fma_bound_ms": w_fma_ms, "library_ms": w_lib_ms,
            "slower_than_library": w_ms > w_lib_ms, "max_abs_err": max(err.values()),
            "max_abs_err_by_mask": err, "smem_bytes": fa.shared_bytes(dim)}
        errs[f"{name}_hd{dim}"] = max(err.values())
    del wide, outs

    b_ms, b_by, fma_ms, pairs = tf32_bound(q)
    timings["flash_attention"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "fp32_fma_bound_ms": fma_ms,
        "library_ms": lib_ms, "max_abs_err": max(errs.values()),
        "shape": f"musicgen-medium (1, {s}, {h}, {hd}) float32 causal",
        "plain_ms_note": f"{h} one-head calls", "library": "scaled_dot_product_attention "
        "(EFFICIENT_ATTENTION backend)", "wide_head": records.pop("stablelm-12b"),
        "other_widths": records}
    emit({"phase": 4, "kernel": "flash_attention", "config": "musicgen-medium, prefill_32k",
          "shape": [1, s, h, hd], "dtype": "float32", "causal": True, "launches": launches,
          "on_a_system_path": False, "ms": ms, "plain_ms": plain_ms, "sdpa_ms": lib_ms,
          "slower_than_library": ms > lib_ms,
          "sdpa_max_abs_diff": lib_err, "bound_ms": b_ms, "bound_by": b_by,
          "bound": "three-pass TF32 on the tensor cores", "fp32_fma_bound_ms": fma_ms,
          "causal_pairs": pairs, "smem_bytes": fa.shared_bytes(hd), "max_abs_err": errs,
          "peak_mem_gb": peak_gb, "wide_head": timings["flash_attention"]["wide_head"],
          "other_widths": records})
    return launches


# ----------------------------------------------------------------- phase 5 ---

# the kernels that search a mutated handle, every one of which must launch
MUTATION_PATH = ("radius_search_loop", "csr_candidate_topk", "tile_count_multilevel",
                 "tile_count", "candidate_topk", "csr_shortlist_q8", "brute_knn")
MUTABLE_BACKENDS = ("hopper", "hopper_gather", "hopper_q8", "torch", "exact")


def host_ms(fn):
    """(result, milliseconds) of one call on the host clock, to the end of
    the device's work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def index_tensors(index) -> list:
    return [*index.proj, index.points_sorted, index.coords_sorted, index.labels_sorted,
            index.ids_sorted, index.offsets, *index.pyramid, index.sat, index.pyr_tiles]


def same_index(a, b, what: str) -> None:
    """Two GridIndex equal in every field, bit for bit."""
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if field == "proj" or field == "pyramid":
            ok = len(x) == len(y) and all(torch.equal(u, v) for u, v in zip(x, y))
        elif x is None or y is None:
            ok = x is None and y is None
        else:
            ok = torch.equal(x, y)
        check(ok, f"{what}: {field} differs from a rebuild")


def mixed_ids(gen, n0: int, n: int, m: int) -> torch.Tensor:
    """m distinct ids, half from the built points [0, n0) and half from the
    inserted ones [n0, n), in a shuffled order."""
    old = torch.randperm(n0, generator=gen, device=DEV)[:m // 2]
    new = n0 + torch.randperm(n - n0, generator=gen, device=DEV)[:m - m // 2]
    both = torch.cat([old, new])
    return both[torch.randperm(m, generator=gen, device=DEV)].to(torch.int32)


def survivors(n: int, dead: torch.Tensor) -> torch.Tensor:
    """Ids [0, n) not in `dead`, ascending: the arrival order, so a rebuild
    from them has the mutated index's CSR order."""
    alive = torch.ones(n, dtype=torch.bool, device=DEV)
    alive[dead.long()] = False
    return torch.nonzero(alive).flatten()


def run_handle(h, q, k, radii):
    """Every op of every mutable backend on one handle, and count_at on
    hopper and hopper_stacked at the given radii."""
    out = {}
    for name in MUTABLE_BACKENDS:
        b = h.with_plan(backend=name)
        out[name] = {"refined": b.search(q, k), "paper": b.search(q, k, mode="paper")}
        if h.cfg.n_classes:
            out[name]["classify"] = b.classify(q, k)
            out[name]["classify_paper"] = b.classify(q, k, mode="paper")
    for name in ("hopper", "hopper_stacked"):
        out[name + "_count_at"] = h.with_plan(backend=name).count_at(q, radii)
    torch.cuda.synchronize()
    return out


def same_runs(a: dict, b: dict, what: str) -> None:
    for key, x in a.items():
        if isinstance(x, dict):
            for op, r in x.items():
                if isinstance(r, torch.Tensor):
                    check(torch.equal(r, b[key][op]), f"{what}: {key} {op} differs")
                else:
                    same_result(r, b[key][op], f"{what}: {key} {op}")
        else:
            check(torch.equal(x, b[key]), f"{what}: {key} differs")


def phase5_paper(seed, api, cfg, k, mods, smi, n=1_000_000, b=4096, batch=2048, batches=8,
                 n_delete=8192, overflow=262_144) -> list:
    """Mutation at PAPER_GRID: build from all but `batches` x `batch` of
    phase 2's 1M points, insert those through the facade, delete `n_delete`
    ids (half built, half inserted) in batches of `batch`, and hold the
    handle against a rebuild of the survivors (every GridIndex field, then
    every backend's search, classify and count_at). The launch counters
    are zeroed before the first insert and read after the mutated handle's
    searches: each kernel of MUTATION_PATH must have launched. Then a last
    insert of `overflow` points spread uniformly over the grid, which
    overflows the spill log and must compact once, and a rebuild again."""
    from repro_torch.core import grid, mutable, projection

    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    pts = torch.randn((n, 2), generator=gen, device=DEV)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=DEV, dtype=torch.int32)
    q = torch.randn((b, 2), generator=gen, device=DEV)
    proj = projection.identity_projection(pts)
    n0 = n - batches * batch
    s = api.ActiveSearcher.build(pts[:n0], labels=labels[:n0], cfg=cfg, proj=proj, device=DEV)
    torch.cuda.synchronize()

    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    insert_ms, delete_ms = [], []
    for i in range(batches):
        lo, hi = n0 + i * batch, n0 + (i + 1) * batch
        s, ms = host_ms(lambda: s.insert(pts[lo:hi], labels=labels[lo:hi]))
        insert_ms.append(ms)
    spill_after_inserts = int(s.mutable.spill_used)
    dead = mixed_ids(gen, n0, n, n_delete)
    for part in dead.split(batch):
        s, ms = host_ms(lambda: s.delete(part))
        delete_ms.append(ms)
    check(on_card(*mutable.state_to_tree(s.mutable).values()), "phase 5: the state left the card")
    inv = mutable.validate_mutable(s.mutable, cfg)
    check(all(inv.values()), f"phase 5: validate_mutable {inv}")
    res = s.search(q, k)
    mutated = run_handle(s, q, k, res.radius)
    launches = counts(mods)
    for name in MUTATION_PATH:
        check(launches[name] > 0, f"phase 5: kernel {name} was never launched on a mutated handle")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # where a facade insert's and delete's time goes (device busy against
    # the wall; each call's new handle is dropped), and the snapshot merge
    # alone, on the final state
    keep = survivors(n, dead)
    ins_dev = idle(device_profile(lambda: s.insert(pts[n0:n0 + batch],
                                                   labels=labels[n0:n0 + batch])),
                   float(np.median(insert_ms)))
    del_dev = idle(device_profile(lambda: s.delete(keep[:batch])), float(np.median(delete_ms)))
    snapshot_ms = [host_ms(lambda: mutable.snapshot(s.mutable, cfg))[1] for _ in range(3)]
    rebuild = lambda: grid.build_index(pts[keep], cfg, proj, labels=labels[keep],  # noqa: E731
                                       ids=keep.to(torch.int32))
    rebuild()
    rebuild_ms = [host_ms(rebuild)[1] for _ in range(3)]
    ref = api.ActiveSearcher.from_index(rebuild(), cfg, device=DEV)
    same_index(s.index, ref.index, "phase 5 PAPER_GRID")
    check(all(grid.validate_invariants(s.index, cfg).values()), "phase 5: invariants fail")
    same_runs(mutated, run_handle(ref, q, k, res.radius), "phase 5 mutated against rebuilt")
    # torch against hopper on the same handle: every field, distances too (d = 2)
    for mode in ("refined", "paper"):
        same_result(mutated["torch"][mode], mutated["hopper"][mode], f"phase 5 torch {mode}")
    torch_ms = search_wall_ms(s.with_plan(backend="torch"), q, k, reps=3)
    hopper_ms = search_wall_ms(s, q, k, reps=3)
    state_b, index_b = nbytes(mutable.state_to_tree(s.mutable).values()), nbytes(index_tensors(s.index))

    # the escape hatch: a batch that lands almost wholly in cells with no
    # bucket overflows the spill log; insert_tracked compacts once
    lo_, span = proj.lo, proj.hi - proj.lo
    big = lo_ + torch.rand((overflow, 2), generator=gen, device=DEV) * span
    big_labels = torch.randint(0, cfg.n_classes, (overflow,), generator=gen, device=DEV,
                               dtype=torch.int32)
    spill_cap = s.mutable.spill_capacity
    s2, overflow_ms = host_ms(lambda: s.insert(big, labels=big_labels))
    st = s2.stats()
    check(st["compactions"] == 1 and st["spill_capacity"] == max(2 * spill_cap, overflow),
          f"phase 5: the overflow insert reported {st['compactions']} compactions")
    ref2 = grid.build_index(torch.cat([pts[keep], big]), cfg, proj,
                            labels=torch.cat([labels[keep], big_labels]),
                            ids=torch.cat([keep, torch.arange(n, n + overflow, device=DEV)]).int())
    same_index(s2.index, ref2, "phase 5 PAPER_GRID after the compaction")
    same_result(s2.search(q, k), api.ActiveSearcher.from_index(ref2, cfg, device=DEV).search(q, k),
                "phase 5 hopper after the compaction")
    torch.cuda.synchronize()

    emit({
        "phase": 5, "config": "PAPER_GRID", "nvidia_smi": smi, "n_built": n0,
        "inserted": batches * batch, "deleted": n_delete, "batch": batch, "B": b, "k": k,
        "insert_ms": {"median": float(np.median(insert_ms)), "all": insert_ms},
        "delete_ms": {"median": float(np.median(delete_ms)), "all": delete_ms},
        "insert_device": ins_dev, "delete_device": del_dev,
        "snapshot_ms": {"median": float(np.median(snapshot_ms)), "all": snapshot_ms},
        "rebuild_ms": {"median": float(np.median(rebuild_ms)), "all": rebuild_ms,
                       "n": int(keep.numel())},
        "spill_used_after_inserts": spill_after_inserts, "spill_capacity": spill_cap,
        "overflow": {"points": overflow, "insert_ms": overflow_ms, "compactions": st["compactions"],
                     "compact_s": st["compact_s"], "spill_capacity_after": st["spill_capacity"],
                     "equal_to_rebuild": True},
        "state_bytes": state_b, "index_bytes": index_b, "state_over_index": state_b / index_b,
        "peak_mem_gb": peak_gb, "validate_mutable": inv,
        "equal_to_rebuild": {"index": True, "backends": list(MUTABLE_BACKENDS),
                             "count_at": ["hopper", "hopper_stacked"]},
        "torch_equal_to_hopper": True,
        "search_ms": {"torch": torch_ms, "hopper": hopper_ms},
        "launches": launches, "search_sha256": sha256_of(*res),
    })
    return [launches]


def phase5_sift(seed, api, cfg, k, mods, smi, n=1_000_000, chunk=2048, batch=2048) -> list:
    """Mutation on phase 3's SIFT1M-shaped PROD_GRID index (d = 128): one
    insert of `batch` points and a delete of `batch` ids, then `hopper` and
    `hopper_q8` on one chunk of queries equal to a rebuild's in every field;
    the `torch` backend timed on the same chunk."""
    from repro_torch.core import grid, mutable, projection

    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    d = 128

    def planted(m):
        x = torch.randn((m, d), generator=gen, device=DEV) * 0.3
        x[:, :2] = torch.randn((m, 2), generator=gen, device=DEV) * 50.0
        return x

    pts, q = planted(n), planted(chunk)
    proj = projection.pca_projection(pts)
    n0 = n - batch
    plan = api.ExecutionPlan(chunk_size=chunk)
    s = api.ActiveSearcher.build(pts[:n0], cfg=cfg, plan=plan, proj=proj, device=DEV)
    torch.cuda.synchronize()
    reset(mods)
    torch.cuda.reset_peak_memory_stats()
    s, insert_ms = host_ms(lambda: s.insert(pts[n0:]))
    dead = mixed_ids(gen, n0, n, batch)
    s, delete_ms = host_ms(lambda: s.delete(dead))
    inv = mutable.validate_mutable(s.mutable, cfg)
    check(all(inv.values()), f"phase 5 SIFT1M-shaped: validate_mutable {inv}")
    got = {name: s.with_plan(backend=name).search(q, k) for name in ("hopper", "hopper_q8")}
    torch.cuda.synchronize()
    launches = counts(mods)
    for name in ("radius_search_loop", "csr_candidate_topk", "csr_shortlist_q8", "candidate_topk"):
        check(launches[name] > 0, f"phase 5 SIFT1M-shaped: kernel {name} was never launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    snapshot_ms = [host_ms(lambda: mutable.snapshot(s.mutable, cfg))[1] for _ in range(3)]
    keep = survivors(n, dead)
    rebuild = lambda: grid.build_index(pts[keep], cfg, proj, ids=keep.to(torch.int32))  # noqa: E731
    rebuild()
    rebuild_ms = [host_ms(rebuild)[1] for _ in range(3)]
    ref = api.ActiveSearcher.from_index(rebuild(), cfg, plan=plan, device=DEV)
    same_index(s.index, ref.index, "phase 5 SIFT1M-shaped")
    for name, r in got.items():
        same_result(r, ref.with_plan(backend=name).search(q, k), f"phase 5 SIFT1M-shaped {name}")
    torch_ms = search_wall_ms(s.with_plan(backend="torch"), q, k, reps=2)
    hopper_ms = search_wall_ms(s, q, k, reps=3)
    res_t = s.with_plan(backend="torch").search(q, k)
    state_b, index_b = nbytes(mutable.state_to_tree(s.mutable).values()), nbytes(index_tensors(s.index))
    emit({
        "phase": 5, "config": "PROD_GRID, SIFT1M-shaped planted data", "nvidia_smi": smi,
        "n_built": n0, "d": d, "inserted": batch, "deleted": batch, "B": chunk, "k": k,
        "insert_ms": insert_ms, "delete_ms": delete_ms,
        "snapshot_ms": {"median": float(np.median(snapshot_ms)), "all": snapshot_ms},
        "rebuild_ms": {"median": float(np.median(rebuild_ms)), "all": rebuild_ms,
                       "n": int(keep.numel())},
        "spill_used": int(s.mutable.spill_used),
        "state_bytes": state_b, "index_bytes": index_b, "state_over_index": state_b / index_b,
        "peak_mem_gb": peak_gb, "validate_mutable": inv,
        "equal_to_rebuild": {"index": True, "backends": ["hopper", "hopper_q8"]},
        "search_ms": {"torch": torch_ms, "hopper": hopper_ms},
        "torch_id_rows_equal_to_hopper": float((res_t.ids == got["hopper"].ids).all(1).float().mean()),
        "launches": launches,
    })
    return [launches]


# ----------------------------------------------------------------- phase 6 ---

# minitron-8b's widths (src/repro/configs/minitron_8b.py): d_model, vocab,
# query heads, KV heads and head_dim; its long_500k context is served by
# the retrieval-memory path (LONG_CONTEXT = "retrieval")
MINITRON = {"d_model": 4096, "vocab": 256_000, "n_heads": 32, "n_kv_heads": 8, "head_dim": 128}
# the kNN-LM datastore's size in phase 6b: at 524,288 pairs (8.6 GB of
# keys) the mutable state is 3.4x the index (a cell holds one or two keys
# at this width, and each gets at least 4 slack rows) and the stream's
# first insert ran out of the card's memory at a 66.7 GB peak (PERF.md,
# PR 23), so the datastore is cut to half
KNN_LM_PAIRS = 262_144


def host_merge(results, k):
    """Numpy's lexsort on (dist, id) over the per-shard top-k lists, the
    diagnostics reduced across shards: the sharded merge on the host."""
    d = np.concatenate([to_np(r.dists) for r in results], axis=1)
    i = np.concatenate([to_np(r.ids) for r in results], axis=1)
    lab = np.concatenate([to_np(r.labels) for r in results], axis=1)
    order = np.stack([np.lexsort((ii, dd)) for dd, ii in zip(d, i)])[:, :k]
    top_d = np.take_along_axis(d, order, 1)
    ok = np.isfinite(top_d)
    stat = lambda f: np.stack([to_np(getattr(r, f)) for r in results])  # noqa: E731
    return {"ids": np.where(ok, np.take_along_axis(i, order, 1), -1),
            "dists": top_d, "labels": np.where(ok, np.take_along_axis(lab, order, 1), -1),
            "valid": ok, "radius": stat("radius").max(0), "count": stat("count").sum(0),
            "iters": stat("iters").max(0), "converged": stat("converged").all(0),
            "truncated": stat("truncated").any(0)}


def phase6_sharded(seed, api, cfg, k, mods, smi, n=1_000_000, b=4096, n_shards=4,
                   batch=2048) -> list:
    """6a, the sharded tier on one card: PAPER_GRID, `n` random 2-D points
    routed over `n_shards` shards, built from all but 2 x `batch` points,
    two inserts of `batch` and a delete of `batch` ids. The stacked index
    equals build_index of each shard's routed points; the `sharded` search
    equals a host merge of the per-shard `torch` results and launches no
    kernel (its shards search on `torch`, as the reference's on `jnp`); the
    mutated handle equals a sharded rebuild in every field of the index,
    search (both modes) and classify; snapshot() equals build_index over
    the live points in arrival order; recall@k against `exact`."""
    from repro_torch.core import distributed, grid, projection

    gen = torch.Generator(device=DEV).manual_seed(seed + 60)
    pts = torch.randn((n, 2), generator=gen, device=DEV)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=DEV, dtype=torch.int32)
    q = torch.randn((b, 2), generator=gen, device=DEV)
    proj = projection.identity_projection(pts)
    n0 = n - 2 * batch
    s, build_ms = host_ms(lambda: api.ActiveSearcher.build_sharded(
        pts[:n0], n_shards=n_shards, labels=labels[:n0], cfg=cfg, proj=proj, device=DEV))
    check(s.sharded and s.plan.backend == "sharded", "phase 6a: not a sharded handle")
    owner = distributed.shard_of_points(pts[:n0], cfg, proj, n_shards)
    for sh in range(n_shards):
        sel = torch.nonzero(owner == sh).flatten()
        want = grid.build_index(pts[sel], cfg, proj, labels=labels[sel], ids=sel.to(torch.int32))
        same_index(distributed.live_shard(s.index, sh), want, f"phase 6a shard {sh}")
    check(s.index.points_sorted.shape[1] == distributed._pow2(int(s.index.offsets[:, -1].max())),
          "phase 6a: the stacked store is not padded to a power of two")

    # the sharded search: no kernel; equal to a host merge of the shards
    s.search(q, k)
    torch.cuda.synchronize()
    reset(mods)
    res = s.search(q, k)
    torch.cuda.synchronize()
    launches = counts(mods)
    check(sum(launches.values()) == 0, f"phase 6a: the sharded search launched {launches}")
    check(on_card(*res), "phase 6a: the search output left the card")
    per_shard = [api.ActiveSearcher(index=distributed.shard(s.index, sh), cfg=cfg,
                                    plan=api.ExecutionPlan(backend="torch")).search(q, k)
                 for sh in range(n_shards)]
    for field, want in host_merge(per_shard, k).items():
        check(np.array_equal(to_np(getattr(res, field)), want),
              f"phase 6a: sharded {field} differs from the host merge")
    search_ms = search_wall_ms(s, q, k, reps=3)

    # two inserts and a delete, against a sharded rebuild of the survivors
    insert_ms = []
    for i in range(2):
        lo, hi = n0 + i * batch, n0 + (i + 1) * batch
        s, ms = host_ms(lambda: s.insert(pts[lo:hi], labels=labels[lo:hi]))
        insert_ms.append(ms)
    dead = mixed_ids(gen, n0, n, batch)
    s, delete_ms = host_ms(lambda: s.delete(dead))
    keep = survivors(n, dead)
    ref = api.ActiveSearcher.build_sharded(pts[keep], n_shards=n_shards, labels=labels[keep],
                                           ids=keep.to(torch.int32), cfg=cfg, proj=proj,
                                           device=DEV)
    same_index(s.index, ref.index, "phase 6a mutated against a sharded rebuild")
    for mode in ("refined", "paper"):
        same_result(s.search(q, k, mode=mode), ref.search(q, k, mode=mode),
                    f"phase 6a mutated {mode} search")
    check(torch.equal(s.classify(q, k), ref.classify(q, k)), "phase 6a: classify differs")
    st = s.stats()
    check(st["n_points"] == keep.numel() and sum(st["shard_points"]) == keep.numel(),
          f"phase 6a: stats {st['n_points']} points, {st['shard_points']}")
    mutated_ms = search_wall_ms(s, q, k, reps=3)
    # phase 10b holds the same datastore on a mesh of ranks to these
    mutated = s.search(q, k)
    PHASE10.mkdir(parents=True, exist_ok=True)
    np.savez(PHASE10 / "sharded_6a.npz",
             **{f"search/{f}": to_np(getattr(res, f)) for f in res._fields},
             **{f"mutated/{f}": to_np(getattr(mutated, f)) for f in mutated._fields})

    # the merge to one dense handle, against build_index in arrival order
    snap, snapshot_ms = host_ms(s.snapshot)
    merge_ms = [host_ms(lambda: distributed.merge_to_dense(s.index, cfg))[1] for _ in range(3)]
    dense = grid.build_index(pts[keep], cfg, proj, labels=labels[keep], ids=keep.to(torch.int32))
    same_index(snap.index, dense, "phase 6a snapshot() against build_index")
    check(snap.plan.backend == "torch" and not snap.sharded, "phase 6a: snapshot plan")
    dense_torch_ms = search_wall_ms(snap, q, k, reps=3)
    reset(mods)
    truth = snap.with_plan(backend="exact").search(q, k)
    torch.cuda.synchronize()
    exact_launches = counts(mods)
    check(exact_launches["brute_knn"] == 1, f"phase 6a exact launched {exact_launches}")
    emit({
        "phase": "6a", "config": "PAPER_GRID, sharded over 4 shards on one card",
        "nvidia_smi": smi, "n_built": n0, "n_shards": n_shards, "B": b, "k": k,
        "inserted": 2 * batch, "deleted": batch, "build_ms": build_ms,
        "stacked_rows_per_shard": int(s.index.points_sorted.shape[1]),
        "sharded_search_ms": search_ms, "sharded_search_ms_after_mutation": mutated_ms,
        "dense_torch_search_ms_same_points": dense_torch_ms,
        "sharded_search_launches": launches, "insert_ms": insert_ms, "delete_ms": delete_ms,
        "snapshot_ms": snapshot_ms,
        "merge_to_dense_ms": {"median": float(np.median(merge_ms)), "all": merge_ms},
        "shard_points": st["shard_points"], "compactions": st["compactions"],
        "compact_s": st["compact_s"],
        "recall_at_k_vs_exact": recall(s.search(q, k).ids, truth.ids, k),
        "equal": {"stacked_index_to_per_shard_build_index": True,
                  "sharded_search_to_host_merge": True,
                  "mutated_to_sharded_rebuild": ["index", "search refined", "search paper",
                                                 "classify"],
                  "snapshot_to_build_index": True},
        "search_sha256": sha256_of(*res),
    })
    return [launches, exact_launches]


def zipf_tokens(gen, m: int, vocab: int, s: float = 1.1) -> torch.Tensor:
    """m next tokens, token r drawn with probability proportional to
    1 / (r + 1)^s (a Zipf law over the vocabulary)."""
    w = torch.arange(1, vocab + 1, dtype=torch.float64, device=DEV).pow(-s).float()
    return torch.multinomial(w, m, replacement=True, generator=gen).to(torch.int32)


def clustered_keys(gen, centres: torch.Tensor, m: int, spread: float) -> torch.Tensor:
    """m hidden states: a random centre each, plus Gaussian noise of std
    `spread` per dim; made in blocks of 65,536 rows."""
    keys = torch.empty((m, centres.shape[1]), device=DEV)
    for lo in range(0, m, 1 << 16):
        hi = min(m, lo + (1 << 16))
        pick = torch.randint(0, centres.shape[0], (hi - lo,), generator=gen, device=DEV)
        keys[lo:hi] = centres[pick] + spread * torch.randn((hi - lo, centres.shape[1]),
                                                          generator=gen, device=DEV)
    return keys


def datastore_keys(seed: int, n: int, d: int, n_centres: int, spread: float):
    """The datastore's keys and the cluster centres, from their own seed,
    so the same keys can be made again for the rebuild check."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    centres = torch.randn((n_centres, d), generator=gen, device=DEV)
    return clustered_keys(gen, centres, n, spread), centres


def phase6_knn_lm(seed, api, mods, smi, n=524_288, requests=256, max_batch=64, inserts=4,
                  batch=2048, n_centres=4096, spread=0.5):
    """6b, the kNN-LM head at minitron-8b's width: a datastore of `n`
    (hidden state, next token) pairs made on the card (keys Gaussian
    clusters, tokens Zipf over the vocabulary) with KNNLMConfig's defaults
    (grid 1024, window 32, row_cap 32, k = 16, plan `hopper`), then a
    decode stream of `requests` requests of 1-8 rows through
    DynamicBatcher(max_batch), with `inserts` offer_insert calls of
    `batch` pairs between batches.  Every request's result equals an
    unpadded call on the handle that served it, each p_knn row sums to 1
    within 1e-5, each batch launches one radius_search_loop and one
    csr_candidate_topk, and the grown datastore equals build_index over
    the union with the datastore's projection.  Returns (launches,
    csr_candidate_topk's timing at a batch's shape)."""
    from repro_torch.core import knn_lm, mutable
    from repro_torch.core.active_search import padded_csr, window_spans
    from repro_torch.core.projection import to_grid_coords
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import DynamicBatcher

    d, vocab = MINITRON["d_model"], MINITRON["vocab"]
    cfg = knn_lm.KNNLMConfig()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 62)
    keys, centres = datastore_keys(seed + 61, n, d, n_centres, spread)
    toks = zipf_tokens(gen, n, vocab)
    sizes = torch.randint(1, 9, (requests,), generator=gen, device=DEV).tolist()
    rows = torch.randint(0, n, (sum(sizes),), generator=gen, device=DEV)
    hidden = keys[rows] + 0.1 * spread * torch.randn((sum(sizes), d), generator=gen, device=DEV)
    reqs = list(hidden.split(sizes))
    new = [(clustered_keys(gen, centres, batch, spread), zipf_tokens(gen, batch, vocab))
           for _ in range(inserts)]
    index, build_ms = host_ms(lambda: knn_lm.build_datastore(keys, toks, cfg))
    proj = index.proj
    del keys
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    batcher = DynamicBatcher(api.ActiveSearcher.from_index(index, cfg.grid, plan=cfg.plan,
                                                           device=DEV),
                             k=cfg.k, max_batch=max_batch)
    index_b = nbytes(index_tensors(index))
    del index
    batcher.searcher.search(reqs[0], cfg.k)                  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(mods)
    pending, done, step_ms = [], [0], {"batch": [], "insert": []}
    sum_err = [0.0]

    def verify() -> None:
        """The requests this batch served, each against an unpadded call on
        the handle that served it, and each p_knn row's sum; their
        launches are taken off the counts again."""
        saved = counts(mods)
        while done[0] < len(pending) and pending[done[0]][1].done():
            q_rows, fut = pending[done[0]]
            got = fut.result(timeout=0)
            same_result(got, batcher.searcher.search(q_rows, cfg.k),
                        f"phase 6b: request {done[0]} differs from an unpadded call")
            p = knn_lm.logprobs_from_result(got, cfg, vocab).double().exp().sum(-1)
            sum_err[0] = max(sum_err[0], float((p - 1.0).abs().max()))
            done[0] += 1
        for name, mod in mods.items():
            mod.launches = saved[name]

    def timed_step() -> bool:
        before = (batcher.stats["batches"], batcher.stats["inserts_applied"])
        ran, ms = host_ms(batcher.step)
        if batcher.stats["batches"] != before[0]:
            step_ms["batch"].append(ms)
            verify()
        elif batcher.stats["inserts_applied"] != before[1]:
            step_ms["insert"].append(ms)
        return ran

    per_insert = requests // inserts
    for i, q_rows in enumerate(reqs):
        pending.append((q_rows, batcher.submit(q_rows)))
        if i % per_insert == per_insert - 1:
            new_keys, new_toks = new[i // per_insert]
            batcher.offer_insert(new_keys, labels=new_toks)
        if i % 8 == 7:
            timed_step()
    while timed_step():
        pass
    launches = counts(mods)
    stream_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = dict(batcher.stats)
    check(done[0] == requests, f"phase 6b: {done[0]} of {requests} requests served")
    check(sum_err[0] <= 1e-5, f"phase 6b: a p_knn row sums to 1 +- {sum_err[0]}")
    check(launches["radius_search_loop"] == st["batches"]
          and launches["csr_candidate_topk"] == st["batches"],
          f"phase 6b: {st['batches']} batches launched {launches}")
    check(st["inserts_applied"] == inserts * batch, "phase 6b: inserts not applied")
    grown = batcher.searcher
    state_b = nbytes(mutable.state_to_tree(grown.mutable).values())
    st["compactions"] = grown.stats()["compactions"]
    grown = grown.snapshot()
    del batcher

    # the grown datastore == a build over the union, the same projection
    keys, _ = datastore_keys(seed + 61, n, d, n_centres, spread)
    union = knn_lm.build_datastore(torch.cat([keys] + [k_ for k_, _ in new]),
                                   torch.cat([toks] + [t for _, t in new]), cfg, proj=proj)
    del keys
    same_index(grown.index, union, "phase 6b grown datastore against build_index of the union")
    del union

    # recall against exact, and csr_candidate_topk at a batch's shape
    all_q = torch.cat(reqs)
    res = grown.search(all_q, cfg.k)
    reset(mods)
    truth = grown.with_plan(backend="exact").search(all_q, cfg.k)
    torch.cuda.synchronize()
    exact_launches = counts(mods)
    qc = all_q[:max_batch].contiguous()
    q_grid = to_grid_coords(grown.index.proj, qc, cfg.grid.grid_size)
    pts_pad, _, _, _, n_live, n_pad = padded_csr(grown.index, cfg.grid.row_cap)
    stt, en = window_spans(grown.index, cfg.grid, q_grid)
    args = (pts_pad, stt, en, qc, cfg.k, n_live, cfg.grid.row_cap)
    csr = mods["csr_candidate_topk"].csr_candidate_topk
    ms, got = time_ms(lambda: csr(*args))
    dev_ms = device_ms(lambda: csr(*args), "csr_candidate_topk_kernel")
    plain_ms, want = time_ms(lambda: ref.csr_candidate_topk(*args), reps=3)
    err, swaps = compare_topk(got, want, pts_pad, qc, "l2", 1e-5)
    s_cl = stt.long().clamp(0, max(n_pad - cfg.grid.row_cap, 0))
    j = s_cl[:, :, None] + torch.arange(cfg.grid.row_cap, device=DEV)
    valid = (j >= stt[:, :, None]) & (j < en[:, :, None]) & (j < n_live)
    pairs, distinct = int(valid.sum()), int(torch.unique(j[valid]).numel())
    skipped = skipped_share(stt, en, n_pad, n_live, cfg.grid.row_cap, pairs, "phase 6b")
    b_ms, b_by = bound(distinct * d * 4 + max_batch * (cfg.grid.window * 8 + d * 4 + cfg.k * 8),
                       3 * pairs * d)
    timing = {"shape": f"kNN-LM d={d} B={max_batch} k={cfg.k}", "ms": ms, "device_ms": dev_ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "gathered_ms": 1e3 * pairs * d * 4 / HBM_BYTES_PER_S, "valid_pairs": pairs,
              "distinct_rows": distinct, "skipped_share": skipped, "max_abs_err": err,
              "tie_swaps": swaps}
    batch_ms = float(np.median(step_ms["batch"]))
    emit({
        "phase": "6b", "config": "kNN-LM head, minitron-8b widths (d_model 4096, vocab 256,000)",
        "nvidia_smi": smi, "n": n, "d": d, "vocab": vocab, "k": cfg.k,
        "grid": {"grid_size": cfg.grid.grid_size, "window": cfg.grid.window,
                 "row_cap": cfg.grid.row_cap}, "plan": cfg.plan.backend,
        "keys": {"clusters": n_centres, "spread": spread, "tokens": "Zipf s=1.1"},
        "build_ms": build_ms, "requests": requests, "request_rows": st["request_rows"],
        "batches": st["batches"], "batch_rows": st["batch_rows"], "pad_rows": st["pad_rows"],
        "truncated_rows": st["truncated_rows"], "max_batch": max_batch,
        "ms_per_batch": {"median": batch_ms, "min": min(step_ms["batch"]),
                         "max": max(step_ms["batch"])},
        "decode_rows_per_s": 1e3 * st["request_rows"] / sum(step_ms["batch"]),
        "insert_ms": step_ms["insert"], "inserted": inserts * batch,
        "insert_backlog_peak": st["insert_backlog_peak"], "compactions": st["compactions"],
        "p_knn_row_sum_max_err": sum_err[0],
        "recall_at_k_vs_exact": recall(res.ids, truth.ids, cfg.k),
        "valid_frac": float(res.valid.float().mean()),
        "state_bytes": state_b, "index_bytes": index_b, "state_over_index": state_b / index_b,
        "peak_mem_gb": {"build": build_peak_gb, "stream": stream_peak_gb},
        "launches": launches, "exact_launches": exact_launches,
        "csr_candidate_topk_at_batch": timing,
        "equal": {"requests_to_unpadded_calls": True, "grown_to_build_index_of_union": True},
    })
    return [launches, exact_launches], timing


def phase6_retrieval(seed, api, mods, smi, n=524_288, steps=64, rows=8, extend=1024):
    """6c, retrieval memory at minitron-8b's long_500k: `n` positions whose
    8 KV heads of head_dim 128 are summarised by key_summary, a fixed
    random projection (make_projection), RetrievalMemoryConfig's defaults
    (64 retrieved, grid 2048, window 32, row_cap 64, max_iters 12), then
    `steps` decode steps of `rows` rows of 32 query heads each (query heads
    near a past position's key heads): each step one radius_search_loop
    and one csr_candidate_topk; recall of the positions against `exact`;
    extend_memory_index of `extend` positions equal to the build over the
    concatenation.  Returns (launches, the mutable state grown by the same
    positions, cfg) for 6d."""
    from repro_torch.core import mutable, retrieval_memory as rm

    hd, n_kv, n_q = MINITRON["head_dim"], MINITRON["n_kv_heads"], MINITRON["n_heads"]
    cfg = rm.RetrievalMemoryConfig()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 63)
    k_heads = torch.randn((n, n_kv, hd), generator=gen, device=DEV)
    keys = rm.key_summary(k_heads)
    proj = rm.make_projection(gen, hd)
    pos = torch.randint(0, n, (steps * rows,), generator=gen, device=DEV)
    q_heads = k_heads[pos].repeat_interleave(n_q // n_kv, dim=1)
    q_heads = q_heads + 0.5 * torch.randn(q_heads.shape, generator=gen, device=DEV)
    q_sum = rm.query_summary(q_heads).split(rows)
    del k_heads, q_heads
    index, build_ms = host_ms(lambda: rm.build_memory_index(keys, cfg, proj))

    rm.retrieve_positions(index, cfg, q_sum[0])               # warm-up, not counted
    torch.cuda.synchronize()
    reset(mods)
    step_ms, out = [], []
    for qs in q_sum:
        res, ms = host_ms(lambda: rm.retrieve_positions(index, cfg, qs))
        step_ms.append(ms)
        out.append(res)
    launches = counts(mods)
    check(launches["radius_search_loop"] == steps and launches["csr_candidate_topk"] == steps,
          f"phase 6c: {steps} decode steps launched {launches}")
    positions = torch.cat([p for p, _ in out])
    ok = torch.cat([v for _, v in out])
    check(positions.shape == (steps * rows, cfg.n_retrieved) and positions.dtype == torch.int32
          and bool(((positions >= 0) & (positions < n)).all()), "phase 6c: positions out of range")
    check(bool(ok.any()), "phase 6c: no decode row retrieved a position")
    # the first two steps again on the CPU, through the plain versions: the
    # same Eq.-1 stats, distances within rtol 1e-5 and positions equal up
    # to near-ties (d = 128 sums in another order)
    card = api.ActiveSearcher.from_index(index, cfg.grid, device=DEV)
    cpu = api.ActiveSearcher.from_index(index, cfg.grid, device="cpu")
    q2 = torch.cat(q_sum[:2])
    rg = card.search(q2, cfg.n_retrieved)
    before = counts(mods)
    rc = cpu.search(q2.cpu(), cfg.n_retrieved)
    check(counts(mods) == before, "phase 6c: the CPU run launched a kernel")
    for field in ("radius", "count", "iters", "converged", "truncated", "valid"):
        check(torch.equal(getattr(rg, field).cpu(), getattr(rc, field)),
              f"phase 6c CPU cross-check: {field} differs")
    check(torch.equal(positions[:2 * rows], torch.clamp_min(rg.ids, 0)),
          "phase 6c: retrieve_positions differs from the searcher's ids")
    cpu_err, cpu_swaps = compare_topk((rg.dists.cpu(), rg.ids.cpu()), (rc.dists, rc.ids),
                                      keys.cpu(), q2.cpu(), "l2", 1e-5)
    del cpu
    self_hit = float((positions == pos[:, None]).any(dim=1).float().mean())
    all_q = torch.cat(q_sum)
    reset(mods)
    truth = api.ActiveSearcher.from_index(index, cfg.grid, device=DEV).with_plan(
        backend="exact").search(all_q, cfg.n_retrieved)
    torch.cuda.synchronize()
    exact_launches = counts(mods)
    rec = recall(torch.where(ok, positions, torch.full_like(positions, -1)), truth.ids,
                 cfg.n_retrieved)

    new_heads = torch.randn((extend, n_kv, hd), generator=gen, device=DEV)
    new_keys = rm.key_summary(new_heads)
    ext, extend_ms = host_ms(lambda: rm.extend_memory_index(index, cfg, new_keys))
    same_index(ext, rm.build_memory_index(torch.cat([keys, new_keys]), cfg, proj),
               "phase 6c extend_memory_index against the build over the concatenation")
    state = mutable.insert(mutable.from_index(index, cfg.grid), cfg.grid, new_keys)
    same_index(mutable.snapshot(state, cfg.grid), ext, "phase 6c held state against extend")
    emit({
        "phase": "6c", "config": "retrieval memory, minitron-8b long_500k (8 KV heads, "
                                 "32 query heads, head_dim 128)",
        "nvidia_smi": smi, "positions": n, "n_retrieved": cfg.n_retrieved,
        "grid": {"grid_size": cfg.grid.grid_size, "window": cfg.grid.window,
                 "row_cap": cfg.grid.row_cap, "max_iters": cfg.grid.max_iters},
        "plan": cfg.plan.backend, "build_ms": build_ms, "decode_steps": steps,
        "rows_per_step": rows,
        "ms_per_step": {"median": float(np.median(step_ms)), "min": min(step_ms),
                        "max": max(step_ms)},
        "decode_rows_per_s": 1e3 * steps * rows / sum(step_ms),
        "recall_at_m_vs_exact": rec, "own_position_retrieved_frac": self_hit,
        "cpu_crosscheck": {"rows": 2 * rows, "max_abs_err": cpu_err, "tie_swaps": cpu_swaps},
        "valid_frac": float(ok.float().mean()),
        "extend": {"positions": extend, "ms": extend_ms, "equal_to_build": True},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "exact_launches": exact_launches,
    })
    return [launches, exact_launches], state, cfg


def phase6_checkpoint(seed, state, cfg, smi, extra=1024) -> None:
    """6d, the checkpoint: 6c's mutable state saved with save_mutable_index
    into a directory under build/ (removed afterwards), restored with
    restore_mutable_index, then one insert of `extra` positions into both
    the restored and the live state: equal in every field."""
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.core import mutable, retrieval_memory as rm

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build")
    try:
        mgr = CheckpointManager(tmp)
        _, save_ms = host_ms(lambda: mgr.save_mutable_index(1, state, blocking=True))
        step_dir = Path(tmp) / "step_1"
        written = sum(f.stat().st_size for f in step_dir.iterdir())
        restored, restore_ms = host_ms(lambda: mgr.restore_mutable_index(1, device=DEV))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device=DEV).manual_seed(seed + 64)
    more = rm.key_summary(torch.randn((extra, MINITRON["n_kv_heads"], MINITRON["head_dim"]),
                                      generator=gen, device=DEV))
    a = mutable.state_to_tree(mutable.insert(restored, cfg.grid, more))
    b = mutable.state_to_tree(mutable.insert(state, cfg.grid, more))
    check(sorted(a) == sorted(b), "phase 6d: the restored state has other fields")
    for key in b:
        check(a[key].dtype == b[key].dtype and a[key].device.type == DEV.type
              and torch.equal(a[key], b[key]), f"phase 6d: {key} differs after the insert")
    emit({
        "phase": "6d", "config": "checkpoint of 6c's mutable state", "nvidia_smi": smi,
        "bytes_written": written, "state_bytes": nbytes(mutable.state_to_tree(state).values()),
        "save_s": save_ms / 1e3, "restore_s": restore_ms / 1e3, "inserted_after": extra,
        "restored_then_inserted_equal_to_live": True,
    })


# ----------------------------------------------------------------- phase 7 ---

# the reference model's own prefill/decode tolerance (tests/test_models.py)
MODEL_TOL = dict(rtol=0.15, atol=0.15)
# each serving phase's harvest seconds, for 9d's line
HARVEST_S: dict = {}
# float32 on the card (cuBLAS, TF32 off) against the CPU's sums
F32_CARD_TOL = dict(rtol=1e-4, atol=1e-4)
# the same for a whole 12-layer model (xlstm-125m): its residual stream's
# float32 error grows about 1e-6 (relative) a layer, and on the CPU alone
# its logits move 9.8e-5 between 8 threads and 1 (other GEMM sums)
F32_DEEP_TOL = dict(rtol=1e-4, atol=1e-3)


def model_size(model) -> tuple[int, int]:
    return (sum(p.numel() for p in model.parameters()),
            sum(p.numel() * p.element_size() for p in model.parameters()))


def close(got, want, tol: dict, what: str) -> float:
    """Check allclose under `tol`; returns the largest absolute error."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **tol), f"{what}: max abs error {err} beyond {tol}")
    return err


def lm_run(model, tokens, prompt: int, steps: int):
    """Prefill of `prompt` tokens, `steps` decode steps teacher-forced on
    `tokens`, and the training forward over all of them: (prefill logits,
    prefill hidden, [(decode logits, hidden)], forward logits)."""
    toks = tokens.to(model.device)
    with torch.no_grad():
        logits, caches, hidden = model.prefill({"tokens": toks[:, :prompt]},
                                               cache_len=prompt + steps)
        dec = []
        for i in range(steps):
            lg, caches, h = model.decode_step(caches, toks[:, prompt + i], prompt + i)
            dec.append((lg, h))
        full, _ = model({"tokens": toks[:, :prompt + steps]})
    return logits, hidden, dec, full


@contextlib.contextmanager
def f32_activations():
    """The port's ACT_DTYPE switched to float32 inside the block (models
    built inside store their matrices in float32)."""
    from repro_torch.models import layers as L

    saved = L.ACT_DTYPE
    L.ACT_DTYPE = torch.float32
    try:
        yield
    finally:
        L.ACT_DTYPE = saved


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def lm_equations(seed, cfg, tol=F32_CARD_TOL) -> dict:
    """The model's equations at `cfg`'s widths in float32: weights drawn on
    the card from generator `seed` and copied to the CPU; a prefill of 64
    tokens and 4 decode steps, 2 rows, through the same module on the card
    and on the CPU: logits and hidden states within `tol`, and on each
    side the decode logits equal to the training forward's at the same
    positions."""
    from repro_torch.models.model import DecoderLM

    prompt, steps, batch = 64, 4, 2
    with f32_activations():
        card = DecoderLM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed))
        cpu = DecoderLM(cfg, device="meta").to_empty(device="cpu")
        cpu.load_state_dict(card.state_dict())
        gen = torch.Generator().manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, prompt + steps), generator=gen)
        (lg_c, h_c, dec_c, full_c), card_ms = host_ms(lambda: lm_run(card, tokens, prompt, steps))
        t0 = time.perf_counter()
        lg_h, h_h, dec_h, full_h = lm_run(cpu, tokens, prompt, steps)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
    errs = {"prefill_logits": close(lg_c, lg_h, tol, f"{cfg.name} prefill logits"),
            "prefill_hidden": close(h_c, h_h, tol, f"{cfg.name} prefill hidden"),
            "forward_logits": close(full_c, full_h, tol, f"{cfg.name} forward logits")}
    errs["decode_logits"] = max(close(a[0], b[0], tol, f"{cfg.name} decode {i} logits")
                                for i, (a, b) in enumerate(zip(dec_c, dec_h)))
    errs["decode_hidden"] = max(close(a[1], b[1], tol, f"{cfg.name} decode {i} hidden")
                                for i, (a, b) in enumerate(zip(dec_c, dec_h)))
    dec_fwd = 0.0
    for side, lg, dec, full in (("card", lg_c, dec_c, full_c), ("cpu", lg_h, dec_h, full_h)):
        dec_fwd = max(dec_fwd, close(lg, full[:, prompt - 1], tol,
                                     f"{cfg.name} {side}: prefill against forward"))
        for i, (lgi, _) in enumerate(dec):
            dec_fwd = max(dec_fwd, close(lgi, full[:, prompt + i], tol,
                                         f"{cfg.name} {side}: decode {i} against forward"))
    n_params, _ = model_size(card)
    return {"params": n_params, "batch": batch, "prompt": prompt, "decode_steps": steps,
            "tolerance": tol, "card_vs_cpu_max_abs_err": errs,
            "decode_vs_forward_max_abs_err": dec_fwd, "card_ms": card_ms, "cpu_ms": cpu_ms}


def phase7_equations(seed, smi, cfg=None) -> None:
    """7a, the model's equations at full width: minitron-8b's widths at
    depth 2 (or `cfg`), float32 activations (the port's ACT_DTYPE switched
    for the phase), through `lm_equations`."""
    from repro_torch.configs import get_config

    cfg = cfg or dataclasses.replace(get_config("minitron-8b"), n_layers=2)
    emit({"phase": "7a", "config": f"minitron-8b widths at depth {cfg.n_layers}, float32",
          "nvidia_smi": smi, **lm_equations(seed + 70, cfg)})


def lm_device_profile(engine, prompts, steps: int) -> dict:
    """`steps` decode steps (decode_step, then the kNN-LM pick) after a
    prefill, twice: untraced, each decode_step and each pick timed alone
    on the host clock (median ms); then under torch.profiler: the traced
    window's wall ms per step and the device records' ms per step (their
    ratio the card's busy share), the largest records by kernel name, the
    host operators with the most self time per step, the cudaLaunchKernel
    calls per step, and the two search kernels' device ms per step."""
    from torch.profiler import ProfilerActivity, profile

    model = engine.model
    gen = torch.Generator(device=engine.device).manual_seed(0)
    s = prompts.shape[1]

    def prefilled():
        logits, caches, hidden = model.prefill({"tokens": prompts}, cache_len=s + steps)
        tok = engine._pick(logits, hidden, gen)
        torch.cuda.synchronize()
        return caches, tok

    with torch.no_grad():
        caches, tok = prefilled()
        timed = []
        for i in range(steps):
            (logits, caches, hidden), ms_model = host_ms(
                lambda: model.decode_step(caches, tok, s + i))
            tok, ms_pick = host_ms(lambda: engine._pick(logits, hidden, gen))
            timed.append((ms_model, ms_pick))
        caches, tok = prefilled()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches, hidden = model.decode_step(caches, tok, s + i)
                tok = engine._pick(logits, hidden, gen)
            torch.cuda.synchronize()
            traced_ms = 1e3 * (time.perf_counter() - t0) / steps
    records = kernel_records(prof)
    by_name: dict[str, float] = {}
    for name, ms in records:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms / steps
    averages = prof.key_averages()
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
                   for e in averages), key=lambda t: -t[1])[:8]
    busy = sum(ms for _, ms in records) / steps
    per = {"model_ms": float(np.median([m for m, _ in timed])),
           "pick_ms": float(np.median([p for _, p in timed])),
           "traced_step_ms": traced_ms, "device_busy_ms": busy,
           "device_busy_share": busy / traced_ms,
           "device_records_per_step": len(records) / steps,
           "launch_calls_per_step": sum(e.count for e in averages
                                        if e.key.startswith("cudaLaunchKernel")) / steps,
           "top_device_ms_per_step": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]),
           "top_host_ops_per_step": {k: {"self_ms": ms, "calls": n} for k, ms, n in host}}
    for kname in ("radius_search_loop_kernel", "csr_candidate_topk_kernel"):
        pat = re.compile(rf"\b{kname}\b")
        times = [ms for name, ms in records if pat.search(name)]
        per[kname] = {"ms_per_step": sum(times) / steps, "launches_traced": len(times)}
    return per


def left_out_params(cfg) -> int:
    """What `ModelConfig.param_count()` leaves out of the model the port
    builds: the norm scales (norm1 of every layer, norm2 of every layer
    with an MLP, final_norm), the padded experts' wi / wg / wo of every MoE
    layer (3 * n_padded * d_model * d_expert), Mamba's conv_b and dt_bias
    (2 * d_inner), mLSTM's fgate_bias (n_heads) and sLSTM's bias
    (4 * d_inner)."""
    d = cfg.d_model
    n = d
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % cfg.block_period]
        n += d
        if cfg.is_moe_layer(i) or (cfg.d_ff > 0 and kind in ("attn", "mamba")):
            n += d
        if cfg.is_moe_layer(i):
            n += 3 * cfg.moe.n_padded * d * cfg.moe.d_expert
        if kind == "mamba":
            n += 2 * cfg.mamba.expand * d
        elif kind == "mlstm":
            n += cfg.xlstm.n_heads
        elif kind == "slstm":
            din = int(cfg.xlstm.proj_factor_slstm * d)
            n += 4 * (din - din % cfg.xlstm.n_heads)
    return n


def region_ms(model, prompts, regions) -> dict:
    """One prefill of `prompts` with CUDA events around it and around every
    call of each function in `regions` ((module, name) pairs, wrapped for
    the call): the prefill's ms on the card's clock and each function's
    summed ms and share of it."""
    events: dict[str, list] = {name: [] for _, name in regions}
    saved = [(mod, name, getattr(mod, name)) for mod, name in regions]

    def timed(fn, name):
        def wrapped(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events[name].append((start, end))
            return out
        return wrapped

    for mod, name, fn in saved:
        setattr(mod, name, timed(fn, name))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        with torch.no_grad():
            torch.cuda.synchronize()
            start.record()
            model.prefill({"tokens": prompts}, cache_len=prompts.shape[1])
            end.record()
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    total = start.elapsed_time(end)
    out = {"prefill_ms": total}
    for name, evs in events.items():
        ms = sum(s.elapsed_time(e) for s, e in evs)
        out[name] = {"calls": len(evs), "ms": ms, "share": ms / total}
    return out


def drop_free(cfg):
    """`cfg` with the capacity factor n_experts / top_k, which makes every
    group's capacity its size g (an expert takes at most one slot of a
    token), so no token is dropped: for checks that hold one grouping
    against another (a decode step's 8 rows against the forward's 504
    tokens).  The reference's SMOKE configs use 4, which drops at decode
    where 8 rows over 16 experts at top-2 give a capacity of 4."""
    if cfg.moe is None:
        return cfg
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def routed(fn):
    """fn() with a spy on moe.route -> (its result, (top_i, keep)): the
    router's choices (uint8) and kept masks of every call in call order,
    each (groups, g, k)."""
    from repro_torch.models import moe

    real, top_i, keep = moe.route, [], []

    def spy(*args):
        r = real(*args)
        top_i.append(r.top_i.to(torch.uint8))
        keep.append(r.keep)
        return r

    moe.route = spy
    try:
        out = fn()
    finally:
        moe.route = real
    return out, (top_i, keep)


def routed_run(model, toks, prompt: int):
    """lm_run(model, toks, prompt, 1) with a spy on moe.route (`routed`),
    and the rows whose router choices all agree between the forward and
    the prefill (B,) and between the forward and the prefill and decode
    (B,) bool, and the count of (layer, token) choices of k experts that
    differ (all rows agree for a model without MoE)."""
    out, (top_i, _) = routed(lambda: lm_run(model, toks, prompt, 1))
    ids = [torch.sort(t.reshape(-1, t.shape[-1]).long(), dim=-1).values for t in top_i]
    b, n = toks.shape[0], len(ids) // 3           # calls: prefill, decode, forward per layer
    flip_pre = torch.zeros(b, prompt, dtype=torch.bool, device=toks.device)
    flip_dec = torch.zeros(b, 1, dtype=torch.bool, device=toks.device)
    flips = 0
    for pre, dec, fwd in zip(ids[:n], ids[n:2 * n], ids[2 * n:]):
        fwd = fwd[:b * (prompt + 1)].reshape(b, prompt + 1, -1)
        fp = (pre[:b * prompt].reshape(b, prompt, -1) != fwd[:, :prompt]).any(-1)
        fd = (dec[:b].reshape(b, 1, -1) != fwd[:, prompt:]).any(-1)
        flips += int(fp.sum()) + int(fd.sum())
        flip_pre |= fp
        flip_dec |= fd
    agree_pre = ~flip_pre.any(-1)
    return out, agree_pre, agree_pre & ~flip_dec[:, 0], flips


def consistency_check(model, toks, tol, phase) -> dict:
    """A prefill of toks[:, :62], one decode step, and the training forward
    over 63 tokens: the prefill's and the decode's logits against the
    forward's, held to `tol` (and the decode's top-1 to 0.5) unless `tol`
    is None (then only printed).  An MoE model's router can choose other
    experts for a token in the forward than in the prefill or decode, where
    a near-tie rounds the other way; such a flip moves the rest of its row.
    The flips are counted, and only the rows free of them are held (at
    least one must be)."""
    (lg_p, _, dec, full), agree_pre, agree_dec, flips = routed_run(model, toks, 62)
    pairs = (("prefill", lg_p, full[:, 61], agree_pre), ("decode", dec[0][0], full[:, 62], agree_dec))
    out = {f"{name}_max_abs_err": float((a.float() - b.float()).abs().max())
           for name, a, b, _ in pairs}
    out.update({f"{name}_rows_held": int(rows.sum()) for name, _, _, rows in pairs})
    out.update({f"{name}_held_max_abs_err": float((a[rows].float() - b[rows].float()).abs().max())
                if rows.any() else None for name, a, b, rows in pairs})
    top1 = dec[0][0].argmax(-1) == full[:, 62].argmax(-1)
    out.update({"decode_top1": float(top1.float().mean()),
                "decode_held_top1": float(top1[agree_dec].float().mean()) if agree_dec.any()
                else None,
                "router_flips": flips, "max_abs_logit": float(full[:, 61:63].abs().max()),
                "rows": toks.shape[0],
                "capacity_factor": model.cfg.moe.capacity_factor if model.cfg.moe else None,
                "tolerance": tol})
    if tol is not None:
        for name, a, b, rows in pairs:
            check(bool(rows.any()), f"phase {phase} {name}: router flips in every row {out}")
            close(a[rows], b[rows], tol, f"phase {phase} {name} against forward")
        check(out["decode_held_top1"] >= 0.5, f"phase {phase}: decode top-1 {out}")
    return out


def lm_serving(seed, api, mods, smi, cfg, phase: str, label: str, n_seqs=256, new=32,
               reduced=None, regions=(), f32_consistency=False) -> list:
    """Serving at `cfg`'s width and depth in bf16 with random weights on
    the card from generator `seed`: the model's own prefill / decode
    consistency against its training forward (`consistency_check` at the
    reference's tolerance; an MoE model at a drop-free capacity factor
    (`drop_free`), the real one's gap printed beside it; with
    `f32_consistency`, the same weights in float32 first, alone on the
    card, held at F32_CARD_TOL);
    build_datastore_from_model over `n_seqs` random sequences of 1,024
    tokens (labels equal to corpus[:, 1:] in order); then Engine.generate
    with the kNN-LM head (KNNLMConfig's defaults, `hopper`) on 8 prompts of
    512 tokens, `new` greedy tokens, timed by the engine's own clock: one
    radius_search_loop and one csr_candidate_topk per pick; afterwards, at
    every pick (the prefill's last hidden and the hiddens generate
    returns), `hopper` equal to `torch` on the same hidden and handle (ids
    but for near-ties, distances within rtol 1e-5), recall@k against
    `exact`; the online flow (queue_datastore_pairs, drain_datastore:
    n_points grows by exactly the pairs queued, their labels the stream's
    next tokens); a second generate on new prompts over the grown
    datastore; a traced run of 8 decode steps; and, for each function in
    `regions`, its share of one prefill of the prompts.  Returns the
    counted runs' launches."""
    from repro_torch.core import knn_lm
    from repro_torch.launch import serve
    from repro_torch.models.model import DecoderLM

    seq_len, n_prompts, prompt_len, profile_steps = 1024, 8, 512, 8
    knn_cfg = knn_lm.KNNLMConfig()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (n_prompts, 64), generator=gen, device=DEV)
    consistency = {}
    if f32_consistency:
        # the same weights in float32, alone on the card, held at float32's tolerance
        with f32_activations():
            m32 = DecoderLM(drop_free(cfg), device=DEV,
                            generator=torch.Generator(device=DEV).manual_seed(seed))
            consistency["float32"] = consistency_check(m32, toks, F32_CARD_TOL, phase)
        del m32
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = host_ms(lambda: DecoderLM(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed)))
    n_params, n_bytes = model_size(model)
    expected = cfg.param_count() + left_out_params(cfg)
    check(n_params == expected, f"phase {phase}: {n_params} parameters, the config counts "
                                f"{cfg.param_count()} + {left_out_params(cfg)} left out")

    # the model's own consistency: prefill of S-2 tokens, one decode step
    # (an MoE model at a drop-free capacity factor)
    model.cfg = drop_free(cfg)
    try:
        consistency["bfloat16"] = consistency_check(model, toks, MODEL_TOL, phase)
    finally:
        model.cfg = cfg
    if cfg.moe is not None:
        consistency[f"bfloat16_capacity_factor_{cfg.moe.capacity_factor}"] = consistency_check(
            model, toks, None, phase)

    corpus = torch.randint(0, cfg.vocab_size, (n_seqs, seq_len), generator=gen, device=DEV)
    index, harvest_ms = host_ms(lambda: serve.build_datastore_from_model(
        cfg, model, corpus, knn_cfg))
    pairs = n_seqs * (seq_len - 1)
    order = torch.argsort(index.ids_sorted.long())
    check(index.n_points == pairs and torch.equal(index.labels_sorted[order],
                                                  corpus[:, 1:].reshape(-1)),
          f"phase {phase}: the datastore's labels are not corpus[:, 1:] in order")
    harvest_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    HARVEST_S[phase] = harvest_ms / 1e3
    del corpus, order

    engine = serve.Engine(cfg, model, serve.ServeConfig(max_new_tokens=new, knn=knn_cfg), index,
                          device=DEV)
    prompts = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len), generator=gen, device=DEV)
    engine.generate(prompts[:2, :64], 4)                      # warm-up, not counted

    def counted_generate(label):
        """One generate with the counters zeroed just before and read just
        after; its readings (the decode steps' ms from the engine's own
        stats), tokens and hiddens."""
        prefill_s, decode_s = engine.stats["prefill_s"], engine.stats["decode_s"]
        reset(mods)
        (toks_out, hiddens), ms = host_ms(lambda: engine.generate(prompts, new))
        launches = counts(mods)
        check(launches["radius_search_loop"] == new and launches["csr_candidate_topk"] == new,
              f"phase {phase} {label} generate: {new} picks launched {launches}")
        check(toks_out.shape == (n_prompts, new) and toks_out.device.type == DEV.type
              and bool(((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()),
              f"phase {phase} {label} generate: tokens out of range")
        reading = {"wall_ms": ms, "tokens_per_s": 1e3 * n_prompts * new / ms,
                   "prefill_ms": 1e3 * (engine.stats["prefill_s"] - prefill_s),
                   "decode_ms_per_step": 1e3 * (engine.stats["decode_s"] - decode_s) / (new - 1),
                   "launches": launches}
        return reading, toks_out, hiddens

    torch.cuda.reset_peak_memory_stats()
    first, toks_out, hiddens = counted_generate("first")

    # the hidden of every pick: the prefill's last (a prefill of the same
    # prompts, whose pick must give the first token again) and the decode
    # steps' that generate returns
    with torch.no_grad():
        logits, caches, h0 = model.prefill({"tokens": prompts}, cache_len=prompt_len + new)
        tok0 = engine._pick(logits, h0, torch.Generator(device=DEV))
    check(torch.equal(tok0, toks_out[:, 0]),
          f"phase {phase}: the prefill's pick differs from generate's")
    pick_hidden = [h.float() for h in [h0, *hiddens]]
    del logits, caches

    # at every pick, the head's `hopper` search equals a `torch` search of
    # the same hidden on the same handle: the same validity, distances
    # within rtol 1e-5, ids equal but for near-ties (the kernel and the
    # plain path sum d products in different orders), which are counted;
    # recall@k against `exact`
    hop = api.ActiveSearcher.from_index(engine.datastore, knn_cfg.grid, plan=knn_cfg.plan,
                                        device=DEV)
    per_query = hop.with_plan(backend="torch")
    row_of = torch.argsort(hop.index.ids_sorted.long())        # id -> CSR row

    def rows(ids):
        return torch.where(ids >= 0, row_of[ids.long().clamp_min(0)], ids.long())

    max_err, swaps, hop_ids, valid = 0.0, 0, [], []
    for i, h in enumerate(pick_hidden):
        a = hop.search(h, knn_cfg.k, mode="refined")
        b = per_query.search(h, knn_cfg.k, mode="refined")
        check(torch.equal(a.valid, b.valid), f"phase {phase} pick {i}: hopper's validity differs")
        err, sw = compare_topk((a.dists, rows(a.ids)), (b.dists, rows(b.ids)),
                               hop.index.points_sorted, h, "l2", 1e-5)
        max_err, swaps = max(max_err, err), swaps + sw
        hop_ids.append(a.ids)
        valid.append(a.valid)
    all_h = torch.cat(pick_hidden)
    reset(mods)
    truth = hop.with_plan(backend="exact").search(all_h, knn_cfg.k)
    torch.cuda.synchronize()
    exact_launches = counts(mods)
    rec = recall(torch.cat(hop_ids), truth.ids, knn_cfg.k)
    del hop, per_query, row_of, truth, pick_hidden, all_h

    # the --knn-online flow: the first stream's pairs queued, then drained
    n0 = engine.datastore.n_points
    added = engine.queue_datastore_pairs(hiddens, toks_out)
    backlog = engine.datastore_queue().stats["insert_backlog"]
    applied, drain_ms = host_ms(engine.drain_datastore)
    check(added == applied == backlog == n_prompts * (new - 1)
          and engine.datastore.n_points == n0 + added,
          f"phase {phase}: queued {added}, applied {applied}, n_points {n0} -> "
          f"{engine.datastore.n_points}")
    ids = engine.datastore.ids_sorted.long()
    check(torch.equal(engine.datastore.labels_sorted[torch.argsort(ids)][n0:],
                      toks_out[:, 1:].T.reshape(-1)),
          f"phase {phase}: the grown datastore's labels are not the stream's next tokens")
    del ids, hiddens
    prompts = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len), generator=gen, device=DEV)
    second, _, _ = counted_generate("second")
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    prof = lm_device_profile(engine, prompts, profile_steps)
    emit({
        "phase": phase, "config": label, **({"reduced": reduced} if reduced else {}),
        "nvidia_smi": smi, "params": n_params, "param_bytes": n_bytes, "init_ms": init_ms,
        "consistency": consistency,
        "harvest": {"sequences": n_seqs, "seq_len": seq_len, "pairs": pairs,
                    "batch_size": serve.HARVEST_BATCH, "s": harvest_ms / 1e3, "tokens_per_s": 1e3 * n_seqs * seq_len / harvest_ms,
                    "peak_mem_gb": harvest_peak_gb},
        "knn": {"k": knn_cfg.k, "lam": knn_cfg.lam, "plan": knn_cfg.plan.backend,
                "grid_size": knn_cfg.grid.grid_size, "window": knn_cfg.grid.window,
                "row_cap": knn_cfg.grid.row_cap},
        "prompts": n_prompts, "prompt_len": prompt_len, "new_tokens": new,
        "generate": {"first": first, "second_on_grown_datastore": second},
        "online_insert": {"pairs": added, "drain_ms": drain_ms,
                          "n_points": [n0, engine.datastore.n_points]},
        "hopper_vs_torch_per_pick": {"picks": new, "max_abs_dist_err": max_err,
                                     "tie_swaps": swaps},
        "recall_at_k_vs_exact": rec, "valid_frac": float(torch.cat(valid).float().mean()),
        "exact_launches": exact_launches,
        "decode_profile": {"steps": profile_steps, **prof},
        **({"prefill_regions": region_ms(model, prompts, regions)} if regions else {}),
        "peak_mem_gb": {"harvest": harvest_peak_gb, "serve": serve_peak_gb},
    })
    return [first["launches"], second["launches"], exact_launches]


def phase7_serving(seed, api, mods, smi, cfg=None, n_seqs=256) -> list:
    """7b, serving at minitron-8b's full width and depth (CONFIG, bf16, or
    `cfg`) through `lm_serving`.  Returns the counted runs' launches."""
    from repro_torch.configs import get_config

    return lm_serving(seed + 72, api, mods, smi, cfg or get_config("minitron-8b"), "7b",
                      "minitron-8b CONFIG (32 layers, d_model 4096, 32 heads over 8 KV heads "
                      "of 128, d_ff 16384, vocab 256,000), bf16, random weights", n_seqs=n_seqs)


# ----------------------------------------------------------------- phase 8 ---


def moe_equations(seed, cfg) -> dict:
    """One moe_block over 2 x 64 tokens at `cfg`'s full width in float32,
    weights drawn on the card and copied to the CPU: output and aux loss
    within F32_CARD_TOL, the router's top-k ids and kept mask equal, card
    against CPU."""
    from repro_torch.models import moe

    batch, s = 2, 64
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = moe.init_moe(gen, cfg, DEV)
    x = torch.randn((batch, s, cfg.d_model), generator=gen, device=DEV)
    ng, g, cap = moe.group_shape(cfg, batch * s)
    check(ng * g == batch * s, f"{cfg.name}: {batch * s} tokens are not whole groups of {g}")

    def run(p, xx):
        with torch.no_grad():
            y, aux = moe.moe_block(p, cfg, xx)
            return y, aux, moe.route(p, cfg, xx.reshape(ng, g, -1), cap)

    (y_c, aux_c, r_c), card_ms = host_ms(lambda: run(params, x))
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    params = tree_to(params, "cpu")
    t0 = time.perf_counter()
    y_h, aux_h, r_h = run(params, x.cpu())
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    del params
    check(torch.equal(r_c.top_i.cpu(), r_h.top_i) and torch.equal(r_c.keep.cpu(), r_h.keep),
          f"{cfg.name}: the router's choices differ, card against CPU")
    return {"experts": cfg.moe.n_total, "top_k": cfg.moe.top_k, "d_expert": cfg.moe.d_expert,
            "tokens": batch * s, "group": g, "capacity": cap,
            "dropped_slots": int((~r_h.keep).sum()), "weight_gb_float32": weight_bytes / 1e9,
            "router_choices_equal": True,
            "max_abs_err": {"y": close(y_c, y_h, F32_CARD_TOL, f"{cfg.name} moe_block"),
                            "aux": close(aux_c, aux_h, F32_CARD_TOL, f"{cfg.name} aux"),
                            "probs": close(r_c.probs, r_h.probs, F32_CARD_TOL,
                                           f"{cfg.name} router probs")},
            "card_ms": card_ms, "cpu_ms": cpu_ms}


def leaves(tree: dict) -> list:
    """The tensors of a nested dict."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def mamba_equations(seed, cfg) -> dict:
    """One Mamba sublayer at `cfg`'s full width in float32, 2 rows: a
    prefill of 64 tokens, then 4 decode steps, and the training form over
    all of them, on the card and on the CPU: outputs and both cache states
    within F32_CARD_TOL, and on each side the decode outputs equal to the
    training form's at the same positions."""
    from repro_torch.models import mamba

    batch, prompt, steps = 2, 64, 4
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = mamba.init_mamba(gen, cfg, DEV)
    x = torch.randn((batch, prompt + steps, cfg.d_model), generator=gen, device=DEV)

    def run(p, xx):
        with torch.no_grad():
            out, cache = mamba.mamba_prefill(p, cfg, xx[:, :prompt])
            pre_cache, dec = dict(cache), []
            for i in range(steps):
                o, cache = mamba.mamba_decode_step(p, cfg, xx[:, prompt + i:prompt + i + 1], cache)
                dec.append(o)
            return out, pre_cache, cache, torch.cat(dec, dim=1), mamba.mamba_block(p, cfg, xx)

    card, card_ms = host_ms(lambda: run(params, x))
    t0 = time.perf_counter()
    cpu = run(tree_to(params, "cpu"), x.cpu())
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    errs = {"prefill": close(card[0], cpu[0], F32_CARD_TOL, "mamba prefill"),
            "decode": close(card[3], cpu[3], F32_CARD_TOL, "mamba decode"),
            "forward": close(card[4], cpu[4], F32_CARD_TOL, "mamba forward")}
    for j, when in ((1, "prefill"), (2, "decode")):
        for key in ("conv", "ssm"):
            errs[f"{when}_cache_{key}"] = close(card[j][key], cpu[j][key], F32_CARD_TOL,
                                                f"mamba {when} cache {key}")
    dec_fwd = max(close(side[3], side[4][:, prompt:], F32_CARD_TOL, f"mamba {name}: decode "
                        "against forward") for name, side in (("card", card), ("cpu", cpu)))
    return {"d_inner": cfg.mamba.expand * cfg.d_model, "d_state": cfg.mamba.d_state,
            "batch": batch, "prompt": prompt, "decode_steps": steps,
            "card_vs_cpu_max_abs_err": errs, "decode_vs_forward_max_abs_err": dec_fwd,
            "card_ms": card_ms, "cpu_ms": cpu_ms}


def phase8_equations(seed, smi, moe_cfgs=None, mamba_cfg=None, xlstm_cfg=None) -> None:
    """8a, the MoE, Mamba and xLSTM equations at full width in float32,
    card against CPU at F32_CARD_TOL: one moe_block at qwen2-moe-a2.7b's
    width (64 experts of 2048 x 1408, top-4, the shared MLP) and one at
    jamba's (16 x 4096 x 14,336, top-2), with the router's choices equal;
    one Mamba sublayer at jamba's width; xlstm-125m whole (lm_equations,
    at F32_DEEP_TOL: 12 layers)."""
    from repro_torch.configs import get_config

    moe_cfgs = moe_cfgs or [get_config("qwen2-moe-a2.7b"), get_config("jamba-v0.1-52b")]
    mamba_cfg = mamba_cfg or get_config("jamba-v0.1-52b")
    xlstm_cfg = xlstm_cfg or get_config("xlstm-125m")
    with f32_activations():
        moe_out = {}
        for i, cfg in enumerate(moe_cfgs):
            moe_out[cfg.name] = moe_equations(seed + 80 + i, cfg)
            torch.cuda.empty_cache()
        mamba_out = mamba_equations(seed + 82, mamba_cfg)
    emit({"phase": "8a", "nvidia_smi": smi, "tolerance": F32_CARD_TOL, "moe_block": moe_out,
          "mamba_sublayer": {mamba_cfg.name: mamba_out},
          "xlstm": {xlstm_cfg.name: lm_equations(seed + 83, xlstm_cfg, tol=F32_DEEP_TOL)}})


def phase8_serving(seed, api, mods, smi, cfgs=None, n_seqs=(256, 32, 32), new=(32, 16, 16)):
    """8b, qwen2-moe-a2.7b's CONFIG at full width and depth (24 layers),
    and 8c, jamba-v0.1-52b at full width with its depth cut to one period
    (8 of 32 layers: 103 GB of bf16 weights do not fit one card) and
    xlstm-125m whole, each through `lm_serving` (or `cfgs`, three
    configs); 8c also times the selective scan's and the sLSTM loop's
    share of one prefill.  The two MoE models' prefill / decode
    consistency is held in float32 too, every row: in bf16 a router's
    near-tie can flip between the forward's and the prefill's rounding,
    and only the rows free of flips are held there.  Returns the counted
    runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba, xlstm

    jamba = get_config("jamba-v0.1-52b")
    cfgs = cfgs or [get_config("qwen2-moe-a2.7b"),
                    dataclasses.replace(jamba, n_layers=jamba.block_period),
                    get_config("xlstm-125m")]
    runs = lm_serving(
        seed + 84, api, mods, smi, cfgs[0], "8b",
        "qwen2-moe-a2.7b CONFIG (24 layers, d_model 2048, 16 heads of 128, 60 routed experts "
        "padded to 64 at top-4 of d_expert 1408, a shared MLP of 5632, vocab 151,936), bf16, "
        "random weights", n_seqs=n_seqs[0], new=new[0], f32_consistency=True)
    runs += lm_serving(
        seed + 86, api, mods, smi, cfgs[1], "8c",
        "jamba-v0.1-52b CONFIG at full width (d_model 4096, Mamba d_inner 8192, 32 heads over "
        "8 KV heads, 16 experts of 14,336 at top-2, vocab 65,536), bf16, random weights",
        n_seqs=n_seqs[1], new=new[1], regions=[(mamba, "mamba_scan")], f32_consistency=True,
        reduced=f"n_layers {jamba.n_layers} -> {cfgs[1].n_layers} (one period: 7 Mamba, 1 "
                "attention, 4 MoE layers; 103 GB of bf16 weights at 32 layers do not fit one card)")
    runs += lm_serving(
        seed + 88, api, mods, smi, cfgs[2], "8c",
        "xlstm-125m CONFIG (12 layers: 10 mLSTM, 2 sLSTM; d_model 768, 4 heads, vocab 50,304), "
        "bf16, random weights", n_seqs=n_seqs[2], new=new[2],
        regions=[(xlstm, "_slstm_scan")])
    return runs


# ----------------------------------------------------------------- phase 9 ---

# the H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet), for the
# train step's model-FLOPs share
BF16_TENSOR_OPS_PER_S = 989e12
# float32 on the card against the CPU for a train step's state (9a): the
# parameters as tests/test_torch_steps.py holds them against the
# reference's (an element whose gradient sits at float32's noise floor can
# take an update of up to the learning rate: at most 1e-4 of them, each
# within 2.5 learning rates)
NOISE_FLOOR_SHARE = 1e-4


def hold_state(got: dict, want: dict, lr: float, tol: dict, what: str) -> dict:
    """A train state against another: step and count equal, moments within
    `tol`, parameters within `tol` but for noise-floor elements.  Returns
    the largest errors and the noise-floor count."""
    from repro_torch.utils import tree

    check(int(got["step"]) == int(want["step"]) and
          int(got["opt"].count) == int(want["opt"].count), f"{what}: step counters differ")

    def diffs(part):
        """(path, |got - want|, want) per leaf, on got's device."""
        for (k, a), (_, b) in zip(tree.leaves_with_path(part(got)), tree.leaves_with_path(
                part(want))):
            b = b.to(a.device)
            yield k, (a - b).abs(), b

    errs = {}
    for name, part in (("mu", lambda s: s["opt"].mu), ("nu", lambda s: s["opt"].nu)):
        errs[name] = 0.0
        for k, d, b in diffs(part):
            errs[name] = max(errs[name], float(d.max()))
            check(bool((d <= tol["atol"] + tol["rtol"] * b.abs()).all()),
                  f"{what}: {name} {k} off by {float(d.max())} beyond {tol}")
    off = total = 0
    worst = 0.0
    for k, d, b in diffs(lambda s: s["params"]):
        worst = max(worst, float(d.max()))
        check(worst <= 2.5 * lr + tol["atol"], f"{what}: params {k} off by {float(d.max())}")
        off += int((d > tol["atol"] + tol["rtol"] * b.abs()).sum())
        total += d.numel()
    check(off <= NOISE_FLOOR_SHARE * total, f"{what}: {off} of {total} parameters off")
    return {**errs, "params": worst, "params_at_noise_floor": off}


def phase9_train_equations(seed, smi, cfg=None) -> None:
    """9a, the train step's equations at internlm2-1.8b's widths at depth 2
    (or `cfg`) in float32 (the port's ACT_DTYPE switched for the phase):
    the state drawn on the card from generator `seed` and copied to the
    CPU, 3 steps of make_train_step (bf16_compute_copy=False, accum 2,
    2 x 64 tokens) on the same synthetic batches on both: loss, grad_norm
    and lr, and
    the moments and parameters after each step within rtol / atol 1e-4
    (the parameters but for noise-floor elements); then one step with
    remat="full" against remat="none" on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as st
    from repro_torch.optim import adamw
    from repro_torch.utils import tree

    cfg = cfg or dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2)
    steps, batch, seq, accum = 3, 2, 64, 2
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    step_cfg = st.StepConfig(accum=accum, bf16_compute_copy=False)
    dc = DataConfig(global_batch=batch, seq_len=seq, vocab_size=cfg.vocab_size, seed=seed)
    rows, card_ms, cpu_ms = [], [], []
    with f32_activations():
        card = st.init_train_state(torch.Generator(device=DEV).manual_seed(seed + 90), cfg,
                                   opt_cfg, step_cfg, DEV)
        cpu = tree.map(lambda t: t.cpu(), card)
        start = tree.map(torch.clone, card)
        step = st.make_train_step(cfg, opt_cfg, step_cfg)
        for i in range(steps):
            hb = synth_batch(dc, i)
            (card, mc), ms = host_ms(lambda: step(card, {k: torch.from_numpy(v).to(DEV)
                                                         for k, v in hb.items()}))
            card_ms.append(ms)
            t0 = time.perf_counter()
            cpu, mh = step(cpu, {k: torch.from_numpy(v) for k, v in hb.items()})
            cpu_ms.append(1e3 * (time.perf_counter() - t0))
            row = {"step": i, **{k: float(mc[k]) for k in ("loss", "grad_norm", "lr")}}
            for k in ("loss", "grad_norm", "lr"):
                row[f"{k}_err"] = close(mc[k], mh[k], F32_CARD_TOL, f"9a step {i} {k}")
            row["max_abs_err"] = hold_state(card, cpu, float(mc["lr"]), F32_CARD_TOL,
                                            f"9a step {i}")
            rows.append(row)
        del cpu
        # remat changes no number: one step from the same state, both ways
        hb = {k: torch.from_numpy(v).to(DEV) for k, v in synth_batch(dc, 0).items()}
        outs = {}
        for remat in ("none", "full"):
            rcfg = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, remat=remat))
            torch.cuda.reset_peak_memory_stats()
            (state, m), ms = host_ms(lambda: st.make_train_step(rcfg, opt_cfg, step_cfg)(
                tree.map(torch.clone, start), hb))
            outs[remat] = (state, m, ms, torch.cuda.max_memory_allocated() / 1e9)
        (sn, mn, msn, pkn), (sf, mf, msf, pkf) = outs["none"], outs["full"]
        remat_err = hold_state(sf, sn, float(mn["lr"]), F32_CARD_TOL, "9a remat full vs none")
        bit_equal = all(torch.equal(a, b) for a, b in zip(tree.leaves(sf), tree.leaves(sn)))
        loss_equal = float(mf["loss"]) == float(mn["loss"])
    n_params = sum(p.numel() for p in tree.leaves(start["params"]))
    emit({"phase": "9a", "config": f"internlm2-1.8b widths at depth {cfg.n_layers}, float32, "
                                   f"bf16_compute_copy False, accum {accum}",
          "nvidia_smi": smi, "params": n_params, "batch": batch, "seq": seq, "steps": rows,
          "tolerance": F32_CARD_TOL, "card_ms": card_ms, "cpu_ms": cpu_ms,
          "remat_full_vs_none": {"loss_equal": loss_equal, "state_bit_equal": bit_equal,
                                 "max_abs_err": remat_err, "ms": {"none": msn, "full": msf},
                                 "peak_mem_gb": {"none": pkn, "full": pkf}}})


TRAIN_DIR = ROOT / "build" / "chip_smoke_train"


def phase9_training(seed, smi, cfg=None) -> tuple:
    """9b, training at internlm2-1.8b's CONFIG (24 layers, full width; or
    `cfg`) through launch/train.py: `run` with bf16_compute_copy=True,
    remat "full" and accum 4 (the config's), 20 steps of 8 x 1,024
    synthetic tokens, a checkpoint every 12 steps under build/ (removed
    after): the loss must fall.  A checkpoint of the full state is 22.7 GB
    and a call may write 45 GiB to the machine's disk, so the run writes
    one (at step 12).  Then a fresh directory holding a hard link of that
    checkpoint and `run` again with a fault injected at step 15: the first
    attempt resumes there and fails, the supervisor restarts from that
    checkpoint to the same final step, and the restarted train_loop's
    losses from the checkpoint on are held against the uninterrupted
    run's within rel 1e-6 (room for a few float32 ulps of the loss should
    the card sum in another order; bit-equality reported).
    Step ms (median past the first step), tokens/s, peak memory and
    6·N·tokens a step over the step time as a share of the card's dense
    bf16 peak.  Returns the directory holding the step-12 checkpoint
    (phase 10c restores it onto a mesh; the caller removes TRAIN_DIR), the
    step, and the uninterrupted run's losses."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils import tree

    cfg = cfg or get_config("internlm2-1.8b")
    steps, batch, seq, every, fail_at = 20, 8, 1024, 12, 15
    root = TRAIN_DIR
    shutil.rmtree(root, ignore_errors=True)
    log: list = []
    try:
        tc = train.TrainConfig(steps=steps, batch=batch, seq=seq, ckpt_dir=str(root / "whole"),
                               ckpt_every=every, log_every=1, seed=seed)
        torch.cuda.reset_peak_memory_stats()
        whole, whole_ms = host_ms(lambda: train.run(cfg, tc, device=DEV, log=log.append))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = whole["losses"]
        check(whole["final_step"] == steps and len(losses) == steps,
              f"9b: the uninterrupted run ended at {whole['final_step']}")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"9b: the loss did not fall: {losses[0]} -> {losses[-1]}")
        n_params = sum(p.numel() for p in tree.leaves(whole["state"]["params"]))
        state_gb = sum(t.numel() * t.element_size() for t in tree.leaves(whole["state"])) / 1e9
        del whole["state"]
        torch.cuda.empty_cache()
        # the recovery: a fresh directory with only the step-`every` checkpoint
        resumed = root / "resumed"
        resumed.mkdir()
        shutil.copytree(root / "whole" / f"step_{every}", resumed / f"step_{every}",
                        copy_function=os.link)     # links: a checkpoint is tens of GB
        shutil.rmtree(root / "whole")
        tc2 = dataclasses.replace(tc, ckpt_dir=str(resumed), fail_at=fail_at)
        log2: list = []
        again, again_ms = host_ms(lambda: train.run(cfg, tc2, device=DEV, log=log2.append))
        check(again["final_step"] == steps, f"9b: the recovered run ended at {again['final_step']}")
        check(tc2.fail_at == -1 and sum("restart 1 after" in x for x in log2) == 1
              and sum(f"resumed from checkpoint step {every}" in x for x in log2) == 2,
              f"9b: the fault and the restart did not happen as expected: {log2}")
        tail = losses[every:]
        check(len(again["losses"]) == len(tail) and all(
            math.isclose(a, b, rel_tol=1e-6) for a, b in zip(again["losses"], tail)),
            f"9b: the resumed losses {again['losses']} differ from {tail}")
        secs = whole["seconds"][1:]
        step_s = float(np.median(secs))
        tokens = batch * seq
        emit({
            "phase": "9b", "config": "internlm2-1.8b CONFIG (24 layers, d_model 2048, 16 heads "
                                     "over 8 KV heads of 128, d_ff 8192, vocab 92,544), float32 "
                                     "masters, bf16 compute copy, remat full, accum 4, random "
                                     "init from the seed",
            "reduced": f"batch {batch} x seq {seq} tokens a step (train_4k: 256 x 4,096), "
                       f"{steps} steps, one checkpoint (at step {every}: each is "
                       f"{state_gb:.1f} GB, and a call may write 45 GiB to disk)",
            "nvidia_smi": smi, "params": n_params, "state_gb": state_gb,
            "steps": steps, "batch": batch, "seq": seq, "accum": cfg.policy.accum,
            "losses": losses,
            "step_ms": {"median": 1e3 * step_s, "min": 1e3 * min(secs), "max": 1e3 * max(secs),
                        "first": 1e3 * whole["seconds"][0]},
            "tokens_per_s": tokens / step_s,
            "model_flops_share_of_bf16_peak":
                6 * n_params * tokens / step_s / BF16_TENSOR_OPS_PER_S,
            "peak_mem_gb": peak_gb, "run_s": whole_ms / 1e3,
            "recovery": {"fail_at": fail_at, "resumed_from": every, "rel_tol": 1e-6,
                         "final_step": again["final_step"],
                         "run_s": again_ms / 1e3, "losses": again["losses"],
                         "bit_equal_to_uninterrupted": again["losses"] == tail,
                         "max_rel_loss_err": max(abs(a - b) / abs(b) for a, b in
                                                 zip(again["losses"], tail))},
            "checkpoints_every": every,
        })
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    return str(resumed), every, losses


def phase9_retrieval_step(seed, api, mods, smi, cfg=None, positions=262_144) -> list:
    """9c, make_retrieval_serve_step at minitron-8b's CONFIG (32 layers,
    9.88 B parameters in bf16, random weights; or `cfg`), batch 1, a cache
    of `positions` filled with random K/V from the seed, the memory index
    over layer 0's key summaries (RetrievalMemoryConfig's defaults):
    16 decode steps at the cache's last positions, each one
    radius_search_loop and one csr_candidate_topk (counted); then at every
    step the retrieved positions held against the same search on `torch`
    (ids equal up to counted near-ties) and the logits against decode_step
    called with those positions.  Returns the counted launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import retrieval_memory as rm
    from repro_torch.launch import steps as st
    from repro_torch.models.model import DecoderLM, init_caches

    cfg = cfg or get_config("minitron-8b")
    steps = 16
    mem = rm.RetrievalMemoryConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(seed + 95)
    model = DecoderLM(cfg, device=DEV, generator=gen)
    n_params, n_bytes = model_size(model)
    caches = init_caches(cfg, 1, positions, device=DEV)
    for c in caches:
        for state in c.values():
            state.normal_(generator=gen)
    keys = rm.key_summary(caches[0]["k"][0, 0])                        # layer 0: (T, hd)
    index, build_ms = host_ms(lambda: rm.build_memory_index(
        keys, mem, rm.make_projection(gen, cfg.head_dim)))
    tokens = torch.randint(0, cfg.vocab_size, (steps, 1), generator=gen, device=DEV)
    pos0 = positions - steps
    step = st.make_retrieval_serve_step(cfg, mem)
    step(model, caches, index, tokens[0], pos0)                        # warm-up, not counted
    torch.cuda.synchronize()
    reset(mods)
    outs, step_ms = [], []
    for i in range(steps):
        out, ms = host_ms(lambda: step(model, caches, index, tokens[i], pos0 + i))
        outs.append(out)
        step_ms.append(ms)
    launches = counts(mods)
    check(launches["radius_search_loop"] == steps and launches["csr_candidate_topk"] == steps,
          f"phase 9c: {steps} steps launched {launches}")
    # afterwards: `hopper` against `torch` on each step's query, and the
    # logits against decode_step given the same positions
    hopper = api.ActiveSearcher.from_index(index, mem.grid, device=DEV)
    plain = hopper.with_plan(backend="torch")
    err, swaps, logit_err, bit_equal, valid = 0.0, 0, 0.0, True, []
    for i in range(steps):
        q = st.retrieval_query(model, tokens[i])
        rh, rt = hopper.search(q, mem.n_retrieved), plain.search(q, mem.n_retrieved)
        e, s = compare_topk((rh.dists, rh.ids), (rt.dists, rt.ids), keys, q, "l2", 1e-5)
        err, swaps = max(err, e), swaps + s
        got_pos, ok = st.retrieve(model, index, tokens[i], pos0 + i, mem)
        check(torch.equal(got_pos, torch.clamp_min(rh.ids, 0)), f"9c step {i}: positions differ")
        valid.append(float(ok.float().mean()))
        with torch.no_grad():
            want, _, _ = model.decode_step(caches, tokens[i], pos0 + i,
                                           retrieved=(got_pos, ok, mem.local_window))
        logit_err = max(logit_err, close(outs[i][0], want, MODEL_TOL, f"9c step {i} logits"))
        bit_equal = bit_equal and torch.equal(outs[i][0], want)
        check(bool(torch.isfinite(outs[i][0]).all()), f"9c step {i}: logits not finite")
    check(max(valid) > 0, "9c: no step retrieved a valid position")
    emit({
        "phase": "9c", "config": "make_retrieval_serve_step, minitron-8b CONFIG (32 layers, "
                                 "d_model 4096, 32 heads over 8 KV heads of 128, vocab 256,000), "
                                 "bf16, random weights; RetrievalMemoryConfig's defaults",
        "reduced": f"cache of {positions} positions (long_500k: 524,288), batch 1",
        "nvidia_smi": smi, "params": n_params, "param_bytes": n_bytes,
        "cache_gb": sum(nbytes(c.values()) for c in caches) / 1e9,
        "positions": positions, "n_retrieved": mem.n_retrieved, "local_window": mem.local_window,
        "index_build_ms": build_ms, "steps": steps,
        "ms_per_step": {"median": float(np.median(step_ms)), "min": min(step_ms),
                        "max": max(step_ms)},
        "hopper_vs_torch": {"max_abs_dist_err": err, "tie_swaps": swaps},
        "logits_vs_decode_step": {"max_abs_err": logit_err, "bit_equal": bit_equal},
        "valid_frac": valid, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    })
    return [launches]


def phase9_moe_harvest(seed, smi, cfg=None, n_seqs=256) -> None:
    """9d, the harvest of an MoE model whose GShard groups no batch of
    whole sequences holds: qwen2-moe-a2.7b's CONFIG at full width and
    depth (bf16, random weights; or `cfg`) over `n_seqs` x 1,023 random
    tokens (g = 512 and S = 1023 share no factor: 511.5 groups a layer at
    256 sequences, the last padded).  build_datastore_from_model runs
    layer-major; with a spy on moe.route in both runs, its router's choices
    and kept masks must equal, group by group in every MoE layer, those of
    one forward over the whole corpus on the card (the reference's
    harvest), so every group boundary and capacity drop is the
    reference's; its keys (in corpus order) are held against that
    forward's hidden states at the model tolerance, with the share of
    bit-equal rows."""
    from repro_torch.configs import get_config
    from repro_torch.core import knn_lm
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import DecoderLM

    cfg = cfg or get_config("qwen2-moe-a2.7b")
    seq_len = 1023
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(seed + 97)
    model = DecoderLM(cfg, device=DEV, generator=gen)
    corpus = torch.randint(0, cfg.vocab_size, (n_seqs, seq_len), generator=gen, device=DEV)
    # the reference's harvest first, while nothing else is held: one
    # forward over the whole corpus (every MoE layer over all its groups
    # at once: ~40 GB of dispatch tensors beside 30 GB of weights)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (one, want_route), forward_ms = host_ms(lambda: routed(
            lambda: model.hidden_states({"tokens": corpus})))
    want = one[:, :-1].reshape(-1, cfg.d_model).clone()
    del one
    forward_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (index, got_route), harvest_ms = host_ms(lambda: routed(
        lambda: serve.build_datastore_from_model(cfg, model, corpus, knn_lm.KNNLMConfig())))
    harvest_peak = torch.cuda.max_memory_allocated() / 1e9
    order = torch.argsort(index.ids_sorted.long())
    check(torch.equal(index.labels_sorted[order], corpus[:, 1:].reshape(-1)),
          "9d: the datastore's labels are not corpus[:, 1:] in order")
    keys = index.points_sorted[order]
    del index, order
    ng, g, cap = moe.group_shape(cfg, n_seqs * seq_len)
    n_moe = sum(cfg.is_moe_layer(i % cfg.block_period) for i in range(cfg.n_layers))
    shapes = {tuple(t.shape[1:]) for t in got_route[0] + want_route[0]}
    check(shapes == {(g, cfg.moe.top_k)}, f"9d: the router ran on groups of {shapes}, not "
                                          f"of {g} tokens")
    got_route, want_route = [[torch.cat(ts) for ts in r] for r in (got_route, want_route)]
    check(got_route[0].shape[0] == want_route[0].shape[0] == n_moe * ng,
          f"9d: {got_route[0].shape[0]} and {want_route[0].shape[0]} groups routed, "
          f"not {n_moe * ng}")
    groups_differ = int(((got_route[0] != want_route[0]) | (got_route[1] != want_route[1]))
                        .flatten(1).any(1).sum())
    check(groups_differ == 0, f"9d: the router chose or kept other experts in {groups_differ} "
                              f"of {n_moe * ng} groups than the one forward")
    err = close(keys, want, MODEL_TOL, "9d: layer-major harvest against one forward")
    rows_equal = float((keys == want.float()).all(dim=1).float().mean())
    emit({
        "phase": "9d", "config": "qwen2-moe-a2.7b CONFIG (24 layers, 60 routed experts padded "
                                 "to 64, top-4, a shared MLP of 5632), bf16, random weights",
        "nvidia_smi": smi, "sequences": n_seqs, "seq_len": seq_len,
        "pairs": n_seqs * (seq_len - 1), "groups": ng, "group_tokens": g, "capacity": cap,
        "harvest_s": harvest_ms / 1e3, "phase_8b_harvest_s": HARVEST_S.get("8b"),
        "one_forward_s": forward_ms / 1e3,
        "vs_one_forward": {"router_groups_compared": n_moe * ng,
                           "router_groups_differing": groups_differ,
                           "max_abs_err": err, "rows_bit_equal": rows_equal,
                           "tolerance": MODEL_TOL},
        "peak_mem_gb": {"harvest": harvest_peak, "one_forward": forward_peak},
    })


# -------------------------------------------------------------------- main ---


# ---------------------------------------------------------------- phase 10 ----
#
# The device mesh: four ranks on the one card (gloo, CUDA tensors, each on
# cuda:0), spawned by this script, and a one-rank nccl mesh.  Each rank
# writes its result as JSON (or its traceback) under build/phase10/; the
# parent prints the phase's lines.

MESH_RANKS = 4
PHASE10 = ROOT / "build" / "phase10"
MESH_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
                    "broadcast")
RANKS_TIMEOUT_S = 900.0


def _rank_entry(fn_name: str, rank: int, world: int, backend: str, args: tuple) -> None:
    """One rank: the process group over a FileStore under PHASE10, the
    card, then fn_name(rank, world, *args)'s JSON result to a file."""
    import datetime
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(str(PHASE10 / f"store_{fn_name}"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        out = globals()[fn_name](rank, world, *args)
        (PHASE10 / f"{fn_name}_{rank}.json").write_text(json.dumps(out))
    except BaseException:
        (PHASE10 / f"{fn_name}_{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn_name: str, world: int, args: tuple, backend: str) -> list:
    """fn_name on `world` spawned ranks over `backend`; every rank's
    result, or an error with their tracebacks (every rank is stopped when
    one fails or the ranks outlast RANKS_TIMEOUT_S)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(fn_name, r, world, backend, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = "".join(f.read_text() for f in sorted(PHASE10.glob(f"{fn_name}_*.err")))
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"phase 10 {fn_name}: exit codes {codes}\n{errors or 'timed out'}")
    return [json.loads((PHASE10 / f"{fn_name}_{r}.json").read_text()) for r in range(world)]


def np_slice(arr: np.ndarray, mesh, spec) -> np.ndarray:
    """This rank's slice of a whole leaf under `spec`, by index
    arithmetic on the host (each mesh axis in order splits its dim's
    current range evenly)."""
    start, size = [0] * arr.ndim, list(arr.shape)
    for j, e in enumerate(spec):
        for axis in (() if e is None else (e,) if isinstance(e, str) else e):
            size[j] //= mesh.shape[axis]
            start[j] += mesh.coordinate(axis) * size[j]
    return arr[tuple(slice(a, a + n) for a, n in zip(start, size))]


def p10_collectives(rank: int, world: int) -> dict:
    """10a: which c10d collectives gloo runs on CUDA tensors (each on a
    group of its own, so a refusal leaves the others' groups whole)."""
    import torch.distributed as dist

    x = torch.full((8,), float(rank + 1), device=DEV)
    calls = {
        "all_gather": lambda g: dist.all_gather([torch.empty_like(x) for _ in range(world)], x,
                                                group=g),
        "all_gather_into_tensor": lambda g: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=DEV), x, group=g),
        "all_reduce": lambda g: dist.all_reduce(x.clone(), group=g),
        "all_reduce_max_int32": lambda g: dist.all_reduce(x.to(torch.int32), dist.ReduceOp.MAX,
                                                          group=g),
        "reduce_scatter_tensor": lambda g: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=DEV), x, group=g),
        "broadcast": lambda g: dist.broadcast(x.clone(), 0, group=g),
        "reduce": lambda g: dist.reduce(x.clone(), 0, group=g),
        "gather": lambda g: dist.gather(x, [torch.empty_like(x) for _ in range(world)]
                                        if rank == 0 else None, 0, group=g),
        "scatter": lambda g: dist.scatter(torch.empty_like(x), [x.clone() for _ in range(world)]
                                          if rank == 0 else None, 0, group=g),
        "all_to_all_single": lambda g: dist.all_to_all_single(torch.empty_like(x), x, group=g),
        "barrier": lambda g: dist.barrier(group=g),
    }
    took = {}
    for name, call in calls.items():
        group = dist.new_group(list(range(world)))
        try:
            call(group)
            torch.cuda.synchronize()
            took[name] = "ok"
        except RuntimeError as e:       # the probe's answer: gloo refused CUDA tensors here
            took[name] = f"refused: {str(e).splitlines()[0][:120]}"
    check(all(took[n] == "ok" for n in MESH_COLLECTIVES if n in took),
          f"10a: a collective the mesh path needs was refused: {took}")
    return took


def p10_sharded(rank: int, world: int, seed: int, mods: dict, want: dict) -> dict:
    """10b: phase 6a's datastore (PAPER_GRID, the same points, queries and
    mutations from the same generator; 6a's sizes) on a ("data",) mesh of
    the ranks."""
    from repro_torch import api
    from repro_torch.configs.paper_active_search import K, PAPER_GRID
    from repro_torch.core import distributed, grid, projection
    from repro_torch.launch.mesh import make_mesh

    cfg, k = PAPER_GRID, K
    n, b, batch = 1_000_000, 4096, 2048
    mesh = make_mesh({"data": world}, device=DEV.type)
    gen = torch.Generator(device=DEV).manual_seed(seed + 60)
    pts = torch.randn((n, 2), generator=gen, device=DEV)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=DEV, dtype=torch.int32)
    q = torch.randn((b, 2), generator=gen, device=DEV)
    proj = projection.identity_projection(pts)
    n0 = n - 2 * batch
    s, build_ms = host_ms(lambda: api.ActiveSearcher.build_sharded(
        pts[:n0], mesh=mesh, axis="data", labels=labels[:n0], cfg=cfg, proj=proj))
    owner = distributed.shard_of_points(pts[:n0], cfg, proj, world)
    sel = torch.nonzero(owner == rank).flatten()
    same_index(distributed.live_shard(s.index, None),
               grid.build_index(pts[sel], cfg, proj, labels=labels[sel], ids=sel.to(torch.int32)),
               f"10b rank {rank}: its shard")
    q = distributed.replicate_queries(q, mesh)
    s.search(q, k)
    torch.cuda.synchronize()
    reset(mods)
    res = s.search(q, k)
    torch.cuda.synchronize()
    launches = counts(mods)
    check(sum(launches.values()) == 0, f"10b: the mesh search launched {launches}")
    for f in res._fields:
        check(np.array_equal(to_np(getattr(res, f)), want[f"search/{f}"]),
              f"10b rank {rank}: {f} differs from phase 6a's one-card sharded search")
    search_ms = search_wall_ms(s, q, k, reps=3)
    for i in range(2):
        lo, hi = n0 + i * batch, n0 + (i + 1) * batch
        s = s.insert(pts[lo:hi], labels=labels[lo:hi])
    dead = mixed_ids(gen, n0, n, batch)
    s = s.delete(dead)
    mutated = s.search(q, k)
    for f in mutated._fields:
        check(np.array_equal(to_np(getattr(mutated, f)), want[f"mutated/{f}"]),
              f"10b rank {rank}: mutated {f} differs from phase 6a's (a sharded rebuild's)")
    st = s.stats()
    check(st["n_points"] == n - batch, f"10b: {st['n_points']} live points")
    return {"build_ms": build_ms, "search_ms": search_ms,
            "search_ms_after_mutation": search_wall_ms(s, q, k, reps=3),
            "shard_bytes": nbytes(index_tensors(s.index)),
            "shard_rows": int(s.index.points_sorted.shape[0]),
            "shard_points": st["shard_points"], "launches": launches}


def p10_psum(rank: int, world: int, seed: int) -> dict:
    """10e: compressed_psum over the ranks on (2048, 8192) gradients (one
    internlm2 MLP matrix) against the same formula on the host."""
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.utils.quantize import dequantize, quantize_symmetric, quantize_with_scale

    shape = (2048, 8192)

    def draw(r):
        gen = torch.Generator(device=DEV).manual_seed(seed + 110 + r)
        return (torch.randn(shape, generator=gen, device=DEV),
                0.01 * torch.randn(shape, generator=gen, device=DEV))

    g, err = draw(rank)
    (mean, new_err), ms = host_ms(lambda: compressed_psum(g, err))
    host = [tuple(t.cpu() for t in draw(r)) for r in range(world)]
    gfs = [a.to(torch.float32) + e for a, e in host]
    scale = torch.stack([quantize_symmetric(gf)[1] for gf in gfs]).max()
    codes = [quantize_with_scale(gf, scale) for gf in gfs]
    total = torch.stack([c.to(torch.int32) for c in codes]).sum(0)
    want_mean = total.to(torch.float32) * scale / torch.tensor(float(world))
    want_err = gfs[rank] - dequantize(codes[rank], scale)
    check(torch.equal(mean.cpu(), want_mean) and torch.equal(new_err.cpu(), want_err),
          f"10e rank {rank}: compressed_psum differs from the host formula")
    return {"ms": ms, "elements": g.numel(), "bit_equal": True}


def same_slices(state, path: str, specs: dict, mesh, what: str) -> float:
    """Every leaf of this rank's `state` equal to its slice of the
    checkpoint file `path`; returns the seconds the check took."""
    from repro_torch.checkpoint.store import stored_array
    from repro_torch.utils import tree

    t0 = time.perf_counter()
    for p, leaf in tree.leaves_with_path(state):
        key = "/".join(map(str, p))
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        check(np.array_equal(to_np(local), np_slice(stored_array(path, key), mesh, specs[p])),
              f"{what}: {key} is not its slice of the checkpoint")
    return time.perf_counter() - t0


def host_rss_gb() -> float:
    """This process's resident host memory now."""
    return int(Path("/proc/self/statm").read_text().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def host_peak_during(fn) -> tuple:
    """(fn(), resident host GB just before, the most sampled while fn ran):
    a thread reads the resident size every 20 ms."""
    import threading

    before = host_rss_gb()
    peak, done = [before], threading.Event()

    def watch():
        while not done.wait(0.02):
            peak[0] = max(peak[0], host_rss_gb())

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        out = fn()
    finally:
        done.set()
        watcher.join()
    return out, before, max(peak[0], host_rss_gb())


def p10_model(rank: int, world: int, seed: int, mods: dict, ckpt: str, step: int,
              want_losses: list) -> dict:
    """10c and 10d on a 2 x 2 mesh of the ranks: 9b's checkpoint restored
    onto it and checked slice by slice; the serve and retrieval serve steps
    with its weights against one rank's; then 9b's next two steps, and the
    mesh's state saved (9b's checkpoint removed first: two do not fit the
    disk) and checked slice by slice against what was written."""
    import torch.distributed as dist

    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import retrieval_memory as rm
    from repro_torch.data.pipeline import DataConfig, Prefetcher
    from repro_torch.launch import steps as st
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.utils import tree

    cfg, t_len = get_config("internlm2-1.8b"), 4096
    mesh = make_host_mesh(2, 2, device=DEV.type)
    tc = train.TrainConfig(steps=20, batch=8, seq=1024, seed=seed)          # 9b's
    opt_cfg = adamw.AdamWConfig(lr=tc.lr, total_steps=tc.steps,
                                warmup_steps=max(tc.steps // 20, 1))
    step_cfg = st.StepConfig(accum=tc.accum, compress_grads=tc.compress_grads)
    like = st.train_state_shapes(cfg, opt_cfg, step_cfg)
    mgr = CheckpointManager(ckpt)
    torch.cuda.reset_peak_memory_stats()
    state, restore_ms = host_ms(lambda: mgr.restore(
        step, like, placements=st.train_state_shardings(like, cfg, mesh)))
    specs = dict(tree.leaves_with_path(st.train_state_specs(like, cfg, mesh)))
    check_s = same_slices(state, mgr.arrays_path(step), specs, mesh, f"10c rank {rank}")
    restore_peak = torch.cuda.max_memory_allocated() / 1e9

    # 10d: serving with the restored weights, in float32 (the mesh held
    # against one rank) and in bf16 (each held against float32)
    out = {"restore_ms": restore_ms, "slice_check_s": check_s, "restore_peak_gb": restore_peak}
    mem = rm.RetrievalMemoryConfig()
    b, steps = 8, 8
    gen = torch.Generator(device=DEV).manual_seed(seed + 100)
    caches = M.init_caches(cfg, b, t_len, device=DEV)
    for c in caches:
        for s_ in c.values():
            s_.normal_(generator=gen)
    index = rm.build_memory_index(rm.key_summary(caches[0]["k"][0, 0]), mem,
                                  rm.make_projection(gen, cfg.head_dim))
    tokens = torch.randint(0, cfg.vocab_size, (steps, b), generator=gen, device=DEV)
    pos0 = t_len - steps
    whole = caches if rank == 0 else None            # the one-rank steps' caches
    caches = sh.distribute_tree(caches, sh.cache_specs(caches, cfg, mesh, b), mesh)
    clone = lambda cs: [{k: v.clone() for k, v in c.items()} for c in cs]  # noqa: E731

    def decode(fn, m, cs, with_index: bool):
        cs, logits, ms = clone(cs), [], []
        extra = (index,) if with_index else ()
        for i in range(steps):
            (lg, cs, _), t = host_ms(lambda: fn(m, cs, *extra, tokens[i], pos0 + i))
            logits.append(sh.gather(lg).float().cpu())
            ms.append(t)
        return logits, ms

    def as_float(cs):
        return [{k: v.float() for k, v in c.items()} for c in cs]

    one = {}
    with f32_activations():
        if rank == 0:      # the one-rank steps: the same float32 weights on one device
            m1 = M.model_from_params(cfg, mgr.restore(step, {"params": like["params"]},
                                                      device=DEV)["params"])
            w32 = as_float(whole)
            one["serve"], _ = decode(st.make_serve_step(cfg), m1, w32, False)
            one["retrieval"], _ = decode(st.make_retrieval_serve_step(cfg, mem), m1, w32, True)
            one["positions"] = [st.retrieve(m1, index, tokens[i], pos0 + i, mem)[0].cpu()
                                for i in range(steps)]
            del m1, w32
            torch.cuda.empty_cache()
        model = M.model_from_params(cfg, state["params"])
        c32 = as_float(caches)
        serve_logits, serve_ms = decode(st.make_serve_step(cfg, mesh=mesh), model, c32, False)
        torch.cuda.synchronize()
        reset(mods)
        retrieval_logits, retrieval_ms = decode(st.make_retrieval_serve_step(cfg, mem, mesh=mesh),
                                                model, c32, True)
        launches = counts(mods)
        check(launches["radius_search_loop"] >= 1 and launches["csr_candidate_topk"] >= 1,
              f"10d rank {rank}: the retrieval serve step launched {launches}")
        positions = []
        for i in range(steps):
            with st.on_mesh(mesh, cfg, b):
                got = st.retrieve(model, index, tokens[i], pos0 + i, mem)[0]
            positions.append(sh.gather(got).cpu())
        del model, c32
    # bf16, the serving dtype: the mesh's and one rank's logits against float32
    model = M.model_from_params(cfg, state["params"])
    bf16_logits, bf16_ms = decode(st.make_serve_step(cfg, mesh=mesh), model, caches, False)
    del model, caches
    torch.cuda.empty_cache()
    if rank == 0:
        errs = {name: max(close(g, w, MESH_F32_TOL, f"10d {name} step {i}")
                          for i, (g, w) in enumerate(zip(got, one[name])))
                for name, got in (("serve", serve_logits), ("retrieval", retrieval_logits))}
        for i, (g, w) in enumerate(zip(positions, one["positions"])):
            check(torch.equal(g, w), f"10d step {i}: the mesh retrieved other positions")
        m1 = M.model_from_params(cfg, mgr.restore(step, {"params": like["params"]},
                                                  device=DEV)["params"])
        one_bf16, _ = decode(st.make_serve_step(cfg), m1, whole, False)
        del m1, whole
        torch.cuda.empty_cache()
        gap = lambda got: max(float((g - w).abs().max())          # noqa: E731
                              for g, w in zip(got, one["serve"]))
        bf16 = {"mesh_vs_float32": gap(bf16_logits), "one_rank_vs_float32": gap(one_bf16),
                "mesh_vs_one_rank": max(float((g - w).abs().max())
                                        for g, w in zip(bf16_logits, one_bf16)),
                "max_abs_logit": max(float(w.abs().max()) for w in one["serve"])}
        check(bf16["mesh_vs_float32"] <= BF16_MESH_SLACK * bf16["one_rank_vs_float32"],
              f"10d: the bf16 mesh is further from float32 than one rank: {bf16}")
        out["float32_logits_max_abs_err"] = errs
        out["bf16"] = bf16
    out.update({"serve_ms": serve_ms, "retrieval_ms": retrieval_ms, "bf16_serve_ms": bf16_ms,
                "launches": launches, "serve_peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()

    # 10c: 9b's next two steps on the mesh; a sample of every parameter
    # shard first, to see each one move
    sample = [leaf.to_local().flatten()[:1024].clone() for leaf in tree.leaves(state["params"])]
    train_step = st.make_train_step(cfg, opt_cfg, step_cfg, mesh=mesh)
    pf = Prefetcher(DataConfig(global_batch=tc.batch, seq_len=tc.seq, vocab_size=cfg.vocab_size,
                               seed=tc.seed), model_cfg=cfg, start_step=step)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    try:
        for _ in range(len(want_losses)):
            _, hb = next(pf)
            batch = {k: torch.from_numpy(v).to(DEV) for k, v in hb.items()}
            (state, metrics), ms = host_ms(lambda: train_step(state, batch))
            losses.append(float(metrics["loss"]))
            step_ms.append(ms)
    finally:
        pf.close()
    gaps = [abs(a - w) / abs(w) for a, w in zip(losses, want_losses)]
    check(max(gaps) <= MESH_LOSS_RTOL, f"10c: losses {losses} against 9b's {want_losses}")
    moved = [not torch.equal(leaf.to_local().flatten()[:1024], old)
             for leaf, old in zip(tree.leaves(state["params"]), sample)]
    check(all(moved), f"10c rank {rank}: {moved.count(False)} parameter shards did not move")
    out.update({"losses": losses, "loss_rel_gap": gaps, "step_ms": step_ms,
                "train_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "params_moved": f"{len(moved)} of {len(moved)} shards"})
    del sample

    # the mesh's state saved: each leaf gathered, rank 0 writes it
    dist.barrier()                     # every rank is done with 9b's checkpoint
    if rank == 0:
        shutil.rmtree(ckpt)
    saver = CheckpointManager(str(TRAIN_DIR / "mesh"))
    (_, save_ms), rss, rss_peak = host_peak_during(
        lambda: host_ms(lambda: saver.save(step + len(losses), state, blocking=True)))
    out["mesh_save"] = {
        "save_ms": save_ms, "host_rss_gb_before": rss, "host_rss_peak_gb": rss_peak,
        "host_rss_added_gb": rss_peak - rss,
        "bytes": os.path.getsize(saver.arrays_path(step + len(losses))),
        "slice_check_s": same_slices(state, saver.arrays_path(step + len(losses)), specs, mesh,
                                     f"10c rank {rank}: the mesh's save")}
    return out


# a loss's relative gap to 9b's on one device.  Sound runs read 7.0e-6 and
# 9.7e-6 (H100 80GB HBM3, 700.00 W); a step moves the loss ~1e-3 relative
MESH_LOSS_RTOL = 1e-4
# 10d's float32 logits on the mesh against one rank's.  Sound runs read
# 2.3e-5 and 2.7e-5 (max |logit| 5.25; H100 80GB HBM3, 700.00 W)
MESH_F32_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 logits on the mesh may be this much further from float32's than one
# rank's bf16 logits are.  At internlm2-1.8b's width with random weights
# and 8 x 4,096 random cached positions the two sat 0.23-0.27 and
# 0.21-0.24 from float32 and 0.25-0.27 from each other (H100 80GB HBM3,
# 700.00 W): bf16's own spread, beyond MODEL_TOL, so MODEL_TOL is held in
# float32
BF16_MESH_SLACK = 1.5


def phase10_rank(rank: int, world: int, seed: int, ckpt: str, step: int,
                 want_losses: list) -> dict:
    """10a, 10b, 10c-10d and 10e on this rank, in order."""
    mods = {name: importlib.import_module(f"repro_torch.kernels.{src}")
            for name, (src, _) in KERNELS.items()}
    with np.load(PHASE10 / "sharded_6a.npz") as z:
        want = {k: z[k] for k in z.files}
    out = {"10a": p10_collectives(rank, world)}
    out["10b"], t = host_ms(lambda: p10_sharded(rank, world, seed, mods, want))
    out["10b"]["phase_s"] = t / 1e3
    out["10cd"], t = host_ms(lambda: p10_model(rank, world, seed, mods, ckpt, step, want_losses))
    out["10cd"]["phase_s"] = t / 1e3
    out["10e"] = p10_psum(rank, world, seed)
    return out


def phase10_nccl(rank: int, world: int, seed: int) -> dict:
    """10f: a 1 x 1 mesh over nccl, three float32 steps of 9a's
    configuration against the same steps with no mesh, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.utils import tree

    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    step_cfg = st.StepConfig(accum=2, bf16_compute_copy=False)
    dc = DataConfig(global_batch=2, seq_len=64, vocab_size=cfg.vocab_size, seed=seed)
    mesh = make_host_mesh(1, 1, device=DEV.type)
    with f32_activations():
        plain = st.init_train_state(torch.Generator(device=DEV).manual_seed(seed + 90), cfg,
                                    opt_cfg, step_cfg, DEV)
        meshed = st.init_train_state(torch.Generator(device=DEV).manual_seed(seed + 90), cfg,
                                     opt_cfg, step_cfg, mesh=mesh)
        one, on_mesh = st.make_train_step(cfg, opt_cfg, step_cfg), st.make_train_step(
            cfg, opt_cfg, step_cfg, mesh=mesh)
        losses, ms = [], []
        for i in range(3):
            hb = {k: torch.from_numpy(v).to(DEV) for k, v in synth_batch(dc, i).items()}
            plain, mp_ = one(plain, hb)
            (meshed, mm), t = host_ms(lambda: on_mesh(meshed, hb))
            ms.append(t)
            losses.append(float(mm["loss"]))
            check(all(torch.equal(sh.gather(a), b) for a, b in
                      zip(tree.leaves(meshed), tree.leaves(plain))) and torch.equal(
                mm["loss"], mp_["loss"]), f"10f step {i}: the 1 x 1 mesh differs from no mesh")
    return {"losses": losses, "step_ms": ms, "bit_equal": True,
            "nccl": ".".join(map(str, torch.cuda.nccl.version()))}


def phase10(seed: int, smi: str, ckpt: str, step: int, want_losses: list) -> list:
    """Phase 10 on the card: four spawned gloo ranks (10a-10e), then one
    nccl rank (10f); prints one line per part and returns 10d's counted
    launches of every rank.  10c removes 9b's checkpoint `ckpt`."""
    t0 = time.perf_counter()
    ranks = run_ranks("phase10_rank", MESH_RANKS, (seed, ckpt, step, want_losses), "gloo")
    r0 = ranks[0]
    mesh4 = f"{MESH_RANKS} ranks on one card (gloo, CUDA tensors)"
    emit({"phase": "10a", "mesh": mesh4, "nvidia_smi": smi, "collectives_on_cuda": r0["10a"],
          "path_needs": list(MESH_COLLECTIVES)})
    emit({"phase": "10b", "config": "phase 6a's datastore (PAPER_GRID, 1M points, 4,096 queries, "
                                    "k = 11) on a 4-rank ('data',) mesh", "nvidia_smi": smi,
          "mesh": mesh4, "equal_to_6a": ["search: every field", "after 2 inserts and a delete "
                                         "of 2,048: every field (6a: = a sharded rebuild)"],
          "per_rank": [r["10b"] for r in ranks]})
    cd = [r["10cd"] for r in ranks]
    emit({"phase": "10c", "config": "internlm2-1.8b CONFIG on a 2 x 2 (data, model) mesh, "
                                    "9b's settings (bf16 compute copy, remat full, accum 4, "
                                    "8 x 1,024 tokens a step)", "nvidia_smi": smi, "mesh": mesh4,
          "restored": f"9b's step-{step} checkpoint (written by one device); every rank's "
                      "shards equal to the same slices of it",
          "losses": r0["10cd"]["losses"], "want_9b": want_losses,
          "loss_rel_gap": r0["10cd"]["loss_rel_gap"], "rtol": MESH_LOSS_RTOL,
          "step_ms": r0["10cd"]["step_ms"], "params_moved": r0["10cd"]["params_moved"],
          "mesh_save": "the state after the steps saved on the mesh (rank 0 writes each "
                       "gathered leaf); every rank's shards equal to their slices of the file",
          "per_rank": [{k: c[k] for k in ("restore_ms", "slice_check_s", "restore_peak_gb",
                                          "train_peak_gb", "step_ms", "params_moved",
                                          "mesh_save")} for c in cd]})
    emit({"phase": "10d", "config": "make_serve_step and make_retrieval_serve_step on the 2 x 2 "
                                    "mesh with the restored weights: 8 x 4,096 cached positions "
                                    "(random, from the seed), 8 decode steps; float32 against "
                                    "one rank, then bf16 (serve) against float32",
          "nvidia_smi": smi, "mesh": mesh4, "tolerance": MESH_F32_TOL,
          "float32_logits_max_abs_err_vs_one_rank": r0["10cd"]["float32_logits_max_abs_err"],
          "retrieved_positions_equal": True, "bf16": r0["10cd"]["bf16"],
          "bf16_slack": BF16_MESH_SLACK,
          "per_rank": [{k: c[k] for k in ("serve_ms", "retrieval_ms", "bf16_serve_ms", "launches",
                                          "serve_peak_gb")} for c in cd]})
    emit({"phase": "10e", "nvidia_smi": smi, "mesh": mesh4,
          "compressed_psum": [r["10e"] for r in ranks]})
    nccl = run_ranks("phase10_nccl", 1, (seed,), "nccl")[0]
    emit({"phase": "10f", "config": "a 1 x 1 mesh over nccl: 9a's configuration (internlm2-1.8b "
                                    "widths at depth 2, float32, accum 2), three steps",
          "nvidia_smi": smi, **nccl})
    emit({"phase": 10, "nvidia_smi": smi, "seconds": time.perf_counter() - t0})
    return [c["launches"] for c in cd]


# ---------------------------------------------------------------- phase 11 --
# 11a: (arch, shape, multi_pod) cells of the dry run on the fake production
# meshes; the minitron-8b long_500k cell traces the retrieval search
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False), ("internlm2-1.8b", "prefill_32k", False),
                ("internlm2-1.8b", "decode_32k", False), ("minitron-8b", "long_500k", False),
                ("internlm2-1.8b", "decode_32k", True))
PEAK_RTOL = 0.10        # 11b: the traced peak against max_memory_allocated
P11_KERNELS = ("radius_search_loop", "csr_candidate_topk")


def p11_cell(arch: str, shape: str, multi_pod: bool) -> dict:
    """One 11a cell, in a child process of its own (a fake process group is
    process-global): the dry run's run_cell on fake CUDA tensors over a
    fake group of the production mesh's size; nothing is allocated on the
    card.  Returns the record."""
    import logging

    sys.path.insert(0, str(ROOT / "src"))
    logging.disable(logging.WARNING)     # DTensor's notes on mesh-dim redistributions
    from repro_torch.launch import dryrun

    return dryrun.run_cell(arch, shape, multi_pod, verbose=False)


def p11_profile(fn, names) -> dict:
    """{kernel: [device ms of each launch]} of `names` in one traced call
    of `fn`."""
    from torch.profiler import ProfilerActivity, profile

    pats = {n: re.compile(rf"\b{n}_kernel\b") for n in names}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    recs = kernel_records(prof)
    return {n: [ms for kname, ms in recs if pat.search(kname)] for n, pat in pats.items()}


def p11_dispatch(mods: dict, args: dict, reps: int = 200) -> dict:
    """Host microseconds of one launch of each kernel through its operator
    (`torch.ops.repro_torch.<name>`, the dispatcher: what the wrapper
    calls) against a direct call of the function registered as its CUDA
    kernel (the same allocations and ctypes launch), on the arguments
    `args[name]` the step passed: `reps` calls timed on the host's clock
    with no sync inside, in the order op, direct, direct, op.  These
    launches are comparisons, not the path's."""
    def host_us(fn, call_args) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*call_args)
        us = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
        return us

    out = {}
    for n in P11_KERNELS:
        op, direct = mods[n]._OP, mods[n]._launch
        op_a, direct_a, direct_b, op_b = (host_us(f, args[n]) for f in (op, direct, direct, op))
        out[n] = {"op_us": [op_a, op_b], "direct_us": [direct_a, direct_b],
                  "dispatch_us": (op_a + op_b - direct_a - direct_b) / 2, "reps": reps}
    return out


def p11_step(seed: int) -> dict:
    """11b: internlm2-1.8b's CONFIG at 9b's one-card cut (8 x 1,024 tokens,
    its accum 4, remat full, the bf16 compute copy) traced on fake CUDA
    tensors by lower_cell, then run for real: the traced FLOPs equal
    FlopCounterMode's over a real step, and the traced peak is within
    PEAK_RTOL of max_memory_allocated over a real step (counted from a
    reset with the state and the batch on the card).  The measured step
    time is printed beside the roofline's, a reading only."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import steps as st
    from repro_torch.optim import adamw

    cfg = get_config("internlm2-1.8b")
    shape = ShapeSpec("9b", 1024, 8, "train")
    lowered, _ = st.lower_cell(cfg, shape, None, device=DEV.type)
    c = lowered.counts
    roof = rl.from_trace(c, 1)
    gen = torch.Generator(device=DEV).manual_seed(seed + 110)
    state = st.init_train_state(gen, cfg, adamw.AdamWConfig(), st.StepConfig(), device=DEV)
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len), generator=gen,
                           device=DEV, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    step = st.make_train_step(cfg, adamw.AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (state, _), first_ms = host_ms(lambda: step(state, batch))
    peak = torch.cuda.max_memory_allocated()
    step_ms = []
    for _ in range(2):
        (state, _), ms = host_ms(lambda: step(state, batch))
        step_ms.append(ms)
    with FlopCounterMode(display=False) as fc:
        state, _ = step(state, batch)
    real_flops = fc.get_total_flops()
    del state
    check(c.flops == real_flops, f"11b: traced FLOPs {c.flops} != a real step's {real_flops}")
    rel = abs(c.peak_bytes - peak) / peak
    check(rel <= PEAK_RTOL, f"11b: traced peak {c.peak_bytes} vs max_memory_allocated {peak}")
    return {"config": "internlm2-1.8b CONFIG, 8 x 1,024 tokens, accum 4, remat full, bf16 "
                      "compute copy (9b's one-card cut)",
            "traced_flops": c.flops, "real_flops": real_flops,
            "traced_peak_bytes": c.peak_bytes, "max_memory_allocated": peak,
            "allocated_at_reset": base, "peak_rel_err": rel, "peak_rtol": PEAK_RTOL,
            "traced_argument_bytes": c.argument_bytes, "trace_s": lowered.seconds,
            "traces": len(lowered.traces), "roofline": roof.as_dict(),
            "roofline_step_ms": 1e3 * roof.step_time_s,
            "step_ms": {"first": first_ms, "next": step_ms}}


def p11_retrieval(seed: int, mods: dict) -> tuple:
    """11c: the retrieval serve step at 9c's shape (minitron-8b CONFIG, a
    cache of 262,144 positions, batch 1), traced on fake CUDA tensors (one
    call of each search kernel's op) and run for real after a warm-up step
    under torch.profiler (exactly one launch of each); each kernel's
    credited FLOPs and bytes beside its device ms, and the host cost of its
    operator's dispatch (`p11_dispatch`, on the warm-up step's arguments).
    Returns (line, the counted launches of the profiled step)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core import retrieval_memory as rm
    from repro_torch.launch import steps as st
    from repro_torch.models.model import DecoderLM, init_caches

    cfg = get_config("minitron-8b")
    positions = 262_144
    mem = rm.RetrievalMemoryConfig()
    lowered, _ = st.lower_cell(cfg, ShapeSpec("9c", positions, 1, "decode"), None,
                               retrieval=(mem.n_retrieved, mem.local_window), device=DEV.type)
    c = lowered.counts
    traced = {n: f"repro_torch.{n}" for n in P11_KERNELS}
    for n, op in traced.items():
        check(c.calls.get(op) == 1, f"11c: the trace counts {c.calls.get(op)} calls of {op}")
    gen = torch.Generator(device=DEV).manual_seed(seed + 111)
    model = DecoderLM(cfg, device=DEV, generator=gen)
    caches = init_caches(cfg, 1, positions, device=DEV)
    for cache in caches:
        for state in cache.values():
            state.normal_(generator=gen)
    index = rm.build_memory_index(rm.key_summary(caches[0]["k"][0, 0]), mem,
                                  rm.make_projection(gen, cfg.head_dim))
    tokens = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen, device=DEV)
    step = st.make_retrieval_serve_step(cfg, mem)
    args = {}
    ops = {n: mods[n]._OP for n in P11_KERNELS}

    def capture(n, op):                 # the warm-up step's kernel arguments, for p11_dispatch
        def call(*a):
            args[n] = a
            return op(*a)
        return call

    for n, op in ops.items():
        mods[n]._OP = capture(n, op)
    try:
        step(model, caches, index, tokens[0], positions - 2)         # warm-up, not counted
    finally:
        for n, op in ops.items():
            mods[n]._OP = op
    torch.cuda.synchronize()
    reset(mods)
    launched = p11_profile(lambda: step(model, caches, index, tokens[1], positions - 1), P11_KERNELS)
    launches = counts(mods)
    for n in P11_KERNELS:
        check(len(launched[n]) == 1 and launches[n] == 1,
              f"11c: the real step launched {n} {launches[n]} times, profiled {len(launched[n])}")
    dispatch = p11_dispatch(mods, args)
    return {"config": "make_retrieval_serve_step, minitron-8b CONFIG, bf16, random weights; "
                      "RetrievalMemoryConfig's defaults",
            "reduced": f"cache of {positions} positions (long_500k: 524,288), batch 1",
            "trace_s": lowered.seconds,
            "kernels": {n: {"traced_calls": c.calls[op], "profiled_launches": len(launched[n]),
                            "flops_credited": c.flops_by_op[op],
                            "bytes_credited": c.bytes_by_op[op],
                            "device_ms": launched[n][0], "host_us": dispatch[n]}
                        for n, op in traced.items()}}, launches


def p11_real(seed: int) -> tuple:
    """11b and 11c in a child process (the card to itself): the kernels are
    built already; returns (11b's line, 11c's line, 11c's launches)."""
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {name: importlib.import_module(f"repro_torch.kernels.{src}")
            for name, (src, _) in KERNELS.items()}
    line_b = p11_step(seed)
    torch.cuda.empty_cache()
    line_c, launches = p11_retrieval(seed, mods)
    return line_b, line_c, launches


def phase11(seed: int, smi: str) -> list:
    """Phase 11, the dry run, after every other phase: 11a's cells at once,
    a child process each (the card idle: nothing else runs), then 11b and
    11c in a child of their own.  Prints one line per part; returns 11c's
    counted launches."""
    import concurrent.futures
    import multiprocessing as mp

    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(len(DRYRUN_CELLS), mp_context=mp.get_context("spawn"),
                                                max_tasks_per_child=1) as pool:
        recs = list(pool.map(p11_cell, *zip(*DRYRUN_CELLS)))
    cells_s = time.perf_counter() - t0
    for rec in recs:
        check(rec.get("status") == "OK", f"11a: {rec['arch']} {rec['shape']} {rec['mesh']}: "
                                         f"{rec.get('status')}")
        use = rec["roofline"]
        emit({"phase": "11a", "cell": f"{rec['arch']} {rec['shape']} {rec['mesh']}",
              "kind": rec["kind"], "nvidia_smi": smi, "fake": "CUDA fake tensors, a fake "
              "process group of the mesh's size, rank 0 traced; H100 data-sheet roofline",
              "C_ms": 1e3 * use["compute_s"], "M_ms": 1e3 * use["memory_s"],
              "X_ms": 1e3 * use["collective_s"], "bottleneck": use["bottleneck"],
              "model_flops_ratio": rec["model_flops_ratio"],
              "temp_bytes_per_rank": rec["memory"]["temp_size_in_bytes"],
              "argument_bytes_per_rank": rec["memory"]["argument_size_in_bytes"],
              "trace_s": rec["lower_s"], "probe_s": rec.get("probe_s"),
              "kernel_calls": rec["calls"], "roofline_raw_step_s": rec["roofline_raw"]["step_time_s"]})
        if rec["retrieval"]:
            check(all(rec["calls"].get(f"repro_torch.{n}") == 1 for n in P11_KERNELS),
                  f"11a: the retrieval cell traced {rec['calls']}")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        line_b, line_c, launches = pool.submit(p11_real, seed).result()
    emit({"phase": "11b", "nvidia_smi": smi, **line_b})
    emit({"phase": "11c", "nvidia_smi": smi, **line_c})
    emit({"phase": 11, "nvidia_smi": smi, "cells_seconds": cells_s,
          "seconds": time.perf_counter() - t0})
    return [launches]


def kernels_line(max_err: dict, timings: dict, launches: dict) -> dict:
    """One entry per kernel: launches on the paths (phase 4's for a kernel
    on no path), largest error against the plain version over every check,
    and the timed call's numbers; brute_knn adds its phase-2 (d=2) shape,
    candidate_topk its gather shape, flash_attention its S = 4096 widths."""
    extra = {"candidate_topk": ("gather_shape",), "brute_knn": ("d2_shape",),
             "flash_attention": ("wide_head", "other_widths"),
             "radius_search_loop": ("chunk_shape",), "csr_candidate_topk": ("knn_lm_shape",)}
    timings = {**timings, "brute_knn": {**timings["brute_knn"],
                                        "d2_shape": timings["brute_knn_d2"]}}
    return {"kernels": [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}.cu",
         "replaces": replaces, "launches": launches[name],
         "path": "none: phase 4 only" if name in NO_PATH else PATHS.get(name, "phases 2, 3, 5"),
         "max_abs_err": max(max_err[name], timings[name]["max_abs_err"]),
         "ms": timings[name]["ms"],
         "plain_ms": timings[name]["plain_ms"], "bound_ms": timings[name]["bound_ms"],
         "bound_by": timings[name]["bound_by"], "library_ms": timings[name].get("library_ms"),
         "shape": timings[name]["shape"],
         **{key: timings[name][key] for key in ("device_ms", "two_call_ms", "library",
                                                 "output_sha256") if key in timings[name]},
         **{key: timings[name][key] for key in extra.get(name, ())}}
        for name, (src, replaces) in KERNELS.items()
    ]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    # read at the card's first allocation: 9d's one forward holds tensors of
    # many sizes at once, and the default cached blocks fragment past 80 GB
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (src/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    shutil.rmtree(PHASE10, ignore_errors=True)
    from repro_torch import api
    from repro_torch.configs.paper_active_search import K, PAPER_GRID, PROD_GRID
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {name: importlib.import_module(f"repro_torch.kernels.{src}")
            for name, (src, _) in KERNELS.items()}
    smi = nvidia_smi()

    t0 = time.perf_counter()
    _build.build(SOURCES)
    build_s = time.perf_counter() - t0
    for name in SOURCES:
        _build.load(name)
    emit({
        "phase": 0, "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_wall_s": build_s,
        "kernels": {
            name: {"library": _build.library_path(name).name, "arch": "sm_90a",
                   "cached": name not in _build.BUILD_LOG,
                   "build_s": _build.BUILD_LOG.get(name, {}).get("seconds"),
                   **ptxas_summary(_build.BUILD_LOG.get(name, {}).get("ptxas", ""))}
            for name in SOURCES
        },
    })

    max_err = phase1(seed, {"PAPER_GRID": PAPER_GRID, "PROD_GRID": PROD_GRID}, mods)
    timings: dict = {}
    # launches on the paths: the sum of every counted run of phases 2 and 3
    runs = phase2(seed, api, PAPER_GRID, K, mods, timings)
    runs += phase3(seed, api, PROD_GRID, 10, mods, timings)
    runs.append(phase4(seed, mods, timings))
    runs += phases_5_to_11(seed, api, mods, smi, timings)
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    emit(kernels_line(max_err, timings, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def phases_5_to_11(seed, api, mods, smi, timings) -> list:
    """Phases 5-11 in order; returns their counted runs."""
    from repro_torch.configs.paper_active_search import K, PAPER_GRID, PROD_GRID

    runs = []
    runs += phase5_paper(seed, api, PAPER_GRID, K, mods, smi)
    runs += phase5_sift(seed, api, PROD_GRID, 10, mods, smi)
    runs += phase6_sharded(seed, api, PAPER_GRID, K, mods, smi)
    knn_runs, timings["csr_candidate_topk"]["knn_lm_shape"] = phase6_knn_lm(
        seed, api, mods, smi, n=KNN_LM_PAIRS)
    runs += knn_runs
    retrieval_runs, state, rcfg = phase6_retrieval(seed, api, mods, smi)
    runs += retrieval_runs
    phase6_checkpoint(seed, state, rcfg, smi)
    del state
    torch.cuda.empty_cache()
    phase7_equations(seed, smi)
    runs += phase7_serving(seed, api, mods, smi)
    torch.cuda.empty_cache()
    phase8_equations(seed, smi)
    runs += phase8_serving(seed, api, mods, smi)
    torch.cuda.empty_cache()
    phase9_train_equations(seed, smi)
    ckpt, ckpt_step, losses = phase9_training(seed, smi)
    try:
        runs += phase9_retrieval_step(seed, api, mods, smi)
        phase9_moe_harvest(seed, smi)
        torch.cuda.empty_cache()
        runs += phase10(seed, smi, ckpt, ckpt_step, losses[ckpt_step:ckpt_step + 2])
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    runs += phase11(seed, smi)
    return runs


if __name__ == "__main__":
    sys.exit(main())
