// Fused CSR gather -> distance -> top-k on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_candidate_topk.py::
// csr_candidate_topk.  For each query b it walks the w window rows; row i
// covers the row_cap store rows from the span start clamped to
// [0, n_pad - row_cap].  A slot is valid when its store row j lies in
// [starts[b,i], ends[b,i]) and below the live count n.  Valid slots get the
// l1 or l2 distance to the query, summed per d_chunk block and then across
// blocks; paper mode ranks floor(x)+0.5 cell centers and keeps only slots
// within radii[b].  The k smallest (distance, slot) pairs, smaller slot first
// on ties, come out as distances and GLOBAL CSR rows, with +inf / -1 where
// fewer than k slots are valid (k may exceed w*row_cap).  Equal to the plain
// version repro_torch/kernels/ref.py::csr_candidate_topk (bit-equal at d <= 2,
// where no summation order differs).
//
// What bounds it on this card: bytes.  A query reads d floats for each
// valid slot from the CSR store, which stays in device memory, and does
// three float operations per value read.  Counted over distinct rows the
// bound assumes queries share rows in L2; counted per (query, row) pair
// ("gathered" bytes) it is the floor when they share nothing.
//
// Design: one block of 256 threads per query.  It walks only the valid
// slots of the query's window.  Those of window row i are one run of
// contiguous store rows, [max(cs_i, start_i), min(cs_i + row_cap, end_i, n))
// with cs_i the clamped start; the block scans the runs' lengths into their
// exclusive prefix P in shared memory (a block scan: a warp scan of each
// thread's rows, then the warps' totals), and the walks run over the
// V = P[w] positions of the valid slots, not over w*row_cap slots.  Position
// p lies in the run i with P[i] <= p < P[i+1] (a binary search of P), and
// reads store row p - P[i] + the run's first row.  Positions keep the slots'
// order, so the top-k ranks the same (distance, slot) pairs in the same
// order and its output is bit for bit that of a walk over every slot; where
// every slot is valid, p is the slot itself.  The prefix holds at most
// PREFIX_ROWS window rows: a wider window is walked PREFIX_ROWS rows at a
// time, and between two such groups the list's positions become their
// slots less w*row_cap (negative, so every earlier group's slot ranks before
// the next group's positions on ties, as its slots do).  A map of sparse
// land leaves 86% of its slots empty and random-s-100 70%: they cost neither
// a load nor a wave of the walk.
//
// The walks (kernel_common.cuh) go over the positions from the middle out
// (nearest first). The run of one window row is contiguous in the store, so a
// tile's rows are a few contiguous blocks of it, as the TPU kernel's DMA of
// each window row into VMEM reads them. Rows of d >= 32 floats take
// staged_rank: tiles of 256 positions, one per thread, staged 32 feature dims
// (one 128-byte line of each row) at a time by cp.async through a 2-stage
// ring, each warp copying its own 32 rows with neighbouring lanes on
// neighbouring bytes, each thread summing its own row from shared memory
// through ChunkedSum, and a tile's distances offered to the filter-then-merge
// top-k after its last stage. Shared memory: the ring (2 x 256 x 36 floats),
// the rows of the tiles in flight (2 x 256), the query (4*d bytes), the
// top-k's buffer and list (5,136 bytes) and the prefix (PREFIX_ROWS + 1
// ints), each run's row offset (PREFIX_ROWS ints) and the scan's warp totals
// (8 ints), 4,144 bytes aligned: 85,056 + 4*d bytes whatever w*row_cap, so
// two blocks share an SM. Measured on the card at phase 3's chunk, 32 dims
// and 2 stages beat 16 dims and 2-4 stages (a row's 64-byte halves fetched a
// stage apart) and 64 dims. Rows of d < 32 floats take direct_rank instead:
// each thread reads its own rows from device memory (a warp's 32 rows are a
// few contiguous runs of the store, read in a few lines). candidate_topk.cu
// walks its dense window with the same two walks; only the slot locator
// differs.
//
// Numerics: every row gets the float that chunked_distance gives it, so
// this kernel and candidate_topk.cu agree bit for bit on the same row
// (built with -fmad=false; no FMA, no fast math).

#include <stdint.h>

#include "kernel_common.cuh"

// Window rows whose runs the prefix holds at a time (the wrapper's
// PREFIX_ROWS counts its shared memory).
#define PREFIX_ROWS 512

// The valid slots of a group of window rows, as the position locators read
// them: the exclusive prefix of the rows' run lengths and each run's first
// store row less its first position (4,144 bytes with the alignment).
struct __align__(16) WindowRuns {
  int pre[PREFIX_ROWS + 1];  // pre[i]: positions before the group's row i; pre[rows]: all
  int off[PREFIX_ROWS];      // store row of position p in row i: off[i] + p
  int warp_sum[TOPK_THREADS / 32];
};

// Scan the runs of window rows [g0, g0 + rows) into r (every thread calls
// it; it starts and ends with a barrier) and return their positions.
// run_of(i) gives row i's run of store rows, [x, y), y >= x.
template <typename RunOf>
__device__ __forceinline__ int scan_runs(WindowRuns& r, int g0, int rows, RunOf run_of) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (rows + TOPK_THREADS - 1) / TOPK_THREADS;  // rows per thread
  const int i0 = threadIdx.x * per, i1 = min(i0 + per, rows);
  int mine = 0;
  for (int i = i0; i < i1; ++i) {
    const int2 e = run_of(g0 + i);
    mine += e.y - e.x;
  }
  int incl = mine;  // inclusive scan over the warp's threads
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __syncthreads();  // the previous group's walk and finish have read r
  if (lane == 31) r.warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - mine;
  for (int q = 0; q < warp; ++q) run += r.warp_sum[q];
  for (int i = i0; i < i1; ++i) {
    const int2 e = run_of(g0 + i);
    r.pre[i] = run;
    r.off[i] = e.x - run;
    run += e.y - e.x;
  }
  if (threadIdx.x == TOPK_THREADS - 1) r.pre[rows] = run;  // the last thread's end: the total
  __syncthreads();
  return r.pre[rows];
}

// The group's row holding position p (0 <= p < pre[rows]): the last i with
// pre[i] <= p, a non-empty run.
__device__ __forceinline__ int run_at(const WindowRuns& r, int rows, int p) {
  int lo = 0, hi = rows;  // pre[lo] <= p < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (r.pre[mid] <= p) lo = mid; else hi = mid;
  }
  return lo;
}

// STAGED: rows reach shared memory through staged_rank's ring (d >=
// STAGE_TD); else direct_rank reads them from device memory.  The direct
// instance is held to 32 registers, so that eight blocks (64 warps) share an
// SM: the locator and the group loop took it from 40 to 48 registers (five
// blocks), and on an H100 at the map's d 2 the cap (a 16-byte spill) runs
// 1.46 ms a 65,536-query call against 1.56 ms at six blocks and 1.67 ms at
// five.  The staged instance's shared memory holds it to two blocks anyway.
template <bool STAGED>
__global__ void __launch_bounds__(TOPK_THREADS, STAGED ? 2 : 8) csr_candidate_topk_kernel(
    const float* __restrict__ store,    // (n_pad, d)
    const int* __restrict__ starts,     // (B, w)
    const int* __restrict__ ends,       // (B, w)
    const float* __restrict__ queries,  // (B, d)
    const float* __restrict__ radii,    // (B,) or nullptr
    float* __restrict__ out_d,          // (B, k)
    int* __restrict__ out_i,            // (B, k)
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                          // STAGE_RING x STAGE_TR x STAGE_LD
  int* rows = (int*)(ring + STAGE_RING * STAGE_TR * STAGE_LD);  // STAGE_RING x STAGE_TR
  float* qs = STAGED ? (float*)(rows + STAGE_RING * STAGE_TR) : smem;  // d
  __shared__ TopkShared top;
  __shared__ WindowRuns runs;

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  float* od = out_d + (long long)b * k;
  int* oi = out_i + (long long)b * k;
  const TopkList list = topk_init(top, od, oi, k);

  const int slots = w * row_cap;
  const int s_max = max(n_pad - row_cap, 0);
  const int* st_b = starts + (long long)b * w;
  const int* en_b = ends + (long long)b * w;
  // window row i covers row_cap store rows from its clamped start
  auto row_start = [&](int i) { return min(max(st_b[i], 0), s_max); };
  // its valid slots: the store rows [x, y) in [start, end) and below n
  auto run_of = [&](int i) {
    const int cs = row_start(i), x = max(cs, st_b[i]);
    return make_int2(x, max(x, min(min(cs + row_cap, en_b[i]), n)));
  };
  const float r_b = radii != nullptr ? radii[b] : 0.0f;
  auto keep = [&](float dd) { return radii == nullptr || dd <= r_b; };

  int g0 = 0, gr = 0, v = 0;  // the group's first row, its rows, its positions
  // the store row of the group's position p, or -1 past its last
  auto row_at = [&](int p) { return p < v ? runs.off[run_at(runs, gr, p)] + p : -1; };
  for (; g0 < w; g0 += PREFIX_ROWS) {
    if (g0 > 0) {
      // the previous group's positions in the list become their slots less
      // w*row_cap: below every position of the groups to come, in slot order
      __syncthreads();
      topk_merge(top, list);
      for (int e = threadIdx.x; e < k; e += blockDim.x) {
        const int p = list.s[e];
        if (p == INT_MAX || p < 0) continue;
        const int i = run_at(runs, gr, p), wr = g0 - PREFIX_ROWS + i;
        list.s[e] = wr * row_cap + (runs.off[i] + p - row_start(wr)) - slots;
      }
      __syncthreads();
      if (threadIdx.x == 0) top.thr_s = list.s[k - 1];
    }
    gr = min(PREFIX_ROWS, w - g0);
    v = scan_runs(runs, g0, gr, run_of);
    if constexpr (!STAGED) {
      __shared__ float sc[TOPK_CHUNK];
      direct_rank(top, list, sc, v, [&](int p) {
        const int j = row_at(p);
        if (j < 0) return INFINITY;
        const float dd = chunked_distance(store + (long long)j * d, qs, d, d_chunk, metric_l1,
                                          center_cells);
        return keep(dd) ? dd : INFINITY;
      });
    } else {
      staged_rank(top, list, ring, rows, STAGE_TR, store, qs, v, d, d_chunk, metric_l1,
                  center_cells, vec, row_at, keep);
    }
  }
  topk_finish(top, list, od, oi, [&](int p) {
    if (p >= 0) return row_at(p);
    const int s = p + slots, wr = s / row_cap;  // an earlier group's slot
    return row_start(wr) + (s - wr * row_cap);
  });
}

extern "C" int csr_candidate_topk_launch(
    const void* store, const void* starts, const void* ends,
    const void* queries, const void* radii, void* out_d, void* out_i, int B,
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells, void* stream) {
  const bool staged = d >= STAGE_TD;
  const size_t smem =
      (staged ? (size_t)STAGE_RING * STAGE_TR * (STAGE_LD + 1) * 4 : 0) + (size_t)d * 4;
  const auto kernel = staged ? csr_candidate_topk_kernel<true> : csr_candidate_topk_kernel<false>;
  const int e = allow_shared_bytes(kernel, smem);
  if (e != 0) return e;
  // 16-byte copies need every row on a 16-byte boundary
  const int vec = d % 4 == 0 && (uintptr_t)store % 16 == 0;
  kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)store, (const int*)starts, (const int*)ends,
      (const float*)queries, (const float*)radii, (float*)out_d, (int*)out_i,
      w, row_cap, d, n_pad, n, k, d_chunk, metric_l1, center_cells, vec);
  return (int)cudaGetLastError();
}
