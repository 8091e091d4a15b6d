// Device code shared by the port's kernels (included by the .cu sources).
//
// One definition each of the pieces whose results must agree between
// kernels: the chunked l1/l2 row distance (chunked_distance in the direct
// walk of rows of d < 32, ChunkedSum in the staged walk, both built on
// distance_term and fold_chunk), the circle mask of a pyramid cell
// (tile_count, tile_count_multilevel, radius_search_loop), the level window
// of a count (level_window and window_cell: tile_count_multilevel,
// radius_search_loop), the exact top-k selection (every candidate kernel)
// and the two walks of a float32 candidate kernel over its window
// (direct_rank, staged_rank: csr_candidate_topk and candidate_topk, which
// differ only in how a slot locates its row).  Two kernels that rank the
// same row therefore produce the same float, which the reference's
// "shortlist containment => bit parity" contract and hopper_gather ==
// hopper rest on.
//
// Numerics: the sources are built with -fmad=false, and every product and
// sum here is written with __fmul_rn / __fadd_rn / __fsub_rn, so no FMA
// changes a rounding; sqrtf is IEEE (no fast math).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

// One term of a row distance: x (or, with center_cells, its cell center
// floor(x) + 0.5) against q, added to the running chunk's partial sum.
__device__ __forceinline__ float distance_term(float part, float x, float q, int metric_l1,
                                               int center_cells) {
  if (center_cells) x = __fadd_rn(floorf(x), 0.5f);
  const float df = __fsub_rn(x, q);
  return metric_l1 ? __fadd_rn(part, fabsf(df)) : __fadd_rn(part, __fmul_rn(df, df));
}

// A finished chunk's partial sum added to the row's sum; the first chunk
// starts it.
__device__ __forceinline__ float fold_chunk(float acc, float part, bool first) {
  return first ? part : __fadd_rn(acc, part);
}

__device__ __forceinline__ float row_distance(float acc, int metric_l1) {
  return metric_l1 ? acc : sqrtf(fmaxf(acc, 0.0f));
}

// l1 or l2 distance of row x (d floats) to the query qs (d floats): summed
// per d_chunk block in order, then across blocks in order.  center_cells
// ranks floor(x) + 0.5 (paper mode's cell centers) instead of x.
__device__ __forceinline__ float chunked_distance(
    const float* __restrict__ x, const float* qs, int d, int d_chunk,
    int metric_l1, int center_cells) {
  float acc = 0.0f;
  for (int c0 = 0; c0 < d; c0 += d_chunk) {
    const int c1 = min(c0 + d_chunk, d);
    float part = 0.0f;
    for (int c = c0; c < c1; ++c) part = distance_term(part, x[c], qs[c], metric_l1, center_cells);
    acc = fold_chunk(acc, part, c0 == 0);
  }
  return row_distance(acc, metric_l1);
}

// chunked_distance's sum for a row that arrives in pieces, feature by
// feature in order (staged_rank's stages): call boundary(c)
// before feature c's term wherever a chunk may end at c, then add().
struct ChunkedSum {
  float acc, part;
  int next;    // where the running chunk ends
  bool first;  // no chunk folded yet
  __device__ explicit ChunkedSum(int d_chunk) : acc(0.0f), part(0.0f), next(d_chunk), first(true) {}
  __device__ __forceinline__ void boundary(int c, int d_chunk) {
    if (c != next) return;
    acc = fold_chunk(acc, part, first);
    first = false;
    part = 0.0f;
    next += d_chunk;
  }
  __device__ __forceinline__ void add(float x, float q, int metric_l1, int center_cells) {
    part = distance_term(part, x, q, metric_l1, center_cells);
  }
  __device__ __forceinline__ float finish(int metric_l1) const {
    return row_distance(fold_chunk(acc, part, first), metric_l1);
  }
};

// Whether the center ((x+0.5)*scale, (y+0.5)*scale) of level cell (x, y)
// lies inside the l1/l2 circle of radius r around (qx, qy).
__device__ __forceinline__ bool cell_in_circle(int x, int y, float scale,
                                               float qx, float qy, float r,
                                               int metric_l1) {
  const float dx = __fsub_rn(__fmul_rn(__fadd_rn((float)x, 0.5f), scale), qx);
  const float dy = __fsub_rn(__fmul_rn(__fadd_rn((float)y, 0.5f), scale), qy);
  if (metric_l1) return __fadd_rn(fabsf(dx), fabsf(dy)) <= r;
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= __fmul_rn(r, r);
}

// The clamped T x T window that a count reads around (qx, qy) at pyramid
// level lv (clamped to [0, L-1]) of the flattened tile array
// (sum_l nblk_l^2, T, T, C), nblk_l = 2^(L-1-l): the level's first tile, its
// block count, its cell scale and the window's origin.  tile_count_multilevel
// and radius_search_loop read their windows through level_window and
// window_cell, so both count the same cells.
struct LevelWindow {
  long long off;  // first tile of the level
  int nblk, ox, oy;
  float scale;
};

__device__ __forceinline__ LevelWindow level_window(int lv, int L, int T, float qx, float qy) {
  LevelWindow w;
  lv = lv < 0 ? 0 : (lv > L - 1 ? L - 1 : lv);
  w.nblk = 1 << (L - 1 - lv);
  w.off = 0;
  for (int j = 0; j < lv; ++j) {
    const long long nb = 1LL << (L - 1 - j);
    w.off += nb * nb;
  }
  w.scale = (float)(1 << lv);
  const int s_l = w.nblk * T;
  w.ox = min(max((int)floorf(qx / w.scale) - T / 2, 0), s_l - T);
  w.oy = min(max((int)floorf(qy / w.scale) - T / 2, 0), s_l - T);
  return w;
}

// Cell `cell` (row-major, x = cell / T) of the window: whether its center
// lies inside the circle of radius r, and in *base the index of its first
// channel (tile off + (x/T)*nblk + (y/T), in-tile (x%T, y%T)).
__device__ __forceinline__ bool window_cell(const LevelWindow& w, int cell, int T, int C,
                                            float qx, float qy, float r, int metric_l1,
                                            long long* base) {
  const int x = w.ox + cell / T;
  const int y = w.oy + cell % T;
  const long long tid = w.off + (long long)(x / T) * w.nblk + (y / T);
  *base = ((tid * T + (x % T)) * T + (y % T)) * C;
  return cell_in_circle(x, y, w.scale, qx, qy, r, metric_l1);
}

__device__ __forceinline__ bool better(float v, int s, float bv, int bs) {
  return v < bv || (v == bv && s < bs);
}

// Exact top-k of a block's stream of (value, slot) candidates, in shared
// memory that depends on k, not on the number of slots: filter, then merge
// (brute_knn.cu's pattern, for one query per block).
//
// The order is total: smaller value first, then smaller slot.  A running
// list of the k best pairs, sorted, lives in shared memory for
// k <= TOPK_SMEM_K, else in the caller's output row (device memory the
// wrapper allocates); unfilled entries are (+inf, INT_MAX).  A candidate
// is offered only if its value is finite and it is better() than the
// list's k-th pair (the threshold), so no tie is lost; survivors go to a
// shared buffer of TOPK_BUF pairs.  The block offers at most TOPK_WAVE
// pairs between two checks; a check (topk_check, at a barrier of the
// caller's loop) merges when fewer than TOPK_WAVE places are left, and
// once early, as soon as k pairs wait, so that the threshold becomes
// finite.  The callers rank their candidates from the middle of the
// window out (middle_out, centred_chunk): a window is centred on its
// query, so the nearest come first and the threshold is tight early.  A
// merge sorts the buffer (bitonic), ranks each survivor in the list by
// binary search, shifts the list's tail up, writes the survivors that
// rank below k and reads the new threshold.  The result is what k rounds
// of a block arg-min over every slot give: the same pairs, best first,
// (+inf, -1) where fewer than k slots have a finite value (k may exceed
// the slots), and -1 for every slot whose value is not finite.

#define TOPK_THREADS 256
#define TOPK_BUF 512     // survivor buffer (a power of two)
#define TOPK_WAVE 256    // offers at most between two checks
#define TOPK_SMEM_K 128  // lists of k <= TOPK_SMEM_K live in shared memory
#define TOPK_CHUNK 4096  // scores a caller stages per topk_offer_chunk
// TopkShared takes 8 * (TOPK_BUF + TOPK_SMEM_K) + 16 bytes
// (kernels/candidate_topk.py: TOPK_SHARED_BYTES, checked by chip_smoke.py)

struct TopkShared {
  float buf_v[TOPK_BUF];
  int buf_s[TOPK_BUF];
  float list_v[TOPK_SMEM_K];
  int list_s[TOPK_SMEM_K];
  float thr_v;  // the list's k-th pair: the bar a candidate must beat
  int thr_s;
  int cnt;      // survivors in the buffer
  int early;    // before the first merge, k - 1: the k-th survivor asks for one
};

// The running list of one block: in shared memory or in its output row.
struct TopkList {
  float* v;
  int* s;
  int k;
};

// Start an empty list (out_d / out_i: the block's output row, k entries).
// Every thread calls it; the caller's next barrier publishes it.
__device__ __forceinline__ TopkList topk_init(TopkShared& t, float* out_d, int* out_i, int k) {
  const bool smem = k <= TOPK_SMEM_K;
  TopkList l{smem ? t.list_v : out_d, smem ? t.list_s : out_i, k};
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    l.v[i] = INFINITY;
    l.s[i] = INT_MAX;
  }
  if (threadIdx.x == 0) {
    t.thr_v = INFINITY;
    t.thr_s = INT_MAX;
    t.cnt = 0;
    t.early = k - 1;
  }
  return l;
}

// Offer one candidate.  Returns whether the buffer now needs a merge
// before the next wave: fewer than TOPK_WAVE places are left, or it holds
// the first k survivors (a merge then sets the first finite threshold).
__device__ __forceinline__ bool topk_offer(TopkShared& t, float v, int s) {
  if (!(v < INFINITY) || !better(v, s, t.thr_v, t.thr_s)) return false;
  const int pos = atomicAdd(&t.cnt, 1);
  t.buf_v[pos] = v;
  t.buf_s[pos] = s;
  return pos >= TOPK_BUF - TOPK_WAVE || pos == t.early;
}

// The i-th of n blocks in middle-out order: n/2, n/2 - 1, n/2 + 1, ...
// A window is centred on its query, so its middle holds the nearest
// candidates; ranked first, they set a tight threshold early.
__device__ __forceinline__ int middle_out(int i, int n) {
  const int h = (i + 1) >> 1;
  return (i & 1) ? n / 2 - h : n / 2 + h;
}

// Entries of a sorted array (n pairs) that are better than (v, s).
__device__ __forceinline__ int topk_rank(const float* av, const int* as, int n, float v, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(av[mid], as[mid], v, s)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge the buffer into the list.  Every thread calls it after a barrier
// that follows the offers; it ends with a barrier.
__device__ void topk_merge(TopkShared& t, TopkList l) {
  const int c = t.cnt;  // the same for every thread: read after a barrier
  if (c == 0) return;
  int p = 2;
  while (p < c) p <<= 1;
  for (int i = c + threadIdx.x; i < p; i += blockDim.x) {
    t.buf_v[i] = INFINITY;
    t.buf_s[i] = INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {  // bitonic sort, best first
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = 2 * stride * (i / stride) + i % stride, hi = lo + stride;
        const bool up = (lo & size) == 0;
        if (better(t.buf_v[hi], t.buf_s[hi], t.buf_v[lo], t.buf_s[lo]) == up) {
          const float v = t.buf_v[lo];
          const int s = t.buf_s[lo];
          t.buf_v[lo] = t.buf_v[hi];
          t.buf_s[lo] = t.buf_s[hi];
          t.buf_v[hi] = v;
          t.buf_s[hi] = s;
        }
      }
      __syncthreads();
    }
  }
  // each survivor's place in the merged list: its rank in the buffer plus
  // the list entries that beat it (slots are distinct: no ties)
  const int k = l.k;
  const int first = topk_rank(l.v, l.s, k, t.buf_v[0], t.buf_s[0]);
  int pos[TOPK_BUF / TOPK_THREADS];
#pragma unroll
  for (int r = 0; r < TOPK_BUF / TOPK_THREADS; ++r) {
    const int i = threadIdx.x + r * TOPK_THREADS;
    pos[r] = i < c ? i + topk_rank(l.v, l.s, k, t.buf_v[i], t.buf_s[i]) : k;
  }
  __syncthreads();
  // list entries from `first` up move up by the survivors that beat them;
  // top chunk first, so no entry is overwritten before it is read
  for (int top = first + ((k - 1 - first) / TOPK_THREADS) * TOPK_THREADS;
       first < k && top >= first; top -= TOPK_THREADS) {
    const int i = top + threadIdx.x;
    float v = INFINITY;
    int s = INT_MAX, shift = 0;
    if (i < k) {
      v = l.v[i];
      s = l.s[i];
      shift = topk_rank(t.buf_v, t.buf_s, c, v, s);
    }
    __syncthreads();
    if (i < k && shift > 0 && i + shift < k) {
      l.v[i + shift] = v;
      l.s[i + shift] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < TOPK_BUF / TOPK_THREADS; ++r) {
    const int i = threadIdx.x + r * TOPK_THREADS;
    if (pos[r] < k) {
      l.v[pos[r]] = t.buf_v[i];
      l.s[pos[r]] = t.buf_s[i];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    t.thr_v = l.v[k - 1];
    t.thr_s = l.s[k - 1];
    t.cnt = 0;
    t.early = -1;
  }
  __syncthreads();
}

// The check between waves: a block-wide barrier that merges when any
// thread's offer (full: topk_offer's result) asked for a merge.  Every
// thread calls it.
__device__ __forceinline__ void topk_check(TopkShared& t, TopkList l, bool full) {
  if (__syncthreads_or(full)) topk_merge(t, l);
}

// Chunks of TOPK_CHUNK of n items centred on n / 2: step 0 is the middle
// chunk [n/2 - TOPK_CHUNK/2, n/2 + TOPK_CHUNK/2), then the next one above,
// the next below, and so on, clipped to [0, n).  chunk_steps(n) steps
// cover the items; centred_chunk(i, n) is step i's [x, y), empty (x >= y)
// where the clipping leaves nothing.
__device__ __forceinline__ int chunk_steps(int n) {
  return 2 * ((n - n / 2 + TOPK_CHUNK / 2 + TOPK_CHUNK - 1) / TOPK_CHUNK) + 1;
}

__device__ __forceinline__ int2 centred_chunk(int i, int n) {
  const int k = (i & 1) ? (i + 1) / 2 : -(i / 2);
  const int lo = n / 2 - TOPK_CHUNK / 2 + k * TOPK_CHUNK;
  return make_int2(max(lo, 0), min(lo + TOPK_CHUNK, n));
}

// Offer a chunk of scores staged in shared memory: sc[i] is slot base +
// i's score (+inf where the slot is no candidate), i < cn <= TOPK_CHUNK.
// Every thread calls it after writing its scores: a barrier publishes
// them, then waves of TOPK_WAVE offers, each followed by a check, from the
// chunk's middle out.  On return sc may be written again.  Computing a
// chunk's scores needs no barrier, so its loads overlap across slots.
__device__ __forceinline__ void topk_offer_chunk(TopkShared& t, TopkList l, const float* sc,
                                                 int base, int cn) {
  __syncthreads();
  const int waves = (cn + TOPK_WAVE - 1) / TOPK_WAVE;
  for (int wi = 0; wi < waves; ++wi) {
    const int i = middle_out(wi, waves) * TOPK_WAVE + threadIdx.x;
    topk_check(t, l, i < cn && topk_offer(t, sc[i], base + i));
  }
}

// After the last wave: merge what is left, then write the block's k pairs
// to its output row, each slot through row_of (its global row, or the slot
// itself), (+inf, -1) for the pads.  Every thread calls it.
template <typename RowOf>
__device__ __forceinline__ void topk_finish(TopkShared& t, TopkList l, float* out_d,
                                            int* out_i, RowOf row_of) {
  __syncthreads();
  topk_merge(t, l);
  for (int i = threadIdx.x; i < l.k; i += blockDim.x) {
    const float v = l.v[i];
    const int s = l.s[i];
    out_d[i] = v;
    out_i[i] = v < INFINITY ? row_of(s) : -1;
  }
}

// ---- The two walks of a float32 candidate kernel (csr_candidate_topk.cu,
// candidate_topk.cu) over its query's window of `slots` slots.  A kernel
// gives each walk a slot locator; the walks rank what it locates.

// Rows of d < STAGE_TD floats: chunks of TOPK_CHUNK slots, the window's
// middle first; each thread computes its slots' scores (score(s): the
// distance, or +inf where slot s is no candidate) straight from device
// memory into sc (shared, TOPK_CHUNK floats), with no barrier between
// slots, so a thread's loads of several rows overlap; then the chunk is
// offered.  Every thread calls it after topk_init and the query's staging.
template <typename Score>
__device__ __forceinline__ void direct_rank(TopkShared& top, TopkList list, float* sc, int slots,
                                            Score score) {
  __syncthreads();
  for (int ci = 0; ci < chunk_steps(slots); ++ci) {
    const int2 r = centred_chunk(ci, slots);
    if (r.x >= r.y) continue;
    const int c0 = r.x, cn = r.y - r.x;
    for (int i = threadIdx.x; i < cn; i += blockDim.x) sc[i] = score(c0 + i);
    topk_offer_chunk(top, list, sc, c0, cn);
  }
}

// Rows of d >= STAGE_TD floats, staged.  A tile is STAGE_TR = 256
// consecutive slots, one per thread, and a stage is STAGE_TD = 32 feature
// dims (one 128-byte line of each row) of a tile.  Tiles go from the
// window's middle out (nearest first).  Stages reach shared memory by
// cp.async (16-byte copies when vec: d a multiple of 4 and `base` 16-byte
// aligned; else 4-byte copies) through a ring of STAGE_RING = 2 slots, so
// the copies of the next stage overlap this stage's distances; each warp
// copies its own 32 rows, neighbouring lanes on neighbouring bytes (a row's
// number comes from its owner by a shuffle), and slots that are no
// candidate copy nothing.  Staged rows are STAGE_LD = STAGE_TD + 4 floats
// apart, so the 16-byte reads of a quarter-warp fall in distinct banks.
// Each thread adds its own row's terms from shared memory in exactly
// chunked_distance's order through ChunkedSum (per d_chunk block, in
// feature order); its partial sums carry across stages.  After a tile's
// last stage each located slot whose distance keep() accepts is offered to
// the top-k, whose buffer is checked at the next stage's barrier.
//
// row_of(s): slot s's row, base + row * d (-1: no candidate; slots >= the
// window's are never located).  ring: STAGE_RING * tile_rows * STAGE_LD
// floats; tile_rows = STAGE_TR, or fewer (a multiple of 32, at least the
// slots) for a window of one partial tile.  rows: STAGE_RING * STAGE_TR
// ints.  Every thread calls it after topk_init and the query's staging
// into qs; the first stage's barrier publishes both.
#define STAGE_TD 32                // feature dims per stage
#define STAGE_LD (STAGE_TD + 4)    // staged row stride (floats)
#define STAGE_RING 2               // ring slots
#define STAGE_TR TOPK_THREADS      // slots per tile: one per thread

__device__ __forceinline__ void stage_cp_async(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most STAGE_RING - 2 of this thread's copy groups are in flight.
__device__ __forceinline__ void stage_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGE_RING - 2) : "memory");
}

template <typename RowOf, typename Keep>
__device__ __forceinline__ void staged_rank(
    TopkShared& top, TopkList list, float* ring, int* rows, int tile_rows,
    const float* __restrict__ base, const float* qs, int slots, int d, int d_chunk,
    int metric_l1, int center_cells, int vec, RowOf row_of, Keep keep) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (slots + STAGE_TR - 1) / STAGE_TR;
  const int nd = (d + STAGE_TD - 1) / STAGE_TD;          // stages per tile
  const int total = ntiles * nd;                         // stages in all
  const int gbytes = vec ? 16 : 4;                       // bytes per copy
  const int gpr = STAGE_TD * 4 / gbytes;                 // copies per row and stage

  // Issue the copies of stage t (the (t / nd)-th tile in middle-out order,
  // dims (t % nd)·TD ..) into ring slot t % STAGE_RING; with a tile's first
  // stage, each thread also locates its own slot's row (-1 if none) and
  // keeps it in `rows` (a ring of STAGE_RING tiles: copies run at most
  // STAGE_RING - 1 stages ahead).
  auto issue = [&](int t) {
    const int ti = t / nd, c0 = (t - ti * nd) * STAGE_TD, slot = t % STAGE_RING;
    int j;
    if (c0 == 0) {
      j = row_of(middle_out(ti, ntiles) * STAGE_TR + tid);
      rows[(ti % STAGE_RING) * STAGE_TR + tid] = j;
    } else {
      j = rows[(ti % STAGE_RING) * STAGE_TR + tid];
    }
    float* dst = ring + slot * tile_rows * STAGE_LD;
    for (int m = 0; m < gpr; ++m) {
      const int r = m * (32 / gpr) + lane / gpr;  // this copy's row within the warp
      const int rj = __shfl_sync(0xffffffffu, j, r);
      const int c = c0 + (lane % gpr) * (gbytes / 4);
      if (rj >= 0 && c < d)
        stage_cp_async(dst + (warp * 32 + r) * STAGE_LD + (c - c0), base + (long long)rj * d + c,
                       gbytes);
    }
    stage_commit();
  };

  for (int t = 0; t < STAGE_RING - 1; ++t) {
    if (t < total) issue(t); else stage_commit();
  }

  ChunkedSum sum(d_chunk);  // this thread's row, carried across its tile's stages
  bool full = false;        // this thread's offer asked for a merge
  for (int t = 0; t < total; ++t) {
    const int ti = t / nd, c0 = (t - ti * nd) * STAGE_TD;
    const int slot = t % STAGE_RING;
    stage_wait_ring();  // this thread's copies of stage t have landed
    topk_check(top, list, full);  // a barrier: every thread's have, slot t-1 is free
    full = false;
    if (t + STAGE_RING - 1 < total) issue(t + STAGE_RING - 1); else stage_commit();

    const int j = rows[(ti % STAGE_RING) * STAGE_TR + tid];
    const int dn = min(STAGE_TD, d - c0);
    if (j >= 0) {
      const float* x = ring + (slot * tile_rows + tid) * STAGE_LD;
      sum.boundary(c0, d_chunk);  // a chunk may end where the stage starts
      if (dn == STAGE_TD && c0 + STAGE_TD <= sum.next) {  // a whole stage inside one chunk
#pragma unroll
        for (int g = 0; g < STAGE_TD / 4; ++g) {
          const float4 x4 = *reinterpret_cast<const float4*>(x + 4 * g);
          sum.add(x4.x, qs[c0 + 4 * g], metric_l1, center_cells);
          sum.add(x4.y, qs[c0 + 4 * g + 1], metric_l1, center_cells);
          sum.add(x4.z, qs[c0 + 4 * g + 2], metric_l1, center_cells);
          sum.add(x4.w, qs[c0 + 4 * g + 3], metric_l1, center_cells);
        }
      } else {
        for (int c = c0; c < c0 + dn; ++c) {
          sum.boundary(c, d_chunk);
          sum.add(x[c - c0], qs[c], metric_l1, center_cells);
        }
      }
    }
    if (c0 + dn == d) {  // the tile's last stage: its distances are complete
      if (j >= 0) {
        const float dd = sum.finish(metric_l1);
        if (keep(dd)) full = topk_offer(top, dd, middle_out(ti, ntiles) * STAGE_TR + tid);
      }
      sum = ChunkedSum(d_chunk);
    }
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// 48 KB default; returns the CUDA error code (0 on success).
template <typename Kernel>
__host__ int allow_shared_bytes(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
