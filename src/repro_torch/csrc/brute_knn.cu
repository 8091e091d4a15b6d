// Exact l2 kNN (brute force) on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/brute_knn.py::brute_knn.  For each
// query q of (B, d) against the points x of (N, d): the distance
// sqrt(max(‖q‖² − 2q·x + ‖x‖², 0)), and the k smallest (distance, index)
// pairs, lower index first on equal distances.  Ranks the square-rooted
// value, as the reference does: two distinct squared distances can round to
// one root, and then the lower index wins.  Slots left empty (k > N) and
// non-finite distances give +inf / -1.  The `exact` backend's l2 route
// (core/exact.py) runs it.  Plain version:
// repro_torch/kernels/ref.py::brute_knn.
//
// What bounds it on this card: operations.  Every (query, point) pair
// costs 2d float operations for the product, so at d = 128 the work is
// 2dBN against (B + N)d floats read.  At d = 2 the per-pair tail (the
// distance form and the top-k test) is the work.
//
// Design.  A block of 256 threads owns a tile of 32 queries and one of
// `splits` contiguous ranges of the points, which it streams in tiles of
// 128.  Each tile is staged in shared memory 32 feature dims at a time,
// beside the same dims of the 32 queries.  Warp w owns queries 4w..4w+3
// and lane l points l, l+32, l+64, l+96 of the tile, so each thread holds
// the 16 float32 dot products of its 4 x 4 pairs in registers.  The points'
// rows are padded to 33 floats so the lanes' reads fall in distinct banks;
// the queries' reads are broadcasts.  ‖x‖² is summed by one thread per
// point, ‖q‖² once per block.
//
// Top-k: each warp keeps, for each of its queries, a sorted list of the
// best k pairs so far, one entry per lane (so k <= 32).  A pair enters only
// if it beats the list's k-th; a cheap test on the squared distance
// (`sq_bound`) rejects almost every pair before its square root is taken,
// so the TPU kernel's k rounds of arg-min over k + tile entries per tile
// become a few warp votes.  The TPU kernel's sequential N-block grid axis
// with a top-k carried in VMEM becomes the point loop inside the block; the
// `splits` point ranges give the card enough blocks when B is small, and a
// second kernel merges each query's `splits` partial lists, ordered by
// (distance, index), into the result.
//
// Numerics: the sources are built with -fmad=false.  The dot products are
// fused multiply-adds on purpose (__fmaf_rn), in feature order, as a
// float32 GEMM accumulates; ‖q‖² and ‖x‖² round each square and add the
// squares in feature order (__fmul_rn / __fadd_rn), as the plain version's
// ref.sq_norms does.  The order matters more than it seems: in
// ‖q‖² − 2q·x + ‖x‖² an ulp of ‖x‖² is an ulp of a large number, not of the
// distance, so a reduction in another order moves near-tied neighbours.
// Where cuBLAS's product is the same fused chain, kernel and plain version
// agree bit for bit (chip_smoke phase 1 reports `bit_equal` per case).
// sqrtf is IEEE (no fast math).

#include <limits.h>

#include "kernel_common.cuh"

#define BK_THREADS 256
#define BK_WARPS (BK_THREADS / 32)
#define BK_QPW 4                    // queries per warp
#define BK_BQ (BK_WARPS * BK_QPW)   // queries per block: 32
#define BK_PPL 4                    // points per lane
#define BK_BN (32 * BK_PPL)         // points per tile: 128
#define BK_DC 32                    // feature dims per staged chunk
#define FULL_MASK 0xffffffffu

// A squared distance above sq_bound(t) has a correctly rounded root above t
// (the bound sits more than an ulp of t above t², rounded up), so skipping
// such pairs never drops one that ties or beats t.
__device__ __forceinline__ float sq_bound(float t) {
  return __fmul_ru(__fmul_ru(t, t), 1.000001f);
}

// Insert (v, id) into a warp's ascending list (lane r holds entry r; empty
// entries are (+inf, INT_MAX)).  The caller has checked that (v, id) beats
// entry k-1, so it lands at a lane below k; entries from there on shift
// one lane up.  Every lane of the warp calls it with the same (v, id).
__device__ __forceinline__ void list_insert(float& ld, int& li, float v, int id, int lane) {
  const unsigned worse = __ballot_sync(FULL_MASK, better(v, id, ld, li));
  if (worse == 0) return;
  const int pos = __ffs(worse) - 1;
  const float pd = __shfl_up_sync(FULL_MASK, ld, 1);
  const int pi = __shfl_up_sync(FULL_MASK, li, 1);
  if (lane > pos) {
    ld = pd;
    li = pi;
  } else if (lane == pos) {
    ld = v;
    li = id;
  }
}

__global__ void __launch_bounds__(BK_THREADS) brute_knn_kernel(
    const float* __restrict__ q,   // (B, d)
    const float* __restrict__ x,   // (N, d)
    float* __restrict__ part_d,    // (B, splits, k)
    int* __restrict__ part_i,      // (B, splits, k)
    int B, int N, int d, int k, int splits, int tiles_per_split) {
  __shared__ float qs[BK_BQ * BK_DC];
  __shared__ float xs[BK_BN * (BK_DC + 1)];
  __shared__ float xxs[BK_BN];
  __shared__ float qqs[BK_BQ];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BK_BQ;
  const int split = blockIdx.y;
  const long long span = (long long)tiles_per_split * BK_BN;
  const int n_begin = (int)min((long long)N, split * span);
  const int n_end = (int)min((long long)N, n_begin + span);

  if (tid < BK_BQ) {
    float acc = 0.0f;
    if (q0 + tid < B) {
      const float* row = q + (long long)(q0 + tid) * d;
      for (int c = 0; c < d; ++c) acc = __fadd_rn(acc, __fmul_rn(row[c], row[c]));
    }
    qqs[tid] = acc;
  }
  __syncthreads();

  float qq[BK_QPW], ld[BK_QPW], thr[BK_QPW], thr2[BK_QPW];
  int li[BK_QPW], thi[BK_QPW];
#pragma unroll
  for (int i = 0; i < BK_QPW; ++i) {
    qq[i] = qqs[warp * BK_QPW + i];
    ld[i] = INFINITY;
    li[i] = INT_MAX;
    thr[i] = INFINITY;  // the list's k-th entry
    thi[i] = INT_MAX;
    thr2[i] = INFINITY;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BK_BN) {
    float acc[BK_QPW][BK_PPL];
#pragma unroll
    for (int i = 0; i < BK_QPW; ++i)
#pragma unroll
      for (int j = 0; j < BK_PPL; ++j) acc[i][j] = 0.0f;
    float xx = 0.0f;  // ‖x‖² of point n0 + tid (threads below BK_BN)

    for (int c0 = 0; c0 < d; c0 += BK_DC) {
      const int dc = min(BK_DC, d - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int e = tid; e < BK_BQ * dc; e += BK_THREADS) {
        const int r = e / dc, c = e - r * dc;
        qs[r * BK_DC + c] = q0 + r < B ? q[(long long)(q0 + r) * d + c0 + c] : 0.0f;
      }
      for (int e = tid; e < BK_BN * dc; e += BK_THREADS) {
        const int p = e / dc, c = e - p * dc;
        xs[p * (BK_DC + 1) + c] = n0 + p < n_end ? x[(long long)(n0 + p) * d + c0 + c] : 0.0f;
      }
      __syncthreads();
      if (tid < BK_BN) {
        for (int c = 0; c < dc; ++c) {
          const float v = xs[tid * (BK_DC + 1) + c];
          xx = __fadd_rn(xx, __fmul_rn(v, v));
        }
      }
      for (int c = 0; c < dc; ++c) {
        float qv[BK_QPW], xv[BK_PPL];
#pragma unroll
        for (int i = 0; i < BK_QPW; ++i) qv[i] = qs[(warp * BK_QPW + i) * BK_DC + c];
#pragma unroll
        for (int j = 0; j < BK_PPL; ++j) xv[j] = xs[(lane + 32 * j) * (BK_DC + 1) + c];
#pragma unroll
        for (int i = 0; i < BK_QPW; ++i)
#pragma unroll
          for (int j = 0; j < BK_PPL; ++j) acc[i][j] = __fmaf_rn(qv[i], xv[j], acc[i][j]);
      }
    }
    if (tid < BK_BN) xxs[tid] = xx;
    __syncthreads();  // xxs is rewritten only after the next tile's first barrier

    float xxj[BK_PPL];
#pragma unroll
    for (int j = 0; j < BK_PPL; ++j) xxj[j] = xxs[lane + 32 * j];

#pragma unroll
    for (int i = 0; i < BK_QPW; ++i) {
#pragma unroll
      for (int j = 0; j < BK_PPL; ++j) {
        const int id = n0 + lane + 32 * j;
        float d2 = __fadd_rn(__fsub_rn(qq[i], __fmul_rn(2.0f, acc[i][j])), xxj[j]);
        d2 = d2 < 0.0f ? 0.0f : d2;  // max(., 0) that keeps a NaN (fmaxf drops it)
        unsigned m = __ballot_sync(FULL_MASK, id < n_end && d2 <= thr2[i]);
        while (m != 0) {  // warp-uniform: every lane sees the same m
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float s = sqrtf(__shfl_sync(FULL_MASK, d2, src));
          const int cid = n0 + src + 32 * j;
          if (s < INFINITY && better(s, cid, thr[i], thi[i])) {
            list_insert(ld[i], li[i], s, cid, lane);
            thr[i] = __shfl_sync(FULL_MASK, ld[i], k - 1);
            thi[i] = __shfl_sync(FULL_MASK, li[i], k - 1);
            thr2[i] = sq_bound(thr[i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BK_QPW; ++i) {
    const int qi = q0 + warp * BK_QPW + i;
    if (qi < B && lane < k) {
      const long long o = ((long long)qi * splits + split) * k + lane;
      part_d[o] = ld[i];
      part_i[o] = li[i];
    }
  }
}

// One warp per query: the `splits` partial lists into the final k, in
// (distance, index) order; empty slots give +inf / -1.
__global__ void __launch_bounds__(BK_THREADS) brute_knn_merge_kernel(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    float* __restrict__ out_d, int* __restrict__ out_i, int B, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * BK_WARPS + (threadIdx.x >> 5);
  if (qi >= B) return;  // the whole warp leaves together
  float ld = INFINITY, thr = INFINITY;
  int li = INT_MAX, thi = INT_MAX;
  const int total = splits * k;
  const long long base = (long long)qi * total;
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = e0 + lane;
    const float v = e < total ? part_d[base + e] : INFINITY;
    const int id = e < total ? part_i[base + e] : INT_MAX;
    unsigned m = __ballot_sync(FULL_MASK, v < INFINITY && better(v, id, thr, thi));
    while (m != 0) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float sv = __shfl_sync(FULL_MASK, v, src);
      const int sid = __shfl_sync(FULL_MASK, id, src);
      if (better(sv, sid, thr, thi)) {
        list_insert(ld, li, sv, sid, lane);
        thr = __shfl_sync(FULL_MASK, ld, k - 1);
        thi = __shfl_sync(FULL_MASK, li, k - 1);
      }
    }
  }
  if (lane < k) {
    out_d[(long long)qi * k + lane] = ld;
    out_i[(long long)qi * k + lane] = ld < INFINITY ? li : -1;
  }
}

extern "C" int brute_knn_launch(
    const void* q, const void* x, void* part_d, void* part_i, void* out_d,
    void* out_i, int B, int N, int d, int k, int splits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (N + BK_BN - 1) / BK_BN;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const dim3 grid((B + BK_BQ - 1) / BK_BQ, splits);
  brute_knn_kernel<<<grid, BK_THREADS, 0, s>>>(
      (const float*)q, (const float*)x, (float*)part_d, (int*)part_i, B, N, d, k,
      splits, tiles_per_split);
  const int e = (int)cudaGetLastError();
  if (e != 0) return e;
  brute_knn_merge_kernel<<<(B + BK_WARPS - 1) / BK_WARPS, BK_THREADS, 0, s>>>(
      (const float*)part_d, (const int*)part_i, (float*)out_d, (int*)out_i, B, splits, k);
  return (int)cudaGetLastError();
}
