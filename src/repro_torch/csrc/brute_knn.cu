// Exact l2 kNN (brute force) on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/brute_knn.py::brute_knn.  For each
// query q of (B, d) against the points x of (N, d): the distance
// sqrt(max(‖q‖² − 2q·x + ‖x‖², 0)), and the k smallest (distance, index)
// pairs, lower index first on equal distances, for any k.  Ranks the
// square-rooted value, as the reference does: two distinct squared
// distances can round to one root, and then the lower index wins.  Slots
// left empty (k > N) and non-finite distances give +inf / -1.  The `exact`
// backend's l2 route (core/exact.py) runs it.  Plain version:
// repro_torch/kernels/ref.py::brute_knn.
//
// What bounds it on this card: operations.  Every (query, point) pair
// costs 2d float operations for the product and 3 for the distance form,
// so at d = 128 the work is about 2dBN against (B + N)d floats read, and the
// float32 FMA units (67 TFLOP/s) are the limit.  At d = 2 the per-pair
// tail (the distance form and the top-k test) is the work.
//
// Design: the product as an SGEMM.  A pre-pass kernel copies the queries
// and the points, transposed, into (d, rows) scratch (rows padded to a
// multiple of 4) and writes each row's squared norm; the wrapper allocates
// the scratch, (B + N)(d + 1) floats: about 516 MB for 1M points at d = 128.
// The main kernel's block of 256 threads owns a tile of 128 queries and one
// of `splits` contiguous ranges of the points, which it streams in tiles
// of 128.  Thread (ty, tx) = (tid / 16, tid % 16) owns the 8 x 8 pairs of
// queries {4ty..4ty+3, 64+4ty..64+4ty+3} and points {4tx..4tx+3,
// 64+4tx..64+4tx+3}: 64 float32 accumulators in registers.  Query and point
// tiles reach shared memory 16 feature dims per stage, already in [dim][row]
// order, by cp.async 16-byte copies through a ring of 3 stages (so no
// register holds a staged value, and one barrier serves 16 dims); a
// thread's 8 queries and 8 points at one dim are four 16-byte shared loads
// for 64 FMAs, and a full stage runs with no guard between dims.  Why this
// shape: at two resident blocks of 8 warps the kernel is held to 128
// registers, of which the 64 accumulators and the fragments take most;
// staging a stage through registers (and transposing on the store) costs
// 16 more at 16 dims per stage, which spill, while 8-dim stages pay a
// barrier per 8 dims.  The copy ring needs no staging registers, so one
// barrier serves 16 dims, and it measured faster than both on the card.
//
// Top-k for any k: filter, then merge.  Each (query, range) keeps its
// running best-k list, sorted by (distance, index): in shared memory for
// k <= 16, else in the (B, splits, k) scratch in device memory.  Shared
// memory also holds each query's threshold sq_bound(τ) on the squared
// distance (τ = the list's k-th distance, +inf while the list is not
// full) and a buffer of 32 survivors per query.  After a tile's products,
// each thread computes its 64 distances and tests each against its
// query's threshold with no warp vote; a survivor takes a buffer slot (a
// shared atomic counter per query); a row of 8 pairs whose smallest d2
// fails is passed over after one test.  Points past the range carry a NaN
// ‖x‖², which fails every test.  One block-wide __syncthreads_or per tile
// asks whether a pair found its buffer full; if so the block merges every
// non-empty buffer into its list (one warp per query: roots, ranks within
// the buffer by shuffles, a binary search into the list, the list's tail
// shifted up, the k-th read back as the new τ) and the turned-away pairs,
// still in registers, are tested again against the lowered thresholds.
// The block merges once more at the end of its range.  Once τ is tight,
// few pairs survive (of the order of k·ln(range / k) per query), so merges
// are rare and k costs nothing in the product loop.  The TPU kernel's
// sequential N-block grid axis with a top-k carried in VMEM becomes the
// point loop inside the block; the `splits` point ranges fill two waves
// of two resident blocks per SM, and a second kernel merges each query's
// `splits` sorted lists by rank (each entry's rank is its index plus, per
// other list, a binary search).
//
// Numerics: the sources are built with -fmad=false.  Each pair's product is
// one fused multiply-add chain from 0 in feature order (__fmaf_rn), as a
// float32 GEMM accumulates, with no split over d and no tensor cores (TF32,
// even in three passes, would round other products and move which
// near-ties win); ‖q‖² and ‖x‖² round each square and add the squares in
// feature order (__fmul_rn / __fadd_rn, in the pre-pass), as the plain
// version's ref.sq_norms does; d2 = (‖q‖² − 2·acc) + ‖x‖², each step
// rounded; a NaN d2 never passes a threshold and a negative one is clamped
// to 0 as it enters a buffer.  The order matters more than it seems: in
// ‖q‖² − 2q·x + ‖x‖² an ulp of ‖x‖² is an ulp of a large number, not of
// the distance, so a reduction in another order moves near-tied
// neighbours.  Where cuBLAS's product is the same fused chain, kernel and
// plain version agree bit for bit (chip_smoke phase 1 reports `bit_equal`
// per case).  sqrtf is IEEE (no fast math).

#include <limits.h>
#include <stdint.h>

#include "kernel_common.cuh"

#define BK_THREADS 256
#define BK_BQ 128     // queries per block
#define BK_BN 128     // points per tile
#define BK_DS 16      // feature dims per stage
#define BK_STAGES 3   // ring slots: stages in flight (cp.async)
#define BK_ROW 132    // shared row stride of a staged dim (floats)
#define BK_BUF 32     // survivor buffer slots per query
#define BK_SMEM_K 16  // lists of k <= BK_SMEM_K live in shared memory
#define BK_MERGE_THREADS 128
#define BK_TR 32      // rows (and dims) per tile of the transposing pre-pass
#define FULL_MASK 0xffffffffu

// A squared distance above sq_bound(t) has a correctly rounded root above t
// (the bound sits more than an ulp of t above t², rounded up), so skipping
// such pairs never drops one that ties or beats t.
__device__ __forceinline__ float sq_bound(float t) {
  return __fmul_ru(__fmul_ru(t, t), 1.000001f);
}

// Row of the tile held by a thread's i-th (or j-th) accumulator: 4 rows
// at 4t and 4 at 64 + 4t.
__device__ __forceinline__ int tile_row(int t, int i) {
  return (i < 4 ? 0 : 64 - 4) + 4 * t + i;
}

struct Shared {
  float qs[BK_STAGES][BK_DS][BK_ROW];  // query stages, [dim][row]
  float xs[BK_STAGES][BK_DS][BK_ROW];  // point stages, [dim][row]
  float xx[BK_STAGES][BK_BN];          // ‖x‖² of the tiles in flight
  float qq[BK_BQ];                     // ‖q‖² of the block's queries
  float thr2[BK_BQ];                   // sq_bound(τ); -1 for rows past B
  int cnt[BK_BQ];                      // survivors appended since the last merge
  float bufd[BK_BQ][BK_BUF];           // survivors: squared distance
  int bufi[BK_BQ][BK_BUF];             //            point index
};

// Dynamic shared memory of one block: the fixed part, then the running
// lists when k <= BK_SMEM_K (128 x k distances and ids).
static size_t bk_shared_bytes(int k) {
  return sizeof(Shared) + (k <= BK_SMEM_K ? (size_t)BK_BQ * k * 8 : 0);
}

// 16-byte asynchronous copy into shared memory; ok == false writes zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most BK_STAGES - 2 of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(BK_STAGES - 2) : "memory");
}

// The pre-pass: the rows of src (R, d) transposed into dst (d, Rp), rows
// R .. Rp-1 zero, and each row's ‖·‖² into norms (squares rounded, then
// added in feature order, as ref.sq_norms).  A block of 32 x 8 threads
// takes 32 rows through a shared tile, 32 dims at a time.
__global__ void __launch_bounds__(BK_TR * 8) brute_knn_transpose_kernel(
    const float* __restrict__ src, float* __restrict__ dst, float* __restrict__ norms,
    int R, int Rp, int d) {
  __shared__ float tile[BK_TR][BK_TR + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x * BK_TR;
  float acc = 0.0f;  // ‖row r0 + tx‖², summed by the threads with ty == 0
  for (int c0 = 0; c0 < d; c0 += BK_TR) {
    for (int m = ty; m < BK_TR; m += 8) {
      const int r = r0 + m, c = c0 + tx;
      tile[m][tx] = r < R && c < d ? src[(long long)r * d + c] : 0.0f;
    }
    __syncthreads();
    if (ty == 0) {
      const int cn = min(BK_TR, d - c0);
      for (int c = 0; c < cn; ++c) acc = __fadd_rn(acc, __fmul_rn(tile[tx][c], tile[tx][c]));
    }
    for (int m = ty; m < BK_TR; m += 8) {
      const int c = c0 + m, r = r0 + tx;
      if (c < d && r < Rp) dst[(long long)c * Rp + r] = tile[tx][m];
    }
    __syncthreads();
  }
  if (ty == 0 && r0 + tx < Rp) norms[r0 + tx] = acc;
}

// Issue the copies of stage t (tile t / nst, dims (t % nst)·BK_DS ..) of
// the transposed queries qt (d, Bp) and points xt (d, Np) into ring slot
// t % BK_STAGES, and with a tile's first stage its 128 norms.  Dims past d
// are not copied (a partial stage's products never read them); columns
// past the arrays are zero-filled.  One group per call.
__device__ __forceinline__ void issue_stage(Shared& sh, int t, int nst, const float* qt,
                                            const float* xt, const float* xnorm, int q0, int Bp,
                                            int n_begin, int Np, int d) {
  const int tile = t / nst;
  const int c0 = (t - tile * nst) * BK_DS;
  const int n0 = n_begin + tile * BK_BN;
  const int slot = t % BK_STAGES;
  const int dims = min(BK_DS, d - c0);
  for (int e = threadIdx.x; e < dims * (BK_BN / 4); e += BK_THREADS) {
    const int c = e / (BK_BN / 4), m = (e - c * (BK_BN / 4)) * 4;
    const bool okq = q0 + m < Bp, okx = n0 + m < Np;
    cp_async16(&sh.qs[slot][c][m], qt + (okq ? (long long)(c0 + c) * Bp + q0 + m : 0), okq);
    cp_async16(&sh.xs[slot][c][m], xt + (okx ? (long long)(c0 + c) * Np + n0 + m : 0), okx);
  }
  if (c0 == 0 && threadIdx.x < BK_BN / 4) {
    const int m = threadIdx.x * 4;
    const bool ok = n0 + m < Np;
    cp_async16(&sh.xx[tile % BK_STAGES][m], xnorm + (ok ? n0 + m : 0), ok);
  }
  cp_async_commit();
}

// 64 FMAs of one staged dim: a thread's 8 queries and 8 points at dim c
// are four 16-byte shared loads.
__device__ __forceinline__ void fma_dim(const Shared& sh, int slot, int c, int tx, int ty,
                                        float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(&sh.qs[slot][c][4 * ty]);
  const float4 a1 = *reinterpret_cast<const float4*>(&sh.qs[slot][c][64 + 4 * ty]);
  const float4 b0 = *reinterpret_cast<const float4*>(&sh.xs[slot][c][4 * tx]);
  const float4 b1 = *reinterpret_cast<const float4*>(&sh.xs[slot][c][64 + 4 * tx]);
  const float qv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float xv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(qv[i], xv[j], acc[i][j]);
}

// Merge every non-empty survivor buffer into its query's running list
// (row r at ld + r·stride: k entries ascending by (distance, index),
// padded with (+inf, INT_MAX); in shared or device memory), then lower the
// query's threshold and empty the buffer.  Warp w takes queries w, w + 8,
// ...; every thread of the block calls it, between barriers.
__device__ __forceinline__ void merge_buffers(Shared& sh, float* lists_d, int* lists_i,
                                              long long stride, int q0, int B, int k) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BK_BQ; r += BK_THREADS / 32) {
    const int c = min(sh.cnt[r], BK_BUF);
    if (c == 0 || q0 + r >= B) continue;  // warp-uniform
    float* ld = lists_d + r * stride;
    int* li = lists_i + r * stride;
    float v = INFINITY;
    int id = INT_MAX;
    if (lane < c) {
      const float s = sqrtf(sh.bufd[r][lane]);
      if (s < INFINITY) {  // +inf ranks as padding: never listed
        v = s;
        id = sh.bufi[r][lane];
      }
    }
    const bool valid = v < INFINITY;
    int rank = 0;  // survivors better than this one (ids are distinct)
    for (int j = 0; j < c; ++j) {
      const float ov = __shfl_sync(FULL_MASK, v, j);
      const int oid = __shfl_sync(FULL_MASK, id, j);
      rank += better(ov, oid, v, id);
    }
    int lo = k;  // list entries better than this one
    if (valid) {
      lo = 0;
      int hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(ld[mid], li[mid], v, id)) lo = mid + 1; else hi = mid;
      }
    }
    const int pos = rank + lo;
    const bool enters = valid && pos < k;
    const int first = __reduce_min_sync(FULL_MASK, enters ? lo : k);
    __syncwarp();
    if (first < k) {
      // list entries from `first` up move up by the survivors that beat
      // them; top chunk first, so no entry is overwritten before it is read
      for (int i0 = first + ((k - 1 - first) / 32) * 32; i0 >= first; i0 -= 32) {
        const int i = i0 + lane;
        float lv = INFINITY;
        int lid = INT_MAX;
        if (i < k) { lv = ld[i]; lid = li[i]; }
        int shift = 0;
        for (int j = 0; j < c; ++j) {
          const float ov = __shfl_sync(FULL_MASK, v, j);
          const int oid = __shfl_sync(FULL_MASK, id, j);
          shift += ov < INFINITY && better(ov, oid, lv, lid);
        }
        __syncwarp();
        if (i < k && shift > 0 && i + shift < k) { ld[i + shift] = lv; li[i + shift] = lid; }
        __syncwarp();
      }
      if (enters) { ld[pos] = v; li[pos] = id; }
      __syncwarp();
    }
    if (lane == 0) {
      sh.thr2[r] = sq_bound(ld[k - 1]);  // +inf while the list is not full
      sh.cnt[r] = 0;
    }
  }
}

__global__ void __launch_bounds__(BK_THREADS, 2) brute_knn_kernel(
    const float* __restrict__ qt,     // (d, Bp) queries, transposed
    const float* __restrict__ xt,     // (d, Np) points, transposed
    const float* __restrict__ qnorm,  // (Bp,) ‖q‖²
    const float* __restrict__ xnorm,  // (Np,) ‖x‖²
    float* __restrict__ part_d,       // (B, splits, k)
    int* __restrict__ part_i,         // (B, splits, k)
    int B, int Bp, int N, int Np, int d, int k, int splits, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char bk_smem[];
  Shared& sh = *reinterpret_cast<Shared*>(bk_smem);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BK_BQ;
  const int split = blockIdx.y;
  const long long span = (long long)tiles_per_split * BK_BN;
  const int n_begin = (int)min((long long)N, split * span);
  const int n_end = (int)min((long long)N, n_begin + span);

  const int nst = (d + BK_DS - 1) / BK_DS;  // stages per tile
  const int n_tiles = (n_end - n_begin + BK_BN - 1) / BK_BN;
  const int total = n_tiles * nst;
  for (int t = 0; t < BK_STAGES - 1; ++t) {
    if (t < total) issue_stage(sh, t, nst, qt, xt, xnorm, q0, Bp, n_begin, Np, d);
    else cp_async_commit();
  }

  // the running lists: in shared memory for small k, else in the scratch
  const bool smem_lists = k <= BK_SMEM_K;
  float* lists_d;
  int* lists_i;
  long long stride;
  if (smem_lists) {
    lists_d = reinterpret_cast<float*>(bk_smem + sizeof(Shared));
    lists_i = reinterpret_cast<int*>(lists_d + BK_BQ * k);
    stride = k;
  } else {
    lists_d = part_d + ((long long)q0 * splits + split) * k;
    lists_i = part_i + ((long long)q0 * splits + split) * k;
    stride = (long long)splits * k;
  }
  for (int e = tid; e < BK_BQ * k; e += BK_THREADS) {
    const int r = e / k;
    if (q0 + r < B) {
      lists_d[r * stride + (e - r * k)] = INFINITY;
      lists_i[r * stride + (e - r * k)] = INT_MAX;
    }
  }
  if (tid < BK_BQ) {
    sh.qq[tid] = q0 + tid < B ? qnorm[q0 + tid] : 0.0f;
    sh.thr2[tid] = q0 + tid < B ? INFINITY : -1.0f;  // d2 >= 0 or NaN: never <= -1
    sh.cnt[tid] = 0;
  }

  float acc[8][8];
  for (int t = 0; t < total; ++t) {
    const int tile = t / nst;
    const int c0 = (t - tile * nst) * BK_DS;
    const int n0 = n_begin + tile * BK_BN;
    const int slot = t % BK_STAGES;
    cp_async_wait_ring();  // this thread's copies of stage t have landed
    __syncthreads();       // everyone's have, and slot (t - 1) % BK_STAGES is free
    if (t + BK_STAGES - 1 < total)
      issue_stage(sh, t + BK_STAGES - 1, nst, qt, xt, xnorm, q0, Bp, n_begin, Np, d);
    else
      cp_async_commit();  // an empty group keeps the wait count in step
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    if (c0 + BK_DS <= d) {  // a full stage: no guard between dims
#pragma unroll
      for (int c = 0; c < BK_DS; ++c) fma_dim(sh, slot, c, tx, ty, acc);
    } else {
      for (int c = 0; c < d - c0; ++c) fma_dim(sh, slot, c, tx, ty, acc);
    }
    if (c0 + BK_DS < d) continue;  // the tile's products are not complete yet

    // the tile's distances, kept in acc; points past the range get a NaN
    // ‖x‖², which fails every test.  A row of 8 pairs whose smallest d2
    // fails its query's threshold is done (fminf skips a NaN); in the
    // others each pair that passes takes a slot of its query's buffer, or
    // stays pending when the buffer is full
    uint64_t pending = 0;
    unsigned rows = 0;
    float xxv[8];
    {
      const float4 xa = *reinterpret_cast<const float4*>(&sh.xx[tile % BK_STAGES][4 * tx]);
      const float4 xb = *reinterpret_cast<const float4*>(&sh.xx[tile % BK_STAGES][64 + 4 * tx]);
      const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xxv[j] = n0 + tile_row(tx, j) < n_end ? xv[j] : __int_as_float(0x7fc00000);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(ty, i);
      const float qqi = sh.qq[r];
      float mn = INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] = __fadd_rn(__fsub_rn(qqi, __fmul_rn(2.0f, acc[i][j])), xxv[j]);
        mn = fminf(mn, acc[i][j]);
      }
      if (mn <= sh.thr2[r]) rows |= 1u << i;
    }
    if (rows != 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!(rows & (1u << i))) continue;
        const int r = tile_row(ty, i);
        const float thi = sh.thr2[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (acc[i][j] <= thi) {  // a negative d2 passes and is clamped
            acc[i][j] = acc[i][j] < 0.0f ? 0.0f : acc[i][j];
            const int slot_ = atomicAdd(&sh.cnt[r], 1);
            if (slot_ < BK_BUF) {
              sh.bufd[r][slot_] = acc[i][j];
              sh.bufi[r][slot_] = n0 + tile_row(tx, j);
            } else {
              pending |= 1ull << (8 * i + j);
            }
          }
        }
      }
    }
    // while a full buffer turned a pair away: merge, then test the pending
    // pairs again against the lowered thresholds
    while (__syncthreads_or(pending != 0)) {
      merge_buffers(sh, lists_d, lists_i, stride, q0, B, k);
      __syncthreads();
      if (pending != 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = tile_row(ty, i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint64_t bit = 1ull << (8 * i + j);
            if (pending & bit) {
              if (acc[i][j] <= sh.thr2[r]) {
                const int slot_ = atomicAdd(&sh.cnt[r], 1);
                if (slot_ < BK_BUF) {
                  sh.bufd[r][slot_] = acc[i][j];
                  sh.bufi[r][slot_] = n0 + tile_row(tx, j);
                  pending &= ~bit;
                }
              } else {
                pending &= ~bit;
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();
  merge_buffers(sh, lists_d, lists_i, stride, q0, B, k);
  if (smem_lists) {
    __syncthreads();
    for (int e = tid; e < BK_BQ * k; e += BK_THREADS) {
      const int r = e / k;
      if (q0 + r < B) {
        const long long o = ((long long)(q0 + r) * splits + split) * k + (e - r * k);
        part_d[o] = lists_d[e];
        part_i[o] = lists_i[e];
      }
    }
  }
}

// One block per query: the `splits` sorted partial lists into the final k.
// Each finite entry's rank is its index in its own list plus, for every
// other list, the number of entries there that beat it (ids are distinct,
// so ranks are too); empty slots give +inf / -1.  The lists are staged in
// shared memory when they fit (smem != 0).
__global__ void __launch_bounds__(BK_MERGE_THREADS) brute_knn_merge_kernel(
    const float* __restrict__ part_d, const int* __restrict__ part_i,
    float* __restrict__ out_d, int* __restrict__ out_i, int B, int splits, int k,
    int smem) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ int n_finite;
  const int qi = blockIdx.x;
  const int total = splits * k;
  const float* pd = part_d + (long long)qi * total;
  const int* pi = part_i + (long long)qi * total;
  if (smem) {
    float* sd = reinterpret_cast<float*>(merge_smem);
    int* si = reinterpret_cast<int*>(sd + total);
    for (int e = threadIdx.x; e < total; e += blockDim.x) { sd[e] = pd[e]; si[e] = pi[e]; }
    pd = sd;
    pi = si;
  }
  if (threadIdx.x == 0) n_finite = 0;
  __syncthreads();
  int mine = 0;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const float v = pd[e];
    if (!(v < INFINITY)) continue;
    const int id = pi[e];
    const int s = e / k;
    int rank = e - s * k;
    for (int s2 = 0; s2 < splits; ++s2) {
      if (s2 == s) continue;
      const float* ld = pd + s2 * k;
      const int* li = pi + s2 * k;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(ld[mid], li[mid], v, id)) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    ++mine;
    if (rank < k) {
      out_d[(long long)qi * k + rank] = v;
      out_i[(long long)qi * k + rank] = id;
    }
  }
  atomicAdd(&n_finite, mine);
  __syncthreads();
  for (int p = n_finite + threadIdx.x; p < k; p += blockDim.x) {
    out_d[(long long)qi * k + p] = INFINITY;
    out_i[(long long)qi * k + p] = -1;
  }
}

// Rows padded to a multiple of 4, so every transposed row starts on a
// 16-byte boundary.
static inline int bk_padded(int r) { return (r + 3) / 4 * 4; }

extern "C" int brute_knn_launch(
    const void* q, const void* x, void* qt, void* xt, void* qnorm, void* xnorm, void* part_d,
    void* part_i, void* out_d, void* out_i, int B, int N, int d, int k, int splits,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int Bp = bk_padded(B), Np = bk_padded(N);
  const dim3 tb(BK_TR, 8);
  brute_knn_transpose_kernel<<<(Bp + BK_TR - 1) / BK_TR, tb, 0, s>>>(
      (const float*)q, (float*)qt, (float*)qnorm, B, Bp, d);
  if (Np > 0)  // no points: the main kernel visits no tile and every slot pads
    brute_knn_transpose_kernel<<<(Np + BK_TR - 1) / BK_TR, tb, 0, s>>>(
        (const float*)x, (float*)xt, (float*)xnorm, N, Np, d);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  const int tiles = (N + BK_BN - 1) / BK_BN;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const dim3 grid((B + BK_BQ - 1) / BK_BQ, splits);
  const size_t smem = bk_shared_bytes(k);
  e = allow_shared_bytes(brute_knn_kernel, smem);
  if (e != 0) return e;
  brute_knn_kernel<<<grid, BK_THREADS, smem, s>>>(
      (const float*)qt, (const float*)xt, (const float*)qnorm, (const float*)xnorm,
      (float*)part_d, (int*)part_i, B, Bp, N, Np, d, k, splits, tiles_per_split);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  const size_t lists = (size_t)splits * k * 8;
  const int staged = lists <= 48 * 1024;
  brute_knn_merge_kernel<<<B, BK_MERGE_THREADS, staged ? lists : 0, s>>>(
      (const float*)part_d, (const int*)part_i, (float*)out_d, (int*)out_i, B, splits, k,
      staged);
  return (int)cudaGetLastError();
}
