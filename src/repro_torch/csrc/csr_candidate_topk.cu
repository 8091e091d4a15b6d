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
// What bounds it on this card: bytes.  A query reads d floats for each valid
// slot from the CSR store, which stays in device memory, and does three
// float operations per value read.
//
// Design: one block per query.  The query vector is staged in shared memory.
// One thread per slot (threads stride over the w*row_cap slots) computes the
// slot's distance; loads of invalid slots are skipped, but every slot writes
// its (distance or +inf, global row) pair to shared arrays of w*row_cap
// entries each.  Then k rounds of a block arg-min on (value, slot) pick the
// result; the chosen slot is set to +inf for the next round.  Nothing of size
// (B, w*row_cap) reaches device memory.  At w*row_cap = 8192 the shared arrays
// take 64 KB, above the 48 KB default, so the launcher raises the block's
// dynamic shared-memory limit; the wrapper refuses shapes above 227 KB.
// A thread reads its slot's row alone, so a warp's loads are strided by d;
// coalescing them is later work.
//
// Numerics: built with -fmad=false, and the l2 sum is written with
// __fmul_rn / __fadd_rn, so no FMA changes a rounding; sqrtf is IEEE
// (no fast math).

#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define WARPS (THREADS / 32)

__device__ __forceinline__ bool better(float v, int s, float bv, int bs) {
  return v < bv || (v == bv && s < bs);
}

__global__ void csr_candidate_topk_kernel(
    const float* __restrict__ store,    // (n_pad, d)
    const int* __restrict__ starts,     // (B, w)
    const int* __restrict__ ends,       // (B, w)
    const float* __restrict__ queries,  // (B, d)
    const float* __restrict__ radii,    // (B,) or nullptr
    float* __restrict__ out_d,          // (B, k)
    int* __restrict__ out_i,            // (B, k)
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells) {
  extern __shared__ float smem[];
  const int slots = w * row_cap;
  float* qs = smem;                       // d
  float* dist = qs + d;                   // slots
  int* gidx = (int*)(dist + slots);       // slots
  __shared__ float warp_v[WARPS];
  __shared__ int warp_s[WARPS];

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  __syncthreads();

  const int s_max = max(n_pad - row_cap, 0);
  const float r = radii != nullptr ? radii[b] : 0.0f;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int row = s / row_cap;
    const int st = starts[b * w + row];
    const int en = ends[b * w + row];
    const int j = min(max(st, 0), s_max) + (s - row * row_cap);
    float dv = INFINITY;
    if (j >= st && j < en && j < n) {
      const float* x = store + (long long)j * d;
      float acc = 0.0f;
      for (int c0 = 0; c0 < d; c0 += d_chunk) {
        const int c1 = min(c0 + d_chunk, d);
        float part = 0.0f;
        for (int c = c0; c < c1; ++c) {
          float v = x[c];
          if (center_cells) v = __fadd_rn(floorf(v), 0.5f);
          const float df = __fsub_rn(v, qs[c]);
          part = metric_l1 ? __fadd_rn(part, fabsf(df))
                           : __fadd_rn(part, __fmul_rn(df, df));
        }
        acc = c0 == 0 ? part : __fadd_rn(acc, part);
      }
      const float dd = metric_l1 ? acc : sqrtf(fmaxf(acc, 0.0f));
      if (radii == nullptr || dd <= r) dv = dd;
    }
    dist[s] = dv;
    gidx[s] = j;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int round = 0; round < k; ++round) {
    float bv = INFINITY;
    int bs = slots;  // past every slot: any slot beats it, ties included
    for (int s = threadIdx.x; s < slots; s += blockDim.x) {
      if (better(dist[s], s, bv, bs)) { bv = dist[s]; bs = s; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int os = __shfl_down_sync(0xffffffffu, bs, o);
      if (better(ov, os, bv, bs)) { bv = ov; bs = os; }
    }
    if (lane == 0) { warp_v[warp] = bv; warp_s[warp] = bs; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < WARPS ? warp_v[lane] : INFINITY;
      bs = lane < WARPS ? warp_s[lane] : slots;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, o);
        const int os = __shfl_down_sync(0xffffffffu, bs, o);
        if (better(ov, os, bv, bs)) { bv = ov; bs = os; }
      }
      if (lane == 0) {
        const long long o = (long long)b * k + round;
        out_d[o] = bv;
        out_i[o] = isfinite(bv) ? gidx[bs] : -1;
        if (bs < slots) dist[bs] = INFINITY;
      }
    }
    __syncthreads();
  }
}

extern "C" int csr_candidate_topk_launch(
    const void* store, const void* starts, const void* ends,
    const void* queries, const void* radii, void* out_d, void* out_i, int B,
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells, void* stream) {
  const size_t smem = (size_t)d * sizeof(float) + (size_t)w * row_cap * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_candidate_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  csr_candidate_topk_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)store, (const int*)starts, (const int*)ends,
      (const float*)queries, (const float*)radii, (float*)out_d, (int*)out_i,
      w, row_cap, d, n_pad, n, k, d_chunk, metric_l1, center_cells);
  return (int)cudaGetLastError();
}
