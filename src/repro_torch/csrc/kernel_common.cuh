// Device code shared by the port's kernels (included by the .cu sources).
//
// One definition each of the three pieces whose rounding must agree
// between kernels: the chunked l1/l2 row distance (csr_candidate_topk,
// candidate_topk), the circle mask of a pyramid cell (tile_count,
// tile_count_multilevel) and the block arg-min top-k (every candidate
// kernel).  Two kernels that rank the same row therefore produce the same
// float, which the reference's "shortlist containment => bit parity"
// contract and hopper_gather == hopper rest on.
//
// Numerics: the sources are built with -fmad=false, and every product and
// sum here is written with __fmul_rn / __fadd_rn / __fsub_rn, so no FMA
// changes a rounding; sqrtf is IEEE (no fast math).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define TOPK_THREADS 256
#define TOPK_WARPS (TOPK_THREADS / 32)

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
    for (int c = c0; c < c1; ++c) {
      float v = x[c];
      if (center_cells) v = __fadd_rn(floorf(v), 0.5f);
      const float df = __fsub_rn(v, qs[c]);
      part = metric_l1 ? __fadd_rn(part, fabsf(df))
                       : __fadd_rn(part, __fmul_rn(df, df));
    }
    acc = c0 == 0 ? part : __fadd_rn(acc, part);
  }
  return metric_l1 ? acc : sqrtf(fmaxf(acc, 0.0f));
}

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

__device__ __forceinline__ bool better(float v, int s, float bv, int bs) {
  return v < bv || (v == bv && s < bs);
}

// k rounds of a block arg-min over dist[0, slots) in shared memory: round
// r writes the smallest remaining (value, slot) pair, smaller slot first on
// ties, to out_d[r] and out_i[r] (gidx[slot], or the slot itself when gidx
// is null; -1 once only +inf is left), then retires the slot.  k may
// exceed slots.  Every thread of a TOPK_THREADS block calls it.
__device__ __forceinline__ void block_topk(float* dist, const int* gidx,
                                           int slots, int k, float* out_d,
                                           int* out_i) {
  __shared__ float warp_v[TOPK_WARPS];
  __shared__ int warp_s[TOPK_WARPS];
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
      bv = lane < TOPK_WARPS ? warp_v[lane] : INFINITY;
      bs = lane < TOPK_WARPS ? warp_s[lane] : slots;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, o);
        const int os = __shfl_down_sync(0xffffffffu, bs, o);
        if (better(ov, os, bv, bs)) { bv = ov; bs = os; }
      }
      if (lane == 0) {
        out_d[round] = bv;
        out_i[round] = isfinite(bv) ? (gidx != nullptr ? gidx[bs] : bs) : -1;
        if (bs < slots) dist[bs] = INFINITY;
      }
    }
    __syncthreads();
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
