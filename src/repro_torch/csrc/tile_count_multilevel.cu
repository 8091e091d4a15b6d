// Level-scheduled circle count on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tile_count_multilevel.py::
// tile_count_multilevel (its body _kernel inlines repro/kernels/tile_count.py::
// circle_window_sum).  For each query b, at its own pyramid level
// l = levels[b], it sums each class channel over the level cells (x, y) of the
// clamped window [ox, ox+T) x [oy, oy+T) whose centers ((x+0.5)*2^l,
// (y+0.5)*2^l) lie inside the l1/l2 circle of radius r[b] around q[b].  Lanes
// with active[b] == 0 write zeros.  Output (B, C) int32, equal to the plain
// version repro_torch/kernels/ref.py::tile_count_multilevel.
//
// What bounds it on this card: bytes.  A live lane reads T*T*C int32 of the
// flattened pyramid (3 KB at T=16, C=3) at a data-dependent address and does
// about ten float operations per cell, far below the compute rate; at count_at's
// batch sizes the launch itself is a large share.
//
// Design: one block per query, one thread per window cell (threads stride
// when T*T exceeds the block).  Each thread reads its cell once, straight
// from the tile layout (tile off_l + (x/T)*nblk_l + (y/T), in-tile
// (x%T, y%T)); neighbouring threads read neighbouring in-tile cells, so a
// warp's loads fall in a few cache lines.  This reads exactly the window
// cells that the TPU kernel's 2x2 tile cover plus duplicate guard keep.  The
// TPU's lane compaction and tile aliasing (DMA elision by block revisiting)
// have no counterpart: a parked block writes zeros and returns.  Per-channel
// int32 sums reduce exactly (integer adds commute): warp shuffles, then
// shared-memory atomics, 32 channels at a time, so any channel count fits
// one fixed shared array.
//
// The window (level clamp, origin, tile address and mask) is
// kernel_common.cuh's level_window / window_cell, shared with
// radius_search_loop.cu, which runs this count inside the whole Eq.-1 loop;
// this one-pass kernel serves count_at and classify's counts.
//
// Numerics: the mask is kernel_common.cuh's cell_in_circle (shared with
// tile_count.cu), written with __fmul_rn / __fadd_rn and built with
// -fmad=false, so (ci-qx)^2 + (cj-qy)^2 rounds as the reference rounds it;
// an FMA there would move boundary cells, and a count that moves is a
// wrong integer.

#include "kernel_common.cuh"

#define CHUNK_C 32  // channels reduced per pass over the window
#define THREADS 256

__global__ void tile_count_multilevel_kernel(
    const int* __restrict__ tiles,            // (sum_l nblk_l^2, T, T, C)
    const float* __restrict__ q,              // (B, 2)
    const float* __restrict__ radii,          // (B,)
    const int* __restrict__ levels,           // (B,)
    const unsigned char* __restrict__ active, // (B,) or nullptr
    int* __restrict__ out,                    // (B, C)
    int T, int C, int L, int metric_l1) {
  const int b = blockIdx.x;
  if (active != nullptr && active[b] == 0) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) out[(long long)b * C + c] = 0;
    return;
  }
  __shared__ int red[CHUNK_C];

  const float qx = q[2 * b], qy = q[2 * b + 1];
  const float r = radii[b];
  const LevelWindow w = level_window(levels[b], L, T, qx, qy);

  const int lane = threadIdx.x & 31;
  const int cells = T * T;
  for (int c0 = 0; c0 < C; c0 += CHUNK_C) {
    const int cn = min(CHUNK_C, C - c0);
    for (int c = threadIdx.x; c < cn; c += blockDim.x) red[c] = 0;
    __syncthreads();
    for (int cell0 = 0; cell0 < cells; cell0 += blockDim.x) {
      const int cell = cell0 + threadIdx.x;
      bool inside = false;
      long long base = 0;
      if (cell < cells) {
        inside = window_cell(w, cell, T, C, qx, qy, r, metric_l1, &base);
        base += c0;
      }
      for (int c = 0; c < cn; ++c) {
        int v = inside ? tiles[base + c] : 0;
        for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
        if (lane == 0 && v != 0) atomicAdd(&red[c], v);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cn; c += blockDim.x) out[(long long)b * C + c0 + c] = red[c];
    __syncthreads();  // red is zeroed again for the next chunk
  }
}

extern "C" int tile_count_multilevel_launch(
    const void* tiles, const void* q, const void* radii, const void* levels,
    const void* active, void* out, int B, int T, int C, int L, int metric_l1,
    void* stream) {
  tile_count_multilevel_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)tiles, (const float*)q, (const float*)radii,
      (const int*)levels, (const unsigned char*)active, (int*)out, T, C, L,
      metric_l1);
  return (int)cudaGetLastError();
}
