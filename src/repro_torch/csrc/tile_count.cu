// Circle count from one pyramid level on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tile_count.py::tile_count, which the
// hopper_stacked backend's count_at launches once per pyramid level.  For
// each query b it sums each class channel over the cells (x, y) of the
// level's clamped window [ox, ox+T) x [oy, oy+T) whose centers
// ((x+0.5)*scale, (y+0.5)*scale) lie inside the l1/l2 circle of radius
// r[b] around q[b], with scale = 2^level and (ox, oy) the window around the
// query's level cell, clamped into [0, S - T].  Output (B, C) int32, equal
// to the plain version repro_torch/kernels/ref.py::tile_count.
//
// What bounds it on this card: bytes.  A query reads T*T*C int32 of the
// level (3 KB at T=16, C=3) and does about ten float operations per cell;
// at the path's batch sizes the launch itself is a large share.
//
// Design: radius_search_loop.cu's layout, for one pass.  One warp per
// query, WARPS queries per block: a query's window is 256 cells at T = 16,
// eight per lane, where a block per query left most of its threads idle
// and paid two barriers and a shared-memory atomic per channel pass.  The
// warp's 32 lanes stride over the window's cells (neighbouring lanes on
// neighbouring cells of a window row, so a warp's loads fall in a few
// lines).  One channel at a time, each lane sums its in-circle cells in
// int32, an xor-shuffle reduction gives every lane the total, and lane c
// (mod 32) writes channel c, so any channel count fits; no shared memory,
// no atomics, no barriers.  The tile side of the configurations, 16, has
// its own instance, in which the cell loop has a fixed trip count (8) and
// the divisions by T are shifts, so the loop unrolls and a lane's 8 loads
// of a channel are in flight together: a cold window costs one round of
// dependent loads rather than eight (on an H100 at chip_smoke.py phase 2's
// first pass: 0.0043 ms, against 0.0088 ms with one load in flight per lane
// and 0.0120 ms for a block per query).  Other sides take the generic
// instance.  The TPU kernel's 2x2 cover of T-aligned tiles with duplicate
// blanking has no counterpart: the warp reads the window itself.  The mask
// is kernel_common.cuh's cell_in_circle, shared with
// tile_count_multilevel.cu and radius_search_loop.cu (built with
// -fmad=false, so a boundary cell rounds as the reference rounds it); int32
// sums are exact in any order.

#include "kernel_common.cuh"

#define WARPS 4  // queries per block, one warp each

// TT: the tile side when it is known at compile time (16), else 0 and T_arg.
template <int TT>
__global__ void tile_count_kernel(
    const int* __restrict__ level,   // (S, S, C)
    const float* __restrict__ q,     // (B, 2)
    const float* __restrict__ radii, // (B,)
    int* __restrict__ out,           // (B, C)
    int B, int S, int T_arg, int C, int scale, int metric_l1) {
  const int T = TT ? TT : T_arg;
  const int per_lane = (T * T + 31) / 32;  // cells per lane
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: b is the warp's
  const int lane = threadIdx.x & 31;
  const float sc = (float)scale;
  const float qx = q[2 * b], qy = q[2 * b + 1];
  const float r = radii[b];
  const int ox = min(max((int)floorf(qx / sc) - T / 2, 0), S - T);
  const int oy = min(max((int)floorf(qy / sc) - T / 2, 0), S - T);

  for (int c = 0; c < C; ++c) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < per_lane; ++i) {
      const int cell = lane + 32 * i;
      const int x = ox + cell / T, y = oy + cell % T;
      if (cell < T * T && cell_in_circle(x, y, sc, qx, qy, r, metric_l1))
        n += level[((long long)x * S + y) * C + c];
    }
    for (int s = 16; s > 0; s >>= 1) n += __shfl_xor_sync(0xffffffffu, n, s);
    if (lane == (c & 31)) out[(long long)b * C + c] = n;
  }
}

extern "C" int tile_count_launch(const void* level, const void* q,
                                 const void* radii, void* out, int B, int S,
                                 int T, int C, int scale, int metric_l1,
                                 void* stream) {
  const int blocks = (B + WARPS - 1) / WARPS;
  auto kernel = T == 16 ? tile_count_kernel<16> : tile_count_kernel<0>;
  kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const int*)level, (const float*)q, (const float*)radii, (int*)out, B, S,
      T, C, scale, metric_l1);
  return (int)cudaGetLastError();
}
