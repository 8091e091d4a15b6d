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
// Design: tile_count_multilevel.cu's, at one level.  One block per query,
// one thread per window cell (threads stride when T*T exceeds the block);
// neighbouring threads read neighbouring cells of a window row, and
// per-channel int32 sums reduce exactly (warp shuffles, then shared-memory
// atomics), 32 channels at a time, so any channel count fits one fixed
// shared array.  The TPU kernel's 2x2 cover of T-aligned tiles with duplicate
// blanking has no counterpart: the block reads the window itself.  The mask
// is kernel_common.cuh's cell_in_circle, shared with
// tile_count_multilevel.cu (built with -fmad=false, so a boundary cell
// rounds as the reference rounds it).

#include "kernel_common.cuh"

#define CHUNK_C 32  // channels reduced per pass over the window
#define THREADS 256

__global__ void tile_count_kernel(
    const int* __restrict__ level,   // (S, S, C)
    const float* __restrict__ q,     // (B, 2)
    const float* __restrict__ radii, // (B,)
    int* __restrict__ out,           // (B, C)
    int S, int T, int C, int scale, int metric_l1) {
  __shared__ int red[CHUNK_C];

  const int b = blockIdx.x;
  const float sc = (float)scale;
  const float qx = q[2 * b], qy = q[2 * b + 1];
  const float r = radii[b];
  const int ox = min(max((int)floorf(qx / sc) - T / 2, 0), S - T);
  const int oy = min(max((int)floorf(qy / sc) - T / 2, 0), S - T);

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
        const int x = ox + cell / T;
        const int y = oy + cell % T;
        inside = cell_in_circle(x, y, sc, qx, qy, r, metric_l1);
        base = ((long long)x * S + y) * C + c0;
      }
      for (int c = 0; c < cn; ++c) {
        int v = inside ? level[base + c] : 0;
        for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
        if (lane == 0 && v != 0) atomicAdd(&red[c], v);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cn; c += blockDim.x) out[(long long)b * C + c0 + c] = red[c];
    __syncthreads();  // red is zeroed again for the next chunk
  }
}

extern "C" int tile_count_launch(const void* level, const void* q,
                                 const void* radii, void* out, int B, int S,
                                 int T, int C, int scale, int metric_l1,
                                 void* stream) {
  tile_count_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)level, (const float*)q, (const float*)radii, (int*)out, S,
      T, C, scale, metric_l1);
  return (int)cudaGetLastError();
}
