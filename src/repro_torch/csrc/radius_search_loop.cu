// The whole Eq.-1 radius loop on Hopper (sm_90a), one launch per batch.
//
// Replaces the TPU kernel repro/kernels/tile_count_multilevel.py::
// tile_count_multilevel together with the lax.while_loop that calls it once
// per iteration (repro/core/batched.py::radius_search_batched).  For each
// query b it runs Eq. 1 from its start radius r0[b]: count the circle at
// the level of the current radius (pyramid.level_for_radius), stop when
// k <= n <= k_hi or after max_iters counts, else move the radius by
// round(r * sqrt(k / max(n, 1))) (doubling at n == 0, +-1 when it would not
// move), clamped to [1, r_max].  A lane that did not converge counts once
// more at its final radius (its smallest radius that saw >= k, else r_max).
// Outputs radius, count, iters and converged (B,), equal lane for lane to
// the plain version repro_torch/kernels/ref.py::radius_search_loop, the
// lock-step loop of the whole batch.
//
// What bounds it on this card: latency.  A pass reads T*T*C int32 of one
// window (3 KB at T=16, C=3) and does about ten float operations per cell;
// every pass waits for the previous one's count, so a lane's time is its
// passes times one round of dependent loads, and the whole batch's
// distinct bytes move in microseconds.
//
// Design: one warp per query, WARPS queries per block.  Lanes never
// interact (a lane's trajectory depends only on its query, its radius and
// the pyramid), so each warp iterates on its own and leaves as soon as its
// lane is done: no lock-step passes, no parked lanes, no host round trip
// per pass.  A chunk of the main path (2048-4096 queries) is resident on
// the card at once, so a warp that finishes early holds up no other, and
// the launch takes as long as its longest lane.  The tile side of the
// configurations, 16, has its own instance, in which the window's
// divisions by T are shifts; other sides take the generic one.  The warp's 32 threads stride over the window's cells (8 each
// at T = 16), sum every channel of the cells inside the circle in int32
// (the loop uses only the total), and an xor-shuffle reduction gives every
// thread the same n, so each thread applies the same scalar update to its
// own copy of (r, t, done, best, n_hit): no broadcast, no barrier.  The
// window (level clamp, origin, tile address, mask) is kernel_common.cuh's
// level_window / window_cell, shared with tile_count_multilevel.cu.
//
// Numerics: int32 sums are exact in any order.  The update rounds as
// pyramid.eq1_ratio and torch.round do: IEEE division and square root
// (__fdiv_rn, __fsqrt_rn), one rounded product, then rintf, which rounds
// half to even as torch.round and jnp.round do (roundf would round half
// away).  Built with -fmad=false, as every source.

#include "kernel_common.cuh"

#define WARPS 4  // queries per block, one warp each

// pyramid.level_for_radius in integers: the smallest level l with
// (T - 3) * 2^l >= 2r, at most L - 1.
__device__ __forceinline__ int level_for_radius(int r, int T, int L) {
  const long long two_r = 2LL * r;
  int lv = 0;
  for (int j = 0; j < L - 1; ++j) lv += ((long long)(T - 3) << j) < two_r;
  return lv;
}

// The circle's total count over every channel at radius r, at r's level;
// the same value in every thread of the warp.
__device__ __forceinline__ int window_total(const int* __restrict__ tiles, int r, float qx,
                                            float qy, int T, int C, int L, int metric_l1) {
  const LevelWindow w = level_window(level_for_radius(r, T, L), L, T, qx, qy);
  const float rf = (float)r;
  int n = 0;
  for (int cell = threadIdx.x & 31; cell < T * T; cell += 32) {
    long long base;
    if (window_cell(w, cell, T, C, qx, qy, rf, metric_l1, &base))
      for (int c = 0; c < C; ++c) n += tiles[base + c];
  }
  for (int s = 16; s > 0; s >>= 1) n += __shfl_xor_sync(0xffffffffu, n, s);
  return n;
}

// TT: the tile side when it is known at compile time (16, the configs'
// side: the window's divisions by T become shifts), else 0 and T_arg.
template <int TT>
__global__ void radius_search_loop_kernel(
    const int* __restrict__ tiles,  // (sum_l nblk_l^2, T, T, C)
    const float* __restrict__ q,    // (B, 2)
    const int* __restrict__ r0,     // (B,)
    int* __restrict__ radius, int* __restrict__ count, int* __restrict__ iters,
    unsigned char* __restrict__ converged,  // (B,) each
    int B, int T_arg, int C, int L, int k, int k_hi, int r_max, int max_iters, int metric_l1) {
  const int T = TT ? TT : T_arg;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: b is the warp's
  const float qx = q[2 * b], qy = q[2 * b + 1];
  int r = r0[b], t = 0, best = r_max + 1, n_hit = 0;
  bool done = false;
  while (t < max_iters && !done) {
    const int n = window_total(tiles, r, qx, qy, T, C, L, metric_l1);
    const bool hit = n >= k && n <= k_hi;
    if (n >= k) best = min(best, r);
    const float ratio = __fsqrt_rn(__fdiv_rn((float)k, (float)max(n, 1)));
    int r_new = (int)rintf(__fmul_rn((float)r, ratio));
    if (n == 0) r_new = 2 * r;
    r_new = min(max(r_new, 1), r_max);
    if (r_new == r && !hit) r_new = r + (n < k ? 1 : -1);
    if (!hit) r = min(max(r_new, 1), r_max);
    ++t;
    if (hit) n_hit = n;  // the count at the final radius: no recount
    done = hit;
  }
  const int r_final = done ? r : (best <= r_max ? best : r_max);
  const int n_final = done ? n_hit : window_total(tiles, r_final, qx, qy, T, C, L, metric_l1);
  if ((threadIdx.x & 31) == 0) {
    radius[b] = r_final;
    count[b] = n_final;
    iters[b] = t;
    converged[b] = done;
  }
}

extern "C" int radius_search_loop_launch(
    const void* tiles, const void* q, const void* r0, void* radius, void* count, void* iters,
    void* converged, int B, int T, int C, int L, int k, int k_hi, int r_max, int max_iters,
    int metric_l1, void* stream) {
  const int blocks = (B + WARPS - 1) / WARPS;
  auto kernel = T == 16 ? radius_search_loop_kernel<16> : radius_search_loop_kernel<0>;
  kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const int*)tiles, (const float*)q, (const int*)r0, (int*)radius, (int*)count,
      (int*)iters, (unsigned char*)converged, B, T, C, L, k, k_hi, r_max, max_iters,
      metric_l1);
  return (int)cudaGetLastError();
}
