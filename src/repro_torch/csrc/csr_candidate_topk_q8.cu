// int8 CSR candidate scoring -> top-rerank_k shortlist on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_candidate_topk_q8.py::
// csr_shortlist_q8, the coarse half of the quantized candidate path
// (hopper_q8).  For each query b it walks the w window rows exactly as
// csr_candidate_topk.cu does (row i covers the row_cap store rows from the
// span start clamped to [0, n_pad - row_cap]; a slot is valid when its row
// j lies in [starts[b,i], ends[b,i]) and below the live count n), but reads
// the int8 store (core/quantized.py) and each row's float scale s:
//
//   qs   = clamp(rint(q[c] / s), -QCLIP, QCLIP)        (round half to even)
//   diff = code[j, c] - qs                             int32
//   l2:  acc = sum over chunks, in order, of float(sum_chunk diff^2)
//        score = s * sqrt(acc)
//   l1:  score = s * float(sum over all c of |diff|)   (int32 total)
//
// summed in int32 within each chunk of at most Q8_MAX_CHUNK = 512 dims (no
// overflow: 512 * (1023 + 127)^2 < 2^31).  The best rerank_k (score, slot)
// pairs, smaller slot first on ties, come out as scores and GLOBAL CSR
// rows, +inf / -1 where fewer slots are valid.  Integer scoring is exact,
// so the result equals the plain version repro_torch/kernels/ref.py::
// csr_shortlist_q8 bit for bit.  Numerics: the division is __fdiv_rn
// (IEEE, as the plain version's tensor division), rintf rounds half to
// even (roundf would round half away from zero), built with -fmad=false
// and no fast math.
//
// What bounds it on this card: bytes.  A query reads d + 4 bytes for each
// valid slot (its int8 row and its scale) instead of 4*d, and does about
// three integer operations per byte read (subtract, multiply, add).
// Counted over distinct rows the bound assumes queries share rows in L2;
// counted per (query, row) pair ("gathered" bytes) it is the floor when
// they share nothing.
//
// Design: one block of 256 threads per query.  A group of G lanes (a power
// of two, G <= 32) scores one window slot's row at a time: each lane loads
// one unit of V contiguous bytes of the row (16, one int4, when d is a
// multiple of 16 and at most 512; else, up to d = 128, 4: one 32-bit word,
// or 4 single bytes when rows are not 4-byte aligned), so neighbouring
// lanes read neighbouring addresses; at d = 128 eight lanes take a row and
// a warp four rows.  The window's slots go in chunks of 4096, the middle chunk first
// (a window is centred on its query, so the nearest come first); within a
// chunk each group scores a run of consecutive slots, so it walks
// consecutive store rows, writing each score (+inf where the slot is not
// valid) to a shared array with no barrier between rows.  The lanes keep
// the query's codes for their dims in registers and recompute them
// (__fdiv_rn, rintf, clamp to +-QCLIP) only when the row's scale differs
// bitwise from the group's previous row's: scales are per cell, broadcast
// over the cell's rows, so consecutive rows often share one, and the same
// scale gives the same codes.  Each chunk's int32 sum is reduced across
// the group by shuffles (integer addition is exact in any order), and the
// float part is as the plain version's: chunk sums added as floats in
// chunk order, then s * sqrtf(acc) (l2) or s * float(total) (l1).  Then
// the chunk's scores go to kernel_common.cuh's filter-then-merge top-k.
// Any other d (past 128 and not a multiple of 16, or past 512) takes a
// generic variant: one row per warp, a byte per lane, each code computed
// where it is used.  Shared memory: the query
// (4*d bytes), the chunk's scores (16 KB) and the top-k's buffer and list
// (5,136 bytes), whatever w*row_cap.

#include <stdint.h>

#include "kernel_common.cuh"

#define QCLIP 1023
#define Q8_FAST_D 512  // widest row the register variants take

__device__ __forceinline__ int query_code(float q, float s) {
  const float v = rintf(__fdiv_rn(q, s));
  return (int)fminf(fmaxf(v, -(float)QCLIP), (float)QCLIP);
}

// Signed byte e of a little-endian word.
__device__ __forceinline__ int sbyte(int w, int e) { return (w << (24 - 8 * e)) >> 24; }

// Sum of v over the G lanes of this lane's group (mask: the group's lanes).
__device__ __forceinline__ int group_sum(int v, int G, unsigned mask) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// V = 16 or 4: one unit of V bytes per lane, G lanes per row, the codes in
// registers; words: rows are 4-byte aligned (V == 4 reads a word, else
// single bytes).  V = 1: the generic variant, one row per warp, a byte per
// lane, codes not kept.
template <int V>
__global__ void __launch_bounds__(TOPK_THREADS, V == 16 ? 4 : 1) csr_shortlist_q8_kernel(
    const signed char* __restrict__ store,  // (n_pad, d) int8
    const float* __restrict__ scales,       // (n_pad, 1)
    const int* __restrict__ starts,         // (B, w)
    const int* __restrict__ ends,           // (B, w)
    const float* __restrict__ queries,      // (B, d)
    float* __restrict__ out_d,              // (B, rerank_k)
    int* __restrict__ out_i,                // (B, rerank_k)
    int w, int row_cap, int d, int n_pad, int n, int rerank_k, int d_chunk,
    int metric_l1, int G, int words) {
  extern __shared__ float qs[];  // d
  __shared__ TopkShared top;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int c = tid; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  float* od = out_d + (long long)b * rerank_k;
  int* oi = out_i + (long long)b * rerank_k;
  const TopkList list = topk_init(top, od, oi, rerank_k);
  __syncthreads();

  const int gl = lane & (G - 1);        // lane within the group
  const int gid = tid / G;              // group within the block
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  const int slots = w * row_cap;
  const int s_max = max(n_pad - row_cap, 0);
  const int* st_b = starts + (long long)b * w;
  const int* en_b = ends + (long long)b * w;
  const int nch = (d + d_chunk - 1) / d_chunk;
  const bool one_sum = metric_l1 || nch == 1;  // one int32 sum per row

  int code[V];  // the query's codes at the group's current scale
  int cur_scale = 0;
  bool have_codes = false;
  // chunks of TOPK_CHUNK slots, centred on the window's middle; in each, every
  // group scores TOPK_CHUNK / (256 / G) consecutive slots (consecutive
  // store rows, mostly of one cell and scale) into shared memory with no
  // barrier between rows, then the chunk's scores are offered
  __shared__ float sc[TOPK_CHUNK];
  const int per = TOPK_CHUNK / (TOPK_THREADS / G);
  for (int ci = 0; ci < chunk_steps(slots); ++ci) {
    const int2 rg = centred_chunk(ci, slots);
    if (rg.x >= rg.y) continue;
    const int base = rg.x, cn = rg.y - rg.x;
    for (int r = 0; r < per; ++r) {
      const int i = gid * per + r, s = base + i;
      float score = INFINITY;
      int j = -1;
      if (i < cn) {
        const int wr = s / row_cap;
        const int st = st_b[wr], en = en_b[wr];
        const int jj = min(max(st, 0), s_max) + (s - wr * row_cap);
        if (jj >= st && jj < en && jj < n) j = jj;
      }
      if (j >= 0) {  // the same for the group's lanes
        const signed char* row = store + (long long)j * d;
        const float sc_j = scales[j];
        float acc = 0.0f;  // l2: chunk sums, added as floats in order
        int total = 0;     // l1, or l2 in one chunk: the int32 sum
        if constexpr (V > 1) {
          const int c = V * gl;  // this lane's unit: dims c .. c + V - 1
          if (!have_codes || __float_as_int(sc_j) != cur_scale) {
#pragma unroll
            for (int e = 0; e < V; ++e) code[e] = c + e < d ? query_code(qs[c + e], sc_j) : 0;
            cur_scale = __float_as_int(sc_j);
            have_codes = true;
          }
          int x[V];
          if constexpr (V == 16) {
            int4 v4 = make_int4(0, 0, 0, 0);
            if (c < d) v4 = *reinterpret_cast<const int4*>(row + c);
            const int wv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int e = 0; e < 16; ++e) x[e] = sbyte(wv[e / 4], e % 4);
          } else if (words) {
            const int wv = c < d ? *reinterpret_cast<const int*>(row + c) : 0;
#pragma unroll
            for (int e = 0; e < V; ++e) x[e] = sbyte(wv, e);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[e] = c + e < d ? (int)row[c + e] : 0;
          }
          int df[V];  // code differences; 0 past d
#pragma unroll
          for (int e = 0; e < V; ++e) df[e] = x[e] - code[e];
          if (one_sum) {
#pragma unroll
            for (int e = 0; e < V; ++e) total += metric_l1 ? abs(df[e]) : df[e] * df[e];
            total = group_sum(total, G, gmask);
          } else {
            for (int c0 = 0; c0 < d; c0 += d_chunk) {
              int part = 0;
#pragma unroll
              for (int e = 0; e < V; ++e)
                if (c + e >= c0 && c + e < c0 + d_chunk) part += df[e] * df[e];
              part = group_sum(part, G, gmask);
              acc = c0 == 0 ? __int2float_rn(part) : __fadd_rn(acc, __int2float_rn(part));
            }
          }
        } else {  // generic: a warp per row, a byte per lane
          for (int c0 = 0; c0 < d; c0 += one_sum ? d : d_chunk) {
            const int c1 = one_sum ? d : min(c0 + d_chunk, d);
            int part = 0;
            for (int c = c0 + lane; c < c1; c += 32) {
              const int df = (int)row[c] - query_code(qs[c], sc_j);
              part += metric_l1 ? abs(df) : df * df;
            }
            part = group_sum(part, 32, 0xffffffffu);
            if (one_sum) total = part;
            else acc = c0 == 0 ? __int2float_rn(part) : __fadd_rn(acc, __int2float_rn(part));
          }
        }
        if (one_sum && !metric_l1) acc = __int2float_rn(total);
        score = metric_l1 ? __fmul_rn(sc_j, __int2float_rn(total)) : __fmul_rn(sc_j, sqrtf(acc));
      }
      if (gl == 0 && i < cn) sc[i] = score;
    }
    topk_offer_chunk(top, list, sc, base, cn);
  }
  topk_finish(top, list, od, oi, [&](int s) {
    const int wr = s / row_cap;
    return min(max(st_b[wr], 0), s_max) + (s - wr * row_cap);
  });
}

// The variant for d: one 16-byte unit per lane at d % 16 == 0 (d <= 512),
// else one 4-byte unit per lane (d <= 128), else the generic one.
template <int V>
static int launch_q8(const void* store, const void* scales, const void* starts, const void* ends,
                     const void* queries, void* out_d, void* out_i, int B, int w, int row_cap,
                     int d, int n_pad, int n, int rerank_k, int d_chunk, int metric_l1, int G,
                     int words, cudaStream_t stream) {
  const size_t smem = (size_t)d * sizeof(float);
  const int e = allow_shared_bytes(csr_shortlist_q8_kernel<V>, smem);
  if (e != 0) return e;
  csr_shortlist_q8_kernel<V><<<B, TOPK_THREADS, smem, stream>>>(
      (const signed char*)store, (const float*)scales, (const int*)starts, (const int*)ends,
      (const float*)queries, (float*)out_d, (int*)out_i, w, row_cap, d, n_pad, n, rerank_k,
      d_chunk, metric_l1, G, words);
  return (int)cudaGetLastError();
}

// Lanes per row: the smallest power of two whose units cover d, at most 32.
static int q8_group(int d, int v) {
  const int units = (d + v - 1) / v;
  int g = 1;
  while (g < units && g < 32) g <<= 1;
  return g;
}

extern "C" int csr_shortlist_q8_launch(
    const void* store, const void* scales, const void* starts,
    const void* ends, const void* queries, void* out_d, void* out_i, int B,
    int w, int row_cap, int d, int n_pad, int n, int rerank_k, int d_chunk,
    int metric_l1, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= Q8_FAST_D && d % 16 == 0 && (uintptr_t)store % 16 == 0)
    return launch_q8<16>(store, scales, starts, ends, queries, out_d, out_i, B, w, row_cap, d,
                         n_pad, n, rerank_k, d_chunk, metric_l1, q8_group(d, 16), 1, s);
  if (d <= 4 * 32) {
    const int words = d % 4 == 0 && (uintptr_t)store % 4 == 0;
    return launch_q8<4>(store, scales, starts, ends, queries, out_d, out_i, B, w, row_cap, d,
                        n_pad, n, rerank_k, d_chunk, metric_l1, q8_group(d, 4), words, s);
  }
  return launch_q8<1>(store, scales, starts, ends, queries, out_d, out_i, B, w, row_cap, d,
                      n_pad, n, rerank_k, d_chunk, metric_l1, 32, 0, s);
}
