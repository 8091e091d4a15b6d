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
// six operations per byte read (divide, round, clamp, subtract, multiply,
// add).
//
// Design: csr_candidate_topk.cu's.  One block per query, the float query
// in shared memory, one thread per window slot (threads stride over the
// w*row_cap slots); each valid slot reads its scale once and its row's
// codes, and writes (score or +inf, global row) to shared arrays of
// w*row_cap entries; then rerank_k rounds of the block arg-min
// (kernel_common.cuh).  Shared memory is 4*d + 8*w*row_cap bytes, 64 KB at
// PAPER_GRID's 8192 slots; the launcher raises the block's limit above
// 48 KB and the wrapper refuses shapes above 227 KB.

#include "kernel_common.cuh"

#define QCLIP 1023

__device__ __forceinline__ int query_code(float q, float s) {
  const float v = rintf(__fdiv_rn(q, s));
  return (int)fminf(fmaxf(v, -(float)QCLIP), (float)QCLIP);
}

__global__ void csr_shortlist_q8_kernel(
    const signed char* __restrict__ store,  // (n_pad, d) int8
    const float* __restrict__ scales,       // (n_pad, 1)
    const int* __restrict__ starts,         // (B, w)
    const int* __restrict__ ends,           // (B, w)
    const float* __restrict__ queries,      // (B, d)
    float* __restrict__ out_d,              // (B, rerank_k)
    int* __restrict__ out_i,                // (B, rerank_k)
    int w, int row_cap, int d, int n_pad, int n, int rerank_k, int d_chunk,
    int metric_l1) {
  extern __shared__ float smem[];
  const int slots = w * row_cap;
  float* qs = smem;                  // d
  float* dist = qs + d;              // slots
  int* gidx = (int*)(dist + slots);  // slots

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  __syncthreads();

  const int s_max = max(n_pad - row_cap, 0);
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int row = s / row_cap;
    const int st = starts[b * w + row];
    const int en = ends[b * w + row];
    const int j = min(max(st, 0), s_max) + (s - row * row_cap);
    float dv = INFINITY;
    if (j >= st && j < en && j < n) {
      const signed char* x = store + (long long)j * d;
      const float sc = scales[j];
      float acc = 0.0f;  // l2: chunk sums, added as floats in order
      int total = 0;     // l1: one int32 sum
      for (int c0 = 0; c0 < d; c0 += d_chunk) {
        const int c1 = min(c0 + d_chunk, d);
        int part = 0;
        for (int c = c0; c < c1; ++c) {
          const int df = (int)x[c] - query_code(qs[c], sc);
          part += metric_l1 ? abs(df) : df * df;
        }
        if (metric_l1) total += part;
        else acc = __fadd_rn(acc, __int2float_rn(part));
      }
      dv = metric_l1 ? __fmul_rn(sc, __int2float_rn(total)) : __fmul_rn(sc, sqrtf(acc));
    }
    dist[s] = dv;
    gidx[s] = j;
  }
  __syncthreads();

  block_topk(dist, gidx, slots, rerank_k, out_d + (long long)b * rerank_k,
             out_i + (long long)b * rerank_k);
}

extern "C" int csr_shortlist_q8_launch(
    const void* store, const void* scales, const void* starts,
    const void* ends, const void* queries, void* out_d, void* out_i, int B,
    int w, int row_cap, int d, int n_pad, int n, int rerank_k, int d_chunk,
    int metric_l1, void* stream) {
  const size_t smem = (size_t)d * sizeof(float) + (size_t)w * row_cap * 8;
  const int e = allow_shared_bytes(csr_shortlist_q8_kernel, smem);
  if (e != 0) return e;
  csr_shortlist_q8_kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const signed char*)store, (const float*)scales, (const int*)starts,
      (const int*)ends, (const float*)queries, (float*)out_d, (int*)out_i, w,
      row_cap, d, n_pad, n, rerank_k, d_chunk, metric_l1);
  return (int)cudaGetLastError();
}
