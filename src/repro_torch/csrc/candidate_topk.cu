// Dense candidate distance -> top-k on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/candidate_topk.py::candidate_topk.
// For each query b it ranks the C dense candidate rows cand[b] (C x d
// floats) that valid[b] marks: the l1 or l2 distance to the query, summed
// per d_chunk block and then across blocks, and the k smallest (distance,
// slot) pairs, smaller slot first on ties.  Out: distances and LOCAL slots
// (0..C-1), with +inf / -1 where fewer than k candidates are valid (k may
// exceed C).  Equal to the plain version
// repro_torch/kernels/ref.py::candidate_topk (bit-equal at d <= 2, where no
// summation order differs), and to csr_candidate_topk.cu bit for bit on the
// same row: both take kernel_common.cuh's chunked_distance and block_topk.
// hopper_gather ranks its materialised window with it (C = w*row_cap) and
// hopper_q8 re-ranks its shortlist with it (C = rerank_k).
//
// What bounds it on this card: bytes.  A query reads d floats for each
// valid candidate, which its caller materialised in device memory, and does
// three float operations per value read.
//
// Design: one block per query, the query vector staged in shared memory,
// one thread per candidate (threads stride over C).  Invalid candidates
// skip their loads; every candidate writes its distance or +inf to a
// shared array of C floats.  Then k rounds of the block arg-min.  The TPU
// kernel's sequential d-chunk grid axis with a VMEM accumulator becomes the
// chunk loop inside chunked_distance.  Shared memory is 4*d + 4*C bytes;
// the launcher raises the block's limit above 48 KB and the wrapper refuses
// shapes above 227 KB.  A thread reads its candidate's row alone, so a
// warp's loads are strided by d; coalescing them is later work.

#include "kernel_common.cuh"

__global__ void candidate_topk_kernel(
    const float* __restrict__ cand,           // (B, C, d)
    const unsigned char* __restrict__ valid,  // (B, C) bool
    const float* __restrict__ queries,        // (B, d)
    float* __restrict__ out_d,                // (B, k)
    int* __restrict__ out_i,                  // (B, k) local slots
    int C, int d, int k, int d_chunk, int metric_l1) {
  extern __shared__ float smem[];
  float* qs = smem;      // d
  float* dist = qs + d;  // C

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  __syncthreads();

  for (int s = threadIdx.x; s < C; s += blockDim.x) {
    const long long row = (long long)b * C + s;
    dist[s] = valid[row] ? chunked_distance(cand + row * d, qs, d, d_chunk, metric_l1, 0)
                         : INFINITY;
  }
  __syncthreads();

  block_topk(dist, nullptr, C, k, out_d + (long long)b * k, out_i + (long long)b * k);
}

extern "C" int candidate_topk_launch(
    const void* cand, const void* valid, const void* queries, void* out_d,
    void* out_i, int B, int C, int d, int k, int d_chunk, int metric_l1,
    void* stream) {
  const size_t smem = (size_t)(d + C) * sizeof(float);
  const int e = allow_shared_bytes(candidate_topk_kernel, smem);
  if (e != 0) return e;
  candidate_topk_kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)cand, (const unsigned char*)valid, (const float*)queries,
      (float*)out_d, (int*)out_i, C, d, k, d_chunk, metric_l1);
  return (int)cudaGetLastError();
}
