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
// same row: both add a row's terms in chunked_distance's order, and both
// select with kernel_common.cuh's exact top-k.
// hopper_gather ranks its materialised window with it (C = w*row_cap) and
// hopper_q8 re-ranks its shortlist with it (C = rerank_k).
//
// What bounds it on this card: bytes.  A query reads d floats for each
// valid candidate, which its caller materialised in device memory, and does
// three float operations per value read.
//
// Design: one block per query, the query vector staged in shared memory.
// Candidates go in chunks of 4096, the middle chunk first (a gathered
// window is centred on its query): one thread per candidate computes its
// distance (+inf if invalid; invalid candidates skip their loads) into a
// shared array of the chunk, with no barrier between candidates, so a
// thread's loads of several rows overlap; then the chunk's distances are
// offered to kernel_common.cuh's filter-then-merge top-k, 256 at a time.
// The TPU kernel's sequential d-chunk grid axis with a VMEM accumulator
// becomes the chunk loop inside chunked_distance.  Shared memory: 4*d
// bytes for the query (dynamic), the chunk's 16 KB and the top-k's buffer
// and list (5,136 bytes), whatever C; the launcher raises the block's
// limit above 48 KB for a wide query.  A thread reads its candidate's row
// alone, so a warp's loads are strided by d; coalescing them is later work.

#include "kernel_common.cuh"

__global__ void candidate_topk_kernel(
    const float* __restrict__ cand,           // (B, C, d)
    const unsigned char* __restrict__ valid,  // (B, C) bool
    const float* __restrict__ queries,        // (B, d)
    float* __restrict__ out_d,                // (B, k)
    int* __restrict__ out_i,                  // (B, k) local slots
    int C, int d, int k, int d_chunk, int metric_l1) {
  extern __shared__ float qs[];  // d
  __shared__ TopkShared top;

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  float* od = out_d + (long long)b * k;
  int* oi = out_i + (long long)b * k;
  const TopkList list = topk_init(top, od, oi, k);
  __syncthreads();

  // chunks of TOPK_CHUNK candidates, centred on the middle: distances into
  // shared memory, then offered
  __shared__ float sc[TOPK_CHUNK];
  for (int ci = 0; ci < chunk_steps(C); ++ci) {
    const int2 r = centred_chunk(ci, C);
    if (r.x >= r.y) continue;
    const int c0 = r.x, cn = r.y - r.x;
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      const long long row = (long long)b * C + c0 + i;
      sc[i] = valid[row] ? chunked_distance(cand + row * d, qs, d, d_chunk, metric_l1, 0)
                         : INFINITY;
    }
    topk_offer_chunk(top, list, sc, c0, cn);
  }
  topk_finish(top, list, od, oi, [](int s) { return s; });
}

extern "C" int candidate_topk_launch(
    const void* cand, const void* valid, const void* queries, void* out_d,
    void* out_i, int B, int C, int d, int k, int d_chunk, int metric_l1,
    void* stream) {
  const size_t smem = (size_t)d * sizeof(float);
  const int e = allow_shared_bytes(candidate_topk_kernel, smem);
  if (e != 0) return e;
  candidate_topk_kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)cand, (const unsigned char*)valid, (const float*)queries,
      (float*)out_d, (int*)out_i, C, d, k, d_chunk, metric_l1);
  return (int)cudaGetLastError();
}
