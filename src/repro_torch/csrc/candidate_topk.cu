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
// Design: csr_candidate_topk.cu's, on a window whose slot s is simply row
// b*C + s: both kernels are instances of kernel_common.cuh's two walks, and
// differ only in the slot locator.  One block of 256 threads per query, the
// query staged in shared memory.  Rows of d >= 32 floats take staged_rank:
// tiles of 256 slots from the window's middle out (a gathered window is
// centred on its query), each staged 32 feature dims (one 128-byte line of
// each row) at a time by cp.async through a 2-stage ring (16-byte copies
// when d % 4 == 0 and the window is 16-byte aligned, else 4-byte copies),
// each warp copying its own 32 rows with neighbouring lanes on neighbouring
// bytes, so a warp's copy instruction reads four whole lines where a
// thread-per-row read touched 32 lines d floats apart; invalid rows copy
// nothing; each thread sums its own row from shared memory through
// ChunkedSum and offers it after the tile's last stage.  The TPU kernel's
// sequential d-chunk grid axis with a VMEM accumulator becomes ChunkedSum's
// chunk folds.  A window of fewer than 256 slots (the q8 re-rank's
// rerank_k = 40-44) sizes the ring to its slots rounded up to a warp, so
// its blocks stay small and many share an SM.  Rows of d < 32 floats take
// direct_rank: one thread per candidate reads its row from device memory
// into a chunk of 4096 scores, then offers them.  Shared memory: the ring
// (2 x tile_rows x 36 floats, tile_rows = min(256, C rounded up to 32)),
// the rows of the tiles in flight (2 x 256 ints), the query (4*d bytes) and
// the top-k's buffer and list (5,136 bytes) -- at most 80,912 + 4*d bytes,
// whatever C; rows of d < 32: the query, a chunk of 4096 scores and the
// top-k's.  The launcher raises the block's limit above 48 KB.

#include <stdint.h>

#include "kernel_common.cuh"

// STAGED: rows reach shared memory through staged_rank's ring (d >=
// STAGE_TD); else direct_rank reads them from device memory.
template <bool STAGED>
__global__ void candidate_topk_kernel(
    const float* __restrict__ cand,           // (B, C, d)
    const unsigned char* __restrict__ valid,  // (B, C) bool
    const float* __restrict__ queries,        // (B, d)
    float* __restrict__ out_d,                // (B, k)
    int* __restrict__ out_i,                  // (B, k) local slots
    int C, int d, int k, int d_chunk, int metric_l1, int tile_rows, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                           // STAGE_RING x tile_rows x STAGE_LD
  int* rows = (int*)(ring + STAGE_RING * tile_rows * STAGE_LD);  // STAGE_RING x STAGE_TR
  float* qs = STAGED ? (float*)(rows + STAGE_RING * STAGE_TR) : smem;  // d
  __shared__ TopkShared top;

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  float* od = out_d + (long long)b * k;
  int* oi = out_i + (long long)b * k;
  const TopkList list = topk_init(top, od, oi, k);

  const float* cand_b = cand + (long long)b * C * d;
  const unsigned char* valid_b = valid + (long long)b * C;
  if constexpr (!STAGED) {
    __shared__ float sc[TOPK_CHUNK];
    direct_rank(top, list, sc, C, [&](int s) {
      return valid_b[s] ? chunked_distance(cand_b + (long long)s * d, qs, d, d_chunk, metric_l1, 0)
                        : INFINITY;
    });
  } else {
    staged_rank(top, list, ring, rows, tile_rows, cand_b, qs, C, d, d_chunk, metric_l1, 0, vec,
                [&](int s) { return s < C && valid_b[s] ? s : -1; },
                [](float) { return true; });
  }
  topk_finish(top, list, od, oi, [](int s) { return s; });
}

extern "C" int candidate_topk_launch(
    const void* cand, const void* valid, const void* queries, void* out_d,
    void* out_i, int B, int C, int d, int k, int d_chunk, int metric_l1,
    void* stream) {
  const bool staged = d >= STAGE_TD;
  // ring rows per slot: a whole tile, or a window of one partial tile's
  // slots rounded up to a warp
  const int tile_rows = min(STAGE_TR, max(32, (C + 31) / 32 * 32));
  const size_t smem =
      (staged ? (size_t)STAGE_RING * (tile_rows * STAGE_LD + STAGE_TR) * 4 : 0) + (size_t)d * 4;
  const auto kernel = staged ? candidate_topk_kernel<true> : candidate_topk_kernel<false>;
  const int e = allow_shared_bytes(kernel, smem);
  if (e != 0) return e;
  // 16-byte copies need every row on a 16-byte boundary
  const int vec = d % 4 == 0 && (uintptr_t)cand % 16 == 0;
  kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)cand, (const unsigned char*)valid, (const float*)queries,
      (float*)out_d, (int*)out_i, C, d, k, d_chunk, metric_l1, tile_rows, vec);
  return (int)cudaGetLastError();
}
