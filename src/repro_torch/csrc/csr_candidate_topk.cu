// Fused CSR gather -> distance -> top-k on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csr_candidate_topk.py::
// csr_candidate_topk.  For each query b it walks the w window rows; row i
// covers the row_cap store rows from the span start clamped to
// [0, n_pad - row_cap].  A slot is valid when its store row j lies in
// [starts[b,i], ends[b,i]) and below the live count n.  Valid slots get the
// l1 or l2 distance to the query, summed per d_chunk block and then across
// blocks; paper mode ranks floor(x)+0.5 cell centers and keeps only slots
// within radii[b].  The k smallest (distance, slot) pairs, smaller slot first
// on ties, come out as distances and GLOBAL CSR rows, with +inf / -1 where
// fewer than k slots are valid (k may exceed w*row_cap).  Equal to the plain
// version repro_torch/kernels/ref.py::csr_candidate_topk (bit-equal at d <= 2,
// where no summation order differs).
//
// What bounds it on this card: bytes.  A query reads d floats for each
// valid slot from the CSR store, which stays in device memory, and does
// three float operations per value read.  Counted over distinct rows the
// bound assumes queries share rows in L2; counted per (query, row) pair
// ("gathered" bytes) it is the floor when they share nothing.
//
// Design: one block of 256 threads per query, over the query's w*row_cap
// window slots from the middle out (nearest first).  The row_cap slots of
// one window row are contiguous store rows, so a tile's valid rows are a few
// contiguous blocks of the store, as the TPU kernel's DMA of each window row
// into VMEM reads them.  Rows of d >= 32 floats take kernel_common.cuh's
// staged_rank: tiles of 256 slots, one per thread, staged 32 feature dims
// (one 128-byte line of each row) at a time by cp.async through a 2-stage
// ring, each warp copying its own 32 rows with neighbouring lanes on
// neighbouring bytes, each thread summing its own row from shared memory
// through ChunkedSum, and a tile's distances offered to the filter-then-merge
// top-k after its last stage.  Shared memory: the ring (2 x 256 x 36 floats),
// the rows of the tiles in flight (2 x 256), the query (4*d bytes) and the
// top-k's buffer and list (5,136 bytes): 80,912 + 4*d bytes whatever
// w*row_cap, so two blocks share an SM.  Measured on the card at phase 3's
// chunk, 32 dims and 2 stages beat 16 dims and 2-4 stages (a row's 64-byte
// halves fetched a stage apart) and 64 dims.  Rows of d < 32 floats take
// direct_rank instead: each thread reads its own rows from device memory (a
// warp's 32 rows are a few contiguous runs of the store, read in a few
// lines).  candidate_topk.cu walks its dense window with the same two
// walks; only the slot locator differs.
//
// Numerics: every row gets the float that chunked_distance gives it, so
// this kernel and candidate_topk.cu agree bit for bit on the same row
// (built with -fmad=false; no FMA, no fast math).

#include <stdint.h>

#include "kernel_common.cuh"

// STAGED: rows reach shared memory through staged_rank's ring (d >=
// STAGE_TD); else direct_rank reads them from device memory.
template <bool STAGED>
__global__ void csr_candidate_topk_kernel(
    const float* __restrict__ store,    // (n_pad, d)
    const int* __restrict__ starts,     // (B, w)
    const int* __restrict__ ends,       // (B, w)
    const float* __restrict__ queries,  // (B, d)
    const float* __restrict__ radii,    // (B,) or nullptr
    float* __restrict__ out_d,          // (B, k)
    int* __restrict__ out_i,            // (B, k)
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                          // STAGE_RING x STAGE_TR x STAGE_LD
  int* rows = (int*)(ring + STAGE_RING * STAGE_TR * STAGE_LD);  // STAGE_RING x STAGE_TR
  float* qs = STAGED ? (float*)(rows + STAGE_RING * STAGE_TR) : smem;  // d
  __shared__ TopkShared top;

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  float* od = out_d + (long long)b * k;
  int* oi = out_i + (long long)b * k;
  const TopkList list = topk_init(top, od, oi, k);

  const int slots = w * row_cap;
  const int s_max = max(n_pad - row_cap, 0);
  const int* st_b = starts + (long long)b * w;
  const int* en_b = ends + (long long)b * w;
  // the store row of window slot s, or -1 where the slot is not valid
  auto slot_row = [&](int s) {
    if (s >= slots) return -1;
    const int wr = s / row_cap;
    const int st = st_b[wr], en = en_b[wr];
    const int j = min(max(st, 0), s_max) + (s - wr * row_cap);
    return j >= st && j < en && j < n ? j : -1;
  };
  const float r_b = radii != nullptr ? radii[b] : 0.0f;
  auto keep = [&](float dd) { return radii == nullptr || dd <= r_b; };

  if constexpr (!STAGED) {
    __shared__ float sc[TOPK_CHUNK];
    direct_rank(top, list, sc, slots, [&](int s) {
      const int j = slot_row(s);
      if (j < 0) return INFINITY;
      const float dd = chunked_distance(store + (long long)j * d, qs, d, d_chunk, metric_l1,
                                        center_cells);
      return keep(dd) ? dd : INFINITY;
    });
  } else {
    staged_rank(top, list, ring, rows, STAGE_TR, store, qs, slots, d, d_chunk, metric_l1,
                center_cells, vec, slot_row, keep);
  }
  topk_finish(top, list, od, oi, [&](int s) {
    const int wr = s / row_cap;
    return min(max(st_b[wr], 0), s_max) + (s - wr * row_cap);
  });
}

extern "C" int csr_candidate_topk_launch(
    const void* store, const void* starts, const void* ends,
    const void* queries, const void* radii, void* out_d, void* out_i, int B,
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells, void* stream) {
  const bool staged = d >= STAGE_TD;
  const size_t smem =
      (staged ? (size_t)STAGE_RING * STAGE_TR * (STAGE_LD + 1) * 4 : 0) + (size_t)d * 4;
  const auto kernel = staged ? csr_candidate_topk_kernel<true> : csr_candidate_topk_kernel<false>;
  const int e = allow_shared_bytes(kernel, smem);
  if (e != 0) return e;
  // 16-byte copies need every row on a 16-byte boundary
  const int vec = d % 4 == 0 && (uintptr_t)store % 16 == 0;
  kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)store, (const int*)starts, (const int*)ends,
      (const float*)queries, (const float*)radii, (float*)out_d, (int*)out_i,
      w, row_cap, d, n_pad, n, k, d_chunk, metric_l1, center_cells, vec);
  return (int)cudaGetLastError();
}
