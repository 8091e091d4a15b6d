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
// What bounds it on this card: bytes.  A query reads d floats for each valid
// slot from the CSR store, which stays in device memory, and does three
// float operations per value read.
//
// Design: one block per query.  The query vector is staged in shared memory.
// One thread per slot (threads stride over the w*row_cap slots) computes the
// slot's distance; loads of invalid slots are skipped, but every slot writes
// its (distance or +inf, global row) pair to shared arrays of w*row_cap
// entries each.  Then k rounds of a block arg-min on (value, slot) pick the
// result; the chosen slot is set to +inf for the next round.  Nothing of size
// (B, w*row_cap) reaches device memory.  At w*row_cap = 8192 the shared arrays
// take 64 KB, above the 48 KB default, so the launcher raises the block's
// dynamic shared-memory limit; the wrapper refuses shapes above 227 KB.
// A thread reads its slot's row alone, so a warp's loads are strided by d;
// coalescing them is later work.
//
// Numerics: the distance and the arg-min are kernel_common.cuh's, shared
// with candidate_topk.cu, so both kernels give the same float for the same
// row (built with -fmad=false; no FMA, no fast math).

#include "kernel_common.cuh"

__global__ void csr_candidate_topk_kernel(
    const float* __restrict__ store,    // (n_pad, d)
    const int* __restrict__ starts,     // (B, w)
    const int* __restrict__ ends,       // (B, w)
    const float* __restrict__ queries,  // (B, d)
    const float* __restrict__ radii,    // (B,) or nullptr
    float* __restrict__ out_d,          // (B, k)
    int* __restrict__ out_i,            // (B, k)
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells) {
  extern __shared__ float smem[];
  const int slots = w * row_cap;
  float* qs = smem;                       // d
  float* dist = qs + d;                   // slots
  int* gidx = (int*)(dist + slots);       // slots

  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
  __syncthreads();

  const int s_max = max(n_pad - row_cap, 0);
  const float r = radii != nullptr ? radii[b] : 0.0f;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int row = s / row_cap;
    const int st = starts[b * w + row];
    const int en = ends[b * w + row];
    const int j = min(max(st, 0), s_max) + (s - row * row_cap);
    float dv = INFINITY;
    if (j >= st && j < en && j < n) {
      const float dd = chunked_distance(store + (long long)j * d, qs, d,
                                        d_chunk, metric_l1, center_cells);
      if (radii == nullptr || dd <= r) dv = dd;
    }
    dist[s] = dv;
    gidx[s] = j;
  }
  __syncthreads();

  block_topk(dist, gidx, slots, k, out_d + (long long)b * k,
             out_i + (long long)b * k);
}

extern "C" int csr_candidate_topk_launch(
    const void* store, const void* starts, const void* ends,
    const void* queries, const void* radii, void* out_d, void* out_i, int B,
    int w, int row_cap, int d, int n_pad, int n, int k, int d_chunk,
    int metric_l1, int center_cells, void* stream) {
  const size_t smem = (size_t)d * sizeof(float) + (size_t)w * row_cap * 8;
  const int e = allow_shared_bytes(csr_candidate_topk_kernel, smem);
  if (e != 0) return e;
  csr_candidate_topk_kernel<<<B, TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)store, (const int*)starts, (const int*)ends,
      (const float*)queries, (const float*)radii, (float*)out_d, (int*)out_i,
      w, row_cap, d, n_pad, n, k, d_chunk, metric_l1, center_cells);
  return (int)cudaGetLastError();
}
