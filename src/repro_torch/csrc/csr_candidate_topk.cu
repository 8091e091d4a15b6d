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
// Design: one block of 256 threads per query; a tile is 256 consecutive window
// slots, one per thread, and a stage is TD = 32 feature dims (one 128-byte line
// of each row) of a tile.  Tiles go from the window's middle out (nearest
// first).  The row_cap slots of one window row are contiguous store rows, so a
// tile's valid rows are a few contiguous blocks of the store, as the TPU
// kernel's DMA of each window row into VMEM reads them.  Stages reach shared
// memory by cp.async (16-byte copies when d is a multiple of 4 and the store
// 16-byte aligned, else 4-byte copies) through a ring of CSR_STAGES = 2 slots,
// so the copies of the next stage overlap this stage's distances; each warp
// copies its own 32 rows, neighbouring lanes on neighbouring bytes (a row's
// slot and validity come from its owner by a shuffle), and invalid slots copy
// nothing.  Staged rows are TD + 4 floats apart, so the 16-byte reads of a
// quarter-warp fall in distinct banks.  Each thread then adds its own row's
// terms from shared memory in exactly chunked_distance's order, through
// kernel_common.cuh's ChunkedSum (per d_chunk block, in feature order, with
// __fsub_rn / __fmul_rn / __fadd_rn); its partial sums carry across stages.
// After a tile's last stage each valid slot offers its distance to
// kernel_common.cuh's filter-then-merge top-k, whose buffer is checked at the
// next stage's barrier.  Shared memory: the ring (2 x 256 x 36 floats), the
// rows of the tiles in flight (2 x 256), the query (4*d bytes) and the top-k's
// buffer and list (5,136 bytes): 80,912 + 4*d bytes whatever w*row_cap, so two
// blocks share an SM.  Measured on the card at phase 3's chunk, 32 dims and 2
// stages beat 16 dims and 2-4 stages (a row's 64-byte halves fetched a stage
// apart) and 64 dims.  Rows of d < 32 floats are read straight from device
// memory instead (see STAGED).
//
// Numerics: every row gets the float that chunked_distance gives it, so
// this kernel and candidate_topk.cu (which reads the same row from device
// memory) agree bit for bit (built with -fmad=false; no FMA, no fast
// math).

#include <stdint.h>

#include "kernel_common.cuh"

#define CSR_TD 32                  // feature dims per stage
#define CSR_LD (CSR_TD + 4)        // staged row stride (floats)
#define CSR_STAGES 2               // ring slots
#define CSR_TR TOPK_THREADS        // rows per tile: one per thread
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void csr_cp_async(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void csr_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most CSR_STAGES - 2 of this thread's copy groups are in flight.
__device__ __forceinline__ void csr_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(CSR_STAGES - 2) : "memory");
}

// STAGED: rows reach shared memory through the ring (d >= CSR_TD); else
// each thread reads its own rows from device memory (d < CSR_TD: a warp's
// 32 rows are a few contiguous runs of the store, read in a few lines),
// chunk by chunk as candidate_topk.cu does, with no barrier between rows.
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
  float* ring = smem;                                    // CSR_STAGES x CSR_TR x CSR_LD
  int* rows = (int*)(ring + CSR_STAGES * CSR_TR * CSR_LD);  // CSR_STAGES x CSR_TR: row or -1
  float* qs = STAGED ? (float*)(rows + CSR_STAGES * CSR_TR) : smem;  // d
  __shared__ TopkShared top;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < d; c += blockDim.x) qs[c] = queries[(long long)b * d + c];
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

  if constexpr (!STAGED) {
    // chunks of TOPK_CHUNK slots, the window's middle first: distances into
    // shared memory with no barrier between slots, then offered
    __shared__ float sc[TOPK_CHUNK];
    __syncthreads();
    for (int ci = 0; ci < chunk_steps(slots); ++ci) {
      const int2 r = centred_chunk(ci, slots);
      if (r.x >= r.y) continue;
      const int c0 = r.x, cn = r.y - r.x;
      for (int i = tid; i < cn; i += blockDim.x) {
        const int j = slot_row(c0 + i);
        float v = INFINITY;
        if (j >= 0) {
          const float dd = chunked_distance(store + (long long)j * d, qs, d, d_chunk, metric_l1,
                                            center_cells);
          if (radii == nullptr || dd <= r_b) v = dd;
        }
        sc[i] = v;
      }
      topk_offer_chunk(top, list, sc, c0, cn);
    }
  } else {
    const int ntiles = (slots + CSR_TR - 1) / CSR_TR;
    const int nd = (d + CSR_TD - 1) / CSR_TD;              // stages per tile
    const int total = ntiles * nd;                         // stages in all
    const int gbytes = vec ? 16 : 4;                       // bytes per copy
    const int gpr = CSR_TD * 4 / gbytes;                   // copies per row and stage

    // Issue the copies of stage t (the (t / nd)-th tile in middle-out
    // order, dims (t % nd)·TD ..) into ring slot t % CSR_STAGES; with a
    // tile's first stage, each thread also finds its own slot's row (-1 if
    // invalid) and keeps it in `rows` (a ring of CSR_STAGES tiles: copies
    // run at most CSR_STAGES - 1 stages ahead).
    auto issue = [&](int t) {
      const int ti = t / nd, c0 = (t - ti * nd) * CSR_TD, slot = t % CSR_STAGES;
      int j;
      if (c0 == 0) {
        j = slot_row(middle_out(ti, ntiles) * CSR_TR + tid);
        rows[(ti % CSR_STAGES) * CSR_TR + tid] = j;
      } else {
        j = rows[(ti % CSR_STAGES) * CSR_TR + tid];
      }
      float* dst = ring + slot * CSR_TR * CSR_LD;
      for (int m = 0; m < gpr; ++m) {
        const int r = m * (32 / gpr) + lane / gpr;  // this copy's row within the warp
        const int rj = __shfl_sync(FULL_MASK, j, r);
        const int c = c0 + (lane % gpr) * (gbytes / 4);
        if (rj >= 0 && c < d)
          csr_cp_async(dst + (warp * 32 + r) * CSR_LD + (c - c0), store + (long long)rj * d + c,
                       gbytes);
      }
      csr_commit();
    };

    for (int t = 0; t < CSR_STAGES - 1; ++t) {
      if (t < total) issue(t); else csr_commit();
    }

    ChunkedSum sum(d_chunk);  // this thread's row, carried across its tile's stages
    bool full = false;        // this thread's offer asked for a merge
    for (int t = 0; t < total; ++t) {
      const int ti = t / nd, c0 = (t - ti * nd) * CSR_TD;
      const int slot = t % CSR_STAGES;
      csr_wait_ring();  // this thread's copies of stage t have landed
      topk_check(top, list, full);  // a barrier: every thread's have, slot t-1 is free
      full = false;
      if (t + CSR_STAGES - 1 < total) issue(t + CSR_STAGES - 1); else csr_commit();

      const int j = rows[(ti % CSR_STAGES) * CSR_TR + tid];
      const int dn = min(CSR_TD, d - c0);
      if (j >= 0) {
        const float* x = ring + (slot * CSR_TR + tid) * CSR_LD;
        sum.boundary(c0, d_chunk);  // a chunk may end where the stage starts
        if (dn == CSR_TD && c0 + CSR_TD <= sum.next) {  // a whole stage inside one chunk
  #pragma unroll
          for (int g = 0; g < CSR_TD / 4; ++g) {
            const float4 x4 = *reinterpret_cast<const float4*>(x + 4 * g);
            sum.add(x4.x, qs[c0 + 4 * g], metric_l1, center_cells);
            sum.add(x4.y, qs[c0 + 4 * g + 1], metric_l1, center_cells);
            sum.add(x4.z, qs[c0 + 4 * g + 2], metric_l1, center_cells);
            sum.add(x4.w, qs[c0 + 4 * g + 3], metric_l1, center_cells);
          }
        } else {
          for (int c = c0; c < c0 + dn; ++c) {
            sum.boundary(c, d_chunk);
            sum.add(x[c - c0], qs[c], metric_l1, center_cells);
          }
        }
      }
      if (c0 + dn == d) {  // the tile's last stage: its distances are complete
        if (j >= 0) {
          const float dd = sum.finish(metric_l1);
          if (radii == nullptr || dd <= r_b)
            full = topk_offer(top, dd, middle_out(ti, ntiles) * CSR_TR + tid);
        }
        sum = ChunkedSum(d_chunk);
      }
    }
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
  const bool staged = d >= CSR_TD;
  const size_t smem = (staged ? (size_t)CSR_STAGES * CSR_TR * (CSR_LD + 1) * 4 : 0) + (size_t)d * 4;
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
