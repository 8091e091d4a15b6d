// Flash attention (online softmax), causal or full, on Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention.
// q (B, S, H, hd), k and v (B, T, H, hd), float32; out (B, S, H, hd):
// softmax(q·kᵀ · scale) · v per (batch, head), with query position >= key
// position kept under `causal` and the rest set to -1e30.  The (S, T)
// scores never reach device memory: a running max m, denominator l and
// output accumulator per query row live in registers across the key tiles,
// and a row whose scores are all masked gives 0 (the m == -1e30 guards of
// the TPU kernel).  No model path calls it; the reference's oracle is
// repro_torch/kernels/ref.py::flash_attention.
//
// What bounds it on this card: operations.  Each (query, key) pair costs
// 4·hd float operations (2·hd for q·k, 2·hd for p·v) against 4·hd·4 bytes
// per row of q, k, v and out, so at musicgen-medium's hd = 64 and S = 32k
// the operations outweigh the bytes about 200 times.  Both products run on
// the tensor cores in three-pass TF32, three products at the TF32 rate for
// each float32 one, so the bound is 3 x operations / 495 TFLOP/s (the
// float32 FMA units' bound, operations / 67 TFLOP/s, is 2.5x longer).
//
// Numerics: three-pass TF32 keeps float32 accuracy.  Every operand x of
// both products is split as hi = tf32(x), lo = tf32(x - hi) (the rounding
// of cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero), and each
// tile product is lo·hi + hi·lo + hi·hi, issued in that order (small terms
// first) into one float32 accumulator.  hi·hi is exact in the tensor core,
// the two cross terms carry the next 11 bits, and the dropped lo·lo term is
// below 2^-22 of the product.  One pass (hi·hi alone) keeps about 3 decimal
// digits and is not used.  The tensor core rounds its own sums toward zero,
// so each key tile's P·V starts from zero and is added to the running
// output once, rounded to nearest: a running sum fed to the tensor core
// over the 512 tiles of a 32k row drifts toward the float32 tolerance
// the kernel is held to (2e-5 against the plain version).  Scores are kept
// in log2 units (scale·log2 e folded into the score scale) so the
// exponentials are exp2f; exp2f and the final division are IEEE (no fast
// math), and the sources are built with -fmad=false.  The sums run in
// another order than the plain version's matmul and softmax, so results
// agree to float32 rounding, not bit for bit.
//
// Design.  A block of 4 warps owns 64 query rows of one (batch, head),
// 16 rows per warp, and streams that head's keys and values in tiles of 64
// rows (the wider variants' sizes are below) through a two-stage ring in
// dynamic shared memory, filled by cp.async (16-byte copies, 4-byte ones
// where hd % 4 != 0 or a row is not 16-byte aligned), so the next tile's
// copy overlaps this tile's products.  The TPU kernel's sequential
// key-block grid axis with its VMEM scratch becomes this key loop.  The
// head dim is padded with zeros to the variant's HDP (16, 32, 64, 128, 160,
// 256, 512 or 1024; zero columns add exact zeros to both products).  At
// HDP <= 64 each warp splits its query fragments once and keeps them in
// registers.  Query tiles run last to first, so the causal rows with the
// most keys start first (see "Grid").  What limits it: not the bytes, and
// not the tensor cores alone.  Each warp alternates between tensor-core
// products and scalar work (the splits: 4 integer operations and a
// subtraction per element of the K and V tiles it reads; the softmax), and
// at 252 registers 8 warps share an SM.  Variants with more warps per SM
// (smaller key tiles, query fragments in shared memory) or with half the
// splits per row (32 rows per warp) ran no faster; wgmma, which takes its
// B operand from shared memory and runs asynchronously, is the next step.
//
// Fragments of mma.sync.m16n8k8 (tf32), lane = 4g + t: A (16 x 8, row
// major) a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4);
// B (8 x 8) b0 = (t, g), b1 = (t+4, g); C (16 x 8) c0, c1 = (g, 2t),
// (g, 2t+1) and c2, c3 = (g+8, 2t), (g+8, 2t+1).  A contraction index may
// be relabelled freely as long as both operands use one labelling (the
// contraction is a sum), and an output column freely as long as the
// epilogue writes it where it belongs:
// - S = Q·Kᵀ, k-step ks: A-column t is dim 8ks+2t and A-column t+4 is dim
//   8ks+2t+1, in the query fragments and in K's (b0, b1) = K[8j+g][8ks+2t,
//   8ks+2t+1], one 8-byte shared read.
// - P·V takes P straight from the S accumulators, never through memory:
//   n-tile j of S holds keys 8j+2t and 8j+2t+1 of rows g and g+8, and A
//   wants columns t and t+4.  So key 8j+2t is read as A-column t and key
//   8j+2t+1 as A-column t+4 (a0..a3 = c0, c2, c1, c3), and V's B fragment
//   with the same relabelling: b0 = V[8j+2t][dv], b1 = V[8j+2t+1][dv].
// - P·V output column c of n-tile n is dim dv(n, c) = 8·NV·(n / NV) +
//   NV·c + n % NV (NV = 4, or 2 at HDP = 16), so a lane's b0 of NV
//   consecutive n-tiles is one 16-byte (8-byte) shared read.
// K rows are HDP + 8 floats apart and V rows HDP + 4, which puts each
// half-warp's 8-byte K reads and each quarter-warp's 16-byte V reads in
// distinct banks.  Row reductions (max, sum) of a score row are two
// xor-shuffles over its 4 lanes t.
//
// Wide heads (hd 65-256: minitron-8b's 128, stablelm-12b's 160) run on
// the same kernel, HDP = 128, 160 and 256, in a layout of their own: with
// the layout above a thread at HDP = 128 holds 255 registers (the output's
// 64 floats, the tile's P·V products for all 16 n-tiles, 64 more, and the
// scores, 32), its query tile, split in shared memory, kept a block of 4
// warps alone on an SM, and at HDP = 160 two stages of 64-key tiles would
// pass a block's 227 KB.  So the wide variants (fa_variant's `wide`)
// differ in four ways, each chosen by ptxas's registers and spills and by
// timing (PERF.md), and none spills.
// - P·V runs with groups of NV n-tiles outer and the tile's keys inner, so
//   only one group's NV products are live, beside P's TF32 splits for the
//   tile's keys.  Each n-tile still sums its keys in the same order from
//   zero, so a tile's products are those of the other loop order.
// - A block has 8 warps (128 query rows), and the key tiles are 32 rows
//   (HDP = 128 and 160) or 16 (256): each K and V tile then feeds 8 warps,
//   and the ring and the query tile fit (138, 171 and 202 KB).  The query
//   tile stays float32 in shared memory and a warp splits its fragments at
//   each k-step (split once, it would not fit at HDP = 160 and 256, and at
//   128 it ran slower).
// - At HDP = 256 a P·V group is one n-tile (NV = 1, scalar reads of V),
//   the Q·Kᵀ k-steps are unrolled 16 at a time and, at HDP = 160, the copy
//   loops are kept rolled: each of these took the registers that spilled
//   (at HDP = 128, 48- and 64-key tiles spilled).
// - A warp skips the key tiles that start past its last row (causal): the
//   block-wide skip leaves them in, because the block is taller than a
//   key tile.  This is exact, as below.
// Head dims 257-1024 (HDP = 512, 1024) add a column split: a warp's output
// is 16 rows x HDP / 32 lanes floats, 256 at HDP = 512, which does not fit
// in 255 registers.  So the `slices` warps of a row group share 16 query
// rows and each owns 128 of the head dims: HDP = 512 runs 4 slices (2 row
// groups, 32 rows) with 16-key tiles, HDP = 1024 8 slices (one row group,
// 16 rows) with 8-key tiles.  A warp's output is then HDP = 128's 64
// floats, and its 128 query columns split once, kept in registers (128
// more), so no query tile sits in shared memory beside the ring (141 and
// 136 KB); P·V reads V two n-tiles at a time (NV = 2) and the copy loops
// stay rolled, the first layout that did not spill.  Each warp computes
// the partial S = Q·Kᵀ over its own head dims (three-pass TF32, as above)
// and writes it to shared memory; after a named barrier of its row group
// (bar.sync 1 + group) every warp of the group sums the partials in slice
// order 0, 1, ..., n - 1, so all of them hold the same S bit for bit, and
// from it the same m, l and P.  Each then runs P·V over its own head dims
// only and writes them.  A row group's warps skip the same causal tiles
// (they share their rows), so none waits at the barrier for a warp that
// skipped.
//
// Grid: (batch, head) sits on grid.x, which holds 2^31 - 1 blocks, so B·H
// is not held to grid.y's 65,535.  The query tile sits on grid.y (grid.x
// runs fastest, so the heaviest causal tile of every head starts first);
// past grid.y's 65,535 tiles (S > 65,535 x the variant's rows) the kernel
// launches again for the next 65,535 tiles, each launch taking the index
// of its first tile, so the heaviest tiles still go first.
//
// Causal skipping: key tiles that start past the block's last query row
// are not visited (nor, in the wide variants, those past a warp's last row
// by that warp).  This is exact, not an approximation: every score there
// is -1e30, so the max is unchanged (alpha = 1), every p = exp(-1e30 - m)
// is 0 (or 0 by the guard when m is -1e30 too), and l and the accumulator
// keep their values.  Masks are computed only in tiles that hold a masked
// pair for the warp (past T, or a key past the warp's first row).

#include <stdint.h>

#include "kernel_common.cuh"

#define FA_NEG_INF -1e30f
#define FULL_MASK 0xffffffffu
#define FA_LOG2E 1.4426950408889634f
#define FA_MAX_TILES 65535  // query tiles on grid.y

// Where a warp finds the A fragments of its query rows at each Q·Kᵀ k-step.
#define FA_Q_REGISTERS 0  // split once, kept in registers
#define FA_Q_RAW 1        // float32 in shared memory, split at each k-step

// Padded head dim of the variant that takes head dim hd (0: none does).
__host__ __device__ constexpr int fa_padded_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128
       : hd <= 160 ? 160 : hd <= 256 ? 256 : hd <= 512 ? 512 : hd <= 1024 ? 1024 : 0;
}

// What each variant keeps where (see "Wide heads" and "Head dims
// 257-1024"; chosen by ptxas's registers and spills and by timing, PERF.md).
struct FaVariant {
  int warps;           // warps of a block
  int slices;          // warps that share 16 query rows, each taking HDP / slices of the head dim
  int key_tile;        // key rows per K and V tile
  int q_mode;          // FA_Q_*
  int pv_group;        // NV: P·V n-tiles per vector read of V
  int kk_unroll;       // Q·Kᵀ k-steps unrolled
  bool rolled_copies;  // copy loops kept rolled (their addresses then hold no registers)
  bool wide;           // P·V with n-tile groups outer; each row group skips causal tiles itself
};
__host__ __device__ constexpr FaVariant fa_variant(int hdp) {
#ifdef FA_TRY_HDP  // scripts/flash_attention_variants.py: try another entry for one HDP
  if (hdp == FA_TRY_HDP) return FaVariant{FA_TRY_VARIANT};
#endif
  return hdp == 128 ? FaVariant{8, 1, 32, FA_Q_RAW, 4, 16, false, true}
       : hdp == 160 ? FaVariant{8, 1, 32, FA_Q_RAW, 4, 16, true, true}
       : hdp == 256 ? FaVariant{8, 1, 16, FA_Q_RAW, 1, 16, false, true}
       : hdp == 512 ? FaVariant{8, 4, 16, FA_Q_REGISTERS, 2, 16, true, true}
       : hdp == 1024 ? FaVariant{8, 8, 8, FA_Q_REGISTERS, 2, 16, true, true}
       : FaVariant{4, 1, 64, FA_Q_REGISTERS, hdp == 16 ? 2 : 4, hdp / 8, false, false};
}
__host__ __device__ constexpr int fa_warps(int hdp) { return fa_variant(hdp).warps; }
__host__ __device__ constexpr int fa_key_tile(int hdp) { return fa_variant(hdp).key_tile; }
__host__ __device__ constexpr int fa_q_mode(int hdp) { return fa_variant(hdp).q_mode; }
// Query rows of a block: 16 per row group of `slices` warps.
__host__ __device__ constexpr int fa_query_rows(int hdp) {
  return 16 * fa_variant(hdp).warps / fa_variant(hdp).slices;
}
// Shared row strides in floats: K (and the query tile) HDP + 8, so the
// 8-byte fragment reads of a half-warp fall in distinct banks; V HDP + 4,
// so the 16-byte (8-byte at HDP = 16) reads of a quarter-warp do.
__host__ __device__ constexpr int fa_k_stride(int hdp) { return hdp + 8; }
__host__ __device__ constexpr int fa_v_stride(int hdp) { return hdp + 4; }

// Dynamic shared memory of one block for head dim hd (the wrapper's
// shared_bytes computes the same): two stages of a K and a V tile, the
// float32 query tile where it is not in registers, and,
// where warps split the head dim, each warp's partial scores (16 x key tile).
__host__ __device__ inline size_t fa_shared_bytes(int hd) {
  const int hdp = fa_padded_hd(hd), qm = fa_q_mode(hdp), bk = fa_key_tile(hdp);
  const size_t ring = (size_t)2 * bk * (fa_k_stride(hdp) + fa_v_stride(hdp));
  const size_t qtile = qm == FA_Q_RAW ? (size_t)fa_query_rows(hdp) * fa_k_stride(hdp) : 0;
  const size_t partial = fa_variant(hdp).slices > 1 ? (size_t)fa_warps(hdp) * 16 * bk : 0;
  return sizeof(float) * (ring + qtile + partial);
}

// Wait for the n threads of one row group at named barrier id (barrier 0
// is __syncthreads').
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// tf32(x): x rounded to 10 mantissa bits, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x, in two integer operations (ptxas
// expands the conversion instruction into a longer sequence with a test
// for non-finite values).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a · b, one m16n8k8 tensor-core product of tf32 operands.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in three passes: lo·hi, hi·lo, then hi·hi, where b = (b0, b1).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// Asynchronous copies into shared memory; ok == false writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's copies of every group but the newest have landed.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of key rows kj0 .. kj0 + BK - 1 of K and V (one head,
// rows rs floats apart) into the shared tiles ks and vs; columns past hd
// are left alone, rows past T are zero-filled.
template <int HDP>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const float* kb, const float* vb,
                                        int kj0, int T, long long rs, int hd, bool vec) {
  constexpr int LDK = fa_k_stride(HDP), LDV = fa_v_stride(HDP);
  constexpr int BK = fa_key_tile(HDP), THREADS = 32 * fa_warps(HDP);
  constexpr int W = 4;  // floats per 16-byte copy
  if (vec) {
    if constexpr (fa_variant(HDP).rolled_copies) {
#pragma unroll 1
      for (int i = threadIdx.x; i < BK * (HDP / W); i += THREADS) {
        const int r = i / (HDP / W), c = (i % (HDP / W)) * W;
        if (c >= hd) continue;
        const bool ok = kj0 + r < T;
        const long long off = ok ? (kj0 + r) * rs + c : 0;
        cp_async16(ks + r * LDK + c, kb + off, ok);
        cp_async16(vs + r * LDV + c, vb + off, ok);
      }
    } else {
      for (int i = threadIdx.x; i < BK * (HDP / W); i += THREADS) {
        const int r = i / (HDP / W), c = (i % (HDP / W)) * W;
        if (c >= hd) continue;
        const bool ok = kj0 + r < T;
        const long long off = ok ? (kj0 + r) * rs + c : 0;
        cp_async16(ks + r * LDK + c, kb + off, ok);
        cp_async16(vs + r * LDV + c, vb + off, ok);
      }
    }
  } else {
    if constexpr (fa_variant(HDP).rolled_copies) {
#pragma unroll 1
      for (int i = threadIdx.x; i < BK * HDP; i += THREADS) {
        const int r = i / HDP, c = i % HDP;
        if (c >= hd) continue;
        const bool ok = kj0 + r < T;
        const long long off = ok ? (kj0 + r) * rs + c : 0;
        cp_async4(ks + r * LDK + c, kb + off, ok);
        cp_async4(vs + r * LDV + c, vb + off, ok);
      }
    } else {
      for (int i = threadIdx.x; i < BK * HDP; i += THREADS) {
        const int r = i / HDP, c = i % HDP;
        if (c >= hd) continue;
        const bool ok = kj0 + r < T;
        const long long off = ok ? (kj0 + r) * rs + c : 0;
        cp_async4(ks + r * LDK + c, kb + off, ok);
        cp_async4(vs + r * LDV + c, vb + off, ok);
      }
    }
  }
}

// V's B fragments of NV consecutive P·V n-tiles: b0 from the row at v0,
// b1 from the next one (one vector read each).
template <int NV>
__device__ __forceinline__ void load_v_fragments(const float* v0, int ldv, float (&b0)[NV],
                                                 float (&b1)[NV]) {
  if constexpr (NV == 4) {
    const float4 x = *reinterpret_cast<const float4*>(v0);
    const float4 y = *reinterpret_cast<const float4*>(v0 + ldv);
    b0[0] = x.x; b0[1] = x.y; b0[2] = x.z; b0[3] = x.w;
    b1[0] = y.x; b1[1] = y.y; b1[2] = y.z; b1[3] = y.w;
  } else if constexpr (NV == 2) {
    const float2 x = *reinterpret_cast<const float2*>(v0);
    const float2 y = *reinterpret_cast<const float2*>(v0 + ldv);
    b0[0] = x.x; b0[1] = x.y;
    b1[0] = y.x; b1[1] = y.y;
  } else {
    b0[0] = v0[0];
    b1[0] = v0[ldv];
  }
}

template <int HDP>
__global__ void __launch_bounds__(32 * fa_warps(HDP)) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    int S, int T, int H, int hd, int causal, float scale, int vec, int tile_base) {
  constexpr int LDK = fa_k_stride(HDP), LDV = fa_v_stride(HDP);
  constexpr int THREADS = 32 * fa_warps(HDP);
  constexpr int SLICES = fa_variant(HDP).slices;  // warps of a row group
  constexpr int BQ = fa_query_rows(HDP);  // query rows per block
  constexpr int BK = fa_key_tile(HDP);    // key rows per tile
  constexpr int NJ = BK / 8;              // n-tiles of S, k-steps of P·V
  constexpr int NT = HDP / SLICES / 8;    // the warp's k-steps of Q·Kᵀ and n-tiles of P·V
  constexpr int NV = fa_variant(HDP).pv_group;  // P·V n-tiles per vector read of V
  constexpr int QM = fa_q_mode(HDP);
  constexpr bool WIDE = fa_variant(HDP).wide;  // see "Wide heads"
  static_assert(fa_warps(HDP) % SLICES == 0 && NT % NV == 0 && (SLICES == 1 || WIDE),
                "a row group is whole warps, a P·V group whole n-tiles, and a split is wide");
  extern __shared__ float smem[];
  float* kst = smem;                    // 2 stages x BK x LDK
  float* vst = kst + 2 * BK * LDK;      // 2 stages x BK x LDV
  float* qs = vst + 2 * BK * LDV;       // FA_Q_RAW: BQ x LDK
  float* sps = qs + (QM == FA_Q_RAW ? BQ * LDK : 0);  // SLICES > 1: each warp's partial S, 16 x BK

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / SLICES;         // the warp's row group
  const int c0 = warp % SLICES * (HDP / SLICES);  // first head dim of its slice
  const int g = lane >> 2, t = lane & 3;
  const int nq = (S + BQ - 1) / BQ;
  const int qi0 = (nq - 1 - (tile_base + (int)blockIdx.y)) * BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long rs = (long long)H * hd;  // stride between sequence rows
  const float* qb = q + ((long long)b * S * H + h) * hd;
  const float* kb = k + ((long long)b * T * H + h) * hd;
  const float* vb = v + ((long long)b * T * H + h) * hd;
  float* ob = o + ((long long)b * S * H + h) * hd;
  const int wq0 = qi0 + rg * 16;  // the warp's first query row
  const int qp[2] = {wq0 + g, wq0 + g + 8};  // this lane's rows
  // scores in log2 units: exp2(s·scale·log2 e - m) = exp(s·scale - m / log2 e)
  const float scale2 = __fmul_rn(scale, FA_LOG2E);

  int nk = (T + BK - 1) / BK;
  if (causal) nk = min(nk, (qi0 + BQ - 1) / BK + 1);  // see "Causal skipping"
  if (nk > 0) load_kv<HDP>(kst, vst, kb, vb, 0, T, rs, hd, vec);
  cp_async_commit();

  // zero the padding columns hd .. HDP-1 of the four tiles (cp.async never
  // writes them)
  if constexpr (fa_variant(HDP).rolled_copies) {
#pragma unroll 1
    for (int i = tid; i < 4 * BK * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      if (c < hd) continue;
      if (r < 2 * BK) kst[r * LDK + c] = 0.0f;
      else vst[(r - 2 * BK) * LDV + c] = 0.0f;
    }
  } else {
    for (int i = tid; i < 4 * BK * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      if (c < hd) continue;
      if (r < 2 * BK) kst[r * LDK + c] = 0.0f;
      else vst[(r - 2 * BK) * LDV + c] = 0.0f;
    }
  }

  // Q·Kᵀ k-step ks reads A-column t as dim 8ks+2t and A-column t+4 as dim
  // 8ks+2t+1, in the query fragments and in K's alike (one 8-byte read)
  uint32_t qh[QM == FA_Q_REGISTERS ? NT : 1][4], ql[QM == FA_Q_REGISTERS ? NT : 1][4];
  if constexpr (QM == FA_Q_REGISTERS) {
#pragma unroll
    for (int ks = 0; ks < NT; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qp[e & 1], col = c0 + 8 * ks + 2 * t + (e >> 1);
        const float x = row < S && col < hd ? qb[row * rs + col] : 0.0f;
        split_tf32(x, qh[ks][e], ql[ks][e]);
      }
  } else if constexpr (fa_variant(HDP).rolled_copies) {
#pragma unroll 1
    for (int i = tid; i < BQ * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      qs[r * LDK + c] = qi0 + r < S && c < hd ? qb[(qi0 + r) * rs + c] : 0.0f;
    }
  } else {
    for (int i = tid; i < BQ * HDP; i += THREADS) {
      const int r = i / HDP, c = i % HDP;
      qs[r * LDK + c] = qi0 + r < S && c < hd ? qb[(qi0 + r) * rs + c] : 0.0f;
    }
  }

  float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < nk)
      load_kv<HDP>(kst + (stage ^ 1) * BK * LDK, vst + (stage ^ 1) * BK * LDV, kb, vb,
                   (kt + 1) * BK, T, rs, hd, vec);
    cp_async_commit();  // possibly empty: the wait below then still finds this tile's group
    cp_async_wait_but_newest();
    __syncthreads();  // every thread's copies of this tile have landed
    const float* ks = kst + stage * BK * LDK;
    const float* vs = vst + stage * BK * LDV;
    const int kj0 = kt * BK;
    // a key tile past the warp's last row changes nothing (see "Causal
    // skipping"); the wide variants' tiles are shorter than the block.  The
    // warps of a row group share their rows, so they skip together
    if (WIDE && causal && kj0 > wq0 + 15) {
      __syncthreads();
      continue;
    }

    // S = Q·Kᵀ for the warp's 16 rows and the tile's BK keys (NJ n-tiles),
    // over the warp's slice of the head dim
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    constexpr int KK_UNROLL = fa_variant(HDP).kk_unroll;
#pragma unroll KK_UNROLL
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      const int o0 = (rg * 16 + g) * LDK + c0 + 8 * kk + 2 * t;
      if constexpr (QM == FA_Q_REGISTERS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { ah[e] = qh[kk][e]; al[e] = ql[kk][e]; }
      } else {
        const float2 x0 = *reinterpret_cast<const float2*>(qs + o0);
        const float2 x1 = *reinterpret_cast<const float2*>(qs + o0 + 8 * LDK);
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 kv =
            *reinterpret_cast<const float2*>(ks + (8 * j + g) * LDK + c0 + 8 * kk + 2 * t);
        mma_3xtf32(s[j], ah, al, kv.x, kv.y);
      }
    }
    if constexpr (SLICES > 1) {
      // the row group's partial scores, summed in slice order 0, 1, ..., so
      // every warp of the group holds the same S (see "Head dims 257-1024");
      // the stage's closing __syncthreads keeps the buffer until all have read
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sps[(warp * NJ * 4 + 4 * j + e) * 32 + lane] = s[j][e];
      group_sync(1 + rg, 32 * SLICES);
      const float* gp = sps + rg * SLICES * NJ * 4 * 32;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = gp[(4 * j + e) * 32 + lane];
#pragma unroll
          for (int i = 1; i < SLICES; ++i)
            sum = __fadd_rn(sum, gp[(i * NJ * 4 + 4 * j + e) * 32 + lane]);
          s[j][e] = sum;
        }
    }

    // online softmax on the accumulators: lane holds keys 8j+2t, 8j+2t+1
    // of rows qp[0] (e = 0, 1) and qp[1] (e = 2, 3)
    const bool masked = kj0 + BK > T || (causal && kj0 + BK - 1 > wq0);
    float mt[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = __fmul_rn(s[j][e], scale2);
        if (masked) {
          const int kp = kj0 + 8 * j + 2 * t + (e & 1);
          if (kp >= T || (causal && qp[e >> 1] < kp)) val = FA_NEG_INF;
        }
        s[j][e] = val;
        mt[e >> 1] = fmaxf(mt[e >> 1], val);
      }
    float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL_MASK, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL_MASK, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      // guards: a row with every score masked so far keeps m = -1e30, and
      // its alpha and p must be 0, not exp(0)
      alpha[r] = m[r] == FA_NEG_INF ? 0.0f : exp2f(fminf(__fsub_rn(m[r], m_new), 0.0f));
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mr = m[e >> 1];
        const float p = mr == FA_NEG_INF ? 0.0f : exp2f(__fsub_rn(s[j][e], mr));
        s[j][e] = p;
        rsum[e >> 1] = __fadd_rn(rsum[e >> 1], p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(FULL_MASK, rsum[r], 1));
      rsum[r] = __fadd_rn(rsum[r], __shfl_xor_sync(FULL_MASK, rsum[r], 2));
      l[r] = __fmaf_rn(l[r], alpha[r], rsum[r]);
    }

    // P·V of this tile, P from the registers above with keys relabelled
    // (header); n-tile n, column c is dim dv(n, c).  Each n-tile's product
    // is summed over the tile's keys from zero, then added to the running
    // output once, rounded to nearest: the tensor core's own sums round
    // toward zero, which over thousands of tiles would drift
    if constexpr (WIDE) {
      // n-tile groups outer, keys inner: P's splits for the tile and one
      // group's products are live, not every n-tile's (see "Wide heads")
      uint32_t ph[NJ][4], pl[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split_tf32(s[j][0], ph[j][0], pl[j][0]);  // row g,   A-column t   = key 8j+2t
        split_tf32(s[j][2], ph[j][1], pl[j][1]);  // row g+8, A-column t   = key 8j+2t
        split_tf32(s[j][1], ph[j][2], pl[j][2]);  // row g,   A-column t+4 = key 8j+2t+1
        split_tf32(s[j][3], ph[j][3], pl[j][3]);  // row g+8, A-column t+4 = key 8j+2t+1
      }
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NV) {
        float pv[NV][4];
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[i][e] = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float b0[NV], b1[NV];  // column g of n-tiles n0 .. n0+NV-1, keys 8j+2t, 8j+2t+1
          load_v_fragments<NV>(vs + (8 * j + 2 * t) * LDV + c0 + NV * g + 8 * n0, LDV, b0,
                               b1);
#pragma unroll
          for (int i = 0; i < NV; ++i) mma_3xtf32(pv[i], ph[j], pl[j], b0[i], b1[i]);
        }
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n0 + i][e] = __fmaf_rn(acc[n0 + i][e], alpha[e >> 1], pv[i][e]);
      }
    } else {
      float pv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* v0 = vs + (8 * j + 2 * t) * LDV + NV * g;  // b0: key 8j+2t
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += NV) {
          float b0[NV], b1[NV];  // column g of n-tiles n0 .. n0+NV-1
          load_v_fragments<NV>(v0 + 8 * n0, LDV, b0, b1);
#pragma unroll
          for (int i = 0; i < NV; ++i) mma_3xtf32(pv[n0 + i], ph, pl, b0[i], b1[i]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = __fmaf_rn(acc[n][e], alpha[e >> 1], pv[n][e]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // c0 + dv(n, c), dv(n, c) = 8·NV·(n / NV) + NV·c + n % NV: the dim that
  // P·V n-tile n, column c stands for (V's reads of NV n-tiles are one
  // vector; c0 is the first dim of the warp's slice)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * NV * (n / NV) + NV * (2 * t + e) + n % NV;
        if (col < hd) ob[qp[r] * rs + col] = acc[n][2 * r + e] / denom;
      }
  }
}

// One launch per max_tiles query tiles (at most FA_MAX_TILES, grid.y's
// limit), heaviest causal tiles first; see "Grid".  *grids: the launches.
template <int HDP>
static int launch_hdp(const float* q, const float* k, const float* v, float* o,
                      int B, int S, int T, int H, int hd, int causal, float scale, int vec,
                      int max_tiles, int* grids, cudaStream_t stream) {
  const size_t smem = fa_shared_bytes(hd);
  int e = allow_shared_bytes(flash_attention_kernel<HDP>, smem);
  if (e != 0) return e;
  constexpr int BQ = fa_query_rows(HDP);
  const int nq = (S + BQ - 1) / BQ;
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int per = max_tiles > 0 && max_tiles < FA_MAX_TILES ? max_tiles : FA_MAX_TILES;
  for (int base = 0; base < nq; base += per) {
    const dim3 grid(B * H, min(per, nq - base));
    flash_attention_kernel<HDP><<<grid, 32 * fa_warps(HDP), smem, stream>>>(
        q, k, v, o, S, T, H, hd, causal, scale, vec, base);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    ++*grids;
  }
  return 0;
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int hd, int causal, float scale, int max_tiles, int* grids, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  const cudaStream_t s = (cudaStream_t)stream;
  *grids = 0;
  // 16-byte copies need every row of k and v on a 16-byte boundary
  const int vec = hd % 4 == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  switch (fa_padded_hd(hd)) {
    case 16:
      return launch_hdp<16>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                            grids, s);
    case 32:
      return launch_hdp<32>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                            grids, s);
    case 64:
      return launch_hdp<64>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                            grids, s);
    case 128:
      return launch_hdp<128>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                             grids, s);
    case 160:
      return launch_hdp<160>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                             grids, s);
    case 256:
      return launch_hdp<256>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                             grids, s);
    case 512:
      return launch_hdp<512>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                             grids, s);
    case 1024:
      return launch_hdp<1024>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, vec, max_tiles,
                              grids, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
