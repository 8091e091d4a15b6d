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
// the operations outweigh the bytes about 200 times.  Both products are
// float32 FMAs in the kernel body, so the function keeps float32 semantics:
// no tensor cores (TF32 would keep ~3 decimal digits), no cuBLAS.
//
// Design.  A block of 256 threads owns 64 query rows of one (batch, head)
// and streams that head's keys and values in tiles of 64 rows through
// shared memory, beside its query tile.  Thread t holds rows 4(t/16)..+3:
// for the scores it computes the 4 x 4 pairs with key columns t%16 + 16j,
// and for the output the columns t%16 + 16j of its rows (j < hd/16).  The
// 16 threads of a row group are one half-warp, so the row max and row sum
// are four xor-shuffles.  Probabilities go through shared memory (64 x 65
// floats) from the score layout to the p·v layout.  Rows of the query and
// key tiles are padded to hd + 1 floats so a half-warp's reads fall in
// distinct banks.  The TPU kernel's sequential key-block grid axis with its
// VMEM scratch becomes the key loop inside the block.  Blocks run the
// query tiles last to first, so the causal rows with the most keys start
// first.
//
// Causal skipping: key tiles that start past the block's last query row
// are not visited.  This is exact, not an approximation: every score there
// is -1e30, so the max is unchanged (alpha = 1), every p = exp(-1e30 - m)
// is 0 (or 0 by the guard when m is -1e30 too), and l and the accumulator
// keep their values.
//
// Numerics: the sources are built with -fmad=false; the products are
// written as fused multiply-adds (__fmaf_rn) on purpose.  expf and the
// final division are IEEE (no fast math).  The sums run in another order
// than the plain version's matmul and softmax, so results agree to float32
// rounding, not bit for bit.

#include "kernel_common.cuh"

#define FA_THREADS 256
#define FA_BQ 64          // query rows per block
#define FA_BK 64          // key rows per tile
#define FA_PS (FA_BK + 1) // probability row stride in shared memory
#define FA_NEG_INF -1e30f
#define FULL_MASK 0xffffffffu

// Dynamic shared memory of one block for head dim hd (the wrapper's
// shared_bytes computes the same).
__host__ __device__ inline size_t fa_shared_bytes(int hd) {
  return sizeof(float) * ((size_t)2 * FA_BQ * (hd + 1) + (size_t)FA_BK * hd + (size_t)FA_BQ * FA_PS);
}

template <int HDJ>  // output columns per thread: hd <= 16 * HDJ
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    int S, int T, int H, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;               // FA_BQ x (hd + 1)
  float* ks = qs + FA_BQ * ld;    // FA_BK x (hd + 1)
  float* vs = ks + FA_BK * ld;    // FA_BK x hd
  float* ps = vs + FA_BK * hd;    // FA_BQ x FA_PS

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = tid >> 4;  // row group: rows 4rg .. 4rg+3
  const int cg = tid & 15;  // column lane within the row group
  const int nq = (S + FA_BQ - 1) / FA_BQ;
  const int qi0 = (nq - 1 - (int)blockIdx.x) * FA_BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * hd;  // stride between sequence rows
  const float* qb = q + ((long long)b * S * H + h) * hd;
  const float* kb = k + ((long long)b * T * H + h) * hd;
  const float* vb = v + ((long long)b * T * H + h) * hd;
  float* ob = o + ((long long)b * S * H + h) * hd;

  for (int r = warp; r < FA_BQ; r += FA_THREADS / 32)
    for (int c = lane; c < hd; c += 32)
      qs[r * ld + c] = qi0 + r < S ? qb[(qi0 + r) * rs + c] : 0.0f;

  float m[4], l[4], acc[4][HDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < HDJ; ++jj) acc[i][jj] = 0.0f;
  }

  int nk = (T + FA_BK - 1) / FA_BK;
  if (causal) nk = min(nk, (qi0 + FA_BQ - 1) / FA_BK + 1);  // see "Causal skipping"
  for (int kt = 0; kt < nk; ++kt) {
    const int kj0 = kt * FA_BK;
    __syncthreads();  // the previous tile's ks, vs, ps are consumed
    for (int r = warp; r < FA_BK; r += FA_THREADS / 32) {
      const bool ok = kj0 + r < T;
      for (int c = lane; c < hd; c += 32) {
        ks[r * ld + c] = ok ? kb[(kj0 + r) * rs + c] : 0.0f;
        vs[r * hd + c] = ok ? vb[(kj0 + r) * rs + c] : 0.0f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < hd; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qi0 + rg * 4 + i;
      float mt = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kj0 + cg + 16 * j;
        float val = __fmul_rn(s[i][j], scale);
        if (kp >= T || (causal && qp < kp)) val = FA_NEG_INF;
        s[i][j] = val;
        mt = fmaxf(mt, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, off));
      const float m_new = fmaxf(m[i], mt);
      // guards: a row with every score masked so far keeps m = -1e30, and
      // its alpha and p must be 0, not exp(0)
      const float alpha = m[i] == FA_NEG_INF ? 0.0f : expf(fminf(__fsub_rn(m[i], m_new), 0.0f));
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = m_new == FA_NEG_INF ? 0.0f : expf(__fsub_rn(s[i][j], m_new));
        ps[(rg * 4 + i) * FA_PS + cg + 16 * j] = p;
        rsum = __fadd_rn(rsum, p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum = __fadd_rn(rsum, __shfl_xor_sync(FULL_MASK, rsum, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rsum);
#pragma unroll
      for (int jj = 0; jj < HDJ; ++jj) acc[i][jj] = __fmul_rn(acc[i][jj], alpha);
      m[i] = m_new;
    }
    __syncthreads();

    for (int c = 0; c < FA_BK; ++c) {
      float pv[4], vv[HDJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * FA_PS + c];
#pragma unroll
      for (int jj = 0; jj < HDJ; ++jj) {
        const int col = cg + 16 * jj;
        vv[jj] = col < hd ? vs[c * hd + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < HDJ; ++jj) acc[i][jj] = __fmaf_rn(pv[i], vv[jj], acc[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = qi0 + rg * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int jj = 0; jj < HDJ; ++jj) {
      const int col = cg + 16 * jj;
      if (col < hd) ob[qp * rs + col] = acc[i][jj] / denom;
    }
  }
}

template <int HDJ>
static int launch_hdj(const float* q, const float* k, const float* v, float* o,
                      int B, int S, int T, int H, int hd, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = fa_shared_bytes(hd);
  const int e = allow_shared_bytes(flash_attention_kernel<HDJ>, smem);
  if (e != 0) return e;
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, B * H);
  flash_attention_kernel<HDJ><<<grid, FA_THREADS, smem, stream>>>(q, k, v, o, S, T, H, hd,
                                                                 causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S, int T,
    int H, int hd, int causal, float scale, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  const cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 16) return launch_hdj<1>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, s);
  if (hd <= 32) return launch_hdj<2>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, s);
  if (hd <= 64) return launch_hdj<4>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, s);
  if (hd <= 128) return launch_hdj<8>(qf, kf, vf, of, B, S, T, H, hd, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
