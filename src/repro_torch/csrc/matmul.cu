// K1: tiled matmul y(M,N) = x(M,K) @ w(K,N), bf16 in, f32 accumulate,
// bf16 out.  Replaces the TPU kernel src/repro/kernels/matmul.py
// (matmul_pallas / _matmul_kernel).
//
// Tile semantics.  A CTA owns one (bm, bn) output tile and walks K in
// steps of bk; each bk step is streamed through shared memory in fixed
// sub-slabs of KS = 32, so any bk fits (bk = 512 as a whole slab would need
// 256 KB).  The CTA's row tile is BM = bm rounded up to a power of two and
// at least 16 (the mma row minimum), its column tile BN = bn rounded up to
// a power of two >= 128; rows beyond the tuned bm (and beyond M) and
// columns beyond bn (and N) are masked, never padded in memory.  The f32
// accumulator lives in registers: BM * BN <= 128 * 256 (128 floats a
// thread at 256 threads), the limit kernels/ops.py:tile_ok enforces.
//
// w is read through its strides: row-major weights (stride_n == 1) and the
// transposed lm_head view (stride_k == 1) both go without a copy.
//
// Bound: at prefill (M = 2048) the products are compute-bound on the
// tensor cores; at decode (M = 4) they are bound by reading w once.  This
// first version uses mma.sync with single-buffered shared-memory staging;
// wgmma, TMA and a multi-stage pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int KS = 32;         // K sub-slab staged per shared-memory pass
constexpr int KPAD = KS + 8;   // row pitch in shared memory (bank spread)
constexpr int THREADS = 256;

template <int BM, int BN, bool B_COL>
__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ y, int M, int N, int K,
              long long lda, long long swk, long long swn, int bm_step,
              int bn_step, int bk_step, int vec_a, int vec_b) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT >= 1, "tile too small for the warp layout");

  __shared__ __align__(16) __nv_bfloat16 As[BM][KPAD];
  __shared__ __align__(16) __nv_bfloat16 Bt[BN][KPAD];   // Bt[n][k]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * bm_step, n0 = blockIdx.x * bn_step;
  const int row_end = min(M, m0 + bm_step);
  const int col_end = min(N, n0 + bn_step);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int kb = 0; kb < K; kb += bk_step) {
    const int kend = min(K, kb + bk_step);
    for (int k0 = kb; k0 < kend; k0 += KS) {
      // ---- stage A: BM x KS ----
      for (int v = tid; v < BM * (KS / 8); v += THREADS) {
        const int r = v / (KS / 8), kc = (v % (KS / 8)) * 8;
        const int gm = m0 + r, gk = k0 + kc;
        __nv_bfloat16* dst = &As[r][kc];
        if (gm < row_end && vec_a && gk + 8 <= kend) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(x + gm * lda + gk);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (gm < row_end && gk + e < kend) ? x[gm * lda + gk + e]
                                                     : zero;
        }
      }
      // ---- stage B transposed: Bt[n][k] for BN x KS ----
      if (B_COL) {   // w[k][n] at k + n*swn: contiguous along k
        for (int v = tid; v < BN * (KS / 8); v += THREADS) {
          const int n = v / (KS / 8), kc = (v % (KS / 8)) * 8;
          const int gn = n0 + n, gk = k0 + kc;
          __nv_bfloat16* dst = &Bt[n][kc];
          if (gn < col_end && vec_b && gk + 8 <= kend) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(w + gn * swn + gk);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dst[e] = (gn < col_end && gk + e < kend)
                           ? w[gn * swn + (gk + e) * swk]
                           : zero;
          }
        }
      } else {       // w[k][n] at k*swk + n: contiguous along n
        for (int v = tid; v < KS * (BN / 8); v += THREADS) {
          const int k = v / (BN / 8), nc = (v % (BN / 8)) * 8;
          const int gk = k0 + k, gn = n0 + nc;
          __nv_bfloat16 vals[8];
          if (gk < kend && vec_b && gn + 8 <= col_end) {
            *reinterpret_cast<uint4*>(vals) =
                *reinterpret_cast<const uint4*>(w + gk * swk + gn);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              vals[e] = (gk < kend && gn + e < col_end)
                            ? w[gk * swk + (gn + e) * swn]
                            : zero;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) Bt[nc + e][k] = vals[e];
        }
      }
      __syncthreads();

      // ---- tensor-core products over the sub-slab ----
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm * WM + i * 16 + g;
          a[i][0] = ld_u32(&As[r][kk + 2 * t]);
          a[i][1] = ld_u32(&As[r + 8][kk + 2 * t]);
          a[i][2] = ld_u32(&As[r][kk + 2 * t + 8]);
          a[i][3] = ld_u32(&As[r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wn * WN + j * 8 + g;
          const uint32_t b0 = ld_u32(&Bt[c][kk + 2 * t]);
          const uint32_t b1 = ld_u32(&Bt[c][kk + 2 * t + 8]);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16_16816(acc[i][j], a[i], b0, b1);
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: f32 -> bf16, masked to the tuned tile and the matrix ----
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = m0 + wm * WM + i * 16 + g;
      const int c = n0 + wn * WN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= row_end) continue;
        if (c < col_end)
          y[(long long)rr * N + c] = __float2bfloat16(acc[i][j][2 * h]);
        if (c + 1 < col_end)
          y[(long long)rr * N + c + 1] = __float2bfloat16(acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch(bool b_col, const __nv_bfloat16* x, const __nv_bfloat16* w,
                   __nv_bfloat16* y, int M, int N, int K, long long lda,
                   long long swk, long long swn, int bm, int bn, int bk,
                   int vec_a, int vec_b, cudaStream_t stream) {
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  if (b_col)
    matmul_kernel<BM, BN, true><<<grid, THREADS, 0, stream>>>(
        x, w, y, M, N, K, lda, swk, swn, bm, bn, bk, vec_a, vec_b);
  else
    matmul_kernel<BM, BN, false><<<grid, THREADS, 0, stream>>>(
        x, w, y, M, N, K, lda, swk, swn, bm, bn, bk, vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// C entry point.  (bm, bn, bk) are the effective (clamped) tiles and the
// CTA strides; (bm_k, bn_k) the compiled CTA tile that covers them.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a compiled tile that does not exist.
extern "C" int repro_matmul_bf16(const void* x, const void* w, void* y, int M,
                                 int N, int K, long long lda, long long swk,
                                 long long swn, int bm, int bn, int bk,
                                 int bm_k, int bn_k, int vec_a, int vec_b,
                                 void* stream) {
  const bool b_col = (swk == 1 && swn != 1);
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto ws = static_cast<const __nv_bfloat16*>(w);
  auto ys = static_cast<__nv_bfloat16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_MM_CASE(BM_, BN_)                                             \
  if (bm_k == BM_ && bn_k == BN_)                                           \
    return (int)launch<BM_, BN_>(b_col, xs, ws, ys, M, N, K, lda, swk, swn, \
                                 bm, bn, bk, vec_a, vec_b, st);
  REPRO_MM_CASE(16, 128)
  REPRO_MM_CASE(16, 256)
  REPRO_MM_CASE(16, 512)
  REPRO_MM_CASE(32, 128)
  REPRO_MM_CASE(32, 256)
  REPRO_MM_CASE(32, 512)
  REPRO_MM_CASE(64, 128)
  REPRO_MM_CASE(64, 256)
  REPRO_MM_CASE(64, 512)
  REPRO_MM_CASE(128, 128)
  REPRO_MM_CASE(128, 256)
  REPRO_MM_CASE(256, 128)
#undef REPRO_MM_CASE
  return (int)cudaErrorInvalidValue;
}
