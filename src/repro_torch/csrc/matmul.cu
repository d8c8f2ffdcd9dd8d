// K1: tiled matmul y(M,N) = x(M,K) @ w(K,N), bf16 in, f32 accumulate,
// bf16 out.  Replaces the TPU kernel src/repro/kernels/matmul.py
// (matmul_pallas / _matmul_kernel).
//
// Bound: at prefill (M = 2048) the products are bound by the tensor-core
// rate; at decode (M = 4) by reading w once from device memory.  Four
// variants share one tile contract: a CTA owns the (bm, bn) output tile
// the agent chose, on the reference's (M/bm, N/bn) grid.  Three are here;
// the fourth, D (f32 operands: the MoE router), is matmul_f32.cu.
//
// A. tma_wgmma (a large output grid: prefill, lm_head).  One producer
//    thread keeps TMA loads of 64-deep K slabs of x and w (128-byte
//    swizzle) in flight through a ring of STAGES buffers in dynamic shared
//    memory, each with a full and an empty mbarrier.  A stage holds KCH
//    slabs: two for the 64 x 128 CTA tile, whose 64-deep stages are too
//    little work to cover each stage's barrier round trip, one otherwise
//    (on an H100 two slabs made that tile about a fifth faster; three or
//    four, or two at larger tiles, did not help: PERF.md).  Two consumer
//    warpgroups issue wgmma m64nNk16 (bf16 -> f32) with both operands in
//    shared memory: A K-major; B MN-major with the transpose bit for
//    row-major w, K-major for the lm_head view head.T, both read in place.
//    The CTA tile is bm rounded up to a power of two, padded to 64 rows
//    for wgmma (the rows beyond bm are computed and masked), by bn rounded
//    up to a power of two >= 128; each consumer holds at most 128 f32
//    accumulators.  CTAs run grouped along M (group_m row blocks, chosen
//    so the band of x stays in L2 while w's column blocks stream once).
//    bk only bounds the ragged K edge: K is walked in order in 16-deep
//    wgmma steps, so every tile sums K in the same order.
// B. split_k (an output grid smaller than the SM count: decode, M = 4).
//    The same kernel, with K split across CTAs: bk is the unit of the
//    split (the reference's sequential k grid axis, made parallel).  CTA z
//    walks [z * k_run, (z + 1) * k_run) of K, where k_run, a whole number
//    of bk blocks and of stages, comes from the caller
//    (kernels/ops.py:matmul_launch_plan), so no stage reads into the next
//    CTA's run.  Each CTA writes its f32 partial tile to a workspace; the
//    last CTA of a tile (an atomic counter that resets itself) sums the
//    partials in order of k and writes bf16.  One launch a call.
// C. unaligned (an operand TMA cannot take: a row pitch or pointer not a
//    multiple of 16 bytes).  The first version's loop: 32-wide K sub-slabs
//    staged through static shared memory, mma.sync m16n8k16.  No model
//    path takes it.
// D. f32 (float32 operands, f32 out): FFMA with K split by K alone over
//    a thread-block cluster; its own source, matmul_f32.cu.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// C. unaligned operands
// ---------------------------------------------------------------------------

constexpr int KS = 32;         // K sub-slab staged per shared-memory pass
constexpr int KPAD = KS + 8;   // row pitch in shared memory (bank spread)
constexpr int THREADS_C = 256;

template <int BM, int BN, bool B_COL>
__global__ void __launch_bounds__(THREADS_C, 1)
matmul_unaligned_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, int M, int N, int K,
                        long long lda, long long swk, long long swn,
                        int bm_step, int bn_step, int bk_step, int vec_a,
                        int vec_b) {
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
      for (int v = tid; v < BM * (KS / 8); v += THREADS_C) {
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
        for (int v = tid; v < BN * (KS / 8); v += THREADS_C) {
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
        for (int v = tid; v < KS * (BN / 8); v += THREADS_C) {
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
cudaError_t launch_unaligned(bool b_col, const __nv_bfloat16* x,
                             const __nv_bfloat16* w, __nv_bfloat16* y, int M,
                             int N, int K, long long lda, long long swk,
                             long long swn, int bm, int bn, int bk, int vec_a,
                             int vec_b, cudaStream_t stream) {
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  if (b_col)
    matmul_unaligned_kernel<BM, BN, true><<<grid, THREADS_C, 0, stream>>>(
        x, w, y, M, N, K, lda, swk, swn, bm, bn, bk, vec_a, vec_b);
  else
    matmul_unaligned_kernel<BM, BN, false><<<grid, THREADS_C, 0, stream>>>(
        x, w, y, M, N, K, lda, swk, swn, bm, bn, bk, vec_a, vec_b);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// A and B. TMA + wgmma pipeline, optionally split over K
// ---------------------------------------------------------------------------

constexpr int BK = 64;                 // K depth of one slab (128 bytes)
constexpr int THREADS_TMA = 384;       // 2 consumer warpgroups + producer
constexpr int CONSUMER_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;     // bytes a block may use on sm_90
constexpr int MAX_STAGES = 8;

template <int ROWS_P, int COLS, bool B_KMAJOR>
struct TmaCfg {
  // ROWS_P == 64: the two warpgroups split the columns; otherwise the rows
  static constexpr int MT = ROWS_P == 256 ? 2 : 1;      // m64 tiles a WG
  static constexpr int WN = ROWS_P == 64 ? COLS / 2 : COLS;
  static constexpr int KCH = ROWS_P * COLS < 128 * 128 ? 2 : 1;  // slabs
  static constexpr int KS = KCH * BK;                   // K a stage holds
  static constexpr int A_SLAB = ROWS_P * BK * 2;
  static constexpr int B_SLAB = COLS * BK * 2;
  static constexpr int A_BYTES = KCH * A_SLAB;          // x, then w
  static constexpr int B_BYTES = KCH * B_SLAB;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - 512) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + 1024;    // + 1 KB alignment
  static_assert(STAGES >= 2, "a stage does not fit twice");
  static_assert(MT * WN / 2 <= 128, "more than 128 accumulators a thread");
};

// Tile `tile` of the grid, grouped along M: group_m row blocks at a time,
// row blocks fastest.
__device__ __forceinline__ void tile_coords(int tile, int grid_m, int grid_n,
                                            int group_m, int& mb, int& nb) {
  const int group = group_m * grid_n;
  const int first = (tile / group) * group_m;
  const int gm = min(grid_m - first, group_m);
  const int local = tile % group;
  mb = first + local % gm;
  nb = local / gm;
}

template <int ROWS_P, int COLS, bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS_TMA, 1)
matmul_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                  int* __restrict__ counters, int M, int N, int K,
                  int bm_step, int bn_step, int k_run, int grid_m,
                  int grid_n, int group_m, int splits, int a_rows) {
  using C = TmaCfg<ROWS_P, COLS, B_KMAJOR>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  __shared__ int is_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  int mb, nb;
  tile_coords(tile, grid_m, grid_n, group_m, mb, nb);
  const int m0 = mb * bm_step, n0 = nb * bn_step;
  // this CTA's run of K (all of it when splits == 1)
  const int z = blockIdx.y;
  const int k_lo = z * k_run;
  const int k_hi = min(K, k_lo + k_run);
  const int nk = k_hi > k_lo ? (k_hi - k_lo + C::KS - 1) / C::KS : 0;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS / 32);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (a_rows < ROWS_P) {   // rows TMA never writes: zero them once
    for (int s = 0; s < C::STAGES * C::KCH; ++s) {
      uint4* a = reinterpret_cast<uint4*>(smem + (s / C::KCH) * C::STAGE +
                                          (s % C::KCH) * C::A_SLAB);
      for (int v = a_rows * 8 + tid; v < ROWS_P * 8; v += THREADS_TMA)
        a[v] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const int tx = C::KCH * (a_rows * BK * 2 + C::B_SLAB);
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(&empty[s], ((i / C::STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], tx);
#pragma unroll
        for (int c = 0; c < C::KCH; ++c) {
          uint8_t* a = smem + s * C::STAGE + c * C::A_SLAB;
          uint8_t* b = smem + s * C::STAGE + C::A_BYTES + c * C::B_SLAB;
          const int k = k_lo + i * C::KS + c * BK;
          tma_load_2d(a, &map_x, k, m0, &full[s]);
          if constexpr (B_KMAJOR) {
            constexpr int BOXN = COLS < 256 ? COLS : 256;  // TMA's box limit
#pragma unroll
            for (int j = 0; j < COLS / BOXN; ++j)
              tma_load_2d(b + j * BOXN * 128, &map_w, k, n0 + j * BOXN,
                          &full[s]);
          } else {
#pragma unroll
            for (int j = 0; j < COLS / 64; ++j)
              tma_load_2d(b + j * 8192, &map_w, n0 + j * 64, k, &full[s]);
          }
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups of wgmma ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int MT = C::MT, WN = C::WN;
    const int rbase = ROWS_P == 64 ? 0 : wg * (ROWS_P / 2);
    const int cbase = ROWS_P == 64 ? wg * WN : 0;
    const uint32_t a_off = rbase * 128;
    const uint32_t b_off = B_KMAJOR ? cbase * 128 : (cbase / 64) * 8192;
    float acc[MT][WN / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) acc[i][e] = 0.f;

    const int lane = tid & 31;
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + s * C::STAGE) + a_off;
      const uint32_t b_addr = smem_u32(smem + s * C::STAGE + C::A_BYTES) +
                              b_off;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < C::KS / 16; ++q) {
        const int c = q / (BK / 16), kk = q % (BK / 16);   // slab, k16 step
        const uint32_t ac = a_addr + c * C::A_SLAB;
        const uint32_t bc = b_addr + c * C::B_SLAB;
        const uint64_t db =
            B_KMAJOR ? make_desc(bc + kk * 32, 16, 1024)
                     : make_desc(bc + kk * 2048, 8192, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_tile<WN, B_KMAJOR ? 0 : 1>(
              acc[mt], make_desc(ac + mt * 8192 + kk * 32, 16, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();     // the previous stage's products are done
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < WN / 2; ++e) fence_operand(acc[i][e]);

    // ---- epilogue: the wgmma accumulator layout, masked to the tile ----
    const int row_end = min(M, m0 + bm_step), col_end = min(N, n0 + bn_step);
    const int wr = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int wc = 2 * (lane & 3);
    const bool pair = (N % 2) == 0;
    float* part = ws + (size_t)z * M * N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + rbase + mt * 64 + wr + 8 * h;
          const int c = n0 + cbase + j * 8 + wc;
          if (r >= row_end) continue;
          const float v0 = acc[mt][4 * j + 2 * h];
          const float v1 = acc[mt][4 * j + 2 * h + 1];
          const size_t o = (size_t)r * N + c;
          if (splits == 1) {
            if (pair && c + 1 < col_end) {
              *reinterpret_cast<__nv_bfloat162*>(y + o) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (c < col_end) y[o] = __float2bfloat16(v0);
              if (c + 1 < col_end) y[o + 1] = __float2bfloat16(v1);
            }
          } else {
            if (pair && c + 1 < col_end) {
              *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
            } else {
              if (c < col_end) part[o] = v0;
              if (c + 1 < col_end) part[o + 1] = v1;
            }
          }
        }
      }
    }

    if (splits > 1) {
      // the last CTA of this tile sums the partials in order of k
      __threadfence();
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
      if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
      if (is_last) {
        __threadfence();
        const int rows_v = row_end - m0, cols_v = col_end - n0;
        for (int e = tid; e < rows_v * cols_v; e += CONSUMER_THREADS) {
          const size_t o = (size_t)(m0 + e / cols_v) * N + n0 + e % cols_v;
          float sum = 0.f;
          for (int q = 0; q < splits; ++q)
            sum += __ldcg(ws + (size_t)q * M * N + o);
          y[o] = __float2bfloat16(sum);
        }
        if (tid == 0) counters[tile] = 0;     // ready for the next call
      }
    }
  }
}

template <int ROWS_P, int COLS, bool B_KMAJOR>
cudaError_t launch_tma(const CUtensorMap& mx, const CUtensorMap& mw,
                       __nv_bfloat16* y, float* ws, int* counters, int M,
                       int N, int K, int bm, int bn, int k_run, int grid_m,
                       int grid_n, int group_m, int splits, int a_rows,
                       cudaStream_t stream) {
  using C = TmaCfg<ROWS_P, COLS, B_KMAJOR>;
  if (splits > 1 && k_run % C::KS != 0) return cudaErrorInvalidValue;
  auto kernel = matmul_tma_kernel<ROWS_P, COLS, B_KMAJOR>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(grid_m * grid_n, splits);
  kernel<<<grid, THREADS_TMA, C::SMEM, stream>>>(
      mx, mw, y, ws, counters, M, N, K, bm, bn, k_run, grid_m, grid_n,
      group_m, splits, a_rows);
  return cudaGetLastError();
}

}  // namespace

// C entry point of variants A and B.  (bm, bn) are the effective
// (clamped) tiles and the CTA strides; k_run the K each of the `splits`
// CTAs of a tile walks; (rows, cols) the power-of-two CTA tile covering
// them; ld_w the stride of w's non-unit dimension (its rows when w_kmajor
// is 0, its columns when 1); ws a (splits, M, N) f32 workspace and
// counters grid_m * grid_n ints at zero when splits > 1.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a CTA
// tile that is not compiled or a split whose runs are not whole stages
// (64 or 128 deep) that cover K, or cudaErrorNotSupported when the tensor
// maps cannot be made.
extern "C" int repro_matmul_tma_bf16(const void* x, const void* w, void* y,
                                     void* ws, void* counters, int M, int N,
                                     int K, long long lda, long long ld_w,
                                     int w_kmajor, int bm, int bn, int k_run,
                                     int rows, int cols, int grid_m,
                                     int grid_n, int group_m, int splits,
                                     void* stream) {
  if (splits < 1 || (long long)splits * k_run < K ||
      (splits > 1 && (splits - 1) * k_run >= K))
    return (int)cudaErrorInvalidValue;
  const int rows_p = rows < 64 ? 64 : rows;
  const int boxn = cols < 256 ? cols : 256;
  CUtensorMap mx, mw;
  if (!make_map(&mx, x, K, M, lda, BK, rows)) return (int)cudaErrorNotSupported;
  const bool ok = w_kmajor ? make_map(&mw, w, K, N, ld_w, BK, boxn)
                           : make_map(&mw, w, N, K, ld_w, 64, BK);
  if (!ok) return (int)cudaErrorNotSupported;
  auto ys = static_cast<__nv_bfloat16*>(y);
  auto wss = static_cast<float*>(ws);
  auto cs = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_TMA_CASE(R_, C_)                                              \
  if (rows_p == R_ && cols == C_)                                           \
    return (int)(w_kmajor                                                   \
                     ? launch_tma<R_, C_, true>(mx, mw, ys, wss, cs, M, N,  \
                                                K, bm, bn, k_run, grid_m,   \
                                                grid_n, group_m, splits,    \
                                                rows, st)                   \
                     : launch_tma<R_, C_, false>(mx, mw, ys, wss, cs, M, N, \
                                                 K, bm, bn, k_run, grid_m,  \
                                                 grid_n, group_m, splits,   \
                                                 rows, st));
  REPRO_TMA_CASE(64, 128)
  REPRO_TMA_CASE(64, 256)
  REPRO_TMA_CASE(64, 512)
  REPRO_TMA_CASE(128, 128)
  REPRO_TMA_CASE(128, 256)
  REPRO_TMA_CASE(256, 128)
#undef REPRO_TMA_CASE
  return (int)cudaErrorInvalidValue;
}

// C entry point of variant C.  (bm, bn, bk) are the effective (clamped)
// tiles and the CTA strides; (bm_k, bn_k) the compiled CTA tile that covers
// them (bm_k at least 16, the mma.sync row minimum).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a compiled tile that does not exist.
extern "C" int repro_matmul_unaligned_bf16(const void* x, const void* w,
                                           void* y, int M, int N, int K,
                                           long long lda, long long swk,
                                           long long swn, int bm, int bn,
                                           int bk, int bm_k, int bn_k,
                                           int vec_a, int vec_b,
                                           void* stream) {
  const bool b_col = (swk == 1 && swn != 1);
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto ws = static_cast<const __nv_bfloat16*>(w);
  auto ys = static_cast<__nv_bfloat16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_MM_CASE(BM_, BN_)                                            \
  if (bm_k == BM_ && bn_k == BN_)                                          \
    return (int)launch_unaligned<BM_, BN_>(b_col, xs, ws, ys, M, N, K, lda, \
                                           swk, swn, bm, bn, bk, vec_a,     \
                                           vec_b, st);
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
