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
//    The CTA tile is bm rounded up to a power of two of at least 16 rows
//    by bn rounded up to a power of two >= 128; each consumer holds at most
//    128 f32 accumulators.  CTAs run grouped along M (group_m row blocks,
//    chosen so the band of x stays in L2 while w's column blocks stream
//    once).  bk only bounds the ragged K edge: K is walked in order in
//    16-deep wgmma steps, so every tile sums K in the same order.
//    CTA tiles of 16 and 32 rows (bm 8, 16, 32) run a kernel of their own,
//    matmul_swap_kernel.  wgmma's M is 64, and at such a tile the bytes a
//    CTA takes in (16 KB of w beside 4 KB of x a 64-deep slab at 32 x
//    128), not the tensor cores, set the time.  (1) The operands are
//    swapped: y^T = w^T x^T with wgmma m64nRk16, R = 16 or 32 the CTA's
//    rows as wgmma's N; A is the w tile (MN-major with the transpose bit
//    for row-major w, K-major for head.T), B the R x 64 x slab, so no row
//    is padded; each consumer warpgroup takes bn / 2 columns (1, 2 or 4
//    m64 tiles, at most 64 accumulators a thread), releases each stage as
//    soon as its products are done, and the epilogue stages y^T through
//    the drained ring into rows of y.  (2) Two or three CTAs an SM (the
//    plan's occupancy), each with an equal share of shared memory: a
//    CTA's products form one dependent wgmma chain a m64 tile, and
//    several CTAs' chains, loads and epilogues overlap; the plan groups
//    all row blocks (group_m = grid_m), so the column blocks of w in
//    flight stay few and in L2.  (3) A thread-block cluster of 2 CTAs
//    (consecutive row blocks of one column block) can share each slab of
//    a row-major w: each CTA issues every other 64-column box of it as a
//    multicast TMA load, a stage is refilled only after every consumer
//    warp of both CTAs has released it (remote mbarrier arrives), and
//    the kernel ends on a cluster barrier.  Each SM still takes in the
//    whole slab, and the two CTAs wait on each other, so on an H100 the
//    cluster paid only at long K: the plan (kernels/ops.py) takes it for
//    the 32 x 128 tile at three CTAs an SM and K >= 6144, where it ran
//    6-19% faster, and not at K = 4096, where it was slower or mixed;
//    clusters of 4 and 8 ran slower still (tools/k1_probe.py; PERF.md).
//    The plan never merges row tiles: the agent's (bm, bn) grid stays.
// B. split_k (an output grid smaller than the SM count: decode, M = 4).
//    The same kernels (the swapped one at 16 and 32 rows, C = 1), with K
//    split across CTAs: bk is the unit of the
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

template <int ROWS, int COLS, bool B_KMAJOR>
struct TmaCfg {
  // ROWS == 64: the two warpgroups split the columns; otherwise the rows
  static constexpr int MT = ROWS == 256 ? 2 : 1;      // m64 tiles a WG
  static constexpr int WN = ROWS == 64 ? COLS / 2 : COLS;
  static constexpr int KCH = ROWS * COLS < 128 * 128 ? 2 : 1;  // slabs
  static constexpr int KS = KCH * BK;                   // K a stage holds
  static constexpr int A_SLAB = ROWS * BK * 2;
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

// CTA `tile` of the grid, in clusters of csize consecutive CTAs: a cluster
// is csize consecutive row blocks of one column block (its rank the row
// block within), clusters grouped along M (group_m row blocks, a multiple
// of csize, at a time), row clusters fastest; csize 1 (rows of 64 and
// more, and every split) is row blocks grouped along M, row blocks
// fastest.  kernels/ops.py:matmul_cta_tiles mirrors it.
__device__ __forceinline__ void cluster_tile_coords(int tile, int grid_m,
                                                    int grid_n, int group_m,
                                                    int csize, int& mb,
                                                    int& nb) {
  const int cl = tile / csize, rank = tile % csize;
  const int grid_mc = (grid_m + csize - 1) / csize;
  const int group_c = group_m / csize;
  const int group = group_c * grid_n;
  const int first = (cl / group) * group_c;
  const int gc = min(grid_mc - first, group_c);
  const int local = cl % group;
  mb = (first + local % gc) * csize + rank;
  nb = local / gc;
}

template <int ROWS, int COLS, bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS_TMA, 1)
matmul_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                  int* __restrict__ counters, int M, int N, int K,
                  int bm_step, int bn_step, int k_run, int grid_m,
                  int grid_n, int group_m, int splits) {
  using C = TmaCfg<ROWS, COLS, B_KMAJOR>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  __shared__ int is_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  int mb, nb;
  cluster_tile_coords(tile, grid_m, grid_n, group_m, 1, mb, nb);
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
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      const int tx = C::KCH * (C::A_SLAB + C::B_SLAB);
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
    const int rbase = ROWS == 64 ? 0 : wg * (ROWS / 2);
    const int cbase = ROWS == 64 ? wg * WN : 0;
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

template <int ROWS, int COLS, bool B_KMAJOR>
cudaError_t launch_tma(const CUtensorMap& mx, const CUtensorMap& mw,
                       __nv_bfloat16* y, float* ws, int* counters, int M,
                       int N, int K, int bm, int bn, int k_run, int grid_m,
                       int grid_n, int group_m, int splits,
                       cudaStream_t stream) {
  using C = TmaCfg<ROWS, COLS, B_KMAJOR>;
  if (splits > 1 && k_run % C::KS != 0) return cudaErrorInvalidValue;
  auto kernel = matmul_tma_kernel<ROWS, COLS, B_KMAJOR>;
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
      group_m, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// A and B at CTA tiles of 16 and 32 rows: the operands swapped, w multicast
// over a thread-block cluster along M
// ---------------------------------------------------------------------------

constexpr int SM_SMEM = 233472;        // shared memory of an H100 SM
constexpr int CTA_RESERVED = 1024;     // of it the runtime keeps a CTA

template <int R, int COLS, bool W_KMAJOR, int OCC_>
struct SwapCfg {
  // R: the CTA's rows of y, wgmma's N; each consumer warpgroup takes
  // COLS / 2 columns of y, MT m64 tiles of w^T
  static constexpr int MT = COLS / 128;
  // OCC CTAs an SM (the plan's occupancy).  A CTA's products over K form
  // one dependent chain of wgmma a m64 tile, too narrow at these N to
  // keep the tensor cores busy alone: two or three CTAs' chains
  // interleave, and one's loads and epilogue overlap another's
  // products.  Each takes an equal share of the SM's shared memory
  // (all of a block's where OCC is 1) for the deepest ring that fits;
  // at three, a stage holds one slab.
  static constexpr int OCC = OCC_;
  static constexpr int KCH = COLS == 128 && OCC < 3 ? 2 : 1;  // slabs a stage
  static constexpr int KS = KCH * BK;                    // K a stage holds
  static constexpr int W_SLAB = COLS * BK * 2;           // A: w^T
  static constexpr int X_SLAB = R * BK * 2;              // B: x^T
  static constexpr int W_BYTES = KCH * W_SLAB;           // w, then x
  static constexpr int STAGE = W_BYTES + KCH * X_SLAB;
  static constexpr int BUDGET = OCC > 1
      ? SM_SMEM / OCC - CTA_RESERVED - 1024 - 256 : SMEM_LIMIT - 1024 - 512;
  static constexpr int FIT = BUDGET / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE + 1024;     // + 1 KB alignment
  // registers a thread: at 2 (3) CTAs an SM 80 (56) at launch, the
  // producer gives up all but 24, the consumers take 104 (72)
  static constexpr int REG_PRODUCER = OCC > 1 ? 24 : 40;
  static constexpr int REG_CONSUMER = OCC == 3 ? 72 : OCC == 2 ? 104 : 232;
  // the epilogue's staging of the (R x COLS) tile, rows padded by 16
  // bytes (the pairs of 4 lanes land in 4 bank groups): f32 when split
  static constexpr int PITCH_H = COLS + 8;               // bf16 elements
  static constexpr int PITCH_F = COLS + 4;               // f32 elements
  static_assert(STAGES >= 2, "a stage does not fit twice");
  static_assert(R * PITCH_F * 4 <= STAGES * STAGE, "staging exceeds the ring");
  static_assert(MT * R / 2 <= 64, "more than 64 accumulators a thread");
};

// y^T = w^T x^T (A above): wgmma m64nRk16 with A the w tile (MN-major,
// transposed, for a row-major w; K-major for head.T) and B the R x 64 x
// slab (K-major).  In a cluster of 2 (a row-major w) each CTA issues
// every other 64-column box of each w slab, multicast to both, and its
// own x slab; a stage is refilled only when every consumer warp of both
// CTAs has released it.  The accumulator holds y^T, so the epilogue stages the
// tile through the drained ring and writes rows of y with 16-byte stores.
template <int R, int COLS, bool W_KMAJOR, int OCC>
__global__ void __launch_bounds__(THREADS_TMA, OCC)
matmul_swap_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   int* __restrict__ counters, int M, int N, int K,
                   int bm_step, int bn_step, int k_run, int grid_m,
                   int grid_n, int group_m, int splits, int csize) {
  using C = SwapCfg<R, COLS, W_KMAJOR, OCC>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  __shared__ int is_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  int mb, nb;
  cluster_tile_coords(tile, grid_m, grid_n, group_m, csize, mb, nb);
  const uint32_t rank = csize > 1 ? cluster_ctarank() : 0;
  const int m0 = mb * bm_step, n0 = nb * bn_step;
  const int z = blockIdx.y;
  const int k_lo = z * k_run;
  const int k_hi = min(K, k_lo + k_run);
  const int nk = k_hi > k_lo ? (k_hi - k_lo + C::KS - 1) / C::KS : 0;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      // one arrive a consumer warp of each CTA of the cluster
      mbar_init(&empty[s], (CONSUMER_THREADS / 32) * csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (csize > 1) cluster_sync();   // the peers' barriers are initialised

  const int wg = tid / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        C::REG_PRODUCER));
    if (tid == 256) {
      const int tx = C::KCH * (C::W_SLAB + C::X_SLAB);
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      for (int i = 0; i < nk; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) mbar_wait(&empty[s], ((i / C::STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], tx);    // x and the whole w slab
#pragma unroll
        for (int c = 0; c < C::KCH; ++c) {
          uint8_t* a = smem + s * C::STAGE + c * C::W_SLAB;
          uint8_t* b = smem + s * C::STAGE + C::W_BYTES + c * C::X_SLAB;
          const int k = k_lo + i * C::KS + c * BK;
          tma_load_2d(b, &map_x, k, m0, &full[s]);
          if constexpr (W_KMAJOR) {
            // COLS rows of 128 bytes (64 k), in boxes of at most 256 rows
            // (TMA's limit); no cluster
            constexpr int box = COLS < 256 ? COLS : 256;
#pragma unroll
            for (int r0 = 0; r0 < COLS; r0 += box)
              tma_load_2d(a + r0 * 128, &map_w, k, n0 + r0, &full[s]);
          } else {
            // COLS / 64 boxes of 64 k rows (8 KB); in a cluster of 2 this
            // CTA's every other one (the loop unrolled: a loop over this
            // CTA's boxes alone issued them about a sixth slower)
#pragma unroll
            for (int j = 0; j < COLS / 64; ++j) {
              if (csize == 1)
                tma_load_2d(a + j * 8192, &map_w, n0 + j * 64, k, &full[s]);
              else if (j % csize == (int)rank)
                tma_load_2d_multicast(a + j * 8192, &map_w, n0 + j * 64, k,
                                      &full[s], mask);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups of wgmma, COLS / 2 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        C::REG_CONSUMER));
    constexpr int MT = C::MT;
    // half the w slab either way: COLS / 2 rows of 128 bytes, or
    // COLS / 128 boxes of 8 KB
    const uint32_t a_off = wg * (COLS / 2) * 128;
    float acc[MT][R / 2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < R / 2; ++e) acc[i][e] = 0.f;

    const int lane = tid & 31;
    for (int i = 0; i < nk; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + s * C::STAGE) + a_off;
      const uint32_t b_addr = smem_u32(smem + s * C::STAGE + C::W_BYTES);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < C::KS / 16; ++q) {
        const int c = q / (BK / 16), kk = q % (BK / 16);   // slab, k16 step
        const uint32_t ac = a_addr + c * C::W_SLAB;
        const uint64_t db = make_desc(b_addr + c * C::X_SLAB + kk * 32, 16,
                                      1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint64_t da =
              W_KMAJOR ? make_desc(ac + mt * 8192 + kk * 32, 16, 1024)
                       : make_desc(ac + mt * 8192 + kk * 2048, 8192, 1024);
          wgmma_narrow<R, W_KMAJOR ? 0 : 1, 0>(acc[mt], da, db);
        }
      }
      wgmma_commit();
      // this stage's products are done: release it at once (a chain
      // cannot start the next stage's products before then anyway)
      wgmma_wait<0>();
      if (lane == 0) {
        if (csize > 1) {
          for (int p = 0; p < csize; ++p) mbar_arrive_cluster(&empty[s], p);
        } else {
          mbar_arrive(&empty[s]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < R / 2; ++e) fence_operand(acc[i][e]);

    // ---- epilogue: y^T's accumulator layout into rows of y ----
    // the ring has drained (every load into it was waited for): both
    // warpgroups' products are done before either overwrites it
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
    const int row_end = min(M, m0 + bm_step), col_end = min(N, n0 + bn_step);
    const int rows_v = row_end - m0;
    const int warp = (tid & 127) >> 5;
    // a thread's value (mt, j, h, e): column n of y (wgmma's row), row m
    // of y (wgmma's column)
    const int nbase = wg * (COLS / 2) + warp * 16 + (lane >> 2);
    const int mbase = 2 * (lane & 3);
    __nv_bfloat16* st_h = reinterpret_cast<__nv_bfloat16*>(smem);
    float* st_f = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = nbase + mt * 64 + 8 * h, m = j * 8 + mbase + e;
            const float v = acc[mt][4 * j + 2 * h + e];
            if (splits == 1)
              st_h[m * C::PITCH_H + n] = __float2bfloat16(v);
            else
              st_f[m * C::PITCH_F + n] = v;
          }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
    if (splits == 1) {
      const bool vec = (N % 8) == 0;
      for (int v = tid; v < R * (COLS / 8); v += CONSUMER_THREADS) {
        const int r = v / (COLS / 8), c = (v % (COLS / 8)) * 8;
        if (r >= rows_v) continue;
        const int gn = n0 + c;
        const __nv_bfloat16* src = st_h + r * C::PITCH_H + c;
        __nv_bfloat16* dst = y + (size_t)(m0 + r) * N + gn;
        if (vec && gn + 8 <= col_end) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8; ++e)
            if (gn + e < col_end) dst[e] = src[e];
        }
      }
    } else {
      const bool vec = (N % 4) == 0;
      float* part = ws + (size_t)z * M * N;
      for (int v = tid; v < R * (COLS / 4); v += CONSUMER_THREADS) {
        const int r = v / (COLS / 4), c = (v % (COLS / 4)) * 4;
        if (r >= rows_v) continue;
        const int gn = n0 + c;
        const float* src = st_f + r * C::PITCH_F + c;
        float* dst = part + (size_t)(m0 + r) * N + gn;
        if (vec && gn + 4 <= col_end) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(src);
        } else {
          for (int e = 0; e < 4; ++e)
            if (gn + e < col_end) dst[e] = src[e];
        }
      }
      // the last CTA of this tile sums the partials in order of k
      __threadfence();
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
      if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
      if (is_last) {
        __threadfence();
        const int cols_v = col_end - n0;
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
  // no CTA leaves while a peer may still arrive on its barriers
  if (csize > 1) cluster_sync();
}

template <int R, int COLS, bool W_KMAJOR, int OCC>
cudaError_t launch_swap(const CUtensorMap& mx, const CUtensorMap& mw,
                        __nv_bfloat16* y, float* ws, int* counters, int M,
                        int N, int K, int bm, int bn, int k_run, int grid_m,
                        int grid_n, int group_m, int splits, int csize,
                        cudaStream_t stream) {
  using C = SwapCfg<R, COLS, W_KMAJOR, OCC>;
  if (splits > 1 && (k_run % C::KS != 0 || csize != 1))
    return cudaErrorInvalidValue;
  auto kernel = matmul_swap_kernel<R, COLS, W_KMAJOR, OCC>;
  static bool attr_set = false;
  static unsigned checked = 0;     // bit c: a cluster of c checked
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int grid_mc = (grid_m + csize - 1) / csize;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_mc * csize * grid_n, splits, 1);
  cfg.blockDim = dim3(THREADS_TMA, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!(checked & (1u << csize))) {
    // the card must hold at least one such cluster at this shared memory
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(kernel), &cfg);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorLaunchOutOfResources;
    checked |= 1u << csize;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, mx, mw, y, ws, counters,
                                     M, N, K, bm, bn, k_run, grid_m, grid_n,
                                     group_m, splits, csize);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// C entry point of variants A and B.  (bm, bn) are the effective
// (clamped) tiles and the CTA strides; k_run the K each of the `splits`
// CTAs of a tile walks; (rows, cols) the power-of-two CTA tile covering
// them; ld_w the stride of w's non-unit dimension (its rows when w_kmajor
// is 0, its columns when 1); ws a (splits, M, N) f32 workspace and
// counters grid_m * grid_n ints at zero when splits > 1; csize the
// thread-block cluster along M (1 or 2; 2 only at rows below 64 without a
// split and with a row-major w), with group_m a multiple of it; occ the CTAs
// an SM of the swapped kernel the plan picked (1 for rows of 64 and
// more).  Rows below 64 run the swapped kernel, rows of 64 and more the
// first redesign's.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// CTA tile (and occupancy) that is not compiled, a cluster it does not
// take or a split
// whose runs are not whole stages (64 or 128 deep) that cover K,
// cudaErrorLaunchOutOfResources when the card holds no such cluster, or
// cudaErrorNotSupported when the tensor maps cannot be made.
extern "C" int repro_matmul_tma_bf16(const void* x, const void* w, void* y,
                                     void* ws, void* counters, int M, int N,
                                     int K, long long lda, long long ld_w,
                                     int w_kmajor, int bm, int bn, int k_run,
                                     int rows, int cols, int grid_m,
                                     int grid_n, int group_m, int splits,
                                     int csize, int occ, void* stream) {
  if (splits < 1 || (long long)splits * k_run < K ||
      (splits > 1 && (splits - 1) * k_run >= K))
    return (int)cudaErrorInvalidValue;
  const bool swap = rows < 64;
  if ((csize != 1 && csize != 2) ||
      (csize > 1 && (!swap || splits > 1 || w_kmajor ||
                     group_m % csize != 0)) ||
      (!swap && occ != 1))
    return (int)cudaErrorInvalidValue;
  auto ys = static_cast<__nv_bfloat16*>(y);
  auto wss = static_cast<float*>(ws);
  auto cs = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mw;
  if (!make_map(&mx, x, K, M, lda, BK, rows)) return (int)cudaErrorNotSupported;
  // head.T in boxes of up to 256 rows (TMA's limit), w in 64-column boxes
  // (of which, in the swapped kernel, each CTA of a cluster loads its share)
  const int boxn = cols < 256 ? cols : 256;
  const bool ok = w_kmajor ? make_map(&mw, w, K, N, ld_w, BK, boxn)
                           : make_map(&mw, w, N, K, ld_w, 64, BK);
  if (!ok) return (int)cudaErrorNotSupported;
  if (swap) {
#define REPRO_SWAP_CASE(R_, C_, O_)                                         \
  if (rows == R_ && cols == C_ && occ == O_)                                \
    return (int)(w_kmajor ? launch_swap<R_, C_, true, O_>(                  \
                                mx, mw, ys, wss, cs, M, N, K, bm, bn, k_run, \
                                grid_m, grid_n, group_m, splits, csize, st) \
                          : launch_swap<R_, C_, false, O_>(                 \
                                mx, mw, ys, wss, cs, M, N, K, bm, bn, k_run, \
                                grid_m, grid_n, group_m, splits, csize,     \
                                st));
    REPRO_SWAP_CASE(16, 128, 2)
    REPRO_SWAP_CASE(16, 256, 2)
    REPRO_SWAP_CASE(16, 512, 1)
    REPRO_SWAP_CASE(32, 128, 2)
    REPRO_SWAP_CASE(32, 128, 3)
    REPRO_SWAP_CASE(32, 256, 2)
    REPRO_SWAP_CASE(32, 512, 1)
#undef REPRO_SWAP_CASE
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_TMA_CASE(R_, C_)                                              \
  if (rows == R_ && cols == C_)                                             \
    return (int)(w_kmajor                                                   \
                     ? launch_tma<R_, C_, true>(mx, mw, ys, wss, cs, M, N,  \
                                                K, bm, bn, k_run, grid_m,   \
                                                grid_n, group_m, splits,    \
                                                st)                         \
                     : launch_tma<R_, C_, false>(mx, mw, ys, wss, cs, M, N, \
                                                 K, bm, bn, k_run, grid_m,  \
                                                 grid_n, group_m, splits,   \
                                                 st));
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
