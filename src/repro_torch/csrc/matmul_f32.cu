// K1, variant D: y(M,N) = x(M,K) @ w(K,N) in float32 (f32 in, f32
// accumulate, f32 out): the MoE router (moe.router) and the corpus's f32
// matmul sites, where the reference's matmul_pallas computes in f32.
// Replaces the TPU kernel src/repro/kernels/matmul.py (matmul_pallas /
// _matmul_kernel) for f32 operands; the bf16 variants are in matmul.cu.
//
// FFMA, no tensor cores: TF32 (or 3xTF32) wgmma would hand the per-k order
// of the sum to the tensor core, and a router rounded to 10 mantissa bits
// flips its top-k at near ties against the eager f32 product.
//
// Bound on the H100: the FP32 rate outside the tensor cores (about 67
// TFLOP/s, 0.51 a SM) at a prefill router (M = 2048, N = 128), reading x
// at N = 16, reading w at decode (M = 4).  A router's output grid is a
// handful of tiles (16 at M = 2048 under the baseline tile, 1 at M = 4),
// so one CTA a tile walking all of K leaves most SMs idle and each CTA
// waiting on its loads.  What the design does about it:
//
// * K is split into R runs, one CTA each (grid (grid_n, grid_m, R)).  R
//   and the run k_run come from K alone (kernels/ops.py:f32_split: at
//   most 8 runs of a multiple of the 32-deep slab, none shorter than
//   512), never from the tile, M, N or the card, so a row's bits do not
//   depend on the batch it came in.  CTA z sums [z * k_run, (z + 1) *
//   k_run) in order, one fmaf a step, into a register micro-tile, and
//   writes that partial to a workspace; the last CTA of a tile (a counter
//   that resets itself, as in split_k) adds the R partials in order of run,
//   ((p0 + p1) + p2) + ..., and stores y.  One launch; with R = 1 the
//   partial is the output.  (A thread-block cluster that adds the partials
//   through distributed shared memory gave the same bits but was slower at
//   the prefills: an H100 holds 15 clusters of 8 at one CTA an SM, so 16
//   router tiles do not run in one wave; PERF.md.)
// * The CTA computes only the rows and columns its tile has: the layout
//   `width` (16 to 512) is the CTA tile's columns or, at a narrower N, the
//   power of two of at least 16 covering N (Jamba's router: 16 of a
//   128-column tile), and the 256 threads go over rows instead; `height`
//   is the CTA tile's rows or, at M <= 8 (decode), 4 or 8.  Each thread
//   holds TM x TN accumulators (at most 128), rows ty + TYR * i, columns
//   in vectors of up to four.
// * 32-deep K slabs of x and w are staged through a ring of 2 to 8 stages
//   (at least 32 KB in flight a CTA where shared memory allows) with
//   cp.async (16 bytes, zero fill past the edges) where the pitch and base
//   allow, scalar loads otherwise.
// Every output element sums its runs in order and the runs in order of
// run, whatever the tile, the layout or M: every legal tile gives the same
// bits, and so does every batch.  w is read in place, row-major or as
// the transposed view head.T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F32_BK = 32;               // K depth of one staged slab
constexpr int F32_THREADS = 256;
constexpr int F32_APITCH = F32_BK + 4;   // floats a K-contiguous smem row
constexpr int F32_SMEM_FLOATS = 232448 / 4;   // a CTA's shared memory
constexpr int F32_RING_FLOATS = 32768 / 4;    // 32 KB in flight wanted
constexpr int F32_MAX_RUNS = 8;          // runs of K (kernels/ops.py)

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int ROWS, int WIDTH, bool B_KMAJOR>
struct F32Cfg {
  static constexpr int P = ROWS * WIDTH / F32_THREADS;   // accumulators
  static constexpr int TN = P <= 4 ? P : (P <= 16 ? 4 : 8);
  static constexpr int TM = P / TN;
  static constexpr int VB = TN < 4 ? TN : 4;   // w's columns a vector holds
  static constexpr int NB = TN / VB;           // vectors of a thread's cols
  static constexpr int TXC = WIDTH / TN;       // threads across columns
  static constexpr int TYR = F32_THREADS / TXC;   // threads down rows
  static constexpr int A_FLOATS = ROWS * F32_APITCH;               // As[r][k]
  static constexpr int B_FLOATS = B_KMAJOR ? WIDTH * F32_APITCH    // Bs[n][k]
                                           : F32_BK * WIDTH;       // Bs[k][n]
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int STAGES = cmin(
      F32_SMEM_FLOATS / STAGE,
      cmax(4, cmin(8, (F32_RING_FLOATS + STAGE - 1) / STAGE)));
  static constexpr int KV = TM >= 16 ? 2 : 4;  // k a K-contiguous read gives
  static constexpr int SMEM = 4 * STAGES * STAGE;
  static_assert(P >= 1 && P <= 128, "1 to 128 accumulators a thread");
  static_assert(TXC * TN == WIDTH && TYR * TXC == F32_THREADS &&
                    TYR * TM == ROWS,
                "the thread layout must cover the tile");
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(SMEM <= 4 * F32_SMEM_FLOATS, "shared memory of a CTA");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING) : "memory");
}

// Four consecutive floats src[0..3] into dst[0..3], the first `n` of them
// real and the rest zero: one cp.async where `vec`, else scalar loads.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       const float* base, int n, bool vec) {
  n = n < 0 ? 0 : (n > 4 ? 4 : n);
  if (vec) {
    cp_async16(dst, n > 0 ? src : base, 4 * n);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = e < n ? src[e] : 0.f;
  }
}

// V consecutive floats of shared memory (V = 1, 2 or 4; aligned to V).
template <int V>
__device__ __forceinline__ void lds(float* out, const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

// The tile column of a thread's accumulator j: vectors of VB columns NB
// apart for a row-major w (one 16-byte smem read a k); tx + TXC * j for
// head.T, whose K-contiguous rows then fall in different banks.
template <typename C, bool B_KMAJOR>
__device__ __forceinline__ int col_of(int tx, int j) {
  if constexpr (B_KMAJOR) {
    return tx + C::TXC * j;
  } else {
    return (j / C::VB) * (C::TXC * C::VB) + tx * C::VB + j % C::VB;
  }
}

template <int ROWS, int WIDTH, bool B_KMAJOR>
__global__ void __launch_bounds__(F32_THREADS, 1)
matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, float* __restrict__ ws,
                  int* __restrict__ counters, int M, int N, int K,
                  long long lda, long long ldw, int bm_step, int bn_step,
                  int k_run, int vec_a, int vec_b) {
  using C = F32Cfg<ROWS, WIDTH, B_KMAJOR>;
  constexpr int TM = C::TM, TN = C::TN, KV = C::KV, STAGES = C::STAGES;
  extern __shared__ __align__(16) float f32_smem[];
  const int tid = threadIdx.x, ty = tid / C::TXC, tx = tid % C::TXC;
  const int m0 = blockIdx.y * bm_step, n0 = blockIdx.x * bn_step;
  const int row_end = min(M, m0 + bm_step);
  const int col_end = min(N, n0 + bn_step);
  const int runs = gridDim.z, run = blockIdx.z;
  const int kb = run * k_run;
  const int nk = (min(K, kb + k_run) - kb + F32_BK - 1) / F32_BK;

  auto load = [&](int buf, int k0) {
    float* As = f32_smem + buf * C::STAGE;
    float* Bs = As + C::A_FLOATS;
    for (int v = tid; v < ROWS * (F32_BK / 4); v += F32_THREADS) {
      const int r = v / (F32_BK / 4), kc = (v % (F32_BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + kc;
      stage4(As + r * F32_APITCH + kc, x + (size_t)gm * lda + gk, x,
             gm < row_end ? K - gk : 0, vec_a);
    }
    if constexpr (B_KMAJOR) {   // w[k][n] at n * ldw + k
      for (int v = tid; v < WIDTH * (F32_BK / 4); v += F32_THREADS) {
        const int n = v / (F32_BK / 4), kc = (v % (F32_BK / 4)) * 4;
        const int gn = n0 + n, gk = k0 + kc;
        stage4(Bs + n * F32_APITCH + kc, w + (size_t)gn * ldw + gk, w,
               gn < col_end ? K - gk : 0, vec_b);
      }
    } else {                    // w[k][n] at k * ldw + n
      for (int v = tid; v < F32_BK * (WIDTH / 4); v += F32_THREADS) {
        const int k = v / (WIDTH / 4), nc = (v % (WIDTH / 4)) * 4;
        const int gk = k0 + k, gn = n0 + nc;
        stage4(Bs + k * WIDTH + nc, w + (size_t)gk * ldw + gn, w,
               gk < K ? col_end - gn : 0, vec_b);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, kb + s * F32_BK);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<STAGES - 2>();   // slab s has landed
    __syncthreads();               // and slab s - 1's buffer is free
    if (s + STAGES - 1 < nk)
      load((s + STAGES - 1) % STAGES, kb + (s + STAGES - 1) * F32_BK);
    cp_async_commit();
    const float* As = f32_smem + (s % STAGES) * C::STAGE;
    const float* Bs = As + C::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < F32_BK; kq += KV) {
      float a[TM][KV];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        lds<KV>(a[i], As + (ty + C::TYR * i) * F32_APITCH + kq);
      float b[KV][TN];
      if constexpr (B_KMAJOR) {
        float t[KV];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          lds<KV>(t, Bs + col_of<C, true>(tx, j) * F32_APITCH + kq);
#pragma unroll
          for (int kk = 0; kk < KV; ++kk) b[kk][j] = t[kk];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KV; ++kk)
#pragma unroll
          for (int q = 0; q < C::NB; ++q)
            lds<C::VB>(&b[kk][q * C::VB], Bs + (kq + kk) * WIDTH +
                                              col_of<C, false>(tx, q * C::VB));
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
  }

  if (runs == 1) {              // the partial is the output
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + ty + C::TYR * i;
      if (r >= row_end) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + col_of<C, B_KMAJOR>(tx, j);
        if (c < col_end) y[(size_t)r * N + c] = acc[i][j];
      }
    }
    return;
  }

  // The partial to the workspace.
  float* part = ws + (size_t)run * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty + C::TYR * i;
    if (r >= row_end) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + col_of<C, B_KMAJOR>(tx, j);
      if (c < col_end) part[(size_t)r * N + c] = acc[i][j];
    }
  }
  __shared__ int is_last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == runs - 1;
  __syncthreads();
  if (!is_last) return;
  // the last CTA of the tile adds the runs' partials in order of run
  __threadfence();
  const int rows_v = row_end - m0, cols_v = col_end - n0;
  const size_t mn = (size_t)M * N;
  if (((N | n0 | cols_v) & 3) == 0) {
    const int cv4 = cols_v / 4, F = rows_v * cv4;
    for (int f0 = tid; f0 < F; f0 += 4 * F32_THREADS) {
      float4 acc4[4];
      size_t o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = min(f0 + u * F32_THREADS, F - 1);
        o[u] = (size_t)(m0 + f / cv4) * N + n0 + 4 * (f % cv4);
        acc4[u] = __ldcg(reinterpret_cast<const float4*>(ws + o[u]));
      }
      for (int z = 1; z < runs; ++z) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 p =
              __ldcg(reinterpret_cast<const float4*>(ws + z * mn + o[u]));
          acc4[u].x = acc4[u].x + p.x, acc4[u].y = acc4[u].y + p.y;
          acc4[u].z = acc4[u].z + p.z, acc4[u].w = acc4[u].w + p.w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (f0 + u * F32_THREADS < F)
          *reinterpret_cast<float4*>(y + o[u]) = acc4[u];
    }
  } else {
    for (int e = tid; e < rows_v * cols_v; e += F32_THREADS) {
      const size_t o = (size_t)(m0 + e / cols_v) * N + n0 + e % cols_v;
      float v = __ldcg(ws + o);
      for (int z = 1; z < runs; ++z) v = v + __ldcg(ws + z * mn + o);
      y[o] = v;
    }
  }
  if (tid == 0) counters[tile] = 0;     // ready for the next call
}

template <int ROWS, int WIDTH, bool B_KMAJOR>
cudaError_t launch_f32(const float* x, const float* w, float* y, float* ws,
                       int* counters, int M, int N, int K, long long lda,
                       long long ldw, int bm, int bn, int k_run, int splits,
                       int grid_m, int grid_n, int vec_a, int vec_b,
                       cudaStream_t stream) {
  using C = F32Cfg<ROWS, WIDTH, B_KMAJOR>;
  auto kernel = matmul_f32_kernel<ROWS, WIDTH, B_KMAJOR>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(grid_n, grid_m, splits);
  kernel<<<grid, F32_THREADS, C::SMEM, stream>>>(x, w, y, ws, counters, M, N,
                                                 K, lda, ldw, bm, bn, k_run,
                                                 vec_a, vec_b);
  return cudaGetLastError();
}

}  // namespace

// C entry point of variant D.  (bm, bn) are the effective (clamped) tiles
// and the CTA strides, on a (grid_m, grid_n) grid; (height, width) the
// rows and columns the CTA computes (its CTA tile's, or fewer at M <= 8
// or a narrow N); K is split into `splits` runs of `k_run` (a multiple of
// 32 when splits > 1), one CTA each, ws a (splits, M, N) f32 workspace
// and counters grid_m * grid_n ints at zero; ld_w the stride of w's
// non-unit dimension (its rows when w_kmajor is 0, its columns when 1);
// vec_a and vec_b say that x's and w's base and pitch are 16-byte aligned
// (and, for a row-major w, bn a multiple of 4), so that its slabs load
// with cp.async.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a layout that is not compiled, runs that do
// not cover K, or several runs without a workspace.
extern "C" int repro_matmul_f32(const void* x, const void* w, void* y,
                                void* ws, void* counters, int M, int N,
                                int K, long long lda, long long ld_w,
                                int w_kmajor, int bm, int bn, int height,
                                int width, int k_run, int splits,
                                int grid_m, int grid_n, int vec_a, int vec_b,
                                void* stream) {
  if (splits < 1 || splits > F32_MAX_RUNS || (long long)splits * k_run < K ||
      (splits > 1 && ((splits - 1) * k_run >= K || k_run % F32_BK != 0 ||
                      ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto xs = static_cast<const float*>(x);
  auto wt = static_cast<const float*>(w);
  auto ys = static_cast<float*>(y);
  auto wss = static_cast<float*>(ws);
  auto cs = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_F32_CASE(R_, W_)                                                \
  if (height == R_ && width == W_)                                            \
    return (int)(w_kmajor                                                     \
                     ? launch_f32<R_, W_, true>(xs, wt, ys, wss, cs, M, N, K, \
                                                lda, ld_w, bm, bn, k_run,     \
                                                splits, grid_m, grid_n,       \
                                                vec_a, vec_b, st)             \
                     : launch_f32<R_, W_, false>(xs, wt, ys, wss, cs, M, N,   \
                                                 K, lda, ld_w, bm, bn, k_run, \
                                                 splits, grid_m, grid_n,      \
                                                 vec_a, vec_b, st));
  REPRO_F32_CASE(4, 128)
  REPRO_F32_CASE(4, 256)
  REPRO_F32_CASE(4, 512)
  REPRO_F32_CASE(8, 128)
  REPRO_F32_CASE(8, 256)
  REPRO_F32_CASE(8, 512)
  REPRO_F32_CASE(16, 16)
  REPRO_F32_CASE(16, 32)
  REPRO_F32_CASE(16, 64)
  REPRO_F32_CASE(16, 128)
  REPRO_F32_CASE(16, 256)
  REPRO_F32_CASE(16, 512)
  REPRO_F32_CASE(32, 16)
  REPRO_F32_CASE(32, 32)
  REPRO_F32_CASE(32, 64)
  REPRO_F32_CASE(32, 128)
  REPRO_F32_CASE(32, 256)
  REPRO_F32_CASE(32, 512)
  REPRO_F32_CASE(64, 16)
  REPRO_F32_CASE(64, 32)
  REPRO_F32_CASE(64, 64)
  REPRO_F32_CASE(64, 128)
  REPRO_F32_CASE(64, 256)
  REPRO_F32_CASE(64, 512)
  REPRO_F32_CASE(128, 16)
  REPRO_F32_CASE(128, 32)
  REPRO_F32_CASE(128, 64)
  REPRO_F32_CASE(128, 128)
  REPRO_F32_CASE(128, 256)
  REPRO_F32_CASE(256, 16)
  REPRO_F32_CASE(256, 32)
  REPRO_F32_CASE(256, 64)
  REPRO_F32_CASE(256, 128)
#undef REPRO_F32_CASE
  return (int)cudaErrorInvalidValue;
}

