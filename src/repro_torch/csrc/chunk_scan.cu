// K3: SSD chunk scan, bf16 x/B/C in, f32 state and accumulation, bf16 out.
// Replaces the TPU kernel src/repro/kernels/chunk_scan.py
// (chunk_scan_pallas / _chunk_kernel).
//
// x (G, S, P), B and C (G, S, N), la (G, S) f32 log-decay, y (G, S, P).
// Per group and chunk of Q positions, with cum = cumsum(la) in the chunk:
//   y     = ((C Bt) .* L) x  +  exp(cum) .* (C stateT),  L_ij = exp(cum_i -
//           cum_j) for j <= i, else 0
//   state = state * exp(cum[Q-1]) + xT (B .* exp(cum[Q-1] - cum))
//
// On the TPU the chunk axis of the grid runs in order and carries the
// (P, N) state in VMEM.  Here one call is two kernels:
//   scores_kernel  (C Bt) .* L for every chunk, in parallel over (group,
//                  chunk, 64x64 tile); bf16 into a (G*S, Qp) scratch, Qp = Q
//                  rounded up to 64, so a Q x Q block never has to fit in
//                  shared memory.  Tiles above the diagonal are never read
//                  and not written; masked entries are written as 0.
//   scan_kernel    one CTA per (group, BP = 16 columns of P) walks the
//                  chunks in order.  Its (16, N) f32 slice of the state
//                  lives in registers as mma accumulators (warp w owns the
//                  8-column tiles w, w+8, ...; N <= 1024 gives 16 tiles, 64
//                  floats a thread) and is copied to shared memory in bf16
//                  as the B operand of C stateT.  The state update's decay
//                  is applied to the 16 x Q slice of x (xdT), so B is used
//                  as it lies: Q-row slabs are copied with cp.async and read
//                  as mma fragments with ldmatrix.trans.
// All products are mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Bound: at the xLSTM site (G = 1, S = 8192, P = N = 1024, Q = 256) the
// operations, 42.9 GFLOP against 67 MB.  This version reads the scores and
// C as mma fragments straight from L2 and has only P / 16 = 64 CTAs in the
// scan; wgmma, TMA and more parallelism across N are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int QMAX = 1024;     // largest chunk
constexpr int NMAX = 1024;     // largest state width N
constexpr int BP = 16;         // P columns a scan CTA owns
constexpr int TS = 64;         // scores tile edge
constexpr int KS = 32;         // K sub-slab staged per shared-memory pass
constexpr int KP = KS + 8;     // its row pitch (bank spread)
constexpr int NTW = NMAX / 8 / 8;  // state tiles a warp owns at most

// Inclusive prefix sum of la[0, Q) into cum (shared) by the whole block;
// wsum holds one float a warp.  Ends with a barrier.
__device__ void block_cumsum(const float* __restrict__ la, int Q, float* cum,
                             float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = (Q + blockDim.x - 1) / blockDim.x;
  const int lo = min(Q, tid * seg), hi = min(Q, lo + seg);
  float s = 0.f;
  for (int i = lo; i < hi; ++i) {
    s += la[i];
    cum[i] = s;
  }
  float v = s;                 // inclusive scan of the segment totals
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffff, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  float off = v - s;
  for (int w = 0; w < warp; ++w) off += wsum[w];
  for (int i = lo; i < hi; ++i) cum[i] += off;
  __syncthreads();
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// B fragments (b0, b1) of mma m16n8k16 for the 16 x 8 block at rows
// [k0, k0 + 16), columns [n0, n0 + 8) of a row-major (k, n) matrix in
// shared memory with row pitch ``pitch`` elements (rows 16-byte aligned).
__device__ __forceinline__ void ldsm_b_trans(uint32_t& b0, uint32_t& b1,
                                             const bf16* m, int pitch,
                                             int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const unsigned s = static_cast<unsigned>(
      __cvta_generic_to_shared(m + (k0 + (lane & 15)) * pitch + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(s));
}

// Stage a 64 x KS slab of rows [r0, r0 + 64) (rows >= rmax are 0) and
// columns [k0, k0 + KS) (columns >= N are 0) of a row-major (., N) matrix.
__device__ __forceinline__ void stage_rows(bf16 (*dst)[KP],
                                           const bf16* __restrict__ src,
                                           int r0, int rmax, int k0, int N) {
  for (int v = threadIdx.x; v < TS * (KS / 8); v += blockDim.x) {
    const int r = v / (KS / 8), kc = (v % (KS / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    // N % 8 == 0: an 8-wide run is wholly inside or wholly past N
    if (r0 + r < rmax && k0 + kc < N)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * N +
                                            k0 + kc);
    *reinterpret_cast<uint4*>(&dst[r][kc]) = val;
  }
}

__global__ void __launch_bounds__(128)
scores_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              const float* __restrict__ la, bf16* __restrict__ sc, int G,
              int S, int N, int Q, int Qp) {
  const int jt = blockIdx.x, it = blockIdx.y;
  if (jt > it) return;          // above the diagonal: never read
  __shared__ float cum[QMAX];
  __shared__ float wsum[4];
  __shared__ __align__(16) bf16 Cs[TS][KP];
  __shared__ __align__(16) bf16 Bs[TS][KP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = S / Q;
  const int i0 = it * TS, j0 = jt * TS;

  for (int z = blockIdx.z; z < G * nc; z += gridDim.z) {
    const long long base = (long long)(z / nc) * S + (long long)(z % nc) * Q;
    block_cumsum(la + base, Q, cum, wsum);
    const bf16* Cc = Cm + base * N;
    const bf16* Bc = Bm + base * N;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int k0 = 0; k0 < N; k0 += KS) {
      stage_rows(Cs, Cc, i0, Q, k0, N);
      stage_rows(Bs, Bc, j0, Q, k0, N);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        const int r = warp * 16 + g;
        uint32_t a[4];
        a[0] = ld_u32(&Cs[r][kk + 2 * t]);
        a[1] = ld_u32(&Cs[r + 8][kk + 2 * t]);
        a[2] = ld_u32(&Cs[r][kk + 2 * t + 8]);
        a[3] = ld_u32(&Cs[r + 8][kk + 2 * t + 8]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* br = &Bs[j * 8 + g][kk + 2 * t];
          mma_bf16_16816(acc[j], a, ld_u32(br), ld_u32(br + 8));
        }
      }
      __syncthreads();
    }

    // ---- epilogue: causal decay, bf16 into the scratch ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + warp * 16 + g + 8 * h;
      if (i >= Q) continue;
      bf16* row = sc + (base + i) * Qp;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j0 + j * 8 + 2 * t;
        float v0 = 0.f, v1 = 0.f;
        if (c <= i && c < Q) v0 = acc[j][2 * h] * expf(cum[i] - cum[c]);
        if (c + 1 <= i && c + 1 < Q)
          v1 = acc[j][2 * h + 1] * expf(cum[i] - cum[c + 1]);
        *reinterpret_cast<uint32_t*>(row + c) = pack_bf16x2(v0, v1);
      }
    }
    __syncthreads();            // cum is rewritten by the next chunk
  }
}

__global__ void __launch_bounds__(256, 1)
scan_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, const float* __restrict__ la,
            const bf16* __restrict__ sc, bf16* __restrict__ y, int S, int P,
            int N, int Q, int Qp, int vec_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Np = (N + 15) / 16 * 16;
  const int xp = Qp + 8, sp = Np + 8;
  float* cum = reinterpret_cast<float*>(smem_raw);           // Qp
  float* wsum = cum + Qp;                                     // 8 (+8 pad)
  bf16* xT = reinterpret_cast<bf16*>(wsum + 16);              // BP x xp
  bf16* xdT = xT + BP * xp;                                   // BP x xp
  bf16* stb = xdT + BP * xp;                                  // BP x sp
  bf16* Bs = stb + BP * sp;                                   // KS x sp

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * BP;
  const long long gbase = (long long)blockIdx.y * S;
  const bf16 zero = __float2bfloat16(0.f);

  float st[NTW][4];             // state rows p0 .. p0+15, tiles w + 8l
#pragma unroll
  for (int l = 0; l < NTW; ++l)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[l][e] = 0.f;
  for (int v = tid; v < BP * sp; v += blockDim.x) stb[v] = zero;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const long long base = gbase + c0;
    block_cumsum(la + base, Q, cum, wsum);
    const float clast = cum[Q - 1];
    // ---- x chunk, transposed: xT[p][q] = x, xdT[p][q] = x * exp(cum[-1]
    //      - cum[q]) (the state update's decay, on the 16 x Q side) ----
    for (int v = tid; v < Qp * 2; v += blockDim.x) {
      const int q = v >> 1, pc = (v & 1) * 8;
      bf16 vals[8];
      const bf16* src = x + (base + q) * P + p0 + pc;
      if (q < Q && vec_x && p0 + pc + 8 <= P) {
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = (q < Q && p0 + pc + e < P) ? src[e] : zero;
      }
      const float d = q < Q ? expf(clast - cum[q]) : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xT[(pc + e) * xp + q] = vals[e];
        xdT[(pc + e) * xp + q] = __float2bfloat16(__bfloat162float(vals[e]) * d);
      }
    }
    __syncthreads();

    // ---- y: intra-chunk scores @ x, plus exp(cum) * C @ stateT ----
    for (int r0 = warp * 16; r0 < Q; r0 += 8 * 16) {
      float yi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float ye[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bool ok0 = r0 + g < Q, ok1 = r0 + g + 8 < Q;
      const bf16* s0 = sc + (base + r0 + g) * Qp;
      const bf16* s1 = s0 + 8 * (long long)Qp;
#pragma unroll 4
      for (int k0 = 0; k0 < r0 + 16; k0 += 16) {
        uint32_t a[4];
        a[0] = ld_pair(s0 + k0 + 2 * t, ok0);
        a[1] = ld_pair(s1 + k0 + 2 * t, ok1);
        a[2] = ld_pair(s0 + k0 + 2 * t + 8, ok0);
        a[3] = ld_pair(s1 + k0 + 2 * t + 8, ok1);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const bf16* b = xT + (n * 8 + g) * xp + k0 + 2 * t;
          mma_bf16_16816(yi[n], a, ld_u32(b), ld_u32(b + 8));
        }
      }
      const bf16* c0r = Cm + (base + r0 + g) * N;
      const bf16* c1r = c0r + 8 * (long long)N;
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 16) {
        const bool lo = k0 + 2 * t < N, hi = k0 + 2 * t + 8 < N;
        uint32_t a[4];
        a[0] = ld_pair(c0r + k0 + 2 * t, ok0 && lo);
        a[1] = ld_pair(c1r + k0 + 2 * t, ok1 && lo);
        a[2] = ld_pair(c0r + k0 + 2 * t + 8, ok0 && hi);
        a[3] = ld_pair(c1r + k0 + 2 * t + 8, ok1 && hi);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const bf16* b = stb + (n * 8 + g) * sp + k0 + 2 * t;
          mma_bf16_16816(ye[n], a, ld_u32(b), ld_u32(b + 8));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (r >= Q) continue;
        const float dec = expf(cum[r]);
        bf16* yr = y + (base + r) * P;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = p0 + n * 8 + 2 * t + e;
            if (p < P)
              yr[p] = __float2bfloat16(yi[n][2 * h + e] +
                                       dec * ye[n][2 * h + e]);
          }
        }
      }
    }

    // ---- state = state * exp(cum[-1]) + xdT @ B, B streamed through
    //      shared memory in KS-row slabs (cp.async, read with ldmatrix) ----
    const float keep = expf(clast);
#pragma unroll
    for (int l = 0; l < NTW; ++l)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[l][e] *= keep;
    const int nv = Np / 8;
    for (int q0 = 0; q0 < Qp; q0 += KS) {
      __syncthreads();          // the last slab's reads (and stb's) are done
      for (int v = tid; v < KS * nv; v += blockDim.x) {
        const int kk = v / nv, n = (v % nv) * 8, q = q0 + kk;
        bf16* dst = Bs + kk * sp + n;
        // N % 8 == 0: an 8-wide run is wholly inside or wholly past N
        if (q < Q && n < N)
          cp_async16(dst, Bm + (base + q) * N + n);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        const bf16* ar = xdT + g * xp + q0 + kk + 2 * t;
        uint32_t a[4];
        a[0] = ld_u32(ar);
        a[1] = ld_u32(ar + 8 * xp);
        a[2] = ld_u32(ar + 8);
        a[3] = ld_u32(ar + 8 * xp + 8);
#pragma unroll
        for (int l = 0; l < NTW; ++l) {
          const int n8 = (warp + 8 * l) * 8;
          if (n8 < N) {
            uint32_t b0, b1;
            ldsm_b_trans(b0, b1, Bs, sp, kk, n8);
            mma_bf16_16816(st[l], a, b0, b1);
          }
        }
      }
    }
    __syncthreads();            // Bs reads done before stb changes
    // ---- bf16 copy of the state for the next chunk's C @ stateT ----
#pragma unroll
    for (int l = 0; l < NTW; ++l) {
      const int n = (warp + 8 * l) * 8 + 2 * t;
      if (n < N) {
        *reinterpret_cast<uint32_t*>(stb + g * sp + n) =
            pack_bf16x2(st[l][0], st[l][1]);
        *reinterpret_cast<uint32_t*>(stb + (g + 8) * sp + n) =
            pack_bf16x2(st[l][2], st[l][3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// C entry point: both passes on ``stream``.  ``scores`` is the caller's
// (G*S, Qp) bf16 scratch.  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a shape the kernels are not built for (the
// predicate in kernels/ops.py:chunk_tiles_legal).
extern "C" int repro_chunk_scan_bf16(const void* x, const void* bm,
                                     const void* cm, const void* la,
                                     void* scores, void* y, int G, int S,
                                     int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > QMAX || S % Q || N < 8 || N > NMAX || N % 8 || P < 1 ||
      G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int Qp = (Q + TS - 1) / TS * TS;
  const int Np = (N + 15) / 16 * 16;
  auto st = static_cast<cudaStream_t>(stream);
  auto xs = static_cast<const bf16*>(x);
  auto bs = static_cast<const bf16*>(bm);
  auto cs = static_cast<const bf16*>(cm);
  auto ls = static_cast<const float*>(la);
  auto ss = static_cast<bf16*>(scores);
  const long long zc = (long long)G * (S / Q);
  dim3 ga(Qp / TS, Qp / TS, (unsigned)(zc < 65535 ? zc : 65535));
  scores_kernel<<<ga, 128, 0, st>>>(bs, cs, ls, ss, G, S, N, Q, Qp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (Qp + 16) +
                      sizeof(bf16) * ((size_t)2 * BP * (Qp + 8) +
                                      (size_t)(BP + KS) * (Np + 8));
  err = cudaFuncSetAttribute(scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 gb((P + BP - 1) / BP, G);
  scan_kernel<<<gb, 256, smem, st>>>(xs, bs, cs, ls, ss,
                                     static_cast<bf16*>(y), S, P, N, Q, Qp,
                                     (int)(P % 8 == 0));
  return (int)cudaGetLastError();
}
