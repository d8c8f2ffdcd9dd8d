// K2: flash-attention forward, bf16 in and out, f32 online softmax.
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _flash_kernel).
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), out (B, Hq, Sq, D), D = 128.
// GQA is read in place: query head h uses KV head h / (Hq / Hkv).
//
// Tile semantics.  A CTA owns bq query rows of one (batch, head) and steps
// over the keys in blocks of bkv; each bkv block is streamed through shared
// memory in fixed sub-slabs of 64 keys, with the online-softmax rescale
// applied per sub-slab (the same function as the TPU kernel's per-block
// rescale, up to rounding).  Each warp owns 16 query rows and keeps its
// (16, D) f32 accumulator in registers: bq * D <= 128 * 128, the limit
// kernels/ops.py:tile_ok enforces.  The causal mask is bottom-right
// aligned (query row i sees keys 0 .. i + Skv - Sq) with the finite
// NEG_INF = -1e30, and the output is acc / max(l, 1e-30), as in the
// reference.  Sub-slabs wholly above the diagonal are skipped, which is
// exact because their weights are exp(-1e30 - m) = 0.
//
// Bound: at prefill (Sq = Skv = 512, D = 128) attention is compute-bound on
// the tensor cores; scores never leave the SM.  This first version uses
// mma.sync with single-buffered shared-memory staging and a transposed V
// tile; wgmma, TMA and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int D = 128;
constexpr int DP = D + 8;        // row pitch of Q and K tiles (bank spread)
constexpr int KV_SUB = 64;       // keys staged per shared-memory pass
constexpr int KVP = KV_SUB + 8;  // row pitch of the transposed V tile
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(256)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Sq,
                 int Skv, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, int bq, int bkv, int causal,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nwarps = blockDim.x >> 5;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + nwarps * 16 * DP;
  __nv_bfloat16* Vt = Ks + KV_SUB * DP;     // Vt[d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * bq;
  const int q_off = Skv - Sq;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb_ = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  // ---- Q tile -> shared -> per-warp register fragments ----
  for (int i = tid; i < nwarps * 16 * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < bq) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qss + c);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qr = Qs + (warp * 16 + g) * DP;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld_u32(qr + kk * 16 + 2 * t);
      qa[kk][1] = ld_u32(qr + 8 * DP + kk * 16 + 2 * t);
      qa[kk][2] = ld_u32(qr + kk * 16 + 2 * t + 8);
      qa[kk][3] = ld_u32(qr + 8 * DP + kk * 16 + 2 * t + 8);
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};
  const int qpos0 = q0 + warp * 16 + g + q_off;   // row g; row g+8 is +8
  const int cta_qmax = q0 + bq - 1 + q_off;
  const bool can_skip = causal && (q0 + q_off >= 0);

  for (int kb = 0; kb < Skv; kb += bkv) {
    const int kend = kb + bkv;
    for (int ks = kb; ks < kend; ks += KV_SUB) {
      if (can_skip && ks > cta_qmax) break;   // block-uniform
      // ---- stage K (row-major) and V (transposed) sub-slabs ----
      for (int i = tid; i < KV_SUB * (D / 8); i += blockDim.x) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const bool ok = ks + r < kend;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (ok) {
          kv = *reinterpret_cast<const uint4*>(kb_ + (ks + r) * kss + c);
          vv = *reinterpret_cast<const uint4*>(vb + (ks + r) * vss + c);
        }
        *reinterpret_cast<uint4*>(Ks + r * DP + c) = kv;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[(c + e) * KVP + r] = ok ? ve[e] : zero;
      }
      __syncthreads();

      // ---- scores S = Q K^T for this warp's 16 rows x 64 keys ----
      float s[KV_SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < KV_SUB / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < KV_SUB / 8; ++nt) {
          const __nv_bfloat16* kr = Ks + (nt * 8 + g) * DP + kk * 16 + 2 * t;
          mma_bf16_16816(s[nt], qa[kk], ld_u32(kr), ld_u32(kr + 8));
        }
      }

      // ---- scale, mask, online softmax ----
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < KV_SUB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ks + nt * 8 + 2 * t + (e & 1);
          const int qpos = qpos0 + 8 * (e >> 1);
          float val = s[nt][e] * scale;
          if (key >= kend) val = -INFINITY;          // outside this block
          else if (causal && key > qpos) val = NEG_INF;
          s[nt][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 2));
        const float m_new = fmaxf(m_row[hh], mx[hh]);
        corr[hh] = expf(m_row[hh] - m_new);
        m_row[hh] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < KV_SUB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m_row[e >> 1]);
          s[nt][e] = p;
          rs[e >> 1] += p;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rs[hh] += __shfl_xor_sync(0xffffffff, rs[hh], 1);
        rs[hh] += __shfl_xor_sync(0xffffffff, rs[hh], 2);
        l_row[hh] = l_row[hh] * corr[hh] + rs[hh];
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][0] *= corr[0]; o[dt][1] *= corr[0];
        o[dt][2] *= corr[1]; o[dt][3] *= corr[1];
      }

      // ---- O += P V, P rounded to bf16 as the reference does ----
#pragma unroll
      for (int j = 0; j < KV_SUB / 16; ++j) {
        uint32_t pa[4];
        pa[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
        pa[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
        pa[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const __nv_bfloat16* vr = Vt + (dt * 8 + g) * KVP + j * 16 + 2 * t;
          mma_bf16_16816(o[dt], pa, ld_u32(vr), ld_u32(vr + 8));
        }
      }
      __syncthreads();
    }
  }

  // ---- out = acc / max(l, 1e-30) ----
  __nv_bfloat16* ob = out + ((long long)bh * Sq + q0) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= bq) continue;
    const float l = fmaxf(l_row[hh], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(ob + r * D + dt * 8 + 2 * t) =
          pack_bf16x2(o[dt][2 * hh] / l, o[dt][2 * hh + 1] / l);
    }
  }
}

}  // namespace

// C entry point: returns cudaGetLastError() after the launch.
extern "C" int repro_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Sq, int Skv, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int bq, int bkv, int causal, float scale, void* stream) {
  const int nwarps = (bq + 15) / 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)nwarps * 16 * DP + KV_SUB * DP + D * KVP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Sq / bq, B * Hq);
  flash_fwd_kernel<<<grid, nwarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, bq, bkv,
      causal, scale);
  return (int)cudaGetLastError();
}
