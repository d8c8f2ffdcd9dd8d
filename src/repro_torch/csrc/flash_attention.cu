// K2: flash-attention forward, bf16 in and out, f32 online softmax.
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _flash_kernel).
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), each read through its own
// strides (the model's v is the transposed view of its projection, strides
// (S*H*D, D, H*D, 1)); out (B, Hq, Sq, D) contiguous.  GQA is read in
// place: query head h uses KV head h / (Hq / Hkv).
//
// Head dims: D a multiple of 8 up to D_PAD = 128 (kernels/ops.py:
// head_dim_ok).  Both variants compute in the layout of D_PAD: variant A's
// tensor maps carry the true D, so TMA fills the columns past it with zeros
// (Q.K^T over them adds nothing; the P.V columns past D are computed and
// never stored); variant B masks its loads.  Both store only the first D
// columns.  The scale comes from the caller (1/sqrt(D) at the true D).
//
// The function is the reference's: scores scaled, the causal mask bottom-
// right aligned (query row i sees keys 0 .. i + Skv - Sq) with the finite
// NEG_INF = -1e30, an online softmax with f32 statistics, P rounded to bf16
// before P.V, and out = acc / max(l, 1e-30).  Rows that see no key (Sq >
// Skv) give the mean of V, as there.  Key stages wholly above a CTA's last
// row are skipped, which is exact: their weights are exp(-1e30 - m) = 0.
//
// Bound: at the Qwen3-8B prefill (B=4, Hq=32, Hkv=8, S=512, causal) reading
// q, k, v and writing out once is 42 MB, 0.0125 ms at 3.35 TB/s, more than
// the causal half's 8.6 GFLOP at 989 TFLOP/s (0.0087 ms): the bound is
// bytes.  The scores never leave the SM; TMA brings each K/V tile into
// shared memory once for a tile of up to 128 query rows, where both
// consumer warpgroups read it, and the tiles of one KV head's group run
// side by side so that the group's other heads find it in L2.
//
// A. tma_wgmma (operands TMA can take: a 16-byte aligned base, strides that
//    are multiples of 16 bytes, D contiguous).  A tile is bq query rows of
//    one (b, h): one or two consumer warpgroups of 64 rows (rows past bq are
//    zero-filled by TMA or belong to the next block: computed, never
//    stored).  Persistent: one CTA a SM walks tiles c, c + grid, ..., so
//    that the load of a tile's Q and first stage overlaps the end of the
//    tile before (at S = 512 a tile has at most 4 stages).  One producer
//    thread loads each tile's Q and streams K and V tiles of stage_keys
//    (128, or 64 where bkv < 128) x 128 through a ring of `ring` stages in
//    dynamic shared memory, each with full-K, full-V and empty mbarriers (Q
//    with a full and an empty one); 4-D tensor maps (D, S, H, B) over the
//    tensors' own strides, 128-byte swizzle, rows past Sq or Skv read as
//    zero.  Each consumer warpgroup computes S = Q.K^T with wgmma
//    m64n{keys}k16 (Q and K K-major in shared memory), scales by
//    scale*log2(e), masks and runs the online softmax in registers with
//    exp2 (a row's statistics shared by its 4 threads), and feeds P,
//    rounded to bf16 in registers, as the A operand of O += P.V (wgmma
//    m64n128k16, V MN-major through the transpose bit, read in place).  A bkv above 128 is walked in 128-key stages with the
//    rescale per stage: the same function up to rounding.  Under a causal
//    mask only the stages that cross a warpgroup's diagonal are masked, and
//    the heaviest query blocks come first.  The epilogue writes O / l in
//    bf16 through a staging tile in shared memory, 16-byte stores.
// B. unaligned (an operand TMA cannot take).  The first kernel's loop: each
//    warp owns 16 query rows, keys staged through shared memory in 64-key
//    sub-slabs (V transposed), mma.sync m16n8k16.  No model path takes it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int D_PAD = 128;       // the head dim the kernels compute in
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// B. unaligned operands
// ---------------------------------------------------------------------------

constexpr int DP = D_PAD + 8;    // row pitch of Q and K tiles (bank spread)
constexpr int KV_SUB = 64;       // keys staged per shared-memory pass
constexpr int KVP = KV_SUB + 8;  // row pitch of the transposed V tile

// Eight elements `sd` apart from p: one 16-byte load where `vec` says the
// row is contiguous and 16-byte aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, long long sd,
                                       int vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  __align__(16) __nv_bfloat16 e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = p[i * sd];
  return *reinterpret_cast<const uint4*>(e);
}

__global__ void __launch_bounds__(256)
flash_unaligned_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                       int Sq, int Skv, int d, long long qsb, long long qsh,
                       long long qss, long long qsd, long long ksb,
                       long long ksh, long long kss, long long ksd,
                       long long vsb, long long vsh, long long vss,
                       long long vsd, int bq, int bkv, int causal,
                       float scale, int vec_q, int vec_k, int vec_v) {
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
  for (int i = tid; i < nwarps * 16 * (D_PAD / 8); i += blockDim.x) {
    const int r = i / (D_PAD / 8), c = (i % (D_PAD / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < bq && c < d)
      val = load8(qb + (q0 + r) * qss + c * qsd, qsd, vec_q);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }
  __syncthreads();
  uint32_t qa[D_PAD / 16][4];
  {
    const __nv_bfloat16* qr = Qs + (warp * 16 + g) * DP;
#pragma unroll
    for (int kk = 0; kk < D_PAD / 16; ++kk) {
      qa[kk][0] = ld_u32(qr + kk * 16 + 2 * t);
      qa[kk][1] = ld_u32(qr + 8 * DP + kk * 16 + 2 * t);
      qa[kk][2] = ld_u32(qr + kk * 16 + 2 * t + 8);
      qa[kk][3] = ld_u32(qr + 8 * DP + kk * 16 + 2 * t + 8);
    }
  }

  float o[D_PAD / 8][4];
#pragma unroll
  for (int i = 0; i < D_PAD / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_row[2] = {NEG_INF, NEG_INF}, l_row[2] = {0.f, 0.f};
  const int qpos0 = q0 + warp * 16 + g + q_off;   // row g; row g+8 is +8
  const int cta_qmax = q0 + bq - 1 + q_off;
  const bool can_skip = causal && (q0 + q_off >= 0);

  for (int kb = 0; kb < Skv; kb += bkv) {
    const int kend = kb + bkv;
    for (int ks = kb; ks < kend; ks += KV_SUB) {
      if (can_skip && ks > cta_qmax) break;   // block-uniform
      // ---- stage K (row-major) and V (transposed) sub-slabs ----
      for (int i = tid; i < KV_SUB * (D_PAD / 8); i += blockDim.x) {
        const int r = i / (D_PAD / 8), c = (i % (D_PAD / 8)) * 8;
        const bool ok = ks + r < kend;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (ok && c < d) {
          kv = load8(kb_ + (ks + r) * kss + c * ksd, ksd, vec_k);
          vv = load8(vb + (ks + r) * vss + c * vsd, vsd, vec_v);
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
      for (int kk = 0; kk < D_PAD / 16; ++kk) {
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
      for (int dt = 0; dt < D_PAD / 8; ++dt) {
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
        for (int dt = 0; dt < D_PAD / 8; ++dt) {
          const __nv_bfloat16* vr = Vt + (dt * 8 + g) * KVP + j * 16 + 2 * t;
          mma_bf16_16816(o[dt], pa, ld_u32(vr), ld_u32(vr + 8));
        }
      }
      __syncthreads();
    }
  }

  // ---- out = acc / max(l, 1e-30): the first d columns ----
  __nv_bfloat16* ob = out + ((long long)bh * Sq + q0) * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= bq) continue;
    const float l = fmaxf(l_row[hh], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < D_PAD / 8; ++dt) {
      if (dt * 8 < d)
        *reinterpret_cast<uint32_t*>(ob + r * d + dt * 8 + 2 * t) =
            pack_bf16x2(o[dt][2 * hh] / l, o[dt][2 * hh + 1] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// A. TMA ring, one producer thread, wgmma from consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;                 // query rows a consumer warpgroup
constexpr int Q_WG_BYTES = WG_ROWS * D_PAD * 2;  // its Q tile: two 64 x 64
                                                 // slabs
constexpr int MAX_RING = 4;
constexpr int SMEM_LIMIT = 232448;          // bytes a block may use on sm_90
constexpr int SMEM_DYN = SMEM_LIMIT - 1024; // dynamic part (static: barriers)

template <int KEYS>
struct StageCfg {
  static constexpr int SLAB = KEYS * 128;   // KEYS rows x 64 columns of D
  static constexpr int KV_BYTES = 2 * SLAB; // one K (or V) tile
  static constexpr int STAGE = 2 * KV_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Tile `tile` of the grid as (query block, batch, head): the heaviest
// query blocks first under a causal mask; within a block row, the query
// heads of one KV head side by side.
__device__ __forceinline__ void tile_coords(int tile, int n_bh, int n_qb,
                                            int Hq, int causal, int& qb,
                                            int& b, int& h) {
  const int rank = tile / n_bh, bh = tile % n_bh;
  qb = causal ? n_qb - 1 - rank : rank;
  b = bh / Hq;
  h = bh % Hq;
}

// Key stages a tile walks: all of Skv, or under a causal mask up to its
// last row's diagonal when no row of the block is all masked.
__device__ __forceinline__ int tile_stages(int q0, int bq, int q_off,
                                           int n_stages, int keys,
                                           int causal) {
  if (causal && q0 + q_off >= 0)
    return min(n_stages, (q0 + bq - 1 + q_off) / keys + 1);
  return n_stages;
}

template <int NWG, int KEYS>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ out, int B, int Hq, int Hkv,
                 int Sq, int Skv, int d, int bq, int n_stages, int ring,
                 int causal, float scale_log2) {
  using C = StageCfg<KEYS>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_k[MAX_RING];
  __shared__ __align__(8) uint64_t full_v[MAX_RING];
  __shared__ __align__(8) uint64_t empty[MAX_RING];
  __shared__ __align__(8) uint64_t q_full, q_empty;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* o_smem = smem + NWG * Q_WG_BYTES;      // output staging
  uint8_t* ring_smem = o_smem + NWG * Q_WG_BYTES;

  const int tid = threadIdx.x;
  const int n_bh = B * Hq, n_qb = Sq / bq, n_tiles = n_qb * n_bh;
  const int group = Hq / Hkv;
  const int q_off = Skv - Sq;

  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], NWG * 4);    // one arrive a consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: CTA c takes tiles c, c + gridDim.x, ...  The ring and the
  // barriers' phases run on from one tile to the next, so the producer
  // loads a tile's first K/V stage and its Q while the consumers finish
  // the tile before.
  const int wg = tid / 128;
  if (wg == NWG) {
    // ---- producer: one thread keeps Q and the ring loaded ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NWG * 128) {
      int s = 0, phase = 0, n = 0, it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        int qb, b, h;
        tile_coords(tile, n_bh, n_qb, Hq, causal, qb, b, h);
        const int q0 = qb * bq, hk = h / group;
        const int nst = tile_stages(q0, bq, q_off, n_stages, KEYS, causal);
        for (int i = 0; i < nst; ++i, ++n) {
          if (n >= ring) mbar_wait(&empty[s], phase ^ 1);
          uint8_t* st = ring_smem + s * C::STAGE;
          mbar_expect_tx(&full_k[s], C::KV_BYTES);
          for (int c = 0; c < 2; ++c)
            tma_load_4d(st + c * C::SLAB, &map_k, c * 64, i * KEYS, hk, b,
                        &full_k[s]);
          mbar_expect_tx(&full_v[s], C::KV_BYTES);
          for (int c = 0; c < 2; ++c)
            tma_load_4d(st + C::KV_BYTES + c * C::SLAB, &map_v, c * 64,
                        i * KEYS, hk, b, &full_v[s]);
          if (++s == ring) { s = 0; phase ^= 1; }
          if (i == 0) {     // Q once the tile before has read its own
            if (it > 0) mbar_wait(&q_empty, (it - 1) & 1);
            mbar_expect_tx(&q_full, NWG * Q_WG_BYTES);
            for (int w = 0; w < NWG; ++w)
              for (int c = 0; c < 2; ++c)
                tma_load_4d(smem + w * Q_WG_BYTES + c * (Q_WG_BYTES / 2),
                            &map_q, c * 64, q0 + w * WG_ROWS, h, b, &q_full);
          }
        }
      }
    }
  } else {
    // ---- consumers: one warpgroup per 64 query rows ----
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int row0 = warp * 16 + (lane >> 2);   // accumulator rows row0, +8
    const int col = 2 * (lane & 3);
    const uint32_t q_addr = smem_u32(smem + wg * Q_WG_BYTES);
    uint8_t* o_tile = o_smem + wg * Q_WG_BYTES;
    int s = 0, phase = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      int qb, b, h;
      tile_coords(tile, n_bh, n_qb, Hq, causal, qb, b, h);
      const int q0 = qb * bq;
      const int nst = tile_stages(q0, bq, q_off, n_stages, KEYS, causal);
      const int qpos0 = q0 + wg * WG_ROWS + row0 + q_off;
      const int wg_qmin = q0 + wg * WG_ROWS + q_off;

      float o[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      mbar_wait(&q_full, it & 1);
      for (int i = 0; i < nst; ++i) {
        const uint32_t k_addr = smem_u32(ring_smem + s * C::STAGE);
        const uint32_t v_addr = k_addr + C::KV_BYTES;

        // ---- S = Q K^T: 64 rows x KEYS keys, f32 ----
        float sc[KEYS / 2];
#pragma unroll
        for (int e = 0; e < KEYS / 2; ++e) sc[e] = 0.f;
        mbar_wait(&full_k[s], phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D_PAD / 16; ++kk) {
          const uint32_t off = (kk & 3) * 32;   // slab kk / 4, 16 columns
          wgmma_tile<KEYS, 0>(
              sc, make_desc(q_addr + (kk >> 2) * (Q_WG_BYTES / 2) + off, 16,
                            1024),
              make_desc(k_addr + (kk >> 2) * C::SLAB + off, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < KEYS / 2; ++e) fence_operand(sc[e]);
        if (i == nst - 1 && lane == 0) mbar_arrive(&q_empty);

        // ---- scale (log2 domain), mask, online softmax ----
        const int k0 = i * KEYS;
        const bool edge =
            k0 + KEYS > Skv || (causal && k0 + KEYS - 1 > wg_qmin);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + col + (e & 1);
              if (key >= Skv) x = -INFINITY;              // past the keys
              else if (causal && key > qpos0 + 8 * (e >> 1)) x = NEG_INF;
            }
            sc[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffff, mx[hh], 2));
          const float m_new = fmaxf(m[hh], mx[hh]);
          corr[hh] = ex2(m[hh] - m_new);
          m[hh] = m_new;
        }
        // P in bf16 as wgmma's A fragment: for the 16 keys of step kk, the
        // accumulator columns 8(2kk) .. 8(2kk+1)+7 in mma.sync's A order
        uint32_t pa[KEYS / 16][4];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          const float p0 = ex2(sc[4 * j] - m[0]);
          const float p1 = ex2(sc[4 * j + 1] - m[0]);
          const float p2 = ex2(sc[4 * j + 2] - m[1]);
          const float p3 = ex2(sc[4 * j + 3] - m[1]);
          rs[0] += p0 + p1;
          rs[1] += p2 + p3;
          pa[j >> 1][(j & 1) * 2] = pack_bf16x2(p0, p1);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
        }
        // each thread keeps its share of l; a row's 4 add up at the end
        l[0] = l[0] * corr[0] + rs[0];
        l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }

        // ---- O += P V ----
        mbar_wait(&full_v[s], phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk)
          wgmma_m64n128_rs<1>(o, pa[kk],
                              make_desc(v_addr + kk * 2048, C::SLAB, 1024));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) fence_operand(o[e]);
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == ring) { s = 0; phase ^= 1; }
      }

      // ---- epilogue: O / max(l, 1e-30) in bf16, staged in shared ----
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffff, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffff, l[hh], 2);
        inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
      }
      // the warpgroup has read the tile before out of the staging area
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      // row r, 16-byte chunk c at r * 256 + ((c ^ (r & 7)) * 16): the 8
      // rows of a warp's store fall on distinct banks
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(o_tile + r * 256 +
                                       ((j ^ (r & 7)) * 16) + 2 * col) =
              pack_bf16x2(o[4 * j + 2 * hh] * inv[hh],
                          o[4 * j + 2 * hh + 1] * inv[hh]);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int rows = min(WG_ROWS, bq - wg * WG_ROWS);  // rows of the block
      __nv_bfloat16* ob =
          out + (((size_t)b * Hq + h) * Sq + q0 + wg * WG_ROWS) * d;
#pragma unroll
      for (int r8 = 0; r8 < WG_ROWS / 8; ++r8) {
        const int r = r8 * 8 + (t >> 4), c = t & 15;
        if (r < rows && c * 8 < d)      // the first d columns only
          *reinterpret_cast<uint4*>(ob + (size_t)r * d + c * 8) =
              *reinterpret_cast<const uint4*>(o_tile + r * 256 +
                                              ((c ^ (r & 7)) * 16));
      }
    }
  }
}

// A 4-D bf16 map over (d, S, H, B) with the tensor's strides (elements) of
// its S, H and B dimensions; boxes of 64 x rows x 1 x 1, 128-byte swizzle;
// out-of-bounds rows, and the columns of the two 64-column slabs past d,
// read as zero.
bool make_map_4d(CUtensorMap* map, const void* ptr, int d, int S, int H,
                 int B, long long ss, long long sh, long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

template <int NWG, int KEYS>
cudaError_t launch_tma(const CUtensorMap& mq, const CUtensorMap& mk,
                       const CUtensorMap& mv, __nv_bfloat16* out, int B,
                       int Hq, int Hkv, int Sq, int Skv, int d, int bq,
                       int n_stages, int ring, int causal, float scale_log2,
                       cudaStream_t stream) {
  // Q and the output staging, then the ring
  const int smem =
      2 * NWG * Q_WG_BYTES + ring * StageCfg<KEYS>::STAGE + 1024;
  const int sms = sm_count();
  if (smem > SMEM_DYN || sms <= 0) return cudaErrorInvalidValue;
  auto kernel = flash_tma_kernel<NWG, KEYS>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int tiles = (Sq / bq) * B * Hq;
  kernel<<<tiles < sms ? tiles : sms, (NWG + 1) * 128, smem, stream>>>(
      mq, mk, mv, out, B, Hq, Hkv, Sq, Skv, d, bq, n_stages, ring, causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// C entry point of variant A.  D is the true head dim (a multiple of 8 up
// to D_PAD); bq is the effective (clamped) query block,
// warpgroups = ceil(bq / 64), stage_keys (64 or 128) the keys a ring stage
// holds, n_stages = ceil(Skv / stage_keys), ring the stages of the ring
// (kernels/ops.py:attention_launch_plan).  Strides are in elements; D is
// contiguous.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a plan the kernel does not take, or
// cudaErrorNotSupported when the tensor maps cannot be made.
extern "C" int repro_flash_fwd_tma_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int bq, int warpgroups,
    int stage_keys, int n_stages, int ring, int causal, float scale,
    void* stream) {
  if (D < 8 || D % 8 || D > D_PAD || bq < 1 || Sq % bq || Hkv < 1 ||
      Hq % Hkv ||
      warpgroups != (bq + WG_ROWS - 1) / WG_ROWS ||
      (long long)n_stages * stage_keys < Skv ||
      (long long)(n_stages - 1) * stage_keys >= Skv || ring < 1 ||
      ring > MAX_RING)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map_4d(&mq, q, D, Sq, Hq, B, qss, qsh, qsb, WG_ROWS) ||
      !make_map_4d(&mk, k, D, Skv, Hkv, B, kss, ksh, ksb, stage_keys) ||
      !make_map_4d(&mv, v, D, Skv, Hkv, B, vss, vsh, vsb, stage_keys))
    return (int)cudaErrorNotSupported;
  const float scale_log2 = scale * 1.4426950408889634f;
  auto o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(W_, K_)                                                 \
  if (warpgroups == W_ && stage_keys == K_)                                   \
    return (int)launch_tma<W_, K_>(mq, mk, mv, o, B, Hq, Hkv, Sq, Skv, D,     \
                                   bq, n_stages, ring, causal, scale_log2,    \
                                   st);
  REPRO_FA_CASE(1, 64)
  REPRO_FA_CASE(1, 128)
  REPRO_FA_CASE(2, 64)
  REPRO_FA_CASE(2, 128)
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}

// C entry point of variant B.  D is the true head dim (a multiple of 8 up
// to D_PAD); (bq, bkv) are the effective (clamped) blocks; strides in
// elements, each tensor's four; vec_* say that a tensor's rows are
// contiguous and 16-byte aligned.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a head dim the kernel does not take.
extern "C" int repro_flash_fwd_unaligned_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long qsd, long long ksb, long long ksh,
    long long kss, long long ksd, long long vsb, long long vsh,
    long long vss, long long vsd, int bq, int bkv, int causal, int vec_q,
    int vec_k, int vec_v, float scale, void* stream) {
  if (D < 8 || D % 8 || D > D_PAD) return (int)cudaErrorInvalidValue;
  const int nwarps = (bq + 15) / 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)nwarps * 16 * DP + KV_SUB * DP + D_PAD * KVP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_unaligned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Sq / bq, B * Hq);
  flash_unaligned_kernel<<<grid, nwarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, Sq, Skv, D, qsb, qsh, qss, qsd, ksb, ksh, kss, ksd, vsb, vsh,
      vss, vsd, bq, bkv, causal, scale, vec_q, vec_k, vec_v);
  return (int)cudaGetLastError();
}
