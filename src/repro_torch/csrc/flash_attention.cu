// K2: flash-attention forward, bf16 in and out, f32 online softmax.
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas / _flash_kernel).
//
// q (B, Hq, Sq, D), k (B, Hkv, Skv, D) and v (B, Hkv, Skv, Dv), each read
// through its own strides (the model's v is the transposed view of its
// projection, strides (S*H*Dv, Dv, H*Dv, 1)); out (B, Hq, Sq, Dv)
// contiguous.  GQA is read in place: query head h uses KV head
// h / (Hq / Hkv).
//
// Head dims: D and the value dim Dv multiples of 8 up to 192, Dv padded no
// wider than D (kernels/ops.py: head_dim_ok; MLA has D = 192, Dv = 128).
// Variant A computes Q.K^T at D's own padded width and P.V at Dv's, in one
// tile a (query block, batch, head), at the widths the caller passes
// (ops.attn_widths): each rounded up to 64, 96, 128 or 192, equal up to
// 128, and (192, 128) or (192, 192) above; the entry point refuses a pair
// it does not compile.  A width is held in 64-column slabs with a 128-byte
// swizzle, and at 96 a last slab of 32 columns with a 64-byte swizzle (its
// own tensor maps and wgmma descriptors).  Variant B computes both at a
// width of 128, or 192 above (pad_dim).  Variant A's tensor maps carry the
// true D and Dv, so TMA fills the columns past them with zeros (Q.K^T over
// them adds exact zeros, its k16 steps in order, so the scores are those
// of any wider padding bit for bit; the P.V columns past Dv are computed
// and never stored); variant B masks its loads.  Both store only the first
// Dv columns.  The scale comes from the caller (1/sqrt(D) at the true D).
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
//    tile before (at S = 512 a tile has at most 4-8 stages).  One producer
//    thread loads each tile's Q and streams K tiles of stage_keys x DQK and
//    V tiles of stage_keys x DV through a ring of `ring` stages in dynamic
//    shared memory, each with full-K, full-V and empty mbarriers (Q with a
//    full and an empty one); 4-D tensor maps (D, S, H, B) over the tensors'
//    own strides, rows past Sq or Skv read as zero.  Each consumer
//    warpgroup computes S = Q.K^T with wgmma m64n{keys}k16 over DQK / 16
//    steps (Q and K K-major in shared memory, 16 columns of a slab a step),
//    scales by scale*log2(e), masks and runs the online softmax in
//    registers with exp2 (a row's statistics shared by its 4 threads), and
//    feeds P, rounded to bf16 in registers, as the A operand of O += P.V
//    (wgmma m64n{DV}k16, V MN-major through the transpose bit, read in
//    place; at DV = 96 an n64 and an n32 product a step).  A consumer holds
//    O at 64 x DV (DV / 2 f32 a thread), its scores (keys / 2) and P (keys
//    / 4 registers).  A bkv above the stage is walked in stages with the
//    rescale per stage: the same function up to rounding.  Under a causal
//    mask only the stages that cross a warpgroup's diagonal are masked,
//    and the heaviest query blocks come first.  The epilogue writes O / l
//    in bf16 through a staging tile of 64 x DV in shared memory, 16-byte
//    stores.  Stages (ops.attention_launch_plan): 128 keys, or 64 where
//    bkv < 128 or DQK = 192 (96- and 128-key stages ran slower at
//    mla.core); at D = Dv = 128 a ring of 2 (ops.ATTN_RING), at other
//    widths the deepest ring that fits, up to MAX_RING.
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

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// B. unaligned operands
// ---------------------------------------------------------------------------

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

// DQK, DV: the padded widths of D and Dv (128 or 192).
template <int DQK, int DV>
__global__ void __launch_bounds__(256)
flash_unaligned_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Hq, int Hkv,
                       int Sq, int Skv, int d, int dv, long long qsb,
                       long long qsh, long long qss, long long qsd,
                       long long ksb, long long ksh, long long kss,
                       long long ksd,
                       long long vsb, long long vsh, long long vss,
                       long long vsd, int bq, int bkv, int causal,
                       float scale, int vec_q, int vec_k, int vec_v) {
  constexpr int DP = DQK + 8;    // row pitch of Q and K tiles (bank spread)
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
  for (int i = tid; i < nwarps * 16 * (DQK / 8); i += blockDim.x) {
    const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < bq && c < d)
      val = load8(qb + (q0 + r) * qss + c * qsd, qsd, vec_q);
    *reinterpret_cast<uint4*>(Qs + r * DP + c) = val;
  }
  __syncthreads();
  uint32_t qa[DQK / 16][4];
  {
    const __nv_bfloat16* qr = Qs + (warp * 16 + g) * DP;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      qa[kk][0] = ld_u32(qr + kk * 16 + 2 * t);
      qa[kk][1] = ld_u32(qr + 8 * DP + kk * 16 + 2 * t);
      qa[kk][2] = ld_u32(qr + kk * 16 + 2 * t + 8);
      qa[kk][3] = ld_u32(qr + 8 * DP + kk * 16 + 2 * t + 8);
    }
  }

  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
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
      for (int i = tid; i < KV_SUB * (DQK / 8); i += blockDim.x) {
        const int r = i / (DQK / 8), c = (i % (DQK / 8)) * 8;
        const bool ok = ks + r < kend;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (ok && c < d) kv = load8(kb_ + (ks + r) * kss + c * ksd, ksd, vec_k);
        if (ok && c < dv) vv = load8(vb + (ks + r) * vss + c * vsd, vsd, vec_v);
        *reinterpret_cast<uint4*>(Ks + r * DP + c) = kv;
        if (c < DV) {       // DV <= DQK
          const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            Vt[(c + e) * KVP + r] = ok ? ve[e] : zero;
        }
      }
      __syncthreads();

      // ---- scores S = Q K^T for this warp's 16 rows x 64 keys ----
      float s[KV_SUB / 8][4];
#pragma unroll
      for (int nt = 0; nt < KV_SUB / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
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
      for (int dt = 0; dt < DV / 8; ++dt) {
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
        for (int dt = 0; dt < DV / 8; ++dt) {
          const __nv_bfloat16* vr = Vt + (dt * 8 + g) * KVP + j * 16 + 2 * t;
          mma_bf16_16816(o[dt], pa, ld_u32(vr), ld_u32(vr + 8));
        }
      }
      __syncthreads();
    }
  }

  // ---- out = acc / max(l, 1e-30): the first dv columns ----
  __nv_bfloat16* ob = out + ((long long)bh * Sq + q0) * dv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= bq) continue;
    const float l = fmaxf(l_row[hh], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      if (dt * 8 < dv)
        *reinterpret_cast<uint32_t*>(ob + r * dv + dt * 8 + 2 * t) =
            pack_bf16x2(o[dt][2 * hh] / l, o[dt][2 * hh + 1] / l);
    }
  }
}

// ---------------------------------------------------------------------------
// A. TMA ring, one producer thread, wgmma from consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;                 // query rows a consumer warpgroup
constexpr int SLAB_COLS = 64;               // columns of a slab (128 bytes)
constexpr int TAIL_COLS = 32;               // columns of a last slab (64 bytes)
constexpr int Q_SLAB = WG_ROWS * SLAB_COLS * 2;  // a 64 x 64 slab of Q
constexpr int MAX_RING = 4;
constexpr int PRODUCER_REGS = 40;           // setmaxnreg of the two-consumer
constexpr int CONSUMER_REGS = 232;          // kernels (40 + 2 * 232 = 3 * 168)
constexpr int SMEM_LIMIT = 232448;          // bytes a block may use on sm_90
constexpr int SMEM_DYN = SMEM_LIMIT - 1024; // dynamic part (static: barriers)

// A padded width W (64, 96, 128 or 192 columns) in shared memory: W / 64
// slabs of 64 columns, 128-byte swizzle, and where W is 96 a last slab of
// 32 columns, 64-byte swizzle (its own tensor map, and wgmma descriptors
// of layout type 2).
template <int W>
struct Slabs {
  static_assert(W % SLAB_COLS == 0 || W % SLAB_COLS == TAIL_COLS,
                "a width of whole 64-column slabs and at most one of 32");
  static constexpr int FULL = W / SLAB_COLS;
  static constexpr bool TAIL = W % SLAB_COLS != 0;
};

// A warpgroup's output staging: 64 rows of DV columns in 16-byte chunks.
// Rows of a multiple of 8 chunks put chunk c of row r at c ^ (r & 7), rows
// of 12 (DV = 96) are padded by one chunk: either way the 8 rows of a
// warp's 4-byte stores fall on distinct banks.
template <int DV>
struct Staging {
  static constexpr int CHUNKS = DV / 8;
  static constexpr bool SWIZZLE = CHUNKS % 8 == 0;
  static constexpr int PITCH = SWIZZLE ? DV * 2 : DV * 2 + 16;
  static constexpr int BYTES = WG_ROWS * PITCH;
  __device__ static int at(int r, int c) {
    return r * PITCH + (SWIZZLE ? c ^ (r & 7) : c) * 16;
  }
};

// A warpgroup's Q tile, and a stage of the ring: a K tile of DQK columns
// and a V tile of DV columns, KEYS rows each, each in the slabs of Slabs.
template <int KEYS, int DQK, int DV>
struct StageCfg {
  static constexpr int Q_WG_BYTES = WG_ROWS * DQK * 2;
  static constexpr int SLAB = KEYS * SLAB_COLS * 2;  // KEYS rows x 64 cols
  static constexpr int K_BYTES = KEYS * DQK * 2;
  static constexpr int V_BYTES = KEYS * DV * 2;
  static constexpr int STAGE = K_BYTES + V_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tiles the kernel walks: one a (query block, batch, head), each
// computing its scores once.
__host__ __device__ __forceinline__ int tma_tiles(int B, int Hq, int Sq,
                                                  int bq) {
  return (Sq / bq) * B * Hq;
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

// Load columns [0, W) of rows (c1, c2, c3) of a 4-D map into the slabs at
// dst (rows of the box apart: `slab` bytes a 64-column slab): the 64-column
// slabs through `map`, a 32-column last slab through `tail`.
template <int W>
__device__ __forceinline__ void load_slabs(uint8_t* dst, int slab,
                                           const CUtensorMap* map,
                                           const CUtensorMap* tail, int c1,
                                           int c2, int c3, uint64_t* bar) {
  for (int c = 0; c < Slabs<W>::FULL; ++c)
    tma_load_4d(dst + c * slab, map, c * SLAB_COLS, c1, c2, c3, bar);
  if constexpr (Slabs<W>::TAIL)
    tma_load_4d(dst + Slabs<W>::FULL * slab, tail,
                Slabs<W>::FULL * SLAB_COLS, c1, c2, c3, bar);
}

// DQK, DV: the padded widths of Q.K^T and P.V (ops.attn_widths).  The maps
// carry the true D and Dv; map_*t are the 32-column maps of a 96 width.
template <int NWG, int KEYS, int DQK, int DV>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_qt,
                 const __grid_constant__ CUtensorMap map_kt,
                 const __grid_constant__ CUtensorMap map_vt,
                 __nv_bfloat16* __restrict__ out, int B, int Hq, int Hkv,
                 int Sq, int Skv, int dv, int bq, int n_stages, int ring,
                 int causal, float scale_log2) {
  using C = StageCfg<KEYS, DQK, DV>;
  using QK = Slabs<DQK>;
  using O = Staging<DV>;
  // 128-key stages at D = Dv = 128 keep 240 registers a consumer (S, P
  // and O take 160) and 24 for the producer; the other kernels spill
  // nothing at CONSUMER_REGS, and their producer needs more than 24 (at
  // 24 it spilled 4 bytes, the 64-key (128, 128) one too)
  constexpr bool WIDE_128 = KEYS == 128 && DQK == 128 && DV == 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_k[MAX_RING];
  __shared__ __align__(8) uint64_t full_v[MAX_RING];
  __shared__ __align__(8) uint64_t empty[MAX_RING];
  __shared__ __align__(8) uint64_t q_full, q_empty;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* o_smem = smem + NWG * C::Q_WG_BYTES;   // output staging
  uint8_t* ring_smem = o_smem + NWG * O::BYTES;

  const int tid = threadIdx.x;
  const int n_bh = B * Hq, n_qb = Sq / bq;
  const int n_tiles = tma_tiles(B, Hq, Sq, bq);
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
    if constexpr (NWG == 2 && WIDE_128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    else if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
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
          mbar_expect_tx(&full_k[s], C::K_BYTES);
          load_slabs<DQK>(st, C::SLAB, &map_k, &map_kt, i * KEYS, hk, b,
                          &full_k[s]);
          mbar_expect_tx(&full_v[s], C::V_BYTES);
          load_slabs<DV>(st + C::K_BYTES, C::SLAB, &map_v, &map_vt,
                         i * KEYS, hk, b, &full_v[s]);
          if (++s == ring) { s = 0; phase ^= 1; }
          if (i == 0) {     // Q once the tile before has read its own
            if (it > 0) mbar_wait(&q_empty, (it - 1) & 1);
            mbar_expect_tx(&q_full, NWG * C::Q_WG_BYTES);
            for (int w = 0; w < NWG; ++w)
              load_slabs<DQK>(smem + w * C::Q_WG_BYTES, Q_SLAB, &map_q,
                              &map_qt, q0 + w * WG_ROWS, h, b, &q_full);
          }
        }
      }
    }
  } else {
    // ---- consumers: one warpgroup per 64 query rows ----
    if constexpr (NWG == 2 && WIDE_128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    else if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int row0 = warp * 16 + (lane >> 2);   // accumulator rows row0, +8
    const int col = 2 * (lane & 3);
    const uint32_t q_addr = smem_u32(smem + wg * C::Q_WG_BYTES);
    uint8_t* o_tile = o_smem + wg * O::BYTES;
    int s = 0, phase = 0, it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      int qb, b, h;
      tile_coords(tile, n_bh, n_qb, Hq, causal, qb, b, h);
      const int q0 = qb * bq;
      const int nst = tile_stages(q0, bq, q_off, n_stages, KEYS, causal);
      const int qpos0 = q0 + wg * WG_ROWS + row0 + q_off;
      const int wg_qmin = q0 + wg * WG_ROWS + q_off;

      float o[DV / 2];
#pragma unroll
      for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      mbar_wait(&q_full, it & 1);
      for (int i = 0; i < nst; ++i) {
        const uint32_t k_addr = smem_u32(ring_smem + s * C::STAGE);
        const uint32_t v_addr = k_addr + C::K_BYTES;

        // ---- S = Q K^T: 64 rows x KEYS keys, f32 ----
        float sc[KEYS / 2];
#pragma unroll
        for (int e = 0; e < KEYS / 2; ++e) sc[e] = 0.f;
        mbar_wait(&full_k[s], phase);
        wgmma_fence();
        if constexpr (DQK == 128) {
#pragma unroll
          for (int kk = 0; kk < DQK / 16; ++kk) {
            const uint32_t off = (kk & 3) * 32;   // slab kk / 4, 16 columns
            wgmma_tile<KEYS, 0>(
                sc, make_desc(q_addr + (kk >> 2) * Q_SLAB + off, 16, 1024),
                make_desc(k_addr + (kk >> 2) * C::SLAB + off, 16, 1024));
          }
        } else {
          // DQK / 16 steps in order: each descriptor the stage's base plus
          // a constant (the address field counts 16 bytes), made anew each
          // stage so that no step's descriptor stays live beside O and S;
          // a 32-column last slab (64-byte rows) takes two steps
          uint64_t dq = make_desc(q_addr, 16, 1024);
          uint64_t dk = make_desc(k_addr, 16, 1024);
          asm volatile("" : "+l"(dq), "+l"(dk));
#pragma unroll
          for (int kk = 0; kk < QK::FULL * 4; ++kk) {
            const uint32_t off = (kk & 3) * 32;
            wgmma_tile<KEYS, 0>(sc, dq + (((kk >> 2) * Q_SLAB + off) >> 4),
                                dk + (((kk >> 2) * C::SLAB + off) >> 4));
          }
          if constexpr (QK::TAIL) {
            uint64_t dqt = make_desc(q_addr + QK::FULL * Q_SLAB, 16, 512, 2);
            uint64_t dkt = make_desc(k_addr + QK::FULL * C::SLAB, 16, 512, 2);
            asm volatile("" : "+l"(dqt), "+l"(dkt));
#pragma unroll
            for (int kk = 0; kk < TAIL_COLS / 16; ++kk)
              wgmma_tile<KEYS, 0>(sc, dqt + kk * 2, dkt + kk * 2);
          }
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
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }

        // ---- O += P V: all DV columns in one tile ----
        mbar_wait(&full_v[s], phase);
        wgmma_fence();
        if constexpr (Slabs<DV>::TAIL) {
          // DV = 96: the 64-column slab, then the 32-column one (64-byte
          // rows: 16 keys a step are 1024 bytes), into O's columns 64..95
          static_assert(DV == SLAB_COLS + TAIL_COLS, "one slab and a tail");
          float(&o_lo)[SLAB_COLS / 2] =
              *reinterpret_cast<float(*)[SLAB_COLS / 2]>(o);
          float(&o_hi)[TAIL_COLS / 2] =
              *reinterpret_cast<float(*)[TAIL_COLS / 2]>(o + SLAB_COLS / 2);
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk) {
            wgmma_tile_rs<SLAB_COLS, 1>(
                o_lo, pa[kk], make_desc(v_addr + kk * 2048, C::SLAB, 1024));
            wgmma_tile_rs<TAIL_COLS, 1>(
                o_hi, pa[kk],
                make_desc(v_addr + C::SLAB + kk * 1024, C::SLAB / 2, 512, 2));
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KEYS / 16; ++kk)
            wgmma_tile_rs<DV, 1>(o, pa[kk],
                                 make_desc(v_addr + kk * 2048, C::SLAB, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < DV / 2; ++e) fence_operand(o[e]);
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
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(o_tile + O::at(r, j) + 2 * col) =
              pack_bf16x2(o[4 * j + 2 * hh] * inv[hh],
                          o[4 * j + 2 * hh + 1] * inv[hh]);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int rows = min(WG_ROWS, bq - wg * WG_ROWS);  // rows of the block
      __nv_bfloat16* ob =
          out + (((size_t)b * Hq + h) * Sq + q0 + wg * WG_ROWS) * dv;
      // rolled at DV = 192: unrolled, its 12 rows' addresses are hoisted
      // out of the stage loop and spill
#pragma unroll (DV > 128 ? 1 : WG_ROWS * O::CHUNKS / 128)
      for (int k = 0; k < WG_ROWS * O::CHUNKS / 128; ++k) {
        const int r = (k * 128 + t) / O::CHUNKS, c = (k * 128 + t) % O::CHUNKS;
        if (r < rows && c * 8 < dv)   // the first dv columns only
          *reinterpret_cast<uint4*>(ob + (size_t)r * dv + c * 8) =
              *reinterpret_cast<const uint4*>(o_tile + O::at(r, c));
      }
    }
  }
}

// A 4-D bf16 map over (d, S, H, B) with the tensor's strides (elements) of
// its S, H and B dimensions; boxes of cols x rows x 1 x 1, cols 64 with a
// 128-byte swizzle or 32 with a 64-byte one; out-of-bounds rows, and the
// columns of a box past d, read as zero.
bool make_map_4d(CUtensorMap* map, const void* ptr, int d, int S, int H,
                 int B, long long ss, long long sh, long long sb, int rows,
                 int cols = SLAB_COLS) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == SLAB_COLS ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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

// What the last launch of variant A in this process ran at: warpgroups,
// stage keys, the widths of Q.K^T and P.V, the ring and the dynamic shared
// memory it asked for (repro_flash_tma_last_launch).
int last_launch[6] = {0, 0, 0, 0, 0, 0};

template <int NWG, int KEYS, int DQK, int DV>
cudaError_t launch_tma(const CUtensorMap (&maps)[6], __nv_bfloat16* out,
                       int B, int Hq, int Hkv, int Sq, int Skv, int dv,
                       int bq, int n_stages, int ring, int causal,
                       float scale_log2, cudaStream_t stream) {
  using C = StageCfg<KEYS, DQK, DV>;
  // Q and the output staging, then the ring
  const int smem =
      NWG * (C::Q_WG_BYTES + Staging<DV>::BYTES) + ring * C::STAGE + 1024;
  const int sms = sm_count();
  if (smem > SMEM_DYN || sms <= 0) return cudaErrorInvalidValue;
  auto kernel = flash_tma_kernel<NWG, KEYS, DQK, DV>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int tiles = tma_tiles(B, Hq, Sq, bq);
  kernel<<<tiles < sms ? tiles : sms, (NWG + 1) * 128, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], out, B, Hq, Hkv,
      Sq, Skv, dv, bq, n_stages, ring, causal, scale_log2);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    const int ran[6] = {NWG, KEYS, DQK, DV, ring, smem};
    for (int i = 0; i < 6; ++i) last_launch[i] = ran[i];
  }
  return err;
}

// The true head and value dims D and Dv fit the padded widths dqk and dvp
// (multiples of 8, none wider than its width); the dispatch refuses a pair
// of widths it does not compile.
bool dims_fit(int D, int Dv, int dqk, int dvp) {
  return D >= 8 && D % 8 == 0 && D <= dqk && Dv >= 8 && Dv % 8 == 0 &&
         Dv <= dvp;
}

// The padded width variant B computes a head dim in (kernels/ops.py:
// attn_d_pad), or 0 for one it does not take (ops.head_dim_ok).
int pad_dim(int d) {
  if (d < 8 || d % 8 || d > 192) return 0;
  return d <= 128 ? 128 : 192;
}

// Variant B at the padded widths DQK, DV: shared memory for the query
// warps' Q rows and a 64-key K sub-slab at DQK, and the transposed V
// sub-slab at DV.
template <int DQK, int DV>
cudaError_t launch_unaligned(const void* q, const void* k, const void* v,
                             void* out, int B, int Hq, int Hkv, int Sq,
                             int Skv, int D, int Dv, long long qsb,
                             long long qsh, long long qss, long long qsd,
                             long long ksb, long long ksh, long long kss,
                             long long ksd, long long vsb, long long vsh,
                             long long vss, long long vsd, int bq, int bkv,
                             int causal, int vec_q, int vec_k, int vec_v,
                             float scale, cudaStream_t stream) {
  const int nwarps = (bq + 15) / 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(nwarps * 16 + KV_SUB) * (DQK + 8) +
                       (size_t)DV * KVP);
  auto kernel = flash_unaligned_kernel<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / bq, B * Hq);
  kernel<<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Hq, Hkv, Sq, Skv, D, Dv, qsb, qsh, qss, qsd, ksb, ksh, kss, ksd, vsb,
      vsh, vss, vsd, bq, bkv, causal, scale, vec_q, vec_k, vec_v);
  return cudaGetLastError();
}

}  // namespace

// C entry point of variant A.  D and Dv are the true head and value dims
// (multiples of 8 up to 192, Dv padded no wider than D); bq is the
// effective (clamped) query block, warpgroups = ceil(bq / 64), stage_keys
// (64 or 128) the keys a ring stage holds, n_stages = ceil(Skv /
// stage_keys), ring the stages of the ring, dqk and dvp the widths Q.K^T
// and P.V run at (kernels/ops.py: attention_launch_plan, its d_pad and
// dv_pad).  Strides are in elements; D is contiguous.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a plan
// the kernel does not take (a pair of widths or a stage it does not
// compile among them), or cudaErrorNotSupported when the tensor maps
// cannot be made.
extern "C" int repro_flash_fwd_tma_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int bq, int warpgroups,
    int stage_keys, int n_stages, int ring, int dqk, int dvp, int causal,
    float scale, void* stream) {
  if (!dims_fit(D, Dv, dqk, dvp) || bq < 1 || Sq % bq || Hkv < 1 ||
      Hq % Hkv ||
      warpgroups != (bq + WG_ROWS - 1) / WG_ROWS ||
      (long long)n_stages * stage_keys < Skv ||
      (long long)(n_stages - 1) * stage_keys >= Skv || ring < 1 ||
      ring > MAX_RING)
    return (int)cudaErrorInvalidValue;
  // the 64-column maps, then the 32-column ones of a 96 width (else unused)
  CUtensorMap maps[6];
  if (!make_map_4d(&maps[0], q, D, Sq, Hq, B, qss, qsh, qsb, WG_ROWS) ||
      !make_map_4d(&maps[1], k, D, Skv, Hkv, B, kss, ksh, ksb, stage_keys) ||
      !make_map_4d(&maps[2], v, Dv, Skv, Hkv, B, vss, vsh, vsb, stage_keys))
    return (int)cudaErrorNotSupported;
  maps[3] = maps[0];
  maps[4] = maps[1];
  maps[5] = maps[2];
  if ((dqk % SLAB_COLS &&
       (!make_map_4d(&maps[3], q, D, Sq, Hq, B, qss, qsh, qsb, WG_ROWS,
                     TAIL_COLS) ||
        !make_map_4d(&maps[4], k, D, Skv, Hkv, B, kss, ksh, ksb, stage_keys,
                     TAIL_COLS))) ||
      (dvp % SLAB_COLS &&
       !make_map_4d(&maps[5], v, Dv, Skv, Hkv, B, vss, vsh, vsb, stage_keys,
                    TAIL_COLS)))
    return (int)cudaErrorNotSupported;
  const float scale_log2 = scale * 1.4426950408889634f;
  auto o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(W_, K_, DQ_, DV_)                                       \
  if (warpgroups == W_ && stage_keys == K_ && dqk == DQ_ && dvp == DV_)       \
    return (int)launch_tma<W_, K_, DQ_, DV_>(maps, o, B, Hq, Hkv, Sq, Skv,    \
                                             Dv, bq, n_stages, ring, causal,  \
                                             scale_log2, st);
  REPRO_FA_CASE(1, 64, 64, 64)         // D <= 64: one slab
  REPRO_FA_CASE(1, 128, 64, 64)
  REPRO_FA_CASE(2, 64, 64, 64)
  REPRO_FA_CASE(2, 128, 64, 64)
  REPRO_FA_CASE(1, 64, 96, 96)         // a slab and a 32-column one
  REPRO_FA_CASE(1, 128, 96, 96)
  REPRO_FA_CASE(2, 64, 96, 96)
  REPRO_FA_CASE(2, 128, 96, 96)
  REPRO_FA_CASE(1, 64, 128, 128)
  REPRO_FA_CASE(1, 128, 128, 128)
  REPRO_FA_CASE(2, 64, 128, 128)
  REPRO_FA_CASE(2, 128, 128, 128)
  REPRO_FA_CASE(1, 64, 192, 128)       // MLA's mla.core: three slabs of D
  REPRO_FA_CASE(2, 64, 192, 128)
  REPRO_FA_CASE(1, 64, 192, 192)       // D = Dv = 192: scores once
  REPRO_FA_CASE(2, 64, 192, 192)
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}

// The tiles variant A's kernel walks for a call (one a query block, batch
// and head: no tile computes its scores twice), or -1 for a block that
// does not divide Sq.
extern "C" int repro_flash_tma_tiles(int B, int Hq, int Sq, int bq) {
  if (bq < 1 || Sq % bq) return -1;
  return tma_tiles(B, Hq, Sq, bq);
}

// Writes what the last launch of variant A in this process ran at into
// vals[0..5]: warpgroups, stage keys, the widths of Q.K^T and P.V, the
// ring and the dynamic shared memory bytes it asked for (all 0 before the
// first launch).
extern "C" void repro_flash_tma_last_launch(int* vals) {
  for (int i = 0; i < 6; ++i) vals[i] = last_launch[i];
}


// C entry point of variant B.  D and Dv are the true head and value dims
// (multiples of 8 up to 192, Dv padded no wider than D); (bq, bkv) are the
// effective (clamped) blocks; strides in elements, each tensor's four;
// vec_* say that a tensor's rows are contiguous and 16-byte aligned.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for head dims the kernel does not take.
extern "C" int repro_flash_fwd_unaligned_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, int Dv, long long qsb, long long qsh,
    long long qss, long long qsd, long long ksb, long long ksh,
    long long kss, long long ksd, long long vsb, long long vsh,
    long long vss, long long vsd, int bq, int bkv, int causal, int vec_q,
    int vec_k, int vec_v, float scale, void* stream) {
  const int dqk = pad_dim(D), dvp = pad_dim(Dv);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(DQ_, DV_)                                               \
  if (dqk == DQ_ && dvp == DV_)                                               \
    return (int)launch_unaligned<DQ_, DV_>(                                   \
        q, k, v, out, B, Hq, Hkv, Sq, Skv, D, Dv, qsb, qsh, qss, qsd, ksb,    \
        ksh, kss, ksd, vsb, vsh, vss, vsd, bq, bkv, causal, vec_q, vec_k,     \
        vec_v, scale, st);
  REPRO_FA_CASE(128, 128)
  REPRO_FA_CASE(192, 128)
  REPRO_FA_CASE(192, 192)
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}
