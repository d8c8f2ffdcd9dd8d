// K3: SSD chunk scan, bf16 x/B/C in, la in bf16 or f32, f32 state and
// accumulation, bf16 out.  Replaces the TPU kernel
// src/repro/kernels/chunk_scan.py (chunk_scan_pallas / _chunk_kernel).
//
// x (G, S, P), B and C (G, S, N), la (G, S) log-decay, y (G, S, P); P and
// N multiples of 8 (the wrapper pads x when P is not), read as 2-D (rows =
// G*S) tensor maps.  Per group g and chunk c of Q positions, with cum =
// cumsum(la) in the chunk, A_c = exp(cum[Q-1]), d[q] = exp(cum[Q-1] -
// cum[q]) and L_ij = exp(cum_i - cum_j) for j <= i, else 0:
//   y_c   = exp(cum) .* (C_c S_c^T) + ((C_c B_c^T) .* L) x_c
//   S_0   = 0,  S_{c+1} = A_c S_c + x_c^T (B_c .* d)
//
// On the TPU the chunk axis of the grid runs in order on one core and
// carries S in VMEM.  Here the parallelism runs over chunks, the "state
// space duality" form of Mamba-2 (Dao & Gu, 2024).  The state is computed
// transposed (rows n, columns p) and stored so, S_c^T.  Two variants,
// chosen in kernels/ops.py:chunk_launch_plan:
//   three_pass
//   chunk_state  dS_c^T = (B_c .* d)^T x_c, f32, every chunk at once: a CTA
//                per (g, c, 64 or 128 rows of N, PW columns of P).  A
//                producer thread streams 64-row slabs of B and x by TMA
//                (128-byte swizzle) into a ring; each consumer warpgroup
//                reads its A fragments of B with ldmatrix.trans from the
//                swizzled slab, scales them by d in registers (rounded to
//                bf16 there) and runs wgmma with A from registers and x
//                MN-major (transpose bit).  It also writes cum[Q-1] (log
//                A_c).
//   state_pass   S_{c+1} = A_c S_c + dS_c, f32, one thread per (g, n, p)
//                walking the chunks with its loads issued 8 ahead; when
//                there are few elements (a Mamba head: 1024), each walks a
//                segment of the chunks and the segments are joined by the
//                associative (a, b) o (a', b') = (a a', a' b + b').  S_c^T,
//                the state entering chunk c, is stored in bf16.
//   chunk_out    see below.
//   walk (many (N, P) tiles and many chunks: the xLSTM site at Q <= 256)
//   chunk_state  a CTA per (g, N rows, P columns) walks every chunk: its
//                accumulator is the f32 state, stored in bf16 as it enters
//                each chunk, scaled by A_c, then accumulating dS_c^T.  No
//                dS in device memory, no state_pass.
//   chunk_out    a CTA per (g, c, 64-row block), heaviest blocks first.
//                First the masked scores (C B^T) .* L of its rows against
//                the keys up to its last row (wgmma, both K-major, up to 4
//                key blocks a stage), in bf16 into shared memory in the
//                swizzled K-major layout wgmma reads.  Then for each tile
//                of PT columns of P: exp(cum_r) .* (C S_c^T) (S_c^T
//                MN-major), and the score stages times x (MN-major) into
//                the same accumulator; bf16 out.  At PT = 256 two consumer
//                warpgroups share each stage, 128 columns each.
// A 64-row box that runs past the chunk end reads the next chunk's rows:
// d = 0 there in chunk_state, L = 0 and no store in chunk_out.  TMA zero-
// fills past the tensors' ends and N below the 64-column box.  Every
// consumer computes cum from la (bf16 or f32) itself; the walk reads the
// next chunk's la into registers while the current one runs.
//
// Bound: at the xLSTM site as the runner builds it (G = 1, S = 8192, P = N
// = 1024) the operations, 38.7 GFLOP at Q = 256 against 67 MB.  three_pass
// adds dS (f32, written and read) and S_c (bf16, written and read) in
// device memory, nc * P * N * 12 bytes, which makes its time follow Q; the
// walk adds only S_c.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int QMAX = 1024;           // largest chunk
constexpr int NMAX = 1024;           // largest state width N
constexpr int BOX = 64;              // every TMA box is 64 x 64 bf16
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int MAX_RING = 4;
constexpr int SMEM_LIMIT = 232448;   // bytes a block may use on sm_90
constexpr int SMEM_DYN = SMEM_LIMIT - 9216;  // the rest: static (cum, d)
constexpr int SCAN_THREADS = 256;
constexpr int MAX_SEGMENTS = 32;

__device__ __forceinline__ float load_f(const float* p, int i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}

// Barrier 1: the consumer warpgroups only (the producer runs ahead).
template <int CONSUMERS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The consumer threads' shares of la[0, Q): thread t holds positions
// [t * seg, t * seg + seg), seg = ceil(Q / CONSUMERS), read as f32.
template <int CONSUMERS>
struct LaShare {
  static constexpr int MAXSEG = QMAX / CONSUMERS;
  float v[MAXSEG];

  __device__ __forceinline__ void load(const void* la, int la_bf16,
                                       long long row0, int Q) {
    const int seg = (Q + CONSUMERS - 1) / CONSUMERS;
    const int lo = threadIdx.x * seg;
#pragma unroll
    for (int k = 0; k < MAXSEG; ++k) {
      const int i = lo + k;
      v[k] = 0.f;
      if (k < seg && i < Q)
        v[k] = la_bf16 ? load_f(static_cast<const bf16*>(la) + row0, i)
                       : load_f(static_cast<const float*>(la) + row0, i);
    }
  }

  // Inclusive prefix sum into cum (shared, f32); wsum holds one float a
  // warp.  Ends with a consumer barrier.
  __device__ __forceinline__ void scan(int Q, float* cum,
                                       float* wsum) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int seg = (Q + CONSUMERS - 1) / CONSUMERS;
    const int lo = tid * seg;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAXSEG; ++k) {
      if (k < seg && lo + k < Q) {
        s += v[k];
        cum[lo + k] = s;
      }
    }
    float t = s;               // inclusive scan of the segment totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffff, t, o);
      if (lane >= o) t += u;
    }
    if (lane == 31) wsum[warp] = t;
    consumers_sync<CONSUMERS>();
    float off = t - s;
    for (int w = 0; w < warp; ++w) off += wsum[w];
#pragma unroll
    for (int k = 0; k < MAXSEG; ++k)
      if (k < seg && lo + k < Q) cum[lo + k] += off;
    consumers_sync<CONSUMERS>();
  }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int ring, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);   // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The producer's next ring slot: wait until the consumers have released
// it, then arm its full barrier for `bytes`.
__device__ __forceinline__ uint8_t* ring_slot(uint8_t* ring_smem, int stage,
                                              uint64_t* full, uint64_t* empty,
                                              int ring, int n, int bytes,
                                              uint64_t*& bar) {
  const int s = n % ring;
  if (n >= ring) mbar_wait(&empty[s], ((n / ring) - 1) & 1);
  bar = &full[s];
  mbar_expect_tx(bar, bytes);
  return ring_smem + s * stage;
}

// The consumers' slot for stage n, once its loads have landed.
__device__ __forceinline__ uint32_t ring_wait(uint8_t* ring_smem, int stage,
                                              uint64_t* full, int ring,
                                              int n) {
  const int s = n % ring;
  mbar_wait(&full[s], (n / ring) & 1);
  return smem_u32(ring_smem + s * stage);
}

__device__ __forceinline__ void ring_release(uint64_t* empty, int ring,
                                             int n) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[n % ring]);
}

template <int W>
__device__ __forceinline__ void zero_acc(float (&a)[W]) {
#pragma unroll
  for (int e = 0; e < W; ++e) a[e] = 0.f;
}

// After a stage's products are issued: wait for them, make the
// accumulator readable and hand the stage's slot back to the producer.
template <int W>
__device__ __forceinline__ void settle(float (&a)[W], uint64_t* empty,
                                       int ring, int n) {
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < W; ++e) fence_operand(a[e]);
  ring_release(empty, ring, n);
}

// ---------------------------------------------------------------------------
// pass 1: dS_c = x_c^T (B_c .* d), or the whole chain (WALK)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float d0,
                                               float d1) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16x2(f.x * d0, f.y * d1);
}

// The state is computed transposed, rows n and columns p: dS_c^T = (B_c
// .* d)^T x_c, so that the decayed operand is wgmma's A from registers
// (no generic-proxy write to shared memory, no fence, no barrier a stage).
// A CTA per (g, NWG * 64 rows of N, PW columns of P) and chunk (WALK =
// false: dS_c^T in f32 to `dstate`, log A_c to `alog`), or per (g, N
// rows, P columns) walking every chunk (WALK = true: the state pass fused
// in; the accumulator is the f32 state, which enters chunk c as S_c^T, is
// stored in bf16 to `states`, scaled by A_c and accumulates dS_c^T).  Each
// consumer warpgroup reads its 64 x 16 A fragments of B from the swizzled
// slab with ldmatrix.trans, scales them by d in registers (rounded to
// bf16 there, as the reference's B .* d), and takes x MN-major.
template <int PW, int NWG, bool WALK>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
chunk_state_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_b,
                   const void* __restrict__ la, int la_bf16,
                   float* __restrict__ dstate, float* __restrict__ alog,
                   bf16* __restrict__ states, int S, int P, int N, int Q,
                   int ring) {
  constexpr int CONSUMERS = NWG * 128;
  constexpr int ROWS = NWG * BOX;               // N rows a CTA
  constexpr int STAGE = NWG * BOX_BYTES + PW * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum[QMAX];
  __shared__ float dec[QMAX];
  __shared__ float wsum[16];
  __shared__ __align__(8) uint64_t full[MAX_RING];
  __shared__ __align__(8) uint64_t empty[MAX_RING];
  uint8_t* smem = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int n_nt = (N + ROWS - 1) / ROWS, n_pt = (P + PW - 1) / PW;
  const int nc = S / Q, nq = (Q + BOX - 1) / BOX;
  int t = blockIdx.x;
  const int pt = t % n_pt;
  t /= n_pt;
  const int nt = t % n_nt;
  t /= n_nt;
  const int c_lo = WALK ? 0 : t % nc, c_hi = WALK ? nc : c_lo + 1;
  const int g = WALK ? t : t / nc;

  init_ring(full, empty, ring, NWG * 4);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread streams the B and x slabs ----
    if (tid == CONSUMERS) {
      for (int c = c_lo, i = 0; c < c_hi; ++c) {
        const long long row0 = (long long)g * S + (long long)c * Q;
        for (int q = 0; q < nq; ++q, ++i) {
          uint64_t* bar;
          uint8_t* st =
              ring_slot(smem, STAGE, full, empty, ring, i, STAGE, bar);
          const int r = (int)(row0 + q * BOX);
#pragma unroll
          for (int w = 0; w < NWG; ++w)
            tma_load_2d(st + w * BOX_BYTES, &map_b, nt * ROWS + w * BOX, r,
                        bar);
#pragma unroll
          for (int j = 0; j < PW / BOX; ++j)
            tma_load_2d(st + NWG * BOX_BYTES + j * BOX_BYTES, &map_x,
                        pt * PW + j * BOX, r, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = tid / 128, lane = tid & 31, warp = (tid & 127) >> 5;
  const int r0 = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  // this lane's ldmatrix row: matrix lane / 8 of the warp's 16 x 16 A
  // fragment (n chunk + (m & 1), q + 8 (m >> 1)), its row lane % 8
  const int lm = lane >> 3;
  const int a_q = (lm >> 1) * 8 + (lane & 7);
  const int a_chunk = warp * 2 + (lm & 1);
  float acc[PW / 2];
  zero_acc(acc);
  LaShare<CONSUMERS> las;
  las.load(la, la_bf16, (long long)g * S + (long long)c_lo * Q, Q);
  for (int c = c_lo, i = 0; c < c_hi; ++c) {
    las.scan(Q, cum, wsum);
    // the next chunk's la is read while this one runs
    if (c + 1 < c_hi)
      las.load(la, la_bf16, (long long)g * S + (long long)(c + 1) * Q, Q);
    const float clast = cum[Q - 1];
    for (int q = tid; q < nq * BOX; q += CONSUMERS)
      dec[q] = q < Q ? __expf(clast - cum[q]) : 0.f;   // 0 past the chunk
    if (!WALK && nt == 0 && pt == 0 && tid == 0)
      alog[(long long)g * nc + c] = clast;
    if constexpr (WALK) {
      // S_c^T, the state entering chunk c, in bf16; then A_c S_c^T
      bf16* so = states + ((long long)g * nc + c) * N * P;
      const float keep = __expf(clast);
#pragma unroll
      for (int j = 0; j < PW / 8; ++j) {
        const int p = pt * PW + 8 * j + col;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = nt * ROWS + wg * BOX + r0 + 8 * hh;
          if (n < N && p < P)
            *reinterpret_cast<uint32_t*>(so + (long long)n * P + p) =
                pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          acc[4 * j + 2 * hh] *= keep;
          acc[4 * j + 2 * hh + 1] *= keep;
        }
      }
    }
    consumers_sync<CONSUMERS>();                 // dec is written
    for (int q = 0; q < nq; ++q, ++i) {
      const uint32_t sa = ring_wait(smem, STAGE, full, ring, i);
      const uint32_t ba = sa + wg * BOX_BYTES, xa = sa + NWG * BOX_BYTES;
      const float* dq = dec + q * BOX + col;
      uint32_t a[BOX / 16][4];
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk) {
        const int qr = kk * 16 + a_q;
        ldsm_x4_trans(a[kk], ba + qr * 128 + ((a_chunk ^ (qr & 7)) << 4));
        const float d0 = dq[kk * 16], d1 = dq[kk * 16 + 1];
        const float d2 = dq[kk * 16 + 8], d3 = dq[kk * 16 + 9];
        a[kk][0] = scale_pair(a[kk][0], d0, d1);
        a[kk][1] = scale_pair(a[kk][1], d0, d1);
        a[kk][2] = scale_pair(a[kk][2], d2, d3);
        a[kk][3] = scale_pair(a[kk][3], d2, d3);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk)
        wgmma_tile_rs<PW, 1>(acc, a[kk],
                             make_desc(xa + kk * 2048, BOX_BYTES, 1024));
      settle(acc, empty, ring, i);
    }
  }
  if constexpr (WALK) return;

  // ---- dS^T in f32, rows n, columns p ----
  float* out = dstate + ((long long)g * nc + c_lo) * N * P;
#pragma unroll
  for (int j = 0; j < PW / 8; ++j) {
    const int p = pt * PW + 8 * j + col;
    if (p >= P) continue;          // P % 8 == 0: p + 1 < P as well
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = nt * ROWS + wg * BOX + r0 + 8 * hh;
      if (n < N)
        *reinterpret_cast<float2*>(out + (long long)n * P + p) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: S_{c+1} = A_c S_c + dS_c
// ---------------------------------------------------------------------------

// Walk chunks [lo, hi) of one element from state s, the loads 8 ahead of
// the FMAs; with STORE, write each chunk's entering state in bf16.
// Returns the state after the walk; `a` gathers the log-decays.
template <bool STORE>
__device__ __forceinline__ float chain(const float* __restrict__ ds,
                                      const float* __restrict__ al,
                                      bf16* __restrict__ st, long long PN,
                                      int lo, int hi, float s, float& a) {
  for (int c0 = lo; c0 < hi; c0 += 8) {
    float v[8], l[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = c0 + u < hi;
      v[u] = in ? ds[(long long)(c0 + u) * PN] : 0.f;
      l[u] = in ? al[c0 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < hi) {
        if (STORE) st[(long long)(c0 + u) * PN] = __float2bfloat16(s);
        s = __expf(l[u]) * s + v[u];
        a += l[u];
      }
    }
  }
  return s;
}

__global__ void __launch_bounds__(SCAN_THREADS)
state_pass_kernel(const float* __restrict__ dstate,
                  const float* __restrict__ alog, bf16* __restrict__ states,
                  long long PN, int nc, long long total, int segments) {
  __shared__ float seg_a[SCAN_THREADS];
  __shared__ float seg_b[SCAN_THREADS];
  const int eb = SCAN_THREADS / segments;       // elements a block
  const int el = threadIdx.x % eb, sg = threadIdx.x / eb;
  const long long e = (long long)blockIdx.x * eb + el;
  const bool live = e < total;
  const long long g = live ? e / PN : 0, pn = live ? e % PN : 0;
  const int len = (nc + segments - 1) / segments;
  const int lo = min(nc, sg * len), hi = min(nc, lo + len);
  const float* ds = dstate + g * nc * PN + pn;
  const float* al = alog + g * nc;
  bf16* st = states + g * nc * PN + pn;
  float carry = 0.f;
  if (segments > 1) {
    // each segment as (a, b): state out = exp(a) * state in + b
    float a = 0.f, b = 0.f;
    if (live) b = chain<false>(ds, al, st, PN, lo, hi, 0.f, a);
    seg_a[threadIdx.x] = a;
    seg_b[threadIdx.x] = b;
    __syncthreads();
    for (int k = 0; k < sg; ++k)
      carry = __expf(seg_a[k * eb + el]) * carry + seg_b[k * eb + el];
  }
  if (!live) return;
  float a = 0.f;
  chain<true>(ds, al, st, PN, lo, hi, carry, a);
}

// ---------------------------------------------------------------------------
// pass 3: y = exp(cum) .* (C S_c^T) + ((C B^T) .* L) x
// ---------------------------------------------------------------------------

// Key blocks (64 keys) a score stage takes: 1, 2 or 4, at most PT / 64.
__device__ __forceinline__ int score_blocks(int left, int most) {
  const int b = left >= 3 ? 4 : left;
  return b < most ? b : most;
}

// A warpgroup's part of a score stage run: its 64 rows against KW keys
// from key block kb0, whose first box lies `boff` bytes into the stage's
// B part, over nN stages of 64 columns of N (C and B K-major); then L and
// the bf16 rounding into slabs jb < nkb of `scores`: row r, 16-byte piece
// k at r * 128 + (k ^ (r & 7)) * 16, as TMA's 128-byte swizzle lays it and
// wgmma reads it.
template <int KW, int STAGE>
__device__ __forceinline__ void score_part(
    uint8_t* ring_smem, uint64_t* full, uint64_t* empty, int ring, int& n,
    int nN, const float* cum, uint8_t* scores, int kb0, int boff, int nkb,
    int r_lo, int Q, int r0, int col) {
  float sc[KW / 2];
  zero_acc(sc);
  for (int ns = 0; ns < nN; ++ns, ++n) {
    const uint32_t ca = ring_wait(ring_smem, STAGE, full, ring, n);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk)
      wgmma_tile<KW, 0>(sc, make_desc(ca + kk * 32, 16, 1024),
                        make_desc(ca + BOX_BYTES + boff + kk * 32, 16, 1024));
    settle(sc, empty, ring, n);
  }
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
    const int jb = kb0 + j / 8;
    if (jb >= nkb) continue;
    uint8_t* slab = scores + jb * BOX_BYTES;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh, i = r_lo + r, k = kb0 * BOX + 8 * j + col;
      float v0 = 0.f, v1 = 0.f;
      if (i < Q) {
        if (k <= i) v0 = sc[4 * j + 2 * hh] * __expf(cum[i] - cum[k]);
        if (k + 1 <= i)
          v1 = sc[4 * j + 2 * hh + 1] * __expf(cum[i] - cum[k + 1]);
      }
      *reinterpret_cast<uint32_t*>(slab + r * 128 +
                                   (((j & 7) ^ (r & 7)) * 16) + col * 2) =
          pack_bf16x2(v0, v1);
    }
  }
}

// A CTA per (g, c, 64-row block), heaviest blocks first.  At PT = 256 two
// consumer warpgroups share every stage: each takes half of a score
// stage's keys and 128 of the PT columns of P.
template <int PT>
__global__ void __launch_bounds__((PT == 256 ? 2 : 1) * 128 + 32, 1)
chunk_out_kernel(const __grid_constant__ CUtensorMap map_c,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_s,
                 const void* __restrict__ la, int la_bf16,
                 bf16* __restrict__ y, int G, int S, int P, int N, int Q,
                 int ring) {
  constexpr int NWG = PT == 256 ? 2 : 1;
  constexpr int CONSUMERS = NWG * 128;
  constexpr int WC = PT / NWG;                  // P columns a warpgroup
  // a slot holds C and up to PT keys of B (scores), C and a 64-row x PT
  // tile of S_c^T, or a 64-key x PT tile of x
  constexpr int STAGE = BOX_BYTES + PT * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float cum[QMAX];
  __shared__ float wsum[16];
  __shared__ __align__(8) uint64_t full[MAX_RING];
  __shared__ __align__(8) uint64_t empty[MAX_RING];
  uint8_t* smem = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int nc = S / Q, nrb = (Q + BOX - 1) / BOX;
  const int n_gc = G * nc;
  const int rb = nrb - 1 - blockIdx.x / n_gc;   // heaviest blocks first
  const int gc = blockIdx.x % n_gc;             // g * nc + c
  const long long crow = (long long)(gc / nc) * S + (long long)(gc % nc) * Q;
  uint8_t* scores = smem;                       // rb + 1 swizzled slabs
  uint8_t* ring_smem = smem + nrb * BOX_BYTES;
  const int nN = (N + BOX - 1) / BOX, nP = (P + PT - 1) / PT;
  const int nkb = rb + 1, r_lo = rb * BOX;      // r_lo: the first row

  init_ring(full, empty, ring, NWG * 4);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread streams every stage in consumption order ----
    if (tid == CONSUMERS) {
      const int rrow = (int)(crow + r_lo);
      int n = 0;
      uint64_t* bar;
      for (int jb0 = 0, kbs; jb0 < nkb; jb0 += kbs) {
        kbs = score_blocks(nkb - jb0, PT / BOX);
        for (int ns = 0; ns < nN; ++ns, ++n) {
          uint8_t* st = ring_slot(ring_smem, STAGE, full, empty, ring, n,
                                  (1 + kbs) * BOX_BYTES, bar);
          tma_load_2d(st, &map_c, ns * BOX, rrow, bar);
          for (int j = 0; j < kbs; ++j)
            tma_load_2d(st + (1 + j) * BOX_BYTES, &map_b, ns * BOX,
                        (int)(crow + (jb0 + j) * BOX), bar);
        }
      }
      for (int pt = 0; pt < nP; ++pt) {
        for (int ns = 0; ns < nN; ++ns, ++n) {
          uint8_t* st = ring_slot(ring_smem, STAGE, full, empty, ring, n,
                                  STAGE, bar);
          tma_load_2d(st, &map_c, ns * BOX, rrow, bar);
#pragma unroll
          for (int j = 0; j < PT / BOX; ++j)
            tma_load_2d(st + BOX_BYTES + j * BOX_BYTES, &map_s,
                        pt * PT + j * BOX, gc * N + ns * BOX, bar);
        }
        for (int jb = 0; jb < nkb; ++jb, ++n) {
          uint8_t* st = ring_slot(ring_smem, STAGE, full, empty, ring, n,
                                  PT * 128, bar);
#pragma unroll
          for (int j = 0; j < PT / BOX; ++j)
            tma_load_2d(st + j * BOX_BYTES, &map_x, pt * PT + j * BOX,
                        (int)(crow + jb * BOX), bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = tid / 128, lane = tid & 31;
  const int r0 = ((tid & 127) >> 5) * 16 + (lane >> 2), col = 2 * (lane & 3);
  int n = 0;
  {
    LaShare<CONSUMERS> las;
    las.load(la, la_bf16, crow, Q);
    las.scan(Q, cum, wsum);
  }
  // masked scores of the block's rows against key blocks 0 .. rb
  for (int jb0 = 0, kbs; jb0 < nkb; jb0 += kbs) {
    kbs = score_blocks(nkb - jb0, PT / BOX);
    const int per = (NWG == 2 && kbs >= 2) ? kbs / 2 : kbs;
    const int kb0 = jb0 + ((NWG == 2 && kbs >= 2) ? wg * per : 0);
    if (NWG == 2 && kbs == 1 && wg == 1) {      // nothing for this one
      for (int ns = 0; ns < nN; ++ns, ++n) {
        ring_wait(ring_smem, STAGE, full, ring, n);
        ring_release(empty, ring, n);
      }
    } else if (per == 1) {
      score_part<64, STAGE>(ring_smem, full, empty, ring, n, nN, cum,
                            scores, kb0, (kb0 - jb0) * BOX_BYTES, nkb,
                            r_lo, Q, r0, col);
    } else {
      if constexpr (PT >= 128)
        score_part<128, STAGE>(ring_smem, full, empty, ring, n, nN, cum,
                               scores, kb0, (kb0 - jb0) * BOX_BYTES, nkb,
                               r_lo, Q, r0, col);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync<CONSUMERS>();

  float ex[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = r_lo + r0 + 8 * hh;
    ex[hh] = i < Q ? __expf(cum[i]) : 0.f;
  }
  for (int pt = 0; pt < nP; ++pt) {
    float acc[WC / 2];
    zero_acc(acc);
    // the carried state: C S_c^T (S_c^T MN-major), then its rows times
    // exp(cum)
    for (int ns = 0; ns < nN; ++ns, ++n) {
      const uint32_t ca = ring_wait(ring_smem, STAGE, full, ring, n);
      const uint32_t sb = ca + BOX_BYTES + wg * (WC / BOX) * BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk)
        wgmma_tile<WC, 1>(acc, make_desc(ca + kk * 32, 16, 1024),
                          make_desc(sb + kk * 2048, BOX_BYTES, 1024));
      settle(acc, empty, ring, n);
    }
#pragma unroll
    for (int j = 0; j < WC / 8; ++j) {
      acc[4 * j] *= ex[0];
      acc[4 * j + 1] *= ex[0];
      acc[4 * j + 2] *= ex[1];
      acc[4 * j + 3] *= ex[1];
    }
    // the chunk's own keys: scores (shared, K-major) times x (MN-major)
    for (int jb = 0; jb < nkb; ++jb, ++n) {
      const uint32_t xa = ring_wait(ring_smem, STAGE, full, ring, n) +
                          wg * (WC / BOX) * BOX_BYTES;
      const uint32_t sa = smem_u32(scores + jb * BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk)
        wgmma_tile<WC, 1>(acc, make_desc(sa + kk * 32, 16, 1024),
                          make_desc(xa + kk * 2048, BOX_BYTES, 1024));
      settle(acc, empty, ring, n);
    }
#pragma unroll
    for (int j = 0; j < WC / 8; ++j) {
      const int p = pt * PT + wg * WC + 8 * j + col;
      if (p >= P) continue;      // P % 8 == 0: p + 1 < P as well
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = r_lo + r0 + 8 * hh;
        if (i < Q)
          *reinterpret_cast<uint32_t*>(y + (crow + i) * P + p) =
              pack_bf16x2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN);
  done = e == cudaSuccess;
  return e;
}

template <int PW, int NWG, bool WALK>
cudaError_t launch_state(const CUtensorMap& mx, const CUtensorMap& mb,
                         const void* la, int la_bf16, float* ds, float* al,
                         bf16* sb, long long grid, int S, int P, int N,
                         int Q, int ring, cudaStream_t st) {
  const int smem = ring * (NWG * BOX_BYTES + PW * 128) + 1024;
  if (smem > SMEM_DYN) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t e = allow_smem(chunk_state_kernel<PW, NWG, WALK>, done);
  if (e != cudaSuccess) return e;
  chunk_state_kernel<PW, NWG, WALK>
      <<<(unsigned)grid, NWG * 128 + 32, smem, st>>>(
          mx, mb, la, la_bf16, ds, al, sb, S, P, N, Q, ring);
  return cudaGetLastError();
}

template <int PT>
cudaError_t launch_out(const CUtensorMap& mc, const CUtensorMap& mb,
                       const CUtensorMap& mx, const CUtensorMap& ms,
                       const void* la, int la_bf16, bf16* y, int G, int S,
                       int P, int N, int Q, int ring, cudaStream_t st) {
  const int nrb = (Q + BOX - 1) / BOX;
  const int smem = nrb * BOX_BYTES + ring * (BOX_BYTES + PT * 128) + 1024;
  if (smem > SMEM_DYN) return cudaErrorInvalidValue;
  static bool done = false;
  cudaError_t e = allow_smem(chunk_out_kernel<PT>, done);
  if (e != cudaSuccess) return e;
  const long long grid = (long long)G * (S / Q) * nrb;
  chunk_out_kernel<PT><<<(unsigned)grid, (PT == 256 ? 2 : 1) * 128 + 32,
                         smem, st>>>(mc, mb, mx, ms, la, la_bf16, y, G, S, P,
                                     N, Q, ring);
  return cudaGetLastError();
}

bool wide_tile(int t) { return t == 64 || t == 128 || t == 256; }

}  // namespace

// C entry point: K3 on ``stream``, as planned by
// kernels/ops.py:chunk_launch_plan, which the kernels take as they are:
// the variant (0 "three_pass": chunk_state, state_pass, chunk_out; 1
// "walk": chunk_state walking every chunk of its tile, then chunk_out),
// state_cols and state_wgs (chunk_state's P columns and 64-row warpgroups
// of N a CTA), its ring, the state pass's segments a chain, p_tile
// (chunk_out's P columns a pass) and its ring.  P is x's (padded) width, a
// multiple of 8.  Scratch, the caller's: states (G*nc*N*P bf16, each
// S_c^T); for three_pass dstate (G*nc*N*P f32) and alog (G*nc f32).
// Returns cudaGetLastError() after the launches, cudaErrorInvalidValue for
// a shape or plan the kernels do not take, or cudaErrorNotSupported when
// the tensor maps cannot be made.
extern "C" int repro_chunk_scan_bf16(const void* x, const void* bm,
                                     const void* cm, const void* la,
                                     int la_bf16, void* dstate, void* states,
                                     void* alog, void* y, int G, int S, int P,
                                     int N, int Q, int variant,
                                     int state_cols, int state_wgs,
                                     int state_ring,
                                     int segments, int p_tile, int out_ring,
                                     void* stream) {
  if (Q < 1 || Q > QMAX || S < Q || S % Q || N < 8 || N > NMAX || N % 8 ||
      P < 8 || P % 8 || G < 1 || (long long)G * S >= (1LL << 31) ||
      (long long)G * (S / Q) * (P > N ? P : N) >= (1LL << 31) ||
      variant < 0 || variant > 1 || state_cols < 64 || state_cols > 128 ||
      !wide_tile(state_cols) || !wide_tile(p_tile) ||
      state_wgs < 1 || state_wgs > 2 || state_ring < 1 ||
      state_ring > MAX_RING || out_ring < 1 || out_ring > MAX_RING ||
      segments < 1 || segments > MAX_SEGMENTS || (segments & (segments - 1)))
    return (int)cudaErrorInvalidValue;
  const int nc = S / Q;
  const long long rows = (long long)G * S;
  CUtensorMap mx, mb, mc, ms;
  if (!make_map(&mx, x, P, rows, P, BOX, BOX) ||
      !make_map(&mb, bm, N, rows, N, BOX, BOX) ||
      !make_map(&mc, cm, N, rows, N, BOX, BOX) ||
      !make_map(&ms, states, P, (long long)G * nc * N, P, BOX, BOX))
    return (int)cudaErrorNotSupported;
  auto st = static_cast<cudaStream_t>(stream);
  auto ds = static_cast<float*>(dstate);
  auto al = static_cast<float*>(alog);
  auto sb = static_cast<bf16*>(states);
  const long long tiles = (long long)G *
                          ((N + state_wgs * BOX - 1) / (state_wgs * BOX)) *
                          ((P + state_cols - 1) / state_cols);
  const long long sgrid = variant == 1 ? tiles : tiles * nc;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_K3_STATE(PW_, W_, V_)                                           \
  if (state_cols == PW_ && state_wgs == W_ && variant == V_)                  \
    err = launch_state<PW_, W_, V_ == 1>(mx, mb, la, la_bf16, ds, al, sb,     \
                                         sgrid, S, P, N, Q, state_ring, st);
  REPRO_K3_STATE(64, 1, 0)
  REPRO_K3_STATE(128, 1, 0)
  REPRO_K3_STATE(64, 2, 0)
  REPRO_K3_STATE(128, 2, 0)
  REPRO_K3_STATE(64, 1, 1)
  REPRO_K3_STATE(128, 1, 1)
  REPRO_K3_STATE(64, 2, 1)
  REPRO_K3_STATE(128, 2, 1)
#undef REPRO_K3_STATE
  if (err != cudaSuccess) return (int)err;

  if (variant == 0) {
    const long long PN = (long long)P * N, total = (long long)G * PN;
    const int eb = SCAN_THREADS / segments;
    state_pass_kernel<<<(unsigned)((total + eb - 1) / eb), SCAN_THREADS, 0,
                        st>>>(ds, al, sb, PN, nc, total, segments);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  auto yo = static_cast<bf16*>(y);
  err = cudaErrorInvalidValue;
  if (p_tile == 64)
    err = launch_out<64>(mc, mb, mx, ms, la, la_bf16, yo, G, S, P, N, Q,
                         out_ring, st);
  if (p_tile == 128)
    err = launch_out<128>(mc, mb, mx, ms, la, la_bf16, yo, G, S, P, N, Q,
                          out_ring, st);
  if (p_tile == 256)
    err = launch_out<256>(mc, mb, mx, ms, la, la_bf16, yo, G, S, P, N, Q,
                          out_ring, st);
  return (int)err;
}
