"""Kernel entry points and the one rule for which tiles can launch.

``tiles`` is the factor tuple the NeuroVectorizer agent injected
(``repro_torch.core.vectorizer``); ``None`` takes the heuristic baseline,
as in ``repro/kernels/ops.py``.  A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the Hopper kernel or raises.

Which tiles launch (:func:`tile_ok`).  One rule, in three clauses, which
``tile_ok``, ``CostModelEnv(legality="h100")`` (scalar and batched), the
launch plans and the kernels' own argument checks all call:

* dtype (:func:`dtype_ok`): K1, K2 and K3 take bfloat16 and nothing else.
  On the CPU route (``route="cpu"``, the plain versions) any dtype runs;
  the other clauses still hold there, so a program tuned on the CPU names
  tiles the card launches at the same shapes in bf16.
* head dim (:func:`head_dim_ok`, K2 at Sq > 1): D a multiple of 8 (TMA's
  16-byte strides, the epilogue's 16-byte stores) up to ``ATTN_D_PAD`` =
  128.  K2 computes every D in two 64-column slabs of the padded 128: TMA
  fills the columns past D with zeros on load and the epilogue stores only
  the first D.  ``Dv == D``.
* the tile: the reference clamps are applied first: ``bm <= ceil8(M)``,
  ``bn, bk <= ceil128(N | K)`` for matmul and ``bq <= Sq``, ``bkv <= Skv``
  for attention.  The f32 accumulator of a CTA lives in registers, and
  that is the limit:

  - matmul: the CTA tile is ``bm`` rounded up to a power of two of at
    least 16 rows by ``bn`` rounded up to a power of two of at least 128
    columns; it launches when ``rows * cols <= 128 * 256`` (128 f32 a
    thread at 256 threads).  ``bk`` never limits.  The wgmma variants pad
    the rows to 64 (two consumer warpgroups, still at most 128
    accumulators a thread), so this rule is unchanged from the first
    kernel; :func:`matmul_launch_plan` picks the variant and, for a small
    output grid, the split over ``bk``.
  - attention: ``bq * ATTN_D_PAD <= 128 * 128`` (at most two consumer
    warpgroups of 64 rows, each holding its (64, 128) f32 accumulator),
    and the blocks must divide the sequence (``Sq % bq == Skv % bkv ==
    0``).  A decode site (Sq == 1) never launches K2, so any positive tile
    of a bf16 site is fine.  :func:`attention_launch_plan` picks the
    variant, the warpgroups and the keys a stage of the TMA ring holds.
  - chunk scan: the chunk ``Q`` is clamped to the sequence (``min(Q,
    S)``) and must be at most 1024 (its cumsum lives in shared memory, and
    so do a 64-row block's scores against the whole chunk); the state
    width N must be a multiple of 8 (TMA's 16-byte strides) and at most
    1024.  P never limits (it is tiled; x is padded to a multiple of 8).
    The measurement runner snaps S up to a multiple of the clamped chunk,
    as the reference's does, so at a site divisibility never limits
    either; a direct call whose chunk does not divide S raises
    ``ValueError`` on every device.  :func:`chunk_launch_plan` sizes K3's
    passes.

``CostModelEnv(legality="h100")`` prices exactly these tiles as illegal;
a site whose dtype or head dim the kernels refuse has no legal tile at
all, and ``tune`` raises for it.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import chunk_scan as kcs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm

KERNEL_DTYPE = "bfloat16"        # the one dtype K1, K2 and K3 take
ROUTES = ("cuda", "cpu")        # the card's kernels; the plain versions
MM_ACC_LIMIT = 128 * 256        # f32 accumulator elements of a K1 CTA
ATTN_ACC_LIMIT = 128 * 128      # f32 accumulator elements of a K2 CTA,
                                # at the padded head dim
ATTN_D_PAD = 128                # K2's head dim: two 64-column slabs
MM_MAX_ROWS, MM_MAX_COLS = 256, 512
L2_BAND_BYTES = 8 << 20         # the band of x a group of CTAs keeps in L2
MM_K_STAGE = 128                # the deepest stage of K1's TMA ring
ATTN_WG_ROWS = 64               # query rows of a K2 consumer warpgroup
ATTN_RING = 2                   # stages of K2's TMA ring (PERF.md, PR 14)
ATTN_MAX_RING = 4
ATTN_SMEM_DYN = 232448 - 1024   # dynamic shared memory a K2 CTA may take
CHUNK_BOX = 64                  # every K3 TMA box is 64 x 64 bf16 (8 KB)
CHUNK_RING = 4                  # the deepest ring of a K3 pass
CHUNK_SMEM_DYN = 232448 - 9216  # dynamic shared memory a K3 CTA may take
SM_SMEM = 233472                # shared memory of an H100 SM
CTA_RESERVED = 1024             # shared memory the runtime keeps a CTA
CHUNK_STATE_STATIC = 8320       # static shared memory of chunk_state and
CHUNK_OUT_STATIC = 4224         # chunk_out (ptxas; a GPU test holds them)
CHUNK_WALK_TILES = 128          # state tiles and chunks a group from
CHUNK_WALK_CHUNKS = 32          # which a chunk_state CTA walks every
                                # chunk of its tile (PERF.md §6: at 16
                                # chunks, xLSTM's Q = 512, a tie)
SCAN_THREADS = 256              # threads of a state_pass block
SCAN_MAX_SEGMENTS = 32          # segments a chain of chunks is cut into
SCAN_WANT_THREADS = 132 * 2048  # state_pass threads that fill the card


def _ceil_mult(x, m):
    return -(-x // m) * m


def _pow2_at_least(x, lo):
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.maximum(lo, 2 ** np.ceil(np.log2(x)).astype(np.int64))


def dtype_ok(dtype, route: str = "cuda"):
    """The rule's dtype clause, elementwise over dtype names (numpy
    broadcast): on the card (``route="cuda"``) the kernels take bfloat16
    only; the plain versions of the CPU route take any dtype."""
    d = np.asarray(dtype)
    if route == "cpu":
        return np.ones(d.shape, bool)
    if route != "cuda":
        raise ValueError(f"route {route!r} not in {ROUTES}")
    return d == KERNEL_DTYPE


def torch_dtype_ok(*tensors) -> bool:
    """The dtype clause for a kernel's operands on the card: one dtype, and
    one the kernels take."""
    names = {str(t.dtype).removeprefix("torch.") for t in tensors}
    return len(names) == 1 and bool(dtype_ok(names.pop()))


def head_dim_ok(D):
    """The rule's head-dim clause for K2 (elementwise): a multiple of 8 up
    to the padded ``ATTN_D_PAD``."""
    D = np.asarray(D, np.int64)
    return (D >= 8) & (D % 8 == 0) & (D <= ATTN_D_PAD)


def matmul_tiles_legal(M, N, K, bm, bn, bk, *, dtype=KERNEL_DTYPE,
                       route="cuda"):
    """Elementwise (numpy-broadcast) K1 launch predicate."""
    bm, bn, bk = (np.asarray(a, np.int64) for a in (bm, bn, bk))
    pos = (bm > 0) & (bn > 0) & (bk > 0)
    rows = _pow2_at_least(np.minimum(bm, _ceil_mult(M, 8)), 16)
    cols = _pow2_at_least(np.minimum(bn, _ceil_mult(N, 128)), 128)
    return (dtype_ok(dtype, route) & pos & (rows <= MM_MAX_ROWS)
            & (cols <= MM_MAX_COLS) & (rows * cols <= MM_ACC_LIMIT))


def attention_tiles_legal(Sq, Skv, D, bq, bkv, *, dtype=KERNEL_DTYPE,
                          route="cuda"):
    """Elementwise (numpy-broadcast) K2 launch predicate."""
    bq, bkv = np.asarray(bq, np.int64), np.asarray(bkv, np.int64)
    pos = (bq > 0) & (bkv > 0)
    bq_e = np.maximum(np.minimum(bq, Sq), 1)
    bkv_e = np.maximum(np.minimum(bkv, Skv), 1)
    launched = (head_dim_ok(D) & (bq_e * ATTN_D_PAD <= ATTN_ACC_LIMIT)
                & (Sq % bq_e == 0) & (Skv % bkv_e == 0))
    # Sq == 1 (decode) never launches K2: it takes the plain branch
    return dtype_ok(dtype, route) & pos & ((np.asarray(Sq) == 1) | launched)


def chunk_tiles_legal(S, P, N, Q, *, dtype=KERNEL_DTYPE, route="cuda"):
    """Elementwise (numpy-broadcast) K3 launch predicate; ``S`` is the
    number of scanned positions of a group.  ``P`` never limits."""
    Q, N = np.asarray(Q, np.int64), np.asarray(N, np.int64)
    q_e = np.minimum(Q, S)
    return (dtype_ok(dtype, route) & (Q > 0) & (q_e <= kcs.Q_MAX) & (N >= 8)
            & (N % 8 == 0) & (N <= kcs.N_MAX))


def tile_ok(site, tiles, route: str = "cuda") -> bool:
    """True when the Hopper kernel for ``site`` launches with ``tiles``
    (``route="cpu"``: when the plain versions take it, which is the same
    rule without its dtype clause).  A chunk-scan site scans ``batch * m``
    positions (one group, as the measurement runner materialises it)."""
    kw = dict(dtype=site.dtype, route=route)
    if site.kind == "matmul":
        return bool(matmul_tiles_legal(site.m, site.n, site.k, *tiles[:3],
                                       **kw))
    if site.kind == "attention":
        return bool(attention_tiles_legal(site.m, site.k, site.n,
                                          *tiles[:2], **kw))
    if site.kind == "chunk_scan":
        return bool(chunk_tiles_legal(site.batch * site.m, site.n, site.k,
                                      tiles[0], **kw))
    raise ValueError(site.kind)


def matmul_tile_plan(M: int, N: int, K: int, tiles):
    """``(bm, bn, bk, rows, cols)``: the clamped tiles (the CTA strides)
    and the compiled CTA tile covering them, or ``None`` if illegal (the
    plans take the operands' dtype as checked: the wrappers call
    :func:`torch_dtype_ok` first)."""
    bm, bn, bk = (int(t) for t in tiles[:3])
    if not matmul_tiles_legal(M, N, K, bm, bn, bk):
        return None
    bm_e = min(bm, _ceil_mult(M, 8))
    bn_e = min(bn, _ceil_mult(N, 128))
    bk_e = min(bk, _ceil_mult(K, 128))
    return (bm_e, bn_e, bk_e, int(_pow2_at_least(bm_e, 16)),
            int(_pow2_at_least(bn_e, 128)))


class MatmulLaunch(NamedTuple):
    """How K1 runs one call: the variant, the clamped tiles (the CTA
    strides), the compiled CTA tile, the output grid, the split of K and
    the grouping of row blocks (``csrc/matmul.cu``)."""
    variant: str        # "tma_wgmma", "split_k" or "unaligned"
    bm: int
    bn: int
    bk: int
    rows: int           # CTA rows (a power of two >= 16)
    cols: int           # CTA columns (a power of two >= 128)
    grid_m: int
    grid_n: int
    splits: int         # CTAs along K
    k_run: int          # K a CTA walks: CTA z takes [z, z + 1) * k_run
    group_m: int        # row blocks that run together


def matmul_launch_plan(M: int, N: int, K: int, tiles, sms: int,
                       aligned: bool = True) -> Optional[MatmulLaunch]:
    """The launch of K1 for a legal tile (``None`` if illegal).  Operands
    TMA cannot take (``aligned`` false) run the unaligned variant.  An
    output grid smaller than ``sms`` splits K into at most ``sms // tiles``
    runs of ``k_run``, a whole number of ``bk`` blocks (``split_k``), when
    ``bk`` is a multiple of the kernel's deepest stage, so that no stage of
    a run reads into the next; otherwise one CTA walks all of K
    (``tma_wgmma``).  The kernel takes ``k_run`` as it is.  Memoised: the
    wrapper asks once a call."""
    bm, bn, bk = (int(t) for t in tiles[:3])
    return _launch_plan(int(M), int(N), int(K), bm, bn, bk, int(sms),
                        bool(aligned))


@functools.lru_cache(maxsize=4096)
def _launch_plan(M, N, K, bm, bn, bk, sms, aligned):
    plan = matmul_tile_plan(M, N, K, (bm, bn, bk))
    if plan is None:
        return None
    bm, bn, bk, rows, cols = plan
    grid_m, grid_n = -(-M // bm), -(-N // bn)
    n_tiles = grid_m * grid_n
    nkb = -(-K // bk)
    splits, k_run = 1, K
    if aligned and n_tiles < sms and bk % MM_K_STAGE == 0:
        most = min(nkb, sms // n_tiles)
        if most > 1:
            k_run = -(-nkb // most) * bk
            splits = -(-K // k_run)
    variant = ("unaligned" if not aligned
               else "split_k" if splits > 1 else "tma_wgmma")
    band = max(1, L2_BAND_BYTES // max(1, bm * K * 2))
    return MatmulLaunch(variant, bm, bn, bk, rows, cols, grid_m, grid_n,
                        splits, k_run, min(grid_m, band))


class AttentionLaunch(NamedTuple):
    """How K2 runs one call (``csrc/flash_attention.cu``): the variant, the
    clamped blocks, the consumer warpgroups of 64 query rows, the keys a
    stage of the TMA ring holds, the stages over ``Skv`` (before the
    causal skip), the stages of the ring and its shared memory."""
    variant: str        # "tma_wgmma" or "unaligned"
    bq: int
    bkv: int
    warpgroups: int
    stage_keys: int     # 128, or 64 where bkv < 128
    n_stages: int       # ceil(Skv / stage_keys)
    ring: int
    smem: int           # dynamic shared memory bytes (tma_wgmma): Q,
                        # the output staging and the ring


def attention_launch_plan(Sq: int, Skv: int, D: int, bq: int, bkv: int,
                          strides=None,
                          aligned: bool = True) -> Optional[AttentionLaunch]:
    """The launch of K2 for a legal tile (``None`` if the rule refuses the
    tile or the head dim).  Shared memory is sized at the padded
    head dim ``ATTN_D_PAD``.  ``strides`` are q's, k's and v's (elements;
    ``None``: contiguous; a dimension of one element carries its
    contiguous stride) and ``aligned`` says their base pointers are
    16-byte aligned.  TMA takes a tensor whose D is contiguous and whose
    other strides are positive multiples of 16 bytes; an operand it cannot
    take runs the unaligned variant."""
    if not attention_tiles_legal(Sq, Skv, D, bq, bkv):
        return None
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    if Sq % bq or Skv % bkv:        # only at Sq == 1, which K2 never runs
        return None
    tma = aligned and (strides is None or all(
        st[3] == 1 and all(x > 0 and x % 8 == 0 for x in st[:3])
        for st in strides))
    wgs = -(-bq // ATTN_WG_ROWS)
    keys = 128 if bkv >= 128 else 64    # blocks below 64 keys: 64 a stage
    n_stages = -(-Skv // keys)
    stage_bytes = 4 * keys * ATTN_D_PAD             # a K and a V tile, bf16
    q_bytes = wgs * ATTN_WG_ROWS * ATTN_D_PAD * 2   # Q, and as much to
                                                    # stage out
    fit = (ATTN_SMEM_DYN - 1024 - 2 * q_bytes) // stage_bytes
    ring = max(1, min(ATTN_RING, fit, ATTN_MAX_RING, n_stages))
    return AttentionLaunch("tma_wgmma" if tma else "unaligned", bq, bkv,
                           wgs, keys, n_stages, ring,
                           2 * q_bytes + ring * stage_bytes + 1024)


class ChunkLaunch(NamedTuple):
    """How K3 runs one call (``csrc/chunk_scan.cu``): the variant, the
    clamped chunk, x's padded width, and for each pass its tile, grid, ring
    and dynamic shared memory; the scratch the wrapper allocates."""
    variant: str        # "three_pass": chunk_state, state_pass, chunk_out;
                        # "walk": chunk_state walks its tile's chunks
                        # (the state pass fused in), then chunk_out
    Q: int              # the chunk, clamped to S
    n_chunks: int       # G * S / Q
    P_pad: int          # P rounded up to 8: x is padded, y sliced
    state_cols: int     # chunk_state: P columns a CTA, 64 or 128 (the
                        # state is computed transposed, rows n)
    state_wgs: int      # chunk_state: consumer warpgroups, 64 N rows each
    state_grid: int     # chunk_state CTAs: (g, [c,] N tile, P tile)
    state_ring: int
    state_smem: int
    segments: int       # state_pass: chunks walked by this many threads
    scan_grid: int      # state_pass blocks of SCAN_THREADS (three_pass)
    p_tile: int         # chunk_out: P columns a pass of a CTA (two
                        # consumer warpgroups at 256)
    out_grid: int       # chunk_out CTAs: (g, c, 64-row block)
    out_ring: int
    out_smem: int       # the block's scores, then the ring
    dstate_elems: int   # f32 scratch: each chunk's own state (three_pass)
    states_elems: int   # bf16 scratch: the state entering each chunk
    alog_elems: int     # f32 scratch: each chunk's log-decay (three_pass)


def _wide_tile(n: int) -> int:
    return 64 if n <= 64 else 128 if n <= 128 else 256


def chunk_launch_plan(G: int, S: int, P: int, N: int,
                      Q: int) -> Optional[ChunkLaunch]:
    """The launch of K3 for a legal chunk (``None`` if the chunk is illegal
    or does not divide S).  ``walk`` when a group has at least
    ``CHUNK_WALK_CHUNKS`` chunks (the f32 ``ΔS`` traffic of three_pass
    grows with their number) and chunk_state at least
    ``CHUNK_WALK_TILES`` (N, P) tiles (at the widest P tile up to 128 that
    keeps that many), so that a CTA a tile fills the card; otherwise
    ``three_pass``, whose state pass cuts each element's chain of chunks
    into segments (joined by the associative decay rule) until the card
    has ``SCAN_WANT_THREADS`` threads or a segment is one chunk.  Rings
    take as many stages as fit, up to ``CHUNK_RING``; chunk_out with
    64-column P tiles, whose stages are short, takes the ring of one or two
    stages that puts more CTAs on a SM (two on a tie)."""
    return _chunk_plan(int(G), int(S), int(P), int(N), int(Q), CHUNK_RING)


@functools.lru_cache(maxsize=1024)
def _chunk_plan(G, S, P, N, Q, ring, variant=None):
    if G < 1 or P < 1 or not chunk_tiles_legal(S, P, N, Q):
        return None
    Q = min(Q, S)
    if S % Q:
        return None
    nc = G * (S // Q)
    P_pad = _ceil_mult(P, 8)
    box = CHUNK_BOX
    n_q = -(-Q // box)                      # 64-row slabs (blocks) a chunk
    p_tile = _wide_tile(P_pad)
    wgs = 1 if N <= box else 2
    n_tiles = G * -(-N // (wgs * box))
    walk_cols = [pc for pc in (128, 64) if pc <= p_tile
                 and n_tiles * -(-P_pad // pc) >= CHUNK_WALK_TILES]
    if variant is None:
        variant = ("walk" if walk_cols and S // Q >= CHUNK_WALK_CHUNKS
                   else "three_pass")
    walk = variant == "walk"
    # 128 columns at most: a consumer's accumulator (64 f32) beside its A
    # fragments of the decayed B (16 registers) and no spill
    cols = (walk_cols or [min(128, p_tile)])[0] if walk else min(128, p_tile)
    tiles = n_tiles * -(-P_pad // cols)
    stage1 = wgs * box * box * 2 + cols * box * 2
    state_ring = min(ring, n_q * (S // Q if walk else 1))
    elems = P_pad * N
    segments = 1
    while (not walk and segments < SCAN_MAX_SEGMENTS
           and 2 * segments <= S // Q
           and G * elems * segments < SCAN_WANT_THREADS):
        segments *= 2
    scores = n_q * box * box * 2
    stage3 = box * box * 2 + p_tile * box * 2
    out_ring = min(ring, (CHUNK_SMEM_DYN - 1024 - scores) // stage3)
    if p_tile == box:
        out_ring = max((2, 1), key=lambda r: SM_SMEM // (
            scores + r * stage3 + 1024 + CHUNK_OUT_STATIC + CTA_RESERVED))
    return ChunkLaunch(
        variant, Q, nc, P_pad, cols, wgs,
        tiles if walk else tiles * (S // Q), state_ring,
        state_ring * stage1 + 1024, segments,
        0 if walk else -(-G * elems // (SCAN_THREADS // segments)), p_tile,
        nc * n_q, out_ring, scores + out_ring * stage3 + 1024,
        0 if walk else nc * elems, nc * elems, 0 if walk else nc)


def _default_matmul_tiles(M: int, N: int, K: int) -> Tuple[int, int, int]:
    from repro_torch.core.costmodel import baseline_matmul_tiles
    return baseline_matmul_tiles(M, N, K)


def _default_attn_tiles(Sq: int, Skv: int) -> Tuple[int, int]:
    from repro_torch.core.costmodel import baseline_attn_tiles
    return baseline_attn_tiles(Sq, Skv)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel for tensors on {t.device}")


def matmul(x: torch.Tensor, w: torch.Tensor,
           tiles: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """``x(M,K) @ w(K,N)`` through K1 (CUDA) or its plain version (CPU)."""
    M, K = x.shape
    N = w.shape[1]
    bm, bn, bk = (tiles[:3] if tiles is not None
                  else _default_matmul_tiles(M, N, K))
    if _route(x) == "cuda":
        return kmm.matmul_cuda(x, w, bm, bn, bk)
    return kmm.matmul_plain(x, w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float,
                    tiles: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Attention forward through K2 (CUDA) or its plain version (CPU).
    ``tiles`` carries the unified 3-head action; attention uses the first
    two factors.  k and v keep their Hkv heads (GQA)."""
    Sq, Skv = q.shape[2], k.shape[2]
    bq, bkv = (tiles[:2] if tiles is not None
               else _default_attn_tiles(Sq, Skv))
    if _route(q) == "cuda":
        return kfa.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                        bq=bq, bkv=bkv)
    return kfa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     bq=bq, bkv=bkv)


def chunk_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
               la: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """The SSD chunk scan through K3 (CUDA) or its plain version (CPU).
    x (G,S,P); Bm/Cm (G,S,N); la (G,S) log-decay; ``chunk`` the tuned Q."""
    if _route(x) == "cuda":
        return kcs.chunk_scan_cuda(x, Bm, Cm, la, chunk=chunk)
    return kcs.chunk_scan_plain(x, Bm, Cm, la, chunk=chunk)
