"""Kernel entry points and the one predicate for which tiles can launch.

``tiles`` is the factor tuple the NeuroVectorizer agent injected
(``repro_torch.core.vectorizer``); ``None`` takes the heuristic baseline,
as in ``repro/kernels/ops.py``.  A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the Hopper kernel or raises.

Which tiles launch (:func:`tile_ok`).  The reference clamps are applied
first: ``bm <= ceil8(M)``, ``bn, bk <= ceil128(N | K)`` for matmul and
``bq <= Sq``, ``bkv <= Skv`` for attention.  The f32 accumulator of a CTA
lives in registers, and that is the limit:

* matmul: the CTA tile is ``bm`` rounded up to a power of two of at least
  16 rows by ``bn`` rounded up to a power of two of at least 128 columns;
  it launches when ``rows * cols <= 128 * 256`` (128 f32 a thread at 256
  threads).  ``bk`` never limits.  The wgmma variants pad the rows to 64
  (two consumer warpgroups, still at most 128 accumulators a thread), so
  this rule is unchanged from the first kernel; :func:`matmul_launch_plan`
  picks the variant and, for a small output grid, the split over ``bk``.
* attention: ``bq * D <= 128 * 128`` (at most two consumer warpgroups of
  64 rows at D = 128, each holding its (64, D) f32 accumulator), and the
  blocks must divide the sequence (``Sq % bq == Skv % bkv == 0``).  A
  decode site (Sq == 1) never launches K2, so any positive tile is fine.
  :func:`attention_launch_plan` picks the variant, the warpgroups and the
  keys a stage of the TMA ring holds.
* chunk scan: the chunk ``Q`` is clamped to the sequence (``min(Q, S)``)
  and must be at most 1024 (its cumsum lives in shared memory); the state
  width N must be a multiple of 8 and at most 1024 (the CTA's slice of the
  state, 16 rows by N, is 16 register tiles a warp).  P never limits (it
  is split across CTAs), nor does the Q x Q score block (it goes through
  a scratch in device memory).  The measurement runner snaps S up to a
  multiple of the clamped chunk, as the reference's does, so at a site
  divisibility never limits either; a direct call whose chunk does not
  divide S raises ``ValueError`` on every device.

``CostModelEnv(legality="h100")`` prices exactly these tiles as illegal.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import chunk_scan as kcs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm

MM_ACC_LIMIT = 128 * 256        # f32 accumulator elements of a K1 CTA
ATTN_ACC_LIMIT = 128 * 128      # f32 accumulator elements of a K2 CTA
MM_MAX_ROWS, MM_MAX_COLS = 256, 512
L2_BAND_BYTES = 8 << 20         # the band of x a group of CTAs keeps in L2
MM_K_STAGE = 128                # the deepest stage of K1's TMA ring
ATTN_WG_ROWS = 64               # query rows of a K2 consumer warpgroup
ATTN_RING = 2                   # stages of K2's TMA ring (PERF.md, PR 14)
ATTN_MAX_RING = 4
ATTN_SMEM_DYN = 232448 - 1024   # dynamic shared memory a K2 CTA may take


def _ceil_mult(x, m):
    return -(-x // m) * m


def _pow2_at_least(x, lo):
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.maximum(lo, 2 ** np.ceil(np.log2(x)).astype(np.int64))


def matmul_tiles_legal(M, N, K, bm, bn, bk):
    """Elementwise (numpy-broadcast) K1 launch predicate."""
    bm, bn, bk = (np.asarray(a, np.int64) for a in (bm, bn, bk))
    pos = (bm > 0) & (bn > 0) & (bk > 0)
    rows = _pow2_at_least(np.minimum(bm, _ceil_mult(M, 8)), 16)
    cols = _pow2_at_least(np.minimum(bn, _ceil_mult(N, 128)), 128)
    return (pos & (rows <= MM_MAX_ROWS) & (cols <= MM_MAX_COLS)
            & (rows * cols <= MM_ACC_LIMIT))


def attention_tiles_legal(Sq, Skv, D, bq, bkv):
    """Elementwise (numpy-broadcast) K2 launch predicate."""
    bq, bkv = np.asarray(bq, np.int64), np.asarray(bkv, np.int64)
    pos = (bq > 0) & (bkv > 0)
    bq_e = np.maximum(np.minimum(bq, Sq), 1)
    bkv_e = np.maximum(np.minimum(bkv, Skv), 1)
    launched = ((bq_e * D <= ATTN_ACC_LIMIT) & (Sq % bq_e == 0)
                & (Skv % bkv_e == 0))
    # Sq == 1 (decode) never launches K2: it takes the plain branch
    return pos & ((np.asarray(Sq) == 1) | launched)


def chunk_tiles_legal(S, P, N, Q):
    """Elementwise (numpy-broadcast) K3 launch predicate; ``S`` is the
    number of scanned positions of a group.  ``P`` never limits."""
    Q, N = np.asarray(Q, np.int64), np.asarray(N, np.int64)
    q_e = np.minimum(Q, S)
    return ((Q > 0) & (q_e <= kcs.Q_MAX) & (N >= 8) & (N % 8 == 0)
            & (N <= kcs.N_MAX))


def tile_ok(site, tiles) -> bool:
    """True when the Hopper kernel for ``site`` launches with ``tiles``.
    A chunk-scan site scans ``batch * m`` positions (one group, as the
    measurement runner materialises it)."""
    if site.kind == "matmul":
        return bool(matmul_tiles_legal(site.m, site.n, site.k, *tiles[:3]))
    if site.kind == "attention":
        return bool(attention_tiles_legal(site.m, site.k, site.n,
                                          *tiles[:2]))
    if site.kind == "chunk_scan":
        return bool(chunk_tiles_legal(site.batch * site.m, site.n, site.k,
                                      tiles[0]))
    raise ValueError(site.kind)


def matmul_tile_plan(M: int, N: int, K: int, tiles):
    """``(bm, bn, bk, rows, cols)``: the clamped tiles (the CTA strides)
    and the compiled CTA tile covering them, or ``None`` if illegal."""
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
    """The launch of K2 for a legal tile at head dim 128 (``None`` if the
    tile is illegal or D is not 128).  ``strides`` are q's, k's and v's
    (elements; ``None``: contiguous; a dimension of one element carries
    its contiguous stride) and ``aligned`` says their base pointers are
    16-byte aligned.  TMA takes a tensor whose D is contiguous and whose
    other strides are positive multiples of 16 bytes; an operand it cannot
    take runs the unaligned variant."""
    if D != kfa.HEAD_DIM or not attention_tiles_legal(Sq, Skv, D, bq, bkv):
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
    stage_bytes = 4 * keys * D              # a K and a V tile, bf16
    q_bytes = wgs * ATTN_WG_ROWS * D * 2    # Q, and as much to stage out
    fit = (ATTN_SMEM_DYN - 1024 - 2 * q_bytes) // stage_bytes
    ring = max(1, min(ATTN_RING, fit, ATTN_MAX_RING, n_stages))
    return AttentionLaunch("tma_wgmma" if tma else "unaligned", bq, bkv,
                           wgs, keys, n_stages, ring,
                           2 * q_bytes + ring * stage_bytes + 1024)


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
