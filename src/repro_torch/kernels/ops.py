"""Kernel entry points and the one rule for which tiles can launch.

``tiles`` is the factor tuple the NeuroVectorizer agent injected
(``repro_torch.core.vectorizer``); ``None`` takes the heuristic baseline,
as in ``repro/kernels/ops.py``.  A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the Hopper kernel or raises.

Which tiles launch (:func:`tile_ok`).  One rule, in three clauses, which
``tile_ok``, ``CostModelEnv(legality="h100")`` (scalar and batched), the
launch plans and the kernels' own argument checks all call:

* dtype (:func:`dtype_ok`), per kernel (``KERNEL_DTYPES``): K1 takes
  bfloat16 and float32 (its ``f32`` variant, for the MoE router), K2 and
  K3 bfloat16 only.  On the CPU route (``route="cpu"``, the plain
  versions) any dtype runs; the other clauses still hold there, so a
  program tuned on the CPU names tiles the card launches at the same
  shapes in bf16.
* head dim (:func:`head_dim_ok`, K2 at Sq > 1): D, and the value dim Dv
  of v and the output (MLA: D = 192, Dv = 128), multiples of 8 (TMA's
  16-byte strides, the epilogue's 16-byte stores) up to ``ATTN_D_MAX`` =
  192, Dv padded no wider than D (:func:`attn_d_pad`: 128 up to 128, 192
  above).  K2's tma_wgmma variant computes ``Q.K^T`` at D's own padded
  width and ``P.V`` at Dv's (:func:`attn_widths`: 64, 96, 128 or 192),
  the unaligned variant at :func:`attn_d_pad`'s: TMA fills the columns
  past D (Dv) with zeros on load and the epilogue stores only the first
  Dv.  A site carries D alone; the value dims of the models (Dv <= D)
  always pass.
* the tile: the reference clamps are applied first: ``bm <= ceil8(M)``,
  ``bn, bk <= ceil128(N | K)`` for matmul and ``bq <= Sq``, ``bkv <= Skv``
  for attention.  The f32 accumulator of a CTA lives in registers, and
  that is the limit:

  - matmul: the CTA tile is ``bm`` rounded up to a power of two of at
    least 16 rows by ``bn`` rounded up to a power of two of at least 128
    columns; it launches when ``rows * cols <= 128 * 256`` (128 f32 a
    thread at 256 threads).  ``bk`` never limits.  The wgmma variants
    run CTA tiles of 64 rows and more as they are (two consumer
    warpgroups, at most 128 accumulators a thread), and tiles of 16 and
    32 rows with the operands swapped (the rows are wgmma's N, so none is
    padded; at most 64 accumulators a thread), so this rule is unchanged
    from the first kernel; :func:`matmul_launch_plan` picks the variant,
    for a small output grid the split over ``bk``, and for a swapped tile
    its CTAs an SM and the thread-block cluster that shares each ``w``
    slab.  In f32 the same tile runs the ``f32`` variant: 256 threads of
    FFMA, at most 128 accumulators a thread, so the clause is the same.
    That variant is bound by the FP32
    rate outside the tensor cores (or, at a narrow N or at decode, by
    reading x or w), and a router's grid is a handful of tiles, so it
    splits K into :func:`f32_split` runs, one CTA each, a function of K
    alone (a row's bits then do not depend on the batch), and computes
    only the rows and columns a small M or N has.
  - attention: ``bq <= ATTN_MAX_BQ`` = 128 (at most two consumer
    warpgroups of 64 rows, each holding a (64, 128) f32 accumulator), at
    every head dim, and the blocks must divide the sequence (``Sq % bq ==
    Skv % bkv == 0``).  A decode site (Sq == 1) never launches K2, so any
    positive tile of a bf16 site is fine.  :func:`attention_launch_plan`
    picks the variant, the warpgroups and the keys a stage of the TMA ring
    holds.
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

KERNEL_DTYPE = "bfloat16"        # the dtype every kernel takes
KERNEL_DTYPES = {"matmul": ("bfloat16", "float32"),     # K1
                 "attention": ("bfloat16",),            # K2
                 "chunk_scan": ("bfloat16",)}           # K3
ROUTES = ("cuda", "cpu")        # the card's kernels; the plain versions
MM_ACC_LIMIT = 128 * 256        # f32 accumulator elements of a K1 CTA
ATTN_SLAB = 64                  # columns of a K2 slab (128 bytes, TMA's
                                # swizzle width)
ATTN_D_MAX = 192                # K2's widest head dim: three slabs
MM_MAX_ROWS, MM_MAX_COLS = 256, 512
MM_SWAP_ROWS = 64               # CTA rows below which K1 swaps its operands
MM_CLUSTER = 2                  # CTAs that share each w slab by multicast
MM_CLUSTER_MIN_K = 6144         # from this K, at the 32 x 128 tile at three
                                # CTAs an SM, a cluster ran faster than
                                # none on an H100 (K = 6144-16384), at K =
                                # 4096 slower (tools/k1_probe.py; PERF.md)
MM_CLUSTERS = (1, MM_CLUSTER)   # the cluster sizes the kernel takes
MM_OCC3_WAVES = 3               # waves at three CTAs an SM from which the
                                # 32 x 128 swapped tile runs three an SM
L2_BAND_BYTES = 8 << 20         # the band of x a group of CTAs keeps in L2
MM_K_STAGE = 128                # the deepest stage of K1's TMA ring
F32_BK = 32                     # K depth of a slab of K1's f32 variant
F32_MIN_RUN = 512               # the shortest run of K an f32 CTA walks
F32_MAX_RUNS = 8                # the most runs of K an f32 call splits
F32_MIN_WIDTH = 16              # the narrowest f32 column layout
F32_MIN_HEIGHT = 4              # the lowest f32 row layout (decode)
ATTN_WG_ROWS = 64               # query rows of a K2 consumer warpgroup
ATTN_MAX_BQ = 2 * ATTN_WG_ROWS  # two consumer warpgroups a CTA
ATTN_RING = 2                   # stages of K2's TMA ring at D = Dv = 128
                                # (PERF.md)
ATTN_MAX_RING = 4
ATTN_WIDTHS = ((64, 64), (96, 96), (128, 128), (192, 128), (192, 192))
                                # (D, Dv) widths K2's tma_wgmma compiles
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


def dtype_ok(dtype, route: str = "cuda", kind: Optional[str] = None):
    """The rule's dtype clause, elementwise over dtype names (numpy
    broadcast): on the card (``route="cuda"``) the dtypes
    ``KERNEL_DTYPES[kind]`` of the kernel for a site ``kind`` (``None``:
    those every kernel takes, bfloat16); the plain versions of the CPU
    route take any dtype."""
    d = np.asarray(dtype)
    if route == "cpu":
        return np.ones(d.shape, bool)
    if route != "cuda":
        raise ValueError(f"route {route!r} not in {ROUTES}")
    return np.isin(d, KERNEL_DTYPES[kind] if kind is not None
                   else (KERNEL_DTYPE,))


def torch_dtype_ok(*tensors, kind: Optional[str] = None) -> bool:
    """The dtype clause for a kernel's operands on the card: one dtype, and
    one the kernel for ``kind`` takes (:func:`dtype_ok`)."""
    names = {str(t.dtype).removeprefix("torch.") for t in tensors}
    return len(names) == 1 and bool(dtype_ok(names.pop(), kind=kind))


def attn_d_pad(D):
    """A head dim's class in the rule (elementwise), and the width K2's
    unaligned variant computes it in: 128 (two slabs) up to 128,
    ``ATTN_D_MAX`` (three) above."""
    return np.where(np.asarray(D, np.int64) <= 2 * ATTN_SLAB, 2 * ATTN_SLAB,
                    ATTN_D_MAX)


def attn_widths(D: int, Dv: Optional[int] = None) -> Tuple[int, int]:
    """``(d_pad, dv_pad)``: the widths K2's tma_wgmma variant computes
    ``Q.K^T`` and ``P.V`` at (``Dv`` default D): the narrowest pair of
    ``ATTN_WIDTHS`` at least as wide as D and Dv, so each is rounded up to
    64, 96 (a 64-column slab and a 32-column one), 128 or 192, the two
    equal up to 128."""
    Dv = D if Dv is None else Dv
    return min((w for w in ATTN_WIDTHS if w[0] >= D and w[1] >= Dv),
               key=sum)


def attn_staging_pitch(dv_pad: int) -> int:
    """Bytes of a row of K2's output staging at the padded value width:
    ``dv_pad`` bf16, and one 16-byte chunk more where a row is not a
    multiple of 8 chunks (96), so that a warp's stores spread over the
    banks (``csrc/flash_attention.cu``: ``Staging``)."""
    return 2 * dv_pad + (0 if (dv_pad // 8) % 8 == 0 else 16)


def head_dim_ok(D, Dv=None):
    """The rule's head-dim clause for K2 (elementwise): D and the value dim
    ``Dv`` (default D) multiples of 8 up to ``ATTN_D_MAX``, Dv padded no
    wider than D (the kernels compiled: (128, 128), (192, 128), (192,
    192))."""
    D = np.asarray(D, np.int64)
    Dv = D if Dv is None else np.asarray(Dv, np.int64)

    def one(d):
        return (d >= 8) & (d % 8 == 0) & (d <= ATTN_D_MAX)
    return one(D) & one(Dv) & (attn_d_pad(Dv) <= attn_d_pad(D))


def matmul_tiles_legal(M, N, K, bm, bn, bk, *, dtype=KERNEL_DTYPE,
                       route="cuda"):
    """Elementwise (numpy-broadcast) K1 launch predicate."""
    bm, bn, bk = (np.asarray(a, np.int64) for a in (bm, bn, bk))
    pos = (bm > 0) & (bn > 0) & (bk > 0)
    rows = _pow2_at_least(np.minimum(bm, _ceil_mult(M, 8)), 16)
    cols = _pow2_at_least(np.minimum(bn, _ceil_mult(N, 128)), 128)
    return (dtype_ok(dtype, route, "matmul") & pos & (rows <= MM_MAX_ROWS)
            & (cols <= MM_MAX_COLS) & (rows * cols <= MM_ACC_LIMIT))


def attention_tiles_legal(Sq, Skv, D, bq, bkv, *, dtype=KERNEL_DTYPE,
                          route="cuda"):
    """Elementwise (numpy-broadcast) K2 launch predicate."""
    bq, bkv = np.asarray(bq, np.int64), np.asarray(bkv, np.int64)
    pos = (bq > 0) & (bkv > 0)
    bq_e = np.maximum(np.minimum(bq, Sq), 1)
    bkv_e = np.maximum(np.minimum(bkv, Skv), 1)
    launched = (head_dim_ok(D) & (bq_e <= ATTN_MAX_BQ)
                & (Sq % bq_e == 0) & (Skv % bkv_e == 0))
    # Sq == 1 (decode) never launches K2: it takes the plain branch
    return dtype_ok(dtype, route, "attention") & pos & (
        (np.asarray(Sq) == 1) | launched)


def chunk_tiles_legal(S, P, N, Q, *, dtype=KERNEL_DTYPE, route="cuda"):
    """Elementwise (numpy-broadcast) K3 launch predicate; ``S`` is the
    number of scanned positions of a group.  ``P`` never limits."""
    Q, N = np.asarray(Q, np.int64), np.asarray(N, np.int64)
    q_e = np.minimum(Q, S)
    return (dtype_ok(dtype, route, "chunk_scan") & (Q > 0)
            & (q_e <= kcs.Q_MAX) & (N >= 8)
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
    strides), the compiled CTA tile, the output grid, the split of K, the
    grouping of row blocks, the rows and columns a CTA computes and the
    thread-block cluster along M (``csrc/matmul.cu``,
    ``csrc/matmul_f32.cu``)."""
    variant: str        # "tma_wgmma", "split_k", "unaligned" or "f32"
    bm: int
    bn: int
    bk: int
    rows: int           # CTA rows (a power of two >= 16)
    cols: int           # CTA columns (a power of two >= 128)
    grid_m: int
    grid_n: int
    splits: int         # CTAs along K
    k_run: int          # K a CTA walks: CTA z takes [z, z + 1) * k_run
    group_m: int        # row blocks that run together (a multiple of
                        # ``cluster``)
    width: int          # columns a CTA computes: ``cols``, or in f32 at
                        # a narrower N the power of two >= 16 covering N
    height: int         # rows a CTA computes: ``rows``, or in f32 at M <=
                        # 8 and width >= 128 the power of two >= 4 over M
    cluster: int = 1    # CTAs of consecutive row blocks of one column
                        # block that share each w slab by multicast (> 1
                        # only on a swapped tile without a split, with a
                        # row-major w)
    occupancy: int = 1  # CTAs an SM of the swapped kernel: 2 at 128 and
                        # 256 columns (3 for 32 x 128 on a grid of
                        # MM_OCC3_WAVES waves of three), 1 at 512 and on
                        # every other layout

    @property
    def swapped(self) -> bool:
        """The wgmma variants at fewer than ``MM_SWAP_ROWS`` CTA rows
        compute ``y^T = w^T x^T``: the rows are wgmma's N."""
        return (self.variant in ("tma_wgmma", "split_k")
                and self.rows < MM_SWAP_ROWS)

    @property
    def layout(self) -> str:
        """``"swapped"`` or ``"direct"`` (x as wgmma's A, or no wgmma)."""
        return "swapped" if self.swapped else "direct"


def matmul_launch_plan(M: int, N: int, K: int, tiles, sms: int,
                       aligned: bool = True,
                       dtype: str = KERNEL_DTYPE,
                       cluster: Optional[int] = None,
                       w_kmajor: bool = False) -> Optional[MatmulLaunch]:
    """The launch of K1 for a legal tile (``None`` if illegal).  float32
    operands run the ``f32`` variant (never ``split_k`` or ``tma_wgmma``;
    it stages through ``cp.async`` where the pitch allows, so ``aligned``
    does not change it): K split into the runs of :func:`f32_split`, one
    CTA each, the same for every tile, M, N and card, the partials added
    in order of run, and the layout ``(height, width)`` narrowed to M and
    N.  bf16 operands TMA cannot take (``aligned`` false) run the
    unaligned variant.  An output grid smaller than ``sms`` splits K into at most
    ``sms // tiles`` runs of ``k_run``, a whole number of ``bk`` blocks
    (``split_k``), when ``bk`` is a multiple of the kernel's deepest
    stage, so that no stage of a run reads into the next; otherwise one
    CTA walks all of K (``tma_wgmma``).  The kernel takes ``k_run`` as it
    is.  A swapped tile (rows below ``MM_SWAP_ROWS``) groups all its row
    blocks (``group_m = grid_m``) and runs ``occupancy`` CTAs an SM; at
    three (the 32 x 128 tile on a large grid), K of at least
    ``MM_CLUSTER_MIN_K`` and a row-major w (``w_kmajor`` false: not the
    ``head.T`` view) it runs in clusters of ``MM_CLUSTER`` CTAs along M
    that share each w slab; ``cluster`` stands in for that choice (a
    probe's argument, 1 or 2 for a swapped ``tma_wgmma`` plan with a
    row-major w, 1 for any other).  ``group_m`` is rounded up to a
    multiple of the cluster, and the grid is padded to whole clusters
    (:func:`matmul_cta_tiles`).  Memoised: the wrapper asks once a
    call."""
    bm, bn, bk = (int(t) for t in tiles[:3])
    if dtype not in KERNEL_DTYPES["matmul"]:
        raise ValueError(f"K1 takes {KERNEL_DTYPES['matmul']}, not {dtype}")
    return _launch_plan(int(M), int(N), int(K), bm, bn, bk, int(sms),
                        bool(aligned), dtype == "float32",
                        None if cluster is None else int(cluster),
                        bool(w_kmajor))


@functools.lru_cache(maxsize=4096)
def _launch_plan(M, N, K, bm, bn, bk, sms, aligned, f32, cluster, w_kmajor):
    plan = matmul_tile_plan(M, N, K, (bm, bn, bk))
    if plan is None:
        return None
    bm, bn, bk, rows, cols = plan
    grid_m, grid_n = -(-M // bm), -(-N // bn)
    if f32:
        splits, k_run = f32_split(K)
        width = min(cols, int(_pow2_at_least(N, F32_MIN_WIDTH)))
        height = rows
        if width >= 128:
            height = min(rows, int(_pow2_at_least(M, F32_MIN_HEIGHT)))
        out = MatmulLaunch("f32", bm, bn, bk, rows, cols, grid_m, grid_n,
                           splits, k_run, 1, width, height)
        return _with_cluster(out, cluster, w_kmajor)
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
    out = MatmulLaunch(variant, bm, bn, bk, rows, cols, grid_m, grid_n,
                       splits, k_run, min(grid_m, band), cols, rows)
    if out.swapped:
        # two or three CTAs an SM run at once: grouping every row block
        # keeps the column blocks of w in flight, and so w's share of L2,
        # small (PERF.md)
        occ = 1 if cols == 512 else 2
        if (rows, cols) == (32, 128) and n_tiles >= MM_OCC3_WAVES * 3 * sms:
            occ = 3
        out = out._replace(group_m=grid_m, occupancy=occ)
    if cluster is None:
        cluster = 1
        if (variant == "tma_wgmma" and out.occupancy == 3 and grid_m >= 2
                and K >= MM_CLUSTER_MIN_K and not w_kmajor):
            cluster = MM_CLUSTER
    return _with_cluster(out, cluster, w_kmajor)


def _with_cluster(plan: MatmulLaunch, cluster, w_kmajor) -> MatmulLaunch:
    """``plan`` in clusters of ``cluster`` CTAs (``None``: 1), its
    ``group_m`` rounded up to a multiple; ``ValueError`` where the kernel
    takes no such cluster."""
    c = 1 if cluster is None else cluster
    if c not in MM_CLUSTERS or (c > 1 and not (
            plan.swapped and plan.variant == "tma_wgmma" and not w_kmajor)):
        raise ValueError(f"K1 takes a cluster of {MM_CLUSTER} only at a "
                         f"swapped tma_wgmma tile with a row-major w, not "
                         f"{c} at {plan}")
    return plan._replace(cluster=c, group_m=_ceil_mult(plan.group_m, c))


def matmul_cta_tiles(plan: MatmulLaunch) -> np.ndarray:
    """``(ctas, 3)``: the ``(mb, nb, rank)`` of each CTA of the kernel's
    grid along x (``blockIdx.x``) under ``plan``, as ``csrc/matmul.cu``'s
    ``cluster_tile_coords`` computes them: clusters of ``plan.cluster``
    consecutive CTAs on consecutive row blocks of one column block, the
    grid padded to whole clusters (a CTA at ``mb >= grid_m`` loads and
    stores nothing), clusters grouped ``group_m`` row blocks at a time,
    row clusters fastest.  The rows ≥ 64 and split kernels take cluster 1:
    row blocks grouped along M, row blocks fastest."""
    c = plan.cluster
    grid_mc = -(-plan.grid_m // c)
    tile = np.arange(grid_mc * c * plan.grid_n)
    cl, rank = tile // c, tile % c
    group_c = plan.group_m // c
    group = group_c * plan.grid_n
    first = (cl // group) * group_c
    gc = np.minimum(grid_mc - first, group_c)
    local = cl % group
    return np.stack([(first + local % gc) * c + rank, local // gc, rank],
                    axis=1)


def f32_split(K: int) -> Tuple[int, int]:
    """``(runs, k_run)``: how K1's f32 variant splits K, from K alone.
    Runs of ``k_run``, a multiple of the slab ``F32_BK`` and at least
    ``F32_MIN_RUN``, at most ``F32_MAX_RUNS`` of them; the last may be
    shorter.  A K of at most ``F32_MIN_RUN`` is one run (``k_run = K``).
    Each run is summed in order and the runs' partials added in order of
    run, so the bits of an output depend on K alone, not on the tile, M,
    N or the card."""
    K = int(K)
    if K <= F32_MIN_RUN:
        return 1, K
    k_run = max(F32_MIN_RUN, _ceil_mult(-(-K // F32_MAX_RUNS), F32_BK))
    return -(-K // k_run), k_run


class AttentionLaunch(NamedTuple):
    """How K2 runs one call (``csrc/flash_attention.cu``): the variant, the
    clamped blocks, the consumer warpgroups of 64 query rows, the keys a
    stage of the TMA ring holds, the stages over ``Skv`` (before the
    causal skip), the stages of the ring and its shared memory, and the
    padded widths of ``Q.K^T`` and ``P.V``."""
    variant: str        # "tma_wgmma" or "unaligned"
    bq: int
    bkv: int
    warpgroups: int
    stage_keys: int     # 128, or 64 where bkv < 128 or d_pad is 192
    n_stages: int       # ceil(Skv / stage_keys)
    ring: int           # 2 at (128, 128); the deepest that fits (at most
                        # ATTN_MAX_RING) at other widths
    smem: int           # dynamic shared memory bytes (tma_wgmma): Q,
                        # the output staging and the ring
    d_pad: int          # the widths tma_wgmma computes Q.K^T and P.V at
    dv_pad: int         # (attn_widths), passed to the kernel, which
                        # refuses a pair it does not compile


def attention_launch_plan(Sq: int, Skv: int, D: int, bq: int, bkv: int,
                          strides=None, aligned: bool = True,
                          Dv: Optional[int] = None
                          ) -> Optional[AttentionLaunch]:
    """The launch of K2 for a legal tile (``None`` if the rule refuses the
    tile or the head dims D and ``Dv``, default D).  The tma_wgmma variant
    computes ``Q.K^T`` at D's padded width and ``P.V`` at Dv's
    (:func:`attn_widths`), every column of Dv in one tile a (query block,
    batch, head), so the scores are computed once; shared memory holds Q
    at ``d_pad``, the output staging at ``dv_pad``
    (:func:`attn_staging_pitch`) and the ring's stages of a K tile at
    ``d_pad`` and a V tile at ``dv_pad``.  A stage holds 128 keys, or 64
    where ``bkv`` is below 128 or ``d_pad`` is 192 (beside an O of up to
    96 registers a consumer; a 96-key stage ran slower at ``mla.core`` on
    an H100, PERF.md).  At ``(128, 128)`` the ring is ``ATTN_RING`` deep:
    the first redesign's plan.  At the other widths it is the deepest that
    fits ``ATTN_SMEM_DYN``, up to ``ATTN_MAX_RING``: 4 at (64, 64), 3 at
    (96, 96), 3 at ``mla.core``'s (192, 128) and 2 at D = Dv = 192 with
    two warpgroups.  A ring is never deeper than the stages over Skv; the
    kernel sizes its shared memory alike (``launch_tma``) and refuses a
    ring that does not fit.  ``strides`` are q's, k's and v's (elements;
    ``None``: contiguous; a dimension of one element carries its
    contiguous stride) and ``aligned`` says their base pointers are
    16-byte aligned.  TMA takes a tensor whose last dim is contiguous and
    whose other strides are positive multiples of 16 bytes; an operand it
    cannot take runs the unaligned variant (at :func:`attn_d_pad`'s
    widths; the plan's other fields are tma_wgmma's)."""
    Dv = D if Dv is None else Dv
    if not attention_tiles_legal(Sq, Skv, D, bq, bkv) or (
            Sq > 1 and not head_dim_ok(D, Dv)):
        return None
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    if Sq % bq or Skv % bkv:        # only at Sq == 1, which K2 never runs
        return None
    tma = aligned and (strides is None or all(
        st[3] == 1 and all(x > 0 and x % 8 == 0 for x in st[:3])
        for st in strides))
    wgs = -(-bq // ATTN_WG_ROWS)
    d_pad, dv_pad = attn_widths(min(D, ATTN_D_MAX), min(Dv, ATTN_D_MAX))
    q_bytes = wgs * ATTN_WG_ROWS * d_pad * 2        # Q
    o_bytes = wgs * ATTN_WG_ROWS * attn_staging_pitch(dv_pad)  # staging
    keys = 128 if bkv >= 128 and d_pad <= 128 else 64
    n_stages = -(-Skv // keys)
    stage_bytes = 2 * keys * (d_pad + dv_pad)       # a K and a V tile, bf16
    fit = (ATTN_SMEM_DYN - 1024 - q_bytes - o_bytes) // stage_bytes
    deepest = ATTN_RING if (d_pad, dv_pad) == (128, 128) else ATTN_MAX_RING
    ring = max(1, min(deepest, fit, ATTN_MAX_RING, n_stages))
    return AttentionLaunch("tma_wgmma" if tma else "unaligned", bq, bkv,
                           wgs, keys, n_stages, ring,
                           q_bytes + o_bytes + ring * stage_bytes + 1024,
                           d_pad, dv_pad)


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


# each kernel, and the reference's Pallas kernel it replaces
_PALLAS = {"K1 (tiled matmul)": "repro/kernels/matmul.py:matmul_pallas",
           "K2 (flash attention forward)":
               "repro/kernels/flash_attention.py:flash_attention_pallas",
           "K3 (SSD chunk scan)": "repro/kernels/chunk_scan.py:chunk_scan_pallas"}


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when autograd would record a call of
    ``kernel``: it has no backward, so its output would silently cut the
    gradient of every input behind it.  Under ``torch.no_grad`` or
    ``inference_mode`` (serving, measurement) it never raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward, nor has the reference's Pallas "
            f"kernel ({_PALLAS[kernel]}): kernel mode (an injected tile "
            f"program) runs only without gradients; train in eager mode, "
            f"or call the kernel under torch.no_grad()")


def matmul(x: torch.Tensor, w: torch.Tensor,
           tiles: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """``x(M,K) @ w(K,N)`` through K1 (CUDA) or its plain version (CPU).
    Refuses autograd (:func:`refuse_grad`)."""
    refuse_grad("K1 (tiled matmul)", x, w)
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
    two factors.  k and v keep their Hkv heads (GQA).  Refuses autograd
    (:func:`refuse_grad`)."""
    refuse_grad("K2 (flash attention forward)", q, k, v)
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
    x (G,S,P); Bm/Cm (G,S,N); la (G,S) log-decay; ``chunk`` the tuned Q.
    Refuses autograd (:func:`refuse_grad`)."""
    refuse_grad("K3 (SSD chunk scan)", x, Bm, Cm, la)
    if _route(x) == "cuda":
        return kcs.chunk_scan_cuda(x, Bm, Cm, la, chunk=chunk)
    return kcs.chunk_scan_plain(x, Bm, Cm, la, chunk=chunk)
