"""K1: tiled matmul ``x(M,K) @ w(K,N)`` as a hand-written Hopper kernel.

Replaces the TPU kernel ``src/repro/kernels/matmul.py`` (``matmul_pallas``
and ``_matmul_kernel``).  The CUDA sources are ``csrc/matmul.cu`` and, for
f32 operands, ``csrc/matmul_f32.cu``; a CTA owns the agent's (bm, bn)
output tile, accumulates in f32 and writes the output in ``x.dtype``.
Four variants (``ops.matmul_launch_plan`` picks one):

* ``tma_wgmma``: a ring of TMA loads into shared memory, one producer
  thread, two consumer warpgroups of ``wgmma``; ``w`` is read in place
  whether row-major or the transposed ``lm_head`` view.  K is walked in
  order, so ``bk`` only bounds the ragged K edge.  CTA tiles of 64 rows
  and more put x in wgmma's A; tiles of 16 and 32 rows (``bm`` 8, 16,
  32) swap the operands, ``y^T = w^T x^T``, so their rows are wgmma's N
  and none is padded (``plan.layout``: ``"swapped"`` or ``"direct"``),
  and run ``plan.occupancy`` CTAs an SM over all their row blocks at
  once.  The swapped kernel can also share each slab of a row-major
  ``w`` over a thread-block cluster of ``plan.cluster`` = 2 CTAs along M
  by multicast TMA loads: the plan takes it for the 32 x 128 tile at
  three CTAs an SM and a long K (``ops.MM_CLUSTER_MIN_K``), where on an
  H100 it ran faster, 1 elsewhere; ``matmul_cuda(..., cluster=C)`` forces
  C = 1 or 2.
* ``split_k``: the same kernels when the output grid has fewer CTAs than
  the card has SMs (decode, M = 4) and ``bk`` is a multiple of 128: K is
  split into runs of whole ``bk`` blocks, one CTA each, and the last CTA
  of a tile sums the f32 partials in order of k.  One launch, no
  cluster.
* ``unaligned``: operands TMA cannot take (a row pitch or pointer that is
  not a multiple of 16 bytes) go through the first kernel's loop
  (``mma.sync``, staged through static shared memory).
* ``f32``: float32 operands (the MoE router's ``moe.router`` site and the
  corpus's f32 sites, where the reference's ``matmul_pallas`` computes in
  f32), ``csrc/matmul_f32.cu``.  FFMA, each of 256 threads holding a
  register micro-tile; no TF32, whose 10 mantissa bits would flip the
  router's top-k at near ties against the eager path.  A router's output
  grid is a handful of tiles (16 at M = 2048, one at M = 4), so K is
  split into ``ops.f32_split(K)`` runs (at most 8, from K alone), one CTA
  each: each CTA sums its run in order into a workspace, and the last CTA
  of a tile adds the partials in order of run, in one launch.  Every
  output then has the same bits at every legal tile and every M.  At a
  narrow N (Jamba's 16) the CTA computes only N's columns
  (``plan.width``) and its threads go over rows, at decode only M's rows
  (``plan.height``); 32-deep slabs stage through a ring of 2 to 8
  ``cp.async`` stages.

What bounds it on the H100: at prefill (M = 2048) the tensor-core rate,
at decode (M = 4) reading ``w`` once from device memory; the ``f32``
variant the FP32 rate outside the tensor cores (about 67 TFLOP/s), or
at N = 16 reading ``x``, at decode reading ``w``.

On a CPU tensor :func:`repro_torch.kernels.ops.matmul` takes
:func:`matmul_plain`; on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches and nothing else;
``launches_by_variant`` splits the same count by variant and
``launches_by_layout`` by layout.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

VARIANTS = ("tma_wgmma", "split_k", "unaligned", "f32")
LAYOUTS = ("swapped", "direct")
launches = 0
launches_by_variant = {v: 0 for v in VARIANTS}
launches_by_layout = {v: 0 for v in LAYOUTS}

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
_TMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 12
                 + [ctypes.c_void_p])
_F32_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 11
                 + [ctypes.c_void_p])
_SMS: dict = {}                 # device index -> SM count
_COUNTERS: dict = {}            # (device, stream) -> split-k tile counters


class TileError(ValueError):
    """The tile cannot launch on the card (``ops.tile_ok`` is false)."""


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 accumulation, output in
    ``x.dtype`` (in f32 the exact f32 product: TF32 stays off).  Every
    legal tile computes this function."""
    return (x.float() @ w.float()).to(x.dtype)


def _fn(name, argtypes, lib="matmul"):
    fn = getattr(build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def reset_counts() -> None:
    """Zero ``launches``, ``launches_by_variant`` and
    ``launches_by_layout``."""
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0
    for v in LAYOUTS:
        launches_by_layout[v] = 0


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Per-tile arrival counters of the split variants.  They start at zero
    and the kernel puts each back to zero, so one buffer serves every call
    on one stream; calls on two streams may overlap, so each stream has
    its own."""
    c = _COUNTERS.get((device, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = c
    return c


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, bm: int, bn: int,
                bk: int, cluster: Optional[int] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors with the tuned tile ``(bm, bn, bk)``.
    ``cluster`` stands in for the plan's thread-block cluster
    (``ops.matmul_launch_plan``): a probe's argument, which no model path
    passes."""
    from repro_torch.kernels.ops import (KERNEL_DTYPES, matmul_launch_plan,
                                         torch_dtype_ok)
    global launches
    if not torch_dtype_ok(x, w, kind="matmul"):
        raise TypeError(f"K1 takes one of {KERNEL_DTYPES['matmul']} for "
                        f"both operands, got {x.dtype} @ {w.dtype} "
                        f"(ops.dtype_ok)")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"K1 needs x(M,K) @ w(K,N), got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("K1 needs both operands on one CUDA device")
    M, K = x.shape
    N = w.shape[1]
    if x.stride(1) != 1:
        x = x.contiguous()
    swk, swn = w.stride()
    if swn != 1 and swk != 1:
        raise ValueError(f"K1 reads w with one unit stride, got {w.stride()}")
    w_kmajor = swk == 1 and swn != 1
    lda, ldw = x.stride(0), (swn if w_kmajor else swk)
    f32 = x.dtype == torch.float32
    # TMA (and 16-byte loads) take a 16-byte aligned base and row pitch
    per16 = 4 if f32 else 8
    vec_a = lda % per16 == 0 and x.data_ptr() % 16 == 0
    vec_b = ldw % per16 == 0 and w.data_ptr() % 16 == 0
    plan = matmul_launch_plan(M, N, K, (bm, bn, bk), _sm_count(x.device),
                              aligned=vec_a and vec_b,
                              dtype="float32" if f32 else "bfloat16",
                              cluster=cluster, w_kmajor=w_kmajor)
    if plan is None:
        raise TileError(f"matmul tile {(bm, bn, bk)} cannot launch at "
                        f"M={M} N={N} K={K} (ops.tile_ok)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if plan.variant == "f32":
        # a row-major w's 16-byte chunks start at column n0 = bn * j
        vec_b = vec_b and (w_kmajor or plan.bn % 4 == 0)
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, M, N), dtype=torch.float32,
                             device=x.device)
            counters = _counters(x.device, stream,
                                 plan.grid_m * plan.grid_n)
        rc = _fn("repro_matmul_f32", _F32_ARGTYPES, "matmul_f32")(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), M, N, K,
            lda, ldw, int(w_kmajor), plan.bm, plan.bn, plan.height,
            plan.width, plan.k_run, plan.splits, plan.grid_m, plan.grid_n,
            int(vec_a), int(vec_b), stream)
    elif plan.variant == "unaligned":
        rc = _fn("repro_matmul_unaligned_bf16", _ARGTYPES)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, lda, swk,
            swn, plan.bm, plan.bn, plan.bk, plan.rows, plan.cols,
            int(vec_a), int(vec_b), stream)
    else:
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty((plan.splits, M, N), dtype=torch.float32,
                             device=x.device)
            counters = _counters(x.device, stream,
                                 plan.grid_m * plan.grid_n)
        rc = _fn("repro_matmul_tma_bf16", _TMA_ARGTYPES)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), M, N, K, lda,
            ldw, int(w_kmajor), plan.bm, plan.bn, plan.k_run, plan.rows,
            plan.cols, plan.grid_m, plan.grid_n, plan.group_m, plan.splits,
            plan.cluster, plan.occupancy, stream)
    build.check(rc, f"matmul kernel ({plan.variant})")
    launches += 1
    launches_by_variant[plan.variant] += 1
    launches_by_layout[plan.layout] += 1
    return y
