"""K1: tiled matmul ``x(M,K) @ w(K,N)`` as a hand-written Hopper kernel.

Replaces the TPU kernel ``src/repro/kernels/matmul.py`` (``matmul_pallas``
and ``_matmul_kernel``).  The CUDA source is ``csrc/matmul.cu``; a CTA owns
the agent's (bm, bn) output tile, accumulates in f32 and writes the output
in ``x.dtype``.  Three variants (``ops.matmul_launch_plan`` picks one):

* ``tma_wgmma``: a ring of TMA loads into shared memory, one producer
  thread, two consumer warpgroups of ``wgmma``; ``w`` is read in place
  whether row-major or the transposed ``lm_head`` view.  K is walked in
  order, so ``bk`` only bounds the ragged K edge.
* ``split_k``: the same kernel when the output grid has fewer CTAs than the
  card has SMs (decode, M = 4) and ``bk`` is a multiple of 128: K is split
  into runs of whole ``bk`` blocks, one CTA each, and the last CTA of a
  tile sums the f32 partials in order of k.  One launch.
* ``unaligned``: operands TMA cannot take (a row pitch or pointer that is
  not a multiple of 16 bytes) go through the first kernel's loop
  (``mma.sync``, staged through static shared memory).

What bounds it on the H100: at prefill (M = 2048) the tensor-core rate,
at decode (M = 4) reading ``w`` once from device memory.

On a CPU tensor :func:`repro_torch.kernels.ops.matmul` takes
:func:`matmul_plain`; on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches and nothing else;
``launches_by_variant`` splits the same count by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

VARIANTS = ("tma_wgmma", "split_k", "unaligned")
launches = 0
launches_by_variant = {v: 0 for v in VARIANTS}

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
_TMA_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 10
                 + [ctypes.c_void_p])
_SMS: dict = {}                 # device index -> SM count
_COUNTERS: dict = {}            # (device, stream) -> split-k tile counters


class TileError(ValueError):
    """The tile cannot launch on the card (``ops.tile_ok`` is false)."""


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 accumulation, output in
    ``x.dtype``.  Every legal tile computes this function."""
    return (x.float() @ w.float()).to(x.dtype)


def _fn(name, argtypes):
    fn = getattr(build.load("matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def reset_counts() -> None:
    """Zero ``launches`` and ``launches_by_variant``."""
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Per-tile arrival counters of the split variant.  They start at zero
    and the kernel puts each back to zero, so one buffer serves every call
    on one stream; calls on two streams may overlap, so each stream has
    its own."""
    c = _COUNTERS.get((device, stream))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = c
    return c


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, bm: int, bn: int,
                bk: int) -> torch.Tensor:
    """Launch K1 on CUDA tensors with the tuned tile ``(bm, bn, bk)``."""
    from repro_torch.kernels.ops import (KERNEL_DTYPE, matmul_launch_plan,
                                         torch_dtype_ok)
    global launches
    if not torch_dtype_ok(x, w):
        raise TypeError(f"K1 takes {KERNEL_DTYPE}, got {x.dtype} @ "
                        f"{w.dtype} (ops.dtype_ok)")
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
    # TMA (and 16-byte loads) take a 16-byte aligned base and row pitch
    vec_a = lda % 8 == 0 and x.data_ptr() % 16 == 0
    vec_b = ldw % 8 == 0 and w.data_ptr() % 16 == 0
    plan = matmul_launch_plan(M, N, K, (bm, bn, bk), _sm_count(x.device),
                              aligned=vec_a and vec_b)
    if plan is None:
        raise TileError(f"matmul tile {(bm, bn, bk)} cannot launch at "
                        f"M={M} N={N} K={K} (ops.tile_ok)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if plan.variant == "unaligned":
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
            stream)
    build.check(rc, f"matmul kernel ({plan.variant})")
    launches += 1
    launches_by_variant[plan.variant] += 1
    return y
