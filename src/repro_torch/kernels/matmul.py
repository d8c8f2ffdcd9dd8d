"""K1: tiled matmul ``x(M,K) @ w(K,N)`` as a hand-written Hopper kernel.

Replaces the TPU kernel ``src/repro/kernels/matmul.py`` (``matmul_pallas``
and ``_matmul_kernel``).  The CUDA source is ``csrc/matmul.cu``: a CTA owns
one (bm, bn) output tile, walks K in steps of bk streamed through shared
memory in 32-wide sub-slabs, accumulates in f32 registers with
``mma.sync`` bf16 tensor-core products and writes the output in
``x.dtype``.  Ragged edges are masked, never padded, and ``w`` is read
through its strides, so the transposed ``lm_head`` view costs no copy.

What bounds it on the H100: at prefill (M = 2048) the tensor-core rate,
at decode (M = 4) reading ``w`` once from device memory.  This first
version stages single-buffered through shared memory; a pipelined
wgmma/TMA version is later work.

On a CPU tensor :func:`repro_torch.kernels.ops.matmul` takes
:func:`matmul_plain`; on a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


class TileError(ValueError):
    """The tile cannot launch on the card (``ops.tile_ok`` is false)."""


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 accumulation, output in
    ``x.dtype``.  Every legal tile computes this function."""
    return (x.float() @ w.float()).to(x.dtype)


def _lib():
    lib = build.load("matmul")
    fn = lib.repro_matmul_bf16
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def matmul_cuda(x: torch.Tensor, w: torch.Tensor, bm: int, bn: int,
                bk: int) -> torch.Tensor:
    """Launch K1 on CUDA tensors with the tuned tile ``(bm, bn, bk)``."""
    from repro_torch.kernels.ops import matmul_tile_plan
    global launches
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"K1 takes bfloat16, got {x.dtype} @ {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"K1 needs x(M,K) @ w(K,N), got {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError("K1 needs both operands on one CUDA device")
    M, K = x.shape
    N = w.shape[1]
    plan = matmul_tile_plan(M, N, K, (bm, bn, bk))
    if plan is None:
        raise TileError(f"matmul tile {(bm, bn, bk)} cannot launch at "
                        f"M={M} N={N} K={K} (ops.tile_ok)")
    bm_e, bn_e, bk_e, bm_k, bn_k = plan
    if x.stride(1) != 1:
        x = x.contiguous()
    swk, swn = w.stride()
    if swn != 1 and swk != 1:
        raise ValueError(f"K1 reads w with one unit stride, got {w.stride()}")
    lda = x.stride(0)
    lead = swn if (swk == 1 and swn != 1) else swk
    vec_a = int(lda % 8 == 0 and x.data_ptr() % 16 == 0)
    vec_b = int(lead % 8 == 0 and w.data_ptr() % 16 == 0)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _lib()(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, lda, swk,
                swn, bm_e, bn_e, bk_e, bm_k, bn_k, vec_a, vec_b,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "matmul kernel")
    launches += 1
    return y
