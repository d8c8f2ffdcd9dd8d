"""K2: flash-attention forward as a hand-written Hopper kernel.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas`` and ``_flash_kernel``).  The CUDA source is
``csrc/flash_attention.cu``: a CTA owns ``bq`` query rows of one (batch,
head) and steps over the keys in blocks of ``bkv``, each streamed through
shared memory in 64-key sub-slabs with the online-softmax rescale applied
per sub-slab.  Each warp keeps its 16 rows' f32 accumulator in registers.
GQA is read in place (KV head ``h // (Hq // Hkv)``), never materialised.
The causal mask is bottom-right aligned with the finite ``NEG_INF`` and
the output is ``acc / max(l, 1e-30)``, as on the TPU.

What bounds it on the H100: at prefill (Sq = Skv = 512, D = 128) the
tensor-core rate; the scores never reach device memory.  This first
version stages single-buffered through shared memory with a transposed V
tile; wgmma, TMA and pipelining are later work.  Head dim 128 only.

On a CPU tensor :func:`repro_torch.kernels.ops.flash_attention` takes
:func:`flash_attention_plain`; on a CUDA tensor it launches the kernel or
raises.  ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import TileError

NEG_INF = -1e30
HEAD_DIM = 128          # the only head dim the CUDA kernel is built for

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def effective_blocks(Sq: int, Skv: int, bq: int, bkv: int):
    """The reference's clamp and divisibility rule
    (``flash_attention.py:72-74``), on every device."""
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    if bq <= 0 or bkv <= 0 or Sq % bq or Skv % bkv:
        raise ValueError(f"attention blocks must divide the sequence: "
                         f"Sq={Sq} bq={bq} Skv={Skv} bkv={bkv}")
    return bq, bkv


def flash_attention_plain(q, k, v, *, causal: bool, scale: float, bq: int,
                          bkv: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the online softmax over
    ``bkv`` key blocks with f32 statistics.  q (B,Hq,Sq,D); k, v
    (B,Hkv,Skv,D)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    bq, bkv = effective_blocks(Sq, Skv, bq, bkv)
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    qf = q.float()
    q_pos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    m = torch.full((B, Hq, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hq, Sq, v.shape[-1]), device=q.device)
    for j in range(0, Skv, bkv):
        s = qf @ k[:, :, j:j + bkv].float().transpose(-1, -2) * scale
        if causal:
            k_pos = torch.arange(j, j + bkv, device=q.device)
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vj = v[:, :, j:j + bkv]
        acc = acc * corr + p.to(v.dtype).float() @ vj.float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _lib():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float, bq: int,
                         bkv: int) -> torch.Tensor:
    """Launch K2 on CUDA tensors with the tuned blocks ``(bq, bkv)``."""
    from repro_torch.kernels.ops import attention_tiles_legal
    global launches
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"K2 takes bfloat16, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if D != HEAD_DIM or k.shape[-1] != D or v.shape[-1] != D:
        raise ValueError(f"K2 is built for head dim {HEAD_DIM}, got "
                         f"q {D}, k {k.shape[-1]}, v {v.shape[-1]}")
    if k.shape != v.shape or k.shape[0] != B or Hq % Hkv:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not all(t.is_cuda and t.device == q.device for t in (k, v)):
        raise ValueError("K2 needs q, k and v on one CUDA device")
    bq_e, bkv_e = effective_blocks(Sq, Skv, bq, bkv)
    if not attention_tiles_legal(Sq, Skv, D, bq, bkv):
        raise TileError(f"attention tile {(bq, bkv)} cannot launch at "
                        f"Sq={Sq} Skv={Skv} D={D} (ops.tile_ok)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"K2 needs 16-byte aligned rows of {name}, "
                             f"strides {t.stride()}")
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, Sq, Skv, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], bq_e, bkv_e, int(causal), float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash-attention kernel")
    launches += 1
    return out
