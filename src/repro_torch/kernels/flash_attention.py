"""K2: flash-attention forward as a hand-written Hopper kernel.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_pallas`` and ``_flash_kernel``).  The CUDA source is
``csrc/flash_attention.cu``; a CTA owns ``bq`` query rows of one (batch,
head).  GQA is read in place (KV head ``h // (Hq // Hkv)``), never
materialised.  The causal mask is bottom-right aligned with the finite
``NEG_INF`` and the output is ``acc / max(l, 1e-30)``, as on the TPU.  Two
variants (``ops.attention_launch_plan`` picks one):

* ``tma_wgmma``: one producer thread streams K and V tiles of up to 128
  keys through a TMA ring in shared memory (4-D tensor maps over the
  tensors' own strides, so the model's transposed ``v`` is read in place);
  one or two consumer warpgroups of 64 query rows compute ``Q.K^T`` and
  ``P.V`` with ``wgmma`` and the online softmax in registers (P in bf16 as
  the register operand of ``P.V``).  A ``bkv`` above the stage is walked
  in stages with the rescale per stage, the same function up to
  rounding.
* ``unaligned``: operands TMA cannot take (a base or a stride that is not
  a multiple of 16 bytes, or D not contiguous) go through the first
  kernel's loop (``mma.sync``, 16 query rows a warp).

What bounds it on the H100: at the Qwen3-8B prefill (B=4, H=32, Hkv=8,
S=512, causal) the bytes, 42 MB of q, k, v and out (0.0125 ms) against
0.0087 ms of the causal half's products; the scores never reach device
memory and each K/V tile is loaded once a CTA for both warpgroups.

Head dims: D any multiple of 8 up to 192, and v's own value dim Dv
likewise, padded no wider than D (``ops.head_dim_ok``; MLA's D = 192, Dv
= 128).  ``tma_wgmma`` computes ``Q.K^T`` at D's own padded width and
``P.V`` at Dv's (``ops.attn_widths``: 64, 96, 128 or 192; the 96 in a
64-column slab and a 32-column one), all of Dv in one tile a (query
block, batch, head), so the scores are computed once; the unaligned
variant at 128, or 192 above (``ops.attn_d_pad``).  TMA's tensor maps
carry the true D and Dv, so the columns past them load as zeros
(``Q.K^T`` over them adds nothing, the ``P.V`` columns past Dv are never
stored), and the epilogue stores only the first Dv columns of the (B, Hq,
Sq, Dv) output.  What padding is left costs tensor work: StableLM-3B's D
= 80 computes at 96 (1.2x its own), SeamlessM4T's 64 and the runner's D =
Dv = 192 at their own widths.

On a CPU tensor :func:`repro_torch.kernels.ops.flash_attention` takes
:func:`flash_attention_plain`; on a CUDA tensor it launches the kernel or
raises.  ``launches`` counts kernel launches and nothing else;
``launches_by_variant`` splits the same count by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import TileError

NEG_INF = -1e30

VARIANTS = ("tma_wgmma", "unaligned")
launches = 0
launches_by_variant = {v: 0 for v in VARIANTS}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_void_p])
_TMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_void_p])
_CALLS: dict = {}       # call signature -> (variant, C function, arguments)


def reset_counts() -> None:
    """Zero ``launches`` and ``launches_by_variant``."""
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0


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
    ``bkv`` key blocks with f32 statistics.  q (B,Hq,Sq,D); k (B,Hkv,Skv,D);
    v (B,Hkv,Skv,Dv); out (B,Hq,Sq,Dv)."""
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


def _fn(name, argtypes):
    fn = getattr(build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _tma_strides(t: torch.Tensor):
    """``t``'s strides, with the contiguous one for a dimension of one
    element (TMA never steps along it, and PyTorch may give it any)."""
    out, run = [], 1
    for n, st in zip(reversed(t.shape), reversed(t.stride())):
        out.append(st if n > 1 else run)
        run *= n
    return tuple(reversed(out))


def _prepare(q, k, v, causal: bool, bq: int, bkv: int):
    """Check a call and plan it: the variant, the C function, and its
    arguments between the four pointers and the scale."""
    from repro_torch.kernels.ops import (ATTN_D_MAX, KERNEL_DTYPE,
                                         attention_launch_plan, head_dim_ok,
                                         torch_dtype_ok)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if not torch_dtype_ok(q, k, v, kind="attention"):
        raise TypeError(f"K2 takes {KERNEL_DTYPE}, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype} (ops.dtype_ok)")
    if not head_dim_ok(D, Dv) or k.shape[-1] != D:
        raise ValueError(f"K2 takes a head dim D (q, k) and a value dim Dv "
                         f"(v), multiples of 8 up to {ATTN_D_MAX}, Dv "
                         f"padded no wider than D (ops.head_dim_ok), got q "
                         f"{D}, k {k.shape[-1]}, v {Dv}")
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or Hq % Hkv:
        raise ValueError(f"bad attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("K2 needs q, k and v on one CUDA device")
    effective_blocks(Sq, Skv, bq, bkv)
    strides = tuple(_tma_strides(t) for t in (q, k, v))
    plan = attention_launch_plan(
        Sq, Skv, D, bq, bkv, strides,
        aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v)), Dv=Dv)
    if plan is None:
        raise TileError(f"attention tile {(bq, bkv)} cannot launch at "
                        f"Sq={Sq} Skv={Skv} D={D} (ops.tile_ok)")
    if plan.variant == "tma_wgmma":
        return plan.variant, _fn("repro_flash_fwd_tma_bf16", _TMA_ARGTYPES), (
            B, Hq, Hkv, Sq, Skv, D, Dv, *strides[0][:3], *strides[1][:3],
            *strides[2][:3], plan.bq, plan.warpgroups, plan.stage_keys,
            plan.n_stages, plan.ring, plan.d_pad, plan.dv_pad, int(causal))
    # 16-byte loads where a tensor's rows are contiguous and aligned
    vec = [int(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:3]))
           for t in (q, k, v)]
    return plan.variant, _fn("repro_flash_fwd_unaligned_bf16", _ARGTYPES), (
        B, Hq, Hkv, Sq, Skv, D, Dv, *q.stride(), *k.stride(), *v.stride(),
        plan.bq, plan.bkv, int(causal), *vec)


def tma_last_launch() -> dict:
    """What the last launch of the tma_wgmma variant in this process ran
    at, as its C entry point recorded it: warpgroups, stage keys, the
    widths of ``Q.K^T`` and ``P.V``, the ring and the dynamic shared memory
    bytes it asked for (all 0 before the first launch)."""
    fn = build.load("flash_attention").repro_flash_tma_last_launch
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], None
    vals = (ctypes.c_int * 6)()
    fn(vals)
    return dict(zip(("warpgroups", "stage_keys", "d_pad", "dv_pad", "ring",
                     "smem"), vals))


def flash_attention_cuda(q, k, v, *, causal: bool, scale: float, bq: int,
                         bkv: int) -> torch.Tensor:
    """Launch K2 on CUDA tensors with the tuned blocks ``(bq, bkv)``.  A
    call is checked and planned once for its shapes, strides, types,
    devices, pointer alignment and tile; the plan is kept for the next
    call like it (the host's cost is on every call of a layer)."""
    global launches
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    key = (q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           q.dtype, k.dtype, v.dtype, q.device, k.device, v.device,
           tuple(p % 16 for p in ptrs), bool(causal), bq, bkv)
    hit = _CALLS.get(key)
    if hit is None:
        hit = _CALLS[key] = _prepare(q, k, v, bool(causal), bq, bkv)
    variant, fn, args = hit
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                      device=q.device)
    rc = fn(*ptrs, out.data_ptr(), *args, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, f"flash-attention kernel ({variant})")
    launches += 1
    launches_by_variant[variant] += 1
    return out
