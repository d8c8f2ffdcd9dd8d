"""K3: the SSD chunk scan as a hand-written Hopper kernel.

Replaces the TPU kernel ``src/repro/kernels/chunk_scan.py``
(``chunk_scan_pallas`` and ``_chunk_kernel``).  Per group g, with a
scalar log-decay per position::

    y[t] = sum_{s<=t} exp(cum[t]-cum[s]) * (C[t].B[s]) * x[s]

computed chunk by chunk (Q positions): ``cum = cumsum(la)`` inside the
chunk, the intra-chunk term ``((C Bᵀ) ⊙ causal exp(cum_i - cum_j)) @ x``,
the inter-chunk term ``exp(cum) ⊙ (C @ stateᵀ)`` and the f32 ``(P, N)``
state update ``state·exp(cum[-1]) + xᵀ @ (B·exp(cum[-1] - cum))``.

The CUDA source is ``csrc/chunk_scan.cu``.  On the TPU the chunk axis of
the grid runs in order on one core and carries the state in VMEM; on the
card the parallelism runs over chunks (the "state space duality" form of
Mamba-2), in passes sized by
:func:`repro_torch.kernels.ops.chunk_launch_plan`:

1. ``chunk_state``: each chunk's own state ``(B ⊙ d)ᵀ x`` (computed
   transposed, rows n), f32, all chunks at once (TMA slabs; the decayed B
   is ``wgmma``'s A operand from registers, x MN-major);
2. ``state_pass``: the chain ``S_{c+1} = A_c S_c + ΔS_c`` in f32, one
   thread per state element (or per segment of its chunks), storing the
   state entering each chunk in bf16;
3. ``chunk_out``: a CTA per 64-row block of a chunk computes its masked
   scores once into shared memory, then per tile of P the carried-state
   term and the intra-chunk term on ``wgmma`` into one accumulator.

That is the ``three_pass`` variant.  In ``walk`` (many state tiles and
many chunks, as at the xLSTM site with Q ≤ 256) a chunk_state CTA walks
every chunk of its tile with the state in its accumulator, which fuses
the state pass in and keeps ``ΔS`` out of device memory.

:func:`chunk_scan_plain` is the function in f32 (the CPU tests also hold
an emulation of the passes, with the kernel's bf16 roundings, against
it).  bf16 x, B and C, ``la`` in bf16 or f32 (read as it is, ``cum`` in f32),
output in ``x.dtype``.  What bounds it on the H100: at the xLSTM site
(Q = 256, P = N = 1024) the operations, 38.7 GFLOP against 67 MB;
three_pass adds ``n_chunks·P·N·12`` bytes of intermediates in device
memory, the walk ``n_chunks·P·N·4``.

On a CPU tensor :func:`repro_torch.kernels.ops.chunk_scan` takes
:func:`chunk_scan_plain`; on a CUDA tensor it launches the kernels or
raises.  ``launches`` counts kernel calls (all passes of a call are one)
and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import TileError

Q_MAX = 1024        # largest chunk: its cumsum and a row block's scores
                    # against it live in shared memory
N_MAX = 1024        # largest state width

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 12 + [ctypes.c_void_p])
VARIANTS = ("three_pass", "walk")


def effective_chunk(S: int, chunk: int) -> int:
    """The reference's clamp and divisibility rule (``chunk_scan.py:69-70``),
    on every device."""
    Q = min(int(chunk), S)
    if Q <= 0 or S % Q:
        raise ValueError(f"the chunk must divide the sequence: S={S} "
                         f"chunk={chunk}")
    return Q


def chunk_scan_plain(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     la: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the chunkwise algorithm of
    ``_chunk_kernel`` in f32 over chunks of ``chunk`` positions, output in
    ``x.dtype``.  x (G,S,P); Bm/Cm (G,S,N); la (G,S)."""
    G, S, P = x.shape
    N = Bm.shape[-1]
    Q = effective_chunk(S, chunk)
    xf, bf, cf, lf = (t.float() for t in (x, Bm, Cm, la))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((G, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((G, S, P), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, Q):
        xc, bc, cc = xf[:, c0:c0 + Q], bf[:, c0:c0 + Q], cf[:, c0:c0 + Q]
        cum = torch.cumsum(lf[:, c0:c0 + Q], dim=1)            # (G,Q)
        li = cum[:, :, None] - cum[:, None, :]
        L = torch.where(causal, torch.exp(li), torch.zeros_like(li))
        yc = (cc @ bc.transpose(1, 2) * L) @ xc
        yc = yc + torch.exp(cum)[..., None] * (cc @ state.transpose(1, 2))
        seg = torch.exp(cum[:, -1:] - cum)                     # (G,Q)
        state = (state * torch.exp(cum[:, -1])[:, None, None]
                 + xc.transpose(1, 2) @ (bc * seg[..., None]))
        y[:, c0:c0 + Q] = yc
    return y.to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base, as TMA reads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _lib():
    lib = build.load("chunk_scan")
    fn = lib.repro_chunk_scan_bf16
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def chunk_scan_cuda(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    la: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Launch K3 on CUDA tensors with the tuned chunk."""
    from repro_torch.kernels.ops import (KERNEL_DTYPE, chunk_launch_plan,
                                         chunk_tiles_legal, torch_dtype_ok)
    global launches
    if not torch_dtype_ok(x, Bm, Cm, kind="chunk_scan"):
        raise TypeError(f"K3 takes {KERNEL_DTYPE} x, B and C, got {x.dtype}/"
                        f"{Bm.dtype}/{Cm.dtype} (ops.dtype_ok)")
    if x.dim() != 3 or Bm.shape != Cm.shape or Bm.dim() != 3 \
            or Bm.shape[:2] != x.shape[:2] or tuple(la.shape) != x.shape[:2]:
        raise ValueError(f"K3 needs x (G,S,P), B and C (G,S,N), la (G,S); "
                         f"got {tuple(x.shape)} {tuple(Bm.shape)} "
                         f"{tuple(Cm.shape)} {tuple(la.shape)}")
    if not all(t.is_cuda and t.device == x.device for t in (x, Bm, Cm, la)):
        raise ValueError("K3 needs x, B, C and la on one CUDA device")
    G, S, P = x.shape
    N = Bm.shape[-1]
    effective_chunk(S, chunk)
    if not chunk_tiles_legal(S, P, N, chunk):
        raise TileError(f"chunk {chunk} cannot launch at S={S} P={P} N={N} "
                        f"(ops.tile_ok)")
    if G * S >= 2 ** 31:
        raise ValueError(f"K3 takes fewer than 2^31 positions, got {G * S}")
    plan = chunk_launch_plan(G, S, P, N, chunk)
    if la.dtype not in (torch.bfloat16, torch.float32):
        la = la.float()
    x, Bm, Cm, la = (_aligned(t) for t in (x, Bm, Cm, la))
    if plan.P_pad != P:                 # TMA needs 16-byte row strides
        x = torch.nn.functional.pad(x, (0, plan.P_pad - P))
    dev = x.device
    dstate = torch.empty(plan.dstate_elems, dtype=torch.float32, device=dev)
    states = torch.empty(plan.states_elems, dtype=torch.bfloat16, device=dev)
    alog = torch.empty(plan.alog_elems, dtype=torch.float32, device=dev)
    y = torch.empty((G, S, plan.P_pad), dtype=x.dtype, device=dev)
    rc = _lib()(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), la.data_ptr(),
                int(la.dtype == torch.bfloat16), dstate.data_ptr(),
                states.data_ptr(), alog.data_ptr(), y.data_ptr(), G, S,
                plan.P_pad, N, plan.Q, VARIANTS.index(plan.variant),
                plan.state_cols, plan.state_wgs, plan.state_ring,
                plan.segments,
                plan.p_tile, plan.out_ring,
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "chunk-scan kernel")
    launches += 1
    return y if plan.P_pad == P else y[..., :P].contiguous()
