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
card nothing carries over between CTAs, so one call is two passes:

1. *scores*: ``(C Bᵀ) ⊙ L`` of every chunk, in parallel over (group,
   chunk, 64x64 tile), written in bf16 to a scratch of ``(G·S, Qp)`` with
   ``Qp = Q`` rounded up to 64.  The Q x Q block never has to fit on chip.
2. *scan*: one CTA per (group, 16 columns of P) walks the chunks in order.
   The rows of the state and the columns of ``y`` are independent in P, so
   P gives the parallelism (the runner's sites have G = 1); each CTA
   carries its ``(16, N)`` f32 slice of the state in registers (N <= 1024)
   as ``mma.sync`` accumulators.  The state update's decay is applied to
   the 16 x Q slice of x, so B is read as it lies: slabs copied with
   ``cp.async`` and read as fragments with ``ldmatrix.trans``.

bf16 inputs, f32 accumulation, output in ``x.dtype``; the scores, the
state and ``x·decay`` enter the tensor cores rounded to bf16.  What bounds
it on the H100: at the xLSTM site (Q = 256, P = N = 1024) the operations
(42.9 GFLOP against 67 MB); this version reads the scores and C as
``mma.sync`` fragments from L2 and uses 64 of the 132 SMs at P = 1024.

On a CPU tensor :func:`repro_torch.kernels.ops.chunk_scan` takes
:func:`chunk_scan_plain`; on a CUDA tensor it launches the kernel or
raises.  ``launches`` counts kernel calls (both passes are one call) and
nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul import TileError

Q_MAX = 1024        # largest chunk: its cumsum lives in shared memory
N_MAX = 1024        # largest state width: 16 accumulator tiles a warp
TILE = 64           # edge of a scores tile; the scratch pitch is Q rounded
                    # up to it
MAX_GROUPS = 65535  # the scan grid's y dimension

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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
    from repro_torch.kernels.ops import chunk_tiles_legal
    global launches
    if not all(t.dtype == torch.bfloat16 for t in (x, Bm, Cm)):
        raise TypeError(f"K3 takes bfloat16 x, B and C, got {x.dtype}/"
                        f"{Bm.dtype}/{Cm.dtype}")
    if x.dim() != 3 or Bm.shape != Cm.shape or Bm.dim() != 3 \
            or Bm.shape[:2] != x.shape[:2] or tuple(la.shape) != x.shape[:2]:
        raise ValueError(f"K3 needs x (G,S,P), B and C (G,S,N), la (G,S); "
                         f"got {tuple(x.shape)} {tuple(Bm.shape)} "
                         f"{tuple(Cm.shape)} {tuple(la.shape)}")
    if not all(t.is_cuda and t.device == x.device for t in (Bm, Cm, la)):
        raise ValueError("K3 needs x, B, C and la on one CUDA device")
    G, S, P = x.shape
    N = Bm.shape[-1]
    Q = effective_chunk(S, chunk)
    if not chunk_tiles_legal(S, P, N, chunk):
        raise TileError(f"chunk {chunk} cannot launch at S={S} P={P} N={N} "
                        f"(ops.tile_ok)")
    if G > MAX_GROUPS:
        raise ValueError(f"K3 takes at most {MAX_GROUPS} groups, got {G}")
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    la = la.float().contiguous()
    qp = -(-Q // TILE) * TILE
    scores = torch.empty((G * S, qp), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((G, S, P), dtype=x.dtype, device=x.device)
    rc = _lib()(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), la.data_ptr(),
                scores.data_ptr(), y.data_ptr(), G, S, P, N, Q,
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "chunk-scan kernel")
    launches += 1
    return y
