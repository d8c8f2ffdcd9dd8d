"""Site-aware compute wrappers — the injection point for the paper's
technique (the port of ``repro/models/compute.py``).

Every tunable hot op goes through :func:`matmul` / :func:`flash_attention`
(or :func:`einsum`, which records a matmul site and never runs a kernel)
with a *site* label.  Modes:

* ``eager``  — plain PyTorch ops (the default; the reference's ``xla``).
* ``kernel`` — route through ``repro_torch.kernels.ops`` with tile factors
  from the active ``TileProgram`` (the reference's ``pallas``).  Missing
  sites take the heuristic baseline tiles.
* recording — a :class:`SiteRecorder` is installed; running a step function
  on ``meta`` tensors registers every site with its shapes and dtypes (the
  paper's loop extractor).  Recording never reaches a kernel wrapper.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.site import KernelSite, SiteRecorder  # noqa: F401

MODES = ("eager", "kernel")
NEG_INF = -1e30


@dataclass
class _ComputeState:
    mode: str = "eager"
    tiles: Optional[dict] = None       # site key -> tile tuple
    recorder: Optional["SiteRecorder"] = None


_STATE = _ComputeState()


@contextlib.contextmanager
def compute_mode(mode: str = "eager", tiles: Optional[dict] = None,
                 recorder: Optional["SiteRecorder"] = None):
    global _STATE
    if mode not in MODES:
        raise ValueError(f"compute mode {mode!r} not in {MODES}")
    prev = _STATE
    _STATE = _ComputeState(mode=mode, tiles=tiles, recorder=recorder)
    try:
        yield _STATE
    finally:
        _STATE = prev


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as the JAX package writes it in site keys
    (``torch.bfloat16`` -> ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def _tiles_for(st: _ComputeState, site: KernelSite):
    return None if st.tiles is None else st.tiles.get(site.key())


def matmul(x: torch.Tensor, w: torch.Tensor, *, site: str,
           fused_ops: int = 0) -> torch.Tensor:
    """``x @ w`` where x is (..., K) and w is (K, N)."""
    *lead, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"{site}: {tuple(x.shape)} @ {tuple(w.shape)}")
    M = int(math.prod(lead)) if lead else 1
    st = _STATE
    ksite = KernelSite(site=site, kind="matmul", m=M, n=int(N), k=int(K),
                       dtype=dtype_name(x.dtype), fused_ops=fused_ops)
    if st.recorder is not None:
        st.recorder.record(ksite)
    if st.mode == "kernel" and x.device.type != "meta":
        from repro_torch.kernels import ops
        y = ops.matmul(x.reshape(M, K), w, tiles=_tiles_for(st, ksite))
        return y.reshape(*lead, N)
    return torch.matmul(x, w)


def einsum(spec: str, *args: torch.Tensor, site: str) -> torch.Tensor:
    """Non-canonical contractions (per-head block-diagonal projections).
    Recorded as a matmul site with flattened dims, as the reference does;
    always run by ``torch.einsum``: the kernels only take the canonical
    (M,K) x (K,N) shape, and the reference's ``einsum`` runs XLA too."""
    out = torch.einsum(spec, *args)
    st = _STATE
    if st.recorder is not None:
        n = int(out.shape[-1])
        m = int(math.prod(out.shape[:-1])) if out.dim() > 1 else 1
        # contraction length from the (last) weight operand
        k = int(args[-1].shape[-2]) if args[-1].dim() >= 2 else 1
        st.recorder.record(KernelSite(site=site, kind="matmul", m=m, n=n,
                                      k=k, dtype=dtype_name(args[0].dtype)))
    return out


def record_chunk_scan(site: str, *, chunk: int, P: int, N: int,
                      batch: int, dtype: torch.dtype) -> None:
    """Record a chunk-scan site when a recorder is installed (the scan
    itself stays plain PyTorch, as the reference keeps it in XLA)."""
    st = _STATE
    if st.recorder is not None:
        st.recorder.record(KernelSite(site=site, kind="chunk_scan", m=chunk,
                                      n=P, k=N, batch=batch,
                                      dtype=dtype_name(dtype)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    site: str, causal: bool, q_chunk: int = 1024,
                    kv_chunk: int = 2048, scale: Optional[float] = None,
                    base_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA).
    ``base_offset``: absolute position of q[0] (causal decode masking).

    ``kernel`` mode routes prefill (Sq > 1) to K2 with the tuned
    (block_q, block_kv); decode (Sq == 1) and ``eager`` mode run plain
    PyTorch, as the reference's ``xla`` branch does."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    if Hq % Hkv:
        raise ValueError(f"{site}: Hq={Hq} not a multiple of Hkv={Hkv}")
    st = _STATE
    ksite = KernelSite(site=site, kind="attention", m=Sq, n=D, k=Skv,
                       batch=B * Hq, dtype=dtype_name(q.dtype), causal=causal)
    if st.recorder is not None:
        st.recorder.record(ksite)
    if scale is None:
        scale = 1.0 / math.sqrt(D)

    if st.mode == "kernel" and Sq > 1 and q.device.type != "meta":
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                   tiles=_tiles_for(st, ksite))

    if Sq == 1:
        group = Hq // Hkv
        qf = q.reshape(B, Hkv, group, Sq, D)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k).float() * scale
        if causal:
            kpos = torch.arange(Skv, device=q.device)
            qpos = base_offset + torch.arange(Sq, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
        return o.reshape(B, Hq, Sq, Dv)

    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"{site}: chunks must divide Sq={Sq}, Skv={Skv}")
    return _mem_efficient_attention(q, k, v, causal=causal, scale=scale,
                                    bq=q_chunk, bkv=kv_chunk)


def _mem_efficient_attention(q, k, v, *, causal, scale, bq, bkv):
    """Forward of the reference's ``_mem_efficient_attention``: the flash
    algorithm over (bq, bkv) chunks, in the reference's op order."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    Dv = v.shape[-1]
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    for i0 in range(0, Sq, bq):
        qi = q[:, :, i0:i0 + bq]
        q_pos = i0 + torch.arange(bq, device=q.device) + (Skv - Sq)
        m = torch.full((B, H, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, H, bq), device=q.device)
        acc = torch.zeros((B, H, bq, Dv), device=q.device)
        for j0 in range(0, Skv, bkv):
            kj, vj = k[:, :, j0:j0 + bkv], v[:, :, j0:j0 + bkv]
            s = (qi @ kj.transpose(-1, -2)).float() * scale
            if causal:
                k_pos = j0 + torch.arange(bkv, device=q.device)
                s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(vj.dtype) @ vj).float()
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, :, i0:i0 + bq] = (acc / l[..., None]).to(q.dtype)
    return out
