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
from repro_torch.obs import trace

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


# ---------------------------------------------------------------------------
# Activation-sharding hints.  Model code is mesh-agnostic; the launcher
# installs logical axis names (a dp tuple, a tp name) and hot activations
# are redistributed to the builder's spec.  Without hints, or on a plain
# tensor, every constraint is a no-op.
# ---------------------------------------------------------------------------

_HINTS: dict = {"active": False, "dp": None, "tp": None, "carry_tp": True}


@contextlib.contextmanager
def sharding_hints(dp, tp, carry_tp: bool = True):
    prev = dict(_HINTS)
    _HINTS.update(active=True, dp=dp, tp=tp, carry_tp=carry_tp)
    try:
        yield
    finally:
        _HINTS.update(prev)


def _dtensor_cls():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return _HINTS["active"] and isinstance(x, _dtensor_cls())


def hint_placements(x, builder) -> list:
    """The placements of ``builder(dp, tp)`` on ``x``'s mesh, any axis
    that does not divide its dim dropped."""
    from repro_torch.distributed import sharding
    mesh = x.device_mesh
    spec = sharding._fit_spec(builder(_HINTS["dp"], _HINTS["tp"]), x.shape,
                              mesh)
    return sharding.placements(mesh, spec)


def tp_size(x) -> int:
    """The size of the hints' tp axis on DTensor ``x``'s mesh."""
    mesh = x.device_mesh
    return mesh.size(list(mesh.mesh_dim_names).index(_HINTS["tp"]))


def sharded_dims(placements, tensor_dim: int) -> list:
    """The mesh dims whose placement shards ``tensor_dim``."""
    return [md for md, q in enumerate(placements)
            if getattr(q, "dim", None) == tensor_dim]


def shard_block(mesh, placements, tensor_dim: int) -> tuple:
    """``(index, count)`` of this rank's block of ``tensor_dim`` over the
    mesh dims that shard it, in mesh order (``(0, 1)`` where none does)."""
    i, n = 0, 1
    for md in sharded_dims(placements, tensor_dim):
        i = i * mesh.size(md) + mesh.get_local_rank(md)
        n *= mesh.size(md)
    return i, n


def partial_on(placements, dims) -> list:
    """``placements`` with the mesh ``dims`` turned ``Partial``: a partial
    sum's placement, or the gradient of an input that each rank along
    those dims uses only in part."""
    from torch.distributed.tensor import Partial
    return [Partial() if md in dims else q
            for md, q in enumerate(placements)]


def local_rows(table, index, n_rows_before):
    """``table[index - n_rows_before]`` where the index falls in the
    table's rows, zero elsewhere: a lookup into one shard of a larger
    table (the partial sums of a vocab-sharded gather)."""
    hit = (index >= n_rows_before) & (index < n_rows_before + table.shape[0])
    rows = table[(index - n_rows_before).clamp(0, table.shape[0] - 1)]
    hit = hit.reshape(hit.shape + (1,) * (rows.ndim - hit.ndim))
    return torch.where(hit, rows, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))


def constrain(x, builder):
    """``builder(dp, tp) -> PartitionSpec``; ``x`` redistributed to it
    when hints are active and ``x`` is a DTensor, else ``x`` as it is."""
    if not is_dtensor(x):
        return x
    pl = hint_placements(x, builder)
    return x if list(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as the JAX package writes it in site keys
    (``torch.bfloat16`` -> ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def _tiles_for(st: _ComputeState, site: KernelSite):
    return None if st.tiles is None else st.tiles.get(site.key())


def _site_span(tr, st: _ComputeState, site: KernelSite, kernel: bool):
    """The ``nv.site`` span of one call: the site's key, the tile it
    runs at (``None``: the baseline's) and its path."""
    return tr.span("nv.site", site=site.key(),
                   tile=_tiles_for(st, site) if kernel else None,
                   path="kernel" if kernel else "eager")


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
    kernel = st.mode == "kernel" and x.device.type != "meta"
    tr = trace.active()
    with _site_span(tr, st, ksite, kernel) if tr.enabled else trace.NO_SPAN:
        if kernel:
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
    kernel = st.mode == "kernel" and Sq > 1 and q.device.type != "meta"
    tr = trace.active()
    with _site_span(tr, st, ksite, kernel) if tr.enabled else trace.NO_SPAN:
        if kernel:
            from repro_torch.kernels import ops
            return ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                       tiles=_tiles_for(st, ksite))

        if is_dtensor(q) and Sq > 1:
            return _sharded_attention(q, k, v, causal=causal, scale=scale,
                                      bq=min(q_chunk, Sq),
                                      bkv=min(kv_chunk, Skv))

        if Sq == 1:
            if is_dtensor(q):
                return _sharded_decode_attention(q, k, v, causal=causal,
                                                 scale=scale,
                                                 base_offset=base_offset)
            return _decode_attention(q, k, v, causal=causal, scale=scale,
                                     base_offset=base_offset)

        if Hq != Hkv:
            k = k.repeat_interleave(Hq // Hkv, dim=1)
            v = v.repeat_interleave(Hq // Hkv, dim=1)
        q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
        if Sq % q_chunk or Skv % kv_chunk:
            raise ValueError(f"{site}: chunks must divide Sq={Sq}, "
                             f"Skv={Skv}")
        return _mem_efficient_attention(q, k, v, causal=causal, scale=scale,
                                        bq=q_chunk, bkv=kv_chunk)


def _decode_attention(q, k, v, *, causal, scale, base_offset):
    """One query position against the whole cache (the reference's
    decode branch): q (B, Hq, 1, D) over GQA groups of k/v (B, Hkv, S, D)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k).float() * scale
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = base_offset + torch.arange(Sq, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return o.reshape(B, Hq, Sq, v.shape[-1])


def _sharded_decode_attention(q, k, v, *, causal, scale, base_offset):
    """``_decode_attention`` on DTensors: where whole kv groups fall on
    each TP rank, on each rank's local heads (``local_map``, the cache's
    heads over TP as its spec places them); else with the heads
    replicated, through DTensor's own rules."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import P
    B, Hkv = q.shape[0], k.shape[1]
    whole = Hkv % tp_size(q) == 0
    hspec = lambda dp, tp: P(dp if B > 1 else None, tp if whole else None,
                             None, None)
    q = constrain(q, hspec)
    if not whole:
        return _decode_attention(q, k, v, causal=causal, scale=scale,
                                 base_offset=base_offset)
    k, v = constrain(k, hspec), constrain(v, hspec)
    pl = list(q.placements)
    return local_map(
        lambda ql, kl, vl: _decode_attention(
            ql, kl, vl, causal=causal, scale=scale, base_offset=base_offset),
        out_placements=pl, in_placements=(pl, pl, pl),
        device_mesh=q.device_mesh)(q, k, v)


def _sharded_attention(q, k, v, *, causal, scale, bq, bkv):
    """Megatron-style TP attention on DTensors, as the reference's hints
    place it: GQA groups expanded so that heads shard over the tp axis,
    batch over dp, then :func:`_mem_efficient_attention` on each rank's
    local heads (``local_map``: the ``Function`` has no sharding rule)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed.sharding import P
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    if q.shape[2] % bq or k.shape[2] % bkv:
        raise ValueError(f"chunks must divide Sq={q.shape[2]}, "
                         f"Skv={k.shape[2]}")
    if Hq != Hkv:
        # the kv heads replicated over tp, then each repeated ``group``
        # times in place (repeat_interleave's order) by views
        rep = lambda dp, tp: P(dp if B > 1 else None, None, None, None)
        g = Hq // Hkv

        def expand(t):
            t = constrain(t, rep)
            return t[:, :, None].expand(B, Hkv, g, *t.shape[2:]).reshape(
                B, Hq, *t.shape[2:])
        k, v = expand(k), expand(v)
    hspec = lambda dp, tp: P(dp if B > 1 else None, tp, None, None)
    q, k, v = (constrain(t, hspec) for t in (q, k, v))
    pl = list(q.placements)

    def local(ql, kl, vl):
        return _mem_efficient_attention(ql, kl, vl, causal=causal,
                                        scale=scale, bq=bq, bkv=bkv)
    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def _mem_efficient_attention(q, k, v, *, causal, scale, bq, bkv):
    """The reference's ``_mem_efficient_attention``: the flash algorithm
    over (bq, bkv) chunks, whose backward saves only ``(q, k, v, o, lse)``
    and recomputes each probability block (an autograd ``Function``, as
    the reference's is a ``jax.custom_vjp``)."""
    return _MemEfficientAttention.apply(q, k, v, causal, scale, bq, bkv)


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """f32 accumulators, as the reference's; f64 for f64 inputs (gradcheck)."""
    return torch.promote_types(q.dtype, torch.float32)


def _mea_fwd(q, k, v, causal, scale, bq, bkv):
    """Forward of the reference's ``_mea_fwd_impl`` in its op order:
    ``(o, lse)``, ``lse`` (B, H, Sq) in the accumulators' dtype."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    Dv = v.shape[-1]
    f = dict(dtype=_acc_dtype(q), device=q.device)
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), **f)
    for i0 in range(0, Sq, bq):
        qi = q[:, :, i0:i0 + bq]
        # bottom-right aligned causal offset, as the reference's
        q_pos = i0 + torch.arange(bq, device=q.device) + (Skv - Sq)
        m = torch.full((B, H, bq), NEG_INF, **f)
        l = torch.zeros((B, H, bq), **f)
        acc = torch.zeros((B, H, bq, Dv), **f)
        for j0 in range(0, Skv, bkv):
            kj, vj = k[:, :, j0:j0 + bkv], v[:, :, j0:j0 + bkv]
            s = (qi @ kj.transpose(-1, -2)).to(f["dtype"]) * scale
            if causal:
                k_pos = j0 + torch.arange(bkv, device=q.device)
                s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(vj.dtype) @ vj).to(f["dtype"])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        out[:, :, i0:i0 + bq] = (acc / l[..., None]).to(q.dtype)
        lse[:, :, i0:i0 + bq] = m + torch.log(l)
    return out, lse


def _mea_bwd(q, k, v, o, lse, do, causal, scale, bq, bkv):
    """The reference's ``_mea_bwd`` in its op order: ``delta = sum(do·o)``,
    then for each kv block the q blocks in turn, each probability block
    recomputed as ``exp(s - lse)``; ``dq``, ``dk`` and ``dv`` accumulate
    in f32 and are cast back to their inputs' dtypes."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    Dv = v.shape[-1]
    acc = _acc_dtype(q)
    f = dict(dtype=acc, device=q.device)
    delta = (do.to(acc) * o.to(acc)).sum(-1)                    # (B,H,Sq)
    dq = torch.zeros((B, H, Sq, D), **f)
    dk = torch.empty((B, H, Skv, D), **f)
    dv = torch.empty((B, H, Skv, Dv), **f)
    for j0 in range(0, Skv, bkv):
        kj, vj = k[:, :, j0:j0 + bkv], v[:, :, j0:j0 + bkv]
        kjf, vjf = kj.to(acc), vj.to(acc)
        k_pos = j0 + torch.arange(bkv, device=q.device)
        dkj = torch.zeros((B, H, bkv, D), **f)
        dvj = torch.zeros((B, H, bkv, Dv), **f)
        for i0 in range(0, Sq, bq):
            qi = q[:, :, i0:i0 + bq]
            doi = do[:, :, i0:i0 + bq].to(acc)
            q_pos = i0 + torch.arange(bq, device=q.device) + (Skv - Sq)
            s = (qi @ kj.transpose(-1, -2)).to(acc) * scale
            if causal:
                s = s.masked_fill(k_pos[None, :] > q_pos[:, None], NEG_INF)
            p = torch.exp(s - lse[:, :, i0:i0 + bq, None])      # (B,H,bq,bkv)
            dvj = dvj + p.transpose(-1, -2) @ doi
            dp = doi @ vjf.transpose(-1, -2)
            ds = p * (dp - delta[:, :, i0:i0 + bq, None]) * scale
            dkj = dkj + ds.transpose(-1, -2) @ qi.to(acc)
            dq[:, :, i0:i0 + bq] += ds @ kjf
        dk[:, :, j0:j0 + bkv] = dkj
        dv[:, :, j0:j0 + bkv] = dvj
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _MemEfficientAttention(torch.autograd.Function):
    """``o`` of :func:`_mea_fwd`; saves ``(q, k, v, o, lse)`` and nothing
    else, so no (bq, bkv) block outlives the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bq, bkv):
        o, lse = _mea_fwd(q, k, v, causal, scale, bq, bkv)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, bq, bkv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _mea_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None
