"""Per-BlockDesc init/apply: one period slot = mixer + optional MLP (the
port of ``repro/models/blocks.py``): an attention (MLA where
``cfg.mla``), Mamba (SSD) or xLSTM ``mlstm``/``slstm`` mixer, then a
dense MLP (gated SiLU or plain GELU as ``cfg.act`` says), an MoE MLP or
none."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.distributed.sharding import P, flatten_with_path
from repro_torch.models import attention, compute, mla, moe, ssm, xlstm
from repro_torch.models.common import apply_mlp, apply_norm, mlp_init, norm_init
from repro_torch.obs import trace


def block_init(cfg: ModelConfig, b: BlockDesc, draw, dtype, device):
    ln = cfg.norm == "layernorm"
    p = {"norm1": norm_init(cfg.d_model, dtype, device, bias=ln)}
    if b.kind == "attn":
        p["mixer"] = (mla.mla_init(cfg, draw, dtype, device) if cfg.mla
                      else attention.attn_init(cfg, draw, dtype, device))
    elif b.kind == "mamba":
        p["mixer"] = ssm.ssm_init(cfg, draw, dtype, device)
    elif b.kind == "mlstm":
        p["mixer"] = xlstm.mlstm_init(cfg, draw, dtype, device)
    elif b.kind == "slstm":
        p["mixer"] = xlstm.slstm_init(cfg, draw, dtype, device)
    else:
        raise ValueError(b.kind)
    if b.mlp != "none":
        p["norm2"] = norm_init(cfg.d_model, dtype, device, bias=ln)
        p["mlp"] = (moe.moe_init(cfg, draw, dtype, device) if b.mlp == "moe"
                    else mlp_init(cfg, draw, dtype, device))
    return p


# the recurrent mixers: kind -> cfg -> (apply, extra keyword arguments)
_RECURRENT = {
    "mamba": lambda cfg: (ssm.apply_ssm, {}),
    "mlstm": lambda cfg: (xlstm.apply_mlstm, {"chunk": cfg.ssm_chunk}),
    "slstm": lambda cfg: (xlstm.apply_slstm, {}),
}


def block_cache(cfg: ModelConfig, b: BlockDesc, batch: int, ctx: int, dtype,
                device):
    if b.kind == "attn":
        if cfg.mla:
            return mla.make_mla_cache(cfg, batch, ctx, dtype, device)
        return attention.make_attn_cache(cfg, batch, ctx, dtype, device)
    if b.kind == "mamba":
        return ssm.make_ssm_cache(cfg, batch, dtype, device)
    if b.kind == "mlstm":
        return xlstm.make_mlstm_cache(cfg, batch, device)
    if b.kind == "slstm":
        return xlstm.make_slstm_cache(cfg, batch, device)
    raise ValueError(b.kind)


def _unflatten_like(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _data_parallel(fn, cfg, p, h, cache, **kw):
    """``fn(cfg, p, h, cache=cache, **kw)`` on DTensors under sharding
    hints, for the recurrent mixers (Mamba, mLSTM, sLSTM), whose chunked
    scans have no DTensor sharding rules: each rank runs ``fn`` on its
    batch rows (``local_map``), the mixer's weights gathered, the cache
    rows batch-sharded.  So these mixers are data-parallel only: their
    work is repeated on every TP rank (the reference shards it over TP)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = h.device_mesh
    rows = lambda dp, tp: P(dp if h.shape[0] > 1 else None)
    h = compute.constrain(h, rows)
    hpl = list(h.placements)
    rep = [Replicate()] * mesh.ndim
    pw = [x for _, x in flatten_with_path(p)]
    cw = [] if cache is None else [x for _, x in flatten_with_path(cache)]
    cpl = [compute.hint_placements(c, rows) if compute.is_dtensor(c)
           else None for c in cw]
    # each rank uses the gathered weights on its own rows only
    wgrad = compute.partial_on(rep, compute.sharded_dims(hpl, 0))

    def local(hl, *flat):
        pl = _unflatten_like(p, iter(flat[:len(pw)]))
        cl = None if cache is None else _unflatten_like(
            cache, iter(flat[len(pw):]))
        return fn(cfg, pl, hl, cache=cl, **kw)
    return local_map(local, out_placements=hpl,
                     in_placements=(hpl, *[rep] * len(pw), *cpl),
                     in_grad_placements=(hpl, *[wgrad] * len(pw), *cpl),
                     device_mesh=mesh, redistribute_inputs=True)(
        h, *pw, *cw)


def block_apply(cfg: ModelConfig, b: BlockDesc, p, x, *, positions,
                causal: bool = True, cache: Optional[dict] = None,
                decode_pos: Optional[int] = None):
    """``(x, aux)``: the block's output and, for an MoE MLP, its
    ``{"lb_loss", "router_z"}`` (``None`` otherwise); ``cache`` (views
    into the stacked cache) is updated in place.  Traced as the mixer's
    span (``nv.attn``, ``nv.mla``, ``nv.<recurrent kind>``) and the MLP's
    (``nv.mlp``, ``nv.moe``), each with its norm and residual add."""
    tr = trace.active()
    with tr.span(_mixer_span(cfg, b)) if tr.enabled else trace.NO_SPAN:
        h = apply_norm(p["norm1"], x)
        if b.kind == "attn":
            attn = mla.apply_mla if cfg.mla else attention.apply_attn
            y = attn(cfg, p["mixer"], h, positions=positions, causal=causal,
                     cache=cache, decode_pos=decode_pos)
        elif b.kind in _RECURRENT:
            fn, kw = _RECURRENT[b.kind](cfg)
            if compute.is_dtensor(h):
                y = _data_parallel(fn, cfg, p["mixer"], h, cache,
                                   decode_pos=decode_pos, **kw)
            else:
                y = fn(cfg, p["mixer"], h, cache=cache,
                       decode_pos=decode_pos, **kw)
        else:
            raise ValueError(b.kind)
        x = x + y
    aux = None
    if b.mlp == "none":
        return x, aux
    with tr.span("nv.moe" if b.mlp == "moe" else "nv.mlp") if tr.enabled \
            else trace.NO_SPAN:
        if b.mlp == "moe":
            y, aux = moe.apply_moe(cfg, p["mlp"], apply_norm(p["norm2"], x))
            x = x + y
        else:
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(p["norm2"], x))
    return x, aux


def _mixer_span(cfg: ModelConfig, b: BlockDesc) -> str:
    if b.kind == "attn":
        return "nv.mla" if cfg.mla else "nv.attn"
    return "nv." + b.kind
