"""Per-BlockDesc init/apply: one period slot = mixer + optional MLP (the
port of ``repro/models/blocks.py``): an attention (MLA where
``cfg.mla``), Mamba (SSD) or xLSTM ``mlstm``/``slstm`` mixer, then a
dense MLP (gated SiLU or plain GELU as ``cfg.act`` says), an MoE MLP or
none."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.models import attention, mla, moe, ssm, xlstm
from repro_torch.models.common import apply_mlp, apply_norm, mlp_init, norm_init


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


def block_apply(cfg: ModelConfig, b: BlockDesc, p, x, *, positions,
                causal: bool = True, cache: Optional[dict] = None,
                decode_pos: Optional[int] = None):
    """``(x, aux)``: the block's output and, for an MoE MLP, its
    ``{"lb_loss", "router_z"}`` (``None`` otherwise); ``cache`` (views
    into the stacked cache) is updated in place."""
    h = apply_norm(p["norm1"], x)
    if b.kind == "attn":
        attn = mla.apply_mla if cfg.mla else attention.apply_attn
        y = attn(cfg, p["mixer"], h, positions=positions, causal=causal,
                 cache=cache, decode_pos=decode_pos)
    elif b.kind == "mamba":
        y = ssm.apply_ssm(cfg, p["mixer"], h, cache=cache,
                          decode_pos=decode_pos)
    elif b.kind == "mlstm":
        y = xlstm.apply_mlstm(cfg, p["mixer"], h, cache=cache,
                              decode_pos=decode_pos, chunk=cfg.ssm_chunk)
    elif b.kind == "slstm":
        y = xlstm.apply_slstm(cfg, p["mixer"], h, cache=cache,
                              decode_pos=decode_pos)
    else:
        raise ValueError(b.kind)
    x = x + y
    aux = None
    if b.mlp == "moe":
        y, aux = moe.apply_moe(cfg, p["mlp"], apply_norm(p["norm2"], x))
        x = x + y
    elif b.mlp != "none":
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(p["norm2"], x))
    return x, aux
