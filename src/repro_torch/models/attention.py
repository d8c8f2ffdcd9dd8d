"""GQA self-attention with RoPE (1-D, 2-D or none), qk-norm and a KV
cache, and the encoder-decoder's cross-attention (the port of
``repro/models/attention.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.models import compute
from repro_torch.models.common import (apply_rope, dense_init,
                                       rms_head_norm)


def attn_init(cfg: ModelConfig, draw, dtype, device, cross: bool = False):
    """q, k, v and o projections; qk-norm scales unless ``cross``."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(draw, (d, hq * hd), dtype, device),
         "wk": dense_init(draw, (d, hkv * hd), dtype, device),
         "wv": dense_init(draw, (d, hkv * hd), dtype, device),
         "wo": dense_init(draw, (hq * hd, d), dtype, device)}
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _split_heads(x, n_heads, hd):
    B, S, _ = x.shape
    if compute.is_dtensor(x):
        # features over TP only where whole heads fall on each rank
        whole = n_heads % compute.tp_size(x) == 0
        x = compute.constrain(x, lambda dp, tp: P(
            dp if B > 1 else None, None, tp if whole else None))
    return x.reshape(B, S, n_heads, hd).transpose(1, 2)    # (B,H,S,hd)


def _merge_heads(x):
    B, H, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, H * hd)


def apply_attn(cfg: ModelConfig, p, x, *, positions, causal: bool,
               cache: Optional[dict] = None, decode_pos: Optional[int] = None,
               site_prefix: str = "attn"):
    """Self-attention.  ``cache`` holds (B, Hkv, ctx, hd) k/v views of the
    stacked cache and is written IN PLACE (the reference returns a fresh
    cache; the port saves the copy): prefill writes the fresh k/v into the
    first S slots and attends over them; decode writes slot ``decode_pos``
    and attends over the whole cache, masked to positions <= decode_pos."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(compute.matmul(x, p["wq"], site=f"{site_prefix}.q"),
                     hq, hd)
    k = _split_heads(compute.matmul(x, p["wk"], site=f"{site_prefix}.k"),
                     hkv, hd)
    v = _split_heads(compute.matmul(x, p["wv"], site=f"{site_prefix}.v"),
                     hkv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope)

    base_offset = 0
    if cache is not None:
        S = k.shape[2]
        start = 0 if decode_pos is None else decode_pos
        cache["k"][:, :, start:start + S] = k
        cache["v"][:, :, start:start + S] = v
        if decode_pos is not None:
            k, v = cache["k"], cache["v"]
            base_offset = decode_pos

    o = compute.flash_attention(q, k, v, site=f"{site_prefix}.core",
                                causal=causal, base_offset=base_offset)
    return compute.matmul(_merge_heads(o), p["wo"], site=f"{site_prefix}.o")


def apply_cross_attn(cfg: ModelConfig, p, x, *, memory=None,
                     mem_cache: Optional[dict] = None,
                     site_prefix: str = "xattn"):
    """Cross-attention: q from ``x``, k/v from the encoder's memory, never
    causal.  With ``memory`` (B, S_src, d) the k/v are computed from it
    and, given a ``mem_cache`` (prefill), also written into its first
    S_src slots IN PLACE; attention runs over the S_src computed keys.
    Without ``memory`` (decode) it runs over the whole of ``mem_cache``,
    as the reference's does: the slots past S_src hold zero keys and
    values and still take softmax weight."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(compute.matmul(x, p["wq"], site=f"{site_prefix}.q"),
                     hq, hd)
    if memory is not None:
        k = _split_heads(compute.matmul(memory, p["wk"],
                                        site=f"{site_prefix}.k"), hkv, hd)
        v = _split_heads(compute.matmul(memory, p["wv"],
                                        site=f"{site_prefix}.v"), hkv, hd)
        if mem_cache is not None:
            S = k.shape[2]
            mem_cache["k"][:, :, :S] = k
            mem_cache["v"][:, :, :S] = v
    else:
        k, v = mem_cache["k"], mem_cache["v"]
    o = compute.flash_attention(q, k, v, site=f"{site_prefix}.core",
                                causal=False)
    return compute.matmul(_merge_heads(o), p["wo"], site=f"{site_prefix}.o")


def make_attn_cache(cfg: ModelConfig, batch: int, ctx: int, dtype, device):
    shape = (batch, cfg.n_kv_heads, ctx, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
