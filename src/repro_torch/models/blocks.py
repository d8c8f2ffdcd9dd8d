"""Per-BlockDesc init/apply: one period slot = mixer + MLP (the port of
``repro/models/blocks.py``; only the dense attention block, which
``lm.build_model`` checks for)."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.models import attention
from repro_torch.models.common import apply_mlp, apply_norm, mlp_init, norm_init


def block_init(cfg: ModelConfig, b: BlockDesc, gen, dtype, device):
    return {"norm1": norm_init(cfg.d_model, dtype, device),
            "mixer": attention.attn_init(cfg, gen, dtype, device),
            "norm2": norm_init(cfg.d_model, dtype, device),
            "mlp": mlp_init(cfg, gen, dtype, device)}


def block_cache(cfg: ModelConfig, b: BlockDesc, batch: int, ctx: int, dtype,
                device):
    return attention.make_attn_cache(cfg, batch, ctx, dtype, device)


def block_apply(cfg: ModelConfig, b: BlockDesc, p, x, *, positions,
                causal: bool = True, cache: Optional[dict] = None,
                decode_pos: Optional[int] = None):
    h = apply_norm(p["norm1"], x)
    x = x + attention.apply_attn(cfg, p["mixer"], h, positions=positions,
                                 causal=causal, cache=cache,
                                 decode_pos=decode_pos)
    return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x))
