"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434; the port
of ``repro/models/mla.py``).

Prefill and train use the expanded form: ``k_nope`` and ``v`` are
expanded per head from the compressed latent ``c_kv`` (``w_uk``,
``w_uv``), q and k are the concatenations of their no-RoPE and RoPE
parts (head dim ``qk_nope_dim + qk_rope_dim``, 192 at full width), v
keeps ``v_head_dim`` (128), and ``compute.flash_attention`` (site
``mla.core``) runs them: in kernel mode K2 at D = 192 with a value dim of
its own.  Decode uses the *absorbed* form: the cache holds only the
latent ``c_kv`` (``kv_lora_rank``) and the shared RoPE key
(``qk_rope_dim``) of each position, 576 numbers a token at full width;
``w_uk`` is absorbed into q, the scores run against the latent, and
``w_uv`` is applied after the weighted sum, in plain ``torch.einsum``, as
the reference leaves it to XLA.  The four projections go through
``compute.matmul`` at the reference's site names.

The cache (``c_kv`` (B, ctx, r), ``k_rope`` (B, 1, ctx, dr)) is written
IN PLACE, as ``models/attention.py`` writes its k/v: prefill fills the
first S positions, decode position ``decode_pos``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import compute
from repro_torch.models.common import apply_rope, dense_init


def mla_init(cfg: ModelConfig, draw, dtype, device):
    """The latent down-projection (``wkv_a``: ``c_kv`` and the RoPE key),
    its norm, the per-head up-projections ``w_uk``/``w_uv``, the output
    ``wo`` and the query path: ``wq_a``, ``q_norm``, ``wq_b`` with a query
    latent (``q_lora_rank``), else one ``wq``."""
    d, h = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {"wkv_a": dense_init(draw, (d, r_kv + dr), dtype, device),
         "kv_norm": torch.ones((r_kv,), dtype=dtype, device=device),
         "w_uk": dense_init(draw, (r_kv, h, dn), dtype, device),
         "w_uv": dense_init(draw, (r_kv, h, dv), dtype, device),
         "wo": dense_init(draw, (h * dv, d), dtype, device)}
    if r_q:
        p["wq_a"] = dense_init(draw, (d, r_q), dtype, device)
        p["q_norm"] = torch.ones((r_q,), dtype=dtype, device=device)
        p["wq_b"] = dense_init(draw, (r_q, h * (dn + dr)), dtype, device)
    else:
        p["wq"] = dense_init(draw, (d, h * (dn + dr)), dtype, device)
    return p


def _rmsn(x, scale):
    """RMSNorm of a latent in f32, cast back (eps 1e-6)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


def _q_heads(cfg: ModelConfig, p, x, positions):
    """``(q_nope, q_rope)``, each (B, h, S, ·), RoPE on the second."""
    B, S, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = _rmsn(compute.matmul(x, p["wq_a"], site="mla.q_down"),
                   p["q_norm"])
        q = compute.matmul(cq, p["wq_b"], site="mla.q_up")
    else:
        q = compute.matmul(x, p["wq"], site="mla.q")
    q = q.reshape(B, S, h, dn + dr).transpose(1, 2)          # (B,h,S,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta, "1d")


def _latent(cfg: ModelConfig, p, x, positions):
    """``(c_kv, k_rope)``: the normed latent (B, S, r) and the shared RoPE
    key (B, 1, S, dr)."""
    r_kv = cfg.kv_lora_rank
    kv = compute.matmul(x, p["wkv_a"], site="mla.kv_down")  # (B,S,r+dr)
    c_kv = _rmsn(kv[..., :r_kv], p["kv_norm"])
    k_rope = kv[..., None, r_kv:].transpose(1, 2)            # (B,1,S,dr)
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta, "1d")


def apply_mla(cfg: ModelConfig, p, x, *, positions, causal: bool,
              cache: Optional[dict] = None,
              decode_pos: Optional[int] = None):
    """MLA over ``x`` (B, S, d).  ``cache`` (views of the stacked cache)
    is written in place; with ``decode_pos`` the step attends over the
    whole cache in the absorbed form, masked to positions <=
    ``decode_pos``."""
    B, S, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _q_heads(cfg, p, x, positions)
    c_kv, k_rope = _latent(cfg, p, x, positions)
    if cache is not None:
        start = 0 if decode_pos is None else decode_pos
        cache["c_kv"][:, start:start + S] = c_kv
        cache["k_rope"][:, :, start:start + S] = k_rope

    if decode_pos is not None:
        # ----- absorbed decode: scores against the latent -----
        c_all, kr_all = cache["c_kv"], cache["k_rope"]
        q_lat = torch.einsum("bhsd,rhd->bhsr", q_nope, p["w_uk"])
        s = (torch.einsum("bhsr,bTr->bhsT", q_lat, c_all)
             + torch.einsum("bhsd,bxTd->bhsT", q_rope, kr_all))
        s = s.float() * (dn + dr) ** -0.5
        pos = torch.arange(c_all.shape[1], device=x.device)
        s = s.masked_fill(pos > decode_pos, float("-inf"))
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhsT,bTr->bhsr", pr, c_all)
        o = torch.einsum("bhsr,rhd->bhsd", ctx_lat, p["w_uv"])  # (B,h,S,dv)
    else:
        # ----- expanded train / prefill: K2 at D = dn + dr, Dv = dv -----
        k_nope = torch.einsum("bsr,rhd->bhsd", c_kv, p["w_uk"])
        v = torch.einsum("bsr,rhd->bhsd", c_kv, p["w_uv"])
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(B, h, S, dr)], dim=-1)
        o = compute.flash_attention(q, k, v, site="mla.core", causal=causal)
    o = o.transpose(1, 2).reshape(B, S, h * dv)
    return compute.matmul(o, p["wo"], site="mla.o")


def make_mla_cache(cfg: ModelConfig, batch: int, ctx: int, dtype, device):
    return {"c_kv": torch.zeros((batch, ctx, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, 1, ctx, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}
