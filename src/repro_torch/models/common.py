"""Shared layers: RMSNorm and LayerNorm, RoPE, the gated SiLU MLP, GELU
and init helpers (the port of ``repro/models/common.py`` for the paths
``lm.build_model`` admits).  Parameters are plain dicts of tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import compute


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale in f32, cast to ``dtype``; fan-in scaling by
    default.  ``gen=None`` (the ``meta`` device) allocates shapes only."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def norm_init(d: int, dtype, device, bias: bool = False):
    """RMSNorm's scale, plus LayerNorm's bias when ``bias``
    (``cfg.norm == "layernorm"``)."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x):
    """In f32, cast back, as the reference does: LayerNorm (eps 1e-5) when
    the parameters carry a bias, else RMSNorm (eps 1e-6)."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * p["scale"].float()).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def log_sigmoid(x):
    """``-softplus(-x)``, as the reference writes it."""
    return -F.softplus(-x)


def rms_head_norm(x, scale):
    """qk-norm: rmsnorm over the head dim, in f32."""
    xf = x.float()
    var = (xf ** 2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """1-D RoPE over all D dims.  x: (B, H, S, D); positions: (S,).
    Interleaved pairs: dims [0::2] rotate with [1::2] (not HF's
    rotate_half), as in the reference."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[:, None].float() * freqs[None, :]        # (S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.reshape(x.shape).to(x.dtype)


def mlp_init(cfg: ModelConfig, gen, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": dense_init(gen, (d, f), dtype, device),
            "wg": dense_init(gen, (d, f), dtype, device),
            "wo": dense_init(gen, (f, d), dtype, device)}


def apply_mlp(p, x):
    h = (F.silu(compute.matmul(x, p["wg"], site="mlp.gate", fused_ops=1))
         * compute.matmul(x, p["wi"], site="mlp.up"))
    return compute.matmul(h, p["wo"], site="mlp.down")
