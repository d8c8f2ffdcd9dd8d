"""Shared layers: RMSNorm and LayerNorm, RoPE (1-D, GLM's 2-D, none), the
gated SiLU and the plain GELU MLP, and init helpers (the port of
``repro/models/common.py`` for the paths ``lm.build_model`` admits).
Parameters are plain dicts of tensors.

Random weights come from :class:`WeightDraw`, a counter-based draw: each
element is a pure function of ``(seed, leaf, element index)`` computed
with exact integer ops and one table lookup on the target device, so one
seed gives the same weights, bit for bit, on the CPU and on the card.
They do not repeat ``jax.random``'s stream (tests carry the reference's
weights across with ``repro_torch.convert``)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.models import compute


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15        # splitmix64's increment and multipliers
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
NORMAL_BITS = 20                    # the table of normal quantiles: 2^20
DRAW_CHUNK = 1 << 24                # elements drawn at a time (int64
                                    # temporaries of 128 MB)
_TABLES: dict = {}                  # device -> the quantile table on it


def _signed(c: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _mix64(z: int) -> int:
    """splitmix64's finaliser on a Python int (the exact reference for
    :func:`_mix64_`)."""
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return z ^ (z >> 31)


def _mix64_(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors, in place: products wrap
    modulo 2^64 and every right shift is masked (``>>`` on int64 is
    arithmetic), so the bits equal :func:`_mix64`'s on every device."""
    z ^= (z >> 30) & ((1 << 34) - 1)
    z *= _signed(_MIX1)
    z ^= (z >> 27) & ((1 << 37) - 1)
    z *= _signed(_MIX2)
    z ^= (z >> 31) & ((1 << 33) - 1)
    return z


def _normal_table(device) -> torch.Tensor:
    """The f32 normal quantiles at the midpoints of 2^NORMAL_BITS equal
    bins, computed once in f64 on the CPU and copied to ``device``."""
    device = torch.device(device)
    if device not in _TABLES:
        n = 1 << NORMAL_BITS
        u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
        _TABLES[device] = torch.special.ndtri(u).float().to(device)
    return _TABLES[device]


class WeightDraw:
    """Normal(0, 1) draws that are the same on every device.  Element
    ``i`` of the ``leaf``-th leaf drawn is the table's entry at the top
    ``NORMAL_BITS`` bits of ``mix64(key + i * golden)``, ``key`` a mix of
    ``(seed, leaf)``: integer ops and a gather, exact on the CPU and on
    the card, run on the target device in chunks of ``DRAW_CHUNK``."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.leaf = 0

    def normal(self, shape, scale: float, dtype, device) -> torch.Tensor:
        """The next leaf: ``normal * scale`` in f32 (one IEEE product),
        cast to ``dtype``."""
        key = _signed(_mix64((self.seed * _GOLDEN + _mix64(self.leaf))
                             & _MASK64))
        self.leaf += 1
        table = _normal_table(device)
        scale_t = torch.tensor(scale, dtype=torch.float32, device=device)
        n = math.prod(shape)
        out = torch.empty(n, dtype=dtype, device=device)
        for s in range(0, n, DRAW_CHUNK):
            z = torch.arange(s, min(n, s + DRAW_CHUNK), dtype=torch.int64,
                             device=device)
            z *= _signed(_GOLDEN)
            z += key
            idx = (_mix64_(z) >> (64 - NORMAL_BITS)) & (
                (1 << NORMAL_BITS) - 1)
            out[s:s + len(z)] = (table[idx] * scale_t).to(dtype)
        return out.reshape(shape)


def dense_init(draw, shape, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * scale in f32, cast to ``dtype``; fan-in scaling by
    default.  ``draw``: the model's :class:`WeightDraw`; ``None`` (the
    ``meta`` device) allocates shapes only."""
    if draw is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    return draw.normal(tuple(shape), scale, dtype, device)


def norm_init(d: int, dtype, device, bias: bool = False):
    """RMSNorm's scale, plus LayerNorm's bias when ``bias``
    (``cfg.norm == "layernorm"``)."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _rows(x):
    """``x`` with only its batch dim sharded, under sharding hints."""
    return compute.constrain(x, lambda dp, tp: P(
        dp if x.shape[0] > 1 else None, *[None] * (x.ndim - 1)))


def apply_norm(p, x):
    """In f32, cast back, as the reference does: LayerNorm (eps 1e-5) when
    the parameters carry a bias, else RMSNorm (eps 1e-6).  A DTensor
    ``x`` has its feature dim gathered first (batch kept over DP), so the
    statistics are whole rows."""
    x = _rows(x)
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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mode: str = "1d") -> torch.Tensor:
    """x: (B, H, S, D); positions: (S,).  ``"1d"`` rotates all D dims,
    ``"2d"`` (GLM) the first D/2 and passes the rest through, ``"none"``
    returns ``x``.  Interleaved pairs: dims [0::2] rotate with [1::2] (not
    HF's rotate_half), as in the reference."""
    if mode == "none":
        return x
    D = x.shape[-1]
    rot_dim = D // 2 if mode == "2d" else D
    freqs = rope_freqs(rot_dim, theta, x.device)
    ang = positions[:, None].float() * freqs[None, :]        # (S, rd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    rot = rot.reshape(*x.shape[:-1], rot_dim).to(x.dtype)
    if rot_dim == D:
        return rot
    return torch.cat([rot, x[..., rot_dim:]], dim=-1)


def mlp_init(cfg: ModelConfig, draw, dtype, device):
    """The gated SiLU MLP (``wi``, ``wg``, ``wo``) for ``act="silu"``,
    else the plain one (``wi``, ``wo``)."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(draw, (d, f), dtype, device)}
    if cfg.act == "silu":
        p["wg"] = dense_init(draw, (d, f), dtype, device)
    p["wo"] = dense_init(draw, (f, d), dtype, device)
    return p


def apply_mlp(cfg: ModelConfig, p, x):
    if cfg.act == "silu":
        h = (F.silu(compute.matmul(x, p["wg"], site="mlp.gate", fused_ops=1))
             * compute.matmul(x, p["wi"], site="mlp.up"))
    else:
        h = gelu(compute.matmul(x, p["wi"], site="mlp.up", fused_ops=1))
    return compute.matmul(h, p["wo"], site="mlp.down")
