"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, a true recurrence), both with
stabilised exponential gating; the port of ``repro/models/xlstm.py``.

The mLSTM prefill runs the chunkwise-parallel form over chunks of
``cfg.ssm_chunk`` positions, carrying the matrix state C (hd x hd), the
normaliser n and the stabiliser m, in plain PyTorch: the reference keeps
this scan in XLA, and only records its ``mlstm.chunk_scan`` site (whose
kernel, K3, the measured oracle times).  Decode is the O(1) recurrence.
sLSTM runs a Python loop over time with per-head block-diagonal recurrent
weights.

Caches are views into the model's stacked cache and are written IN PLACE
(the reference returns fresh ones).  On ``meta`` tensors (site
extraction) the recurrences compute nothing: the sites are recorded before
and after them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import compute
from repro_torch.models.common import dense_init, gelu, log_sigmoid

NEG = -1e30


def _write(cache: Optional[dict], new: dict) -> None:
    if cache is not None:
        for k, v in new.items():
            cache[k].copy_(v)


# ===========================================================================
# mLSTM
# ===========================================================================

def _mlstm_dims(cfg: ModelConfig):
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_init(cfg: ModelConfig, draw, dtype, device):
    d = cfg.d_model
    di, h, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "up": dense_init(draw, (d, 2 * di), dtype, device),
        "wq": dense_init(draw, (h, hd, hd), dtype, device),
        "wk": dense_init(draw, (h, hd, hd), dtype, device),
        "wv": dense_init(draw, (h, hd, hd), dtype, device),
        "w_i": dense_init(draw, (di, h), f32, device, scale=0.01),
        "w_f": dense_init(draw, (di, h), f32, device, scale=0.01),
        "b_f": torch.full((h,), 3.0, dtype=f32, device=device),
        "gn": torch.ones((di,), dtype=dtype, device=device),
        "down": dense_init(draw, (di, d), dtype, device),
    }


def _mlstm_qkv(cfg, p, xi):
    """xi (B,S,di) -> q, k, v (B,S,h,hd) via per-head block-diagonal
    projections."""
    B, S, di = xi.shape
    h = cfg.n_heads
    hd = di // h
    xh = xi.reshape(B, S, h, hd)
    q = compute.einsum("bshd,hde->bshe", xh, p["wq"], site="mlstm.q")
    k = compute.einsum("bshd,hde->bshe", xh, p["wk"], site="mlstm.k")
    v = compute.einsum("bshd,hde->bshe", xh, p["wv"], site="mlstm.v")
    return q, k * (1.0 / (hd ** 0.5)), v


def _mlstm_chunkwise(q, k, v, li, lf, init, Q: int):
    """The chunkwise-parallel scan of ``repro/models/xlstm.py:108-170``, in
    f32.  q/k/v (B,Sp,h,hd), li/lf (B,Sp,h), Sp a multiple of Q."""
    B, Sp, h, hd = q.shape
    nc = Sp // Q
    C0, n0, m0 = init
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        qi, ki, vi = (t[:, sl].float() for t in (q, k, v))
        lii, lfi = li[:, sl], lf[:, sl]
        b = torch.cumsum(lfi, dim=1)                            # (B,Q,h)
        D = b[:, :, None] - b[:, None, :, :] + lii[:, None]     # (B,Q,Q,h)
        D = D.masked_fill(~causal, float("-inf"))
        m_row = torch.maximum(D.amax(dim=2), b + m0[:, None])   # (B,Q,h)
        W = torch.exp(D - m_row[:, :, None])
        sc = torch.einsum("bqhd,bkhd->bqkh", qi, ki) * W
        inter = torch.exp(b + m0[:, None] - m_row)              # (B,Q,h)
        num = (torch.einsum("bqkh,bkhd->bqhd", sc, vi)
               + inter[..., None] * torch.einsum("bqhd,bhde->bqhe", qi, C0))
        den = sc.sum(dim=2) + inter * torch.einsum("bqhd,bhd->bqh", qi, n0)
        ys.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_row))[..., None])
        # state update to the chunk's end
        g = b[:, -1]                                            # (B,h)
        dec_j = g[:, None] - b + lii                            # (B,Q,h)
        m1 = torch.maximum(g + m0, dec_j.amax(dim=1))
        wj = torch.exp(dec_j - m1[:, None])
        keep = torch.exp(g + m0 - m1)
        C0 = (keep[..., None, None] * C0
              + torch.einsum("bqhd,bqhe->bhde", wj[..., None] * ki, vi))
        n0 = keep[..., None] * n0 + torch.einsum("bqh,bqhd->bhd", wj, ki)
        m0 = m1
    return torch.cat(ys, dim=1), (C0, n0, m0)


def apply_mlstm(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None,
                decode_pos: Optional[int] = None, chunk: int = 256):
    """x (B,S,d).  Cache: {"C": (B,h,hd,hd), "n": (B,h,hd), "m": (B,h)},
    all f32, updated in place."""
    B, S, d = x.shape
    di, h, hd = _mlstm_dims(cfg)
    up = compute.matmul(x, p["up"], site="mlstm.up")
    xi, z = up[..., :di], up[..., di:]
    q, k, v = _mlstm_qkv(cfg, p, xi)
    xif = xi.float()
    li = torch.einsum("bsd,dh->bsh", xif, p["w_i"])
    lf = log_sigmoid(torch.einsum("bsd,dh->bsh", xif, p["w_f"]) + p["b_f"])

    if cache is not None and decode_pos is not None and S == 1:
        # ---------- O(1) decode ----------
        C0, n0, m0 = cache["C"], cache["n"], cache["m"]
        lf0, li0 = lf[:, 0], li[:, 0]                           # (B,h)
        m1 = torch.maximum(lf0 + m0, li0)
        fg = torch.exp(lf0 + m0 - m1)[..., None, None]
        ig = torch.exp(li0 - m1)[..., None, None]
        kf, vf, qf = (t[:, 0].float() for t in (k, v, q))       # (B,h,hd)
        C1 = fg * C0 + ig * kf[..., :, None] * vf[..., None, :]
        n1 = fg[..., 0] * n0 + ig[..., 0] * kf
        num = torch.einsum("bhd,bhde->bhe", qf, C1)
        den = torch.einsum("bhd,bhd->bh", qf, n1).abs()
        y = num / torch.maximum(den, torch.exp(-m1))[..., None]
        _write(cache, {"C": C1, "n": n1, "m": m1})
        return _mlstm_out(cfg, p, y.reshape(B, 1, di).to(x.dtype), z)

    # ---------- chunkwise-parallel ----------
    Q = min(chunk, S)
    compute.record_chunk_scan("mlstm.chunk_scan", chunk=Q, P=hd, N=hd,
                              batch=B * h * (S // max(1, Q)), dtype=x.dtype)
    if x.device.type == "meta":
        y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
        return _mlstm_out(cfg, p, y.to(x.dtype), z)
    Sp = -(-S // Q) * Q
    if Sp != S:
        # identity padding: i-gate -inf (no write), f-gate log-decay 0
        pad = (0, 0, 0, 0, 0, Sp - S)
        q, k, v = (F.pad(t, pad) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, Sp - S), value=NEG)
        lf = F.pad(lf, (0, 0, 0, Sp - S))
    if cache is not None:
        init = (cache["C"], cache["n"], cache["m"])
    else:
        f32 = dict(dtype=torch.float32, device=x.device)
        init = (torch.zeros((B, h, hd, hd), **f32),
                torch.zeros((B, h, hd), **f32),
                torch.full((B, h), NEG, **f32))
    y, (C1, n1, m1) = _mlstm_chunkwise(q, k, v, li, lf, init, Q)
    _write(cache, {"C": C1, "n": n1, "m": m1})
    y = y.reshape(B, Sp, di)[:, :S]
    return _mlstm_out(cfg, p, y.to(x.dtype), z)


def _mlstm_out(cfg, p, y, z):
    B, S, di = y.shape
    h = cfg.n_heads
    yf = y.float().reshape(B, S, h, di // h)
    yf = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + 1e-6)
    y = (yf.reshape(B, S, di) * p["gn"].float()).to(y.dtype)
    y = y * F.silu(z)
    return compute.matmul(y, p["down"], site="mlstm.down")


def make_mlstm_cache(cfg: ModelConfig, batch: int, device):
    di, h, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), NEG, **f32)}


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_init(cfg: ModelConfig, draw, dtype, device):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    f = -(-(4 * d // 3) // 128) * 128    # GLU hidden, padded to 128
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": dense_init(draw, (d, 4 * d), dtype, device),    # i,f,z,o input
        "r": dense_init(draw, (4, h, hd, hd), torch.float32, device,
                        scale=0.02),
        "b": torch.cat([torch.zeros((d,), **f32),
                        torch.full((d,), 3.0, **f32),
                        torch.zeros((2 * d,), **f32)]),
        "mlp_up": dense_init(draw, (d, 2 * f), dtype, device),
        "mlp_down": dense_init(draw, (f, d), dtype, device),
        "gn": torch.ones((d,), dtype=dtype, device=device),
    }


def _slstm_cell(cfg, p, wx_t, state):
    """One recurrence step.  wx_t (B,4,d) f32; state (h, c, n, m), each
    (B,d) f32."""
    B = wx_t.shape[0]
    d = cfg.d_model
    nh = cfg.n_heads
    hprev, c0, n0, m0 = state
    hh = hprev.reshape(B, nh, d // nh)
    rec = torch.einsum("ghde,bhd->gbhe", p["r"], hh).reshape(4, B, d)
    pre = wx_t.transpose(0, 1) + rec + p["b"].reshape(4, 1, d)
    it, ft, zt, ot = pre[0], pre[1], pre[2], pre[3]
    lf = log_sigmoid(ft)
    m1 = torch.maximum(lf + m0, it)
    ig = torch.exp(it - m1)
    fg = torch.exp(lf + m0 - m1)
    c1 = fg * c0 + ig * torch.tanh(zt)
    n1 = fg * n0 + ig
    h1 = torch.sigmoid(ot) * c1 / torch.clamp(n1, min=1e-6)
    return (h1, c1, n1, m1)


def apply_slstm(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None,
                decode_pos: Optional[int] = None):
    """x (B,S,d).  Cache: {"h","c","n","m"}, each (B,d) f32, updated in
    place."""
    B, S, d = x.shape
    wx = compute.matmul(x, p["wx"], site="slstm.wx").float()
    wx = wx.reshape(B, S, 4, d)
    if x.device.type == "meta":
        return _slstm_out(cfg, p, torch.empty_like(x))
    if cache is not None:
        st = (cache["h"], cache["c"], cache["n"], cache["m"])
    else:
        zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        st = (zero, zero, zero, torch.full_like(zero, NEG))
    hs = []
    for t in range(S):
        st = _slstm_cell(cfg, p, wx[:, t], st)
        hs.append(st[0])
    _write(cache, dict(zip(("h", "c", "n", "m"), st)))
    y = torch.stack(hs, dim=1).to(x.dtype)                   # (B,S,d)
    return _slstm_out(cfg, p, y)


def _slstm_out(cfg, p, y):
    yf = y.float()
    yf = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["gn"].float()).to(y.dtype)
    up = compute.matmul(y, p["mlp_up"], site="slstm.mlp_up")
    f = up.shape[-1] // 2
    return compute.matmul(gelu(up[..., :f]) * up[..., f:], p["mlp_down"],
                          site="slstm.mlp_down")


def make_slstm_cache(cfg: ModelConfig, batch: int, device):
    z = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, cfg.d_model), **z),
            "c": torch.zeros((batch, cfg.d_model), **z),
            "n": torch.zeros((batch, cfg.d_model), **z),
            "m": torch.full((batch, cfg.d_model), NEG, **z)}
