"""Mamba mixer in the SSD (state-space dual, Mamba-2) formulation (the
port of ``repro/models/ssm.py``).

Prefill runs the chunkwise-parallel algorithm over chunks of
``cfg.ssm_chunk`` positions: the intra-chunk terms are batched products
over one chunk's ``(B, Q, Q, h)`` decay-masked scores, and the ``(B, h,
P, N)`` state is carried from chunk to chunk in a Python loop (the
reference's ``lax.scan``), so the decay mask exists for one chunk at a
time.  A sequence that is not a multiple of the chunk is zero-padded
with ``dt = 0``: identity steps that leave the carried state as it is.
Decode is the O(1) recurrence.  The scan stays plain PyTorch, as the
reference keeps it in XLA; it only records its ``ssm.chunk_scan`` site,
whose kernel (K3) the measured oracle times.  The projections go through
``compute.matmul`` (``ssm.in_proj``, ``ssm.out_proj``).

The cache, ``{"conv": (B, W-1, di+2n), "ssd": (B, h, P, N) f32}``, holds
views into the model's stacked cache and is written IN PLACE (the
reference returns a fresh one).  On ``meta`` tensors (site extraction)
the scan computes nothing: its site is recorded and its output made
empty.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import compute
from repro_torch.models.common import dense_init


def ssm_init(cfg: ModelConfig, draw, dtype, device):
    d = cfg.d_model
    di, n, h = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.n_ssm_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z(di) | x(di) | B(n) | C(n) | dt(h)]
        "in_proj": dense_init(draw, (d, 2 * di + 2 * n + h), dtype, device),
        "conv": dense_init(draw, (cfg.ssm_conv_width, di + 2 * n), dtype,
                           device, scale=0.5),
        "A_log": torch.zeros((h,), **f32),
        "D": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(draw, (di, d), dtype, device),
    }


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv.  x (B,S,C), w (W,C); ``conv_state``
    (B,W-1,C), when given, goes before x.  Returns (y, the last W-1 rows
    of the padded input: the next conv state)."""
    W = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], W - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)                     # (B,S+W-1,C)
    y = xp[:, 0:x.shape[1]] * w[0][None, None]
    for i in range(1, W):
        y = y + xp[:, i:i + x.shape[1]] * w[i][None, None]
    return y, xp[:, xp.shape[1] - (W - 1):]


def _project(cfg: ModelConfig, p, x):
    di, n, h = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.n_ssm_heads
    zxbcdt = compute.matmul(x, p["in_proj"], site="ssm.in_proj")
    return (zxbcdt[..., :di], zxbcdt[..., di:di + di + 2 * n],
            zxbcdt[..., zxbcdt.shape[-1] - h:])


def _split_xbc(cfg, xbc):
    di, n = cfg.d_inner_ssm, cfg.ssm_state_dim
    return xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]


def _chunk_scan(xh, Bc, Cc, dtc, A, state):
    """The chunkwise scan of ``repro/models/ssm.py:127-154`` in f32.  xh
    (B,nc,Q,h,P), Bc/Cc (B,nc,Q,N), dtc (B,nc,Q,h), A (h,), state
    (B,h,P,N).  Returns (y (B,nc,Q,h,P), the final state)."""
    Q = xh.shape[2]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))[None, :, :, None]
    ys = []
    for c in range(xh.shape[1]):
        xc, bc, cc, dc = xh[:, c], Bc[:, c], Cc[:, c], dtc[:, c]
        cum = torch.cumsum(dc * A[None, None], dim=1)           # (B,Q,h)
        # the mask goes in before exp: the same values as the reference's
        # where(causal, exp(L), 0), without its NaN gradient where the
        # masked exp overflows
        Lm = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~causal, float("-inf")).exp()                       # (B,Q,Q,h)
        cb = torch.einsum("biN,bjN->bij", cc, bc)               # (B,Q,Q)
        xdt = xc * dc[..., None]                                # (B,Q,h,P)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * Lm, xdt)
        y_inter = torch.einsum("bih,biN,bhpN->bihp", torch.exp(cum), cc,
                               state)
        seg = torch.exp(cum[:, -1:, :] - cum)                   # (B,Q,h)
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjh,bjN,bjhp->bhpN", seg, bc, xdt))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1), state


def apply_ssm(cfg: ModelConfig, p, x, *, cache: Optional[dict] = None,
              decode_pos: Optional[int] = None):
    """x (B,S,d) -> y (B,S,d); ``cache`` is updated in place."""
    B, S, _ = x.shape
    di, N, h = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    A = -torch.exp(p["A_log"])                                  # (h,) < 0

    z, xbc, dt_raw = _project(cfg, p, x)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (B,S,h)

    if cache is not None and decode_pos is not None and S == 1:
        # ---------- O(1) decode recurrence ----------
        xbc_c, conv_state = _causal_conv(xbc, p["conv"], cache["conv"])
        xs, Bm, Cm = _split_xbc(cfg, F.silu(xbc_c))
        xh = xs.reshape(B, 1, h, P)[:, 0].float()               # (B,h,P)
        a = torch.exp(dt[:, 0] * A[None])                       # (B,h)
        dBx = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh,
                           Bm[:, 0].float())
        state = cache["ssd"] * a[..., None, None] + dBx         # (B,h,P,N)
        y = torch.einsum("bhpn,bn->bhp", state, Cm[:, 0].float())
        y = y + p["D"][None, :, None] * xh
        cache["conv"].copy_(conv_state)
        cache["ssd"].copy_(state)
        return _gated_out(p, y.reshape(B, 1, di).to(x.dtype), z)

    # ---------- chunkwise-parallel train / prefill ----------
    compute.record_chunk_scan("ssm.chunk_scan", chunk=cfg.ssm_chunk, P=P,
                              N=N, batch=B * h * (S // max(1,
                                                           cfg.ssm_chunk)),
                              dtype=x.dtype)
    xbc_c, conv_state = _causal_conv(xbc, p["conv"])
    if x.device.type == "meta":
        return _gated_out(p, torch.empty((B, S, di), dtype=x.dtype,
                                         device=x.device), z)
    xs, Bm, Cm = _split_xbc(cfg, F.silu(xbc_c))
    Q = min(cfg.ssm_chunk, S)
    Sp = -(-S // Q) * Q
    if Sp != S:
        # dt = 0 past the end: decay exp(0) = 1 and no input, steps that
        # leave the carried state untouched
        xs, Bm, Cm, dt = (F.pad(t, (0, 0, 0, Sp - S)) for t in
                          (xs, Bm, Cm, dt))
    nc = Sp // Q
    xh = xs.reshape(B, nc, Q, h, P).float()
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, h)
    init = (cache["ssd"].float() if cache is not None else
            torch.zeros((B, h, P, N), dtype=torch.float32, device=x.device))
    y, final = _chunk_scan(xh, Bc, Cc, dtc, A, init)
    y = y + p["D"][None, None, None, :, None] * xh
    y = y.reshape(B, Sp, di)[:, :S].to(x.dtype)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssd"].copy_(final)
    return _gated_out(p, y, z)


def _gated_out(p, y, z):
    y = y * F.silu(z)
    yf = y.float()
    yf = yf * torch.rsqrt((yf ** 2).mean(-1, keepdim=True) + 1e-6)
    y = (yf * p["norm"].float()).to(y.dtype)
    return compute.matmul(y, p["out_proj"], site="ssm.out_proj")


def make_ssm_cache(cfg: ModelConfig, batch: int, dtype, device):
    di, N, h = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.n_ssm_heads
    P, W = cfg.ssm_head_dim, cfg.ssm_conv_width
    return {"conv": torch.zeros((batch, W - 1, di + 2 * N), dtype=dtype,
                                device=device),
            "ssd": torch.zeros((batch, h, P, N), dtype=torch.float32,
                               device=device)}
