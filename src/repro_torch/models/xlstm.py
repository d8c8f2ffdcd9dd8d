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
and after them.  Under the dry-run's op counter (fake tensors) the sLSTM's
loop over time runs as a batched body plus what the loop counts beyond it
(:func:`_slstm_counted`).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import op_analysis
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
    if S > 1 and op_analysis.counting_active(wx):
        hs, st = _slstm_counted(cfg, p, wx, st)
    else:
        hs, st = _slstm_stepwise(cfg, p["r"], p["b"], wx, st)   # (B,S,d)
    _write(cache, dict(zip(("h", "c", "n", "m"), st)))
    return _slstm_out(cfg, p, hs.to(x.dtype))


class _Uncounted(torch.autograd.Function):
    """Identity on R that adds to the op counter the bytes the stepwise
    loop moves beyond the batched body, ``fwd`` in the forward and
    ``bwd`` in the backward, and holds ``held`` bytes (what the loop
    saves for the backward beyond what the body saves) as one fake
    buffer until the backward."""

    @staticmethod
    def forward(ctx, r, fwd: int, bwd: int, held: int):
        op_analysis.add_bytes(fwd)
        ctx.bwd = bwd
        ctx.save_for_backward(r.new_empty((max(held, 0),),
                                          dtype=torch.uint8))
        return r.view_as(r)

    @staticmethod
    def backward(ctx, g):
        op_analysis.add_bytes(ctx.bwd)
        return g, None, None, None


def _slstm_batched(cfg, r, b, wx, state):
    """The S steps of :func:`_slstm_cell` as one body over the time axis,
    for the op counter only: fake tensors carry no values, so only
    shapes, dtypes and what autograd saves matter.  Step 0 takes the
    initial state; steps 1..S-1 take stand-ins of the carried state cut
    from ``wx`` (they need a gradient wherever the carried state would).
    So the recurrent product runs as two products whose 2·M·N·K sum to S
    steps' in the forward and in the backward, and the gates run
    elementwise on (B, S, d).  -> ((B,S,d) h, the final state)."""
    B, S, _, d = wx.shape
    nh = cfg.n_heads
    c0, n0, m0 = (torch.cat([s[:, None], wx[:, 1:, g]], dim=1)
                  for g, s in enumerate(state) if g)          # (B,S,d)
    rec0 = torch.einsum("ghde,bhd->gbhe", r,
                        state[0].reshape(B, nh, d // nh))
    rest = torch.einsum("ghde,bshd->gbshe", r,
                        wx[:, 1:, 0].reshape(B, S - 1, nh, d // nh))
    rec = torch.cat([rec0[:, :, None], rest], dim=2).reshape(4, B, S, d)
    pre = wx.movedim(2, 0) + rec + b.reshape(4, 1, 1, d)
    it, ft, zt, ot = pre[0], pre[1], pre[2], pre[3]
    lf = log_sigmoid(ft)
    m1 = torch.maximum(lf + m0, it)
    ig = torch.exp(it - m1)
    fg = torch.exp(lf + m0 - m1)
    c1 = fg * c0 + ig * torch.tanh(zt)
    n1 = fg * n0 + ig
    h1 = torch.sigmoid(ot) * c1 / torch.clamp(n1, min=1e-6)
    return h1, tuple(t[:, -1] for t in (h1, c1, n1, m1))


def _slstm_stepwise(cfg, r, b, wx, state):
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(cfg, {"r": r, "b": b}, wx[:, t], state)
        hs.append(state[0])
    return torch.stack(hs, dim=1), state


def _slstm_blocked(cfg, r, b, wx, state):
    """:func:`_slstm_batched` over blocks of :data:`COUNT_BLOCK` steps,
    the state carried from block to block: a few dispatches a block, and
    no temporary larger than a block's."""
    hs = []
    for part in wx.split(COUNT_BLOCK, dim=1):
        h, state = (_slstm_batched if part.shape[1] > 1
                    else _slstm_stepwise)(cfg, r, b, part, state)
        hs.append(h)
    return torch.cat(hs, dim=1), state


COUNT_BLOCK = 512                # steps the counted body takes at once
_PROBE_STEPS = (3, 4, 5)
_PROBES: dict = {}


def _probe(cfg, body, n, wx, leaves, state):
    """(forward bytes, backward bytes, bytes held between them) of
    ``body`` over ``n`` steps on fresh fake tensors shaped like the
    call's, counted and then taken back out of the counter."""
    counter = op_analysis.active_counter()
    snap = counter.snapshot()
    like = lambda t: t.new_empty(t.shape).requires_grad_(t.requires_grad)
    B, _, g, d = wx.shape
    x = wx.new_empty((B, n, g * d)).requires_grad_(wx.requires_grad)
    r, b = (like(t) for t in leaves)
    st = tuple(t.new_empty(t.shape) for t in state)
    ins = [t for t in (x, r, b) if t.requires_grad]
    live0, bytes0 = counter.live_bytes, counter.bytes
    # (B, n, 4, d) as apply_slstm shapes it, so that the gradient meets
    # the same reshape
    hs, last = body(cfg, r, b, x.reshape(B, n, g, d), st)
    fwd, held = counter.bytes - bytes0, counter.live_bytes - live0
    bwd = 0
    if ins and hs.requires_grad:
        dh = torch.empty_like(hs)
        bytes1 = counter.bytes
        torch.autograd.grad(hs, ins, dh)
        bwd = counter.bytes - bytes1
        del dh
    del hs, last, ins, x, r, b, st
    counter.restore(snap)
    return fwd, bwd, held


def _probed(cfg, body, n, wx, leaves, state):
    key = (body.__name__, n, tuple(wx.shape[:1] + wx.shape[2:]), wx.dtype,
           cfg.n_heads, torch.is_grad_enabled(), wx.requires_grad,
           tuple((t.dtype, t.requires_grad) for t in leaves),
           tuple(t.dtype for t in state), COUNT_BLOCK)
    if key not in _PROBES:
        # saved tensors kept as they are, whatever hooks the caller runs
        # under (a checkpointed forward drops them)
        with torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                      lambda t: t):
            _PROBES[key] = _probe(cfg, body, n, wx, leaves, state)
    return _PROBES[key]


def _stepwise_extra(cfg, p, wx, state):
    """What the stepwise loop counts beyond :func:`_slstm_blocked` at
    this call's S, as (forward bytes, backward bytes, held bytes).  The
    loop is counted at 3, 4 and 5 steps on fake tensors of the call's
    other shapes and extended to S as the polynomial of degree 2 in S
    that it is (each step's backward writes a gradient the size of
    ``wx``); the blocked body is counted at S itself.  Kept per shape,
    dtype and gradient setting."""
    S = wx.shape[1]
    leaves = (p["r"], p["b"])
    pts = [_probed(cfg, _slstm_stepwise, n, wx, leaves, state)
           for n in _PROBE_STEPS]
    body = _probed(cfg, _slstm_blocked, S, wx, leaves, state)
    out = []
    for j in range(3):           # Lagrange through the three probes, exact
        v = Fraction(0)
        for i, ni in enumerate(_PROBE_STEPS):
            w = Fraction(pts[i][j])
            for k, nk in enumerate(_PROBE_STEPS):
                if k != i:
                    w *= Fraction(S - nk, ni - nk)
            v += w
        out.append(int(v) - body[j])
    return out


def _slstm_counted(cfg, p, wx, state):
    """The sLSTM under the op counter (``op_analysis.counting_active``;
    see that module's docstring): :func:`_slstm_blocked`, plus the bytes
    and the saved storage by which the stepwise loop exceeds it."""
    fwd, bwd, held = _stepwise_extra(cfg, p, wx, state)
    r = _Uncounted.apply(p["r"], fwd, bwd, held)
    return _slstm_blocked(cfg, r, p["b"], wx, state)


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
