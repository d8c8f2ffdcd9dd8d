"""Token-choice top-k MoE with GShard-style capacity dispatch (the port of
``repro/models/moe.py``).

The router runs in f32 through ``compute.matmul`` (site ``moe.router``:
on the card K1's ``f32`` variant).  Each token picks its top-k experts
by softmax probability, its gates renormalised over the k; an expert
takes at most ``C`` tokens (:func:`_capacity`), slot 0 of every token
before slot 1 (slot-major priority, as GShard), and a token past the
capacity of its expert is dropped from that slot.  Dispatch and combine
are index gathers through the ``(E, C)`` inverse maps; autograd gives
them the gradients of the reference's custom VJPs, which exist there only
so that GSPMD partitions the backward as gathers.  The expert products
are ``torch.einsum`` over the stacked ``(E, d, f)`` weights, as the
reference leaves them to XLA; the shared experts go through
``compute.matmul``.  One card has no mesh, so the reference's
``compute.constrain`` hints have no counterpart.

Every shape depends on the config and the token count alone (``C`` is
static, no ``.item()``), so the layer runs on ``meta`` tensors for site
extraction.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import compute
from repro_torch.models.common import dense_init

CAPACITY_FACTOR = 1.25


def moe_init(cfg: ModelConfig, draw, dtype, device):
    """The f32 router, the stacked expert weights and the shared experts'
    (``n_shared_experts`` of them, as one MLP ``n_shared_experts`` times
    as wide)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {"router": dense_init(draw, (d, e), torch.float32, device),
         "ewi": dense_init(draw, (e, d, f), dtype, device),
         "ewg": dense_init(draw, (e, d, f), dtype, device),
         "ewo": dense_init(draw, (e, f, d), dtype, device)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = dense_init(draw, (d, fs), dtype, device)
        p["shared_wg"] = dense_init(draw, (d, fs), dtype, device)
        p["shared_wo"] = dense_init(draw, (fs, d), dtype, device)
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int) -> int:
    c = int(n_tokens * top_k * CAPACITY_FACTOR / n_experts)
    return max(8, -(-c // 8) * 8)   # multiple of 8, >= 8


def route(cfg: ModelConfig, logits: torch.Tensor):
    """Top-k routing with capacity from the router's f32 logits (T, E):
    ``(eidx, pos_tk, keep_tk, w, idx, aux)``: each token's k experts
    (T, K), its position in each expert's buffer and whether it is kept
    there, its combine weights (the renormalised gates, zero where
    dropped), the ``(E, C)`` map from buffer slot to token (-1 where
    empty), and the load-balance and z losses."""
    T, E = logits.shape
    K = cfg.moe_top_k
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1, sorted=True)      # (T,K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load balance and router z-loss
    me = probs.mean(0)                                          # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=logits.device)
    ce = ce.index_add(0, eidx.reshape(-1), torch.full(
        (eidx.numel(),), 1.0 / (T * K), device=logits.device))
    aux = {"lb_loss": E * torch.sum(me * ce),
           "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}

    # capacity, slot-major: slot 0 of every token, then slot 1, ...
    C = _capacity(T, E, K)
    a_e = eidx.T.reshape(-1)                                    # (K*T,)
    onehot = (a_e[:, None] == torch.arange(E, device=logits.device)).int()
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1    # (K*T,)
    keep = pos < C
    tok = torch.arange(T, device=logits.device).repeat(K)
    # the (E, C) inverse map; dropped entries land in a spare column C
    pc = torch.where(keep, pos, torch.full_like(pos, C))
    idx = torch.full((E, C + 1), -1, dtype=torch.long, device=logits.device)
    idx = idx.index_put((a_e, pc), tok)[:, :C]
    pos_tk = pos.reshape(K, T).T                                # (T,K)
    keep_tk = keep.reshape(K, T).T
    w = gate * keep_tk.float()
    return eidx, pos_tk, keep_tk, w, idx, aux


def apply_moe(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux), aux = {"lb_loss", "router_z"}."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = compute.matmul(xt.float(), p["router"], site="moe.router")
    eidx, pos_tk, _, w, idx, aux = route(cfg, logits)
    C = idx.shape[1]

    # dispatch: (T, d) -> (E, C, d), empty slots zero
    valid = (idx >= 0)[..., None]
    buf = torch.where(valid, xt[idx.clamp(0, T - 1)],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    h = torch.einsum("ecd,edf->ecf", buf, p["ewi"])
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["ewg"]))
    y_flat = torch.einsum("ecf,efd->ecd", h * g, p["ewo"]).reshape(-1, d)

    # combine: each token's k buffer rows, weighted in f32
    y = None
    for k in range(cfg.moe_top_k):
        flat = eidx[:, k] * C + pos_tk[:, k].clamp(0, C - 1)
        y_k = y_flat[flat].float() * w[:, k:k + 1]
        y = y_k if y is None else y + y_k

    if cfg.n_shared_experts:
        hs = (F.silu(compute.matmul(xt, p["shared_wg"],
                                    site="moe.shared_gate", fused_ops=1))
              * compute.matmul(xt, p["shared_wi"], site="moe.shared_up"))
        y = y + compute.matmul(hs, p["shared_wo"],
                               site="moe.shared_down").float()
    return y.to(x.dtype).reshape(B, S, d), aux
