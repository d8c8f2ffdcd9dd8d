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
``compute.matmul``.

Under sharding hints on DTensors (:func:`_sharded_moe`) the layer keeps
the reference's placements: tokens over DP, the ``(E, C)`` buffers over
(TP, DP), expert weights over TP with their FSDP axis gathered for the
product.  Routing is global, as on one card: each rank routes its own
tokens, the (T, K) expert choices are gathered, and the capacity
positions come from each TP rank's experts, summed over TP.

A choice's position in its expert's buffer is its rank among the
slot-major choices of that expert (:func:`_positions`): a stable sort of
the choices by expert, each one's sorted index less the start of its
expert's run (``searchsorted`` on the sorted ids), scattered back.  The
reference writes it as a cumsum of a ``(K*T, E)`` one-hot down the
token axis, which XLA runs as a parallel scan; PyTorch's CUDA scan along
an outer dimension walks the K*T rows in sequence, a thread a column, and
took as much device time as the expert products at DeepSeek-V2's 12288
choices of 160 experts.  The sort does work in proportion to K*T and
gives the same positions bit for bit.

Every shape depends on the config and the token count alone (``C`` is
static; no ``.item()``, ``nonzero``, ``bincount`` or ``unique``, so no
host sync), and the layer runs on ``meta`` tensors for site extraction.

On one card the layer's parts are traced as ``nv.moe.route``,
``nv.moe.dispatch``, ``nv.moe.combine`` and ``nv.moe.shared``, and, while
tracing is on, the token-choices kept count into the device counter
``moe.kept`` (of the ``E * C`` slots the expert products compute).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.models import compute
from repro_torch.models.common import dense_init
from repro_torch.obs import trace

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
    pos = _positions(eidx, E) - 1                               # (K*T,)
    pos_tk, keep_tk, idx = _slots(eidx, pos, E, C)
    w = gate * keep_tk.float()
    return eidx, pos_tk, keep_tk, w, idx, aux


def _slots(eidx: torch.Tensor, pos: torch.Tensor, E: int, C: int):
    """The capacity map from the experts' buffer positions ``pos`` (K*T,)
    of the slot-major choices ``eidx`` (T, K): ``(pos_tk, keep_tk, idx)``,
    idx the ``(E, C)`` map from buffer slot to token (-1 where empty)."""
    T, K = eidx.shape
    a_e = eidx.T.reshape(-1)                                    # (K*T,)
    keep = pos < C
    tok = torch.arange(T, device=eidx.device).repeat(K)
    # the (E, C) inverse map; dropped entries land in a spare column C
    pc = torch.where(keep, pos, torch.full_like(pos, C))
    idx = torch.full((E, C + 1), -1, dtype=torch.long, device=eidx.device)
    idx = idx.index_put((a_e, pc), tok)[:, :C]
    return pos.reshape(K, T).T, keep.reshape(K, T).T, idx


def _positions(eidx: torch.Tensor, E: int, e0: int = 0):
    """Each slot-major choice's position in its expert's buffer, counted
    over the experts ``[e0, e0 + E)`` (zero for the others), plus one.

    The position is the choice's rank among its expert's choices in
    slot-major order: the stable sort by expert keeps that order within
    each expert's run, and ``searchsorted`` of the sorted ids in
    themselves finds where each run starts.  The reference's one-hot
    cumsum gives the same numbers (the module's docstring says why it is
    not used here)."""
    a_e = eidx.T.reshape(-1)                                    # (K*T,)
    ids, order = torch.sort(a_e, stable=True)
    pos = (torch.arange(1, a_e.numel() + 1, device=a_e.device)
           - torch.searchsorted(ids, ids))          # rank in the run, + 1
    pos = torch.empty_like(pos).scatter_(0, order, pos)
    return torch.where((a_e >= e0) & (a_e < e0 + E), pos, 0)


def apply_moe(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux), aux = {"lb_loss", "router_z"}."""
    if compute.is_dtensor(x):
        return _sharded_moe(cfg, p, x)
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    logits = compute.matmul(xt.float(), p["router"], site="moe.router")
    tr = trace.active()
    with tr.span("nv.moe.route") if tr.enabled else trace.NO_SPAN:
        eidx, pos_tk, keep_tk, w, idx, aux = route(cfg, logits)
    if tr.enabled:              # the token-choices kept, of E * C slots
        tr.count("moe.kept", keep_tk.sum())
    C = idx.shape[1]

    # dispatch: (T, d) -> (E, C, d), empty slots zero
    with tr.span("nv.moe.dispatch") if tr.enabled else trace.NO_SPAN:
        valid = (idx >= 0)[..., None]
        buf = torch.where(valid, xt[idx.clamp(0, T - 1)],
                          torch.zeros((), dtype=x.dtype, device=x.device))
        h = torch.einsum("ecd,edf->ecf", buf, p["ewi"])
        g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["ewg"]))
        y_flat = torch.einsum("ecf,efd->ecd", h * g, p["ewo"]).reshape(-1, d)

    # combine: each token's k buffer rows, weighted in f32
    with tr.span("nv.moe.combine") if tr.enabled else trace.NO_SPAN:
        y = None
        for k in range(cfg.moe_top_k):
            flat = eidx[:, k] * C + pos_tk[:, k].clamp(0, C - 1)
            y_k = y_flat[flat].float() * w[:, k:k + 1]
            y = y_k if y is None else y + y_k

    if cfg.n_shared_experts:
        with tr.span("nv.moe.shared") if tr.enabled else trace.NO_SPAN:
            hs = (F.silu(compute.matmul(xt, p["shared_wg"],
                                        site="moe.shared_gate", fused_ops=1))
                  * compute.matmul(xt, p["shared_wi"], site="moe.shared_up"))
            y = y + compute.matmul(hs, p["shared_wo"],
                                   site="moe.shared_down").float()
    return y.to(x.dtype).reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# the layer on DTensors, under sharding hints
# ---------------------------------------------------------------------------

_TD = lambda dp, tp: P(dp, None)
_ECD = lambda dp, tp: P(tp, dp, None)


def _sharded_moe(cfg: ModelConfig, p, x):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    C = _capacity(T, E, K)
    mesh = x.device_mesh
    tp_dim = list(mesh.mesh_dim_names).index(compute._HINTS["tp"])
    rep = [Replicate()] * mesh.ndim
    xt = compute.constrain(x.reshape(T, d), _TD)                # (T/dp, d)
    logits = compute.constrain(
        compute.matmul(xt.float(), p["router"], site="moe.router"), _TD)
    tok_pl = list(logits.placements)
    tok_dims = compute.sharded_dims(tok_pl, 0)
    t_blk, n_t = compute.shard_block(mesh, tok_pl, 0)
    T_l = T // n_t
    t0 = t_blk * T_l
    sum_pl = compute.partial_on(rep, tok_dims)

    def route_local(lg):
        probs = torch.softmax(lg, dim=-1)
        gate, eidx = torch.topk(probs, K, dim=-1, sorted=True)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        cnt = torch.zeros((E,), dtype=torch.float32, device=lg.device)
        cnt = cnt.index_add(0, eidx.reshape(-1), torch.ones(
            (eidx.numel(),), device=lg.device))
        return (gate, eidx, probs.sum(0), cnt,
                (torch.logsumexp(lg, dim=-1) ** 2).sum())
    gate, eidx, me_sum, ce_cnt, z_sum = local_map(
        route_local, out_placements=(tok_pl, tok_pl, sum_pl, sum_pl, sum_pl),
        in_placements=(tok_pl,), device_mesh=mesh)(logits)
    aux = {"lb_loss": E * torch.sum((me_sum / T) * (ce_cnt / (T * K))),
           "router_z": z_sum / T}

    # global routing: every rank holds the (T, K) choices; each TP rank
    # counts the positions of its own experts, summed over TP
    eidx_all = eidx.redistribute(mesh, rep).to_local()
    tp_split = E % mesh.size(tp_dim) == 0
    tp_part = [tp_dim] if tp_split else []
    E_l = E // mesh.size(tp_dim) if tp_split else E
    e0 = mesh.get_local_rank(tp_dim) * E_l if tp_split else 0
    part = _positions(eidx_all, E_l, e0)
    if tp_split:
        part = DTensor.from_local(part, mesh, compute.partial_on(
            rep, tp_part)).redistribute(mesh, rep).to_local()
    pos_tk, keep_tk, idx = _slots(eidx_all, part - 1, E, C)

    # dispatch: each rank fills its experts' slots from its own tokens;
    # the partial buffers are reduce-scattered over DP by the constraint
    e_pl = [Shard(0) if md in tp_part else Replicate()
            for md in range(mesh.ndim)]
    buf_pl = compute.partial_on(e_pl, tok_dims)

    def dispatch_local(xl):
        return compute.local_rows(xl, idx[e0:e0 + E_l], t0)
    buf = local_map(dispatch_local, out_placements=buf_pl,
                    in_placements=(tok_pl,),
                    in_grad_placements=(compute.partial_on(tok_pl, tp_part),),
                    device_mesh=mesh)(xt)
    buf = compute.constrain(buf, _ECD)

    # the experts' products on each rank's experts and slots, the expert
    # weights' FSDP axis gathered
    bpl = list(buf.placements)
    w_grad = compute.partial_on(e_pl, compute.sharded_dims(bpl, 1))

    def experts_local(bl, wi, wg, wo):
        h = torch.einsum("ecd,edf->ecf", bl, wi)
        g = F.silu(torch.einsum("ecd,edf->ecf", bl, wg))
        return torch.einsum("ecf,efd->ecd", h * g, wo)
    y_buf = local_map(experts_local, out_placements=bpl,
                      in_placements=(bpl, e_pl, e_pl, e_pl),
                      in_grad_placements=(bpl, w_grad, w_grad, w_grad),
                      device_mesh=mesh, redistribute_inputs=True)(
        buf, p["ewi"], p["ewg"], p["ewo"])

    # combine: each rank's tokens gather their rows from its experts'
    # buffers (all slots gathered over DP), partial over TP
    y_pl = compute.partial_on(tok_pl, tp_part)
    e_l = eidx_all[t0:t0 + T_l]
    p_l = pos_tk[t0:t0 + T_l]
    k_l = keep_tk[t0:t0 + T_l]

    def combine_local(yb, gl):
        w = gl * k_l.float()
        y = None
        for k in range(K):
            mine = (e_l[:, k] >= e0) & (e_l[:, k] < e0 + E_l)
            rows = yb[(e_l[:, k] - e0).clamp(0, E_l - 1),
                      p_l[:, k].clamp(0, C - 1)]
            y_k = torch.where(mine[:, None], rows.float() * w[:, k:k + 1],
                              torch.zeros((), device=yb.device))
            y = y_k if y is None else y + y_k
        return y
    y = local_map(combine_local, out_placements=y_pl,
                  in_placements=(e_pl, tok_pl),
                  in_grad_placements=(compute.partial_on(e_pl, tok_dims),
                                      compute.partial_on(tok_pl, tp_part)),
                  device_mesh=mesh, redistribute_inputs=True)(y_buf, gate)
    y = compute.constrain(y, _TD)

    if cfg.n_shared_experts:
        hs = (F.silu(compute.matmul(xt, p["shared_wg"],
                                    site="moe.shared_gate", fused_ops=1))
              * compute.matmul(xt, p["shared_wi"], site="moe.shared_up"))
        y = y + compute.matmul(hs, p["shared_wo"],
                               site="moe.shared_down").float()
    return y.to(x.dtype).reshape(B, S, d), aux
