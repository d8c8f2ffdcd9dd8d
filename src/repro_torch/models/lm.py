"""Model builder (the port of ``repro/models/lm.py``: the decoder stacks
of attention (GQA or MLA), Mamba and xLSTM blocks with dense or MoE
MLPs, with a frontend prefix where the config has one, and the
encoder-decoder with cross-attention).  ``build_model(cfg)``
returns a :class:`Model` of plain functions:

* ``init(seed, device)``                          -> params
* ``train_loss(params, batch)``                   -> (loss, metrics)
* ``prefill(params, batch, cache)``               -> (last_logits, cache)
* ``decode_step(params, token, pos, cache)``      -> (logits, cache)
* ``make_cache(batch, ctx, dtype, device)``       -> zeroed cache

A batch holds ``tokens`` (and ``targets`` to train), plus
``frontend_embeds`` (B, n_frontend_tokens, d) for a vision frontend,
whose projection is prepended to the token embeddings, or
``src_embeds`` (B, S_src, d), the encoder's input, for an
encoder-decoder.  Parameters keep the reference's tree: each period
slot's leaves are stacked along a leading layer axis
(``repro_torch.convert`` maps a JAX tree one to one).  Layers run in a
Python loop over that axis, as deep as the stack's leaves are, each
recomputed in the backward of ``train_loss``; the MoE layers' load-balance
and router z-losses are summed over the stack and enter the loss with
the reference's weights.  The cache is updated in place.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import P
from repro_torch.models import attention, blocks, compute
from repro_torch.models.common import (WeightDraw, apply_norm, dense_init,
                                       norm_init, torch_dtype)
from repro_torch.obs import trace


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable


def _stacked(n: int, make):
    """Stack ``n`` freshly made param trees along a new leading axis,
    filling one preallocated tensor per leaf (peak = stack + one layer).
    A stack of one layer is the drawn tree itself, each leaf a view with
    a leading axis of 1 (peak = the layer)."""
    if n == 1:
        return _map_leaves(make(), lambda v: v.unsqueeze(0))

    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict) else
                torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                            device=v.device)
                for k, v in tree.items()}

    def write(out, tree, i):
        for k, v in tree.items():
            if isinstance(v, dict):
                write(out[k], v, i)
            else:
                out[k][i] = v

    first = make()
    out = alloc(first)
    write(out, first, 0)
    for i in range(1, n):
        write(out, make(), i)
    return out


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _stack_init(cfg: ModelConfig, draw, dtype, device, n_units: int,
                cross: bool = False):
    """One stacked tree a period slot, ``n_units // len(period)`` layers
    deep; a decoder slot of an encoder-decoder (``cross``) also gets its
    cross-attention (``cross``) and that attention's norm (``norm_x``)."""
    ln = cfg.norm == "layernorm"

    def layer(b):
        p = blocks.block_init(cfg, b, draw, dtype, device)
        if cross:
            p["cross"] = attention.attn_init(cfg, draw, dtype, device,
                                             cross=True)
            p["norm_x"] = norm_init(cfg.d_model, dtype, device, bias=ln)
        return p
    n = n_units // len(cfg.period)
    return tuple(_stacked(n, lambda b=b: layer(b)) for b in cfg.period)


def model_init(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights from ``seed`` (``device="meta"``: shapes only),
    drawn on ``device`` by :class:`~repro_torch.models.common.WeightDraw`:
    the same numbers on every device."""
    dtype = torch_dtype(cfg.dtype)
    device = torch.device(device)
    draw = None if device.type == "meta" else WeightDraw(seed)
    ln = cfg.norm == "layernorm"
    p = {"embed": dense_init(draw, (cfg.vocab_size, cfg.d_model), dtype,
                             device, scale=cfg.d_model ** -0.5),
         "final_norm": norm_init(cfg.d_model, dtype, device, bias=ln)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(draw, (cfg.vocab_size, cfg.d_model), dtype,
                               device)
    if cfg.frontend != "none" and not cfg.enc_dec:
        p["frontend_proj"] = dense_init(draw, (cfg.d_model, cfg.d_model),
                                        dtype, device)
    if cfg.enc_dec:
        p["enc_blocks"] = _stack_init(cfg, draw, dtype, device,
                                      cfg.n_enc_layers)
        p["dec_blocks"] = _stack_init(cfg, draw, dtype, device,
                                      cfg.n_dec_layers, cross=True)
        p["enc_norm"] = norm_init(cfg.d_model, dtype, device, bias=ln)
    else:
        p["blocks"] = _stack_init(cfg, draw, dtype, device, cfg.n_layers)
    return p


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each a tree of views.  One
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a zero-padded copy of the whole
    stack into the leaf's gradient once a layer."""
    layers = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def _embed(cfg, params, tokens):
    if compute.is_dtensor(params["embed"]):
        x = _sharded_lookup(params["embed"], tokens)
    else:
        x = params["embed"][tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def _sharded_lookup(emb, tokens):
    """``emb[tokens]`` for a vocab-sharded DTensor table: each rank looks
    its batch rows' tokens up in its vocab rows (the table's other axes
    gathered), a partial sum over the vocab's mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = emb.device_mesh
    if not compute.is_dtensor(tokens):
        tokens = compute._dtensor_cls().from_local(
            tokens, mesh, [Replicate()] * mesh.ndim)
    tpl = list(tokens.placements)
    v_dims = compute.sharded_dims(emb.placements, 0)
    epl = [Shard(0) if md in v_dims else Replicate()
           for md in range(mesh.ndim)]
    opl = compute.partial_on(
        [Shard(0) if md in compute.sharded_dims(tpl, 0) else Replicate()
         for md in range(mesh.ndim)], v_dims)
    egrad = compute.partial_on(epl, compute.sharded_dims(tpl, 0))

    def lookup(el, tl):
        v_blk, _ = compute.shard_block(mesh, epl, 0)
        return compute.local_rows(el, tl, v_blk * el.shape[0])
    return local_map(lookup, out_placements=opl, in_placements=(epl, tpl),
                     in_grad_placements=(egrad, tpl), device_mesh=mesh,
                     redistribute_inputs=True)(emb, tokens)


def _logits(cfg, params, x):
    # head.T (or the tied embed.T) is a strided view: K1 reads it in
    # place, no copy per step
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    if compute.is_dtensor(head):
        head = _vocab_over_tp(head)
    return compute.matmul(x, head.T, site="lm_head").float()


def _vocab_over_tp(head):
    """The (V, d) head with its vocab sharded over TP, unevenly where TP
    does not divide V (its parameter spec then leaves V replicated, and a
    local slice places it), so the logits come out vocab-sharded, as
    GSPMD pads them."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = head.device_mesh
    tp = list(mesh.mesh_dim_names).index(compute._HINTS["tp"])
    if head.placements[tp] != Replicate():
        return head
    pl = list(head.placements)
    pl[tp] = Shard(0)
    return head.redistribute(mesh, pl)


def _depth(stack) -> int:
    """The layers of a stacked tree: its leaves' leading dim."""
    tree = stack[0]
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def _slot_apply(cfg, b, p, x, *, memory, positions, causal, cache,
                decode_pos, mem_cache):
    """One period slot: the block, then (a decoder slot of an
    encoder-decoder) the cross-attention over the memory or its cache.
    Returns ``(x, aux)`` as ``blocks.block_apply`` does."""
    x, aux = blocks.block_apply(cfg, b, p, x, positions=positions,
                                causal=causal, cache=cache,
                                decode_pos=decode_pos)
    if "cross" in p:
        x = x + attention.apply_cross_attn(
            cfg, p["cross"], apply_norm(p["norm_x"], x), memory=memory,
            mem_cache=mem_cache)
    return x, aux


def _run_stack(cfg, stack, x, *, positions, causal, caches=None,
               decode_pos=None, memory=None, mem_caches=None):
    """The layers of ``stack`` over ``x``.  Under autograd and without a
    cache each layer is recomputed in the backward, as the reference's
    ``jax.checkpoint(..., policy=nothing_saveable)`` does: only the
    layers' inputs are kept.  ``memory`` with ``mem_caches`` (prefill)
    writes the cross-attention k/v into them; ``mem_caches`` alone
    (decode) is read.  Returns ``(x, aux)``: ``aux`` the MoE layers'
    ``{"lb_loss", "router_z"}`` summed in layer order, zero without
    MoE."""
    n = _depth(stack)
    # new_zeros: a replicated DTensor where x is a DTensor
    aux = {"lb_loss": x.new_zeros((), dtype=torch.float32),
           "router_z": x.new_zeros((), dtype=torch.float32)}
    remat = torch.is_grad_enabled() and caches is None
    tr = trace.active()
    with tr.span("nv.unstack") if tr.enabled else trace.NO_SPAN:
        layers = [_unstack(slot, n) for slot in stack]
    for i in range(n):
        with tr.span("nv.layer", index=i) if tr.enabled else trace.NO_SPAN:
            # pin the carry under sharding hints: batch over DP, d over TP
            x = compute.constrain(x, lambda dp, tp: P(
                dp if x.shape[0] > 1 else None, None,
                tp if compute._HINTS["carry_tp"] else None))
            for slot, b in enumerate(cfg.period):
                cache = mc = None
                if caches is not None:
                    cache = {k: v[i] for k, v in caches[slot].items()}
                if mem_caches is not None:
                    mc = {k: v[i] for k, v in mem_caches[slot].items()}
                apply = functools.partial(
                    _slot_apply, cfg, b, layers[slot][i], memory=memory,
                    positions=positions, causal=causal, cache=cache,
                    decode_pos=decode_pos, mem_cache=mc)
                x, a = checkpoint(apply, x, use_reentrant=False) if remat \
                    else apply(x)
                if a is not None:
                    aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def _prep_inputs(cfg, params, batch):
    """The token embeddings, after the projected frontend prefix where
    the config has one: ``(x, n_pre)``."""
    x = _embed(cfg, params, batch["tokens"])
    if cfg.frontend == "none" or cfg.enc_dec:
        return x, 0
    fe = compute.matmul(batch["frontend_embeds"].to(x.dtype),
                        params["frontend_proj"], site="frontend.proj")
    return torch.cat([fe, x], dim=1), fe.shape[1]


def _positions(x, decode_pos):
    start = 0 if decode_pos is None else decode_pos
    return torch.arange(start, start + x.shape[1], device=x.device)


def forward(cfg, params, batch, caches=None, decode_pos=None,
            mem_caches=None):
    """The (decoder) stack's output over ``batch``, the frontend prefix's
    length and the stack's MoE losses: ``(x, n_pre, aux)``.  Unless
    ``decode_pos`` is given, the frontend prefix goes first and an
    encoder-decoder's encoder (non-causal) runs over
    ``batch["src_embeds"]``: prefill writes its cross-attention k/v into
    ``mem_caches``, which decode reads."""
    memory = None
    if decode_pos is None:
        x, n_pre = _prep_inputs(cfg, params, batch)
        if cfg.enc_dec:
            src = batch["src_embeds"].to(torch_dtype(cfg.dtype))
            memory, _ = _run_stack(cfg, params["enc_blocks"], src,
                                   positions=_positions(src, None),
                                   causal=False)
            memory = apply_norm(params["enc_norm"], memory)
    else:
        x, n_pre = _embed(cfg, params, batch["tokens"]), 0
    stack = params["dec_blocks"] if cfg.enc_dec else params["blocks"]
    x, aux = _run_stack(cfg, stack, x, positions=_positions(x, decode_pos),
                        causal=True, caches=caches, decode_pos=decode_pos,
                        memory=memory, mem_caches=mem_caches)
    return apply_norm(params["final_norm"], x), n_pre, aux


def _xent(logits, targets):
    if compute.is_dtensor(logits):
        return _sharded_xent(logits, targets)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - gold).mean()


def _sharded_xent(logits, targets):
    """``_xent`` on DTensors with the vocab sharded over TP, as the
    reference's hints pin it: each rank's log-sum-exp over its vocab shard
    is combined over TP (a max and a sum), and the gold logit is the
    one-hot contraction over its shard (a partial sum over TP), so the
    logits are never gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    rows = lambda dp, tp: P(dp if logits.shape[0] > 1 else None, None)
    mesh = logits.device_mesh
    tp = list(mesh.mesh_dim_names).index(compute._HINTS["tp"])
    V = logits.shape[-1]
    # batch over DP; the vocab over TP, unevenly where TP does not divide
    # it (each shard ceil(V / TP) wide, the last one less)
    pl = compute.hint_placements(targets, rows)
    pl[tp] = Shard(logits.ndim - 1)
    if list(logits.placements) != pl:
        logits = logits.redistribute(mesh, pl)
    targets = compute.constrain(targets, rows)
    v_dims = compute.sharded_dims(pl, logits.ndim - 1)
    lse_pl = [Replicate() if md in v_dims else q for md, q in enumerate(pl)]
    groups = [(mesh, md) for md in v_dims if mesh.size(md) > 1]

    def nll_local(lg, tg):
        blk, n_blk = compute.shard_block(mesh, pl, lg.ndim - 1)
        v0 = blk * -(-V // n_blk)
        n = lg.shape[-1]
        g = torch.gather(lg, -1, (tg - v0).clamp(0, max(n - 1, 0))[
            ..., None])[..., 0]
        gold = torch.where((tg >= v0) & (tg < v0 + n), g,
                           torch.zeros((), dtype=g.dtype, device=g.device))
        return _ShardedLSE.apply(lg, groups), gold
    lse, gold = local_map(nll_local,
                          out_placements=(lse_pl,
                                          compute.partial_on(pl, v_dims)),
                          in_placements=(pl, list(targets.placements)),
                          device_mesh=mesh)(logits, targets)
    return (lse - gold).mean()


class _ShardedLSE(torch.autograd.Function):
    """``logsumexp`` over the last dim of a tensor whose last dim is
    sharded over the mesh dims ``groups``: the max and the sum of
    exponentials are all-reduced over them.  The backward is local:
    ``softmax = exp(x - lse)`` on the shard."""

    @staticmethod
    def forward(ctx, x, groups):
        from torch.distributed import _functional_collectives as fc
        m = x.amax(-1)
        for g in groups:
            m = fc.all_reduce(m, "max", g)
        s = torch.exp(x - m[..., None]).sum(-1)
        for g in groups:
            s = fc.all_reduce(s, "sum", g)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None


def train_loss(cfg: ModelConfig, params, batch):
    """The loss (cross-entropy in f32, as the reference's, over the text
    positions only, plus ``1e-2 * lb_loss + 1e-3 * router_z`` of the MoE
    layers) and its metrics; differentiable, each layer recomputed in the
    backward."""
    x, n_pre, aux = forward(cfg, params, batch)
    logits = _logits(cfg, params, x)
    xent = _xent(logits[:, n_pre:], batch["targets"])
    loss = xent + 1e-2 * aux["lb_loss"] + 1e-3 * aux["router_z"]
    return loss, {"xent": xent, **aux}


def make_cache(cfg: ModelConfig, batch: int, ctx: int, dtype=None,
               device="cuda"):
    """``ctx`` positions a layer: ``caches`` for the (decoder) stack's
    blocks and, for an encoder-decoder, ``mem`` for its cross-attention."""
    dtype = dtype or torch_dtype(cfg.dtype)
    n = ((cfg.n_dec_layers if cfg.enc_dec else cfg.n_layers)
         // len(cfg.period))

    def stacked(one):
        # one copy a layer of the slot's initial cache (xLSTM's stabiliser
        # starts at -1e30, not 0)
        return {k: v[None].expand((n,) + tuple(v.shape)).clone()
                for k, v in one.items()}
    out = {"caches": tuple(
        stacked(blocks.block_cache(cfg, b, batch, ctx, dtype, device))
        for b in cfg.period)}
    if cfg.enc_dec:
        out["mem"] = tuple(
            stacked(attention.make_attn_cache(cfg, batch, ctx, dtype, device))
            for _ in cfg.period)
    return out


def prefill(cfg: ModelConfig, params, batch, cache):
    """Fill the cache from a full-sequence forward; return last logits.
    Traced as ``nv.prefill`` where tracing is on or a ``torch.profiler``
    records (``obs.trace.for_step``)."""
    tr = trace.for_step()
    if not tr.enabled:
        return _prefill(cfg, params, batch, cache)
    B, S = batch["tokens"].shape
    with trace.tracing(tr), tr.span("nv.prefill", batch=B, tokens=B * S):
        return _prefill(cfg, params, batch, cache)


def _prefill(cfg: ModelConfig, params, batch, cache):
    x, _, _ = forward(cfg, params, batch, caches=cache["caches"],
                      mem_caches=cache.get("mem"))
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params, token, pos: int, cache):
    """token (B,1); ``pos`` the absolute position of the new token."""
    x, _, _ = forward(cfg, params, {"tokens": token},
                      caches=cache["caches"], decode_pos=int(pos),
                      mem_caches=cache.get("mem"))
    return _logits(cfg, params, x)[:, 0], cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg,
                 init=functools.partial(model_init, cfg),
                 train_loss=functools.partial(train_loss, cfg),
                 prefill=functools.partial(prefill, cfg),
                 decode_step=functools.partial(decode_step, cfg),
                 make_cache=functools.partial(make_cache, cfg))
