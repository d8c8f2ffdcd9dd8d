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
from repro_torch.models import attention, blocks, compute
from repro_torch.models.common import (WeightDraw, apply_norm, dense_init,
                                       norm_init, torch_dtype)


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
    x = params["embed"][tokens]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)


def _logits(cfg, params, x):
    # head.T (or the tied embed.T) is a strided view: K1 reads it in
    # place, no copy per step
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return compute.matmul(x, head.T, site="lm_head").float()


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
    aux = {"lb_loss": torch.zeros((), device=x.device),
           "router_z": torch.zeros((), device=x.device)}
    remat = torch.is_grad_enabled() and caches is None
    layers = [_unstack(slot, n) for slot in stack]
    for i in range(n):
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
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - gold).mean()


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
    """Fill the cache from a full-sequence forward; return last logits."""
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
