"""Decoder-only model builder (the port of ``repro/models/lm.py``: the
dense decoder and the xLSTM stack).  ``build_model(cfg)`` returns a :class:`Model` of plain functions:

* ``init(seed, device)``                          -> params
* ``train_loss(params, batch)``                   -> (loss, metrics)
* ``prefill(params, batch, cache)``               -> (last_logits, cache)
* ``decode_step(params, token, pos, cache)``      -> (logits, cache)
* ``make_cache(batch, ctx, dtype, device)``       -> zeroed cache

Parameters keep the reference's tree: each period slot's leaves are
stacked along a leading layer axis (``repro_torch.convert`` maps a JAX
tree one to one).  Layers run in a Python loop over that axis, each
recomputed in the backward of ``train_loss``.  The cache is updated in
place.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.models import blocks, compute
from repro_torch.models.common import (apply_norm, dense_init, norm_init,
                                       torch_dtype)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable


_PORTED_BLOCKS = (BlockDesc("attn", "dense"), BlockDesc("mlstm", "none"),
                  BlockDesc("slstm", "none"))


def _check_ported(cfg: ModelConfig) -> None:
    """The port runs decoder stacks of attention + gated-SiLU MLP blocks
    (1-D RoPE or none) and of mLSTM/sLSTM blocks, with RMSNorm or
    LayerNorm and a tied or untied head."""
    has_attn = any(b.kind == "attn" for b in cfg.period)
    if (cfg.enc_dec or cfg.frontend != "none" or cfg.mla
            or cfg.norm not in ("rmsnorm", "layernorm")
            or any(b not in _PORTED_BLOCKS for b in cfg.period)
            or (has_attn and (cfg.act != "silu"
                              or cfg.rope not in ("1d", "none")))):
        raise NotImplementedError(
            f"{cfg.name}: not ported yet; the port runs attention + gated "
            f"SiLU MLP blocks (1-D RoPE or none) and mLSTM/sLSTM blocks")


def _stacked(n: int, make):
    """Stack ``n`` freshly made param trees along a new leading axis,
    filling one preallocated tensor per leaf (peak = stack + one layer)."""
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


def model_init(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random weights from ``seed`` (``device="meta"``: shapes only)."""
    dtype = torch_dtype(cfg.dtype)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    p = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                             device, scale=cfg.d_model ** -0.5),
         "final_norm": norm_init(cfg.d_model, dtype, device,
                                 bias=cfg.norm == "layernorm")}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                               device)
    p["blocks"] = tuple(
        _stacked(cfg.n_periods,
                 lambda b=b: blocks.block_init(cfg, b, gen, dtype, device))
        for b in cfg.period)
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


def decoder_forward(cfg, params, tokens, caches=None, decode_pos=None):
    """The stack's output.  Under autograd and without a cache each layer
    is recomputed in the backward, as the reference's
    ``jax.checkpoint(..., policy=nothing_saveable)`` does: only the
    layers' inputs are kept."""
    x = _embed(cfg, params, tokens)
    S = x.shape[1]
    start = 0 if decode_pos is None else decode_pos
    positions = torch.arange(start, start + S, device=x.device)
    remat = torch.is_grad_enabled() and caches is None
    layers = [_unstack(slot, cfg.n_periods) for slot in params["blocks"]]
    for i in range(cfg.n_periods):
        for slot, b in enumerate(cfg.period):
            cache = None
            if caches is not None:
                cache = {k: v[i] for k, v in caches[slot].items()}
            apply = functools.partial(
                blocks.block_apply, cfg, b, layers[slot][i],
                positions=positions, causal=True, cache=cache,
                decode_pos=decode_pos)
            x = checkpoint(apply, x, use_reentrant=False) if remat \
                else apply(x)
    return apply_norm(params["final_norm"], x)


def _xent(logits, targets):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - gold).mean()


def train_loss(cfg: ModelConfig, params, batch):
    """The loss (cross-entropy in f32, as the reference's) and its metrics;
    differentiable, each layer recomputed in the backward."""
    x = decoder_forward(cfg, params, batch["tokens"])
    loss = _xent(_logits(cfg, params, x), batch["targets"])
    zero = torch.zeros((), device=loss.device)
    return loss, {"xent": loss, "lb_loss": zero, "router_z": zero}


def make_cache(cfg: ModelConfig, batch: int, ctx: int, dtype=None,
               device="cuda"):
    dtype = dtype or torch_dtype(cfg.dtype)
    caches = []
    for b in cfg.period:
        one = blocks.block_cache(cfg, b, batch, ctx, dtype, device)
        # one copy a layer of the slot's initial cache (xLSTM's stabiliser
        # starts at -1e30, not 0)
        caches.append({k: v[None].expand((cfg.n_periods,) + tuple(v.shape))
                       .clone() for k, v in one.items()})
    return {"caches": tuple(caches)}


def prefill(cfg: ModelConfig, params, batch, cache):
    """Fill the cache from a full-sequence forward; return last logits."""
    x = decoder_forward(cfg, params, batch["tokens"], caches=cache["caches"])
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params, token, pos: int, cache):
    """token (B,1); ``pos`` the absolute position of the new token."""
    x = decoder_forward(cfg, params, token, caches=cache["caches"],
                        decode_pos=int(pos))
    return _logits(cfg, params, x)[:, 0], cache


def build_model(cfg: ModelConfig) -> Model:
    _check_ported(cfg)
    return Model(cfg=cfg,
                 init=functools.partial(model_init, cfg),
                 train_loss=functools.partial(train_loss, cfg),
                 prefill=functools.partial(prefill, cfg),
                 decode_step=functools.partial(decode_step, cfg),
                 make_cache=functools.partial(make_cache, cfg))
