"""AdamW with global-norm clipping and a warmup-then-cosine schedule, as
functions on trees of tensors (the port of ``repro/optim/adamw.py``).

A tree is a tensor, or a dict, list or tuple of trees.  Moments are f32
whatever the parameters' dtype.  Weight decay is decoupled and applies to
tensors with ``ndim >= 2`` only, as the reference's does
(``torch.optim.AdamW`` decays every tensor, 1-D ones too, and so is not
used).  ``update_`` writes the new parameters and moments in place (one
copy of the state, whatever its size); ``update`` is its functional
form, which returns new tensors and never writes into its arguments.

On DTensors (a state sharded over a mesh) ``update_`` works on each
leaf's local shard, and the global norm sums the squares of the local
shards and all-reduces them over the mesh dims that shard each leaf, so
it is the one-card norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _leaves(tree) -> list:
    """The tensors of ``tree`` in the reference's order (dict keys
    sorted, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor): linear warmup
    over ``warmup_steps``, then cosine down to ``min_lr_frac * lr`` at
    ``total_steps``; an f32 tensor, computed as the reference computes
    it in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict:
    """Zero f32 moments shaped like ``params``, and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = _leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": _unflatten(params, iter([zeros(p) for p in leaves])),
            "v": _unflatten(params, iter([zeros(p) for p in leaves])),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def global_norm(tree) -> torch.Tensor:
    """The l2 norm over every leaf of ``tree``, in f32."""
    leaves = _leaves(tree)
    if leaves and _is_dtensor(leaves[0]):
        return _sharded_norm(leaves)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def _sharded_norm(leaves) -> torch.Tensor:
    """``global_norm`` of DTensor leaves: the local shards' sums of
    squares, added per pattern of sharded mesh dims and all-reduced over
    those dims (a replicated dim holds copies, which count once)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = leaves[0].device_mesh
    by_pattern = {}
    for g in leaves:
        key = tuple(isinstance(q, Shard) for q in g.placements)
        s = torch.sum(torch.square(g.to_local().float()))
        by_pattern[key] = s if key not in by_pattern else by_pattern[key] + s
    total = None
    for key, s in by_pattern.items():
        pl = [Partial() if k else Replicate() for k in key]
        s = DTensor.from_local(s, mesh, pl).full_tensor()
        total = s if total is None else total + s
    return torch.sqrt(total)


# elements of a leaf updated at once by ``update_``: bounds its f32
# temporaries (at most four of this size) whatever the leaf's size
CHUNK = 1 << 24


@torch.no_grad()
def update_(cfg: AdamWConfig, grads, state: dict, params) -> dict:
    """One AdamW step in place: writes the new parameters into ``params``
    and the new moments and step into ``state``; returns the metrics
    ``{"grad_norm", "lr"}``.  ``grads`` has ``params``' structure; each
    leaf is taken in flat chunks of ``CHUNK`` elements; a DTensor leaf
    by its local shard (``p``, ``g``, ``m`` and ``v`` placed alike)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    state["step"].add_(1)
    step = _local(state["step"])
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state["m"]), _leaves(state["v"])):
        decay = p.ndim >= 2
        if _is_dtensor(p):
            if not (p.placements == g.placements == m.placements
                    == v.placements):
                raise ValueError("a leaf's parameter, gradient and moments "
                                 "are placed differently")
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        # p, m and v are written through views; g may have any layout
        pcs, mcs, vcs = (t.view(-1).split(CHUNK) for t in (p, m, v))
        gcs = g.reshape(-1).split(CHUNK)
        for pc, gc, mc, vc in zip(pcs, gcs, mcs, vcs):
            gc = gc.float() * scale
            mc.mul_(b1).add_((1 - b1) * gc)
            vc.mul_(b2).add_(((1 - b2) * gc).mul_(gc))
            u = (mc / bc1).div_(torch.sqrt(vc / bc2).add_(cfg.eps))
            if decay:
                u.add_(cfg.weight_decay * pc.float())
            pc.copy_(pc.float() - u.mul_(lr))
    return {"grad_norm": gnorm, "lr": lr}


def update(cfg: AdamWConfig, grads, state: dict, params):
    """``update_`` on copies: ``(new_params, new_state, metrics)``, the
    arguments left as they were."""
    def copy(tree):
        return _unflatten(tree, iter([
            t.detach().clone(memory_format=torch.contiguous_format)
            for t in _leaves(tree)]))
    new_params = copy(params)
    new_state = {"m": copy(state["m"]), "v": copy(state["v"]),
                 "step": state["step"].clone()}
    metrics = update_(cfg, grads, new_state, new_params)
    return new_params, new_state, metrics
