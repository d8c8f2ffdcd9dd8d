"""Training and serving step functions (the port of
``repro/train/steps.py``).

``make_train_step`` builds a microbatched (gradient-accumulation) step:
the batch is split into ``accum`` microbatches run one after another,
their gradients summed in ``accum_dtype``.  Optional int8 error-feedback
gradient compression hooks in before the optimizer
(``repro_torch.distributed.compression``).  The optimizer writes the new
parameters and moments in place (``adamw.update_``): one copy of the
train state, whatever its size.

The same step runs on a state of DTensors (sharded over a mesh, under
``compute.sharding_hints``): plain tensors then count as replicated
(``implicit_replication``), each gradient is reduced to its parameter's
placements, AdamW updates the local shards, and the loss and metrics
come back as full tensors.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.models.lm import Model
from repro_torch.optim import adamw


def make_train_state(model: Model, seed: int, opt_cfg: adamw.AdamWConfig,
                     device="cuda") -> dict:
    """Random weights from ``seed``, zero moments, step 0."""
    params = model.init(seed=seed, device=device)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=torch.device(device))}


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _split_microbatches(batch: dict, accum: int, mb_specs=None) -> list:
    """(B, ...) -> ``accum`` microbatches of (B/accum, ...), in order.
    A DTensor batch's microbatches are the one card's rows, each placed
    by its key's spec of ``mb_specs`` (the batch's PartitionSpecs), so
    that the batch dim stays sharded over the data axes as the
    reference's ``with_sharding_constraint`` pins it."""
    out = [{} for _ in range(accum)]
    for k, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"accum {accum}")
        if _is_dtensor(x):
            parts = _dtensor_microbatches(x, accum, None if mb_specs is None
                                          else mb_specs[k])
        else:
            parts = x.chunk(accum)
        for mb, part in zip(out, parts):
            mb[k] = part
    return out


def _dtensor_microbatches(x, accum: int, spec) -> list:
    """``x`` gathered, cut into ``accum`` parts, each placed by ``spec``
    (``x``'s placements where there is none); placing a replicated tensor
    moves no data.  The gather is small for token ids; a frontend's or an
    encoder's embeddings are gathered whole for the moment of the cut."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed import sharding
    mesh = x.device_mesh
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    parts = []
    for part in full.chunk(accum):
        pl = list(x.placements) if spec is None else sharding.placements(
            mesh, sharding._fit_spec(spec, part.shape, mesh))
        parts.append(part.redistribute(mesh, pl))
    return parts


def _full(t):
    return t.full_tensor() if _is_dtensor(t) else t


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    accum: int = 1, compression=None, mb_specs=None,
                    accum_dtype=torch.float32):
    """Returns ``train_step(state, batch, mark=None) -> (state,
    metrics)``; ``state`` is updated in place and returned.

    Gradients come from ``torch.autograd.grad`` over the parameter
    leaves, which take ``requires_grad`` for the backward only.
    ``accum_dtype``: dtype of the gradient-accumulation buffers (accum >
    1).  ``mark(label)``, when given, is called at ``"start"``,
    ``"grads"`` (the forward and backward done) and ``"end"`` (the
    optimizer done), for a caller that times the two apart."""
    microbatches = (lambda b: [b]) if accum == 1 else \
        (lambda b: _split_microbatches(b, accum, mb_specs))

    def grads_and_metrics(params, batch):
        leaves = adamw._leaves(params)
        sharded = bool(leaves) and _is_dtensor(leaves[0])
        for p in leaves:
            p.requires_grad_(True)
        ctx = contextlib.nullcontext()
        if sharded:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            ctx = implicit_replication()
        try:
            ctx.__enter__()
            gsum = lsum = metrics = None
            for mb in microbatches(batch):
                loss, metrics = model.train_loss(params, mb)
                g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
                if sharded:
                    g = [x.redistribute(p.device_mesh, p.placements)
                         for x, p in zip(g, leaves)]
                if accum == 1:
                    gsum, lsum = g, loss
                elif gsum is None:
                    gsum = [x.to(accum_dtype) for x in g]
                    lsum = 0.0 + loss
                else:
                    for a, x in zip(gsum, g):
                        a.add_(x.to(accum_dtype))
                    lsum = lsum + loss
                del g
        finally:
            ctx.__exit__(None, None, None)
            for p in leaves:
                p.requires_grad_(False)
        if accum > 1:
            gsum = [a.div_(accum) for a in gsum]
            lsum = lsum / accum
        grads = adamw._unflatten(params, iter(gsum))
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        return grads, _full(lsum.detach()), metrics

    def train_step(state, batch, mark: Optional[Callable] = None):
        mark = mark or (lambda label: None)
        mark("start")
        grads, loss, metrics = grads_and_metrics(state["params"], batch)
        mark("grads")
        if compression is not None:
            grads, comp_metrics = compression(grads)
            metrics = {**metrics, **comp_metrics}
        opt_metrics = adamw.update_(opt_cfg, grads, state["opt"],
                                    state["params"])
        del grads
        state["step"].add_(1)
        mark("end")
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_serve_step(model: Model):
    """One decode step: the greedy next token for a batch of requests."""

    def serve_step(params, token, pos, cache):
        logits, cache = model.decode_step(params, token, pos, cache)
        if _is_dtensor(logits):
            # one position's logits, the vocab gathered for the argmax
            from torch.distributed.tensor import Replicate
            logits = logits.redistribute(
                logits.device_mesh,
                [q if getattr(q, "dim", None) == 0 else Replicate()
                 for q in logits.placements])
        next_tok = logits.argmax(dim=-1)[:, None]
        return next_tok, logits, cache

    return serve_step
