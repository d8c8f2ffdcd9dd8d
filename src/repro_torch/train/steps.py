"""Training and serving step functions (the port of
``repro/train/steps.py``).

``make_train_step`` builds a microbatched (gradient-accumulation) step:
the batch is split into ``accum`` microbatches run one after another,
their gradients summed in ``accum_dtype``.  Optional int8 error-feedback
gradient compression hooks in before the optimizer
(``repro_torch.distributed.compression``).  The optimizer writes the new
parameters and moments in place (``adamw.update_``): one copy of the
train state, whatever its size.
"""
from __future__ import annotations

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


def _split_microbatches(batch: dict, accum: int, mb_specs=None) -> list:
    """(B, ...) -> ``accum`` microbatches of (B/accum, ...), in order.
    ``mb_specs`` pins the reference's GSPMD shardings; one card has none."""
    if mb_specs is not None:
        raise NotImplementedError(
            "mb_specs pins GSPMD shardings of a mesh; one card has none")
    out = [{} for _ in range(accum)]
    for k, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"accum {accum}")
        for mb, part in zip(out, x.chunk(accum)):
            mb[k] = part
    return out


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
        for p in leaves:
            p.requires_grad_(True)
        try:
            gsum = lsum = metrics = None
            for mb in microbatches(batch):
                loss, metrics = model.train_loss(params, mb)
                g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
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
            for p in leaves:
                p.requires_grad_(False)
        if accum > 1:
            gsum = [a.div_(accum) for a in gsum]
            lsum = lsum / accum
        grads = adamw._unflatten(params, iter(gsum))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return grads, lsum.detach(), metrics

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
        next_tok = logits.argmax(dim=-1)[:, None]
        return next_tok, logits, cache

    return serve_step
