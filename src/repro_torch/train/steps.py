"""Serving step functions (the port of ``repro/train/steps.py:103-117``;
the train step waits)."""
from __future__ import annotations

from repro_torch.models.lm import Model


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
