"""Gradient compression: int8 quantization with error feedback (the port
of ``repro/distributed/compression.py:23-47``).

``make_compressor`` returns a hook for ``make_train_step``: each gradient
tensor is quantized to int8 against a per-tensor scale with an
error-feedback accumulator (the classical EF-SGD trick, which keeps
convergence), then dequantized for the optimizer.  The reference's
``compressed_psum`` (int8 over the wire of a mesh's all-reduce) needs
several cards and is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import _leaves, _unflatten


def _quantize(g: torch.Tensor, err: torch.Tensor):
    """-> (dequantized f32, new error, int8 codes, scale)."""
    g = g.float() + err
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq, q, scale


def make_compressor(params_like):
    """An error-feedback compressor whose residual (f32, shaped like
    ``params_like``) lives in its closure; ``compress(grads) ->
    (dequantized grads, {"compress_err_sq": sum of squared residuals})``."""
    state = {"err": [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in _leaves(params_like)]}

    def compress(grads):
        res = [_quantize(g, e) for g, e in zip(_leaves(grads), state["err"])]
        state["err"] = [r[1] for r in res]
        deq = _unflatten(grads, iter([r[0] for r in res]))
        err_norm = sum(torch.sum(e * e) for e in state["err"])
        return deq, {"compress_err_sq": err_norm}

    return compress
