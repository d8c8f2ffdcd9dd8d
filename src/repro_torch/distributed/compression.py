"""Gradient compression: int8 quantization with error feedback (the port
of ``repro/distributed/compression.py:23-47``).

``make_compressor`` returns a hook for ``make_train_step``: each gradient
tensor is quantized to int8 against a per-tensor scale with an
error-feedback accumulator (the classical EF-SGD trick, which keeps
convergence), then dequantized for the optimizer.  ``compressed_psum`` (the port of
``:50-64``) is an all-reduce with int8 on the wire: each rank quantizes
its own tensor, the codes and scales are all-gathered over one mesh
axis, and each rank sums them in f32.
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


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data"
                    ) -> torch.Tensor:
    """The sum over ``axis`` of ``mesh`` of each rank's ``x``, moved as
    int8: each rank quantizes its own ``x`` against its own scale
    (``max|x| / 127``), the int8 codes and the f32 scales are
    all-gathered over the axis (``all_gather_into_tensor`` on its
    group), and each rank sums ``scale_r * q_r`` in f32, in rank order.
    4x fewer collective bytes than an f32 all-reduce."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    qg = torch.empty((n * q.numel(),), dtype=torch.int8, device=q.device)
    sg = torch.empty((n,), dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(qg, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(sg, scale.reshape(1), group=group)
    qg = qg.reshape((n,) + tuple(q.shape))
    return torch.tensordot(sg, qg.float(), dims=([0], [0]))
