"""Carry weights across from the JAX package.

``params_from_jax(np_params, cfg)`` maps the reference's parameter tree
(the decoder's with its ``frontend_proj`` where it has one, the
encoder-decoder's ``enc_blocks``, ``dec_blocks`` with their ``cross``
and ``norm_x``, and ``enc_norm``, the xLSTM stack's; the MoE MLP's f32
``router``, stacked ``ewi``/``ewg``/``ewo`` and ``shared_*``, the
Mamba mixer's ``in_proj``, ``conv``, f32 ``A_log``/``D``/``dt_bias``,
``norm`` and ``out_proj``, and MLA's ``wkv_a``, ``kv_norm``, ``w_uk``,
``w_uv``, ``wo``, ``wq_a``, ``q_norm`` and ``wq_b`` among the leaves), and
``train_state_from_jax(np_state, cfg)`` its whole train state,
with its leaves as numpy arrays, onto the port's.  The two trees have the
same structure: each period slot's leaves stacked along a leading layer
axis (``repro/models/lm.py:44-58``), every matmul weight ``w(K, N)`` with
the same meaning.  So the map is exact: the same numbers, no transposes.
``embedder_from_jax(np_params)`` does the same for the code2vec
embedder's four leaves, and ``surrogate_from_jax(state)`` for a trained
surrogate: the reference's ``SurrogateModel.state_dict()`` (its weights
``w(in, out)`` as the port stores them) becomes a port model computing
the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import build_model


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(ref, src, path, device):
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            raise ValueError(f"{path}: keys {sorted(src) if isinstance(src, dict) else type(src)} "
                             f"!= {sorted(ref)}")
        return {k: _map(ref[k], src[k], f"{path}/{k}", device) for k in ref}
    if isinstance(ref, (tuple, list)):
        if len(src) != len(ref):
            raise ValueError(f"{path}: {len(src)} entries, expected "
                             f"{len(ref)}")
        return tuple(_map(r, s, f"{path}/{i}", device)
                     for i, (r, s) in enumerate(zip(ref, src)))
    t = _tensor(src, device)
    if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
        raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(ref.shape)} {ref.dtype}")
    return t


def embedder_from_jax(np_params, device="cuda") -> dict:
    """The code2vec embedder's parameters (``tok``, ``path``, ``W``,
    ``att``) from the reference's ``embedding.embedder_init`` leaves as
    numpy arrays, the same numbers as f32 tensors."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.array(np_params[k], np.float32), device=dev)
            for k in ("tok", "path", "W", "att")}


def params_from_jax(np_params, cfg: ModelConfig, device="cuda") -> dict:
    """The port's parameter tree holding the reference's numbers, on the
    card unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    ref = build_model(cfg).init(device="meta")
    return _map(ref, np_params, "params", dev)


def train_state_from_jax(np_state, cfg: ModelConfig, device="cuda") -> dict:
    """The port's train state (``train.steps.make_train_state``'s tree)
    holding the numbers of the reference's ``{"params", "opt": {"m", "v",
    "step"}, "step"}`` with numpy leaves, mapped one to one as
    :func:`params_from_jax` maps the parameters; the moments f32."""
    dev = resolve_device(device)
    ref = build_model(cfg).init(device="meta")
    moments = _map_tree(ref, lambda t: torch.empty(t.shape,
                                                   dtype=torch.float32,
                                                   device="meta"))
    opt = np_state["opt"]

    def step(a, path):
        return _map(torch.empty((), dtype=torch.int32, device="meta"),
                    np.asarray(a, np.int32), path, dev)
    return {"params": _map(ref, np_state["params"], "params", dev),
            "opt": {"m": _map(moments, opt["m"], "opt/m", dev),
                    "v": _map(moments, opt["v"], "opt/v", dev),
                    "step": step(opt["step"], "opt/step")},
            "step": step(np_state["step"], "step")}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tree(v, fn) for v in tree)
    return fn(tree)


def surrogate_from_jax(state: dict, device="cuda"):
    """A :class:`~repro_torch.surrogate.model.SurrogateModel` holding the
    numbers of a reference ``SurrogateModel.state_dict()`` (numpy arrays;
    weights f32, normalization statistics f64), on the card unless
    ``device="cpu"`` is asked for."""
    from repro_torch.surrogate.model import SurrogateModel
    state = dict(state)
    state["params"] = [[{"w": np.asarray(l["w"], np.float32),
                         "b": np.asarray(l["b"], np.float32)}
                        for l in member] for member in state["params"]]
    return SurrogateModel.from_state(state, device=device)
