"""Stand-ins for every model input (the port of ``repro/launch/specs.py``):
tensors on ``meta`` with the reference's shapes and dtypes, which hold no
data; the dry-run turns them into fake tensors.  The train state comes
from ``make_train_state`` on ``meta``, so no weight is drawn.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models.common import torch_dtype
from repro_torch.models.lm import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import make_train_state


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs_abstract(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training/prefill batch stand-ins."""
    B, S = shape.global_batch, shape.seq_len
    n_pre = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    b = {"tokens": _sds((B, S - n_pre), torch.int32),
         "targets": _sds((B, S - n_pre), torch.int32)}
    if cfg.frontend == "vision":
        b["frontend_embeds"] = _sds((B, n_pre, cfg.d_model), torch.float32)
    if cfg.enc_dec:
        b["src_embeds"] = _sds((B, S, cfg.d_model), torch.float32)
    return b


def input_specs(model: Model, shape_name: str,
                opt_cfg: AdamWConfig = AdamWConfig(),
                shape: ShapeConfig = None):
    """-> (kind, abstract args tuple) for the step that this shape runs:
    train -> train_step(state, batch); prefill -> (params, batch, cache);
    decode -> serve_step(params, token, pos, cache).  ``shape`` stands in
    for ``SHAPES[shape_name]`` where given."""
    cfg = model.cfg
    shape = shape or SHAPES[shape_name]
    if shape.kind == "train":
        state = make_train_state(model, 0, opt_cfg, device="meta")
        return "train", (state, batch_specs_abstract(cfg, shape))
    params = model.init(seed=0, device="meta")
    cache = model.make_cache(shape.global_batch, shape.seq_len,
                             torch_dtype(cfg.dtype), device="meta")
    if shape.kind == "prefill":
        return "prefill", (params, batch_specs_abstract(cfg, shape), cache)
    token = _sds((shape.global_batch, 1), torch.int32)
    pos = _sds((), torch.int32)
    return "decode", (params, token, pos, cache)


def input_shardings(model: Model, shape_name: str, mesh, abstract,
                    fsdp: bool = True, shape: ShapeConfig = None):
    """PartitionSpec trees matching ``input_specs``'s output (the
    reference returns the ``NamedSharding``s of these specs);
    ``sharding.placements`` turns each into DTensor placements."""
    cfg = model.cfg
    shape = shape or SHAPES[shape_name]
    bspec = shd.batch_specs(cfg, shape, mesh)
    if shape.kind == "train":
        state, _ = abstract
        state_specs = {"params": shd.param_specs(state["params"], mesh,
                                                 fsdp=fsdp),
                       "opt": shd.param_specs(state["opt"], mesh, fsdp=fsdp),
                       "step": P()}
        return state_specs, bspec
    cache_specs = shd.cache_specs(cfg, shape, mesh, abstract[-1])
    params_specs = shd.param_specs(abstract[0], mesh, fsdp=fsdp)
    if shape.kind == "prefill":
        return params_specs, bspec, cache_specs
    n_dp = 1
    for a in shd.dp_axes(mesh):
        n_dp *= shd.axis_sizes(mesh)[a]
    tok_spec = P(shd.dp_axes(mesh), None) \
        if shape.global_batch % n_dp == 0 \
        and shape.global_batch >= n_dp else P(None, None)
    return params_specs, tok_spec, P(), cache_specs
