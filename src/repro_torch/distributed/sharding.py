"""Sharding rules: DP / TP (Megatron-style) / EP / FSDP / SP on a
("pod",)"data","model" mesh (the port of ``repro/distributed/sharding.py``).

Parameters get a :class:`PartitionSpec` from path-keyword rules; every
2-D+ weight is TP-sharded on its role axis over "model" and FSDP-sharded
over "data" on the other large axis (ZeRO-3 style).  Optimizer state
inherits the parameter sharding.  A spec becomes DTensor placements with
:func:`placements`: one ``Shard(dim)`` or ``Replicate()`` per mesh dim.
DTensor then inserts the collectives where GSPMD would.

A mesh here is a ``DeviceMesh`` (axes from its ``mesh_dim_names``), a
mapping of axis name to size, or any object with such a mapping as
``.shape`` and its axis names as ``.axis_names``: the rules read the axis
sizes only, so a production mesh's specs need no process group.
"""
from __future__ import annotations

import math
from typing import Mapping

from repro_torch.configs.base import ModelConfig, ShapeConfig


class PartitionSpec(tuple):
    """A tuple of mesh axis names (or tuples of them, or ``None``), one
    entry per tensor dim; equal by value to the tuple it holds.  A tuple
    of one axis is that axis, as JAX normalizes it."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, a mapping or an object
    with a mapping ``.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names)
    if hasattr(mesh, "axis_names"):
        return tuple(mesh.axis_names)
    return tuple(axis_sizes(mesh))


def dp_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


# ---------------------------------------------------------------------------
# parameter rules (first match on the joined parameter path wins)
# ---------------------------------------------------------------------------
# fmt: off
_PARAM_RULES = [
    # MoE expert tensors: EP over model, FSDP over d_model
    ("ewi",         {3: P("model", "data", None), 4: P(None, "model", "data", None)}),
    ("ewg",         {3: P("model", "data", None), 4: P(None, "model", "data", None)}),
    ("ewo",         {3: P("model", None, "data"), 4: P(None, "model", None, "data")}),
    ("router",      {2: P("data", "model"), 3: P(None, "data", "model")}),
    ("shared_wi",   {2: P("data", "model"), 3: P(None, "data", "model")}),
    ("shared_wg",   {2: P("data", "model"), 3: P(None, "data", "model")}),
    ("shared_wo",   {2: P("model", "data"), 3: P(None, "model", "data")}),
    # embeddings / lm head: vocab over model, d over data
    ("embed",       {2: P("model", "data")}),
    ("head",        {2: P("model", "data")}),
    ("frontend_proj", {2: P("data", "model")}),
    # dense MLP (gated): D x F over (data, model)
    ("wi",          {2: P("data", "model"), 3: P(None, "data", "model")}),
    ("wg",          {2: P("data", "model"), 3: P(None, "data", "model")}),
    # attention / MLA
    ("wq",          {2: P("data", "model"), 3: P(None, "data", "model"), 4: P(None, None, None, "model")}),
    ("wk",          {2: P("data", "model"), 3: P(None, "data", "model"), 4: P(None, None, None, "model")}),
    ("wv",          {2: P("data", "model"), 3: P(None, "data", "model"), 4: P(None, None, None, "model")}),
    ("wo",          {2: P("model", "data"), 3: P(None, "model", "data")}),
    ("wq_a",        {3: P(None, "data", "model")}),
    ("wq_b",        {3: P(None, "data", "model")}),
    ("wkv_a",       {3: P(None, "data", "model")}),
    ("w_uk",        {4: P(None, None, "model", None)}),
    ("w_uv",        {4: P(None, None, "model", None)}),
    # dense / ssm / xlstm projections
    ("in_proj",     {3: P(None, "data", "model")}),
    ("out_proj",    {3: P(None, "model", "data")}),
    ("up",          {3: P(None, "data", "model")}),
    ("down",        {3: P(None, "model", "data")}),
    ("wx",          {3: P(None, "data", "model")}),
    ("conv",        {3: P(None, None, "model")}),
    # sLSTM recurrent weights stay TP-sharded
    ("r",           {5: P(None, None, None, None, "model")}),
]
# fmt: on


def _spec_for(path: str, ndim: int) -> P:
    for key, by_rank in _PARAM_RULES:
        if f"/{key}" in path or path.endswith(key) or f"{key}/" in path:
            if ndim in by_rank:
                return by_rank[ndim]
    if ndim >= 2:
        # fallback: FSDP-shard the biggest trailing dim over data
        spec = [None] * ndim
        spec[-1] = "data"
        return P(*spec)
    return P()


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _fit_spec(spec: P, shape, mesh) -> P:
    """Drop (replicate) any assignment whose mesh axes do not divide the
    dim evenly, as the reference does for pjit."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axes is None:
            out.append(None)
            continue
        ax_tuple = axes if isinstance(axes, tuple) else (axes,)
        n = int(math.prod(sizes[a] for a in ax_tuple))
        out.append(axes if dim % n == 0 else None)
    return P(*out)


def _drop_axis(spec: P, axis: str) -> P:
    out = []
    for e in spec:
        if e == axis:
            out.append(None)
        elif isinstance(e, tuple):
            keep = tuple(a for a in e if a != axis)
            out.append(keep if keep else None)
        else:
            out.append(e)
    return P(*out)


def flatten_with_path(tree, path=()):
    """``[(path, leaf)]`` in the reference's order (dict keys sorted, as
    ``jax.tree_util`` flattens them; a tuple's entries by index)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def map_with_path(fn, tree, path=()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params_tree, mesh=None, fsdp: bool = True):
    """PartitionSpec tree for a parameter (or optimizer-state) tree.

    ``fsdp=False`` drops the "data" axis from every weight spec (pure TP).
    """
    def one(path, leaf):
        sp = _spec_for(_path_str(path), len(leaf.shape))
        if not fsdp:
            sp = _drop_axis(sp, "data")
        return _fit_spec(sp, leaf.shape, mesh)
    return map_with_path(one, params_tree)


def placements(mesh, spec: P) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim, in
    mesh order, ``Shard(d)`` for the tensor dim ``d`` that names its axis,
    else ``Replicate()``.  A tensor dim that names two axes
    (``("pod", "data")``) is sharded over each, in mesh order, as GSPMD
    shards it."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            by_axis[a] = d
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in axis_names(mesh)]


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------

def _n_dp(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(math.prod(sizes[a] for a in dp_axes(mesh)))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """PartitionSpecs for the input batch tree."""
    dp = dp_axes(mesh)
    n_dp = _n_dp(mesh)
    bdim = dp if shape.global_batch % max(n_dp, 1) == 0 \
        and shape.global_batch >= n_dp else None
    tok = P(bdim, None)
    out = {"tokens": tok, "targets": tok}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = P(bdim, None, "model")
    if cfg.enc_dec:
        out["src_embeds"] = P(bdim, None, "model")
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, cache_tree):
    """Cache shardings: batch over DP, heads/features over TP.  For the
    batch=1 long-context shape, sequence axes are sharded over "data"
    (sequence parallelism) instead."""
    dp = dp_axes(mesh)
    n_dp = _n_dp(mesh)
    n_model = axis_sizes(mesh)["model"]
    seq_par = shape.global_batch < n_dp
    b = None if seq_par else dp

    def spec_for(path, leaf):
        seg = _path_str(path).split("/")[-1]   # "conv" must not match "v"
        nd = len(leaf.shape)
        # leading axis is the stacked layer axis: unsharded
        if seg in ("k", "v"):                            # (L,B,Hkv,S,hd)
            if cfg.n_kv_heads >= n_model:
                return P(None, b, "model", "data" if seq_par else None, None)
            return P(None, b, None, "data" if seq_par else "model", None)
        if seg == "c_kv":                                # (L,B,S,r)
            return P(None, b, "data" if seq_par else None, "model")
        if seg == "k_rope":                              # (L,B,1,S,dr)
            return P(None, b, None, "data" if seq_par else None, None)
        if seg == "ssd":                                 # (L,B,h,P,N)
            return P(None, b, "model", None, None)
        if seg == "conv":                                # (L,B,W,C)
            return P(None, b, None, "model")
        if seg == "C":                                   # (L,B,h,hd,hd)
            return P(None, b, None, "model", None)
        if seg == "n" and nd == 4:                       # mlstm n (L,B,h,hd)
            return P(None, b, None, "model")
        if nd == 3 and leaf.shape[-1] == cfg.d_model:    # slstm states (L,B,d)
            return P(None, b, "model")
        if nd >= 3:
            return P(None, b, *([None] * (nd - 2)))
        return P()

    return map_with_path(spec_for, cache_tree)


def scalar_spec():
    return P()
