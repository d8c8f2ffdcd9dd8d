"""The benchmark's own weights and prompts, drawn on the device from the
run's seed.

The program's parameter tree, built on the ``meta`` device, gives the
shapes and types; every leaf is then drawn, in the order of its path, by
one ``torch.Generator`` on the run's device, in the type it is served in:
one call a leaf, each leaf stacked over the layers.  The program and the
reference are handed the same tensors.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

NORM_LEAVES = ("scale", "q_norm", "k_norm", "kv_norm")


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` in order of path; tuples by index."""
    items = (enumerate(tree) if isinstance(tree, (tuple, list))
             else sorted(tree.items()))
    for k, v in items:
        path = f"{prefix}/{k}"
        if isinstance(v, (dict, tuple, list)):
            yield from leaves(v, path)
        else:
            yield path, v


def fan_in(path: str, shape) -> int:
    """The length each of a weight's outputs sums over: the model dim of
    the embedding and of the head (used transposed), the latent of MLA's
    up-projections (latent, heads, dim), else the weight's rows."""
    name = path.rsplit("/", 1)[-1]
    if name in ("embed", "head"):
        return shape[-1]
    if name in ("w_uk", "w_uv"):
        return shape[-3]
    return shape[-2]


def _map(tree, fn, prefix=""):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}") for k, v in tree.items()}
    return fn(prefix, tree)


def draw_params(shapes, gen: torch.Generator, device) -> dict:
    """A tree like ``shapes`` (a tree of ``meta`` tensors) on ``device``:
    weights normal with a standard deviation of ``fan_in ** -0.5``, norm
    scales ``1 + 0.1 * normal``, biases ``0.1 * normal``.  Every leaf is
    drawn from ``gen`` in order of path, whatever the tree's insertion
    order."""
    out = {}
    for path, meta in leaves(shapes):
        t = torch.randn(tuple(meta.shape), generator=gen, device=device,
                        dtype=meta.dtype)
        name = path.rsplit("/", 1)[-1]
        if name in NORM_LEAVES:
            t.mul_(0.1).add_(1.0)
        elif name == "bias":
            t.mul_(0.1)
        else:
            t.mul_(fan_in(path, meta.shape) ** -0.5)
        out[path] = t
    return _map(shapes, lambda path, _: out[path])


def draw_prompts(gen: torch.Generator, device, pool: int, batch: int,
                 seq: int, vocab: int) -> torch.Tensor:
    """(pool, batch, seq) token ids, uniform over the vocabulary."""
    return torch.randint(0, vocab, (pool, batch, seq), generator=gen,
                         device=device)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
