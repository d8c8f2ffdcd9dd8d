"""The decision methods of paper §3.5 behind one Agent protocol and a
string-keyed registry (the port of ``repro/core/agents/__init__.py``).

``make_agent(name, cfg, seed=...)`` builds any of the seven methods:
``ppo`` (deep RL), ``dtree``/``nns`` (supervised on brute-force labels),
``brute`` (exhaustive oracle), ``random``, ``polly`` (mem-only heuristic)
and ``baseline`` (the fixed LLVM-cost-model stand-in).  Each satisfies
:class:`repro_torch.core.protocols.Agent`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core.agents.baseline import BaselineHeuristicAgent
from repro_torch.core.agents.brute import (BruteForceAgent,
                                           brute_force_action,
                                           brute_force_costs,
                                           brute_force_labels, n_evaluations)
from repro_torch.core.agents.dtree import DecisionTreeAgent
from repro_torch.core.agents.nns import NNSAgent
from repro_torch.core.agents.polly import PollyAgent
from repro_torch.core.agents.ppo import PPOAgent
from repro_torch.core.agents.random_search import RandomAgent
from repro_torch.core.env import ActionSpace
from repro_torch.device import resolve_device

AGENT_NAMES = ("ppo", "dtree", "nns", "brute", "random", "polly",
               "baseline")


def embed_fn_from_params(params):
    """``sites -> (n, EMBED_DIM)`` f32 numpy code vectors from a frozen
    embedder's parameters (tensors on one device)."""
    from repro_torch.core import embedding as emb
    dev = params["W"].device

    @torch.no_grad()
    def embed(sites):
        ctx, mask = emb.featurize_batch(sites)
        return emb.embed_sites(
            params, torch.as_tensor(ctx, dtype=torch.long, device=dev),
            torch.as_tensor(mask, device=dev)).cpu().numpy()

    return embed


def default_embed_fn(seed: int = 0, device="cuda"):
    """A frozen randomly initialised code2vec embedder, the stand-in
    ``nns``/``dtree`` use when no trained one is given (pass
    ``embed_fn=ppo.code_vectors`` for the paper's frozen-after-RL setup).
    Its params are drawn by a ``torch.Generator`` seeded with ``seed`` on
    ``device``: the reference draws them with ``jax.random.PRNGKey(seed)``,
    a stream torch cannot reproduce, so at the same seed the two embed
    differently.  To embed as the reference does, carry its params across
    (``convert.embedder_from_jax``, then :func:`embed_fn_from_params`)."""
    from repro_torch.core import embedding as emb
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return embed_fn_from_params(emb.embedder_init(gen, dev))


def make_agent(name: str, cfg: NeuroVecConfig = DEFAULT, *, seed: int = 0,
               device="cuda", **kwargs):
    """Construct a registered agent by name.  ``device`` is where PPO's
    network and the default embedder of ``nns``/``dtree`` live (the card
    unless ``"cpu"`` is asked for); the other methods compute in NumPy.
    Extra ``kwargs`` flow to the constructor (``mode=``/``lr=`` for ppo,
    ``embed_fn=`` for nns/dtree, ``oracle=`` for brute, ``max_depth=``
    for dtree)."""
    if name == "ppo":
        return PPOAgent(cfg, seed=seed, device=str(device), **kwargs)
    if name == "dtree":
        embed_fn = kwargs.pop("embed_fn", None) or default_embed_fn(seed,
                                                                    device)
        return DecisionTreeAgent(embed_fn, seed=seed, **kwargs)
    if name == "nns":
        embed_fn = kwargs.pop("embed_fn", None) or default_embed_fn(seed,
                                                                    device)
        return NNSAgent(embed_fn, space=ActionSpace(cfg), **kwargs)
    if name == "brute":
        return BruteForceAgent(cfg=cfg, **kwargs)
    if name == "random":
        return RandomAgent(ActionSpace(cfg), seed=seed, **kwargs)
    if name == "polly":
        return PollyAgent(ActionSpace(cfg), **kwargs)
    if name == "baseline":
        return BaselineHeuristicAgent(ActionSpace(cfg), **kwargs)
    raise ValueError(
        f"unknown agent {name!r}; registered: {', '.join(AGENT_NAMES)}")


__all__ = ["AGENT_NAMES", "make_agent", "default_embed_fn",
           "embed_fn_from_params", "PPOAgent", "BruteForceAgent",
           "DecisionTreeAgent", "NNSAgent", "PollyAgent", "RandomAgent",
           "BaselineHeuristicAgent", "brute_force_action",
           "brute_force_labels", "brute_force_costs", "n_evaluations"]
