"""The decision methods of paper §3.5 (the port of
``repro/core/agents/__init__.py``).  ``make_agent(name, cfg, seed=...)``
builds a ported one: ``ppo`` (deep RL), ``brute`` (exhaustive oracle) and
``baseline`` (the fixed LLVM-cost-model stand-in).  The reference's other
four (``dtree``, ``nns``, ``polly``, ``random``) are not ported yet and
raise ``NotImplementedError``."""
from __future__ import annotations

from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core.agents.baseline import BaselineHeuristicAgent
from repro_torch.core.agents.brute import (BruteForceAgent,
                                           brute_force_action,
                                           brute_force_costs,
                                           brute_force_labels, n_evaluations)
from repro_torch.core.agents.ppo import PPOAgent
from repro_torch.core.env import ActionSpace

AGENT_NAMES = ("ppo", "dtree", "nns", "brute", "random", "polly",
               "baseline")
PORTED_AGENTS = ("ppo", "brute", "baseline")


def make_agent(name: str, cfg: NeuroVecConfig = DEFAULT, *, seed: int = 0,
               **kwargs):
    """Construct a ported agent by name.  Extra ``kwargs`` flow to the
    constructor (``mode=``/``lr=``/``device=`` for ppo, ``oracle=`` for
    brute)."""
    if name == "ppo":
        return PPOAgent(cfg, seed=seed, **kwargs)
    if name == "brute":
        return BruteForceAgent(cfg=cfg, **kwargs)
    if name == "baseline":
        return BaselineHeuristicAgent(ActionSpace(cfg), **kwargs)
    if name in AGENT_NAMES:
        raise NotImplementedError(
            f"agent {name!r} is not ported yet; ported: "
            f"{', '.join(PORTED_AGENTS)} (not yet: "
            f"{', '.join(a for a in AGENT_NAMES if a not in PORTED_AGENTS)})")
    raise ValueError(
        f"unknown agent {name!r}; registered: {', '.join(AGENT_NAMES)}")


__all__ = ["AGENT_NAMES", "PORTED_AGENTS", "make_agent", "PPOAgent",
           "BruteForceAgent", "BaselineHeuristicAgent", "brute_force_action",
           "brute_force_labels", "brute_force_costs", "n_evaluations"]
