"""Brute-force search over the full factor space (the paper's oracle and
the label source for the supervised methods, §3.5); the port of
``repro/core/agents/brute.py``.

The search is one argmin over the oracle's ``cost_grid``, whichever the
oracle: the cost model (:class:`~repro_torch.core.env.CostModelEnv`) or
the kernels' timings (:class:`~repro_torch.core.env.MeasuredEnv`, which
times every tile its legality admits, so that brute force takes the
fastest timed tile at each site).  Flat action order is the reference's,
so ties break alike.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import costmodel_vec
from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state
from repro_torch.models.compute import KernelSite


def brute_force_action(oracle, site: KernelSite
                       ) -> Tuple[Tuple[int, int, int], float]:
    """Exhaustive argmin of cost.  Returns (action_indices, best_cost);
    best_cost is ``inf`` when every tile is illegal."""
    grid = oracle.cost_grid([site])[0]
    flat = int(np.argmin(grid))
    return oracle.space.unflatten(site.kind, flat), float(grid[flat])


def _labels(space, sites, grid) -> np.ndarray:
    out = np.zeros((len(sites), 3), np.int32)
    flat = grid.argmin(1)
    for kind, idx in costmodel_vec.group_by_kind(sites).items():
        out[idx] = space.unflatten_batch(kind, flat[idx])
    return out


def brute_force_labels(oracle, sites: List[KernelSite]) -> np.ndarray:
    """(n_sites, 3) optimal action indices — brute-force labels: one
    ``cost_grid`` and a row argmin (the padding columns are ``inf`` and
    never win; a row with no legal tile labels action 0, as the
    reference's)."""
    if not len(sites):
        return np.zeros((0, 3), np.int32)
    return _labels(oracle.space, sites, oracle.cost_grid(sites))


def brute_force_costs(oracle, sites: List[KernelSite]) -> np.ndarray:
    """(n_sites,) best achievable cost per site (the oracle's runtime)."""
    if not len(sites):
        return np.zeros((0,), np.float64)
    return oracle.cost_grid(sites).min(1)


def n_evaluations(oracle, sites) -> int:
    """How many compile+run evaluations brute force costs (the paper's
    35x-more-samples claim)."""
    return sum(oracle.space.n_actions(s.kind) for s in sites)


class BruteForceAgent:
    """The exhaustive-search method behind the agent surface.

    ``fit`` captures the oracle (brute force has nothing to learn); ``act``
    is the cost-grid argmin.  Without an oracle it builds a cost-model one
    (the port's default legality, ``"h100"``)."""

    name = "brute"

    def __init__(self, cfg=None, oracle=None):
        self._cfg = cfg
        self.oracle = oracle

    def _ensure_oracle(self):
        if self.oracle is None:
            from repro_torch.configs.neurovec import DEFAULT
            from repro_torch.core.env import CostModelEnv
            self.oracle = CostModelEnv(self._cfg or DEFAULT)
        return self.oracle

    def fit(self, sites, oracle, **_) -> "BruteForceAgent":
        self.oracle = oracle
        return self

    def state_dict(self) -> dict:
        """Versioned empty state: the search has nothing learned."""
        return {"version": AGENT_STATE_VERSION, "name": self.name}

    def load_state(self, state: dict) -> "BruteForceAgent":
        check_agent_state(state, self.name)
        return self

    def act(self, sites, *, sample: bool = False, legal=None) -> np.ndarray:
        """(n, 3) action indices.  ``legal`` ((n, A) bool, laid out as
        ``cost_grid``) limits the argmin to those actions; a site with no
        legal action of finite cost raises ``ValueError``."""
        oracle = self._ensure_oracle()
        if legal is None:
            return brute_force_labels(oracle, sites).astype(np.int64)
        if not len(sites):
            return np.zeros((0, 3), np.int64)
        grid = oracle.cost_grid(sites)
        grid = np.where(np.asarray(legal, bool)[:, :grid.shape[1]], grid,
                        np.inf)
        for s, row in zip(sites, grid):
            if not np.isfinite(row).any():
                raise ValueError(f"no legal action for site {s.key()}")
        return _labels(oracle.space, sites, grid).astype(np.int64)
