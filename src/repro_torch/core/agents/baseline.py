"""The heuristic baseline as an agent: the stand-in for LLVM's fixed cost
model (paper Fig. 7's 1.0x reference bar); the port of
``repro/core/agents/baseline.py``.  ``act`` maps each site's heuristic
baseline tiles onto the nearest action-grid indices, one vectorized pass
per site kind."""
from __future__ import annotations

import numpy as np

from repro_torch.core import costmodel_vec
from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state


class BaselineHeuristicAgent:
    name = "baseline"

    def __init__(self, space=None):
        self.space = space

    def fit(self, sites, oracle, **_) -> "BaselineHeuristicAgent":
        if self.space is None:
            self.space = oracle.space
        return self

    def state_dict(self) -> dict:
        """Versioned empty state (the fixed heuristic learns nothing)."""
        return {"version": AGENT_STATE_VERSION, "name": self.name}

    def load_state(self, state: dict) -> "BaselineHeuristicAgent":
        check_agent_state(state, self.name)
        return self

    def act(self, sites, *, sample: bool = False, legal=None) -> np.ndarray:
        """(n, 3) action indices of the baseline tiles.  With ``legal``
        ((n, A) bool over flat actions) a baseline action that is not
        legal raises ``ValueError``: the heuristic has no other pick."""
        if self.space is None:
            raise RuntimeError("BaselineHeuristicAgent.act before fit "
                               "(no ActionSpace)")
        tiles = costmodel_vec.baseline_tiles_batch(sites)
        out = np.zeros((len(sites), 3), np.int64)
        for kind, idx in costmodel_vec.group_by_kind(sites).items():
            for d, opts in enumerate(self.space.choices(kind)):
                opts_a = np.asarray(opts, np.int64)
                # exact match when the tile is a choice, else nearest
                out[idx, d] = np.abs(opts_a[None, :]
                                     - tiles[idx, d][:, None]).argmin(1)
        if legal is not None:
            legal = np.asarray(legal, bool)
            for i, s in enumerate(sites):
                s0, s1, s2 = self.space.valid_sizes(s.kind)
                a = out[i]
                if not legal[i, (a[0] * s1 + a[1]) * s2 + a[2]]:
                    raise ValueError(f"the baseline tile of site {s.key()} "
                                     f"is not legal")
        return out
