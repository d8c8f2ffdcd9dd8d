"""Random search: one uniform action per site (paper Fig. 7: it does worse
than the baseline, evidence that the RL policy learned structure); the
port of ``repro/core/agents/random_search.py``.

One ``rng.integers`` draw per site-kind group from
``np.random.default_rng(seed)``, so the stream is the reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import costmodel_vec
from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state


class RandomAgent:
    name = "random"

    def __init__(self, space=None, seed: int = 0):
        self.space = space
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def fit(self, sites, oracle, **_) -> "RandomAgent":
        if self.space is None:
            self.space = oracle.space
        return self

    def state_dict(self) -> dict:
        """The seed is the whole deployable state: ``act(sample=False)``
        redraws from it.  The exploration stream (``sample=True``)
        restarts on load."""
        return {"version": AGENT_STATE_VERSION, "name": self.name,
                "seed": int(self.seed)}

    def load_state(self, state: dict) -> "RandomAgent":
        check_agent_state(state, self.name)
        self.seed = int(state["seed"])
        self.rng = np.random.default_rng(self.seed)
        return self

    def act(self, sites, *, sample: bool = False, legal=None) -> np.ndarray:
        """(n, 3) uniform draws.  ``sample=False`` redraws from the
        construction seed (deterministic).  With ``legal`` ((n, A) bool
        over flat actions) a drawn action that is not legal is replaced by
        a uniform draw among the site's legal actions, from the same
        stream after the reference's draws (so where every drawn action is
        legal the result is the reference's); a site with no legal action
        raises ``ValueError``."""
        if self.space is None:
            raise RuntimeError("RandomAgent.act before fit (no ActionSpace)")
        rng = self.rng if sample else np.random.default_rng(self.seed)
        out = np.zeros((len(sites), 3), np.int64)
        groups = costmodel_vec.group_by_kind(sites)
        for kind, idx in groups.items():
            sizes = np.asarray(self.space.valid_sizes(kind), np.int64)
            out[idx] = rng.integers(0, sizes, size=(len(idx), 3))
        if legal is None:
            return out
        legal = np.asarray(legal, bool)
        for i, s in enumerate(sites):
            _, s1, s2 = self.space.valid_sizes(s.kind)
            row = legal[i, :self.space.n_actions(s.kind)]
            a = out[i]
            if row[(a[0] * s1 + a[1]) * s2 + a[2]]:
                continue
            ok = np.flatnonzero(row)
            if not len(ok):
                raise ValueError(f"no legal action for site {s.key()}")
            out[i] = self.space.unflatten(s.kind, int(rng.choice(ok)))
        return out
