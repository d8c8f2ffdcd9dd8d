"""Nearest-neighbour search on the learned code embeddings (paper §3.5):
the embedding generator is frozen and NNS predicts the brute-force label
of the closest training site; the port of ``repro/core/agents/nns.py``."""
from __future__ import annotations

import numpy as np

from repro_torch.core.agents.brute import brute_force_labels
from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state


class NNSAgent:
    """``fit(sites, oracle)`` labels the training sites by brute force over
    the oracle's cost grid (``labels=`` reuses precomputed ones) and
    freezes their embeddings; ``act`` is one cosine argmax.  ``space``
    (the registry passes the config's) lays out the ``legal`` mask; a fit
    without one takes the oracle's."""

    name = "nns"

    def __init__(self, embed_fn=None, space=None):
        self.embed_fn = embed_fn
        self.space = space
        self.keys = None
        self.labels = None
        self.train_kinds = None

    def fit(self, sites, oracle, labels=None, **_) -> "NNSAgent":
        if self.embed_fn is None:
            raise ValueError("NNSAgent needs an embed_fn "
                             "(e.g. PPOAgent.code_vectors)")
        if labels is None:
            labels = brute_force_labels(oracle, sites)
        if self.space is None:
            self.space = oracle.space
        self.keys = self._norm(np.asarray(self.embed_fn(sites)))
        self.labels = np.asarray(labels, np.int64)
        self.train_kinds = np.array([s.kind for s in sites])
        return self

    @staticmethod
    def _norm(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-9)

    def state_dict(self) -> dict:
        """The frozen training embeddings and their labels (the embed_fn
        is rebuilt from the construction seed, not serialized)."""
        st = {"version": AGENT_STATE_VERSION, "name": self.name,
              "fitted": self.keys is not None}
        if self.keys is not None:
            st["keys"] = np.asarray(self.keys)
            st["labels"] = np.asarray(self.labels, np.int64)
            st["train_kinds"] = [str(k) for k in self.train_kinds]
        return st

    def load_state(self, state: dict) -> "NNSAgent":
        check_agent_state(state, self.name)
        if state["fitted"]:
            # keys keep their saved dtype: a cast could move argmax ties
            self.keys = np.asarray(state["keys"])
            self.labels = np.asarray(state["labels"], np.int64)
            self.train_kinds = np.array([str(k)
                                         for k in state["train_kinds"]])
        else:
            self.keys = self.labels = self.train_kinds = None
        return self

    def act(self, sites, *, sample: bool = False, legal=None) -> np.ndarray:
        """(n, 3) label of each site's nearest same-kind training site.
        With ``legal`` ((n, A) bool over flat actions) only neighbours
        whose label is legal at the site count (under
        ``legality="h100"``: a tile the kernels launch there); a site with
        no such neighbour raises ``ValueError``."""
        if self.keys is None:
            raise RuntimeError("NNSAgent.act before fit")
        q = self._norm(np.asarray(self.embed_fn(sites)))
        sims = q @ self.keys.T                        # (B, n_train) cosine
        kinds = np.array([s.kind for s in sites])
        match = kinds[:, None] == self.train_kinds[None, :]
        if legal is not None:
            if self.space is None:
                raise RuntimeError("NNSAgent.act with legal= needs an "
                                   "ActionSpace (construct with space=)")
            legal = np.asarray(legal, bool)
            lab = self.labels
            for i, s in enumerate(sites):
                _, s1, s2 = self.space.valid_sizes(s.kind)
                cand = np.flatnonzero(match[i])
                flat = (lab[cand, 0] * s1 + lab[cand, 1]) * s2 + lab[cand, 2]
                match[i, cand] = legal[i, flat]
                if not match[i].any():
                    raise ValueError(f"no training label is legal at site "
                                     f"{s.key()}")
        nn = np.where(match, sims, -np.inf).argmax(1)
        return self.labels[nn]
