"""CART decision tree on the learned code embeddings (paper §3.5, Fig. 7);
the port of ``repro/core/agents/dtree.py``.

A NumPy classification tree over the flattened action index, trained on
brute-force labels, one tree per site kind.  Growth is the reference's
step for step (Gini gain over the quartiles of a ``default_rng(seed)``
feature subsample), so on the same embeddings the trees are equal node for
node.  Each node the port grows also keeps its labels ranked by frequency
(``"ranked"`` in the state), which ``act`` needs to take the most frequent
*legal* label; a tree loaded from the reference has no ranking.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state


@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    label: int = 0
    ranked: Optional[List[int]] = field(default=None)


def _gini(y, n_classes):
    if len(y) == 0:
        return 0.0
    counts = np.bincount(y, minlength=n_classes)
    p = counts / len(y)
    return 1.0 - (p * p).sum()


def _ranked(counts) -> List[int]:
    """The labels present, most frequent first (ties: the smaller label,
    as ``bincount().argmax()`` breaks them)."""
    present = np.flatnonzero(counts)
    return [int(c) for c in present[np.argsort(-counts[present],
                                               kind="stable")]]


def _build(X, y, n_classes, depth, max_depth, min_samples, rng):
    counts = np.bincount(y, minlength=n_classes)
    node = _Node(label=int(counts.argmax()), ranked=_ranked(counts))
    if depth >= max_depth or len(y) < min_samples or len(np.unique(y)) == 1:
        return node
    best_gain, best = 0.0, None
    parent = _gini(y, n_classes)
    # a random feature subsample keeps this O(n log n)-ish at 340 dims
    feats = rng.choice(X.shape[1], size=min(48, X.shape[1]), replace=False)
    for f in feats:
        vals = X[:, f]
        qs = np.quantile(vals, (0.25, 0.5, 0.75))
        for t in qs:
            m = vals <= t
            if m.sum() < 2 or (~m).sum() < 2:
                continue
            g = parent - (m.mean() * _gini(y[m], n_classes)
                          + (~m).mean() * _gini(y[~m], n_classes))
            if g > best_gain:
                best_gain, best = g, (f, t, m)
    if best is None:
        return node
    f, t, m = best
    node.feature, node.thresh = int(f), float(t)
    node.left = _build(X[m], y[m], n_classes, depth + 1, max_depth,
                       min_samples, rng)
    node.right = _build(X[~m], y[~m], n_classes, depth + 1, max_depth,
                        min_samples, rng)
    return node


def _path(node, x) -> List[_Node]:
    """The nodes from the root down to ``x``'s leaf."""
    out = [node]
    while node.feature >= 0:
        node = node.left if x[node.feature] <= node.thresh else node.right
        out.append(node)
    return out


def _node_to_dict(node: _Node) -> dict:
    d = {"f": node.feature, "t": node.thresh, "label": node.label}
    if node.ranked is not None:
        d["ranked"] = list(node.ranked)
    if node.feature >= 0:
        d["left"] = _node_to_dict(node.left)
        d["right"] = _node_to_dict(node.right)
    return d


def _node_from_dict(d: dict) -> _Node:
    node = _Node(feature=int(d["f"]), thresh=float(d["t"]),
                 label=int(d["label"]),
                 ranked=([int(c) for c in d["ranked"]] if "ranked" in d
                         else None))
    if node.feature >= 0:
        node.left = _node_from_dict(d["left"])
        node.right = _node_from_dict(d["right"])
    return node


class DecisionTreeAgent:
    """``fit(sites, oracle)`` labels the training sites by brute force over
    the oracle's cost grid (``labels=`` reuses precomputed ones) and grows
    one tree per site kind."""

    name = "dtree"

    def __init__(self, embed_fn=None, max_depth: int = 12,
                 min_samples: int = 4, seed: int = 0):
        self.embed_fn = embed_fn
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.seed = seed
        self.space = None
        self.trees = {}

    def fit(self, train_sites, oracle, labels=None,
            **_) -> "DecisionTreeAgent":
        if self.embed_fn is None:
            raise ValueError("DecisionTreeAgent needs an embed_fn "
                             "(e.g. PPOAgent.code_vectors)")
        if labels is None:
            from repro_torch.core.agents.brute import brute_force_labels
            labels = brute_force_labels(oracle, train_sites)
        labels = np.asarray(labels)
        self.space = oracle.space
        self.trees = {}
        X = np.asarray(self.embed_fn(train_sites))
        rng = np.random.default_rng(self.seed)
        for kind in sorted({s.kind for s in train_sites}):
            idx = [i for i, s in enumerate(train_sites) if s.kind == kind]
            sizes = self.space.valid_sizes(kind)
            flat = (labels[idx, 0] * sizes[1] * sizes[2]
                    + labels[idx, 1] * sizes[2] + labels[idx, 2])
            n_classes = sizes[0] * sizes[1] * sizes[2]
            self.trees[kind] = _build(X[idx], flat.astype(np.int64),
                                      n_classes, 0, self.max_depth,
                                      self.min_samples, rng)
        return self

    def state_dict(self) -> dict:
        """The per-kind trees and the action-space config they unflatten
        through, in the reference's layout (plus each node's ``ranked``
        labels where the port grew it)."""
        from repro_torch.configs.neurovec import cfg_to_dict
        return {"version": AGENT_STATE_VERSION, "name": self.name,
                "trees": {k: _node_to_dict(t) for k, t in self.trees.items()},
                "space_cfg": (cfg_to_dict(self.space.cfg)
                              if self.space is not None else None)}

    def load_state(self, state: dict) -> "DecisionTreeAgent":
        check_agent_state(state, self.name)
        from repro_torch.configs.neurovec import cfg_from_dict
        from repro_torch.core.env import ActionSpace
        self.trees = {k: _node_from_dict(d)
                      for k, d in state["trees"].items()}
        self.space = (ActionSpace(cfg_from_dict(state["space_cfg"]))
                      if state["space_cfg"] is not None else None)
        return self

    def act(self, sites, *, sample: bool = False, legal=None) -> np.ndarray:
        """(n, 3) the label of each site's leaf.  With ``legal`` ((n, A)
        bool over flat actions) the most frequent legal label in the leaf,
        else in its nearest ancestor that holds one (under
        ``legality="h100"``: a tile the kernels launch there); a tree
        without ranked labels (loaded from the reference) offers only each
        node's majority label.  No legal label on the path raises
        ``ValueError``."""
        if not self.trees:
            raise RuntimeError("DecisionTreeAgent.act before fit")
        X = np.asarray(self.embed_fn(sites))
        out = []
        for i, s in enumerate(sites):
            path = _path(self.trees[s.kind], X[i])
            if legal is None:
                flat = path[-1].label
            else:
                row = np.asarray(legal[i], bool)
                flat = next((c for node in reversed(path)
                             for c in (node.ranked or [node.label])
                             if row[c]), None)
                if flat is None:
                    raise ValueError(f"no legal label on the tree path of "
                                     f"site {s.key()}")
            out.append(self.space.unflatten(s.kind, int(flat)))
        return np.array(out, np.int64)
