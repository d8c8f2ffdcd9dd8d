"""The contextual-bandit environment (paper §3.3–3.4), the port of
``repro/core/env.py`` (``ActionSpace`` and ``CostModelEnv``; the measured
oracle waits).

State  = kernel site; Action = joint discrete factor indices
(i_bm, i_bn, i_bk) for matmul, (i_bq, i_bkv, ·) for attention, (i_chunk,
·, ·) for chunk scans; Reward = (t_baseline − t_action) / t_baseline
(eq. 2) with the −9 penalty for an illegal tile.  ``legality`` picks what
is illegal (see :mod:`repro_torch.core.costmodel`); the time formula is the
reference's TPU v5e model either way.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.core import costmodel, costmodel_vec
from repro_torch.models.compute import KernelSite

_STRICT_ACTIONS = os.environ.get("REPRO_STRICT_ACTIONS", "0") == "1"


def set_strict_actions(on: bool) -> None:
    global _STRICT_ACTIONS
    _STRICT_ACTIONS = bool(on)


@dataclass(frozen=True)
class ActionSpace:
    """Per-kind factor arrays + unified 3-head indexing with masking."""

    cfg: NeuroVecConfig

    def choices(self, kind: str) -> Tuple[Tuple[int, ...], ...]:
        c = self.cfg
        if kind == "matmul":
            return (c.bm_choices, c.bn_choices, c.bk_choices)
        if kind == "attention":
            return (c.bq_choices, c.bkv_choices, (1,))
        if kind == "chunk_scan":
            return (c.chunk_choices, (1,), (1,))
        raise ValueError(kind)

    @property
    def head_sizes(self) -> Tuple[int, int, int]:
        c = self.cfg
        return (max(len(c.bm_choices), len(c.bq_choices),
                    len(c.chunk_choices)),
                max(len(c.bn_choices), len(c.bkv_choices)),
                len(c.bk_choices))

    def valid_sizes(self, kind: str) -> Tuple[int, int, int]:
        return tuple(len(x) for x in self.choices(kind))

    def strict_enabled(self, strict: Optional[bool]) -> bool:
        if strict is not None:
            return strict
        return _STRICT_ACTIONS or getattr(self.cfg, "strict_actions", False)

    def tiles(self, kind: str, action: Sequence[int],
              strict: Optional[bool] = None) -> Tuple[int, ...]:
        ch = self.choices(kind)
        if self.strict_enabled(strict):
            for d in range(3):
                if not 0 <= int(action[d]) < len(ch[d]):
                    raise IndexError(
                        f"action index {int(action[d])} out of range "
                        f"[0, {len(ch[d])}) for head {d} of kind {kind!r}")
        return tuple(ch[d][min(int(action[d]), len(ch[d]) - 1)]
                     for d in range(3))

    def n_actions(self, kind: str) -> int:
        return int(np.prod(self.valid_sizes(kind)))

    def unflatten(self, kind: str, flat: int) -> Tuple[int, int, int]:
        s = self.valid_sizes(kind)
        return (flat // (s[1] * s[2]), (flat // s[2]) % s[1], flat % s[2])


class CostModelEnv:
    """Reward oracle backed by the analytic cost model.

    ``legality="h100"`` (the default, and the serve path's) prices a tile
    the Hopper kernels cannot launch as illegal; ``"tpu_v5e"`` reproduces
    the reference's VMEM rule exactly."""

    def __init__(self, nv_cfg: NeuroVecConfig, seed: int = 0,
                 legality: str = costmodel.DEFAULT_LEGALITY):
        self.cfg = nv_cfg
        self.space = ActionSpace(nv_cfg)
        self.legality = costmodel.check_legality(legality)
        self._rng = np.random.default_rng(seed)
        self._baseline_cache: Dict[str, float] = {}

    # -- baseline cache ----------------------------------------------------
    def baseline_cost(self, site: KernelSite) -> float:
        key = site.key()
        c = self._baseline_cache.get(key)
        if c is None:
            c = costmodel.baseline_cost(site, self.legality)
            self._baseline_cache[key] = c
        return c

    def baseline_costs(self, sites: Sequence[KernelSite]) -> np.ndarray:
        keys = [s.key() for s in sites]
        missing = [i for i, k in enumerate(keys)
                   if k not in self._baseline_cache]
        if missing:
            fresh = costmodel_vec.baseline_costs([sites[i] for i in missing],
                                                 self.legality)
            for i, c in zip(missing, fresh):
                self._baseline_cache[keys[i]] = float(c)
        return np.array([self._baseline_cache[k] for k in keys], np.float64)

    # -- the paper's eq. 2 --
    def reward(self, site: KernelSite, action: Sequence[int]) -> float:
        t = self.cost(site, action)
        if t is None:
            return float(self.cfg.fail_penalty)
        t_base = self.baseline_cost(site)
        if not math.isfinite(t_base):
            return float(self.cfg.fail_penalty)
        if self.cfg.reward_noise > 0:
            t *= float(np.exp(self._rng.normal(0, self.cfg.reward_noise)))
        return float((t_base - t) / t_base)

    def cost(self, site: KernelSite, action: Sequence[int]) -> Optional[float]:
        return costmodel.site_cost(site, self.space.tiles(site.kind, action),
                                   self.legality)

    def speedup(self, site: KernelSite, action: Sequence[int]) -> float:
        t = self.cost(site, action)
        t_base = self.baseline_cost(site)
        if t is None or not math.isfinite(t_base):
            return 1.0 / float(self.cfg.illegal_slowdown)
        return float(t_base / t)

    # -- batched fast paths -------------------------------------------------
    def costs_batch(self, sites, actions) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        return costmodel_vec.costs_for_actions(self.space, sites, actions,
                                               self.legality)

    def rewards_batch(self, sites, actions) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float32)
        t = self.costs_batch(sites, actions)
        t_base = self.baseline_costs(sites)
        if self.cfg.reward_noise > 0:
            legal = np.isfinite(t)
            t = t.copy()
            t[legal] *= np.exp(self._rng.normal(
                0, self.cfg.reward_noise, size=int(legal.sum())))
        with np.errstate(invalid="ignore", divide="ignore"):
            r = np.where(np.isfinite(t) & np.isfinite(t_base),
                         (t_base - t) / t_base,
                         float(self.cfg.fail_penalty))
        return r.astype(np.float32)

    def speedups_batch(self, sites, actions) -> np.ndarray:
        t = self.costs_batch(sites, actions)
        t_base = self.baseline_costs(sites)
        return np.where(np.isfinite(t) & np.isfinite(t_base),
                        t_base / np.maximum(t, 1e-300),
                        1.0 / float(self.cfg.illegal_slowdown))

    def cost_grid(self, sites) -> np.ndarray:
        return costmodel_vec.cost_grid(self.space, sites, self.legality)

    def tiles_costs(self, sites, tiles) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        return costmodel_vec.costs_for_tiles(sites, tiles, self.legality)
