"""``SurrogateOracle``: the learned cost model behind the Oracle protocol
(the port of ``repro/surrogate/oracle.py``).

Structurally a :class:`~repro_torch.core.env.CostModelEnv` whose cost
source is the trained :class:`~repro_torch.surrogate.model.SurrogateModel`
instead of the analytic formulas: the same batched surface
(``costs_batch`` / ``baseline_costs`` / ``rewards_batch`` /
``speedups_batch`` / ``cost_grid`` / ``tiles_costs``), the same ``inf`` =
illegal masking and the same eq. 2 reward, so every agent and the facade
run against it unchanged.

``legality`` picks the illegal tiles, as for ``CostModelEnv``: under
``"h100"`` (the default) a tile the Hopper kernels cannot launch is never
priced by the network, under ``"tpu_v5e"`` the reference's VMEM rule
applies.  Per-key results are cached, so repeated sweeps run no
inference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.core import costmodel_vec
from repro_torch.core.costmodel import DEFAULT_LEGALITY
from repro_torch.core.env import CostModelEnv
from repro_torch.models.site import KernelSite
from repro_torch.surrogate.model import SurrogateModel


class SurrogateOracle(CostModelEnv):
    """Oracle pricing every query with the learned surrogate."""

    def __init__(self, nv_cfg: NeuroVecConfig, model: SurrogateModel,
                 seed: int = 0, legality: str = DEFAULT_LEGALITY):
        super().__init__(nv_cfg, seed=seed, legality=legality)
        self.model = model
        self._result_cache: Dict[Tuple[str, Tuple[int, int, int]],
                                 float] = {}

    def clear_result_cache(self) -> None:
        self._result_cache.clear()

    # -- the surrogate cost of explicit tiles --------------------------------
    def _surrogate_costs(self, sites, tiles) -> np.ndarray:
        """(n,) predicted seconds; ``inf`` = illegal tile."""
        tiles = np.asarray(tiles, np.int64)
        keys = [(s.key(), (int(t[0]), int(t[1]), int(t[2])))
                for s, t in zip(sites, tiles)]
        first = {}
        for i, k in enumerate(keys):
            if k not in self._result_cache and k not in first:
                first[k] = i
        miss = list(first.values())
        if miss:
            vals = self.model.predict_seconds(
                [sites[i] for i in miss], tiles[miss], self.legality)
            for i, v in zip(miss, vals):
                self._result_cache[keys[i]] = float(v)
        return np.array([self._result_cache[k] for k in keys], np.float64)

    # -- Oracle surface (surrogate-priced) -----------------------------------
    def costs_batch(self, sites, actions) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        tiles = costmodel_vec.tiles_for_actions(self.space, sites, actions)
        return self._surrogate_costs(sites, tiles)

    def baseline_costs(self, sites) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        return self._surrogate_costs(
            sites, costmodel_vec.baseline_tiles_batch(sites))

    def baseline_cost(self, site: KernelSite) -> float:
        return float(self.baseline_costs([site])[0])

    def cost(self, site: KernelSite,
             action: Sequence[int]) -> Optional[float]:
        c = float(self.costs_batch([site], np.asarray([action]))[0])
        return None if math.isinf(c) else c

    def tiles_costs(self, sites, tiles) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        t = np.asarray(tiles, np.int64)
        if t.ndim != 2 or t.shape[0] != len(sites):
            raise ValueError(f"tiles must be (n_sites, k), got {t.shape}")
        if t.shape[1] < 3:
            t = np.concatenate(
                [t, np.ones((len(t), 3 - t.shape[1]), np.int64)], 1)
        return self._surrogate_costs(sites, t)

    def cost_grid(self, sites) -> np.ndarray:
        groups = costmodel_vec.group_by_kind(sites)
        a_max = max((self.space.n_actions(k) for k in groups), default=0)
        out = np.full((len(sites), a_max), np.inf, np.float64)
        for kind, idx in groups.items():
            tg = costmodel_vec.action_tiles_grid(self.space, kind)
            rep_sites = [sites[i] for i in idx for _ in range(len(tg))]
            rep_tiles = np.tile(tg, (len(idx), 1))
            out[idx, :len(tg)] = self._surrogate_costs(
                rep_sites, rep_tiles).reshape(len(idx), len(tg))
        return out
