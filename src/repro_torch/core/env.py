"""The contextual-bandit environment (paper §3.3–3.4), the port of
``repro/core/env.py`` (``ActionSpace``, ``CostModelEnv`` and the measured
oracle ``MeasuredEnv``).

State  = kernel site; Action = joint discrete factor indices
(i_bm, i_bn, i_bk) for matmul, (i_bq, i_bkv, ·) for attention, (i_chunk,
·, ·) for chunk scans; Reward = (t_baseline − t_action) / t_baseline
(eq. 2) with the −9 penalty for an illegal tile.  ``legality`` picks what
is illegal (see :mod:`repro_torch.core.costmodel`); the time formula of
``CostModelEnv`` is the reference's TPU v5e model either way, and
``MeasuredEnv`` replaces it with timings of the kernels themselves.
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

    def unflatten_batch(self, kind: str, flat) -> np.ndarray:
        """(n, 3) head indices of flat actions (vectorized ``unflatten``)."""
        s = self.valid_sizes(kind)
        f = np.asarray(flat, np.int64)
        return np.stack([f // (s[1] * s[2]), (f // s[2]) % s[1], f % s[2]],
                        axis=-1)


class CostModelEnv:
    """Reward oracle backed by the analytic cost model.

    ``legality="h100"`` (the default, and the serve path's on the card)
    prices a tile the Hopper kernels cannot launch as illegal, and every
    tile of a site whose dtype or head dim they refuse; ``"cpu"`` is that
    rule without its dtype clause (the serve path's on the CPU);
    ``"tpu_v5e"`` reproduces the reference's VMEM rule exactly.  A site
    whose baseline tile is illegal has an infinite baseline, and every
    action there earns the penalty.

    ``vectorized=True`` (the default) prices batches with the vectorized
    engine and caches each site's baseline; ``vectorized=False`` is the
    reference's scalar path, kept for parity tests and benchmarks:
    ``reward`` and ``speedup`` recompute the baseline on every call,
    ``costs_batch`` and ``rewards_batch`` loop over the sites, and
    ``speedups_batch`` recomputes the baselines.  Both draw the same
    reward noise in the same order."""

    def __init__(self, nv_cfg: NeuroVecConfig, seed: int = 0,
                 legality: str = costmodel.DEFAULT_LEGALITY,
                 vectorized: bool = True):
        self.cfg = nv_cfg
        self.space = ActionSpace(nv_cfg)
        self.legality = costmodel.check_legality(legality)
        self.vectorized = vectorized
        self._rng = np.random.default_rng(seed)
        self._baseline_cache: Dict[str, float] = {}

    # -- baseline cache ----------------------------------------------------
    def _fresh_baseline(self, site: KernelSite) -> float:
        c = costmodel.site_cost(site, costmodel.baseline_tiles(site),
                                self.legality)
        return math.inf if c is None else c

    def baseline_cost(self, site: KernelSite) -> float:
        key = site.key()
        c = self._baseline_cache.get(key)
        if c is None:
            c = self._baseline_cache[key] = self._fresh_baseline(site)
        return c

    def _call_baseline(self, site: KernelSite) -> float:
        """The baseline a scalar call uses: cached, or recomputed on the
        reference's scalar path."""
        return (self.baseline_cost(site) if self.vectorized
                else self._fresh_baseline(site))

    def baseline_costs(self, sites: Sequence[KernelSite]) -> np.ndarray:
        keys = [s.key() for s in sites]
        missing = [i for i, k in enumerate(keys)
                   if k not in self._baseline_cache]
        if missing:
            fresh = costmodel_vec.baseline_costs([sites[i] for i in missing],
                                                 self.legality, strict=False)
            for i, c in zip(missing, fresh):
                self._baseline_cache[keys[i]] = float(c)
        return np.array([self._baseline_cache[k] for k in keys], np.float64)

    def clear_baseline_cache(self) -> None:
        self._baseline_cache.clear()

    # -- the paper's eq. 2 --
    def reward(self, site: KernelSite, action: Sequence[int]) -> float:
        t = self.cost(site, action)
        if t is None:
            return float(self.cfg.fail_penalty)
        t_base = self._call_baseline(site)
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
        t_base = self._call_baseline(site)
        if t is None or not math.isfinite(t_base):
            return 1.0 / float(self.cfg.illegal_slowdown)
        return float(t_base / t)

    # -- batched fast paths -------------------------------------------------
    def costs_batch(self, sites, actions) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        if not self.vectorized:
            return np.array([c if (c := self.cost(s, a)) is not None
                             else np.inf for s, a in zip(sites, actions)],
                            np.float64)
        return costmodel_vec.costs_for_actions(self.space, sites, actions,
                                               self.legality)

    def rewards_batch(self, sites, actions) -> np.ndarray:
        if not self.vectorized:
            return np.array([self.reward(s, a)
                             for s, a in zip(sites, actions)], np.float32)
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
        t_base = (self.baseline_costs(sites) if self.vectorized
                  else np.array([self._fresh_baseline(s) for s in sites]))
        return np.where(np.isfinite(t) & np.isfinite(t_base),
                        t_base / np.maximum(t, 1e-300),
                        1.0 / float(self.cfg.illegal_slowdown))

    def cost_grid(self, sites) -> np.ndarray:
        return costmodel_vec.cost_grid(self.space, sites, self.legality)

    def tiles_costs(self, sites, tiles) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        return costmodel_vec.costs_for_tiles(sites, tiles, self.legality)


class MeasuredEnv(CostModelEnv):
    """Hardware-measurement oracle: eq. 2 priced by wall-clock timings,
    behind the same batched surface as :class:`CostModelEnv`.

    ``measure_fn(sites, tiles) -> (n,) seconds`` is called at most once per
    oracle entry point with every cache-missing, legal ``(site, tile)``
    pair of that batch (``tiles`` an ``(n, 3)`` int array; unused dims are
    1).  Non-finite or non-positive returns mark failed runs and count as
    illegal (a failed *baseline* fails the site closed to the penalty).
    Results, failures included, are cached per ``(site.key(), tiles)`` and
    deduplicated within a batch.

    Tiles illegal under ``legality`` are never sent to the hook: under
    ``"h100"`` a tile the kernels cannot launch is not timed, under
    ``"tpu_v5e"`` the reference's VMEM rule filters, as in the reference.
    With ``measure_fn=None`` every query is priced by the cost model.

    Grid pruning (``prune_topk`` and ``surrogate``): with a trained
    surrogate attached, each site's tile grid, legal under ``legality``,
    is ranked by predicted runtime once, and only the top-k candidates,
    plus the heuristic baseline tile (eq. 2 stays measured against
    measured), are ever sent to the hook; every other pair is priced by
    the surrogate (``surrogate.predict_seconds(sites, tiles, legality)``,
    see :mod:`repro_torch.surrogate`).  Surrogate-priced values never
    reach the hook, so they are never written to a timing DB, and
    :meth:`timed_tiles` leaves them out.  ``pruned_pairs`` counts them.

    Circuit breaker: when the hook raises, or ``breaker_threshold``
    (default 2, at least 1) consecutive batches come back with every pair failed, the breaker
    opens and the oracle prices with the cost model instead of feeding
    all-penalty rewards into training; ``health()`` is ``"degraded"``
    while it is open, and cached failures from the collapse are purged.
    It stays open until :meth:`reset_breaker`.
    """

    #: a down transport degrades this oracle rather than stopping tuning
    can_degrade = True

    def __init__(self, nv_cfg: NeuroVecConfig, measure_fn=None,
                 seed: int = 0,
                 legality: str = costmodel.DEFAULT_LEGALITY,
                 prune_topk: Optional[int] = None, surrogate=None, *,
                 breaker_threshold: int = 2):
        super().__init__(nv_cfg, seed=seed, legality=legality,
                         vectorized=True)
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if prune_topk is not None and prune_topk < 1:
            raise ValueError(f"prune_topk must be >= 1, got {prune_topk}")
        self.measure_fn = measure_fn
        self.prune_topk = prune_topk
        self.surrogate = surrogate
        self._allowed_cache: Dict[str, frozenset] = {}
        self._priced: set = set()       # keys priced by the surrogate
        self.breaker_threshold = breaker_threshold
        self.breaker_open = False
        self.degraded_reason: Optional[str] = None
        self._consec_failed_batches = 0
        self._result_cache: Dict[Tuple[str, Tuple[int, int, int]],
                                 float] = {}
        self.measure_calls = 0          # hook invocations
        self.measured_pairs = 0         # (site, tile) pairs sent to the hook
        self.pruned_pairs = 0           # pairs priced by the surrogate

    def clear_result_cache(self) -> None:
        self._result_cache.clear()
        self._priced.clear()

    def health(self) -> str:
        return "degraded" if self.breaker_open else "ok"

    def _trip_breaker(self, reason: str) -> None:
        self.breaker_open = True
        self.degraded_reason = reason
        # failures cached during the collapse are artifacts of the dead
        # measurement path: purge them so queries re-price with the model
        for k in [k for k, v in self._result_cache.items()
                  if not math.isfinite(v)]:
            del self._result_cache[k]

    def reset_breaker(self) -> None:
        """Re-arm measurement after the backend recovers."""
        self.breaker_open = False
        self.degraded_reason = None
        self._consec_failed_batches = 0

    def timed_tiles(self, site: KernelSite) -> Dict[Tuple[int, ...], float]:
        """Every tile of ``site`` this oracle holds a finite price for
        (measured, or modelled while degraded; not surrogate-priced), with
        its seconds."""
        key = site.key()
        return {t: v for (k, t), v in self._result_cache.items()
                if k == key and math.isfinite(v)
                and (k, t) not in self._priced}

    # -- surrogate grid pruning ---------------------------------------------
    @property
    def prune_active(self) -> bool:
        """Pruning needs a budget, a trained surrogate and a measurement
        path to save work on."""
        return (self.prune_topk is not None and self.surrogate is not None
                and self.measure_fn is not None)

    def _allowed_tiles(self, site: KernelSite) -> frozenset:
        """The measurable tile set of ``site``: the surrogate's top-k of
        the action grid legal under this env's ``legality`` (the
        reference ranks the grid legal under the TPU rule; here a slot
        never goes to a tile the kernels cannot launch), plus the
        heuristic baseline tile.  Ranked once per site."""
        key = site.key()
        allowed = self._allowed_cache.get(key)
        if allowed is None:
            grid = costmodel_vec.action_tiles_grid(self.space, site.kind)
            legal = np.flatnonzero(np.isfinite(costmodel_vec.costs_for_tiles(
                [site] * len(grid), grid, self.legality)))
            pred = np.asarray(self.surrogate.predict_seconds(
                [site] * len(legal), grid[legal], self.legality), np.float64)
            top = legal[np.argsort(pred, kind="stable")[:self.prune_topk]]
            base = costmodel_vec.baseline_tiles_batch([site])[0]
            allowed = frozenset(
                [tuple(int(x) for x in grid[i]) for i in top]
                + [tuple(int(x) for x in base)])
            self._allowed_cache[key] = allowed
        return allowed

    # -- the measured cost of explicit tiles --------------------------------
    def _measured_costs(self, sites, tiles) -> np.ndarray:
        """(n,) seconds per (site, tile) pair; ``inf`` = illegal/failed.
        One batched hook call covering all cache misses."""
        tiles = np.asarray(tiles, np.int64)
        keys = [(s.key(), (int(t[0]), int(t[1]), int(t[2])))
                for s, t in zip(sites, tiles)]
        # first occurrence of each uncached key: duplicates in one batch
        # (training samples sites with replacement) are measured once
        first = {}
        for i, k in enumerate(keys):
            if k not in self._result_cache and k not in first:
                first[k] = i
        miss = list(first.values())
        if miss:
            m_sites = [sites[i] for i in miss]
            m_tiles = tiles[miss]
            vals = costmodel_vec.costs_for_tiles(m_sites, m_tiles,
                                                 self.legality)
            if self.measure_fn is not None and not self.breaker_open:
                legal = np.flatnonzero(np.isfinite(vals))
                if len(legal) and self.prune_active:
                    # only each site's top-k candidates (and its baseline
                    # tile) reach the hook; the surrogate prices the rest
                    keep = np.array(
                        [tuple(int(x) for x in m_tiles[j])
                         in self._allowed_tiles(m_sites[j])
                         for j in legal], bool)
                    pruned = legal[~keep]
                    if len(pruned):
                        vals[pruned] = self.surrogate.predict_seconds(
                            [m_sites[j] for j in pruned], m_tiles[pruned],
                            self.legality)
                        self.pruned_pairs += len(pruned)
                        self._priced.update(keys[miss[j]] for j in pruned)
                    legal = legal[keep]
                if len(legal):
                    try:
                        raw = self.measure_fn(
                            [m_sites[j] for j in legal], m_tiles[legal])
                    except Exception as e:
                        # a raising hook is a collapsed measurement path:
                        # open the breaker, keep the model's prices
                        self._trip_breaker(
                            f"measure_fn raised {type(e).__name__}: {e}")
                        raw = None
                    if raw is not None:
                        t = np.asarray(raw, np.float64).reshape(-1)
                        if t.shape != (len(legal),):
                            raise ValueError(
                                f"measure_fn returned shape {t.shape}, "
                                f"expected ({len(legal)},)")
                        measured = np.where(np.isfinite(t) & (t > 0),
                                            t, np.inf)
                        self.measure_calls += 1
                        self.measured_pairs += len(legal)
                        if np.isfinite(measured).any():
                            self._consec_failed_batches = 0
                            vals[legal] = measured
                        else:
                            # one all-failed batch is data; a streak is a
                            # dead backend: degrade
                            self._consec_failed_batches += 1
                            if self._consec_failed_batches \
                                    >= self.breaker_threshold:
                                self._trip_breaker(
                                    f"{self._consec_failed_batches} "
                                    f"consecutive all-failed "
                                    f"measurement batches")
                            else:
                                vals[legal] = measured
            for i, v in zip(miss, vals):
                self._result_cache[keys[i]] = float(v)
        gone = [i for i, k in enumerate(keys)
                if k not in self._result_cache]
        if gone:
            # a mid-batch breaker trip purged these keys' cached failures:
            # re-price them with the model
            fresh = costmodel_vec.costs_for_tiles(
                [sites[i] for i in gone], tiles[gone], self.legality)
            for i, v in zip(gone, fresh):
                self._result_cache[keys[i]] = float(v)
        return np.array([self._result_cache[k] for k in keys], np.float64)

    # -- Oracle surface (measured) ------------------------------------------
    def costs_batch(self, sites, actions) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        tiles = costmodel_vec.tiles_for_actions(self.space, sites, actions)
        return self._measured_costs(sites, tiles)

    def baseline_costs(self, sites) -> np.ndarray:
        if not len(sites):
            return np.zeros((0,), np.float64)
        return self._measured_costs(
            sites, costmodel_vec.baseline_tiles_batch(sites))

    def baseline_cost(self, site: KernelSite) -> float:
        return float(self.baseline_costs([site])[0])

    def cost(self, site: KernelSite, action: Sequence[int]) -> Optional[float]:
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
        return self._measured_costs(sites, t)

    def cost_grid(self, sites) -> np.ndarray:
        groups = costmodel_vec.group_by_kind(sites)
        a_max = max((self.space.n_actions(k) for k in groups), default=0)
        out = np.full((len(sites), a_max), np.inf, np.float64)
        for kind, idx in groups.items():
            tg = costmodel_vec.action_tiles_grid(self.space, kind)
            rep_sites = [sites[i] for i in idx for _ in range(len(tg))]
            rep_tiles = np.tile(tg, (len(idx), 1))
            out[idx, :len(tg)] = self._measured_costs(
                rep_sites, rep_tiles).reshape(len(idx), len(tg))
        return out
