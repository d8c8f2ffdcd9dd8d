"""Vectorized (NumPy) cost-model engine — the batched reward oracle (the
port of ``repro/core/costmodel_vec.py``).

Evaluates whole ``(n_sites, n_actions)`` grids with float64 NumPy in the
same evaluation order as :mod:`repro_torch.core.costmodel`; illegal tiles
are ``np.inf``.  ``legality`` is as in the scalar model: ``"tpu_v5e"``
(VMEM overflow, the reference's exact grids) or ``"h100"`` (the Hopper
kernels' launch predicate, ``kernels.ops``).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.kernels import ops
from repro_torch.models.compute import KernelSite

ILLEGAL = np.inf
DEFAULT_LEGALITY = cm.DEFAULT_LEGALITY


def _ceil(a, b):
    return -(-a // b)


def _mxu_util_vec(bm, bn, bk):
    u = np.minimum(bm, cm.MXU) / cm.MXU * (np.minimum(bn, cm.LANE) / cm.LANE)
    u = np.where(bm % cm.SUBLANE != 0, u * 0.6, u)
    u = np.where(bn % cm.LANE != 0, u * 0.5, u)
    u = u * (bk / (bk + cm.MXU))
    return np.maximum(u, 1e-3)


def matmul_cost_vec(M, N, K, s, peak, bm, bn, bk,
                    legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    tm, tn, tk = _ceil(M, bm), _ceil(N, bn), _ceil(K, bk)
    if cm.check_legality(legality) == "tpu_v5e":
        vmem = 2 * (bm * bk + bk * bn) * s + bm * bn * 4 + bm * bn * s
        legal = vmem <= cm.VMEM_BYTES
    else:
        legal = ops.matmul_tiles_legal(M, N, K, bm, bn, bk)
    pm = (tm * bm).astype(np.float64)
    pn = (tn * bn).astype(np.float64)
    pk = (tk * bk).astype(np.float64)
    grid = tm.astype(np.float64) * tn * tk
    flops = 2.0 * pm * pn * pk
    t_compute = flops / (peak * _mxu_util_vec(bm, bn, bk))
    bytes_ = pm * pk * tn * s + pk * pn * tm * s + pm * pn * s
    t_mem = bytes_ / cm.HBM_BW
    cost = (np.maximum(t_compute, t_mem) + grid * cm.GRID_STEP_OVERHEAD
            + cm.FIXED_OVERHEAD)
    return np.where(legal, cost, ILLEGAL)


def attention_cost_vec(Sq, Skv, D, BH, causal, s, peak, bq, bkv,
                       legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    tq, tkv = _ceil(Sq, bq), _ceil(Skv, bkv)
    if cm.check_legality(legality) == "tpu_v5e":
        vmem = 2 * (bq * D + 2 * bkv * D) * s + bq * D * 4 + 2 * bq * 4 \
            + bq * bkv * 4
        legal = vmem <= cm.VMEM_BYTES
    else:
        legal = ops.attention_tiles_legal(Sq, Skv, D, bq, bkv)
    pq = (tq * bq).astype(np.float64)
    pkv = (tkv * bkv).astype(np.float64)
    grid = BH.astype(np.float64) * tq * tkv
    frac = np.where(causal, 0.5 * (1 + 1 / np.maximum(tq, 1)), 1.0)
    flops = 4.0 * BH * pq * pkv * D * frac
    vpu_ops = 6.0 * BH * pq * pkv * frac
    t_compute = (flops / (peak * _mxu_util_vec(bq, bkv, D))
                 + vpu_ops / (cm.PEAK_FLOPS_BF16 / 16))
    bytes_ = BH * s * (pq * D + 2 * pkv * D * tq * frac + pq * D)
    t_mem = bytes_ / cm.HBM_BW
    cost = (np.maximum(t_compute, t_mem) + grid * frac * cm.GRID_STEP_OVERHEAD
            + cm.FIXED_OVERHEAD)
    return np.where(legal, cost, ILLEGAL)


def chunk_scan_cost_vec(m, P, N, batch, s, peak, Q,
                        legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    tokens = batch * m
    if cm.check_legality(legality) == "tpu_v5e":
        vmem = 2 * Q * (P + 2 * N) * s + P * N * 4 + Q * Q * 4
        legal = vmem <= cm.VMEM_BYTES
    else:
        legal = ops.chunk_tiles_legal(tokens, P, N, Q)
    chunks_total = _ceil(tokens, Q)
    per_chunk = 2.0 * Q * Q * N + 2.0 * Q * Q * P + 4.0 * Q * P * N
    flops = per_chunk * chunks_total
    t_compute = flops / (peak * _mxu_util_vec(Q, np.maximum(P, N), Q))
    bytes_ = tokens.astype(np.float64) * (P + 2 * N) * s * 2
    t_mem = bytes_ / cm.HBM_BW
    cost = (np.maximum(t_compute, t_mem)
            + chunks_total * cm.GRID_STEP_OVERHEAD + cm.FIXED_OVERHEAD)
    return np.where(legal, cost, ILLEGAL)


_DTYPE_META: Dict[str, Tuple[int, float]] = {}


def _dtype_meta(dtype: str) -> Tuple[int, float]:
    m = _DTYPE_META.get(dtype)
    if m is None:
        m = (cm._dtype_bytes(dtype), cm._peak(dtype))
        _DTYPE_META[dtype] = m
    return m


def _site_cols(sites: Sequence[KernelSite], grid: bool = True):
    rows = [(s.m, s.n, s.k, s.batch, s.causal, *_dtype_meta(s.dtype))
            for s in sites]
    m, n, k, b, causal, sb, peak = zip(*rows) if rows else ((),) * 7

    def col(vals, dt):
        a = np.array(vals, dt)
        return a[:, None] if grid else a
    return {"m": col(m, np.int64), "n": col(n, np.int64),
            "k": col(k, np.int64), "batch": col(b, np.int64),
            "causal": col(causal, bool), "s": col(sb, np.int64),
            "peak": col(peak, np.float64)}


def _cost_kind(kind: str, c: Dict[str, np.ndarray], tiles: np.ndarray,
               grid: bool = True,
               legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    t = np.asarray(tiles, np.int64)
    if grid:
        t0, t1, t2 = t[None, :, 0], t[None, :, 1], t[None, :, 2]
    else:
        t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
    if kind == "matmul":
        return matmul_cost_vec(c["m"], c["n"], c["k"], c["s"], c["peak"],
                               t0, t1, t2, legality)
    if kind == "attention":
        return attention_cost_vec(c["m"], c["k"], c["n"], c["batch"],
                                  c["causal"], c["s"], c["peak"], t0, t1,
                                  legality)
    if kind == "chunk_scan":
        return chunk_scan_cost_vec(c["m"], c["n"], c["k"], c["batch"],
                                   c["s"], c["peak"], t0, legality)
    raise ValueError(kind)


def group_by_kind(sites: Sequence[KernelSite]) -> Dict[str, np.ndarray]:
    out: Dict[str, List[int]] = {}
    for i, s in enumerate(sites):
        out.setdefault(s.kind, []).append(i)
    return {k: np.asarray(v, np.int64) for k, v in out.items()}


_GRID_CACHE: Dict[Tuple, np.ndarray] = {}


def action_tiles_grid(space, kind: str) -> np.ndarray:
    """(n_actions, 3) tile values in flat-action order for ``kind``."""
    choices = space.choices(kind)
    key = (choices, kind)
    g = _GRID_CACHE.get(key)
    if g is None:
        g = np.array(list(itertools.product(*choices)), np.int64)
        _GRID_CACHE[key] = g
    return g


def cost_grid_kind(space, sites, kind: str,
                   legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    return _cost_kind(kind, _site_cols(sites), action_tiles_grid(space, kind),
                      legality=legality)


def cost_grid(space, sites, legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    """(n_sites, max_n_actions) cost tensor; ``inf`` pads past a kind's
    action count, so a row argmin is the brute-force flat action."""
    groups = group_by_kind(sites)
    if len(groups) == 1:
        (kind, _), = groups.items()
        return cost_grid_kind(space, sites, kind, legality)
    a_max = max((space.n_actions(k) for k in groups), default=0)
    out = np.empty((len(sites), a_max), np.float64)
    for kind, idx in groups.items():
        na = space.n_actions(kind)
        out[idx, :na] = cost_grid_kind(space, [sites[i] for i in idx], kind,
                                       legality)
        if na < a_max:
            out[idx, na:] = ILLEGAL
    return out


def _tiles_for_actions_kind(space, kind: str, acts: np.ndarray,
                            idx: np.ndarray) -> np.ndarray:
    ch = space.choices(kind)
    if acts.shape[1] < 3:
        raise IndexError(
            f"actions need 3 head indices, got shape {acts.shape}")
    out = np.ones((len(acts), 3), np.int64)
    strict = space.strict_enabled(None)
    for d in range(3):
        arr = np.asarray(ch[d], np.int64)
        if strict:
            bad = (acts[:, d] < 0) | (acts[:, d] >= len(arr))
            if bad.any():
                j = int(np.flatnonzero(bad)[0])
                raise IndexError(
                    f"action index {int(acts[j, d])} out of range "
                    f"[0, {len(arr)}) for head {d} of kind {kind!r} "
                    f"(site index {int(idx[j])})")
        out[:, d] = arr[np.minimum(acts[:, d], len(arr) - 1)]
    return out


def costs_for_actions(space, sites, actions,
                      legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    """(n,) cost of each site under its chosen action (``inf`` = illegal)."""
    acts = np.asarray(actions, np.int64).reshape(len(sites), -1)
    out = np.empty((len(sites),), np.float64)
    for kind, idx in group_by_kind(sites).items():
        tiles = _tiles_for_actions_kind(space, kind, acts[idx], idx)
        c = _site_cols([sites[i] for i in idx], grid=False)
        out[idx] = _cost_kind(kind, c, tiles, grid=False, legality=legality)
    return out


def tiles_for_actions(space, sites, actions) -> np.ndarray:
    """(n, 3) tile values for per-site action indices (unused dims = 1):
    the batched ``ActionSpace.tiles``, for oracles that price tiles rather
    than action indices (``MeasuredEnv``)."""
    acts = np.asarray(actions, np.int64).reshape(len(sites), -1)
    out = np.ones((len(sites), 3), np.int64)
    for kind, idx in group_by_kind(sites).items():
        out[idx] = _tiles_for_actions_kind(space, kind, acts[idx], idx)
    return out


def costs_for_tiles(sites, tiles,
                    legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    """(n,) model cost of each site under explicit tile values."""
    t = np.asarray(tiles, np.int64)
    if t.ndim != 2 or t.shape[0] != len(sites):
        raise ValueError(f"tiles must be (n_sites, k), got {t.shape}")
    if t.shape[1] < 3:
        t = np.concatenate(
            [t, np.ones((len(t), 3 - t.shape[1]), np.int64)], 1)
    out = np.empty((len(sites),), np.float64)
    for kind, idx in group_by_kind(sites).items():
        c = _site_cols([sites[i] for i in idx], grid=False)
        out[idx] = _cost_kind(kind, c, t[idx], grid=False, legality=legality)
    return out


def baseline_tiles_batch(sites) -> np.ndarray:
    """(n, 3) heuristic-baseline tile values (unused dims = 1)."""
    out = np.ones((len(sites), 3), np.int64)
    for kind, idx in group_by_kind(sites).items():
        M = np.array([sites[i].m for i in idx], np.int64)
        N = np.array([sites[i].n for i in idx], np.int64)
        K = np.array([sites[i].k for i in idx], np.int64)
        if kind == "matmul":
            out[idx, 0] = np.minimum(128, _ceil(M, cm.SUBLANE) * cm.SUBLANE)
            out[idx, 1] = np.minimum(128, _ceil(N, cm.LANE) * cm.LANE)
            out[idx, 2] = np.minimum(512, _ceil(K, cm.LANE) * cm.LANE)
        elif kind == "attention":
            out[idx, 0] = np.minimum(128, _ceil(M, cm.SUBLANE) * cm.SUBLANE)
            out[idx, 1] = np.minimum(512, _ceil(K, cm.LANE) * cm.LANE)
        elif kind == "chunk_scan":
            out[idx, 0] = np.minimum(256, M)
    return out


def baseline_costs(sites, legality: str = DEFAULT_LEGALITY) -> np.ndarray:
    """(n,) baseline cost per site; raises if a baseline tile is illegal."""
    tiles = baseline_tiles_batch(sites)
    out = np.empty((len(sites),), np.float64)
    for kind, idx in group_by_kind(sites).items():
        c = _site_cols([sites[i] for i in idx], grid=False)
        out[idx] = _cost_kind(kind, c, tiles[idx], grid=False,
                              legality=legality)
    if not np.isfinite(out).all():
        raise ValueError(f"baseline tiles illegal ({legality}) for some site")
    return out
