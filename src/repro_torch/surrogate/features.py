"""Fixed numeric featurizer for ``(site, tiles)`` pairs (the port of
``repro/surrogate/features.py``, bitwise the reference's in float64).

The feature vector is a deterministic function of the site's recorded
shape metadata and the tile triple — no code embedding, no hardware
probe — so it can be computed for any pair the ``MeasureDB`` has ever
seen and for any candidate the tuner wants priced.  Layout (all float64):

====  =====================================================
 0-2  kind one-hot (matmul, attention, chunk_scan)
 3-6  log2 site dims: m, n, k, batch
   7  dtype bytes (2 = bf16, 4 = f32)
   8  causal flag
9-11  log2 tile triple (t0, t1, t2; unused dims are 1)
12-14 log2 tile/dim ratios (t0/m, t1/n, t2/k)
  15  log2 VMEM footprint bytes (the kernels' scratch formulas)
  16  VMEM footprint as a fraction of the budget
  17  log2 grid steps (number of kernel invocations)
  18  log2 analytic model cost — the scalar cost model as a prior
====  =====================================================

The features are a fixed encoding shared by both packages' checkpoints:
the footprint (15-16) and the prior (18) are the reference's TPU v5e
formulas (``legality="tpu_v5e"``), whatever card the timings came from,
just as the cost model's constants are.  They describe no H100 resource.

Pairs the analytic model rejects (VMEM overflow) have no finite cost to
take a log of; their prior feature is clamped.  Callers filter by their
own legality before pricing (both the oracle and the pruner do); a tile
legal on the card but over the v5e VMEM budget keeps the clamp.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import costmodel_vec
from repro_torch.models.site import KernelSite

KINDS = ("matmul", "attention", "chunk_scan")
N_FEATURES = 19

_LOG_CLAMP = 64.0       # stand-in for log2(inf) on illegal-pair priors


def _log2(x: np.ndarray) -> np.ndarray:
    return np.log2(np.maximum(np.asarray(x, np.float64), 1e-300))


def _vmem_and_grid(sites: Sequence[KernelSite],
                   tiles: np.ndarray) -> tuple:
    """(n,) VMEM footprint bytes and (n,) grid steps, per the kernels'
    scratch formulas (mirrors the legality math in ``costmodel_vec``)."""
    n = len(sites)
    vmem = np.empty(n, np.float64)
    grid = np.empty(n, np.float64)
    t0 = tiles[:, 0].astype(np.float64)
    t1 = tiles[:, 1].astype(np.float64)
    t2 = tiles[:, 2].astype(np.float64)
    for kind, idx in costmodel_vec.group_by_kind(sites).items():
        s = np.array([cm._dtype_bytes(sites[i].dtype) for i in idx],
                     np.float64)
        m = np.array([sites[i].m for i in idx], np.float64)
        nn = np.array([sites[i].n for i in idx], np.float64)
        kk = np.array([sites[i].k for i in idx], np.float64)
        b = np.array([sites[i].batch for i in idx], np.float64)
        a, c, e = t0[idx], t1[idx], t2[idx]
        if kind == "matmul":
            vmem[idx] = 2 * (a * e + e * c) * s + a * c * 4 + a * c * s
            grid[idx] = (np.ceil(m / a) * np.ceil(nn / c)
                         * np.ceil(kk / e))
        elif kind == "attention":
            # site semantics: m=Sq, k=Skv, n=D; tiles (bq, bkv, 1)
            vmem[idx] = (2 * (a * nn + 2 * c * nn) * s + a * nn * 4
                         + 2 * a * 4 + a * c * 4)
            grid[idx] = b * np.ceil(m / a) * np.ceil(kk / c)
        elif kind == "chunk_scan":
            # tiles (chunk, 1, 1); P=site.n, N=site.k
            vmem[idx] = 2 * a * (nn + 2 * kk) * s + nn * kk * 4 + a * a * 4
            grid[idx] = np.ceil(b * m / a)
        else:                               # unknown kind: neutral values
            vmem[idx] = s
            grid[idx] = 1.0
    return vmem, np.maximum(grid, 1.0)


def featurize(sites: Sequence[KernelSite], tiles) -> np.ndarray:
    """(n, N_FEATURES) float64 feature matrix for the given pairs."""
    t = np.asarray(tiles, np.int64)
    if t.ndim != 2 or t.shape[0] != len(sites):
        raise ValueError(f"tiles must be (n_sites, k), got {t.shape}")
    if t.shape[1] < 3:
        t = np.concatenate([t, np.ones((len(t), 3 - t.shape[1]),
                                       np.int64)], 1)
    n = len(sites)
    X = np.zeros((n, N_FEATURES), np.float64)
    if not n:
        return X
    kind_ix = {k: i for i, k in enumerate(KINDS)}
    dims = np.array([[s.m, s.n, s.k, s.batch] for s in sites], np.float64)
    for i, s in enumerate(sites):
        j = kind_ix.get(s.kind)
        if j is not None:
            X[i, j] = 1.0
        X[i, 7] = cm._dtype_bytes(s.dtype)
        X[i, 8] = float(s.causal)
    X[:, 3:7] = _log2(dims)
    X[:, 9:12] = _log2(t)
    X[:, 12:15] = _log2(t) - _log2(dims[:, :3])
    vmem, grid = _vmem_and_grid(sites, t)
    X[:, 15] = _log2(vmem)
    X[:, 16] = vmem / cm.VMEM_BYTES
    X[:, 17] = _log2(grid)
    prior = costmodel_vec.costs_for_tiles(sites, t, legality="tpu_v5e")
    X[:, 18] = np.where(np.isfinite(prior), _log2(prior), _LOG_CLAMP)
    return X
