"""The Polly analogue: a strong non-learned domain baseline (paper §4:
Polly beats the baseline by 17% and loses to RL by 56%); the port of
``repro/core/agents/polly.py``.

Polly optimises data locality, not ISA-level vectorization; the analogue
picks the tile that moves the fewest bytes within the reference's VMEM
budget, blind to alignment, pipelining and dispatch cost.  The search is
one mem-only grid per site kind in exact int64 byte counts, so ties break
as in the scalar ``itertools.product`` walk, kept as the parity reference.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core import costmodel, costmodel_vec
from repro_torch.core.protocols import AGENT_STATE_VERSION, check_agent_state
from repro_torch.models.compute import KernelSite

_ILLEGAL = np.iinfo(np.int64).max      # sentinel: never wins an argmin


def _mem_only_cost(site: KernelSite, tiles) -> float:
    """Scalar reference (the per-tile walk), held against the grid."""
    s = costmodel._dtype_bytes(site.dtype)
    if site.kind == "matmul":
        M, N, K = site.m, site.n, site.k
        bm, bn, bk = tiles
        vmem = 2 * (bm * bk + bk * bn) * s + bm * bn * 4 + bm * bn * s
        if vmem > costmodel.VMEM_BYTES:
            return float("inf")
        tm, tn = -(-M // bm), -(-N // bn)
        return (M * K * tn + K * N * tm + M * N) * s
    if site.kind == "attention":
        Sq, Skv, D, BH = site.m, site.k, site.n, site.batch
        bq, bkv = tiles[:2]
        vmem = 2 * (bq * D + 2 * bkv * D) * s + bq * D * 4 + bq * bkv * 4
        if vmem > costmodel.VMEM_BYTES:
            return float("inf")
        tq = -(-Sq // bq)
        return BH * (Sq * D + 2 * Skv * D * tq + Sq * D) * s
    if site.kind == "chunk_scan":
        Q = tiles[0]
        tokens = site.batch * site.m
        vmem = 2 * Q * (site.n + 2 * site.k) * s + site.n * site.k * 4 \
            + Q * Q * 4
        if vmem > costmodel.VMEM_BYTES:
            return float("inf")
        # the state is re-loaded at every chunk boundary
        return tokens * (site.n + 2 * site.k) * s * 2 \
            + (-(-tokens // Q)) * site.n * site.k * 4
    raise ValueError(site.kind)


def _ceil(a, b):
    return -(-a // b)


def mem_only_grid_kind(space, sites, kind: str) -> np.ndarray:
    """(n_sites, n_actions(kind)) data-movement bytes in flat-action order;
    entries over the VMEM budget carry the int64-max sentinel."""
    tiles = costmodel_vec.action_tiles_grid(space, kind)
    t0, t1, t2 = tiles[None, :, 0], tiles[None, :, 1], tiles[None, :, 2]
    c = costmodel_vec._site_cols(sites)             # (n, 1) int columns
    s = c["s"]
    if kind == "matmul":
        M, N, K = c["m"], c["n"], c["k"]
        vmem = 2 * (t0 * t2 + t2 * t1) * s + t0 * t1 * 4 + t0 * t1 * s
        tm, tn = _ceil(M, t0), _ceil(N, t1)
        cost = (M * K * tn + K * N * tm + M * N) * s
    elif kind == "attention":
        Sq, Skv, D, BH = c["m"], c["k"], c["n"], c["batch"]
        vmem = 2 * (t0 * D + 2 * t1 * D) * s + t0 * D * 4 + t0 * t1 * 4
        tq = _ceil(Sq, t0)
        cost = BH * (Sq * D + 2 * Skv * D * tq + Sq * D) * s
    elif kind == "chunk_scan":
        P, N, tokens = c["n"], c["k"], c["batch"] * c["m"]
        vmem = 2 * t0 * (P + 2 * N) * s + P * N * 4 + t0 * t0 * 4
        cost = tokens * (P + 2 * N) * s * 2 + _ceil(tokens, t0) * P * N * 4
    else:
        raise ValueError(kind)
    cost = np.broadcast_to(cost, vmem.shape)
    return np.where(vmem <= costmodel.VMEM_BYTES, cost, _ILLEGAL)


class PollyAgent:
    """Mem-only argmin behind the Agent protocol (search-free: ``fit`` is
    a no-op that may pick up the oracle's action space)."""

    name = "polly"

    def __init__(self, space=None):
        self.space = space

    def fit(self, sites, oracle, **_) -> "PollyAgent":
        if self.space is None:
            self.space = oracle.space
        return self

    def state_dict(self) -> dict:
        """Versioned empty state (search-free)."""
        return {"version": AGENT_STATE_VERSION, "name": self.name}

    def load_state(self, state: dict) -> "PollyAgent":
        check_agent_state(state, self.name)
        return self

    def act(self, sites, *, sample: bool = False, legal=None) -> np.ndarray:
        """(n, 3) argmin of the mem-only grid.  With ``legal`` ((n, A)
        bool over flat actions) the argmin runs over the legal actions
        only (under ``legality="h100"``: the tiles the kernels launch);
        where every legal action is over the VMEM budget, the first legal
        one; a site with no legal action raises ``ValueError``."""
        if self.space is None:
            raise RuntimeError("PollyAgent.act before fit (no ActionSpace)")
        out = np.zeros((len(sites), 3), np.int64)
        for kind, idx in costmodel_vec.group_by_kind(sites).items():
            grid = mem_only_grid_kind(self.space,
                                      [sites[i] for i in idx], kind)
            if legal is None:
                flat = grid.argmin(1)
            else:
                ok = np.asarray(legal, bool)[idx, :grid.shape[1]]
                for i, row in zip(idx, ok):
                    if not row.any():
                        raise ValueError(f"no legal action for site "
                                         f"{sites[i].key()}")
                masked = np.where(ok, grid, _ILLEGAL)
                flat = masked.argmin(1)
                none = masked[np.arange(len(idx)), flat] == _ILLEGAL
                flat = np.where(none, ok.argmax(1), flat)
            out[idx] = self.space.unflatten_batch(kind, flat)
        return out


def _polly_action_ref(space, site: KernelSite):
    """The interpreted factor-product walk (parity reference)."""
    sizes = space.valid_sizes(site.kind)
    best_a, best_c = (0, 0, 0), float("inf")
    for a in itertools.product(*(range(n) for n in sizes)):
        c = _mem_only_cost(site, space.tiles(site.kind, a))
        if c < best_c:
            best_a, best_c = a, c
    return np.array(best_a, np.int64)
