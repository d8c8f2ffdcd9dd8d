"""Extract, tune, inject (paper Fig. 3+4); the port of
``repro/core/vectorizer.py``.

The trained agent is deployed inference-only (§4.2): :func:`tune` maps each
site to its factor tuple; :func:`inject` installs the resulting
:class:`TileProgram` so every matmul and prefill attention site launches
its Hopper kernel with the tuned tile — the analogue of writing
``#pragma clang loop vectorize_width(VF) interleave_count(IF)``.  The JSON
format is the reference's, so a program tuned by either package loads in
the other.
"""
from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core import costmodel, costmodel_vec
from repro_torch.core.env import ActionSpace
from repro_torch.core.extractor import extract_sites
from repro_torch.models import compute
from repro_torch.models.compute import KernelSite


@dataclass
class TileProgram:
    """site key -> tile tuple; the 'pragma file' for a model."""
    tiles: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.tiles, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "TileProgram":
        with open(path) as f:
            return cls({k: tuple(v) for k, v in json.load(f).items()})


def tune(sites: List[KernelSite], agent, space: ActionSpace,
         env=None) -> TileProgram:
    """Greedy (inference-mode) factor assignment for every site.

    With ``env``, the greedy pick is the agent's most probable action among
    those ``env`` prices as legal (a finite cost), so that under
    ``legality="h100"`` every tile of the program launches; a site with no
    legal action (a dtype or head dim the kernels refuse) raises
    ``ValueError``.  Without it the pick is the reference's plain
    argmax."""
    if not sites:
        return TileProgram()
    legal = None if env is None else np.isfinite(env.cost_grid(sites))
    if legal is not None:
        for s, row in zip(sites, legal):
            if not row.any():
                raise ValueError(f"no legal action for site {s.key()}")
    actions = np.asarray(agent.act(sites, sample=False, legal=legal))
    return TileProgram({s.key(): tuple(int(t) for t in space.tiles(s.kind, a))
                        for s, a in zip(sites, actions)})


def baseline_program(sites: List[KernelSite]) -> TileProgram:
    return TileProgram({s.key(): costmodel.baseline_tiles(s) for s in sites})


@contextlib.contextmanager
def inject(program: TileProgram):
    """Run model code with the tuned tiles routed through the kernels."""
    with compute.compute_mode("kernel", tiles=program.tiles):
        yield


def tune_step_fn(step_fn, args, agent,
                 nv: NeuroVecConfig = DEFAULT) -> TileProgram:
    """Extract sites from ``step_fn`` run on ``meta`` ``args``; tune them."""
    return tune(extract_sites(step_fn, *args), agent, ActionSpace(nv))


def program_speedup(program: TileProgram, sites: List[KernelSite],
                    env=None) -> float:
    """Aggregate modelled speedup of a program over the heuristic baseline
    (the TPU v5e time model; legality from ``env``).  Missing sites run at
    baseline; illegal tiles are charged ``cfg.illegal_slowdown`` times the
    baseline."""
    if not sites:
        return 1.0
    cfg = env.cfg if env is not None else DEFAULT
    t_base = (np.asarray(env.baseline_costs(sites)) if env is not None
              else costmodel_vec.baseline_costs(sites))
    rows = np.ones((len(sites), 3), np.int64)
    for i, s in enumerate(sites):
        tiles = program.tiles.get(s.key()) or costmodel.baseline_tiles(s)
        k = min(len(tiles), 3)
        rows[i, :k] = tiles[:k]
    t_new = (np.asarray(env.tiles_costs(sites, rows)) if env is not None
             else costmodel_vec.costs_for_tiles(sites, rows))
    ok = np.isfinite(t_base)
    if not ok.any():
        return 1.0
    t_base, t_new = t_base[ok], t_new[ok]
    t_new = np.where(np.isfinite(t_new), t_new,
                     float(cfg.illegal_slowdown) * t_base)
    return float(t_base.sum() / t_new.sum())
