"""Training corpus from the persistent ``MeasureDB`` (the port of
``repro/surrogate/dataset.py``; a DB file either package wrote parses to
the same corpus).

Every measurement ever taken is one append-only JSONL record keyed
``site_key|t0xt1xt2|backend``; ``MeasureDB.iter_records()`` already
resolves duplicates last-wins and drops quarantined/corrupt entries.
This module finishes the job: parse the key back into a
:class:`~repro_torch.models.site.KernelSite` + tile triple, keep only
finite timings (a ``null``/``inf`` record means the kernel failed — it
carries no cost signal), and hand back aligned arrays ready for the
featurizer.  Targets are ``log(seconds)``: timings span orders of
magnitude and the ranking loss we care about lives on the log scale.
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np

from repro_torch.measure.db import MeasureDB
from repro_torch.models.site import KernelSite

# KernelSite.key() followed by the DB's tile/backend components.  The
# site label may itself contain separators; the dims block anchors it.
_KEY_RE = re.compile(
    r"^(?P<kind>[^:|]+):(?P<site>.+):m(?P<m>\d+)n(?P<n>\d+)k(?P<k>\d+)"
    r"b(?P<batch>\d+):(?P<dtype>[^:|]+):(?P<transpose>[^:|]+)"
    r"(?P<causal>:c)?:f(?P<fused>\d+)"
    r"\|(?P<t0>\d+)x(?P<t1>\d+)x(?P<t2>\d+)\|(?P<backend>.*)$")


class Corpus(NamedTuple):
    """Aligned training arrays: pair i is ``(sites[i], tiles[i]) ->
    y[i] = log(seconds)``, measured under ``backends[i]``."""
    sites: Tuple[KernelSite, ...]
    tiles: np.ndarray           # (n, 3) int64
    y: np.ndarray               # (n,) float64 log-seconds
    backends: Tuple[str, ...]


def parse_key(key: str) -> Optional[Tuple[KernelSite, Tuple[int, int, int],
                                          str]]:
    """Full DB key -> ``(site, tiles, backend)``; ``None`` if the key
    does not round-trip (foreign record kinds stay non-fatal)."""
    m = _KEY_RE.match(key)
    if m is None:
        return None
    site = KernelSite(
        site=m["site"], kind=m["kind"], m=int(m["m"]), n=int(m["n"]),
        k=int(m["k"]), batch=int(m["batch"]), dtype=m["dtype"],
        transpose=m["transpose"], causal=m["causal"] is not None,
        fused_ops=int(m["fused"]))
    return site, (int(m["t0"]), int(m["t1"]), int(m["t2"])), m["backend"]


def build_corpus(db: Union[MeasureDB, str],
                 backend: Optional[str] = None) -> Corpus:
    """Every finite, parseable measurement in ``db`` as a :class:`Corpus`.

    ``backend`` restricts to records taken under one measurement
    fingerprint — mixing fingerprints trains on incommensurable clocks.
    Accepts an open :class:`MeasureDB` or a path.
    """
    if isinstance(db, str):
        db = MeasureDB(db)
    sites, tiles, ys, backends = [], [], [], []
    for rec in db.iter_records():
        if not np.isfinite(rec.value) or rec.value <= 0:
            continue
        parsed = parse_key(rec.key)
        if parsed is None:
            continue
        site, t, be = parsed
        if backend is not None and be != backend:
            continue
        sites.append(site)
        tiles.append(t)
        ys.append(np.log(rec.value))
        backends.append(be)
    return Corpus(sites=tuple(sites),
                  tiles=np.asarray(tiles, np.int64).reshape(-1, 3),
                  y=np.asarray(ys, np.float64),
                  backends=tuple(backends))
