"""Persistent measurement database: timings survive the process (the port
of ``repro/measure/db.py``).

An append-only JSON-lines store keyed by ``(site.key(), tiles,
backend_key)``, where ``backend_key`` fingerprints the measurement
conditions, so an entry is only served back under the conditions that
produced it.  The format is the reference's, line for line: a file the
JAX package wrote is read here and the other way round.  A second autotune
run against the same path times nothing.

Lines that fail to parse are skipped and counted, never fatal.  A torn
trailing line (a crash mid-append) is isolated: the first append starts on
a fresh line.  Failed measurements are stored as ``null`` and read back as
``inf``, so known-bad tiles are not re-timed.

Quarantine records are the poison-job ledger: a ``(site, tiles)`` pair
that repeatedly kills or wedges measurement workers is recorded by
:meth:`MeasureDB.quarantine` with its attempt count and a reason.  A
quarantined key reads back as ``inf`` in every process that opens the DB,
even after the in-memory LRU has evicted it, so no later run re-attempts
it; :meth:`MeasureDB.quarantined` keeps the record.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Iterator, NamedTuple, Optional

import numpy as np


def make_key(site_key: str, tiles, backend: str) -> str:
    t = tuple(int(x) for x in tiles)
    return f"{site_key}|{t[0]}x{t[1]}x{t[2]}|{backend}"


class MeasureRecord(NamedTuple):
    """One resolved measurement from :meth:`MeasureDB.iter_records`."""
    key: str            # full DB key: "site_key|t0xt1xt2|backend"
    kind: str           # site kind parsed from the key ("matmul", ...)
    value: float        # measured seconds; inf for failed measurements
    fingerprint: str    # backend fingerprint component of the key


def _parse(line: str):
    """``(record, key, value)`` of one JSONL line; raises on garbage."""
    rec = json.loads(line)
    return rec, rec["k"], float("inf") if rec["v"] is None else float(rec["v"])


class MeasureDB:
    """Append-only JSONL timing store with an in-process LRU on top
    (``max_entries`` bounds the memory map only; the file keeps all, and
    duplicate keys resolve last-wins on load).  Quarantined keys are kept
    apart from the LRU and survive its eviction."""

    def __init__(self, path: str, max_entries: Optional[int] = None):
        self.path = path
        self.max_entries = max_entries
        self._mem: "OrderedDict[str, float]" = OrderedDict()
        self._quarantined: dict = {}    # key -> {"attempts", "reason"}
        self.skipped_lines = 0          # corrupt lines ignored
        self._torn_tail = False         # file ends mid-record
        self._fh = None
        self._load()

    # -- persistence ---------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec, key, val = _parse(line)
                except (ValueError, KeyError, TypeError):
                    self.skipped_lines += 1
                    continue
                if rec.get("kind") == "quarantine":
                    self._quarantined[key] = {
                        "attempts": int(rec.get("attempts", 0)),
                        "reason": str(rec.get("reason", ""))}
                self._remember(key, val)
        # a crash mid-append leaves the last line unterminated: the next
        # append starts on a fresh line so the torn bytes stay isolated
        try:
            with open(self.path, "rb") as fb:
                fb.seek(-1, os.SEEK_END)
                self._torn_tail = fb.read(1) != b"\n"
        except OSError:                 # an empty file: nothing to isolate
            self._torn_tail = False

    def _remember(self, key: str, val: float) -> None:
        self._mem[key] = val
        self._mem.move_to_end(key)
        if self.max_entries is not None:
            while len(self._mem) > self.max_entries:
                self._mem.popitem(last=False)

    def _append(self, rec: dict) -> None:
        if self._fh is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._fh = open(self.path, "a")
            if self._torn_tail:
                self._fh.write("\n")    # isolate the torn trailing record
                self._torn_tail = False
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- mapping -------------------------------------------------------------
    def get(self, key: str) -> Optional[float]:
        v = self._mem.get(key)
        if v is not None:
            self._mem.move_to_end(key)
        elif key in self._quarantined:
            return float("inf")         # quarantine survives LRU eviction
        return v

    def put(self, key: str, val: float) -> None:
        self._append({"k": key, "v": None if not np.isfinite(val) else val})
        self._remember(key, val)

    # -- poison-job quarantine -----------------------------------------------
    def quarantine(self, key: str, attempts: int, reason: str) -> None:
        """Persist ``key`` as poisoned: it reads back ``inf`` in every
        process that opens this DB, its attempt count and reason kept.
        A reader that knows no quarantine sees a failed measurement
        (``v: null``)."""
        info = {"attempts": int(attempts), "reason": str(reason)}
        self._append({"k": key, "v": None, "kind": "quarantine", **info})
        self._quarantined[key] = info
        self._remember(key, float("inf"))

    def quarantined(self, key: str) -> Optional[dict]:
        """``{"attempts", "reason"}`` for a poisoned ``key``, else None."""
        return self._quarantined.get(key)

    @property
    def n_quarantined(self) -> int:
        return len(self._quarantined)

    # -- iteration -----------------------------------------------------------
    def iter_records(self) -> Iterator[MeasureRecord]:
        """Every resolved measurement of the on-disk log, last wins (so
        entries the LRU evicted are seen).  Quarantined, corrupt and
        malformed keys are skipped: poisoned or torn records are not
        data."""
        self.flush()
        if not os.path.exists(self.path):
            return
        resolved: "OrderedDict[str, Optional[float]]" = OrderedDict()
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec, key, val = _parse(line)
                except (ValueError, KeyError, TypeError):
                    continue            # counted at load time; not data
                resolved[key] = (None if rec.get("kind") == "quarantine"
                                 else val)
        for key, val in resolved.items():
            parts = key.split("|")
            if val is None or len(parts) != 3:
                continue
            site_key, _, backend = parts
            yield MeasureRecord(key=key, kind=site_key.split(":", 1)[0],
                                value=val, fingerprint=backend)

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem


def open_measure_db(path: str, **kwargs):
    """A :class:`MeasureDB` on a local JSONL path, or for a
    ``fleet://host:port`` path a
    :class:`~repro_torch.fleet.artifacts.RemoteMeasureDB`: a live,
    push-updated mirror of a ``serve-artifacts`` daemon's timing store."""
    if isinstance(path, str) and path.startswith("fleet://"):
        from repro_torch.fleet.artifacts import RemoteMeasureDB
        return RemoteMeasureDB(path)
    return MeasureDB(path, **kwargs)
