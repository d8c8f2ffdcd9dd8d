"""Persistent measurement database: timings survive the process (the port
of ``repro/measure/db.py``, local files only).

An append-only JSON-lines store keyed by ``(site.key(), tiles,
backend_key)``, where ``backend_key`` fingerprints the measurement
conditions, so an entry is only served back under the conditions that
produced it.  The format is the reference's, line for line: a file the
JAX package wrote is read here and the other way round.  A second autotune
run against the same path times nothing.

Lines that fail to parse are skipped and counted, never fatal.  A torn
trailing line (a crash mid-append) is isolated: the first append starts on
a fresh line.  Failed measurements are stored as ``null`` and read back as
``inf``, so known-bad tiles are not re-timed; the reference's quarantine
records read back as ``inf`` too.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Optional

import numpy as np


def make_key(site_key: str, tiles, backend: str) -> str:
    t = tuple(int(x) for x in tiles)
    return f"{site_key}|{t[0]}x{t[1]}x{t[2]}|{backend}"


class MeasureDB:
    """Append-only JSONL timing store with an in-process LRU on top
    (``max_entries`` bounds the memory map only; the file keeps all, and
    duplicate keys resolve last-wins on load)."""

    def __init__(self, path: str, max_entries: Optional[int] = None):
        self.path = path
        self.max_entries = max_entries
        self._mem: "OrderedDict[str, float]" = OrderedDict()
        self.skipped_lines = 0          # corrupt lines ignored
        self._torn_tail = False         # file ends mid-record
        self._fh = None
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    key = rec["k"]
                    val = float("inf") if rec["v"] is None else float(rec["v"])
                except (ValueError, KeyError, TypeError):
                    self.skipped_lines += 1
                    continue
                self._remember(key, val)
        with open(self.path, "rb") as fb:
            fb.seek(0, os.SEEK_END)
            if fb.tell():
                fb.seek(-1, os.SEEK_END)
                self._torn_tail = fb.read(1) != b"\n"

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

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def get(self, key: str) -> Optional[float]:
        v = self._mem.get(key)
        if v is not None:
            self._mem.move_to_end(key)
        return v

    def put(self, key: str, val: float) -> None:
        self._append({"k": key, "v": None if not np.isfinite(val) else val})
        self._remember(key, val)

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem


def open_measure_db(path: str, **kwargs) -> MeasureDB:
    """A :class:`MeasureDB` on a local JSONL path.  The reference's shared
    ``fleet://host:port`` store is not ported yet."""
    if isinstance(path, str) and path.startswith("fleet://"):
        raise NotImplementedError(
            f"{path}: the fleet artifact service is not ported yet (ROADMAP "
            f"queue 1 item 3); pass a local file path")
    return MeasureDB(path, **kwargs)
