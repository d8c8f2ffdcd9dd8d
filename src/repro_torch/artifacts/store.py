"""``ProgramStore`` — persistent, append-only store of tuned tile programs;
the port of ``repro/artifacts/store.py``, in its JSONL format.

Once an agent has tuned a set of kernel sites, every later process asking
the same question gets the answer by lookup — zero agent inferences, zero
oracle evaluations.  The key fingerprints all three coordinates:

* the **site set** — sorted ``site.key()``s, hashed (order-insensitive);
* the **agent** — registry name + SHA-256 of its deployable
  ``state_dict`` (:func:`~repro_torch.artifacts.agentio.agent_fingerprint`);
* the **oracle/backend** — oracle type + config hash, the oracle's
  ``legality`` (the port's cost models price tiles by the TPU's VMEM or
  by the Hopper kernels' launch rule, and the two tune differently), plus
  the measurement transport's ``backend_key`` when one is attached.

On disk it is JSON-lines, append-only: corrupt lines are skipped and
counted (the store degrades to re-tuning), duplicate keys resolve
last-wins on load.  A ``fleet://host:port`` path opens the shared store of
a ``serve-artifacts`` daemon instead (:func:`open_program_store`).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional, Sequence, Tuple

from repro_torch.artifacts.agentio import agent_fingerprint
from repro_torch.core.vectorizer import TileProgram, mask_env, tune


def sites_fingerprint(sites: Sequence) -> str:
    """Order-insensitive hash of a site set (sorted ``site.key()``s)."""
    blob = "\n".join(sorted(s.key() for s in sites))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def oracle_fingerprint(oracle) -> str:
    """Oracle identity for the store key: type + config hash + legality,
    plus the transport's measurement-conditions fingerprint when one is
    attached."""
    transport = getattr(getattr(oracle, "measure_fn", None), "transport",
                        None)
    cfg = getattr(oracle, "cfg", None)
    try:
        from repro_torch.configs.neurovec import cfg_to_dict
        cfg_fp = hashlib.sha256(json.dumps(
            cfg_to_dict(cfg), sort_keys=True).encode()).hexdigest()[:12]
    except (TypeError, AttributeError):
        cfg_fp = f"cfg-{type(cfg).__name__}"
    base = f"{type(oracle).__name__}:{cfg_fp}"
    legality = getattr(oracle, "legality", None)
    if legality is not None:
        base += f":{legality}"
    if transport is not None:
        base += f":{transport.backend_key}"
    return base


def program_key(sites: Sequence, agent, oracle) -> str:
    """The full store key: (site set, agent identity, oracle/backend).

    The agent fingerprint is recomputed from ``state_dict()`` on every
    call rather than cached: nothing in the protocol announces state
    mutation (callers may ``fit`` the agent directly), and a stale
    fingerprint would serve a *wrong program* — correctness over the
    hash cost, which is linear in policy size."""
    return (f"{sites_fingerprint(sites)}"
            f"|{agent.name}:{agent_fingerprint(agent)[:16]}"
            f"|{oracle_fingerprint(oracle)}")


class ProgramStore:
    """Append-only JSONL store: ``program_key -> TileProgram`` tiles.

    ``hits``/``misses`` count lookups through :meth:`get` (what the
    facade reports as its warm-start rate); ``skipped_lines`` counts
    unparseable records ignored at load.  Lookups, appends and counters
    are serialized under one lock, so facades on several threads may
    share one store.
    """

    def __init__(self, path: str):
        self.path = path
        self._mem: dict = {}            # key -> {site_key: (tiles...)}
        self.hits = 0
        self.misses = 0
        self.skipped_lines = 0
        self._fh = None
        self._lock = threading.Lock()
        self._read_offset = 0           # file bytes folded into _mem so far
        self._load()

    # -- persistence ---------------------------------------------------------
    def _load(self) -> None:
        self._read_offset = 0
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        self._read_offset = len(data)
        for raw in data.split(b"\n"):
            self._apply_line(raw)

    def _apply_line(self, raw: bytes) -> bool:
        """Parse one JSONL record into ``_mem`` (last wins); ``False``
        (counting ``skipped_lines``) on anything unparseable."""
        line = raw.strip()
        if not line:
            return False
        try:
            rec = json.loads(line.decode("utf-8"))
            key = rec["k"]
            tiles = {str(sk): tuple(int(x) for x in tv)
                     for sk, tv in rec["v"].items()}
        except (ValueError, KeyError, TypeError, AttributeError):
            self.skipped_lines += 1
            return False
        self._mem[key] = tiles          # duplicate keys: last wins
        return True

    def refresh(self) -> int:
        """Fold in records appended to the file since open (or the last
        refresh), e.g. by another process sharing the file.  Returns the
        number of records applied, last-wins like :meth:`_load`.

        Only complete (newline-terminated) lines are consumed: a torn
        tail from a writer caught mid-append stays unread until the next
        refresh sees its newline.  Records this store appended itself
        may be re-applied — idempotent by last-wins."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            try:
                size = os.path.getsize(self.path)
            except OSError:
                return 0
            if size <= self._read_offset:
                return 0
            with open(self.path, "rb") as f:
                f.seek(self._read_offset)
                data = f.read()
            end = data.rfind(b"\n")
            if end < 0:
                return 0
            chunk = data[:end + 1]
            self._read_offset += len(chunk)
            return sum(self._apply_line(raw) for raw in chunk.split(b"\n"))

    def _append(self, key: str, tiles: dict) -> None:
        if self._fh is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a")
        rec = {"k": key, "v": {sk: list(tv) for sk, tv in tiles.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- mapping -------------------------------------------------------------
    def get(self, key: str) -> Optional[TileProgram]:
        with self._lock:
            tiles = self._mem.get(key)
            if tiles is None:
                self.misses += 1
                return None
            self.hits += 1
            return TileProgram(dict(tiles))

    def put(self, key: str, program: TileProgram) -> None:
        tiles = {str(sk): tuple(int(x) for x in tv)
                 for sk, tv in program.tiles.items()}
        with self._lock:
            self._append(key, tiles)
            self._mem[key] = tiles

    def records(self) -> dict:
        """Plain-dict snapshot ``{key: {site_key: [t0, t1, t2]}}``."""
        with self._lock:
            return {k: {sk: list(tv) for sk, tv in tiles.items()}
                    for k, tiles in self._mem.items()}

    def stats(self) -> dict:
        with self._lock:
            n = self.hits + self.misses
            return {"entries": len(self._mem), "hits": self.hits,
                    "misses": self.misses,
                    "hit_rate": (self.hits / n) if n else 0.0,
                    "skipped_lines": self.skipped_lines}

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._mem

    def __enter__(self) -> "ProgramStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_program_store(path: str):
    """A :class:`ProgramStore` on a local JSONL path, or for a
    ``fleet://host:port`` path a
    :class:`~repro_torch.fleet.artifacts.RemoteProgramStore`: a live,
    push-updated mirror of a ``serve-artifacts`` daemon's store."""
    if isinstance(path, str) and path.startswith("fleet://"):
        from repro_torch.fleet.artifacts import RemoteProgramStore
        return RemoteProgramStore(path)
    return ProgramStore(path)


def tune_through_store(sites: Sequence, agent, space, oracle,
                       store: Optional[ProgramStore]
                       ) -> Tuple[TileProgram, bool]:
    """The facade's warm-start code path: look the site set up in
    ``store``, tune only on a miss (appending the fresh program).  Tuning
    is the port's ``tune(sites, agent, space, env)``: the greedy pick
    among the actions ``oracle`` prices as legal (``env`` is
    :func:`~repro_torch.core.vectorizer.mask_env` of it).  Returns
    ``(program, hit)`` — on a hit the agent and the oracle are never
    touched."""
    sites = list(sites)
    if store is None or not sites:
        return tune(sites, agent, space, mask_env(oracle)), False
    key = program_key(sites, agent, oracle)
    prog = store.get(key)
    if prog is not None:
        return prog, True
    prog = tune(sites, agent, space, mask_env(oracle))
    store.put(key, prog)
    return prog, False
