"""``fleet serve-artifacts``: the shared artifact service and its client
mirrors (the port of ``repro/fleet/artifacts.py``, speaking its protocol).

One daemon fronts a :class:`~repro_torch.measure.db.MeasureDB` and/or a
:class:`~repro_torch.artifacts.store.ProgramStore` over the
:mod:`repro_torch.measure.wire` framing:

* **append**: ``put``/``quarantine`` requests write through to the backing
  store (acked, so a client knows its record is durable);
* **push invalidation**: a connection may ``subscribe`` to a store;
  appends from any client are pushed to all *other* subscribers as they
  land.  The pull fallback is :meth:`ProgramStore.refresh`: the server
  folds in records appended by co-located processes before every ``sync``;
* **versioned GC**: ``snapshot`` copies the stores into a
  ``version_%06d`` directory with a manifest written last and keeps the
  newest ``keep_n``.

The client halves, :class:`RemoteMeasureDB` and
:class:`RemoteProgramStore`, present the *local* store interfaces over a
full in-memory mirror (synced at connect, push-updated afterwards): ``get``
never touches the network, ``put`` writes through.  A ``fleet://host:port``
string wherever a ``db_path=``/``program_store=`` path is accepted makes
that caller a fleet client (``open_measure_db`` / ``open_program_store``).

Degradation: a lost artifact connection never fails a measurement or a
tune: reads keep serving the mirror, writes land locally and count
``put_failures``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Iterator, Optional

from repro_torch.artifacts.store import ProgramStore
from repro_torch.core.vectorizer import TileProgram
from repro_torch.fleet import rpc
from repro_torch.fleet.rpc import (FLEET_SCHEME, PROTO_VERSION, FrameServer,
                                   SocketStream, format_address,
                                   parse_address)
from repro_torch.measure.db import MeasureDB, MeasureRecord


def _wire_value(v) -> "float | None":
    v = float(v)
    return None if not math.isfinite(v) else v


def _from_wire(v) -> float:
    return float("inf") if v is None else float(v)


def _tiles_from_wire(d: dict) -> dict:
    return {str(sk): tuple(int(x) for x in tv) for sk, tv in d.items()}


def _tiles_to_wire(tiles: dict) -> dict:
    return {sk: list(tv) for sk, tv in tiles.items()}


# -- versioned GC (keep N complete versions) ---------------------------------
def complete_versions(versions_dir: str) -> "list[int]":
    """Sorted version numbers whose directory holds a manifest (written
    last: a version without one is torn and invisible)."""
    try:
        entries = os.listdir(versions_dir)
    except OSError:
        return []
    out = []
    for e in entries:
        if not e.startswith("version_"):
            continue
        try:
            v = int(e.split("_", 1)[1])
        except ValueError:
            continue                    # tmp dirs and strangers
        if os.path.exists(os.path.join(versions_dir, e, "manifest.json")):
            out.append(v)
    return sorted(out)


def write_version(versions_dir: str, sources: dict,
                  keep_n: int = 3) -> int:
    """Copy ``sources`` (``{name_in_version: src_path}``) into the next
    ``version_%06d`` directory (files first, ``manifest.json`` last, then
    an atomic rename from a tmp dir) and GC all but the newest ``keep_n``
    complete versions.  Returns the new version number."""
    if keep_n < 1:
        raise ValueError(f"keep_n must be >= 1, got {keep_n}")
    os.makedirs(versions_dir, exist_ok=True)
    existing = complete_versions(versions_dir)
    v = (existing[-1] + 1) if existing else 0
    final = os.path.join(versions_dir, f"version_{v:06d}")
    tmp = final + f".tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    copied = []
    for name, src in sorted(sources.items()):
        if src is not None and os.path.exists(src):
            shutil.copyfile(src, os.path.join(tmp, name))
            copied.append(name)
    manifest = {"version": v, "files": copied, "created": time.time()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    os.rename(tmp, final)
    for old in complete_versions(versions_dir)[:-keep_n]:
        shutil.rmtree(os.path.join(versions_dir, f"version_{old:06d}"),
                      ignore_errors=True)
    return v


# -- server ------------------------------------------------------------------
def _measure_records(db: MeasureDB) -> "tuple[dict, dict]":
    """The last-wins state of a MeasureDB's on-disk log, failed pairs
    (``null``) included: the sync payload.  Read from the file, so
    LRU-evicted entries are served too."""
    db.flush()
    records: dict = {}
    quarantined: dict = {}
    if not os.path.exists(db.path):
        return records, quarantined
    with open(db.path, "rb") as f:
        for raw in f.read().split(b"\n"):
            line = raw.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
                key = rec["k"]
                val = None if rec["v"] is None else float(rec["v"])
            except (ValueError, KeyError, TypeError):
                continue
            records[key] = val
            if rec.get("kind") == "quarantine":
                quarantined[key] = {"attempts": int(rec.get("attempts", 0)),
                                    "reason": str(rec.get("reason", ""))}
    return records, quarantined


class _Conn:
    """One subscribed client connection (server side)."""

    def __init__(self, stream: SocketStream):
        self.stream = stream
        self.wlock = threading.Lock()

    def send(self, msg: dict) -> bool:
        try:
            with self.wlock:
                self.stream.write(msg)
            return True
        except (OSError, ValueError):
            return False                # subscriber gone; reaped on close


class ArtifactServer(FrameServer):
    """Serve a MeasureDB and/or a ProgramStore to fleet clients.

    ``measure_db`` / ``program_store`` take instances (borrowed) or paths
    (opened and owned).  ``versions_dir`` enables :meth:`snapshot` with
    keep-``keep_n`` GC; ``snapshot_every`` (appends) makes it automatic.
    """

    def __init__(self, measure_db=None, program_store=None,
                 host: str = "127.0.0.1", port: int = 0,
                 versions_dir: Optional[str] = None, keep_n: int = 3,
                 snapshot_every: Optional[int] = None):
        if measure_db is None and program_store is None:
            raise ValueError("serve-artifacts needs a measure DB and/or a "
                             "program store to front")
        super().__init__(host=host, port=port)
        self._owns_db = isinstance(measure_db, str)
        self._owns_store = isinstance(program_store, str)
        self.measure_db = MeasureDB(measure_db) \
            if self._owns_db else measure_db
        self.program_store = ProgramStore(program_store) \
            if self._owns_store else program_store
        self.versions_dir = versions_dir
        self.keep_n = keep_n
        self.snapshot_every = snapshot_every
        self._state_lock = threading.Lock()
        self._subscribers: "dict[str, set[_Conn]]" = {
            "measure": set(), "program": set()}
        self._conn_by_stream: "dict[SocketStream, _Conn]" = {}
        self._appends_since_snapshot = 0
        self.pushes_sent = 0

    @property
    def stores(self) -> "tuple[str, ...]":
        return tuple(name for name, s in
                     (("measure", self.measure_db),
                      ("program", self.program_store)) if s is not None)

    # -- per-connection protocol ------------------------------------------
    def handle(self, stream: SocketStream) -> None:
        hello = stream.read()
        if not isinstance(hello, dict) or hello.get("type") != "hello":
            return
        conn = _Conn(stream)
        if hello.get("proto", PROTO_VERSION) != PROTO_VERSION:
            conn.send({"type": "error",
                       "error": f"unsupported proto {hello.get('proto')}"})
            return
        with self._state_lock:
            self._conn_by_stream[stream] = conn
        conn.send({"type": "welcome", "role": "artifacts",
                   "proto": PROTO_VERSION, "stores": list(self.stores)})
        while True:
            msg = stream.read()
            if msg is None or msg.get("type") == "bye":
                return
            rid = msg.get("id")
            try:
                reply = self._handle_msg(conn, msg)
            except Exception as e:      # a bad request must not kill it
                reply = {"type": "error", "error": f"{type(e).__name__}: {e}"}
            if reply is not None and rid is not None:
                conn.send(dict(reply, re=rid))

    def connection_closed(self, stream: SocketStream) -> None:
        with self._state_lock:
            conn = self._conn_by_stream.pop(stream, None)
            if conn is not None:
                for subs in self._subscribers.values():
                    subs.discard(conn)

    def _store_for(self, msg):
        name = msg.get("store")
        store = {"measure": self.measure_db,
                 "program": self.program_store}.get(name)
        if store is None:
            raise ValueError(f"no such store: {name!r} (serving "
                             f"{list(self.stores)})")
        return name, store

    def _handle_msg(self, conn: _Conn, msg: dict) -> Optional[dict]:
        kind = msg.get("type")
        if kind == "sync":
            name, store = self._store_for(msg)
            if name == "measure":
                records, quarantined = _measure_records(store)
                return {"type": "state", "store": name,
                        "records": records, "quarantined": quarantined}
            store.refresh()             # co-located writers' appends
            return {"type": "state", "store": name,
                    "records": store.records()}
        if kind == "subscribe":
            name, _ = self._store_for(msg)
            with self._state_lock:
                self._subscribers[name].add(conn)
            return {"type": "ok"}
        if kind == "put":
            name, store = self._store_for(msg)
            key = str(msg["key"])
            if name == "measure":
                store.put(key, _from_wire(msg.get("v")))
                push = {"type": "push", "store": name, "key": key,
                        "v": msg.get("v")}
            else:
                tiles = _tiles_from_wire(dict(msg["v"]))
                store.put(key, TileProgram(tiles))
                push = {"type": "push", "store": name, "key": key,
                        "v": _tiles_to_wire(tiles)}
            self._push(name, push, origin=conn)
            self._maybe_snapshot()
            return {"type": "ok"}
        if kind == "quarantine":
            if self.measure_db is None:
                raise ValueError("no measure store to quarantine in")
            key = str(msg["key"])
            attempts = int(msg.get("attempts", 0))
            reason = str(msg.get("reason", ""))
            self.measure_db.quarantine(key, attempts, reason)
            self._push("measure",
                       {"type": "push", "store": "measure", "key": key,
                        "v": None, "kind": "quarantine",
                        "attempts": attempts, "reason": reason},
                       origin=conn)
            self._maybe_snapshot()
            return {"type": "ok"}
        if kind == "snapshot":
            v = self.snapshot()
            if v is None:
                raise ValueError("versioning is off (no versions_dir)")
            return {"type": "ok", "version": v,
                    "kept": complete_versions(self.versions_dir)}
        if kind == "ping":
            return {"type": "pong", "stores": list(self.stores)}
        raise ValueError(f"unknown request type {kind!r}")

    def _push(self, store_name: str, push: dict, origin: _Conn) -> None:
        with self._state_lock:
            targets = [c for c in self._subscribers[store_name]
                       if c is not origin]
        for c in targets:
            if c.send(push):
                self.pushes_sent += 1

    # -- versioning --------------------------------------------------------
    def _maybe_snapshot(self) -> None:
        if self.snapshot_every is None or self.versions_dir is None:
            return
        with self._state_lock:
            self._appends_since_snapshot += 1
            due = self._appends_since_snapshot >= self.snapshot_every
            if due:
                self._appends_since_snapshot = 0
        if due:
            self.snapshot()

    def snapshot(self) -> Optional[int]:
        """Version the current store files (keep-``keep_n`` GC); ``None``
        when versioning is off."""
        if self.versions_dir is None:
            return None
        sources = {}
        if self.measure_db is not None:
            self.measure_db.flush()
            sources["measure.jsonl"] = self.measure_db.path
        if self.program_store is not None:
            self.program_store.flush()
            sources["programs.jsonl"] = self.program_store.path
        return write_version(self.versions_dir, sources, keep_n=self.keep_n)

    def close(self) -> None:
        super().close()
        if self._owns_db and self.measure_db is not None:
            self.measure_db.close()
        if self._owns_store and self.program_store is not None:
            self.program_store.close()


# -- client plumbing ----------------------------------------------------------
class _ArtifactClient:
    """One request/response connection to serve-artifacts, shared by a
    remote store: a reader thread routes replies (by the ``re`` echo of
    each request ``id``) and fans push frames out to handlers."""

    def __init__(self, address, timeout: float = 30.0):
        self.host, self.port = parse_address(address)
        self.timeout = timeout
        self._stream = rpc.connect((self.host, self.port), timeout=timeout)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._waiting: "dict[int, Future]" = {}
        self._next_id = 0
        self._push_handlers: list = []
        self._closed = False
        self.connected = False
        try:
            self._stream.write({"type": "hello", "role": "artifacts",
                                "proto": PROTO_VERSION})
            welcome = self._stream.read()
        except (OSError, EOFError, ValueError) as e:
            self._stream.close()
            raise ConnectionError(
                f"artifact service handshake failed: {e}") from e
        if not isinstance(welcome, dict) or welcome.get("type") != "welcome":
            self._stream.close()
            raise ConnectionError(
                f"artifact service handshake failed: {welcome!r}")
        self.stores = tuple(welcome.get("stores", ()))
        self.connected = True
        self._stream.settimeout(None)   # the reader thread blocks
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"fleet-artifacts-{self.port}")
        self._reader.start()

    def add_push_handler(self, handler) -> None:
        self._push_handlers.append(handler)

    def _read_loop(self) -> None:
        try:
            while True:
                msg = self._stream.read()
                if msg is None:
                    raise EOFError("artifact service closed the connection")
                if "re" in msg:
                    with self._lock:
                        fut = self._waiting.pop(msg["re"], None)
                    if fut is not None:
                        fut.set_result(msg)
                elif msg.get("type") == "push":
                    for h in list(self._push_handlers):
                        try:
                            h(msg)
                        except Exception:
                            pass        # a bad handler never stops reads
        except (OSError, EOFError, ValueError) as e:
            with self._lock:
                self.connected = False
                waiting, self._waiting = self._waiting, {}
            err = ConnectionError(
                f"artifact service connection lost ({type(e).__name__})")
            for fut in waiting.values():
                fut.set_exception(err)

    def request(self, msg: dict) -> dict:
        with self._lock:
            if self._closed or not self.connected:
                raise ConnectionError("artifact service connection is down")
            self._next_id += 1
            rid = self._next_id
            fut: Future = Future()
            self._waiting[rid] = fut
        try:
            with self._wlock:
                self._stream.write(dict(msg, id=rid))
            reply = fut.result(timeout=self.timeout)
        except (OSError, ValueError, _FutureTimeout, TimeoutError) as e:
            with self._lock:
                self._waiting.pop(rid, None)
            raise ConnectionError(
                f"artifact request failed ({type(e).__name__})") from e
        if reply.get("type") == "error":
            raise RuntimeError(f"artifact service error: "
                               f"{reply.get('error')}")
        return reply

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.connected = False
        try:
            with self._wlock:
                self._stream.write({"type": "bye"})
        except (OSError, ValueError):
            pass
        self._stream.close()
        self._reader.join(timeout=5.0)


class _RemoteStore:
    """What both remote stores share: the client, the subscription, the
    address as a path, and the write-through that degrades to a counted
    local write."""

    STORE = ""

    def __init__(self, address, timeout: float = 30.0):
        self._c = _ArtifactClient(address, timeout=timeout)
        if self.STORE not in self._c.stores:
            self._c.close()
            raise ConnectionError(
                f"artifact service at {address} serves no {self.STORE} "
                f"store (has: {list(self._c.stores)})")
        self.path = FLEET_SCHEME + format_address(self._c.host, self._c.port)
        self._lock = threading.Lock()
        self._mem: dict = {}
        self.skipped_lines = 0
        self.pushes_received = 0
        self.put_failures = 0
        self._c.add_push_handler(self._push_for_me)
        self._c.request({"type": "subscribe", "store": self.STORE})
        self._sync()

    def _push_for_me(self, msg: dict) -> None:
        if msg.get("store") == self.STORE:
            self._on_push(msg)

    def _write_through(self, msg: dict) -> None:
        try:
            self._c.request(msg)
        except (ConnectionError, RuntimeError):
            with self._lock:
                self.put_failures += 1

    def refresh(self) -> int:
        """Pull fallback: a full re-sync from the service."""
        return self._sync()

    def close(self) -> None:
        self._c.close()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._mem

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RemoteMeasureDB(_RemoteStore):
    """A :class:`~repro_torch.measure.db.MeasureDB` view of the fleet's
    shared timing store: a full mirror synced at connect and push-updated
    after.  ``get`` is local; ``put``/``quarantine`` write through
    (acked).  A lost connection degrades to the mirror (``put_failures``
    counts writes that only landed here), never an exception out of the
    measurement path."""

    STORE = "measure"

    def __init__(self, address, timeout: float = 30.0):
        self._quarantined: dict = {}
        super().__init__(address, timeout=timeout)

    def _sync(self) -> int:
        st = self._c.request({"type": "sync", "store": "measure"})
        with self._lock:
            before = len(self._mem)
            for k, v in st.get("records", {}).items():
                self._mem[k] = _from_wire(v)
            for k, info in st.get("quarantined", {}).items():
                self._quarantined[k] = dict(info)
            return len(self._mem) - before

    def _on_push(self, msg: dict) -> None:
        with self._lock:
            key = str(msg.get("key"))
            self._mem[key] = _from_wire(msg.get("v"))
            if msg.get("kind") == "quarantine":
                self._quarantined[key] = {
                    "attempts": int(msg.get("attempts", 0)),
                    "reason": str(msg.get("reason", ""))}
            self.pushes_received += 1

    # -- MeasureDB surface -------------------------------------------------
    def get(self, key: str) -> Optional[float]:
        with self._lock:
            v = self._mem.get(key)
            if v is None and key in self._quarantined:
                return float("inf")
            return v

    def put(self, key: str, val: float) -> None:
        val = float(val)
        with self._lock:
            self._mem[key] = val
        self._write_through({"type": "put", "store": "measure",
                             "key": key, "v": _wire_value(val)})

    def quarantine(self, key: str, attempts: int, reason: str) -> None:
        info = {"attempts": int(attempts), "reason": str(reason)}
        with self._lock:
            self._quarantined[key] = info
            self._mem[key] = float("inf")
        self._write_through({"type": "quarantine", "key": key, **info})

    def quarantined(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._quarantined.get(key)

    @property
    def n_quarantined(self) -> int:
        with self._lock:
            return len(self._quarantined)

    def flush(self) -> None:
        """Nothing to flush: every write is acked by the service."""

    def iter_records(self) -> Iterator[MeasureRecord]:
        """Resolved measurements of the mirror, shaped like
        :meth:`MeasureDB.iter_records` (quarantined and malformed keys
        skipped)."""
        with self._lock:
            snapshot = dict(self._mem)
            poisoned = set(self._quarantined)
        for key, val in snapshot.items():
            parts = key.split("|")
            if key in poisoned or len(parts) != 3:
                continue
            site_key, _, backend = parts
            yield MeasureRecord(key=key, kind=site_key.split(":", 1)[0],
                                value=val, fingerprint=backend)


class RemoteProgramStore(_RemoteStore):
    """A :class:`~repro_torch.artifacts.store.ProgramStore` view of the
    fleet's shared program store, with :class:`RemoteMeasureDB`'s mirror,
    write-through and push discipline: a client sees newly tuned programs
    arrive without re-opening anything (``pushes_received``); ``refresh``
    is the pull fallback (the server refreshes its store from disk
    first)."""

    STORE = "program"

    def __init__(self, address, timeout: float = 30.0):
        self.hits = 0
        self.misses = 0
        super().__init__(address, timeout=timeout)

    def _sync(self) -> int:
        st = self._c.request({"type": "sync", "store": "program"})
        applied = 0
        with self._lock:
            for k, tiles in st.get("records", {}).items():
                try:
                    self._mem[str(k)] = _tiles_from_wire(tiles)
                    applied += 1
                except (TypeError, ValueError, AttributeError):
                    self.skipped_lines += 1
        return applied

    def _on_push(self, msg: dict) -> None:
        with self._lock:
            try:
                self._mem[str(msg["key"])] = _tiles_from_wire(msg["v"])
            except (KeyError, TypeError, ValueError, AttributeError):
                self.skipped_lines += 1
                return
            self.pushes_received += 1

    # -- ProgramStore surface ----------------------------------------------
    def get(self, key: str) -> Optional[TileProgram]:
        with self._lock:
            tiles = self._mem.get(key)
            if tiles is None:
                self.misses += 1
                return None
            self.hits += 1
            return TileProgram(dict(tiles))

    def put(self, key: str, program: TileProgram) -> None:
        tiles = _tiles_from_wire(program.tiles)
        with self._lock:
            self._mem[key] = tiles
        self._write_through({"type": "put", "store": "program", "key": key,
                             "v": _tiles_to_wire(tiles)})

    def records(self) -> dict:
        with self._lock:
            return {k: _tiles_to_wire(tiles) for k, tiles in self._mem.items()}

    def stats(self) -> dict:
        with self._lock:
            n = self.hits + self.misses
            return {"entries": len(self._mem), "hits": self.hits,
                    "misses": self.misses,
                    "hit_rate": (self.hits / n) if n else 0.0,
                    "skipped_lines": self.skipped_lines,
                    "pushes_received": self.pushes_received}
