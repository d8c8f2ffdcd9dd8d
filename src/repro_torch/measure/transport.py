"""The in-process :class:`~repro_torch.core.protocols.MeasureTransport`
(the port of ``repro/measure/transport.py``).

``submit`` serves DB hits as already-resolved futures, coalesces duplicate
keys to one measurement, executes the misses eagerly on the calling thread
(there is no worker to hand them to, so ``drain()`` is a no-op by the time
it can be called) and streams every fresh timing into the attached
:class:`~repro_torch.measure.db.MeasureDB` exactly once per key.

:class:`TransportMeasureFn` puts any transport behind the synchronous
batched ``measure_fn(sites, tiles) -> (n,) seconds`` hook that
:class:`~repro_torch.core.env.MeasuredEnv` consumes: submit, gather.
:class:`CachedMeasureFn` is the runner+DB spelling of the same.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from repro_torch.measure.db import MeasureDB, make_key


def _resolved(value: float) -> Future:
    f = Future()
    f.set_result(float(value))
    return f


class _TransportStats:
    """The shared counter block every transport reports via ``stats()``."""

    def __init__(self):
        self.hits = 0            # pairs served from the DB
        self.misses = 0          # pairs that required a measurement
        self.coalesced = 0       # pairs folded onto an in-flight duplicate
        self.timed_pairs = 0     # successful measurements performed
        self.failed_pairs = 0    # measurements resolved to inf (fail-closed)
        self.retries = 0         # jobs requeued after a worker death

    def snapshot(self, in_flight: int = 0) -> dict:
        """Counter snapshot under the reference's names."""
        n = self.hits + self.misses + self.coalesced
        return {"transport_hits_total": self.hits,
                "transport_misses_total": self.misses,
                "transport_coalesced_total": self.coalesced,
                "transport_timed_pairs_total": self.timed_pairs,
                "transport_failed_pairs_total": self.failed_pairs,
                "transport_retries_total": self.retries,
                "transport_inflight_pairs": in_flight,
                "transport_hit_ratio": (self.hits / n) if n else 0.0}


class InProcessTransport:
    """Eager single-process transport: the calling thread measures.

    ``runner`` is any batched ``(sites, tiles) -> (n,) seconds`` callable
    exposing ``backend_key`` (a :class:`~repro_torch.measure.runner.
    MeasureRunner`, or a counting spy in tests); ``db=None`` disables
    persistence but keeps the statistics.
    """

    def __init__(self, runner, db: Optional[MeasureDB] = None):
        self.runner = runner
        self.db = db
        self._stats = _TransportStats()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: dict = {}       # key -> Future (across submit calls)
        self._closed = False

    @property
    def backend_key(self) -> str:
        return getattr(self.runner, "backend_key", "unknown")

    def submit(self, sites: Sequence, tiles) -> list:
        if self._closed:
            raise RuntimeError("submit on a closed transport")
        tiles = np.asarray(tiles, np.int64)
        backend = self.backend_key
        futs: list = [None] * len(sites)
        run_idx: list = []              # (index, key) pairs to measure here
        with self._lock:
            for i, (s, t) in enumerate(zip(sites, tiles)):
                key = make_key(s.key(), t, backend)
                v = self.db.get(key) if self.db is not None else None
                if v is not None:
                    self._stats.hits += 1
                    futs[i] = _resolved(v)
                elif key in self._inflight:
                    # duplicate of a key this submit call — or a concurrent
                    # one from another thread — is already measuring
                    self._stats.coalesced += 1
                    futs[i] = self._inflight[key]
                else:
                    f: Future = Future()
                    self._inflight[key] = f
                    futs[i] = f
                    run_idx.append((i, key))
        if run_idx:
            idx = [i for i, _ in run_idx]
            try:
                vals = np.asarray(self.runner([sites[i] for i in idx],
                                              tiles[idx]), np.float64)
            except BaseException:
                # a runner that raises (instead of returning inf) must not
                # strand its in-flight futures: anyone already coalesced
                # onto them would block forever.  Fail them closed, then
                # surface the error to this caller.
                with self._lock:
                    for _, key in run_idx:
                        f = self._inflight.pop(key, None)
                        if f is not None:
                            self._stats.misses += 1
                            self._stats.failed_pairs += 1
                            f.set_result(float("inf"))
                    self._idle.notify_all()
                raise
            with self._lock:
                for (i, key), v in zip(run_idx, vals):
                    v = float(v)
                    if self.db is not None:
                        self.db.put(key, v)
                    self._stats.misses += 1
                    if np.isfinite(v):
                        self._stats.timed_pairs += 1
                    else:
                        self._stats.failed_pairs += 1
                    self._inflight.pop(key).set_result(v)
                self._idle.notify_all()
        return futs

    def drain(self) -> None:
        """Block until no measurement (from any thread) is in flight."""
        with self._lock:
            self._idle.wait_for(lambda: not self._inflight)

    def close(self) -> None:
        self._closed = True
        if self.db is not None:
            self.db.close()

    def health(self) -> str:
        """In-process: either the calling thread can measure (``ok``)
        or the transport is closed (``down``) — nothing in between."""
        return "down" if self._closed else "ok"

    def stats(self) -> dict:
        with self._lock:
            return self._stats.snapshot(in_flight=len(self._inflight))

    def __enter__(self) -> "InProcessTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TransportMeasureFn:
    """Any :class:`~repro_torch.core.protocols.MeasureTransport` behind the
    synchronous batched ``measure_fn`` hook of
    :class:`~repro_torch.core.env.MeasuredEnv`: submit the batch, gather.

    Keeps the historical ``hits`` / ``misses`` / ``hit_rate`` reporting
    surface (delegated to the transport's counters) so callers that print
    cache statistics work across every transport."""

    def __init__(self, transport):
        self.transport = transport

    def __call__(self, sites: Sequence, tiles) -> np.ndarray:
        futs = self.transport.submit(sites, tiles)
        # gather blocks on exactly this batch's futures — NOT drain(),
        # which would also wait out other sessions' unrelated in-flight
        # work on a shared transport
        return np.array([f.result() for f in futs], np.float64)

    @property
    def hits(self) -> int:
        return self.transport.stats()["transport_hits_total"]

    @property
    def misses(self) -> int:
        return self.transport.stats()["transport_misses_total"]

    @property
    def hit_rate(self) -> float:
        return self.transport.stats()["transport_hit_ratio"]

    @property
    def db(self):
        return getattr(self.transport, "db", None)


class CachedMeasureFn(TransportMeasureFn):
    """``CachedMeasureFn(runner, db)`` is exactly
    ``TransportMeasureFn(InProcessTransport(runner, db))``; ``runner`` may
    also be an already-built :class:`InProcessTransport` (which carries
    its own db)."""

    def __init__(self, runner, db: Optional[MeasureDB] = None):
        if isinstance(runner, InProcessTransport):
            if db is not None:
                raise TypeError("the transport carries its own db")
            super().__init__(runner)
        else:
            super().__init__(InProcessTransport(runner, db))

    @property
    def runner(self):
        return self.transport.runner
