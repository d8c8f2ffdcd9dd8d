"""Deterministic fault injection for the measurement stack (the port of
``repro/measure/faults.py``).

The transport conformance suite pins down *what* every transport must do;
this module supplies the machinery to show those invariants hold while
workers crash, wedge, tear result frames mid-write and timings jitter.
Everything is seedable and deterministic: a fault schedule is a pure
function of ``(seed, event key)``, so a failing chaos run replays exactly.

:class:`FaultSchedule`
    maps an event key (e.g. ``"site|tiles"``) to a fault name or ``None``
    by a crc32 hash: no state, no generator to thread around.

:class:`ChaosRunner`
    a worker-side wrapper around any batched runner (on the card, the real
    :class:`~repro_torch.measure.runner.MeasureRunner`).  ``crash`` is
    ``os._exit`` mid-job, ``hang`` sleeps past the pool's ``job_timeout``,
    ``torn`` writes a partial or garbage result frame onto the protocol
    pipe and dies, ``noise`` adds deterministic latency without touching
    the value.  Destructive faults fire once per event key (sentinel files
    in ``state_dir``), so the retried job succeeds within the pool's
    ``max_attempts`` and values and once-per-key DB writes stay exact.

:class:`FaultInjectionTransport`
    a parent-side decorator over any
    :class:`~repro_torch.core.protocols.MeasureTransport`: it delegates the
    whole surface (values, coalescing, counters) and injects latency noise
    around ``submit`` and ``drain``.
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

FAULTS = ("crash", "hang", "torn", "noise")


class FaultSchedule:
    """``draw(event_key)`` → a fault name or ``None``, a pure function of
    ``(seed, event_key)``.  With ``period=2`` about half of all keys draw
    a fault, spread over ``faults``; a larger ``period`` thins it."""

    def __init__(self, seed: int = 0,
                 faults: Tuple[str, ...] = FAULTS, period: int = 2):
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.seed = seed
        self.faults = tuple(faults)
        self.period = period

    def draw(self, event_key: str) -> Optional[str]:
        h = zlib.crc32(f"{self.seed}|{event_key}".encode())
        slot = h % (len(self.faults) * self.period)
        return self.faults[slot] if slot < len(self.faults) else None


def _tear_frame(fd: int, variant: int) -> None:
    """Write one of three torn result frames onto the protocol pipe: a
    truncated header, a prefix promising more payload than follows, or a
    whole frame of invalid JSON (the parent's ``EOFError`` twice, then
    ``ValueError``)."""
    torn = (b"\x00\x00",                            # truncated header
            struct.pack(">I", 64) + b"garbage",     # truncated payload
            struct.pack(">I", 5) + b"notjs")        # invalid JSON
    os.write(fd, torn[variant % len(torn)])


class ChaosRunner:
    """Worker-side chaos around a batched runner, on the schedule's word.

    ``state_dir`` holds the one-shot sentinel files, shared by every worker
    of a pool through the file system; ``hang_s`` should exceed the pool's
    ``job_timeout`` so a hang is seen as a wedge, not a slow success."""

    def __init__(self, base, schedule: FaultSchedule, state_dir: str,
                 hang_s: float = 3600.0, noise_s: float = 0.05):
        self.base = base
        self.schedule = schedule
        self.state_dir = state_dir
        self.hang_s = hang_s
        self.noise_s = noise_s

    @property
    def backend_key(self) -> str:
        return getattr(self.base, "backend_key", "unknown")

    @property
    def device(self):
        """The base runner's device (the worker readies the card for it)."""
        return getattr(self.base, "device", None)

    def _fire_once(self, fault: str, event_key: str) -> bool:
        """True exactly once per ``(fault, event_key)`` across every worker
        sharing ``state_dir``."""
        name = f"{fault}-{zlib.crc32(event_key.encode()):08x}"
        try:
            fd = os.open(os.path.join(self.state_dir, name),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def _inject(self, event_key: str) -> None:
        fault = self.schedule.draw(event_key)
        if fault is None:
            return
        if fault == "noise":
            # latency only: the measured value survives bit-identical
            u = zlib.crc32(f"noise|{event_key}".encode()) % 1000 / 999.0
            time.sleep(self.noise_s * u)
            return
        if not self._fire_once(fault, event_key):
            return
        if fault == "crash":
            os._exit(3)
        if fault == "hang":
            time.sleep(self.hang_s)
            os._exit(3)             # the parent killed us long ago
        if fault == "torn":
            fd = os.environ.get("REPRO_WORKER_PROTO_FD")
            if fd is not None:      # outside a worker: a crash
                _tear_frame(int(fd), zlib.crc32(event_key.encode()))
            os._exit(3)

    def __call__(self, sites: Sequence, tiles) -> np.ndarray:
        tiles = np.asarray(tiles, np.int64)
        for s, t in zip(sites, tiles):
            self._inject(f"{s.key()}|{tuple(int(x) for x in t)}")
        return self.base(sites, tiles)


class FaultInjectionTransport:
    """Parent-side chaos decorator over any MeasureTransport.

    Every call delegates, so values, future identity (coalescing), counter
    arithmetic and DB writes are untouched; only timing changes, by
    deterministic latency noise before ``submit`` and ``drain``.  Pair it
    with a :class:`ChaosRunner` factory in the workers to shake both ends
    of the pipe at once."""

    def __init__(self, inner, seed: int = 0, noise_s: float = 0.02):
        self.inner = inner
        self.schedule = FaultSchedule(seed, faults=("noise",), period=2)
        self.noise_s = noise_s
        self.faults_injected = 0
        self._calls = 0

    @property
    def backend_key(self) -> str:
        return self.inner.backend_key

    @property
    def db(self):
        return getattr(self.inner, "db", None)

    def _maybe_noise(self, what: str) -> None:
        self._calls += 1
        if self.schedule.draw(f"{what}|{self._calls}") is None:
            return
        u = zlib.crc32(f"{what}|{self._calls}|u".encode()) % 1000 / 999.0
        self.faults_injected += 1
        time.sleep(self.noise_s * u)

    def submit(self, sites: Sequence, tiles) -> list:
        self._maybe_noise("submit")
        return self.inner.submit(sites, tiles)

    def drain(self) -> None:
        self._maybe_noise("drain")
        self.inner.drain()

    def close(self) -> None:
        self.inner.close()

    def health(self) -> str:
        h = getattr(self.inner, "health", None)
        return h() if callable(h) else "ok"

    def stats(self) -> dict:
        s = self.inner.stats()
        s["faults_injected"] = self.faults_injected
        return s

    def __enter__(self) -> "FaultInjectionTransport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getattr__(self, name):
        # a transparent decorator: what is specific to the inner transport
        # (worker_restarts, runner, ...) shows through
        return getattr(self.inner, name)
