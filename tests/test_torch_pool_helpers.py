"""Worker-side runner factories for the port's transport tests.

The pool's ``factory="module:attr"`` seam imports these *inside real
worker subprocesses* (the pool hands its ``sys.path`` to the worker, which
holds this directory under pytest).  So the conformance suite runs
deterministic, or deliberately crashing, runners through the genuine pipe
protocol.  This file imports neither JAX nor the JAX package: a port
worker loads only the port (and torch where a runner needs it).  It holds
no tests.

Values derive from ``zlib.crc32`` of the DB key material (``hash()`` is
salted per process), so in-process, pool and socket results are bitwise
equal, and equal to the JAX package's ``tests/pool_helpers.py``.
"""
from __future__ import annotations

import os
import sys
import time
import zlib

import numpy as np


def fake_value(site_key: str, tiles) -> float:
    """Deterministic pseudo-seconds for one (site, tiles) pair."""
    text = f"{site_key}|{tuple(int(x) for x in tiles)}"
    return 1e-4 * (1 + zlib.crc32(text.encode()) % 1000)


class FakeRunner:
    """Deterministic batched runner with a stable backend fingerprint."""

    backend_key = "fake-backend"

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.calls = 0
        self.pairs = 0

    def __call__(self, sites, tiles):
        self.calls += 1
        self.pairs += len(sites)
        if self.delay:
            time.sleep(self.delay)
        return np.array([fake_value(s.key(), t)
                         for s, t in zip(sites, tiles)], np.float64)


class _BoomRunner(FakeRunner):
    """Kills its worker on the site named ``"boom"``.  ``transient``: once
    (sentinel file ``REPRO_TEST_BOOM_FILE``), so the respawned worker
    measures the pair; else every time."""

    def __init__(self, transient: bool):
        super().__init__()
        self.transient = transient

    def __call__(self, sites, tiles):
        sentinel = os.environ.get("REPRO_TEST_BOOM_FILE", "")
        for s in sites:
            if s.site == "boom" and not (self.transient and sentinel
                                         and os.path.exists(sentinel)):
                if self.transient and sentinel:
                    with open(sentinel, "w") as f:
                        f.write("died once\n")
                os._exit(3)         # a hard worker death
        return super().__call__(sites, tiles)


class FailRunner(FakeRunner):
    """Fails (``inf``) on any site named ``"fail"``, measures the rest."""

    def __call__(self, sites, tiles):
        out = super().__call__(sites, tiles)
        return np.where([s.site == "fail" for s in sites], np.inf, out)


class RaisingRunner(FakeRunner):
    """Raises (instead of returning inf) on any site named ``"boom"``."""

    def __call__(self, sites, tiles):
        if any(s.site == "boom" for s in sites):
            raise RuntimeError("simulated runner bug")
        return super().__call__(sites, tiles)


class WedgingRunner(FakeRunner):
    """Hangs on any site named ``"wedge"``: what ``job_timeout`` is for."""

    def __call__(self, sites, tiles):
        if any(s.site == "wedge" for s in sites):
            time.sleep(3600)
        return super().__call__(sites, tiles)


def _foreign_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


class ModulesRunner(FakeRunner):
    """Measures ``inf`` where its process has imported JAX or the JAX
    package, so a finite value proves the worker stayed free of both."""

    def __init__(self, base=None):
        super().__init__()
        self.base = base

    @property
    def backend_key(self):
        return getattr(self.base, "backend_key", FakeRunner.backend_key)

    @property
    def device(self):
        return getattr(self.base, "device", None)

    def __call__(self, sites, tiles):
        out = super().__call__(sites, tiles) if self.base is None \
            else np.asarray(self.base(sites, tiles), np.float64)
        return np.full(len(sites), np.inf) if _foreign_modules() else out


def deterministic():
    return FakeRunner()


def failing():
    return FailRunner()


def raising():
    return RaisingRunner()


def wedging():
    return WedgingRunner()


def slow():
    return FakeRunner(delay=0.3)


def boom_once():
    return _BoomRunner(transient=True)


def boom_always():
    return _BoomRunner(transient=False)


def modules():
    return ModulesRunner()


def modules_cpu_runner():
    """The port's real runner on the CPU, behind the module check."""
    from repro_torch.measure.runner import MeasureRunner
    return ModulesRunner(MeasureRunner(reps=1, warmup=0, device="cpu"))


# -- chaos factories ----------------------------------------------------------
def chaos():
    """A :class:`repro_torch.measure.faults.ChaosRunner` around a base
    factory: ``REPRO_CHAOS_BASE`` (default the deterministic one),
    ``REPRO_CHAOS_SEED`` (the schedule's seed), ``REPRO_CHAOS_STATE`` (the
    one-shot sentinel directory, required)."""
    import importlib

    from repro_torch.measure.faults import ChaosRunner, FaultSchedule

    base_spec = os.environ.get("REPRO_CHAOS_BASE",
                               "test_torch_pool_helpers:deterministic")
    mod, _, attr = base_spec.partition(":")
    base = getattr(importlib.import_module(mod), attr)()
    return ChaosRunner(base,
                       FaultSchedule(int(os.environ.get("REPRO_CHAOS_SEED",
                                                        "0"))),
                       os.environ["REPRO_CHAOS_STATE"], hang_s=3600.0)


class _TornOnceRunner(FakeRunner):
    """Tears the protocol pipe (and dies) the first time it sees the site
    named ``"torn"`` (sentinel ``REPRO_TEST_TORN_FILE``), then measures it
    on the respawned worker."""

    def __call__(self, sites, tiles):
        from repro_torch.measure.faults import _tear_frame

        sentinel = os.environ.get("REPRO_TEST_TORN_FILE", "")
        for s in sites:
            if s.site == "torn" and sentinel and not os.path.exists(sentinel):
                with open(sentinel, "w") as f:
                    f.write("tore once\n")
                _tear_frame(int(os.environ["REPRO_WORKER_PROTO_FD"]), 1)
                os._exit(3)
        return super().__call__(sites, tiles)


def torn_once():
    return _TornOnceRunner()


class _DieOnJobRunner(FakeRunner):
    """Dies on the first job it receives."""

    def __call__(self, sites, tiles):
        os._exit(3)


def spawn_flaky():
    """The first spawn hands out a runner that dies on any job; every later
    spawn fails during the handshake, driving the dispatcher through its
    respawn backoff.  Sentinel: ``REPRO_TEST_SPAWN_FILE``."""
    sentinel = os.environ["REPRO_TEST_SPAWN_FILE"]
    try:
        fd = os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        os._exit(2)                 # a spawn failure: no ready handshake
    os.close(fd)
    return _DieOnJobRunner()


# -- on the card --------------------------------------------------------------
def _once(env: str) -> bool:
    """True the first time in any process that shares the file ``$env``."""
    try:
        fd = os.open(os.environ[env], os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


class _CardFaultRunner:
    """The port's runner on the card, with one fault the first time it
    sees the site named ``"fault"``: a device-side assert (an index out of
    range on a CUDA tensor, which poisons the context) or, ``hang=True``,
    a kernel that spins for minutes on the card."""

    def __init__(self, hang: bool):
        from repro_torch.measure.runner import MeasureRunner
        self.base = MeasureRunner(reps=1, warmup=1, device="cuda")
        self.hang = hang

    backend_key = property(lambda self: self.base.backend_key)
    device = property(lambda self: self.base.device)

    def __call__(self, sites, tiles):
        import torch
        if any(s.site == "fault" for s in sites) and \
                _once("REPRO_TEST_CARD_FAULT_FILE"):
            if self.hang:
                torch.cuda._sleep(1 << 40)      # minutes of spinning
            else:
                idx = torch.tensor([1 << 20], device="cuda")
                torch.zeros(4, device="cuda")[idx].sum()
            torch.cuda.synchronize()
        return self.base(sites, tiles)


def card_assert_once():
    return _CardFaultRunner(hang=False)


def card_hang_once():
    return _CardFaultRunner(hang=True)
