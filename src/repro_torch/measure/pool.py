"""``WorkerPoolTransport``: fan ``(site, tiles)`` measurements out to N
subprocess workers (the port of ``repro/measure/pool.py``).

Each worker is its own process with its own CUDA context, so a kernel that
crashes, wedges or poisons the context costs one worker, never the tuning
loop.  Workers are started with ``subprocess.Popen([sys.executable, "-m",
"repro_torch.measure.worker"])``, never forked: a forked child of a
process that has initialised CUDA cannot use it.  They speak a
length-prefixed JSON pipe protocol (:mod:`repro_torch.measure.worker`).

Scheduling semantics (the
:class:`~repro_torch.core.protocols.MeasureTransport` contract, the same
conformance suite as the in-process transport):

* ``submit`` does not block: DB hits resolve at once, duplicate keys, in
  one batch or across concurrent submitters, coalesce onto the one
  in-flight job, fresh keys queue for the next idle worker.
* results stream into the attached
  :class:`~repro_torch.measure.db.MeasureDB` as they arrive, once per key.
* a job whose worker dies mid-measurement is requeued and the worker
  respawned; after ``max_attempts`` tries it fails closed to ``inf`` and
  is quarantined in the DB (attempts and reason), so no later run in any
  process re-attempts a pair that kills workers.
* a worker holding one job past ``job_timeout`` is killed (which frees
  its context on the card) and the job requeued, as after a death.
* respawns back off exponentially with deterministic jitter
  (:func:`respawn_backoff`); ``health()`` reports ``ok``, ``degraded``
  (workers lost or backing off) or ``down`` (no dispatcher can make
  progress), the signal :class:`~repro_torch.core.env.MeasuredEnv`'s
  breaker degrades on.

When the workers' runner measures on the card, the pool builds the kernel
libraries once in this process before it spawns, so N workers starting
together do not each run ``nvcc``.

One dispatcher thread per worker feeds its worker one job at a time and
reads the result, so a worker's death is seen where the job is known.
"""
from __future__ import annotations

import os
import select
import subprocess
import sys
import threading
import time
import zlib
from collections import deque
from concurrent.futures import Future
from dataclasses import asdict
from typing import Optional, Sequence

import numpy as np

from repro_torch.measure.db import make_key
from repro_torch.measure.transport import _resolved, _TransportStats
from repro_torch.measure.wire import read_frame, write_frame

_MAX_SPAWN_FAILURES = 3                 # consecutive, per dispatcher thread
WORKER_MODULE = "repro_torch.measure.worker"


def respawn_backoff(failures: int, *, base: float = 0.1, cap: float = 30.0,
                    seed: int = 0) -> float:
    """Seconds to wait before respawn attempt ``failures`` (1-based):
    exponential in the consecutive-failure count, capped, with a
    deterministic multiplicative jitter in ``[0.5, 1.0]`` from ``(seed,
    failures)``, so distinct seeds (one per dispatcher) desynchronise a
    thundering herd yet a run replays exactly."""
    if failures < 1:
        raise ValueError(f"failures must be >= 1, got {failures}")
    d = min(cap, base * (2.0 ** (failures - 1)))
    u = (zlib.crc32(f"{seed}|{failures}".encode()) % 1000) / 999.0
    return d * (0.5 + 0.5 * u)


def _read_frame_deadline(stream, deadline: Optional[float]):
    """:func:`read_frame` bounded by a monotonic ``deadline``:
    ``TimeoutError`` on expiry.  Safe because the protocol is one frame per
    job (the pipe holds nothing between frames, so select sees all)."""
    while True:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("worker did not answer before the "
                                   "deadline (wedged measurement?)")
            r, _, _ = select.select([stream], [], [], remaining)
            if not r:
                continue
        return read_frame(stream)


class _Job:
    __slots__ = ("key", "site", "tiles", "future", "attempts",
                 "t_queued", "t_start", "queue_wait_s")

    def __init__(self, key: str, site, tiles):
        self.key = key
        self.site = site
        self.tiles = [int(x) for x in tiles]
        self.future: Future = Future()
        self.attempts = 0
        # t_queued stamps every (re)entry into the queue, queue_wait_s sums
        # the waits across requeues, t_start marks the hand-off to a worker
        self.t_queued = time.monotonic()
        self.t_start: Optional[float] = None
        self.queue_wait_s = 0.0


class _JobBook:
    """The job accounting the pool and the socket transport share: the
    queue, the in-flight map, the counters, requeue-or-fail and resolve.
    Methods marked *locked* expect ``self._cv`` held."""

    def _init_book(self, db, max_attempts: int) -> None:
        if isinstance(db, str):
            from repro_torch.measure.db import open_measure_db
            db = open_measure_db(db)    # fleet:// paths open remote mirrors
        self.db = db
        self.max_attempts = max_attempts
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: "deque[_Job]" = deque()
        self._inflight: dict = {}       # key -> _Job (queued or running)
        self._stats = _TransportStats()
        self._closing = False
        self._backend: Optional[str] = None
        self.queue_wait_seconds = 0.0   # summed time jobs spent queued
        self.run_seconds = 0.0          # summed time jobs spent running
        self.jobs_finished = 0          # jobs resolved (timed or failed)
        # observer(queue_wait_s, run_s), called as each job leaves; the
        # obs layer wires histograms here
        self.job_observer = None

    def _account(self, job: _Job) -> None:
        """Book a finished job's queue-wait/run split (locked)."""
        run_s = 0.0 if job.t_start is None \
            else time.monotonic() - job.t_start
        self.queue_wait_seconds += job.queue_wait_s
        self.run_seconds += run_s
        self.jobs_finished += 1
        obs = self.job_observer
        if obs is not None:
            try:
                obs(job.queue_wait_s, run_s)
            except Exception:
                pass                    # telemetry never fails a job

    def _requeue_or_fail(self, job: Optional[_Job], hard: bool = False,
                         reason: str = "worker death") -> None:
        """Requeue ``job`` or, its attempts spent, fail it closed (locked).
        Only the attempts-exhausted verdict is quarantined in the DB: a
        ``hard`` failure is the pool's own (a spawn failure, shutdown), the
        pair was never tried, and a persisted ``inf`` would poison every
        later run."""
        if job is None:
            return
        job.attempts += 1
        if hard or job.attempts >= self.max_attempts:
            if not hard and self.db is not None:
                self.db.quarantine(job.key, job.attempts, reason)
            self._stats.failed_pairs += 1
            self._inflight.pop(job.key, None)
            self._account(job)
            job.future.set_result(float("inf"))
        else:
            self._stats.retries += 1
            job.t_queued = time.monotonic()     # the wait clock restarts
            job.t_start = None
            self._pending.append(job)

    def _resolve(self, job: _Job, v: float) -> None:
        with self._cv:
            if self.db is not None:
                self.db.put(job.key, v)
            if np.isfinite(v):
                self._stats.timed_pairs += 1
            else:
                self._stats.failed_pairs += 1
            self._inflight.pop(job.key, None)
            self._account(job)
            job.future.set_result(v)
            self._cv.notify_all()

    def _fail_pending(self) -> None:
        """No dispatcher is left (locked): fail every queued job closed so
        ``drain()`` never hangs; nothing is quarantined."""
        while self._pending:
            self._requeue_or_fail(self._pending.popleft(), hard=True)

    # -- MeasureTransport surface --------------------------------------------
    @property
    def backend_key(self) -> str:
        return self._backend or "unknown"

    def submit(self, sites: Sequence, tiles) -> list:
        tiles = np.asarray(tiles, np.int64)
        futs: list = [None] * len(sites)
        with self._cv:
            if self._closing:
                raise RuntimeError("submit on a closed transport")
            backend = self.backend_key
            for i, (s, t) in enumerate(zip(sites, tiles)):
                key = make_key(s.key(), t, backend)
                v = self.db.get(key) if self.db is not None else None
                if v is not None:
                    self._stats.hits += 1
                    futs[i] = _resolved(v)
                elif key in self._inflight:
                    self._stats.coalesced += 1
                    futs[i] = self._inflight[key].future
                elif self._live == 0:
                    # every dispatcher is gone (down, not closed): nothing
                    # will serve the queue, so fail the pair closed now
                    self._stats.misses += 1
                    self._stats.failed_pairs += 1
                    futs[i] = _resolved(float("inf"))
                else:
                    job = _Job(key, s, t)
                    self._stats.misses += 1
                    self._inflight[key] = job
                    self._pending.append(job)
                    futs[i] = job.future
            self._cv.notify_all()
        return futs

    def drain(self) -> None:
        with self._cv:
            self._cv.wait_for(lambda: not self._inflight)

    def close(self) -> None:
        if self._closing:
            return
        self.drain()
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        if self.db is not None:
            self.db.close()

    def health(self) -> str:
        with self._cv:
            return self._health_locked()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _runs_on_card(runner_kwargs: dict, factory: Optional[str]) -> bool:
    if factory is not None:
        return False
    import torch
    return (torch.device(runner_kwargs.get("device", "cuda")).type == "cuda"
            and torch.cuda.is_available())


class WorkerPoolTransport(_JobBook):
    """Subprocess measurement pool behind the MeasureTransport contract.

    Parameters
    ----------
    workers:        pool size (one subprocess and dispatcher thread each).
    db:             a :class:`MeasureDB`, a path for one (``fleet://``
                    paths open the shared store), or ``None``.
    runner_kwargs:  :class:`~repro_torch.measure.runner.MeasureRunner`
                    options each worker builds its runner from (``reps=``,
                    ``warmup=``, ``device=``; the default device is the
                    card).
    max_attempts:   tries per job before it fails closed to ``inf`` (a try
                    is spent each time a worker dies holding the job).
    factory:        ``"module:attr"`` runner factory for the workers, the
                    test seam; production leaves it ``None``.
    spawn_timeout:  seconds to wait for each worker's ready handshake.
    job_timeout:    seconds a worker may hold one job before it is killed
                    as wedged and the job requeued (``None``: unlimited).
    backoff_base / backoff_cap / backoff_seed:
                    the :func:`respawn_backoff` schedule between failed
                    respawns; dispatcher ``i`` jitters from
                    ``backoff_seed + i``.
    """

    def __init__(self, workers: int = 2, db=None,
                 runner_kwargs: Optional[dict] = None,
                 max_attempts: int = 3, factory: Optional[str] = None,
                 spawn_timeout: float = 180.0,
                 job_timeout: Optional[float] = 900.0,
                 backoff_base: float = 0.1, backoff_cap: float = 30.0,
                 backoff_seed: int = 0):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.workers = workers
        self.runner_kwargs = dict(runner_kwargs or {})
        self.factory = factory
        self.spawn_timeout = spawn_timeout
        self.job_timeout = job_timeout
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_seed = backoff_seed
        self._sleep = time.sleep        # seam: a fake clock in tests
        if _runs_on_card(self.runner_kwargs, factory):
            from repro_torch.kernels import build
            build.build_all()           # once here, not once per worker
        self._init_book(db, max_attempts)
        self._ready = 0
        self._live = workers            # dispatcher threads still running
        self._backing_off = 0           # dispatchers sleeping out a backoff
        self._spawn_error: Optional[BaseException] = None
        self.worker_restarts = 0        # respawns after a worker death
        self.spawn_seconds = 0.0        # summed wall of every handshake

        self._threads = [
            threading.Thread(target=self._dispatch, args=(i,),
                             name=f"measure-w{i}", daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._ready == workers or self._spawn_error,
                timeout=spawn_timeout)
            err = self._spawn_error
            if err is not None or not ok:
                self._closing = True    # wind the live threads down
                self._cv.notify_all()
        if err is not None:
            raise RuntimeError("worker pool failed to start") from err
        if not ok:
            raise TimeoutError(
                f"worker pool: {self._ready}/{workers} workers ready "
                f"after {spawn_timeout}s")

    # -- worker process lifecycle -------------------------------------------
    def _spawn(self) -> subprocess.Popen:
        t0 = time.monotonic()
        env = dict(os.environ)
        # the child imports the port (and, under tests, the helper
        # factories) exactly as this process does
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        proc = subprocess.Popen([sys.executable, "-m", WORKER_MODULE],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                env=env)
        try:
            write_frame(proc.stdin, {"type": "init",
                                     "runner": self.runner_kwargs,
                                     "factory": self.factory})
            ready = _read_frame_deadline(
                proc.stdout, time.monotonic() + self.spawn_timeout)
        except Exception:
            self._kill(proc)
            raise
        if not ready or ready.get("type") != "ready":
            self._kill(proc)
            raise RuntimeError(f"worker handshake failed: {ready!r}")
        with self._cv:
            self.spawn_seconds += time.monotonic() - t0
            if self._backend is None:
                self._backend = ready["backend"]
            elif self._backend != ready["backend"]:
                proc.kill()
                raise RuntimeError(
                    f"worker backend {ready['backend']!r} != pool "
                    f"backend {self._backend!r} — mixed measurement "
                    f"conditions would poison the DB")
        return proc

    def _kill(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        try:
            proc.kill()
            proc.wait(timeout=5)
        except Exception:
            pass

    def _stop_worker(self, proc: Optional[subprocess.Popen]) -> None:
        """Polite shutdown: exit frame, short grace, then kill."""
        if proc is None:
            return
        try:
            write_frame(proc.stdin, {"type": "exit"})
            proc.stdin.close()
            proc.wait(timeout=10)
        except Exception:
            self._kill(proc)

    # -- the per-worker dispatcher thread ------------------------------------
    def _dispatch(self, index: int) -> None:
        proc: Optional[subprocess.Popen] = None
        counted_ready = False
        spawn_failures = 0
        job: Optional[_Job] = None
        job_id = 0
        try:
            while True:
                # keep a live worker before waiting for work: the
                # constructor blocks on every worker's handshake
                if proc is None or proc.poll() is not None:
                    try:
                        proc = self._spawn()
                        spawn_failures = 0
                    except Exception as e:
                        spawn_failures += 1
                        with self._cv:
                            if not counted_ready:
                                # this worker never came up: abort the
                                # constructor rather than limp along
                                self._spawn_error = e
                                self._requeue_or_fail(job, hard=True)
                                job = None
                                self._cv.notify_all()
                                return
                            self._requeue_or_fail(
                                job, reason=f"respawn failed "
                                f"({type(e).__name__})")
                            job = None
                            self._cv.notify_all()
                            if spawn_failures >= _MAX_SPAWN_FAILURES:
                                return
                            self._backing_off += 1
                        try:
                            self._sleep(respawn_backoff(
                                spawn_failures, base=self.backoff_base,
                                cap=self.backoff_cap,
                                seed=self.backoff_seed + index))
                        finally:
                            with self._cv:
                                self._backing_off -= 1
                        continue
                    if not counted_ready:
                        counted_ready = True
                        with self._cv:
                            self._ready += 1
                            self._cv.notify_all()
                if job is None:
                    with self._cv:
                        self._cv.wait_for(
                            lambda: self._pending or self._closing)
                        if self._closing and not self._pending:
                            return
                        job = self._pending.popleft()
                        job.queue_wait_s += time.monotonic() - job.t_queued
                    continue        # re-check the worker before sending
                job_id += 1
                job.t_start = time.monotonic()
                try:
                    write_frame(proc.stdin, {"type": "job", "id": job_id,
                                             "site": asdict(job.site),
                                             "tiles": job.tiles})
                    deadline = None if self.job_timeout is None else \
                        time.monotonic() + self.job_timeout
                    while True:
                        msg = _read_frame_deadline(proc.stdout, deadline)
                        if msg is None:
                            raise EOFError("worker closed its pipe")
                        if msg.get("type") == "result" \
                                and msg.get("id") == job_id:
                            break
                except (OSError, EOFError, ValueError) as e:
                    # the worker died, lost its context or wedged past
                    # job_timeout (TimeoutError is an OSError) holding this
                    # job: requeue or fail closed, respawn on the next turn
                    self._kill(proc)
                    proc = None
                    reason = "wedged (job timeout)" \
                        if isinstance(e, TimeoutError) \
                        else f"worker died ({type(e).__name__})"
                    with self._cv:
                        self.worker_restarts += 1
                        self._requeue_or_fail(job, reason=reason)
                        job = None
                        self._cv.notify_all()
                    continue
                v = float("inf") if msg["v"] is None else float(msg["v"])
                self._resolve(job, v)
                job = None
        finally:
            self._stop_worker(proc)
            with self._cv:
                self._live -= 1
                if self._live == 0:
                    self._fail_pending()
                self._cv.notify_all()

    def _health_locked(self) -> str:
        """``ok``: every dispatcher up, none backing off; ``degraded``:
        workers lost or sleeping out a backoff; ``down``: closed, or no
        dispatcher can make progress."""
        if self._closing or self._live == 0:
            return "down"
        if self._backing_off or self._live < self.workers:
            return "degraded"
        return "ok"

    def stats(self) -> dict:
        """The transport counters and the pool's, under the reference's
        names (``spawn_seconds`` is the port's: the wall of every worker
        handshake, the kernels' loading included)."""
        with self._cv:
            s = self._stats.snapshot(in_flight=len(self._inflight))
            s["health"] = self._health_locked()
            s["pool_queue_depth"] = len(self._pending)
            s["pool_queue_wait_seconds_total"] = self.queue_wait_seconds
            s["pool_run_seconds_total"] = self.run_seconds
            s["pool_jobs_finished_total"] = self.jobs_finished
            s["pool_spawn_seconds_total"] = self.spawn_seconds
        s["pool_workers_count"] = self.workers
        s["pool_worker_restarts_total"] = self.worker_restarts
        s["pool_quarantined_total"] = \
            self.db.n_quarantined if self.db is not None else 0
        return s
