"""Deadline-aware admission queue + batch scheduler over
``TuningService`` (the port of ``repro/serving/server.py``).

The serving path turns the service's per-session ``tune``/``tune_async``
verbs into *requests* against one shared :class:`Server`:

* **admission** — each request carries an SLO budget (``slo_ms``,
  defaulting to the server's).  A warm :class:`~repro_torch.artifacts
  .ProgramStore` answer resolves immediately at admission (the
  warm-store tier never queues); past ``max_queue`` depth the request is
  *shed* with a typed :class:`QueueFull` instead of silently blowing
  every queued deadline behind it.
* **flush** — a background flusher cuts a batch when ``max_batch``
  requests are waiting, the oldest has waited ``max_wait_ms``, or the
  oldest request's remaining budget approaches the EMA of batch
  execution time (deadline urgency).  Requests whose budget expired
  before execution fail with :class:`DeadlineExceeded`.
* **execution** — the batch groups by route: sessions whose agent is the
  brute-force search over an analytic or surrogate cost grid run through
  the :class:`~repro_torch.serving.fused.FusedTuner` (the whole group is
  ONE device dispatch, with a tuner per config, surrogate and legality);
  everything else coalesces per agent through
  :class:`~repro_torch.serving.batcher.AgentBatch` (one forward per
  agent).  A request with a site that has no legal tile under its
  oracle's legality fails alone with ``ValueError`` (the reference never
  raises there); the rest of its group resolve.  Results resolve strictly
  in admission order — FIFO fairness within an SLO class.

``health()`` follows the transports' semantics: ``down`` once closed,
``degraded`` while a shed/deadline breach is younger than
``health_window_s``, ``ok`` otherwise.  ``stats()`` speaks the unified ``serving_*`` key
dialect, and the ``request_observer`` seam (the serving analogue of the
pool's ``job_observer``) feeds ``repro_torch.obs.instrument_serving``.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.artifacts import program_key
from repro_torch.core.agents import BruteForceAgent
from repro_torch.core.env import CostModelEnv
from repro_torch.core.vectorizer import TileProgram
from repro_torch.serving.batcher import AgentBatch
from repro_torch.serving.fused import FusedTuner
from repro_torch.surrogate import SurrogateOracle


class ServingError(RuntimeError):
    """Base class of the serving path's typed rejections."""


class QueueFull(ServingError):
    """Shed at admission: the queue is at ``max_queue`` depth."""


class DeadlineExceeded(ServingError):
    """The request's SLO budget expired before a batch could run it."""


@dataclass
class ServingConfig:
    """Knobs of the admission queue + flusher (all times host-side)."""
    slo_ms: float = 100.0        # default per-request budget
    max_batch: int = 32          # requests per flush
    max_wait_ms: float = 2.0     # oldest-request wait that forces a flush
    max_queue: int = 256         # admission depth before shedding
    health_window_s: float = 5.0  # how long a breach keeps health degraded
    fused: bool = True           # allow the FusedTuner route


class _Request:
    __slots__ = ("session", "sites", "future", "slo_ms", "t_submit",
                 "deadline", "store_key", "wait_s")

    def __init__(self, session, sites, slo_ms, store_key):
        self.session = session
        self.sites = sites
        self.future: "Future[TileProgram]" = Future()
        self.slo_ms = slo_ms
        self.t_submit = time.perf_counter()
        self.deadline = (None if slo_ms is None
                         else self.t_submit + slo_ms / 1000.0)
        self.store_key = store_key
        self.wait_s = 0.0


class Server:
    """The serving loop: one admission queue + flusher thread per
    :class:`~repro_torch.service.TuningService` (constructed by the
    service's ``serving=`` argument; sessions route ``tune``/``tune_async``
    here automatically — zero caller churn).  The fused tuners run on the
    service's ``device``; their CUDA graphs are captured on the flusher
    thread."""

    def __init__(self, service, config: Optional[ServingConfig] = None,
                 request_observer: Optional[Callable] = None):
        self.service = service
        self.cfg = config or ServingConfig()
        #: ``observer(event, **fields)`` with events ``complete`` /
        #: ``batch`` / ``shed`` / ``deadline`` / ``store_hit`` — the
        #: instrumentation seam (``repro_torch.obs.instrument_serving``)
        self.request_observer = request_observer
        self._cv = threading.Condition()
        self._q: "deque[_Request]" = deque()
        self._closed = False
        self.device = getattr(service, "device", "cuda")
        # routing caches: (session, effective oracle) -> route,
        # shared FusedTuners per (cfg, surrogate, legality), AgentBatch
        # per agent
        self._routes: Dict[Tuple[int, int], tuple] = {}
        self._tuners: Dict[tuple, FusedTuner] = {}
        self._batchers: Dict[int, AgentBatch] = {}
        # counters (under _cv); latencies bounded for p50/p99
        self.requests = 0
        self.shed = 0
        self.deadline_misses = 0
        self.batches = 0
        self.store_hits = 0
        self.queue_wait_s = 0.0
        self.batch_requests: "Counter[int]" = Counter()
        self._lat: "deque[float]" = deque(maxlen=4096)
        self._last_breach = 0.0              # monotonic; shed or miss
        self._exec_ema = 0.0                 # EMA of batch execution time
        self._flusher = threading.Thread(target=self._loop, daemon=True,
                                         name="serving-flush")
        self._flusher.start()

    # -- admission -----------------------------------------------------------
    def submit(self, session, sites: Sequence,
               slo_ms: Optional[float] = None) -> "Future[TileProgram]":
        """Admit one tune request for ``session``; resolves to its
        :class:`TileProgram`.  Raises :class:`QueueFull` when shedding;
        the future fails with :class:`DeadlineExceeded` when the budget
        (``slo_ms``, default the server's) expires while queued."""
        if self._closed:
            raise ServingError("the serving path is closed")
        sites = list(sites)
        slo = self.cfg.slo_ms if slo_ms is None else slo_ms
        t0 = time.perf_counter()
        store = session.program_store
        key = None
        if sites and store is not None:
            key = program_key(sites, session.agent, session.oracle)
            prog = store.get(key)
            if prog is not None:             # warm-store tier: no queue
                fut: "Future[TileProgram]" = Future()
                session._account_tune(time.perf_counter() - t0,
                                      len(sites), True)
                with self._cv:
                    self.requests += 1
                    self.store_hits += 1
                    self._lat.append(time.perf_counter() - t0)
                self._observe("store_hit",
                              latency_s=time.perf_counter() - t0)
                fut.set_result(prog)
                return fut
        if not sites:                        # nothing to schedule
            fut = Future()
            session._account_tune(time.perf_counter() - t0, 0, False)
            with self._cv:
                self.requests += 1
            fut.set_result(TileProgram())
            return fut
        req = _Request(session, sites, slo, key)
        with self._cv:
            if self._closed:
                raise ServingError("the serving path is closed")
            if len(self._q) >= self.cfg.max_queue:
                self.shed += 1
                self._last_breach = time.monotonic()
                depth = len(self._q)
                self._cv.notify()
                self._observe("shed", queue_depth=depth)
                raise QueueFull(
                    f"queue depth {depth} at max_queue="
                    f"{self.cfg.max_queue}: request shed (retry later or "
                    f"raise max_queue/workers)")
            self.requests += 1
            self._q.append(req)
            self._cv.notify()
        return req.future

    # -- the flusher ---------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(0.25)
                if not self._q:
                    if self._closed:
                        return
                    continue
                now = time.perf_counter()
                oldest = self._q[0]
                flush_at = oldest.t_submit + self.cfg.max_wait_ms / 1000.0
                if oldest.deadline is not None:
                    # leave enough budget to actually execute the batch
                    # (floored so a cold EMA never schedules the flush
                    # exactly AT the deadline — a guaranteed miss)
                    margin = max(1.5 * self._exec_ema, 1e-3)
                    flush_at = min(flush_at, oldest.deadline - margin)
                if not (self._closed or now >= flush_at
                        or len(self._q) >= self.cfg.max_batch):
                    self._cv.wait(max(flush_at - now, 1e-4))
                    continue
                k = min(len(self._q), self.cfg.max_batch)
                batch = [self._q.popleft() for _ in range(k)]
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]) -> None:
        t_start = time.perf_counter()
        live = []
        for r in batch:
            r.wait_s = t_start - r.t_submit
            if r.deadline is not None and t_start > r.deadline:
                with self._cv:
                    self.deadline_misses += 1
                    self._last_breach = time.monotonic()
                self._observe("deadline", queue_wait_s=r.wait_s)
                r.future.set_exception(DeadlineExceeded(
                    f"SLO budget of {r.slo_ms:.1f} ms spent queueing "
                    f"({r.wait_s * 1e3:.1f} ms) before a batch ran"))
                continue
            live.append(r)
        if not live:
            return
        groups: Dict[tuple, List[_Request]] = {}
        for r in live:
            groups.setdefault(self._route(r.session), []).append(r)
        results: Dict[int, object] = {}
        for (kind, engine), reqs in groups.items():
            try:
                if kind == "fused":
                    progs = engine.tune_each([r.sites for r in reqs])
                else:
                    acts = engine.act_many([r.sites for r in reqs],
                                           [r.session.oracle for r in reqs])
                    progs = [a if isinstance(a, Exception)
                             else self._assemble(r, a)
                             for r, a in zip(reqs, acts)]
                for r, p in zip(reqs, progs):
                    results[id(r)] = p
            except Exception as exc:         # fail the group, not the batch
                for r in reqs:
                    results[id(r)] = exc
        dt = time.perf_counter() - t_start
        with self._cv:
            self._exec_ema = (dt if self._exec_ema == 0.0
                              else 0.7 * self._exec_ema + 0.3 * dt)
            self.batches += 1
            self.batch_requests[len(live)] += 1
        self._observe("batch", batch_requests=len(live),
                      batch_sites=sum(len(r.sites) for r in live),
                      exec_s=dt)
        # resolve strictly in admission order: FIFO within the batch
        for r in live:
            out = results[id(r)]
            if isinstance(out, Exception):
                r.future.set_exception(out)
                continue
            if r.store_key is not None:
                r.session.program_store.put(r.store_key, out)
            lat = time.perf_counter() - r.t_submit
            r.session._account_tune(lat, len(r.sites), False)
            with self._cv:
                self._lat.append(lat)
                self.queue_wait_s += r.wait_s
            self._observe("complete", queue_wait_s=r.wait_s, latency_s=lat)
            r.future.set_result(out)

    # -- routing -------------------------------------------------------------
    def _route(self, session) -> tuple:
        agent = session.agent
        key = (id(session), id(getattr(agent, "oracle", None)))
        r = self._routes.get(key)
        if r is None:
            r = self._make_route(session, agent)
            self._routes[key] = r
        return r

    def _make_route(self, session, agent) -> tuple:
        """Fused route for brute-force search over an analytic or
        surrogate cost grid (exactly the grids ``FusedTuner`` reproduces
        argmin for argmin, under the oracle's legality); everything else
        coalesces per agent."""
        if self.cfg.fused and isinstance(agent, BruteForceAgent):
            o = agent._ensure_oracle()
            o = getattr(o, "oracle", o)      # unwrap AsyncOracle
            sur = None
            eligible = False
            if isinstance(o, SurrogateOracle):
                sur, eligible = o.model, True
            elif type(o) is CostModelEnv:    # MeasuredEnv etc. excluded
                eligible = True
            if eligible:
                tk = (id(o.cfg), id(sur), o.legality)
                tuner = self._tuners.get(tk)
                if tuner is None:
                    tuner = FusedTuner(o.cfg, surrogate=sur,
                                       legality=o.legality,
                                       device=self.device)
                    self._tuners[tk] = tuner
                return ("fused", tuner)
        batcher = self._batchers.get(id(agent))
        if batcher is None:
            batcher = AgentBatch(agent)
            self._batchers[id(agent)] = batcher
        return ("agent", batcher)

    @staticmethod
    def _assemble(r: _Request, actions: np.ndarray) -> TileProgram:
        space = r.session.oracle.space       # same assembly as vectorizer
        prog = TileProgram()
        for s, a in zip(r.sites, actions):
            prog.tiles[s.key()] = space.tiles(s.kind, a)
        return prog

    def _observe(self, event: str, **fields) -> None:
        obs = self.request_observer
        if obs is not None:
            try:
                obs(event, **fields)
            except Exception:
                pass                         # observers never break serving

    # -- observability / lifecycle -------------------------------------------
    def health(self) -> str:
        """``ok | degraded | down`` (the transports' semantics): degraded
        while a shed or deadline miss is younger than
        ``health_window_s``."""
        if self._closed:
            return "down"
        if time.monotonic() - self._last_breach < self.cfg.health_window_s:
            return "degraded"
        return "ok"

    def stats(self) -> dict:
        """Unified ``serving_*`` counters + latency quantiles + the fused
        tuners' dispatch/trace counters (summed)."""
        with self._cv:
            lat = np.asarray(self._lat, np.float64)
            out = {
                "serving_requests_total": self.requests,
                "serving_queue_depth": len(self._q),
                "serving_shed_total": self.shed,
                "serving_deadline_misses_total": self.deadline_misses,
                "serving_batches_total": self.batches,
                "serving_store_hits_total": self.store_hits,
                "serving_queue_wait_seconds_total": self.queue_wait_s,
                "serving_batch_requests_hist": dict(self.batch_requests),
                "serving_batch_requests_max":
                    max(self.batch_requests, default=0),
                "serving_tune_p50_ms":
                    float(np.percentile(lat, 50) * 1e3) if len(lat) else 0.0,
                "serving_tune_p99_ms":
                    float(np.percentile(lat, 99) * 1e3) if len(lat) else 0.0,
            }
        for t in self._tuners.values():
            for k, v in t.stats().items():
                out[k] = out.get(k, 0) + v
        out["serving_agent_batches_total"] = sum(
            b.batches for b in self._batchers.values())
        out["serving_batched_requests_total"] = sum(
            b.requests for b in self._batchers.values())
        out["health"] = self.health()
        return out

    def close(self) -> None:
        """Drain the queue (every admitted future resolves or fails) and
        stop the flusher.  Idempotent."""
        with self._cv:
            if self._closed and not self._flusher.is_alive():
                return
            self._closed = True
            self._cv.notify_all()
        self._flusher.join(timeout=60.0)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
