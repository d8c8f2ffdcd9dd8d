"""``TuningService`` — session-oriented autotuning over one shared
measurement transport (the port of ``repro/service/service.py``).

The facade (:class:`~repro_torch.api.NeuroVectorizer`) is one pipeline,
one oracle, one caller.  The service is the next altitude: a long-lived
object owning one :class:`~repro_torch.core.protocols.MeasureTransport`
(typically a :class:`~repro_torch.measure.pool.WorkerPoolTransport`) that
many
concurrent *sessions* share — each session pairing its own agent with its
own oracle view, all feeding the same worker pool and the same persistent
:class:`~repro_torch.measure.db.MeasureDB`.  Duplicate (site, tiles) keys
across sessions coalesce inside the transport, so two sessions tuning
overlapping corpora never measure the same pair twice.

Sessions warm-start from persistent artifacts:
``open_session(agent_ckpt=...)`` restores a fitted agent from a
``repro_torch.artifacts`` checkpoint instead of re-paying ``fit``, and a
service-wide ``program_store=`` lets every session answer
previously-tuned site sets by lookup — zero agent inferences, shared
across sessions and across processes (the decision-level analogue of
the shared timing DB).

::

    with TuningService(cfg, transport="pool", workers=4,
                       db_path="measure.jsonl", reps=3) as svc:
        s1 = svc.open_session(agent="ppo", oracle="measured")
        s2 = svc.open_session(agent="brute", oracle="measured")
        s1.fit(corpus, total_steps=5000)
        f1 = s1.tune_async(sites_a)          # overlapping tunes...
        f2 = s2.fit(sites_b).tune_async(sites_b)
        prog_a, prog_b = f1.result(), f2.result()
        print(s1.stats())                    # timings, hit rate, in-flight

Sessions run their async work on the service's thread pool; the actual
measurement parallelism lives below, in the transport's workers.

Two arguments are the port's own.  ``device`` (default ``"cuda"``; without
CUDA the service raises unless ``"cpu"`` is asked for) is where the
sessions' agents, a surrogate, the in-process or pool runner and the
serving path's fused tuners live.  ``legality`` (default ``"h100"``, the
Hopper kernels' launch rule) is the one every oracle the service builds
prices tiles under; a session tunes through
:func:`~repro_torch.core.vectorizer.tune` with the legal mask of
``mask_env(oracle)``, so every program it returns launches.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence, Union

from repro_torch.artifacts import (ProgramStore, load_agent,
                                   open_program_store, tune_through_store)
from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core.agents import BruteForceAgent, make_agent
from repro_torch.core.costmodel import DEFAULT_LEGALITY, check_legality
from repro_torch.core.env import CostModelEnv, MeasuredEnv
from repro_torch.core.protocols import Agent, AsyncOracle, Oracle
from repro_torch.core.vectorizer import TileProgram
from repro_torch.device import resolve_device
from repro_torch.ft.monitor import PreemptionHandler
from repro_torch.measure import (TransportMeasureFn, make_transport,
                                 resolve_surrogate)
from repro_torch.obs import ObsHandle, resolve_obs
from repro_torch.obs.instrument import (instrument_oracle_stack,
                                        instrument_program_store,
                                        instrument_serving,
                                        instrument_transport)
from repro_torch.serving.server import Server, ServingConfig
from repro_torch.surrogate import SurrogateOracle

_COUNTERS = ("transport_hits_total", "transport_misses_total",
             "transport_coalesced_total", "transport_timed_pairs_total",
             "transport_failed_pairs_total", "transport_retries_total")


class SessionHandle:
    """One tuning session: an agent + an oracle view over the service's
    shared transport.

    ``fit``/``tune`` are the synchronous verbs of the facade;
    :meth:`tune_async` submits the tune to the service's thread pool and
    returns a :class:`~concurrent.futures.Future` of the
    :class:`TileProgram`, so callers overlap tuning across sessions (the
    measurements themselves already overlap inside the transport).
    :meth:`stats` reports per-session wall/throughput counters plus the
    transport's counter *deltas since the session opened*."""

    def __init__(self, service: "TuningService", name: str, agent: Agent,
                 oracle: AsyncOracle,
                 program_store: Optional[ProgramStore] = None):
        self.service = service
        self.name = name
        self.agent = agent
        self.oracle = oracle
        self.program_store = program_store
        self._lock = threading.Lock()
        self._opened = time.perf_counter()
        self._fit_wall = 0.0
        self._tune_wall = 0.0
        self._tunes = 0
        self._sites_tuned = 0
        self._agent_inferences = 0
        self._store_hits = 0
        self._store_misses = 0
        self._outstanding: "set[Future]" = set()
        self._closed = False
        t = oracle.transport
        self._base = dict.fromkeys(_COUNTERS, 0) if t is None else t.stats()
        # -- obs wiring: the session's registry series + root span -----------
        reg = service.registry
        self._tracer = service.tracer
        lbl = {"session": name}
        self._m_fit_s = reg.histogram(
            "session_fit_seconds", "fit() latency per session",
            labelnames=("session",)).labels(**lbl)
        self._m_tune_s = reg.histogram(
            "session_tune_seconds", "tune() latency per session",
            labelnames=("session",)).labels(**lbl)
        self._m_tunes = reg.counter(
            "session_tunes_total", "tunes completed",
            labelnames=("session",)).labels(**lbl)
        self._m_sites = reg.counter(
            "session_sites_tuned_total", "sites tuned",
            labelnames=("session",)).labels(**lbl)
        self._m_infer = reg.counter(
            "session_agent_inferences_total", "sites through agent.act",
            labelnames=("session",)).labels(**lbl)
        self._m_store_hits = reg.counter(
            "session_store_hits_total", "tunes answered by program lookup",
            labelnames=("session",)).labels(**lbl)
        self._m_store_miss = reg.counter(
            "session_store_misses_total", "tunes that ran inference",
            labelnames=("session",)).labels(**lbl)
        self._m_inflight = reg.gauge(
            "session_inflight_tunes", "async tunes outstanding",
            labelnames=("session",)).labels(**lbl)
        self._span = self._tracer.begin("session", detached=True,
                                        session=name, agent=agent.name)

    # -- the facade verbs ----------------------------------------------------
    def fit(self, sites: Sequence, **fit_kwargs) -> "SessionHandle":
        """Train/label the session's agent against its oracle."""
        self._check_open()
        t0 = time.perf_counter()
        with self._tracer.span("fit", parent=self._span,
                               session=self.name, n_sites=len(sites)):
            self.agent.fit(sites, self.oracle, **fit_kwargs)
        dt = time.perf_counter() - t0
        self._m_fit_s.observe(dt)
        with self._lock:
            self._fit_wall += dt
        return self

    def tune(self, sites: Sequence, *,
             slo_ms: Optional[float] = None) -> TileProgram:
        """Greedy inference-mode tiles for ``sites`` (synchronous).
        Under ``TuningService(serving=...)`` the call is admitted to the
        shared :class:`~repro_torch.serving.Server` (``slo_ms`` overrides the
        server's default budget) and may raise its typed errors."""
        self._check_open()
        if self.service.server is not None:
            return self.service.server.submit(self, list(sites),
                                              slo_ms=slo_ms).result()
        return self._tune(list(sites))

    def tune_async(self, sites: Sequence, *,
                   slo_ms: Optional[float] = None) -> "Future[TileProgram]":
        """Submit :meth:`tune` and return a
        :class:`~concurrent.futures.Future` of the :class:`TileProgram`.
        Without serving the tune runs on the service's session pool;
        under ``serving=`` it is admitted to the shared batch server
        (raising :class:`~repro_torch.serving.QueueFull` when shedding)."""
        self._check_open()
        if self.service.server is not None:
            fut = self.service.server.submit(self, list(sites),
                                             slo_ms=slo_ms)
        else:
            if slo_ms is not None:
                raise ValueError("slo_ms needs TuningService(serving=...)")
            fut = self.service._submit(self._tune, list(sites))
        with self._lock:
            self._outstanding.add(fut)
            self._m_inflight.set(len(self._outstanding))
        fut.add_done_callback(self._forget)
        return fut

    def _tune(self, sites: list) -> TileProgram:
        t0 = time.perf_counter()
        with self._tracer.span("tune", parent=self._span,
                               session=self.name, n_sites=len(sites)) as sp:
            prog, hit = tune_through_store(sites, self.agent,
                                           self.oracle.space,
                                           self.oracle, self.program_store)
            sp.set(store_hit=bool(hit))
        self._account_tune(time.perf_counter() - t0, len(sites), hit)
        return prog

    def _account_tune(self, dt: float, n_sites: int, hit: bool) -> None:
        """Book one completed tune (wall time, inference/store counters)
        — shared by the inline path and the serving path, so a request
        fulfilled by the batch server reports identically."""
        self._m_tune_s.observe(dt)
        self._m_tunes.inc()
        self._m_sites.inc(n_sites)
        with self._lock:
            self._tune_wall += dt
            self._tunes += 1
            self._sites_tuned += n_sites
            if self.program_store is not None and n_sites:
                if hit:
                    self._store_hits += 1
                else:
                    self._store_misses += 1
            if not hit:
                self._agent_inferences += n_sites
        if self.program_store is not None and n_sites:
            (self._m_store_hits if hit else self._m_store_miss).inc()
        if not hit:
            self._m_infer.inc(n_sites)

    def _forget(self, fut: Future) -> None:
        with self._lock:
            self._outstanding.discard(fut)
            self._m_inflight.set(len(self._outstanding))

    # -- observability / lifecycle -------------------------------------------
    def health(self) -> str:
        """``ok | degraded | down`` for this session's oracle+transport
        pair (:func:`~repro_torch.core.protocols.resolve_health`
        semantics)."""
        return self.oracle.health()

    def stats(self) -> dict:
        """Per-session counters + transport deltas since ``open_session``.

        Keys are the unified ``<subsystem>_<noun>_<unit>`` spellings only
        (the legacy aliases — ``wall_s``, ``tunes``,
        transport ``hits``/``misses``/... — are gone as scheduled): the
        same series the service's :class:`~repro_torch.obs.MetricsRegistry`
        exposes, labelled by session name, in
        ``snapshot()``/``render_prom()``.
        """
        t = self.oracle.transport
        now = self._base if t is None else t.stats()
        delta = {k: now.get(k, 0) - self._base.get(k, 0) for k in _COUNTERS}
        n = (delta["transport_hits_total"] + delta["transport_misses_total"]
             + delta["transport_coalesced_total"])
        delta["transport_hit_ratio"] = \
            (delta["transport_hits_total"] / n) if n else 0.0
        delta["transport_inflight_pairs"] = now.get(
            "transport_inflight_pairs", 0)
        with self._lock:
            out = {"session": self.name, "agent": self.agent.name,
                   "health": self.oracle.health(),
                   "session_wall_seconds":
                       time.perf_counter() - self._opened,
                   "session_fit_seconds_total": self._fit_wall,
                   "session_tune_seconds_total": self._tune_wall,
                   "session_tunes_total": self._tunes,
                   "session_sites_tuned_total": self._sites_tuned,
                   "session_agent_inferences_total": self._agent_inferences,
                   "session_store_hits_total": self._store_hits,
                   "session_store_misses_total": self._store_misses,
                   "session_inflight_tunes": len(self._outstanding),
                   "transport": delta}
        return out

    def drain(self) -> None:
        """Block until this session's async tunes (and everything the
        shared transport has in flight) are finished.  Waits without
        re-raising: a serving-path future that failed its SLO carries
        :class:`~repro_torch.serving.DeadlineExceeded` for *its* caller, not
        for whoever closes the session."""
        for f in list(self._outstanding):
            f.exception()
        self.oracle.drain()

    def close(self) -> None:
        """Finish outstanding work and detach.  The shared transport
        stays up — it belongs to the service."""
        if not self._closed:
            self.drain()
            self._closed = True
            self._span.end()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"session {self.name!r} is closed")
        if self.service._closed:
            raise RuntimeError("the TuningService is closed")

    def __enter__(self) -> "SessionHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TuningService:
    """The service root: one shared transport, many sessions.

    Parameters
    ----------
    cfg:        default :class:`NeuroVecConfig` for sessions that do not
                bring their own.
    transport:  ``"inproc"`` (default) / ``"pool"`` / ``"socket"`` (with
                ``hosts=``) / a pre-built
                :class:`~repro_torch.core.protocols.MeasureTransport` (the
                service then *borrows* it and will not close it).
    workers:    pool size when ``transport="pool"``.
    db_path:    persistent :class:`MeasureDB` path shared by every
                session (repeat runs re-time nothing).
    program_store: a :class:`~repro_torch.artifacts.ProgramStore`
                (borrowed) or
                a path (opened and owned by the service) shared by every
                session that does not bring its own: finished tile
                programs are served by lookup across sessions *and*
                processes — the warm-start analogue of the shared
                timing DB, one level up.
    max_parallel_tunes: thread-pool width for :meth:`SessionHandle.
                tune_async` (measurement parallelism is the transport's).
    serving:    ``True`` / a :class:`~repro_torch.serving.ServingConfig` /
                a kwargs dict — start a shared :class:`~repro_torch.serving
                .Server`: every session's ``tune``/``tune_async`` is
                admitted to its deadline-aware queue and batched through
                fused device dispatches (``slo_ms=`` per call; typed
                shedding via :class:`~repro_torch.serving.QueueFull`).
    preemption: install a :class:`~repro_torch.ft.monitor.PreemptionHandler`
                whose SIGTERM callback is :meth:`close` — in-flight
                tunes drain, workers stop, and every owned store/DB
                closes cleanly before the process dies (the handler is
                restored on close).
    runner_kwargs: :class:`~repro_torch.measure.runner.MeasureRunner`
                options (``reps=``, ``warmup=``) — per worker under the
                pool transport.  With ``transport="socket"``, pass
                ``hosts=["host:port", ...]`` here instead (it flows to
                :func:`~repro_torch.measure.make_transport`; runner
                options then live on the ``serve-worker`` hosts).
    device:     where agents, a surrogate, the runner (in process and
                each pool worker's) and the fused tuners live: ``"cuda"``
                (default; raises without CUDA) or ``"cpu"``.
    legality:   the launch rule every oracle the service builds prices
                tiles under: ``"h100"`` (default), ``"cpu"`` or the
                reference's ``"tpu_v5e"``.
    """

    def __init__(self, cfg: NeuroVecConfig = DEFAULT,
                 transport: Union[str, object] = "inproc",
                 workers: Optional[int] = None,
                 db_path: Optional[str] = None, seed: int = 0,
                 program_store: Union[str, ProgramStore, None] = None,
                 max_parallel_tunes: int = 4, preemption: bool = False,
                 metrics=None, trace=None,
                 serving: Union[bool, dict, ServingConfig, None] = None,
                 device="cuda", legality: str = DEFAULT_LEGALITY,
                 **runner_kwargs):
        self.cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.legality = check_legality(legality)
        # obs substrate: metrics default to the process-wide
        # registry (False disables), tracing is off unless trace= names a
        # path (owned) or passes a Tracer (borrowed)
        self.registry, self.tracer, self._owns_tracer = \
            resolve_obs(metrics, trace)
        if isinstance(transport, str):
            if transport != "socket":
                runner_kwargs.setdefault("device", str(self.device))
            self.transport = make_transport(transport, db_path=db_path,
                                            workers=workers, **runner_kwargs)
            self._owns_transport = True
        else:
            if db_path is not None or workers is not None or runner_kwargs:
                raise TypeError("a pre-built transport carries its own "
                                "runner/db/workers — drop the extra "
                                "arguments")
            self.transport = transport
            self._owns_transport = False
        self._owned_stores: "list[ProgramStore]" = []
        self.program_store = self._resolve_store(program_store)
        self._executor = ThreadPoolExecutor(max_workers=max_parallel_tunes,
                                            thread_name_prefix="tune")
        self._sessions: "list[SessionHandle]" = []
        self._n_opened = 0
        self._closed = False
        self._preemption = (PreemptionHandler(on_stop=self.close)
                            if preemption else None)
        self._obs = ObsHandle(self.registry)
        self._obs.adopt(instrument_transport(self.transport, self.registry,
                                             self.tracer))
        self._obs.adopt(instrument_program_store(self.program_store,
                                                 self.registry))
        self._m_sessions = self.registry.gauge(
            "service_sessions_open", "sessions currently open")
        self._m_sessions_total = self.registry.counter(
            "service_sessions_total", "sessions opened over the lifetime")
        # serving path: sessions' tune/tune_async route through
        # one shared batch server when serving= is set
        if serving is None or serving is False:
            self.server = None
        else:
            sc = (ServingConfig() if serving is True
                  else ServingConfig(**serving) if isinstance(serving, dict)
                  else serving)
            self.server = Server(self, sc)
            self._obs.adopt(instrument_serving(self.server, self.registry))

    def _resolve_store(self, store: Union[str, ProgramStore, None]
                       ) -> Optional[ProgramStore]:
        """A path opens a service-owned store (closed with the service);
        an instance is borrowed.  ``fleet://host:port`` paths open a
        :class:`~repro_torch.fleet.artifacts.RemoteProgramStore` against
        the shared
        ``serve-artifacts`` daemon."""
        if isinstance(store, str):
            store = open_program_store(store)
            self._owned_stores.append(store)
        return store

    # -- sessions ------------------------------------------------------------
    def open_session(self, cfg: Optional[NeuroVecConfig] = None,
                     agent: Union[str, Agent] = "ppo",
                     oracle: Union[str, Oracle] = "measured",
                     seed: Optional[int] = None,
                     agent_ckpt: Optional[str] = None,
                     program_store: Union[str, ProgramStore, None] = None,
                     prune_topk: Optional[int] = None,
                     surrogate=None,
                     **agent_kwargs) -> SessionHandle:
        """A new session: ``agent`` (registry name or :class:`Agent`)
        paired with ``oracle`` — ``"measured"`` (reward = the shared
        transport's timings), ``"model"`` (the analytic
        :class:`CostModelEnv`), ``"surrogate"`` (the learned cost model,
        trained from the shared transport's DB unless ``surrogate=``
        supplies a model/checkpoint dir), or a pre-built :class:`Oracle`.
        The oracles built here price under the service's ``legality``.

        ``oracle="measured"`` accepts ``prune_topk=N``: the surrogate
        ranks each site's legal grid and only the top-N candidates are
        submitted to the shared transport (trained from the transport's
        DB when ``surrogate`` is ``None``; a DB too cold to train leaves
        pruning inactive for the session).

        ``agent_ckpt`` warm-starts the session: the constructed agent's
        state is restored from a ``repro_torch.artifacts`` checkpoint
        directory (fingerprint-verified), so the session can tune
        without paying ``fit`` again.  ``program_store`` overrides the
        service-wide store for this session (``None`` inherits it)."""
        if self._closed:
            raise RuntimeError("open_session on a closed TuningService")
        cfg = self.cfg if cfg is None else cfg
        seed = self.seed if seed is None else seed
        dev = str(self.device)
        if oracle == "measured":
            if prune_topk is not None:
                surrogate = resolve_surrogate(
                    surrogate, db=getattr(self.transport, "db", None),
                    device=dev)
            env: Oracle = MeasuredEnv(
                cfg, measure_fn=TransportMeasureFn(self.transport),
                seed=seed, legality=self.legality, prune_topk=prune_topk,
                surrogate=surrogate)
            async_oracle = AsyncOracle(env, self.transport)
        elif oracle == "surrogate":
            if prune_topk is not None:
                raise ValueError("prune_topk applies only to "
                                 "oracle='measured' (a surrogate oracle "
                                 "performs no measurements to prune)")
            model = resolve_surrogate(
                surrogate, db=getattr(self.transport, "db", None),
                device=dev)
            if model is None:
                raise ValueError(
                    "oracle='surrogate' needs a trained model: pass "
                    "surrogate= (a SurrogateModel or checkpoint dir) or "
                    "give the service a DB with enough finite records")
            async_oracle = AsyncOracle(SurrogateOracle(
                cfg, model, seed=seed, legality=self.legality))
        elif oracle == "model":
            async_oracle = AsyncOracle(CostModelEnv(cfg, seed=seed,
                                                    legality=self.legality))
        elif isinstance(oracle, str):
            raise ValueError(f"unknown oracle {oracle!r}: expected "
                             f"'model', 'measured', or 'surrogate'")
        else:
            async_oracle = AsyncOracle(oracle)
        a = (make_agent(agent, cfg, seed=seed, device=dev, **agent_kwargs)
             if isinstance(agent, str) else agent)
        if agent_ckpt is not None:
            load_agent(agent_ckpt, agent=a)
            if isinstance(a, BruteForceAgent):    # brute: re-bind live oracle
                a.oracle = async_oracle.oracle
        store = (self.program_store if program_store is None
                 else self._resolve_store(program_store))
        self._n_opened += 1
        handle = SessionHandle(self, f"session-{self._n_opened}", a,
                               async_oracle, program_store=store)
        self._sessions.append(handle)
        # the session's oracle view (env counters, breaker gauge, a
        # per-session surrogate) feeds the service registry too; the
        # shared transport is already instrumented — first wins
        self._obs.adopt(instrument_oracle_stack(async_oracle.oracle,
                                                self.registry, self.tracer))
        if store is not None and store is not self.program_store:
            self._obs.adopt(instrument_program_store(store, self.registry))
        self._m_sessions_total.inc()
        self._m_sessions.set(sum(not s._closed for s in self._sessions))
        return handle

    def _submit(self, fn, *args) -> Future:
        return self._executor.submit(fn, *args)

    # -- observability / lifecycle -------------------------------------------
    def health(self) -> str:
        """``ok | degraded | down``: the worst of the shared transport's
        health and (under ``serving=``) the batch server's."""
        h = getattr(self.transport, "health", None)
        states = [h() if callable(h) else "ok"]
        if self.server is not None:
            states.append(self.server.health())
        for level in ("down", "degraded"):
            if level in states:
                return level
        return "ok"

    def stats(self) -> dict:
        """Service-level counters + the shared transport's snapshot (and
        the batch server's ``serving_*`` block when serving is on).
        Unified key spellings only — the legacy aliases
        (``sessions_open``/``sessions_total``) are gone as scheduled."""
        open_n = sum(not s._closed for s in self._sessions)
        self._m_sessions.set(open_n)
        out = {"service_sessions_open": open_n,
               "service_sessions_total": self._n_opened,
               "owns_transport": self._owns_transport,
               "health": self.health(),
               "transport": self.transport.stats()}
        if self.server is not None:
            out["serving"] = self.server.stats()
        return out

    def close(self) -> None:
        """Drain every session, stop the tune pool, and — when the
        service built them — close the transport and any program stores
        it opened from paths.  Idempotent; also the SIGTERM drain path
        under ``preemption=True``."""
        if self._closed:
            return
        self._closed = True
        if self._preemption is not None:
            self._preemption.restore()
            self._preemption = None
        # the server first: sessions' drain waits on futures it fulfills
        if self.server is not None:
            self.server.close()
        for s in self._sessions:
            s.close()
        self._executor.shutdown(wait=True)
        if self._owns_transport:
            self.transport.close()
        for store in self._owned_stores:
            store.close()
        self._m_sessions.set(0)
        self._obs.close()
        if self._owns_tracer:
            self.tracer.close()

    def __enter__(self) -> "TuningService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_session(cfg: NeuroVecConfig = DEFAULT, agent="ppo",
                 oracle="measured", **service_kwargs) -> SessionHandle:
    """One-shot convenience: a private :class:`TuningService` wrapped
    around a single session.  Closing the returned session's *service*
    (``handle.service.close()`` or using it as a context manager) tears
    the private transport down."""
    svc = TuningService(cfg, **service_kwargs)
    return svc.open_session(agent=agent, oracle=oracle)
