"""Retrofit instrumentation for the tuning seams the facade reaches in the
port — no behavior change, by construction; the port of
``repro/obs/instrument.py`` for the measured env, its surrogate, its
transports (in process, the worker pool and the socket fleet) and timing
DB, the program store and the batch server.

Every ``instrument_*`` function takes a *live instance* and wraps its
methods on the instance (never the class: two transports can feed two
registries in one process), guarded by an ``_obs_instrumented`` marker so
double-instrumentation is a no-op.  Wrappers call the original and return
its value untouched.

Counters that already live on the instrumented object (a transport's
``stats()`` block, :class:`~repro_torch.core.env.MeasuredEnv`'s attribute
counters, a store's ``hits``) are not double-booked: a *collector* —
registered on the registry, run before every snapshot/render — mirrors
them in as clamped deltas, so several instrumented instances sum
correctly into one registry and an instance that resets never drives a
counter backwards.  Metric names are the reference's.

Lock ordering: wrapped methods and collectors may hold an instance lock
while touching the registry (registry ``RLock`` is the innermost lock);
nothing in this module calls back into an instrumented object while
holding the registry lock.

Each function returns an :class:`ObsHandle`; ``handle.close()``
unregisters the collectors (the facade calls it from its own ``close``
so a long-lived global registry does not accumulate dead collectors).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from .metrics import MetricsRegistry
from .trace import NULL_TRACER

__all__ = ["ObsHandle", "instrument_transport", "instrument_pool",
           "instrument_fleet", "instrument_db", "instrument_env",
           "instrument_surrogate", "instrument_program_store",
           "instrument_serving", "instrument_oracle_stack"]

_MARK = "_obs_instrumented"


class ObsHandle:
    """Undo ticket for one ``instrument_*`` call: unregisters the
    collectors it added (instance-level method wraps stay — they are
    inert once nobody snapshots the registry)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._collectors: List[Callable[[], None]] = []
        self._children: List["ObsHandle"] = []

    def add_collector(self, fn: Callable[[], None]) -> None:
        self.registry.register_collector(fn)
        self._collectors.append(fn)

    def adopt(self, child: Optional["ObsHandle"]) -> None:
        if child is not None:
            self._children.append(child)

    def close(self) -> None:
        # final sync before detaching: counters accrued since the last
        # snapshot must land in the registry, not die with the collector
        for fn in self._collectors:
            try:
                fn()
            except Exception:
                pass
            self.registry.unregister_collector(fn)
        self._collectors.clear()
        for c in self._children:
            c.close()
        self._children.clear()


def _marked(obj, registry: MetricsRegistry) -> bool:
    """True (and leave the object alone) if ``obj`` is already feeding a
    registry — first instrumentation wins."""
    if getattr(obj, _MARK, None) is not None:
        return True
    try:
        setattr(obj, _MARK, id(registry))
    except (AttributeError, TypeError):    # __slots__ or frozen: skip
        return True
    return False


def _delta_sync(registry: MetricsRegistry, counter_map: dict,
                read: Callable[[], dict], help_map: Optional[dict] = None
                ) -> Callable[[], None]:
    """Build a collector mirroring absolute counters from ``read()`` into
    registry counters as clamped deltas.  ``counter_map`` is
    ``{source_key: metric_name}``."""
    counters = {src: registry.counter(name, (help_map or {}).get(name, ""))
                for src, name in counter_map.items()}
    last = dict.fromkeys(counter_map, 0.0)

    def collect() -> None:
        try:
            cur = read()
        except Exception:
            return                          # a dying source is not fatal
        for src, ctr in counters.items():
            v = float(cur.get(src, 0) or 0)
            d = v - last[src]
            if d > 0:
                ctr.inc(d)
            last[src] = v
    return collect


_HEALTH_CODE = {"ok": 0.0, "degraded": 1.0, "down": 2.0}


# -- transports ---------------------------------------------------------------
def instrument_transport(transport, registry: MetricsRegistry,
                         tracer=NULL_TRACER) -> Optional[ObsHandle]:
    """Any :class:`~repro_torch.core.protocols.MeasureTransport`:
    submit/drain latency histograms + spans, counter mirror, in-flight
    gauge, and its timing DB's counters."""
    if _marked(transport, registry):
        return None
    h = ObsHandle(registry)
    submit_hist = registry.histogram(
        "transport_submit_seconds", "submit() call latency")
    drain_hist = registry.histogram(
        "transport_drain_seconds", "drain() wait latency")
    inflight = registry.gauge("transport_inflight_pairs",
                              "measurements currently in flight")
    health = registry.gauge("transport_health",
                            "0=ok 1=degraded 2=down")

    orig_submit, orig_drain = transport.submit, transport.drain

    def submit(sites, tiles):
        t0 = time.monotonic()
        with tracer.span("submit", n_pairs=len(sites)):
            out = orig_submit(sites, tiles)
        submit_hist.observe(time.monotonic() - t0)
        return out

    def drain():
        t0 = time.monotonic()
        with tracer.span("drain"):
            out = orig_drain()
        drain_hist.observe(time.monotonic() - t0)
        return out

    transport.submit, transport.drain = submit, drain

    sync = _delta_sync(registry, {
        "transport_hits_total": "transport_hits_total",
        "transport_misses_total": "transport_misses_total",
        "transport_coalesced_total": "transport_coalesced_total",
        "transport_timed_pairs_total": "transport_timed_pairs_total",
        "transport_failed_pairs_total": "transport_failed_pairs_total",
        "transport_retries_total": "transport_retries_total",
    }, transport.stats, help_map={
        "transport_hits_total": "pairs served from the DB",
        "transport_misses_total": "pairs that required a measurement",
        "transport_coalesced_total": "pairs folded onto in-flight work",
        "transport_timed_pairs_total": "successful measurements",
        "transport_failed_pairs_total": "measurements failed closed to inf",
        "transport_retries_total": "jobs requeued after a worker death",
    })

    def collect() -> None:
        sync()
        try:
            s = transport.stats()
        except Exception:
            return
        inflight.set(s.get("transport_inflight_pairs", 0))
        health.set(_HEALTH_CODE.get(s.get("health", "ok"), 0.0))

    h.add_collector(collect)
    h.adopt(instrument_pool(transport, registry))
    h.adopt(instrument_fleet(transport, registry))
    if getattr(transport, "db", None) is not None:
        h.adopt(instrument_db(transport.db, registry))
    return h


def instrument_pool(pool, registry: MetricsRegistry) -> Optional[ObsHandle]:
    """WorkerPool metrics: queue depth, restarts, quarantine, and the
    per-job queue-wait and in-flight split (the pool's ``job_observer``
    seam feeds the two histograms)."""
    if not hasattr(pool, "worker_restarts"):       # not a worker pool
        return None
    h = ObsHandle(registry)
    qwait = registry.histogram("pool_queue_wait_seconds",
                               "per-job time spent queued (incl. requeues)")
    run = registry.histogram("pool_run_seconds",
                             "per-job time in flight on a worker")
    depth = registry.gauge("pool_queue_depth", "jobs waiting for a worker")
    workers = registry.gauge("pool_workers_count", "configured pool size")
    live = registry.gauge("pool_workers_live", "dispatchers still running")

    def observer(queue_wait_s: float, run_s: float) -> None:
        qwait.observe(queue_wait_s)
        run.observe(run_s)
    pool.job_observer = observer

    sync = _delta_sync(registry, {
        "pool_worker_restarts_total": "pool_worker_restarts_total",
        "pool_quarantined_total": "pool_quarantined_total",
    }, pool.stats, help_map={
        "pool_worker_restarts_total": "worker respawns after a death",
        "pool_quarantined_total": "poison pairs quarantined in the DB",
    })

    def collect() -> None:
        sync()
        with pool._cv:
            depth.set(len(pool._pending))
            live.set(pool._live)
        workers.set(pool.workers)

    h.add_collector(collect)
    return h


def instrument_fleet(transport, registry: MetricsRegistry
                     ) -> Optional[ObsHandle]:
    """:class:`~repro_torch.fleet.SocketTransport` metrics (gated on its
    ``host_states`` seam): fleet-wide queue depth and live-host gauges,
    and per-host labelled up, jobs and reconnects series, so a dashboard
    can tell which serve-worker host is flapping."""
    if not hasattr(transport, "host_states"):      # not a fleet transport
        return None
    h = ObsHandle(registry)
    depth = registry.gauge("fleet_queue_depth",
                           "jobs waiting for a serve-worker slot")
    hosts_n = registry.gauge("fleet_hosts_count", "configured fleet size")
    hosts_live = registry.gauge("fleet_hosts_live",
                                "hosts currently connected")
    host_up = registry.gauge("fleet_host_up",
                             "1 while this serve-worker host is connected",
                             labelnames=("host",))
    host_jobs = registry.counter("fleet_host_jobs_total",
                                 "results returned by this host",
                                 labelnames=("host",))
    host_reconn = registry.counter("fleet_host_reconnects_total",
                                   "connections re-established to this host",
                                   labelnames=("host",))
    sync = _delta_sync(registry, {
        "fleet_reconnects_total": "fleet_reconnects_total",
        "fleet_quarantined_total": "fleet_quarantined_total",
    }, transport.stats, help_map={
        "fleet_reconnects_total": "connections re-established fleet-wide",
        "fleet_quarantined_total": "poison pairs quarantined in the DB",
    })
    last = {}                                      # per-host counter floors

    def collect() -> None:
        sync()
        try:
            s = transport.stats()
        except Exception:
            return
        depth.set(s.get("fleet_queue_depth", 0))
        hosts_n.set(s.get("fleet_hosts_count", 0))
        hosts_live.set(s.get("fleet_hosts_live", 0))
        for name, hs in (s.get("hosts") or {}).items():
            host_up.labels(host=name).set(
                1.0 if hs.get("state") == "connected" else 0.0)
            for src, ctr in (("jobs_done", host_jobs),
                             ("reconnects", host_reconn)):
                v = float(hs.get(src, 0) or 0)
                prev = last.get((name, src), 0.0)
                if v > prev:                       # clamped delta
                    ctr.labels(host=name).inc(v - prev)
                last[(name, src)] = v

    h.add_collector(collect)
    return h


# -- stores -------------------------------------------------------------------
def instrument_db(db, registry: MetricsRegistry) -> Optional[ObsHandle]:
    """:class:`~repro_torch.measure.db.MeasureDB`: lookup hit/miss counters
    (wrapped at ``get`` — the transport-level hit counter only sees
    submit-time lookups; this one sees every consumer) plus corrupt-line
    and quarantine mirrors."""
    if _marked(db, registry):
        return None
    h = ObsHandle(registry)
    hits = registry.counter("measuredb_hits_total", "get() served a value")
    misses = registry.counter("measuredb_misses_total", "get() found nothing")
    puts = registry.counter("measuredb_puts_total", "records appended")

    orig_get, orig_put = db.get, db.put

    def get(key):
        v = orig_get(key)
        (misses if v is None else hits).inc()
        return v

    def put(key, value):
        out = orig_put(key, value)
        puts.inc()
        return out

    db.get, db.put = get, put

    def read() -> dict:
        return {"skipped_lines": db.skipped_lines,
                "quarantined": db.n_quarantined}
    h.add_collector(_delta_sync(registry, {
        "skipped_lines": "measuredb_corrupt_lines_total",
        "quarantined": "measuredb_quarantined_total",
    }, read, help_map={
        "measuredb_corrupt_lines_total": "unparseable JSONL lines skipped",
        "measuredb_quarantined_total": "poison keys reading back as inf",
    }))
    return h


def instrument_program_store(store, registry: MetricsRegistry
                             ) -> Optional[ObsHandle]:
    """:class:`~repro_torch.artifacts.ProgramStore`: warm-hit/miss mirror +
    entry count gauge."""
    if store is None or _marked(store, registry):
        return None
    h = ObsHandle(registry)
    entries = registry.gauge("store_programs_count", "programs held")
    sync = _delta_sync(registry, {
        "hits": "store_warm_hits_total",
        "misses": "store_misses_total",
        "skipped_lines": "store_corrupt_lines_total",
    }, store.stats, help_map={
        "store_warm_hits_total": "tunes answered by program lookup",
        "store_misses_total": "tunes that ran agent inference",
        "store_corrupt_lines_total": "unparseable JSONL lines skipped",
    })

    def collect() -> None:
        sync()
        try:
            entries.set(len(store))
        except Exception:
            pass
    h.add_collector(collect)
    return h


# -- serving ------------------------------------------------------------------
def instrument_serving(server, registry: MetricsRegistry
                       ) -> Optional[ObsHandle]:
    """:class:`~repro_torch.serving.Server`: queue-wait and end-to-end tune
    latency histograms plus a batch-size histogram via the server's
    ``request_observer`` seam (the serving analogue of the pool's
    ``job_observer``), a queue-depth/health gauge collector, and clamped
    counter mirrors for requests/sheds/deadline-misses/batches and the
    fused one-dispatch counters."""
    if server is None or _marked(server, registry):
        return None
    h = ObsHandle(registry)
    qwait = registry.histogram("serving_queue_wait_seconds",
                               "per-request time in the admission queue")
    lat = registry.histogram("serving_tune_seconds",
                             "end-to-end request latency (admit -> result)")
    bsize = registry.histogram("serving_batch_requests",
                               "requests coalesced per flushed batch")
    depth = registry.gauge("serving_queue_depth",
                           "requests awaiting a batch")
    health = registry.gauge("serving_health", "0=ok 1=degraded 2=down")

    def observer(event: str, queue_wait_s: float = 0.0,
                 latency_s: float = 0.0, batch_requests: int = 0,
                 **_fields) -> None:
        if event == "complete":
            qwait.observe(queue_wait_s)
            lat.observe(latency_s)
        elif event == "store_hit":
            lat.observe(latency_s)
        elif event == "batch":
            bsize.observe(batch_requests)
    server.request_observer = observer

    sync = _delta_sync(registry, {
        "serving_requests_total": "serving_requests_total",
        "serving_shed_total": "serving_shed_total",
        "serving_deadline_misses_total": "serving_deadline_misses_total",
        "serving_batches_total": "serving_batches_total",
        "serving_store_hits_total": "serving_store_hits_total",
        "serving_fused_dispatches_total": "serving_fused_dispatches_total",
        "serving_fused_traces_total": "serving_fused_traces_total",
    }, server.stats, help_map={
        "serving_requests_total": "tune requests admitted (incl. warm)",
        "serving_shed_total": "requests rejected at max_queue depth",
        "serving_deadline_misses_total":
            "requests whose SLO budget expired before execution",
        "serving_batches_total": "batches flushed",
        "serving_store_hits_total":
            "requests answered by program lookup at admission",
        "serving_fused_dispatches_total":
            "fused cost-grid device dispatches",
        "serving_fused_traces_total": "fused cost-grid graph captures",
    })

    def collect() -> None:
        sync()
        try:
            s = server.stats()
        except Exception:
            return
        depth.set(s.get("serving_queue_depth", 0))
        health.set(_HEALTH_CODE.get(s.get("health", "ok"), 0.0))

    h.add_collector(collect)
    return h


# -- oracles ------------------------------------------------------------------
def instrument_env(env, registry: MetricsRegistry,
                   tracer=NULL_TRACER) -> Optional[ObsHandle]:
    """:class:`~repro_torch.core.env.MeasuredEnv`: measured-vs-surrogate-
    priced pair mirror, breaker state gauge, measure-batch latency
    histogram."""
    if not hasattr(env, "breaker_open") or _marked(env, registry):
        return None
    h = ObsHandle(registry)
    batch_hist = registry.histogram("env_measure_batch_seconds",
                                    "_measured_costs() batch latency")
    breaker = registry.gauge("env_breaker_open",
                             "1 while the measurement circuit breaker "
                             "is open (analytic fallback)")

    orig = env._measured_costs

    def _measured_costs(sites, tiles):
        t0 = time.monotonic()
        out = orig(sites, tiles)
        batch_hist.observe(time.monotonic() - t0)
        return out
    env._measured_costs = _measured_costs

    def read() -> dict:
        return {"measure_calls": env.measure_calls,
                "measured_pairs": env.measured_pairs,
                "pruned_pairs": env.pruned_pairs}
    sync = _delta_sync(registry, {
        "measure_calls": "env_measure_calls_total",
        "measured_pairs": "env_measured_pairs_total",
        "pruned_pairs": "env_surrogate_priced_pairs_total",
    }, read, help_map={
        "env_measure_calls_total": "measure-hook invocations",
        "env_measured_pairs_total": "(site, tile) pairs sent to hardware",
        "env_surrogate_priced_pairs_total":
            "pairs priced by the surrogate instead of measured",
    })

    def collect() -> None:
        sync()
        breaker.set(1.0 if env.breaker_open else 0.0)
    h.add_collector(collect)
    return h


def instrument_surrogate(oracle, registry: MetricsRegistry
                         ) -> Optional[ObsHandle]:
    """:class:`~repro_torch.surrogate.SurrogateOracle`: pricing-call
    latency and result-cache hit counters, from the cache-size delta
    around each ``_surrogate_costs`` call."""
    if not hasattr(oracle, "_surrogate_costs") or _marked(oracle, registry):
        return None
    h = ObsHandle(registry)
    predict_hist = registry.histogram("surrogate_predict_seconds",
                                      "surrogate pricing-call latency")
    predicted = registry.counter("surrogate_predicted_pairs_total",
                                 "pairs priced by a fresh model prediction")
    cache_hits = registry.counter("surrogate_cache_hits_total",
                                  "pairs served from the result cache")

    orig = oracle._surrogate_costs

    def _surrogate_costs(sites, tiles):
        before = len(oracle._result_cache)
        t0 = time.monotonic()
        out = orig(sites, tiles)
        predict_hist.observe(time.monotonic() - t0)
        fresh = len(oracle._result_cache) - before
        if fresh > 0:
            predicted.inc(fresh)
        served = len(sites) - max(fresh, 0)
        if served > 0:
            cache_hits.inc(served)
        return out
    oracle._surrogate_costs = _surrogate_costs
    return h


def instrument_oracle_stack(oracle, registry: MetricsRegistry,
                            tracer=NULL_TRACER) -> ObsHandle:
    """Walk one oracle's dependency stack — env, its surrogate, its
    measure transport and DB — and instrument whatever is present.  Safe
    on any oracle (a plain :class:`CostModelEnv` yields an empty
    handle)."""
    h = ObsHandle(registry)
    h.adopt(instrument_env(oracle, registry, tracer))
    h.adopt(instrument_surrogate(oracle, registry))
    sur = getattr(oracle, "surrogate", None)
    if sur is not None and hasattr(sur, "_surrogate_costs"):
        h.adopt(instrument_surrogate(sur, registry))
    fn = getattr(oracle, "measure_fn", None)
    transport = getattr(fn, "transport", None)
    if transport is not None:
        h.adopt(instrument_transport(transport, registry, tracer))
    return h
