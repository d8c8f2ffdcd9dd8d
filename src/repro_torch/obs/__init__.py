"""``repro_torch.obs`` — the telemetry substrate (the port of
``repro/obs``): metrics, traces, and retrofit instrumentation for the
tuning stack.

* :mod:`~repro_torch.obs.metrics` — Counter/Gauge/Histogram registry with
  ``snapshot()`` and Prometheus ``render_prom()``.
* :mod:`~repro_torch.obs.trace` — span tracing, to JSONL or kept in
  memory, + ``to_chrome_trace()``; the process's active tracer
  (:func:`tracing`, ``trace.active()``), which the model step's ``nv.*``
  spans and the MoE's ``moe.kept`` device counter report to, mirrored
  into a recording ``torch.profiler`` on its clock.
* :mod:`~repro_torch.obs.instrument` — wrap the live measured env, its
  surrogate, its transport (in process, pool or fleet) and DB, the
  program store and the batch server into a registry without behavior
  change.
* :mod:`~repro_torch.obs.exporter` — :class:`MetricsServer`, the stdlib
  HTTP endpoint serving a registry's Prometheus text on ``/metrics``.

The facade and the tuning service wire all of this by default into the
process-wide registry (:func:`get_registry`); tracing is opt-in
(``NeuroVectorizer(trace="t.jsonl")``; ``with tracing(Tracer()):`` for
the model step and site extraction).  Off, a span site in the model step
costs one flag check; a prefill run under ``torch.profiler`` with no
tracer active puts its spans into the profiler alone.
"""
from repro_torch.obs.exporter import MetricsServer
from repro_torch.obs.instrument import (ObsHandle, instrument_db,
                                        instrument_env, instrument_fleet,
                                        instrument_oracle_stack,
                                        instrument_pool,
                                        instrument_program_store,
                                        instrument_serving,
                                        instrument_surrogate,
                                        instrument_transport)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     get_registry)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   read_trace, to_chrome_trace, tracing)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "DEFAULT_LATENCY_BUCKETS",
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "read_trace",
    "to_chrome_trace", "tracing",
    "ObsHandle", "instrument_transport", "instrument_pool",
    "instrument_fleet", "instrument_db", "instrument_env",
    "instrument_surrogate", "instrument_program_store",
    "instrument_serving", "instrument_oracle_stack", "MetricsServer",
    "resolve_obs",
]


def resolve_obs(metrics=None, trace=None):
    """Resolve the facade's ``metrics=`` / ``trace=`` arguments.

    ``metrics``: ``None`` → the process-wide registry (metrics on by
    default), ``False`` → disabled (an isolated throwaway registry no
    one snapshots), or an explicit :class:`MetricsRegistry`.

    ``trace``: ``None``/``False`` → off (:data:`NULL_TRACER`), a path →
    a new *owned* :class:`Tracer` (the caller closes it), or a ``Tracer``
    instance → borrowed.

    Returns ``(registry, tracer, owns_tracer)``.
    """
    if metrics is None:
        registry = get_registry()
    elif metrics is False:
        registry = MetricsRegistry()
    elif isinstance(metrics, MetricsRegistry):
        registry = metrics
    else:
        raise TypeError(f"metrics= expects None, False, or a "
                        f"MetricsRegistry, got {type(metrics).__name__}")
    if trace is None or trace is False:
        return registry, NULL_TRACER, False
    if isinstance(trace, str):
        return registry, Tracer(trace), True
    if isinstance(trace, (Tracer, NullTracer)):
        return registry, trace, False
    raise TypeError(f"trace= expects None, a path, or a Tracer, "
                    f"got {type(trace).__name__}")
