"""``repro_torch.obs`` — the telemetry substrate (the port of
``repro/obs``): metrics, traces, and retrofit instrumentation for the
tuning stack.

* :mod:`~repro_torch.obs.metrics` — Counter/Gauge/Histogram registry with
  ``snapshot()`` and Prometheus ``render_prom()``.
* :mod:`~repro_torch.obs.trace` — JSONL span tracing + ``to_chrome_trace()``.
* :mod:`~repro_torch.obs.instrument` — wrap the live measured env, its
  transport (in process, pool or fleet) and DB, and the program store into
  a registry without behavior change.

The facade wires all of this by default into the process-wide registry
(:func:`get_registry`); tracing is opt-in (``NeuroVectorizer(trace=
"t.jsonl")``).  The HTTP exporter (``MetricsServer``) is not ported yet.
"""
from repro_torch.obs.instrument import (ObsHandle, instrument_db,
                                        instrument_env, instrument_fleet,
                                        instrument_oracle_stack,
                                        instrument_pool,
                                        instrument_program_store,
                                        instrument_transport)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     get_registry)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   read_trace, to_chrome_trace)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "DEFAULT_LATENCY_BUCKETS",
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "read_trace",
    "to_chrome_trace",
    "ObsHandle", "instrument_transport", "instrument_pool",
    "instrument_fleet", "instrument_db", "instrument_env",
    "instrument_program_store", "instrument_oracle_stack",
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
