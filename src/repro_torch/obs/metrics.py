"""Process-wide metrics: ``Counter`` / ``Gauge`` / ``Histogram`` behind a
thread-safe :class:`MetricsRegistry`; the port of ``repro/obs/metrics.py``,
pure Python, with the reference's names and exposition text.

Cheap enough to leave on everywhere: a counter increment is one dict
update under an ``RLock``.  Metric names follow the
``<subsystem>_<noun>_<unit>`` convention of every ``stats()`` dict
(``transport_hits_total``, ``facade_tune_seconds``, ...).

Two read surfaces:

* :meth:`MetricsRegistry.snapshot` — a flat ``dict`` (histograms expand to
  ``{"count", "sum", "buckets"}`` with *cumulative* bucket counts);
* :meth:`MetricsRegistry.render_prom` — Prometheus text exposition
  (``# TYPE`` / ``# HELP`` + samples, histogram ``_bucket{le=...}`` /
  ``_sum`` / ``_count``).

Instrumented objects whose counters live elsewhere (a transport's
``stats()`` block, :class:`~repro_torch.core.env.MeasuredEnv`'s attribute
counters) register a *collector* — a zero-arg callable invoked before
every snapshot/render that syncs the latest values in
(:mod:`repro_torch.obs.instrument` builds these).

The process-wide default registry is :func:`get_registry`; pass an
explicit :class:`MetricsRegistry` for isolation (tests, benchmarks).
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "DEFAULT_LATENCY_BUCKETS"]

#: Fixed log-spaced latency buckets: two per decade from 1 microsecond to
#: 100 seconds (a kernel measurement, a tune, or a full fit all land
#: somewhere useful).  ``+Inf`` is implicit.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 12) for e in range(-12, 5))

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


def _check_name(name: str) -> str:
    if not name or name[0] not in _VALID_FIRST \
            or any(c not in _VALID_REST for c in name):
        raise ValueError(f"invalid metric name {name!r} (want "
                         f"[a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


def _label_key(labelnames: Sequence[str], labels: dict) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(f"expected labels {tuple(labelnames)}, "
                         f"got {tuple(labels)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Sequence[str], values: Sequence[str]) -> str:
    if not labelnames:
        return ""
    esc = [str(v).replace("\\", r"\\").replace('"', r'\"')
           .replace("\n", r"\n") for v in values]
    inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, esc))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if isinstance(v, float) else str(v)


class _Metric:
    """Shared machinery: one metric *family* = name + labelnames; each
    distinct label-value tuple is a child series.  An unlabelled family is
    its own single child, so ``counter("x").inc()`` just works."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_name(ln)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._series[()] = self._zero()

    def _zero(self):
        return 0.0

    def labels(self, **labels) -> "_Bound":
        key = _label_key(self.labelnames, labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = self._zero()
        return _Bound(self, key)

    def _default_key(self) -> Tuple[str, ...]:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} has labels "
                             f"{self.labelnames}; call .labels(...) first")
        return ()

    # Every verb exists on every kind; the _-hooks raise TypeError for
    # kinds that don't support it (counter.observe, histogram.inc, ...)
    # so a wrong verb is a loud type error, never an AttributeError.
    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._default_key(), amount)

    def dec(self, amount: float = 1.0) -> None:
        self._inc(self._default_key(), -amount)

    def set(self, value: float) -> None:
        self._set(self._default_key(), value)

    def observe(self, value: float) -> None:
        self._observe(self._default_key(), value)


class _Bound:
    """One labelled series of a family; proxies the family's verbs."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key, -amount)

    def set(self, value: float) -> None:
        self._metric._set(self._key, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)

    @property
    def value(self):
        return self._metric._get(self._key)


class Counter(_Metric):
    """Monotonically increasing count (``*_total`` by convention)."""

    kind = "counter"

    def _inc(self, key, amount) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(got {amount})")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _set(self, key, value) -> None:
        raise TypeError(f"counter {self.name!r} does not support set()")

    def _observe(self, key, value) -> None:
        raise TypeError(f"counter {self.name!r} does not support observe()")

    def _get(self, key):
        with self._lock:
            return self._series.get(key, 0.0)

    @property
    def value(self) -> float:
        return self._get(self._default_key())


class Gauge(_Metric):
    """A value that can go up and down (queue depth, breaker state)."""

    kind = "gauge"

    def _set(self, key, value) -> None:
        with self._lock:
            self._series[key] = float(value)

    def _inc(self, key, amount) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _observe(self, key, value) -> None:
        raise TypeError(f"gauge {self.name!r} does not support observe()")

    def _get(self, key):
        with self._lock:
            return self._series.get(key, 0.0)

    @property
    def value(self) -> float:
        return self._get(self._default_key())


class _HistState:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets       # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram (default: log-spaced latency buckets).

    ``observe(v)`` lands in the first bucket whose upper bound satisfies
    ``v <= le`` (Prometheus semantics); values above the last bound land
    in the implicit ``+Inf`` bucket.  ``snapshot`` exposes *cumulative*
    bucket counts keyed by the stringified bound.
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"buckets must be sorted and distinct: {b}")
        if math.isinf(b[-1]):
            b = b[:-1]                      # +Inf is implicit
        self.buckets = b
        super().__init__(name, help, labelnames, lock)

    def _zero(self):
        return _HistState(len(self.buckets) + 1)

    def _observe(self, key, value) -> None:
        value = float(value)
        i = len(self.buckets)
        for j, le in enumerate(self.buckets):       # ~17 bounds: linear scan
            if value <= le:
                i = j
                break
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = self._zero()
            st.counts[i] += 1
            st.sum += value
            st.count += 1

    def _inc(self, key, amount) -> None:
        raise TypeError(f"histogram {self.name!r} does not support inc()")

    def _set(self, key, value) -> None:
        raise TypeError(f"histogram {self.name!r} does not support set()")

    def _get(self, key):
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = self._zero()
            cum, acc = {}, 0
            for le, c in zip(self.buckets, st.counts):
                acc += c
                cum[_fmt_value(le)] = acc
            cum["+Inf"] = acc + st.counts[-1]
            return {"count": st.count, "sum": st.sum, "buckets": cum}

    @property
    def value(self) -> dict:
        return self._get(self._default_key())


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Thread-safe metric registry: get-or-create families by name.

    Re-requesting a name returns the existing family — with a
    ``ValueError`` if the kind or labelnames disagree (two subsystems
    silently sharing one name under different schemas is a bug).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "Dict[str, _Metric]" = {}
        self._collectors: "list[Callable[[], None]]" = []

    # -- get-or-create -------------------------------------------------------
    def _get_or_create(self, kind: str, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}; cannot re-register "
                        f"as {kind} with labels {tuple(labelnames)}")
                return m
            m = _KINDS[kind](name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create("histogram", name, help, labelnames,
                                   buckets=buckets)

    # -- collectors ----------------------------------------------------------
    def register_collector(self, fn: Callable[[], None]) -> Callable:
        """``fn()`` runs before every :meth:`snapshot`/:meth:`render_prom`
        — the sync point for counters that live on other objects.
        Returns ``fn`` (the unregister handle)."""
        with self._lock:
            self._collectors.append(fn)
        return fn

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            try:
                self._collectors.remove(fn)
            except ValueError:
                pass

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()

    # -- read surfaces -------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat ``{series_name: value}`` dict; labelled series render as
        ``name{label="v",...}``, histograms as
        ``{"count", "sum", "buckets"}`` dicts."""
        self._collect()
        out = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                for key in sorted(m._series):
                    out[name + _fmt_labels(m.labelnames, key)] = m._get(key)
        return out

    def render_prom(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        self._collect()
        lines: "list[str]" = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                for key in sorted(m._series):
                    if m.kind == "histogram":
                        v = m._get(key)
                        for le, c in v["buckets"].items():
                            ln = m.labelnames + ("le",)
                            lines.append(f"{name}_bucket"
                                         f"{_fmt_labels(ln, key + (le,))}"
                                         f" {c}")
                        lab = _fmt_labels(m.labelnames, key)
                        lines.append(f"{name}_sum{lab} "
                                     f"{_fmt_value(v['sum'])}")
                        lines.append(f"{name}_count{lab} {v['count']}")
                    else:
                        lines.append(
                            f"{name}{_fmt_labels(m.labelnames, key)} "
                            f"{_fmt_value(m._get(key))}")
        return "\n".join(lines) + "\n"


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry — what every facade/service
    instruments into unless handed an explicit one."""
    return _GLOBAL
