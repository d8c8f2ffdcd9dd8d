"""Structured span tracing — the *when* the metrics registry cannot hold;
the port of ``repro/obs/trace.py``, pure Python, with the reference's
JSONL schema (so one reader serves traces of either package).

A :class:`Tracer` appends one JSON line per finished span (or instant
event) to a trace file: name, start on the wall clock, duration on the
monotonic one, span id, parent id, thread, attributes, and the exception type
if the span body raised.  Parentage is implicit — a span opened while
another is open on the same thread becomes its child — with an explicit
``parent=`` override for work that hops threads.

The file is plain JSONL so it can be grepped, tailed, and diffed;
:func:`to_chrome_trace` converts it to the Chrome/Perfetto trace-event
JSON (open ``chrome://tracing`` or https://ui.perfetto.dev and load the
converted file) for a visual timeline of a whole tuning run:
``session`` → ``fit`` → ``tune`` → ``submit``/``drain`` batches.
Chrome events keep the reference's category, ``"repro"``.

Tracing off is the default everywhere: :data:`NULL_TRACER` swallows every
call at the cost of one attribute lookup, so instrumented code paths need
no ``if tracing:`` branches.

Inside the model step, where a prefill opens about 300 spans, each span
site reads the process's active tracer (:func:`active`, set by
:func:`tracing`) and checks its ``enabled`` flag before it builds a name,
an attribute or a profiler range::

    tr = trace.active()
    with tr.span("nv.attn") if tr.enabled else trace.NO_SPAN:
        ...

A tracer with ``path=None`` keeps its records in memory
(:meth:`Tracer.records`) and writes nothing.  While a ``torch.profiler``
records, every span a :class:`Tracer` opens (a detached root aside) is
also a profiler range of the same name, its attributes the range's
arguments (in an exported trace where the profiler records shapes); the
record and the range stamp their start on the wall clock, which is the
profiler's.  A model step run under a profiler with no tracer active
puts its spans into the profiler alone (:func:`for_step`).
:meth:`Tracer.count` adds a device tensor into a buffer on its device
without a sync; :meth:`Tracer.counters` reads the buffers back once.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Optional, Union

# one shared encoder: json.dumps(..., default=str) builds a fresh
# JSONEncoder per call, which dominates the span write path
_ENCODER = json.JSONEncoder(separators=(",", ":"), default=str)

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "NO_SPAN",
           "active", "tracing", "for_step", "read_trace", "to_chrome_trace"]


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process (none can
    where torch is not loaded)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def _profiler_range(name: str, attrs: dict):
    """An unentered profiler range ``name`` with ``attrs`` as its
    arguments.  A plain function range, not a user annotation: the
    profiler copies no range of it onto the device's timeline, and it
    costs a fraction of ``record_function``."""
    import torch
    return torch._C._profiler._RecordFunctionFast(name, [], {
        k: v if isinstance(v, (bool, int, float, str)) else str(v)
        for k, v in attrs.items()})


class Span:
    """One open span; close with :meth:`end` (or use as context manager —
    the body raising still closes the span, recording the error)."""

    __slots__ = ("tracer", "name", "id", "parent", "attrs", "ts", "t0",
                 "tid", "range")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent: Optional[int], attrs: dict):
        self.tracer = tracer
        self.name = name
        self.id = span_id
        self.parent = parent
        self.attrs = attrs
        self.ts = time.time()           # the start, on the profiler's clock
        self.t0 = time.monotonic()      # the duration's
        self.tid = threading.get_ident()
        self.range = None               # the profiler's, while one records

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes before the span ends."""
        self.attrs.update(attrs)
        return self

    def end(self, error: Optional[str] = None) -> None:
        self.tracer._end(self, error)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(error=None if exc_type is None
                 else f"{exc_type.__name__}: {exc}")


class _NullSpan:
    """The do-nothing span: every verb is a no-op, so disabled tracing
    costs one method call and nothing else."""

    __slots__ = ()
    id = None
    parent = None

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end(self, error=None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()
NO_SPAN = _NULL_SPAN     # a span site's context while tracing is off


class Tracer:
    """Append-only JSONL span writer with implicit per-thread nesting.

    ``path`` is opened lazily on the first record (mode ``"w"`` truncates
    by default — one trace file per run; pass ``mode="a"`` to accumulate).
    With ``path=None`` the records stay in memory (:meth:`records`).
    Thread-safe: span ids and file writes are serialized under one lock;
    the open-span stack is thread-local, so concurrent sessions nest
    correctly without seeing each other.
    """

    enabled = True

    def __init__(self, path: Optional[str] = None, mode: str = "w"):
        self.path = path
        self._mode = mode
        self._fh = None
        self._records: list = []
        self._counts: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 1
        self.n_spans = 0
        self.n_events = 0
        self._unflushed = 0
        self._last_flush = time.monotonic()

    # -- the write path ------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _write(self, rec: dict) -> None:
        if self.path is None:
            with self._lock:
                self._records.append(rec)
            return
        line = _ENCODER.encode(rec)
        with self._lock:
            if self._fh is None:
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, self._mode)
            self._fh.write(line + "\n")
            # flush periodically, not per record: a crash loses at most
            # ~1s / 64 spans of trail, and the hot path skips the syscall
            self._unflushed += 1
            now = time.monotonic()
            if self._unflushed >= 64 or now - self._last_flush >= 1.0:
                self._fh.flush()
                self._unflushed = 0
                self._last_flush = now

    # -- spans ---------------------------------------------------------------
    def begin(self, name: str, parent: Union[int, Span, None] = None,
              detached: bool = False, **attrs) -> Span:
        """Open a span.  ``parent`` defaults to the innermost open span on
        *this thread*; pass a :class:`Span` (or its id) explicitly when
        the logical parent lives on another thread.  ``detached=True``
        keeps the span off this thread's implicit-parent stack — for
        long-lived roots (a session) whose children arrive from many
        threads with explicit ``parent=`` links."""
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        if parent is None:
            st = self._stack()
            parent_id = st[-1].id if st else None
        else:
            parent_id = parent.id if isinstance(parent, Span) else int(parent)
        span = Span(self, name, span_id, parent_id, attrs)
        if not detached:
            self._stack().append(span)
            if _profiling():
                span.range = _profiler_range(name, attrs)
                span.range.__enter__()
        return span

    def span(self, name: str, parent: Union[int, Span, None] = None,
             **attrs) -> Span:
        """Context-manager spelling of :meth:`begin`::

            with tracer.span("tune", n_sites=len(sites)):
                ...
        """
        return self.begin(name, parent=parent, **attrs)

    def _end(self, span: Span, error: Optional[str]) -> None:
        t1 = time.monotonic()
        if span.range is not None:
            span.range.__exit__(None, None, None)
        st = self._stack()
        # exception-safe pop: the span may be closed out of order (or from
        # a different thread than it was opened on) — remove, don't assert
        for i in range(len(st) - 1, -1, -1):
            if st[i] is span:
                del st[i]
                break
        rec = {"type": "span", "name": span.name, "id": span.id,
               "parent": span.parent, "ts": span.ts,
               "dur": t1 - span.t0, "pid": os.getpid(), "tid": span.tid}
        if span.attrs:
            rec["attrs"] = span.attrs
        if error is not None:
            rec["error"] = error
        self._write(rec)
        with self._lock:
            self.n_spans += 1

    # -- instants ------------------------------------------------------------
    def event(self, name: str, **attrs) -> None:
        """A zero-duration instant (e.g. a straggler flag), parented to
        the innermost open span on this thread."""
        st = self._stack()
        rec = {"type": "event", "name": name,
               "parent": st[-1].id if st else None,
               "ts": time.time(),
               "pid": os.getpid(), "tid": threading.get_ident()}
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)
        with self._lock:
            self.n_events += 1

    # -- device counters -----------------------------------------------------
    def count(self, name: str, value) -> None:
        """Add the scalar tensor ``value`` into the counter ``name``, a
        buffer on its device: no sync.  A ``meta`` value (a step traced
        for its sites) counts nothing."""
        if value.device.type == "meta":
            return
        buf = self._counts.get(name)
        if buf is None:
            import torch
            with torch.inference_mode(False):   # usable in and out of it
                buf = self._counts[name] = torch.zeros(
                    (), dtype=value.dtype, device=value.device)
        buf.add_(value.detach())

    def counters(self) -> dict:
        """Each counter's value, read back from its device (a sync)."""
        return {k: v.item() for k, v in self._counts.items()}

    def records(self) -> list:
        """The records an in-memory tracer (``path=None``) kept."""
        with self._lock:
            return list(self._records)

    # -- lifecycle -----------------------------------------------------------
    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._unflushed = 0
                self._last_flush = time.monotonic()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracer:
    """Tracing disabled: every span/event is a shared no-op object."""

    enabled = False
    path = None
    n_spans = 0
    n_events = 0

    def begin(self, name, parent=None, detached=False, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def span(self, name, parent=None, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name, **attrs) -> None:
        pass

    def count(self, name, value) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def records(self) -> list:
        return []

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullTracer":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_TRACER = NullTracer()


class _ProfilerRanges(NullTracer):
    """A model step's spans put into a recording ``torch.profiler``
    alone: no record, no counter (:func:`for_step`)."""

    enabled = True

    def span(self, name, parent=None, **attrs):
        return _profiler_range(name, attrs)


_PROFILER_RANGES = _ProfilerRanges()
_active: Union[Tracer, NullTracer] = NULL_TRACER


def active() -> Union[Tracer, NullTracer]:
    """The process's active tracer, which code that is passed none
    reports to: :data:`NULL_TRACER` unless :func:`tracing` set one."""
    return _active


@contextlib.contextmanager
def tracing(tracer: Union[Tracer, NullTracer]):
    """Make ``tracer`` the active one for the block."""
    global _active
    prev, _active = _active, tracer
    try:
        yield tracer
    finally:
        _active = prev


def for_step() -> Union[Tracer, NullTracer]:
    """The tracer a model step reports to: the active one where tracing
    is on; else, while a ``torch.profiler`` records, one that puts the
    step's spans into the profiler alone; else :data:`NULL_TRACER`."""
    if _active.enabled or not _profiling():
        return _active
    return _PROFILER_RANGES


def read_trace(path: str) -> list:
    """Parse a trace file back into a list of record dicts (corrupt or
    torn lines are skipped, matching the MeasureDB discipline)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "name" in rec:
                out.append(rec)
    return out


def to_chrome_trace(trace: Union[str, list]) -> dict:
    """Convert a JSONL trace (path or pre-read record list) to the
    Chrome/Perfetto trace-event format: ``{"traceEvents": [...]}`` with
    complete (``"X"``) events for spans and instant (``"i"``) events.

    Span/parent ids survive in ``args`` (chrome's flow UI does not model
    a parent pointer; the nesting is reconstructed from timing per tid,
    which matches because children are contained in their parents).
    Timestamps are microseconds as the format requires.
    """
    records = read_trace(trace) if isinstance(trace, str) else trace
    events = []
    for r in records:
        args = dict(r.get("attrs") or {})
        if r.get("id") is not None:
            args["span_id"] = r["id"]
        if r.get("parent") is not None:
            args["parent_id"] = r["parent"]
        if r.get("error") is not None:
            args["error"] = r["error"]
        base = {"name": r["name"], "cat": "repro",
                "pid": r.get("pid", 0), "tid": r.get("tid", 0),
                "ts": float(r.get("ts", 0.0)) * 1e6, "args": args}
        if r.get("type") == "event":
            events.append({**base, "ph": "i", "s": "t"})
        else:
            events.append({**base, "ph": "X",
                           "dur": float(r.get("dur", 0.0)) * 1e6})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
