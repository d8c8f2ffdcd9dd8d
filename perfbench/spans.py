"""The program's ``nv.*`` spans and ``moe.kept`` counter against the
device trace.

:func:`launched` pairs each device event of a finished ``torch.profiler``
run with the host time of the op that launched it (the profiler's linked
correlation id); :func:`device_us_by_span` charges each device event to
the innermost ``nv.*`` range open on the host at its launch.  The program
opens those ranges while a profiler records (``repro_torch.obs.trace``).
``tools/span_probe.py`` reads the cells' span metrics through these;
the harness's ``Record`` does not carry the profiler or the program's
tracer yet.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from perfbench import timeline
from perfbench.spec import ModelSpec
from perfbench.timeline import Event

PREFIX = "nv."
NO_SPAN = "(no span)"


def launched(prof) -> List[Tuple[Event, float]]:
    """Each device event of a finished ``torch.profiler.profile`` that
    ``timeline.from_profiler`` keeps, with the start of the host op or
    range that launched it, in microseconds on the trace's clock.  An
    event whose launch the trace does not hold is left out.  The CUDA
    runtime's and driver's calls (``cuda*``, ``cu*``) number their
    correlation ids apart from the ops': they are no launcher here."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    ops: Dict[int, float] = {}
    dev = []
    for e in res.events():
        if str(e.device_type()).endswith("CPU"):
            if not e.name().startswith("cu"):
                ops[e.correlation_id()] = (e.start_ns() - t0) * 1e-3
        elif not e.is_user_annotation() and \
                timeline._device_activity(e.name()):
            dev.append((Event(e.name(), True, (e.start_ns() - t0) * 1e-3,
                              (e.end_ns() - t0) * 1e-3),
                        e.linked_correlation_id()))
    return [(ev, ops[c]) for ev, c in dev if c in ops]


def device_us_by_span(launches: List[Tuple[Event, float]],
                      events: List[Event], t0: float, t1: float,
                      prefix: str = PREFIX) -> Dict[str, float]:
    """Device time within ``[t0, t1]`` by the innermost host range named
    ``prefix...`` open at each event's launch; :data:`NO_SPAN` where none
    is.  One sweep over the launches and the ranges, both in order of
    time."""
    spans = sorted((e for e in events
                    if not e.device and e.name.startswith(prefix)),
                   key=lambda e: (e.start, -e.end))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Event] = []     # the ranges open at the sweep
    i = 0
    for ev, at in sorted(launches, key=lambda p: p[1]):
        a, b = max(ev.start, t0), min(ev.end, t1)
        if b <= a:
            continue
        while i < len(spans) and spans[i].start <= at:
            e = spans[i]
            i += 1
            while stack and stack[-1].end <= e.start:
                stack.pop()
            stack.append(e)
        while stack and stack[-1].end <= at:
            stack.pop()
        out[stack[-1].name if stack else NO_SPAN] += b - a
    return dict(out)


def moe_slots(s: ModelSpec, tokens: int) -> int:
    """The expert slots one prefill of ``tokens`` tokens computes: ``E * C``
    a MoE layer, ``C`` the capacity of the GShard rule the configuration
    assumes (``T * K * factor / E``, rounded up to a multiple of 8, at
    least 8), whether a slot holds a token or not."""
    if not s.moe:
        return 0
    c = int(tokens * s.top_k * s.capacity_factor / s.n_experts)
    c = max(8, -(-c // 8) * 8)
    return s.n_layers * s.n_experts * c
