"""The trace's arithmetic, on a plain timeline.

A :class:`Event` is a named interval on the host or on the device, in
microseconds on one clock.  :func:`from_profiler` turns a finished
``torch.profiler`` run into events; everything else here works on the
plain list, so that a test can hand it a synthetic timeline.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from perfbench.work import KERNELS

WINDOW_MARK = "perfbench.prefill"    # the host annotation around a prefill


@dataclass(frozen=True)
class Event:
    name: str
    device: bool        # True: ran on the card
    start: float        # microseconds
    end: float


def kernel_name(raw: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameter list."""
    name = raw.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()


def family(name: str) -> Optional[str]:
    """``"k1"``, ``"k1f32"``, ``"k2"`` or ``"k3"`` for the port's kernels,
    else ``None``."""
    base = kernel_name(name)
    for fam, names in KERNELS.items():
        if base in names:
            return fam
    return None


def _device_activity(name: str) -> bool:
    """Kernels, copies and fills; not the trace's synchronisation
    records, which mark the host waiting, nor the host's annotations
    mirrored onto the device's timeline."""
    return not ("Sync" in name or name.startswith("cuda")
                or name.startswith("ProfilerStep") or name == WINDOW_MARK)


def from_profiler(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``: its device
    activity and its host operations, on the trace's clock."""
    out = []
    for e in prof.events():
        on_device = str(e.device_type).endswith("CUDA")
        if on_device and (getattr(e, "is_user_annotation", False)
                          or not _device_activity(e.name)):
            continue
        out.append(Event(e.name, on_device, float(e.time_range.start),
                         float(e.time_range.end)))
    return out


def window(events: Iterable[Event], mark: str = WINDOW_MARK
           ) -> Tuple[float, float, int]:
    """``(start, end, n)``: from the first host ``mark`` to the end of the
    last, and how many there are."""
    marks = [e for e in events if not e.device and e.name == mark]
    if not marks:
        return 0.0, 0.0, 0
    return (min(e.start for e in marks), max(e.end for e in marks),
            len(marks))


def _clip(events, t0, t1):
    for e in events:
        a, b = max(e.start, t0), min(e.end, t1)
        if b > a:
            yield a, b, e


def busy_intervals(events: Iterable[Event], t0: float, t1: float
                   ) -> List[Tuple[float, float]]:
    """The union of the device's activity within ``[t0, t1]``."""
    iv = sorted((a, b) for a, b, e in _clip(events, t0, t1) if e.device)
    merged: List[List[float]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(events: List[Event], t0: float, t1: float) -> float:
    return sum(b - a for a, b in busy_intervals(events, t0, t1))


def idle_gaps(events: List[Event], t0: float, t1: float
              ) -> List[Tuple[float, float]]:
    """The stretches of ``[t0, t1]`` in which nothing ran on the device."""
    gaps, at = [], t0
    for a, b in busy_intervals(events, t0, t1):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1 > at:
        gaps.append((at, t1))
    return gaps


def device_us_by_name(events: List[Event], t0: float, t1: float
                      ) -> Dict[str, float]:
    """Device time within ``[t0, t1]`` by kernel (or copy) name."""
    out: Dict[str, float] = defaultdict(float)
    for a, b, e in _clip(events, t0, t1):
        if e.device:
            out[kernel_name(e.name)] += b - a
    return dict(out)


def device_us_by_family(events: List[Event], t0: float, t1: float
                        ) -> Dict[str, float]:
    """Device time by the port's kernel family; the rest under
    ``"other"``."""
    out: Dict[str, float] = defaultdict(float)
    for name, us in device_us_by_name(events, t0, t1).items():
        out[family(name) or "other"] += us
    return dict(out)


def idle_by_host_op(events: List[Event], t0: float, t1: float
                    ) -> Dict[str, float]:
    """The device's idle time within ``[t0, t1]``, each gap charged to
    what the host was doing at its middle: the innermost host operation
    that covers it, ``"(no host op)"`` where none does.  One sweep over
    the gaps and the host's operations, both in order of time."""
    host = sorted((e for e in events if not e.device),
                  key=lambda e: (e.start, -e.end))
    out: Dict[str, float] = defaultdict(float)
    stack: List[Event] = []     # the host operations open at the sweep
    i = 0
    for a, b in idle_gaps(events, t0, t1):
        t = (a + b) / 2
        while i < len(host) and host[i].start <= t:
            e = host[i]
            i += 1
            while stack and stack[-1].end <= e.start:
                stack.pop()
            stack.append(e)
        while stack and stack[-1].end <= t:
            stack.pop()
        out[stack[-1].name if stack else "(no host op)"] += b - a
    return dict(out)


def top(d: Dict[str, float], n: int = 10, scale: float = 1e-6) -> list:
    """The ``n`` largest entries as ``[name, value * scale]`` (seconds
    from microseconds by default)."""
    return [[k, v * scale] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
