"""Fault tolerance: straggler detection, preemption handling, elastic
re-planning (a copy of ``repro/ft/monitor.py``: pure Python).

On a real multi-pod deployment the runtime (GKE/Borg + libtpu) restarts
failed workers; this module supplies the framework-side pieces that make a
restart cheap and a slow host visible:

* ``StepMonitor`` — per-step wall-time EMA + z-score straggler flags.
* ``PreemptionHandler`` — SIGTERM/SIGINT => checkpoint-and-exit flag.
* ``plan_elastic_mesh`` — given surviving chip count, the largest valid
  (data, model) grid with TP preserved, plus the data re-shard plan.
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple


class StepMonitor:
    """Per-step wall-time EMA with z-score straggler flags.

    Flags still accumulate in :attr:`events` (the in-process forensic
    record), and — when ``metrics=``/``tracer=`` wire it into the
    ``repro_torch.obs`` substrate — each flag also increments the
    ``straggler_flags_total`` counter and lands in the shared trace file
    as a ``straggler`` instant event, right next to the tune spans it
    stretched."""

    def __init__(self, alpha: float = 0.1, z_thresh: float = 3.0,
                 warmup: int = 5, metrics=None, tracer=None):
        self.alpha = alpha
        self.z = z_thresh
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: List[dict] = []
        self._t0: Optional[float] = None
        self._counter = None
        if metrics is not None:
            self._counter = metrics.counter(
                "straggler_flags_total",
                "steps flagged as stragglers by StepMonitor")
        self._tracer = tracer

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> Optional[dict]:
        dt = time.monotonic() - self._t0
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else (
                self.mean + (dt - self.mean) / self.n)
            return None
        z = (dt - self.mean) / (math.sqrt(self.var) + 1e-9) \
            if self.var > 0 else 0.0
        ev = None
        if z > self.z:
            ev = {"step": step, "dt": dt, "mean": self.mean, "z": z,
                  "kind": "straggler"}
            self.events.append(ev)
            if self._counter is not None:
                self._counter.inc()
            if self._tracer is not None:
                self._tracer.event("straggler", step=step, dt=dt,
                                   mean=self.mean, z=z)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return ev


class PreemptionHandler:
    """Installs SIGTERM/SIGINT handlers; trainer polls ``should_stop``.

    ``on_stop`` is the push-side alternative for consumers with no poll
    loop (e.g. the reference's ``TuningService``): invoked once from
    the handler after ``should_stop`` is set — drain and close there."""

    def __init__(self, signals=(signal.SIGTERM,), on_stop=None):
        self.should_stop = False
        self._on_stop = on_stop
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):
        already = self.should_stop
        self.should_stop = True
        if self._on_stop is not None and not already:
            self._on_stop()

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_chips: int
    global_batch: int


def plan_elastic_mesh(healthy_chips: int, model_parallel: int,
                      global_batch: int, multi_pod: bool = False
                      ) -> ElasticPlan:
    """Largest power-of-two data axis that fits the surviving chips with TP
    preserved (TP degree is baked into weight shardings; DP is elastic)."""
    assert healthy_chips >= model_parallel, "cannot preserve TP degree"
    dp = healthy_chips // model_parallel
    dp = 2 ** int(math.log2(dp))
    used = dp * model_parallel
    # keep per-replica batch constant: shrink the global batch with DP
    gb = global_batch
    while gb % dp:
        gb -= 1
    if multi_pod and dp % 2 == 0:
        return ElasticPlan((2, dp // 2, model_parallel),
                           ("pod", "data", "model"),
                           healthy_chips - used, gb)
    return ElasticPlan((dp, model_parallel), ("data", "model"),
                       healthy_chips - used, gb)
