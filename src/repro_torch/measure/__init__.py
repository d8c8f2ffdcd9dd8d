"""``repro_torch.measure``: the measured oracle's stack (the port of
``repro/measure``, in-process transport only).

Closes the paper's loop: the reward becomes the *measured* execution time
of the Hopper kernels (eq. 2) instead of the analytic stand-in.

* :mod:`~repro_torch.measure.timing`: the one median-of-reps loop;
* :mod:`~repro_torch.measure.runner`: :class:`MeasureRunner`, the batched
  build-and-time primitive (kernels on the card; plain versions with
  capped shapes on the CPU when asked for; per-tile failures fail closed);
* :mod:`~repro_torch.measure.db`: :class:`MeasureDB`, the persistent
  JSONL timing store in the reference's format;
* :mod:`~repro_torch.measure.transport`: :class:`InProcessTransport` and
  the ``measure_fn`` adapters.

:func:`make_transport` builds a transport by name and
:func:`make_measured_env` assembles a ready
:class:`~repro_torch.core.env.MeasuredEnv`.  The subprocess pool, the
socket fleet, fault injection and surrogate pruning are not ported yet.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.measure import timing
from repro_torch.measure.db import MeasureDB, make_key, open_measure_db
from repro_torch.measure.runner import MeasureRunner
from repro_torch.measure.transport import (CachedMeasureFn,
                                           InProcessTransport,
                                           TransportMeasureFn)

TRANSPORT_NAMES = ("inproc", "pool", "socket")

__all__ = ["MeasureRunner", "MeasureDB", "CachedMeasureFn", "make_key",
           "open_measure_db", "InProcessTransport", "TransportMeasureFn",
           "TRANSPORT_NAMES", "make_transport", "make_measured_env",
           "timing"]


def make_transport(name: str = "inproc", *, db_path: Optional[str] = None,
                   runner: Optional[MeasureRunner] = None,
                   **runner_kwargs):
    """Build a :class:`~repro_torch.core.protocols.MeasureTransport` by
    name.  ``"inproc"``: the calling process measures.  ``db_path``
    attaches the persistent timing store.  ``runner_kwargs`` build the
    :class:`MeasureRunner` (``reps=``, ``warmup=``, ``device=``)."""
    if name in ("pool", "socket"):
        raise NotImplementedError(f"transport {name!r} is not ported yet "
                                  f"(ROADMAP queue 1 item 3); use 'inproc'")
    if name != "inproc":
        raise ValueError(f"unknown transport {name!r}; "
                         f"registered: {', '.join(TRANSPORT_NAMES)}")
    if runner is None:
        runner = MeasureRunner(**runner_kwargs)
    elif runner_kwargs:
        raise TypeError("pass either runner= or runner kwargs, not both")
    db = open_measure_db(db_path) if db_path else None
    return InProcessTransport(runner, db)


def make_measured_env(cfg=None, db_path: Optional[str] = None,
                      runner: Optional[MeasureRunner] = None,
                      seed: int = 0, transport="inproc",
                      legality: str = "h100",
                      prune_topk: Optional[int] = None, surrogate=None,
                      **runner_kwargs):
    """A :class:`~repro_torch.core.env.MeasuredEnv` wired to a measurement
    stack: ``transport`` names it (only ``"inproc"`` is ported; ``None``
    means it too) or is a pre-built
    :class:`~repro_torch.core.protocols.MeasureTransport`, which carries
    its own runner and DB; ``db_path`` enables the persistent timing DB (a
    second run against the same path times nothing); ``legality`` is the
    env's (under ``"h100"`` no tile the kernels cannot launch is sent to
    the runner); extra kwargs build the :class:`MeasureRunner`
    (``reps=``, ``warmup=``, ``device=``).  The hook is
    ``env.measure_fn`` (``.transport``, ``.db``; ``.runner`` in
    process)."""
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.env import MeasuredEnv

    if prune_topk is not None or surrogate is not None:
        raise NotImplementedError("surrogate grid pruning (prune_topk=, "
                                  "surrogate=) is not ported yet (ROADMAP "
                                  "queue 1 item 3)")
    if transport is None or isinstance(transport, str):
        t = make_transport(transport or "inproc", db_path=db_path,
                           runner=runner, **runner_kwargs)
    else:
        if db_path is not None or runner is not None or runner_kwargs:
            raise TypeError("a pre-built transport carries its own "
                            "runner and db: drop the extra arguments")
        t = transport
    fn = (CachedMeasureFn(t) if isinstance(t, InProcessTransport)
          else TransportMeasureFn(t))
    return MeasuredEnv(cfg if cfg is not None else DEFAULT, measure_fn=fn,
                       seed=seed, legality=legality)
