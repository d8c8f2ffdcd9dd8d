"""``repro_torch.measure``: the measured oracle's stack (the port of
``repro/measure``).

Closes the paper's loop: the reward becomes the *measured* execution time
of the Hopper kernels (eq. 2) instead of the analytic stand-in.

* :mod:`~repro_torch.measure.timing`: the one median-of-reps loop;
* :mod:`~repro_torch.measure.runner`: :class:`MeasureRunner`, the batched
  build-and-time primitive (kernels on the card; plain versions with
  capped shapes on the CPU when asked for; per-tile failures fail closed);
* :mod:`~repro_torch.measure.db`: :class:`MeasureDB`, the persistent
  JSONL timing store in the reference's format, quarantine included;
* :mod:`~repro_torch.measure.transport` / :mod:`~repro_torch.measure.pool`:
  *how* measurements execute, behind the asynchronous
  :class:`~repro_torch.core.protocols.MeasureTransport` contract:
  :class:`InProcessTransport` (this process) and
  :class:`WorkerPoolTransport` (N subprocess workers, each with its own
  CUDA context, over the length-prefixed JSON pipe protocol of
  :mod:`~repro_torch.measure.wire`); the ``socket`` transport to remote
  ``serve-worker`` daemons lives in :mod:`repro_torch.fleet`;
* :mod:`~repro_torch.measure.faults`: deterministic chaos machinery
  (:class:`FaultInjectionTransport`, :class:`ChaosRunner`,
  :class:`FaultSchedule`).

:func:`make_transport` builds a transport by name and
:func:`make_measured_env` assembles a ready
:class:`~repro_torch.core.env.MeasuredEnv`, with surrogate grid pruning
(``prune_topk=``; :func:`resolve_surrogate`) when asked for.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.measure.db import MeasureDB, make_key, open_measure_db
from repro_torch.measure.faults import (ChaosRunner, FaultInjectionTransport,
                                        FaultSchedule)
from repro_torch.measure.pool import WorkerPoolTransport, respawn_backoff
from repro_torch.measure.transport import (CachedMeasureFn,
                                           InProcessTransport,
                                           TransportMeasureFn)

TRANSPORT_NAMES = ("inproc", "pool", "socket")

__all__ = ["MeasureRunner", "MeasureDB", "CachedMeasureFn", "make_key",
           "open_measure_db", "InProcessTransport", "WorkerPoolTransport",
           "TransportMeasureFn", "TRANSPORT_NAMES", "make_transport",
           "make_measured_env", "resolve_surrogate", "timing",
           "FaultInjectionTransport",
           "ChaosRunner", "FaultSchedule", "respawn_backoff"]


def __getattr__(name):
    # the runner and the timing loop import torch: loaded on first use, so
    # a pool worker whose runner needs no torch (a test factory) starts at
    # once
    if name == "MeasureRunner":
        from repro_torch.measure.runner import MeasureRunner
        return MeasureRunner
    if name == "timing":
        import importlib
        return importlib.import_module("repro_torch.measure.timing")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_transport(name: str = "inproc", *, db_path: Optional[str] = None,
                   db: Optional[MeasureDB] = None, runner=None,
                   workers: Optional[int] = None,
                   hosts=None, **runner_kwargs):
    """Build a :class:`~repro_torch.core.protocols.MeasureTransport` by
    name.

    ``"inproc"``: the calling process measures (``workers`` unset);
    ``"pool"``: ``workers`` subprocess workers (default 2), each building
    its own :class:`MeasureRunner` from ``runner_kwargs`` (``reps=``,
    ``warmup=``, ``device=``; the card by default); ``"socket"``: a
    :class:`~repro_torch.fleet.transport.SocketTransport` to the
    ``serve-worker`` daemons named by ``hosts=["host:port", ...]`` (the
    runner is configured on those hosts).  ``db_path`` or ``db`` attach
    the persistent timing store; ``db_path="fleet://host:port"`` attaches
    the shared artifact service.
    """
    if db is not None and db_path is not None:
        raise TypeError("pass either db= or db_path=, not both")
    if db is None and db_path:
        db = open_measure_db(db_path)
    if hosts is not None and name != "socket":
        raise ValueError("hosts= applies only to transport='socket'")
    if name == "inproc":
        if workers is not None:
            raise ValueError("workers= applies only to transport='pool'")
        if runner is None:
            from repro_torch.measure.runner import MeasureRunner
            runner = MeasureRunner(**runner_kwargs)
        elif runner_kwargs:
            raise TypeError("pass either runner= or runner kwargs, not both")
        return InProcessTransport(runner, db)
    if name == "pool":
        if runner is not None:
            raise TypeError("transport='pool' builds one runner per worker "
                            "from runner kwargs; runner= cannot be shared "
                            "across processes")
        return WorkerPoolTransport(
            workers=workers if workers is not None else 2,
            db=db, runner_kwargs=runner_kwargs)
    if name == "socket":
        if not hosts:
            raise ValueError("transport='socket' needs hosts=['host:port', "
                             "...] naming the serve-worker daemons")
        if workers is not None:
            raise ValueError("workers= applies only to transport='pool' "
                             "(each serve-worker host sets its own pool "
                             "size)")
        if runner is not None or runner_kwargs:
            raise TypeError("transport='socket' measures on the "
                            "serve-worker hosts — runner configuration "
                            "(runner=, reps=, device=, ...) belongs "
                            "there, not on the client")
        from repro_torch.fleet.transport import SocketTransport
        return SocketTransport(hosts, db=db)
    raise ValueError(f"unknown transport {name!r}; "
                     f"registered: {', '.join(TRANSPORT_NAMES)}")


def make_measured_env(cfg=None, db_path: Optional[str] = None, runner=None,
                      seed: int = 0, transport="inproc",
                      workers: Optional[int] = None, hosts=None,
                      legality: str = "h100",
                      prune_topk: Optional[int] = None, surrogate=None,
                      surrogate_device=None, **runner_kwargs):
    """A :class:`~repro_torch.core.env.MeasuredEnv` wired to a measurement
    stack.

    ``transport`` names it (``"inproc"`` or ``None``, ``"pool"`` with
    ``workers=N``, ``"socket"`` with ``hosts=[...]``) or is a pre-built
    :class:`~repro_torch.core.protocols.MeasureTransport`, which carries
    its own runner and DB; ``db_path`` enables the persistent timing DB (a
    second run against the same path times nothing; ``fleet://host:port``
    attaches the shared store); ``legality`` is the env's (under
    ``"h100"`` no tile the kernels cannot launch is sent to the runner);
    extra kwargs build the :class:`MeasureRunner` (``reps=``, ``warmup=``,
    ``device=``), one per worker under the pool.  The hook is
    ``env.measure_fn`` (``.transport``, ``.db``; ``.runner`` in
    process).

    ``prune_topk=N`` enables surrogate grid pruning: only each site's
    top-N predicted candidates, legal under ``legality``, and its baseline
    tile are timed.  ``surrogate`` is a trained
    :class:`~repro_torch.surrogate.model.SurrogateModel`, a checkpoint
    directory, or ``None`` to train one from the attached DB's records
    (a DB too cold to train leaves pruning inactive for this run).  A
    loaded or trained surrogate lives on ``surrogate_device`` (by default
    the runner's ``device=``, else the card)."""
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.env import MeasuredEnv

    if transport is None or isinstance(transport, str):
        t = make_transport(transport or "inproc", db_path=db_path,
                           runner=runner, workers=workers, hosts=hosts,
                           **runner_kwargs)
    else:
        if db_path is not None or runner is not None or workers is not None \
                or hosts is not None or runner_kwargs:
            raise TypeError("a pre-built transport carries its own "
                            "runner/db/workers/hosts: drop the extra "
                            "arguments")
        t = transport
    fn = (CachedMeasureFn(t) if isinstance(t, InProcessTransport)
          else TransportMeasureFn(t))
    if prune_topk is not None:
        surrogate = resolve_surrogate(
            surrogate, db=getattr(t, "db", None),
            device=surrogate_device or runner_kwargs.get("device", "cuda"))
    return MeasuredEnv(cfg if cfg is not None else DEFAULT, measure_fn=fn,
                       seed=seed, legality=legality, prune_topk=prune_topk,
                       surrogate=surrogate)


def resolve_surrogate(surrogate, db=None, device="cuda"):
    """The facade's and serve's ``surrogate=`` argument as a model: a
    trained model passes through, a string loads that checkpoint
    directory onto ``device``, and ``None`` trains one on ``device`` from
    ``db`` (``None`` again when the DB is too cold: pruning stays
    inactive)."""
    if surrogate is None:
        from repro_torch.surrogate.model import train_from_db
        return train_from_db(db, device=device)
    if isinstance(surrogate, str):
        from repro_torch.surrogate.model import load_surrogate
        return load_surrogate(surrogate, device=device)
    return surrogate
