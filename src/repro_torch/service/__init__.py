"""``repro_torch.service`` — service-oriented autotuning (the port of
``repro/service``).

:class:`TuningService` owns one shared
:class:`~repro_torch.core.protocols.MeasureTransport` (in-process, a
subprocess worker pool, or a socket fleet) and hands out
:class:`SessionHandle` sessions — each an agent + oracle pair with async
tuning (``tune_async`` → ``Future[TileProgram]``) and per-session
statistics; with ``serving=`` every tune goes through the batch server of
:mod:`repro_torch.serving`.  See :mod:`repro_torch.service.service`.
"""
from __future__ import annotations

from repro_torch.service.service import (SessionHandle, TuningService,
                                         open_session)

__all__ = ["TuningService", "SessionHandle", "open_session"]
