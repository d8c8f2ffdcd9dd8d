"""Shared wall-clock timing primitives: ONE median-of-reps loop (the port
of ``repro/measure/timing.py``).

Every timing consumer of the port (the :class:`MeasureRunner`) routes
through these two helpers, so the methodology (warmup to exclude build and
cache effects, a device synchronise after each call where the reference
calls ``block_until_ready``, the median over repetitions) is defined
once.  Host clock around each call and its synchronise: on the card that
includes the launch, as the reference's ``block_until_ready`` does.

On a card (``device=`` a CUDA device) the warmup and the timed
repetitions run under the card's lock (:mod:`repro_torch.measure.lock`):
one timed call per card at a time across every process of the host, so
a pool worker's time never takes in another worker's kernels.  The
caller's own queued work (its inputs) is finished before the lock is
taken, and whatever the caller does before and after (building inputs,
answering its parent) overlaps other processes' timings.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.measure import lock

_UUIDS: dict = {}


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


def _block(x) -> None:
    """Wait for every CUDA device that holds a tensor of the result; a
    no-op for CPU tensors and host values."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


def card_lock(device=None):
    """The lock of the card ``device`` names (see
    :mod:`repro_torch.measure.lock`), entered after the card has finished
    this process's queued work; a no-op context for ``None`` or a
    non-CUDA device."""
    if device is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = _UUIDS.get(idx)
    if uuid is None:
        uuid = _UUIDS[idx] = str(torch.cuda.get_device_properties(idx).uuid)
    torch.cuda.synchronize(idx)
    return lock.exclusive(lock.lock_path(uuid))


def median_time(fn: Callable[[], object], *, reps: int = 5,
                warmup: int = 1, device=None) -> float:
    """Median wall-clock seconds per call of ``fn()``, after ``warmup``
    discarded calls; each timed call waits for its result.  ``reps`` must
    be >= 1.  ``device``: the card the calls run on, whose lock the
    warmup and the repetitions hold (``None``: no lock)."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    ts = np.empty(reps, np.float64)
    with card_lock(device):
        for _ in range(warmup):
            _block(fn())
        for i in range(reps):
            t0 = time.perf_counter()
            _block(fn())
            ts[i] = time.perf_counter() - t0
    return float(np.median(ts))


def interleaved_medians(fn_a: Callable[[], object],
                        fn_b: Callable[[], object], *,
                        reps: int = 5, device=None) -> Tuple[float, float]:
    """Median seconds per call of two functions, interleaved A/B/A/B, so
    that slow drift in background load cancels.  Callers warm both.
    ``device`` as for :func:`median_time`."""
    ta, tb = np.empty(reps, np.float64), np.empty(reps, np.float64)
    with card_lock(device):
        for i in range(reps):
            t0 = time.perf_counter()
            _block(fn_a())
            ta[i] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _block(fn_b())
            tb[i] = time.perf_counter() - t0
    return float(np.median(ta)), float(np.median(tb))
