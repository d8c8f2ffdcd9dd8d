"""Shared wall-clock timing primitives: ONE median-of-reps loop (the port
of ``repro/measure/timing.py``).

Every timing consumer of the port (the :class:`MeasureRunner`) routes
through these two helpers, so the methodology (warmup to exclude build and
cache effects, a device synchronise after each call where the reference
calls ``block_until_ready``, the median over repetitions) is defined
once.  Host clock around each call and its synchronise: on the card that
includes the launch, as the reference's ``block_until_ready`` does.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple

import numpy as np
import torch


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


def median_time(fn: Callable[[], object], *, reps: int = 5,
                warmup: int = 1) -> float:
    """Median wall-clock seconds per call of ``fn()``, after ``warmup``
    discarded calls; each timed call waits for its result.  ``reps`` must
    be >= 1."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    for _ in range(warmup):
        _block(fn())
    ts = np.empty(reps, np.float64)
    for i in range(reps):
        t0 = time.perf_counter()
        _block(fn())
        ts[i] = time.perf_counter() - t0
    return float(np.median(ts))


def interleaved_medians(fn_a: Callable[[], object],
                        fn_b: Callable[[], object], *,
                        reps: int = 5) -> Tuple[float, float]:
    """Median seconds per call of two functions, interleaved A/B/A/B, so
    that slow drift in background load cancels.  Callers warm both."""
    ta, tb = np.empty(reps, np.float64), np.empty(reps, np.float64)
    for i in range(reps):
        t0 = time.perf_counter()
        _block(fn_a())
        ta[i] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _block(fn_b())
        tb[i] = time.perf_counter() - t0
    return float(np.median(ta)), float(np.median(tb))
