"""One timed call per card at a time: an exclusive ``fcntl.flock`` on a
file named by the card.

Without MPS, CUDA contexts of different processes time-slice one card, so
a measurement timed on the host clock while another process's kernels run
takes those kernels in.  Every timing of the port on a card
(:mod:`repro_torch.measure.timing`) therefore holds this lock around its
warmup and timed repetitions: pool workers, fleet ``serve-worker``
daemons and the in-process runner on one host all take the same file,
which :func:`lock_path` names by the card's UUID (not its index, which
``CUDA_VISIBLE_DEVICES`` renumbers), in ``tempfile.gettempdir()``.

The kernel releases an ``flock`` when the holding process dies, so a
worker killed mid-measurement (a ``job_timeout``, a crash) never leaves
the card locked; the file's existence means nothing.  Each acquisition
opens the file anew, so threads of one process exclude each other too.

This module imports no torch, so a process that only needs the lock
starts at once.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
import tempfile
import time
from collections import deque

SPANS_KEPT = 256


class LockStats:
    """What one process's timed calls did with the lock: acquisitions,
    seconds spent waiting for it and holding it, and the last
    ``SPANS_KEPT`` ``(enter, exit)`` times on ``time.monotonic()`` (one
    clock for every process of a host)."""

    def __init__(self):
        self.acquires = 0
        self.wait_s = 0.0
        self.held_s = 0.0
        self.spans: deque = deque(maxlen=SPANS_KEPT)

    def as_dict(self) -> dict:
        return {"acquires": self.acquires, "wait_s": self.wait_s,
                "held_s": self.held_s}


#: this process's counts (the timing helpers record into it)
stats = LockStats()


def lock_path(card_uuid: str) -> str:
    """The lock file of the card with this UUID."""
    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(card_uuid))
    return os.path.join(tempfile.gettempdir(), f"repro_torch-card-{safe}.lock")


@contextlib.contextmanager
def exclusive(path: str):
    """Hold an exclusive ``flock`` on ``path`` (created if missing) for the
    body, recorded in :data:`stats`; blocks while another holder has
    it."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        t0 = time.monotonic()
        fcntl.flock(fd, fcntl.LOCK_EX)
        t1 = time.monotonic()
        try:
            yield
        finally:
            t2 = time.monotonic()
            # still held: the lock serialises these updates across threads
            stats.acquires += 1
            stats.wait_s += t1 - t0
            stats.held_s += t2 - t1
            stats.spans.append((t1, t2))
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
