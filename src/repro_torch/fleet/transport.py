"""``SocketTransport``: ship ``(site, tiles)`` measurements to remote
``serve-worker`` hosts over TCP (the port of ``repro/fleet/transport.py``).

The cross-host half of the
:class:`~repro_torch.core.protocols.MeasureTransport` contract, with the
scheduling semantics of
:class:`~repro_torch.measure.pool.WorkerPoolTransport` (the two share its
job accounting): non-blocking ``submit``, DB hits resolved at once,
duplicate keys coalesced, failures closed to ``inf`` with quarantine once
the attempts are spent.  The "worker" under each dispatcher thread is a
whole remote host speaking :mod:`repro_torch.fleet.worker_server`'s
protocol.

Per host:

* **handshake**: hello/welcome; the first host's ``backend`` fingerprint
  becomes the fleet's, and a host whose fingerprint disagrees is rejected
  for good (mixed measurement conditions would poison the shared DB).  The
  dispatcher keeps at most ``welcome.slots`` jobs in flight on the
  connection.
* **reconnect with backoff**: a lost connection requeues its windowed jobs
  (each loss costs them one attempt) and reconnects on the
  :func:`~repro_torch.measure.pool.respawn_backoff` schedule; a host that
  refuses ``max_connect_failures`` connects in a row is given up.  Re-sent
  jobs are never timed twice: the server answers repeats from its
  completed-results cache.
* **health**: ``ok`` with every host connected, ``degraded`` while a host
  is down, backing off or rejected, ``down`` when closed or no dispatcher
  is left; then pending jobs fail closed so ``drain()`` never hangs.
"""
from __future__ import annotations

import threading
import time
from dataclasses import asdict
from typing import Optional, Sequence

from repro_torch.fleet import rpc
from repro_torch.fleet.rpc import PROTO_VERSION, format_address, parse_address
from repro_torch.measure.pool import _Job, _JobBook, respawn_backoff


class _BackendMismatch(RuntimeError):
    """A host's measurement fingerprint disagrees with the fleet's."""


class _HostLink:
    """Mutable per-host record (guarded by the transport's lock)."""

    __slots__ = ("index", "address", "name", "state", "failures",
                 "reconnects", "jobs_done", "error")

    def __init__(self, index: int, address):
        self.index = index
        host, port = parse_address(address)
        self.address = (host, port)
        self.name = format_address(host, port)
        self.state = "connecting"   # connecting|backing_off|connected|
        #                             rejected|gone|closed
        self.failures = 0           # consecutive failed connects
        self.reconnects = 0         # connections lost mid-serve
        self.jobs_done = 0
        self.error: Optional[str] = None


class SocketTransport(_JobBook):
    """Remote measurement fleet behind the MeasureTransport contract.

    Parameters
    ----------
    hosts:          ``serve-worker`` addresses (``"host:port"`` or
                    ``(host, port)``), one dispatcher thread each.
    db:             a :class:`~repro_torch.measure.db.MeasureDB` (or a
                    remote mirror), a path for one (``fleet://host:port``
                    names a ``serve-artifacts`` daemon), or ``None``.  The
                    client writes each key once, as the pool does.
    max_attempts:   tries per job before it fails closed to ``inf`` (a try
                    is spent each time a connection dies holding the job).
    connect_timeout: seconds per connect and handshake; also how long the
                    constructor waits for the first live host.
    job_timeout:    seconds a host may hold the *oldest* windowed job
                    before the connection is torn down as wedged and its
                    jobs requeued (``None``: unlimited).
    max_connect_failures: failed connects in a row before a host is given
                    up for the transport's lifetime.
    backoff_base / backoff_cap / backoff_seed:
                    the reconnect schedule; dispatcher ``i`` jitters from
                    ``backoff_seed + i``.
    """

    def __init__(self, hosts: Sequence, db=None, max_attempts: int = 3,
                 connect_timeout: float = 60.0,
                 job_timeout: Optional[float] = 900.0,
                 max_connect_failures: int = 5,
                 backoff_base: float = 0.1, backoff_cap: float = 30.0,
                 backoff_seed: int = 0):
        hosts = list(hosts)
        if not hosts:
            raise ValueError("hosts must name at least one serve-worker "
                             "address, e.g. ['127.0.0.1:7761']")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if max_connect_failures < 1:
            raise ValueError(f"max_connect_failures must be >= 1, got "
                             f"{max_connect_failures}")
        self.connect_timeout = connect_timeout
        self.job_timeout = job_timeout
        self.max_connect_failures = max_connect_failures
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_seed = backoff_seed
        self._sleep = time.sleep        # seam: a fake clock in tests
        self._init_book(db, max_attempts)
        self._links = [_HostLink(i, h) for i, h in enumerate(hosts)]
        self._live = len(self._links)   # dispatcher threads still running
        self._ready_hosts = 0           # links connected now
        self._backing_off = 0
        self._first_error: Optional[BaseException] = None
        self.reconnects = 0             # connections lost mid-serve

        self._threads = [
            threading.Thread(target=self._dispatch, args=(i,),
                             name=f"fleet-h{i}", daemon=True)
            for i in range(len(self._links))]
        for t in self._threads:
            t.start()
        # a fleet starts as soon as ONE host answers: a missing host is the
        # degraded-but-working case, an empty fleet an error
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._ready_hosts > 0 or self._live == 0,
                timeout=connect_timeout)
            dead = self._live == 0 and self._ready_hosts == 0
            err = self._first_error
            if dead or not ok:
                self._closing = True
                self._cv.notify_all()
        if dead:
            raise RuntimeError(
                "fleet failed to start: no serve-worker host reachable"
            ) from err
        if not ok:
            raise TimeoutError(
                f"fleet: no host completed the handshake within "
                f"{connect_timeout}s")

    # -- per-host dispatcher thread ---------------------------------------
    def _dispatch(self, index: int) -> None:
        link = self._links[index]
        try:
            while True:
                with self._cv:
                    if self._closing:
                        return
                try:
                    stream, slots = self._connect(link)
                except _BackendMismatch as e:
                    with self._cv:
                        link.state = "rejected"
                        link.error = str(e)
                        if self._first_error is None:
                            self._first_error = e
                        self._cv.notify_all()
                    return
                except (OSError, EOFError, ValueError, RuntimeError) as e:
                    with self._cv:
                        link.failures += 1
                        link.error = f"{type(e).__name__}: {e}"
                        if self._first_error is None:
                            self._first_error = e
                        give_up = link.failures >= self.max_connect_failures
                        link.state = "gone" if give_up else "backing_off"
                        if not give_up:
                            self._backing_off += 1
                        self._cv.notify_all()
                    if give_up:
                        return
                    try:
                        self._backoff_sleep(respawn_backoff(
                            link.failures, base=self.backoff_base,
                            cap=self.backoff_cap,
                            seed=self.backoff_seed + index))
                    finally:
                        with self._cv:
                            self._backing_off -= 1
                    continue
                with self._cv:
                    link.failures = 0
                    link.error = None
                    link.state = "connected"
                    self._ready_hosts += 1
                    self._cv.notify_all()
                try:
                    clean = self._serve(link, stream, slots)
                finally:
                    with self._cv:
                        self._ready_hosts -= 1
                        if link.state == "connected":
                            link.state = "connecting"
                if clean:
                    try:
                        stream.write({"type": "bye"})
                    except (OSError, ValueError):
                        pass
                    stream.close()
                    return
                stream.close()
        finally:
            with self._cv:
                if link.state not in ("rejected", "gone"):
                    link.state = "closed" if self._closing else "gone"
                self._live -= 1
                if self._live == 0:
                    self._fail_pending()    # fleet down, not a bad pair
                self._cv.notify_all()

    def _connect(self, link: _HostLink):
        stream = rpc.connect(link.address, timeout=self.connect_timeout)
        try:
            stream.settimeout(self.connect_timeout)
            stream.write({"type": "hello", "role": "measure",
                          "proto": PROTO_VERSION})
            welcome = stream.read()
            if not isinstance(welcome, dict) \
                    or welcome.get("type") != "welcome":
                raise RuntimeError(f"fleet handshake failed: {welcome!r}")
            backend = welcome.get("backend") or "unknown"
            with self._cv:
                if self._backend is None:
                    self._backend = backend     # the first host wins
                elif self._backend != backend:
                    raise _BackendMismatch(
                        f"host {link.name} backend {backend!r} != fleet "
                        f"backend {self._backend!r} — mixed measurement "
                        f"conditions would poison the DB")
            return stream, max(1, int(welcome.get("slots", 1)))
        except BaseException:
            stream.close()
            raise

    def _serve(self, link: _HostLink, stream, slots: int) -> bool:
        """Feed the connection a window of up to ``slots`` jobs, reading
        results as they complete.  ``True``: clean shutdown; ``False``:
        the connection was lost (its windowed jobs already requeued)."""
        window: "dict[int, _Job]" = {}
        next_id = 0
        while True:
            to_send = []
            with self._cv:
                if self._closing and not self._pending and not window:
                    return True
                while len(window) < slots and self._pending:
                    job = self._pending.popleft()
                    job.queue_wait_s += time.monotonic() - job.t_queued
                    job.t_start = time.monotonic()
                    next_id += 1
                    window[next_id] = job
                    to_send.append((next_id, job))
                if not to_send and not window:
                    self._cv.wait_for(lambda: self._pending or self._closing)
                    continue
            try:
                for jid, job in to_send:
                    stream.write({"type": "job", "id": jid, "key": job.key,
                                  "site": asdict(job.site),
                                  "tiles": job.tiles})
                if not window:
                    continue
                msg = self._read_result(stream, window)
                if msg is None:
                    raise EOFError("host closed the connection")
            except (OSError, EOFError, ValueError) as e:
                reason = "host wedged (job timeout)" \
                    if isinstance(e, TimeoutError) \
                    else f"connection lost ({type(e).__name__})"
                with self._cv:
                    link.reconnects += 1
                    self.reconnects += 1
                    for job in window.values():
                        self._requeue_or_fail(job, reason=reason)
                    self._cv.notify_all()
                return False
            if msg.get("type") != "result":
                continue                # pong, forward-compatible frames
            job = window.pop(msg.get("id"), None)
            if job is None:
                continue                # a stale id, already requeued
            v = float("inf") if msg.get("v") is None else float(msg["v"])
            with self._cv:
                link.jobs_done += 1
            self._resolve(job, v)

    def _read_result(self, stream, window: dict):
        """One frame, bounded by the oldest windowed job's deadline."""
        if self.job_timeout is not None:
            oldest = min(j.t_start for j in window.values())
            remaining = (oldest + self.job_timeout) - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("host did not answer before the "
                                   "deadline (wedged measurement?)")
            stream.settimeout(remaining)
        else:
            stream.settimeout(None)
        return stream.read()

    def _backoff_sleep(self, delay: float) -> None:
        """Sleep out a reconnect backoff in short slices, so ``close()`` is
        never stuck behind a long schedule."""
        deadline = time.monotonic() + delay
        while True:
            with self._cv:
                if self._closing:
                    return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._sleep(min(0.1, remaining))

    # -- health and counters ------------------------------------------------
    def _health_locked(self) -> str:
        """``ok``: every host connected; ``degraded``: a host down,
        backing off or rejected (the rest keep measuring); ``down``:
        closed, or no dispatcher left."""
        if self._closing or self._live == 0:
            return "down"
        if self._backing_off or self._ready_hosts < len(self._links):
            return "degraded"
        return "ok"

    def host_states(self) -> dict:
        """``{address: state}``, the per-host view obs labels on."""
        with self._cv:
            return {link.name: link.state for link in self._links}

    def stats(self) -> dict:
        """The transport counters and the fleet's (``hosts`` is the
        per-host breakdown obs labels come from)."""
        with self._cv:
            s = self._stats.snapshot(in_flight=len(self._inflight))
            s["health"] = self._health_locked()
            s["fleet_hosts_count"] = len(self._links)
            s["fleet_hosts_live"] = self._ready_hosts
            s["fleet_reconnects_total"] = self.reconnects
            s["fleet_queue_depth"] = len(self._pending)
            s["fleet_queue_wait_seconds_total"] = self.queue_wait_seconds
            s["fleet_run_seconds_total"] = self.run_seconds
            s["fleet_jobs_finished_total"] = self.jobs_finished
            s["hosts"] = {
                link.name: {"state": link.state, "jobs_done": link.jobs_done,
                            "reconnects": link.reconnects,
                            "connect_failures": link.failures}
                for link in self._links}
        s["fleet_quarantined_total"] = \
            getattr(self.db, "n_quarantined", 0) if self.db is not None else 0
        return s
