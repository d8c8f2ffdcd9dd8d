"""``fleet serve-worker``: a measurement host daemon (the port of
``repro/fleet/worker_server.py``, speaking its protocol).

Wraps a *local* transport (``InProcessTransport`` or
``WorkerPoolTransport``) and serves its measurements over TCP in the
:mod:`repro_torch.measure.wire` framing.  Per connection:

    client →  ``{"type": "hello", "role": "measure", "proto": 1}``
    server →  ``{"type": "welcome", "backend": ..., "slots": N, ...}``
    client →  ``{"type": "job", "id": n, "key": k,
                 "site": {...}, "tiles": [a, b, c]}``
    server →  ``{"type": "result", "id": n, "v": seconds | null}``
    client →  ``{"type": "bye"}`` or EOF: the connection closes

``welcome.backend`` is the host's measurement fingerprint (the client
rejects a host whose fingerprint disagrees with the fleet's);
``welcome.slots`` its local parallelism (pool size, 1 in process): the
client keeps at most that many jobs in flight on the connection, and
results stream back in completion order through future callbacks.

Jobs are idempotent by ``key``: every finished measurement lands in a
bounded completed-results cache, so a job re-sent after a lost connection
is answered from it instead of being timed again.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.fleet.rpc import PROTO_VERSION, FrameServer, SocketStream

#: completed-results cache bound: any tuning run's key set, and a flat
#: footprint for a long-lived daemon
DONE_CACHE_MAX = 65536


def _site(d: dict):
    from repro_torch.models.site import KernelSite
    return KernelSite(**d)


def _wire_value(v) -> "float | None":
    v = float(v)
    return None if not math.isfinite(v) else v


class MeasureServer(FrameServer):
    """Serve a local :class:`MeasureTransport` to remote fleet clients.

    Borrows ``transport`` (its owner closes it).  Duplicate keys across
    clients coalesce inside the inner transport as for local callers."""

    def __init__(self, transport, host: str = "127.0.0.1", port: int = 0,
                 slots: "int | None" = None):
        super().__init__(host=host, port=port)
        self.transport = transport
        self.slots = int(slots if slots is not None
                         else max(1, getattr(transport, "workers", 1)))
        self._done_lock = threading.Lock()
        self._done: "OrderedDict[str, float]" = OrderedDict()

    # -- idempotency cache ------------------------------------------------
    def _done_get(self, key):
        if not key:
            return None
        with self._done_lock:
            return self._done.get(key)

    def _done_put(self, key, v: float) -> None:
        if not key:
            return
        with self._done_lock:
            self._done[key] = float(v)
            self._done.move_to_end(key)
            while len(self._done) > DONE_CACHE_MAX:
                self._done.popitem(last=False)

    # -- per-connection protocol ------------------------------------------
    def handle(self, stream: SocketStream) -> None:
        hello = stream.read()
        if not isinstance(hello, dict) or hello.get("type") != "hello":
            return
        if hello.get("proto", PROTO_VERSION) != PROTO_VERSION:
            stream.write({"type": "error",
                          "error": f"unsupported proto {hello.get('proto')}"})
            return
        wlock = threading.Lock()
        with wlock:
            stream.write({"type": "welcome", "role": "measure",
                          "proto": PROTO_VERSION,
                          "backend": self.transport.backend_key,
                          "slots": self.slots})
        while True:
            msg = stream.read()
            if msg is None or msg.get("type") == "bye":
                return
            kind = msg.get("type")
            if kind == "job":
                self._handle_job(stream, wlock, msg)
            elif kind == "ping":
                self._send(stream, wlock,
                           {"type": "pong",
                            "health": self.transport.health()})
            # unknown frame types are ignored: forward compatibility

    def _handle_job(self, stream, wlock, msg) -> None:
        jid, key = msg.get("id"), msg.get("key")
        cached = self._done_get(key)
        if cached is not None:
            self._send(stream, wlock,
                       {"type": "result", "id": jid,
                        "v": _wire_value(cached), "cached": True})
            return
        try:
            site = _site(msg["site"])
            [fut] = self.transport.submit([site], np.asarray([msg["tiles"]]))
        except Exception:
            # a malformed site, or the transport closed under us: fail the
            # job closed; the client reads inf or retries elsewhere
            self._send(stream, wlock,
                       {"type": "result", "id": jid, "v": None})
            return
        fut.add_done_callback(
            lambda f, jid=jid, key=key: self._reply(stream, wlock, jid,
                                                    key, f))

    def _reply(self, stream, wlock, jid, key, fut) -> None:
        v = fut.result()                # transports never raise here
        self._done_put(key, v)
        self._send(stream, wlock,
                   {"type": "result", "id": jid, "v": _wire_value(v)})

    @staticmethod
    def _send(stream, wlock, msg) -> None:
        try:
            with wlock:
                stream.write(msg)
        except (OSError, ValueError):
            pass                        # client gone; it reconnects
