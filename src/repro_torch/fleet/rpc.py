"""The fleet wire protocol's shared plumbing (the port of
``repro/fleet/rpc.py``).

Both fleet daemons (``serve-worker``, ``serve-artifacts``) and both client
halves (:class:`~repro_torch.fleet.transport.SocketTransport`, the remote
stores of :mod:`repro_torch.fleet.artifacts`) speak the length-prefixed
JSON framing of the worker-pool pipe protocol
(:mod:`repro_torch.measure.wire`) over TCP, byte for byte as the
reference's do, so a port client talks to a reference daemon and the other
way round.  Here: address parsing (with the ``fleet://host:port`` scheme
that lets a store *path* name a remote service), buffered socket streams
and the threaded accept loop every daemon runs.
"""
from __future__ import annotations

import socket
import struct
import threading

from repro_torch.measure.wire import read_frame, write_frame

#: Protocol version in every hello/welcome frame: a server refuses a hello
#: whose ``proto`` it does not speak, so a mixed fleet fails at handshake.
PROTO_VERSION = 1

#: URL scheme marking a store path as remote ("fleet://host:port").
FLEET_SCHEME = "fleet://"


def parse_address(address) -> "tuple[str, int]":
    """``"host:port"`` / ``"fleet://host:port"`` / ``(host, port)`` →
    ``(host, port)``."""
    if isinstance(address, (tuple, list)):
        host, port = address
        return str(host), int(port)
    addr = str(address)
    if addr.startswith(FLEET_SCHEME):
        addr = addr[len(FLEET_SCHEME):]
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"fleet address {address!r} is not host:port — e.g. "
            f"'127.0.0.1:7761' or 'fleet://gpu-host:7761'")
    return host, int(port)


def format_address(host: str, port: int) -> str:
    return f"{host}:{port}"


class SocketStream:
    """A connected TCP socket with buffered read and write file views.

    Owns the socket: ``close()`` tears down both files and the socket
    (idempotent; a ruined connection closes like a healthy one)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # frames are small request/response units: Nagle only adds latency
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.rfile = sock.makefile("rb")
        self.wfile = sock.makefile("wb")

    def read(self) -> "dict | None":
        return read_frame(self.rfile)

    def write(self, msg: dict) -> None:
        write_frame(self.wfile, msg)

    def settimeout(self, timeout) -> None:
        self.sock.settimeout(timeout)

    def close(self) -> None:
        # wake a thread blocked in read() before touching the files: a
        # buffered file's lock is held by a reader parked in recv(), and a
        # cross-thread close would deadlock on it; shutdown() returns that
        # recv EOF at once
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._close_parts()

    def kill(self) -> None:
        """Abort the connection without the FIN handshake (RST to the peer
        where the OS allows): the chaos seam for a killed host."""
        try:
            # SHUT_RD wakes a local reader without sending FIN: the peer
            # must see the RST of the lingering close below
            self.sock.shutdown(socket.SHUT_RD)
        except OSError:
            pass
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                 struct.pack("ii", 1, 0))
        except OSError:
            pass
        self._close_parts()

    def _close_parts(self) -> None:
        for part in (self.rfile, self.wfile, self.sock):
            try:
                part.close()
            except OSError:
                pass


def connect(address, timeout=None) -> SocketStream:
    host, port = parse_address(address)
    return SocketStream(socket.create_connection((host, port),
                                                 timeout=timeout))


class FrameServer:
    """Threaded TCP accept loop, one daemon thread per connection.

    Subclasses implement ``handle(stream)``, called on its own thread with
    a :class:`SocketStream`; the server tracks live streams so ``close()``
    (and the chaos seam ``drop_connections()``) can tear them down.
    ``port=0`` binds an ephemeral port; the bound address is ``.address``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._listener = socket.create_server((host, port))
        bound = self._listener.getsockname()
        self.host, self.port = bound[0], bound[1]
        self.address = format_address(self.host, self.port)
        self._lock = threading.Lock()
        self._streams: "set[SocketStream]" = set()
        self._threads: "list[threading.Thread]" = []
        self._accept_thread = None
        self._closing = False

    def start(self) -> "FrameServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"fleet-accept-{self.port}",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return                  # listener closed
            stream = SocketStream(sock)
            with self._lock:
                if self._closing:
                    stream.close()
                    return
                self._streams.add(stream)
                t = threading.Thread(target=self._run_handler,
                                     args=(stream,),
                                     name=f"fleet-conn-{self.port}",
                                     daemon=True)
                # started under the lock, so close() never joins a
                # thread it finds listed before it has started
                t.start()
                self._threads.append(t)

    def _run_handler(self, stream: SocketStream) -> None:
        try:
            self.handle(stream)
        except (OSError, EOFError, ValueError):
            pass                        # the peer vanished or ruined it
        finally:
            stream.close()
            with self._lock:
                self._streams.discard(stream)
            self.connection_closed(stream)

    def handle(self, stream: SocketStream) -> None:  # pragma: no cover
        raise NotImplementedError

    def connection_closed(self, stream: SocketStream) -> None:
        """Hook: a connection's handler has finished (any reason)."""

    def drop_connections(self) -> None:
        """Abort every live client connection (the listener stays up): the
        connection-reset chaos seam; clients must reconnect and retry."""
        with self._lock:
            streams = list(self._streams)
        for s in streams:
            s.kill()

    def close(self) -> None:
        """Stop accepting and tear down every connection.  Idempotent."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            streams = list(self._streams)
        try:
            # closing an fd does not wake a thread in accept() on it
            # (Linux); shutdown() does
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for s in streams:
            s.close()
        for t in list(self._threads):
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
