"""One-file stdlib Prometheus endpoint: serve ``render_prom()`` on
``GET /metrics`` so a scraper (or ``curl``) can watch a tuning run live
(the port of ``repro/obs/exporter.py``).

No dependencies — :class:`http.server.ThreadingHTTPServer` on a daemon
thread.  ``serve.py --metrics-port N`` owns one of these for the life of
the run; tests bind port 0 and read :attr:`MetricsServer.port` back.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry, get_registry

__all__ = ["MetricsServer"]

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # set by MetricsServer per-class

    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404, "try /metrics")
            return
        try:
            body = self.registry.render_prom().encode("utf-8")
        except Exception as e:  # never take the endpoint down with the scrape
            self.send_error(500, f"render failed: {type(e).__name__}")
            return
        self.send_response(200)
        self.send_header("Content-Type", _CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not stdout news
        pass


class MetricsServer:
    """Background HTTP server exposing a registry in Prometheus text format.

    >>> srv = MetricsServer(port=0)          # 0 = ephemeral, read .port
    >>> srv.start()
    >>> # curl http://localhost:{srv.port}/metrics
    >>> srv.close()
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else get_registry()
        # a per-instance handler subclass so two servers can expose two
        # different registries in one process (tests do exactly this)
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": self.registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
                name="obs-metrics-http", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
