"""Dependency-free live scrape endpoint for the telemetry exporter.

A stdlib ``http.server`` on a background daemon thread with two routes:

* ``GET /metrics`` — the Prometheus text exposition, rendered at scrape
  time from a ``collect`` callable (returning a list of
  :class:`repro_torch.runtime.metrics.Metric` families or finished
  text); a collector exception answers 500.
* ``GET /healthz`` — ``ok`` liveness probe.

The collector runs on the scrape thread while the run appends journal
rows on the main thread; column reads are copies, so a scrape may see
interval N-1 while N lands. ``repro_torch.launch.serve`` wires it in
with ``--metrics-port`` (0 picks an ephemeral port, printed at start).
"""
from __future__ import annotations

import http.server
import threading

from repro_torch.runtime import metrics as metrics_mod

__all__ = ["MetricsServer"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(http.server.BaseHTTPRequestHandler):
    # the server instance injects `collect` via the class-per-server
    # subclass created in MetricsServer.start()
    collect = None

    def _send(self, status: int, body: str,
              ctype: str = CONTENT_TYPE) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            try:
                out = type(self).collect()
                body = out if isinstance(out, str) else \
                    metrics_mod.render(out)
            except Exception as e:  # surface collector bugs to the scraper
                self._send(500, f"collector error: {e}\n",
                           "text/plain; charset=utf-8")
                return
            self._send(200, body)
        elif path == "/healthz":
            self._send(200, "ok\n", "text/plain; charset=utf-8")
        else:
            self._send(404, "not found\n", "text/plain; charset=utf-8")

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """Background-thread scrape server over a live collector.

    ``collect`` is called per scrape — pass a closure over the live
    controller/recorder (e.g. ``lambda: collect_serving(mgr) +
    collect_telemetry(rec)``) so every scrape sees current counters.

    Usable as a context manager; ``start()`` returns ``(host, port)``
    with the ephemeral port resolved.
    """

    def __init__(self, collect, host: str = "127.0.0.1", port: int = 0):
        self._collect = collect
        self._host = host
        self._port = port
        self._server = None
        self._thread = None

    def start(self) -> tuple[str, int]:
        if self._server is not None:
            raise RuntimeError("server already started")
        handler = type("_BoundHandler", (_Handler,),
                       {"collect": staticmethod(self._collect)})
        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._port), handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="etica-metrics",
            daemon=True)
        self._thread.start()
        return self.address

    @property
    def address(self) -> tuple[str, int]:
        if self._server is None:
            raise RuntimeError("server not started")
        host, port = self._server.server_address[:2]
        return host, port

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}/metrics"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=5)
            self._server = None
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
