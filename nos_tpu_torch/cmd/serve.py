"""Shared daemon plumbing of the port's binaries (port of
``nos_tpu/cmd/serve.py``'s ``HealthServer`` and ``metrics_payload``).

``HealthServer`` serves /healthz, /readyz, /metrics and the tracing
flight recorder at /debug/traces for a binary with no HTTP surface of
its own: the trainer's ``metrics_port``. The serving binary
(``cmd/server.py``) has its own handler and shares ``metrics_payload``
with it, so the two expose alike. Nothing here imports torch.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from nos_tpu_torch.obs import tracing
from nos_tpu_torch.utils.metrics import default_registry

OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def metrics_payload(accept: str = "") -> tuple:
    """(body, content_type) for a /metrics scrape, content-negotiated:
    an ``Accept`` header asking for ``application/openmetrics-text``
    gets the OpenMetrics dialect (histogram buckets carry trace
    exemplars); everything else gets the classic Prometheus text
    format."""
    if "application/openmetrics-text" in (accept or ""):
        return (default_registry().expose(openmetrics=True),
                OPENMETRICS_CONTENT_TYPE)
    return default_registry().expose(), "text/plain; version=0.0.4"


class HealthServer:
    """Serves /healthz and /readyz (ok while the process serves),
    /metrics (content-negotiated as ``metrics_payload``) and the tracing
    flight recorder at /debug/traces for one binary."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, status: int, text: str,
                      content_type: str = "text/plain; version=0.0.4") -> None:
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/healthz", "/readyz"):
                    self._send(200, "ok")
                elif self.path == "/metrics":
                    body, ctype = metrics_payload(
                        self.headers.get("Accept", ""))
                    self._send(200, body, ctype)
                elif self.path == "/debug/traces":
                    self._send(200, json.dumps(tracing.recorder().to_json()),
                               "application/json")
                elif self.path.startswith("/debug/traces/"):
                    tid = self.path.rsplit("/", 1)[1]
                    spans = tracing.recorder().trace(tid)
                    if not spans:
                        self._send(404, json.dumps({"error": "unknown trace",
                                                    "trace_id": tid}),
                                   "application/json")
                    else:
                        self._send(200, json.dumps({
                            "trace_id": tid,
                            "spans": [sp.to_dict() for sp in spans],
                        }), "application/json")
                else:
                    self._send(404, "not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "HealthServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="health-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
