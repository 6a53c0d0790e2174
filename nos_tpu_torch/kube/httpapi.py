"""HTTP facade over the in-process API server + a remote client (a copy
of ``nos_tpu/kube/httpapi.py``): the same endpoints and JSON bodies, so
the port's ``RemoteApiServer`` reads the reference's ``ApiHttpServer``
and the other way round. One difference: a watch stream skips events of
kinds the port does not carry (``serial.KINDS``), since a control
plane's server streams every kind and the port's trainer watches only
its node.

Endpoints (JSON bodies):
  GET  /healthz, /readyz            liveness/readiness
  GET  /metrics                     Prometheus text exposition
  POST /apis                        create(obj)
  GET  /apis/{kind}/{ns}/{name}     get ("_" = cluster-scoped)
  POST /list                        {kind, namespace?, label_selector?, index?}
  POST /update                      {obj, check_version}
  POST /delete                      {kind, name, namespace}
  POST /subscribe                   {kinds?} -> {id}
  POST /unsubscribe                 {id}
  GET  /events/{id}?timeout=S       long-poll watch events
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from nos_tpu_torch.kube import serial
from nos_tpu_torch.kube.apiserver import (
    AdmissionDenied,
    AlreadyExists,
    ApiError,
    ApiServer,
    Conflict,
    NotFound,
    Subscription,
    WatchEvent,
)
from nos_tpu_torch.utils.metrics import default_registry

_ERROR_STATUS = {
    "NotFound": 404,
    "AlreadyExists": 409,
    "Conflict": 409,
    "AdmissionDenied": 403,
}
_ERROR_CLASS = {
    "NotFound": NotFound,
    "AlreadyExists": AlreadyExists,
    "Conflict": Conflict,
    "AdmissionDenied": AdmissionDenied,
}


def _event_wire(ev: WatchEvent) -> dict:
    return {
        "type": ev.type,
        "kind": ev.kind,
        "obj": serial.to_wire(ev.obj),
        "old": serial.to_wire(ev.old) if ev.old is not None else None,
    }


def _event_unwire(d: dict) -> WatchEvent:
    return WatchEvent(
        type=d["type"],
        kind=d["kind"],
        obj=serial.from_wire(d["obj"]),
        old=serial.from_wire(d["old"]) if d.get("old") else None,
    )


class ApiHttpServer:
    """Serves an ApiServer over HTTP. One per deployment (the stand-in for
    the kube-apiserver the reference's binaries all point at)."""

    def __init__(self, server: ApiServer, host: str = "127.0.0.1", port: int = 0):
        self.api = server
        self._subs: Dict[str, Subscription] = {}
        self._subs_lock = threading.Lock()
        self._next_sub = 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, status: int, text: str,
                           ctype: str = "text/plain; version=0.0.4") -> None:
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def _error(self, e: Exception) -> None:
                name = type(e).__name__
                self._send(_ERROR_STATUS.get(name, 400),
                           {"error": name, "message": str(e)})

            def do_GET(self):
                try:
                    outer._handle_get(self)
                except ApiError as e:
                    self._error(e)
                except Exception as e:  # noqa: BLE001 — surface as 500
                    self._send(500, {"error": "Internal", "message": str(e)})

            def do_POST(self):
                try:
                    outer._handle_post(self)
                except ApiError as e:
                    self._error(e)
                except (ValueError, TypeError) as e:
                    self._error(e)
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": "Internal", "message": str(e)})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiHttpServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="apiserver-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)

    # -- request handling ----------------------------------------------
    def _handle_get(self, h) -> None:
        parsed = urlparse(h.path)
        parts = [p for p in parsed.path.split("/") if p]
        if parsed.path in ("/healthz", "/readyz"):
            h._send_text(200, "ok")
            return
        if parsed.path == "/metrics":
            h._send_text(200, default_registry().expose())
            return
        if len(parts) == 4 and parts[0] == "apis":
            kind, ns, name = parts[1], parts[2], parts[3]
            obj = self.api.get(kind, name, "" if ns == "_" else ns)
            h._send(200, serial.to_wire(obj))
            return
        if len(parts) == 2 and parts[0] == "events":
            sub = self._get_sub(parts[1])
            q = parse_qs(parsed.query)
            timeout = float(q.get("timeout", ["0"])[0])
            deadline = time.monotonic() + timeout
            events: List[dict] = []
            while True:
                ev = sub.pop()
                while ev is not None:
                    events.append(_event_wire(ev))
                    ev = sub.pop()
                if events or time.monotonic() >= deadline:
                    break
                time.sleep(0.02)
            h._send(200, {"events": events})
            return
        h._send(404, {"error": "NotFound", "message": h.path})

    def _handle_post(self, h) -> None:
        path = urlparse(h.path).path
        body = h._body()
        if path == "/apis":
            obj = self.api.create(serial.from_wire(body))
            h._send(201, serial.to_wire(obj))
        elif path == "/list":
            index = body.get("index")
            items = self.api.list(
                body["kind"],
                body.get("namespace"),
                body.get("label_selector"),
                tuple(index) if index else None,
            )
            h._send(200, {"items": [serial.to_wire(o) for o in items]})
        elif path == "/update":
            obj = self.api.update(
                serial.from_wire(body["obj"]),
                check_version=body.get("check_version", True),
            )
            h._send(200, serial.to_wire(obj))
        elif path == "/delete":
            self.api.delete(body["kind"], body["name"], body.get("namespace", ""))
            h._send(200, {})
        elif path == "/subscribe":
            sub = self.api.subscribe(body.get("kinds"))
            with self._subs_lock:
                self._next_sub += 1
                sid = str(self._next_sub)
                self._subs[sid] = sub
            h._send(200, {"id": sid})
        elif path == "/unsubscribe":
            with self._subs_lock:
                sub = self._subs.pop(body["id"], None)
            if sub is not None:
                self.api.unsubscribe(sub)
            h._send(200, {})
        else:
            h._send(404, {"error": "NotFound", "message": path})

    def _get_sub(self, sid: str) -> Subscription:
        with self._subs_lock:
            sub = self._subs.get(sid)
        if sub is None:
            raise NotFound(f"subscription {sid}")
        return sub


class RemoteSubscription:
    """Client-side watch stream; buffers events fetched over HTTP."""

    def __init__(self, remote: "RemoteApiServer", sub_id: str):
        self.remote = remote
        self.id = sub_id
        self._buffer: List[WatchEvent] = []

    def pop(self) -> Optional[WatchEvent]:
        if not self._buffer:
            self._fetch(timeout=0.0)
        return self._buffer.pop(0) if self._buffer else None

    def wait(self, timeout: float) -> bool:
        """Block up to ``timeout`` for at least one event (long-poll)."""
        if self._buffer:
            return True
        self._fetch(timeout=timeout)
        return bool(self._buffer)

    def _fetch(self, timeout: float) -> None:
        data = self.remote._get_json(f"/events/{self.id}?timeout={timeout}")
        self._buffer.extend(_event_unwire(d) for d in data["events"]
                            if d["kind"] in serial.KINDS)


class RemoteApiServer:
    """ApiServer-compatible client speaking to an ApiHttpServer.

    patch() is optimistic-concurrency client-side (get -> mutate -> update,
    retry on Conflict) — the same semantics controller-runtime gives the
    reference's controllers."""

    PATCH_RETRIES = 16

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base = base_url.rstrip("/")
        self.timeout_s = timeout_s

    # -- http plumbing --------------------------------------------------
    def _request(self, method: str, path: str, payload: Optional[dict] = None) -> dict:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read() or b"{}")
            except json.JSONDecodeError:
                err = {}
            cls = _ERROR_CLASS.get(err.get("error", ""), ApiError)
            raise cls(err.get("message", str(e))) from None

    def _get_json(self, path: str) -> dict:
        return self._request("GET", path)

    def _post(self, path: str, payload: dict) -> dict:
        return self._request("POST", path, payload)

    # -- ApiServer surface ----------------------------------------------
    def create(self, obj):
        return serial.from_wire(self._post("/apis", serial.to_wire(obj)))

    def get(self, kind: str, name: str, namespace: str = ""):
        ns = namespace or "_"
        return serial.from_wire(self._get_json(f"/apis/{kind}/{ns}/{name}"))

    def try_get(self, kind: str, name: str, namespace: str = ""):
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        index: Optional[Tuple[str, str]] = None,
    ) -> List[object]:
        data = self._post("/list", {
            "kind": kind,
            "namespace": namespace,
            "label_selector": label_selector,
            "index": list(index) if index else None,
        })
        return [serial.from_wire(d) for d in data["items"]]

    def update(self, obj, *, check_version: bool = True):
        return serial.from_wire(self._post("/update", {
            "obj": serial.to_wire(obj), "check_version": check_version,
        }))

    def patch(self, kind: str, name: str, namespace: str,
              mutate: Callable[[object], None]):
        last: Optional[Exception] = None
        for _ in range(self.PATCH_RETRIES):
            obj = self.get(kind, name, namespace)
            mutate(obj)
            try:
                return self.update(obj, check_version=True)
            except Conflict as e:
                last = e
        raise last or Conflict(f"patch {kind}/{namespace}/{name}")

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._post("/delete", {"kind": kind, "name": name, "namespace": namespace})

    def subscribe(self, kinds: Optional[List[str]] = None) -> RemoteSubscription:
        data = self._post("/subscribe", {"kinds": kinds})
        return RemoteSubscription(self, data["id"])

    def unsubscribe(self, sub: RemoteSubscription) -> None:
        self._post("/unsubscribe", {"id": sub.id})

    # -- health ----------------------------------------------------------
    def healthz(self) -> bool:
        try:
            with urllib.request.urlopen(
                self.base + "/healthz", timeout=self.timeout_s
            ) as resp:
                return resp.status == 200
        except Exception:  # noqa: BLE001 — any failure means unhealthy
            return False
