"""Live stats endpoint: stdlib HTTP server exposing /metrics + /healthz.

``serve_metrics(port)`` starts a daemon ``ThreadingHTTPServer``:

* ``GET /metrics``  -> Prometheus text exposition of the global registry
  (``text/plain; version=0.0.4``) — point a Prometheus scraper or plain
  ``curl`` at it.
* ``GET /healthz``  -> JSON health document.  Callers register named
  health providers (``add_health_provider("predictor", pred.health)``);
  the endpoint runs them at request time and returns 200 only if every
  provider ran AND reported itself healthy — a provider that raises gets
  status "error", one whose dict says ``"ok": False`` (a runtime with no
  active version, a crashed batcher worker) gets status "degraded"; both
  answer 503 so a load balancer pulls the replica without the document
  losing the detail of WHAT degraded.

Everything runs on daemon threads so a serving process exits normally;
``MetricsServer.close()`` shuts the listener down deterministically (the
selftest binds port 0, scrapes itself, then closes).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import REGISTRY

_health_lock = threading.Lock()
_health_providers: dict[str, object] = {}


def add_health_provider(name: str, fn) -> None:
    """Register ``fn()`` (returning a JSON-able dict) under ``name`` in the
    /healthz document; re-registering a name replaces it."""
    with _health_lock:
        _health_providers[name] = fn


def remove_health_provider(name: str) -> None:
    with _health_lock:
        _health_providers.pop(name, None)


def health_document() -> tuple[dict, bool]:
    """(document, ok) — runs every registered provider.

    ``status``: "ok" / "degraded" (a provider's dict reports ``ok: False`` —
    the component answered, and what it said is bad) / "error" (a provider
    raised).  ``ok`` is True only for "ok" — the HTTP layer maps the other
    two to 503/500 so load balancers act on them.
    """
    with _health_lock:
        providers = dict(_health_providers)
    doc: dict = {"status": "ok", "components": {}}
    for name, fn in sorted(providers.items()):
        try:
            snap = fn()
            doc["components"][name] = snap
            if isinstance(snap, dict) and snap.get("ok") is False \
                    and doc["status"] == "ok":
                doc["status"] = "degraded"
        except Exception as e:  # a failing component degrades, not crashes
            doc["status"] = "error"
            doc["components"][name] = {"error": f"{type(e).__name__}: {e}"}
    return doc, doc["status"] == "ok"


class _Handler(BaseHTTPRequestHandler):
    # registry injected per-server via a subclass attribute
    registry = REGISTRY

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = self.registry.render().encode()
            self._send(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            doc, ok = health_document()
            code = 200 if ok else (503 if doc["status"] == "degraded"
                                   else 500)
            body = (json.dumps(doc, indent=2, default=str) + "\n").encode()
            self._send(code, body, "application/json")
        else:
            self._send(404, b"not found\n", "text/plain")

    def log_message(self, fmt, *args) -> None:
        pass  # scrapes every few seconds would spam the serving log


class MetricsServer:
    """A running /metrics + /healthz listener.  ``port`` is the BOUND port
    (pass 0 to let the OS pick — the selftest does)."""

    def __init__(self, port: int, host: str = "127.0.0.1", registry=None):
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry or REGISTRY})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def serve_metrics(port: int, host: str = "127.0.0.1") -> MetricsServer:
    """Start the endpoint on ``host:port`` (daemon threads; returns the
    server handle — keep it or let it run for the process lifetime)."""
    return MetricsServer(port, host)
