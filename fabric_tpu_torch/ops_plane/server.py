"""Ops HTTP server: /metrics, /healthz, /logspec, /version.

Counterpart of `fabric_tpu/ops_plane/server.py`.  Reference parity:
Fabric's core/operations/system.go:75-267 —
Prometheus exposition, health checks with per-checker status, runtime
log-level administration (the flogging /logspec admin), and a version
endpoint.  Plain http.server (stdlib): the ops surface is control-plane
only and stays off the data path.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .metrics import MetricsRegistry, registry as default_registry

VERSION = "fabric-tpu-torch/0.2"


class OperationsServer:
    """healthz checkers: name -> callable() (raise or return falsy = FAIL,
    mirroring the healthz.StatusOK / failed-checks JSON of system.go:203)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics or default_registry
        self._checkers: Dict[str, Callable] = {}
        # fleet lifecycle: a provider returning "serving" | "draining" |
        # "drained", surfaced in the /healthz body so rollout tooling
        # (chaos rolling_restart, node.top LIFECYCLE column) can watch a
        # drain complete without a separate endpoint.  A draining node
        # still answers 200 when its checkers pass — drain is an
        # ORDERLY state, not a failure.
        self.lifecycle_fn: Optional[Callable] = None
        # extra /healthz fields: key -> callable() -> json-able, e.g. a
        # peer's provider {"name", "backend", "degraded"}; a failing
        # callable leaves its key out, as lifecycle_fn's does
        self.health_fields: Dict[str, Callable] = {}
        # extension routes: (method, path-prefix) -> fn(path, body) ->
        # (code, json-able) — e.g. the orderer's channelparticipation REST
        self._routes: Dict[tuple, Callable] = {}
        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "text/plain; charset=utf-8"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, ops.metrics.expose_text().encode())
                elif self.path == "/healthz":
                    ok, failed = ops.run_checks()
                    out = {"status": "OK" if ok else "Service Unavailable",
                           "failed_checks": failed}
                    if ops.lifecycle_fn is not None:
                        try:
                            out["lifecycle"] = str(ops.lifecycle_fn())
                        except Exception:
                            pass
                    for key, fn in list(ops.health_fields.items()):
                        try:
                            out[key] = fn()
                        except Exception:
                            pass
                    body = json.dumps(out).encode()
                    self._send(200 if ok else 503, body, "application/json")
                elif self.path == "/version":
                    self._send(200, json.dumps({"version": VERSION}).encode(),
                               "application/json")
                elif self.path == "/logspec":
                    level = logging.getLevelName(
                        logging.getLogger().getEffectiveLevel())
                    self._send(200, json.dumps({"spec": level}).encode(),
                               "application/json")
                else:
                    self._route("GET") or self._send(404, b"not found")

            def _route(self, method: str) -> bool:
                for (m, prefix), fn in ops._routes.items():
                    if m == method and self.path.startswith(prefix):
                        try:
                            ln = int(self.headers.get("Content-Length", "0"))
                            body = self.rfile.read(ln) if ln else b""
                            code, out = fn(self.path, body)
                            if isinstance(out, str):
                                # routes may return plain text (folded
                                # profile stacks) instead of a jsonable
                                self._send(code, out.encode())
                            else:
                                self._send(code, json.dumps(out).encode(),
                                           "application/json")
                        except Exception as exc:
                            self._send(400, str(exc).encode())
                        return True
                return False

            def do_POST(self):
                self._route("POST") or self._send(404, b"not found")

            def do_DELETE(self):
                self._route("DELETE") or self._send(404, b"not found")

            def do_PUT(self):
                if self.path == "/logspec":
                    # runtime log-level admin (flogging/httpadmin parity)
                    try:
                        ln = int(self.headers.get("Content-Length", "0"))
                        spec = json.loads(self.rfile.read(ln))["spec"]
                        logging.getLogger().setLevel(spec.upper())
                        self._send(204, b"")
                    except Exception as exc:
                        self._send(400, str(exc).encode())
                else:
                    self._send(404, b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.addr = self._httpd.server_address
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def register_checker(self, name: str, check: Callable) -> None:
        self._checkers[name] = check

    def register_route(self, method: str, path_prefix: str,
                       fn: Callable) -> None:
        """fn(path, body_bytes) -> (status_code, json-able body)."""
        self._routes[(method.upper(), path_prefix)] = fn

    def run_checks(self):
        failed = []
        for name, check in self._checkers.items():
            try:
                result = check()
                if result is not None and not result:
                    failed.append({"component": name, "reason": "unhealthy"})
            except Exception as exc:
                failed.append({"component": name, "reason": str(exc)[:200]})
        return not failed, failed

    def start(self) -> "OperationsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
