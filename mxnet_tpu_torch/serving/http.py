"""Minimal HTTP/JSON front end over a ModelServer (counterpart of
``mxnet_tpu/serving/http.py``).

Endpoints (the JAX package's paths and JSON keys)::

    POST /v1/models/<name>:predict   {"data": [[...], ...],
                                      "priority": "interactive"|"batch",
                                      "deadline_ms": <F>}
                                     (priority and deadline_ms optional)
                                     -> {"model":..., "outputs": [[...]],
                                     "model_version":..., "request_id":...,
                                     "phases": {...}}
                                     ("model_version": the bus version
                                     the answering batch ran on, 0 until
                                     a live weight update lands;
                                     "cache_hit": true when the answer
                                     came from the prediction cache; the
                                     request id is the caller's
                                     X-Request-Id header or one minted
                                     here, echoed back as a header and
                                     propagated to the batcher; "phases"
                                     is the traced queue_wait /
                                     batch_collect / h2d / compute /
                                     respond split and total_ms, with
                                     tracing on)
    GET  /v1/models                  -> {"models": [...], "detail": {...}}
    GET  /v1/stats                   -> ModelServer.stats()
    GET  /metrics                    -> Prometheus text (telemetry.export)
    GET  /metrics.json               -> the same metrics as JSON
    GET  /healthz                    -> {"status": "ok"|"draining"}

Errors become the status codes a load balancer expects: unknown model
404, admission fast-reject 429 (with Retry-After), draining 503, request
deadline 504 (the client-wait RequestTimeout, and a DeadlineExceeded
drop with ``"dropped": true`` since no compute ran), bad body 400, failed
batch 500. Each request is one bounded ``server.submit`` and ``result``;
the handler threads (ThreadingHTTPServer) never wait unbounded.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from ..telemetry import export as _export
from ..telemetry import trace as _trace
from .errors import (DeadlineExceeded, ModelNotFound, RequestError,
                     RequestTimeout, ServerBusyError, ServerDrainingError)

__all__ = ["HttpFrontEnd"]

_PREDICT_RE = re.compile(r"^/(?:v1/models|models|predict)/([^/:]+)"
                         r"(?::predict)?$")


class HttpFrontEnd:
    """Bind a ModelServer to a local HTTP port (``port=0`` picks one)."""

    def __init__(self, server, host="127.0.0.1", port=0, timeout=None):
        self._server = server
        self._timeout = timeout
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "mxtt-serving/0.1"
            # keep-alive clients otherwise meet the Nagle x delayed-ACK
            # stall on every request
            disable_nagle_algorithm = True

            def log_message(self, *args):  # stay quiet under load
                pass

            def _send(self, code, body, ctype, extra_headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, payload, extra_headers=()):
                self._send(code, json.dumps(payload).encode(),
                           "application/json", extra_headers)

            def do_GET(self):
                srv = front._server
                if self.path == "/healthz":
                    self._json(200, {"status": "draining" if srv.draining
                                     else "ok"})
                elif self.path in ("/v1/models", "/models"):
                    self._json(200, {"models": srv.models(),
                                     "detail": srv.model_info()})
                elif self.path in ("/v1/stats", "/stats"):
                    self._json(200, srv.stats())
                elif self.path == "/metrics":
                    self._send(200, _export.render_prometheus().encode(),
                               _export.PROMETHEUS_CONTENT_TYPE)
                elif self.path == "/metrics.json":
                    self._send(200, _export.render_json().encode(),
                               "application/json")
                else:
                    self._json(404, {"error": f"no route {self.path!r}"})

            def do_POST(self):
                srv = front._server
                m = _PREDICT_RE.match(self.path)
                if not m:
                    self._json(404, {"error": f"no route {self.path!r}"})
                    return
                name = m.group(1)
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    arr = _np.asarray(payload["data"])
                    priority = payload.get("priority", "interactive")
                    deadline_ms = payload.get("deadline_ms")
                    if deadline_ms is not None:
                        deadline_ms = float(deadline_ms)
                except (ValueError, KeyError, TypeError) as e:
                    self._json(400, {"error": f"bad request body: {e}"})
                    return
                # the caller's X-Request-Id, else a minted one: bound to
                # this thread, the batcher's trace picks it up
                rid = self.headers.get("X-Request-Id") \
                    or _trace.new_request_id()
                rid_hdr = [("X-Request-Id", rid)]
                try:
                    with _trace.context(rid):
                        fut = srv.submit(name, arr, priority=priority,
                                         deadline_ms=deadline_ms)
                    out = fut.result(front._timeout)
                except ModelNotFound as e:
                    self._json(404, {"error": str(e)},
                               extra_headers=rid_hdr)
                except ServerDrainingError as e:
                    self._json(503, {"error": str(e)},
                               extra_headers=rid_hdr
                               + [("Retry-After", "1")])
                except ServerBusyError as e:
                    self._json(429, {"error": str(e)},
                               extra_headers=rid_hdr
                               + [("Retry-After", "0.1")])
                except DeadlineExceeded as e:
                    # dropped before any compute: a retrying client knows
                    # no batch slot was spent on it
                    self._json(504, {"error": str(e), "dropped": True},
                               extra_headers=rid_hdr)
                except RequestTimeout as e:
                    self._json(504, {"error": str(e)},
                               extra_headers=rid_hdr)
                except (RequestError, ValueError) as e:
                    code = 400 if isinstance(e, ValueError) else 500
                    self._json(code, {"error": str(e)},
                               extra_headers=rid_hdr)
                else:
                    outs = out if isinstance(out, list) else [out]
                    body = {"model": name,
                            "outputs": [o.tolist() for o in outs],
                            "model_version": fut.model_version,
                            "request_id": fut.request_id or rid}
                    if fut.cache_hit:
                        body["cache_hit"] = True
                    bd = fut.breakdown()
                    if bd is not None:
                        body["phases"] = {
                            k: bd.get(f"{k}_ms")
                            for k in _trace.REQUEST_PHASES}
                        body["phases"]["total_ms"] = bd["total_ms"]
                    self._json(200, body, extra_headers=rid_hdr)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = None

    @property
    def host(self):
        return self._httpd.server_address[0]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1}, daemon=True,
                name="mxtt-serving-http")
            self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
