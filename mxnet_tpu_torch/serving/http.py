"""Minimal HTTP/JSON front end over a ModelServer (counterpart of
``mxnet_tpu/serving/http.py``).

Endpoints (the JAX package's paths and JSON keys)::

    POST /v1/models/<name>:predict   {"data": [[...], ...],
                                      "priority": "interactive"|"batch",
                                      "deadline_ms": <F>}
                                     (priority and deadline_ms optional)
                                     -> {"model":..., "outputs": [[...]],
                                     "model_version":..., "request_id":...}
                                     ("model_version": the bus version
                                     the answering batch ran on, 0 until
                                     a live weight update lands;
                                     "cache_hit": true when the answer
                                     came from the prediction cache; the
                                     request id is the caller's
                                     X-Request-Id header or one minted
                                     here, echoed back as a header)
    GET  /v1/models                  -> {"models": [...], "detail": {...}}
    GET  /v1/stats                   -> ModelServer.stats()
    GET  /healthz                    -> {"status": "ok"|"draining"}

Errors become the status codes a load balancer expects: unknown model
404, admission fast-reject 429 (with Retry-After), draining 503, request
deadline 504 (the client-wait RequestTimeout, and a DeadlineExceeded
drop with ``"dropped": true`` since no compute ran), bad body 400, failed
batch 500. ``GET /metrics`` and ``/metrics.json`` answer 501: the
telemetry export behind them is not ported, and neither are the traced
phases of a response. Each request is one bounded ``server.submit`` and
``result``; the handler threads (ThreadingHTTPServer) never wait
unbounded.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as _np

from .errors import (DeadlineExceeded, ModelNotFound, RequestError,
                     RequestTimeout, ServerBusyError, ServerDrainingError)

__all__ = ["HttpFrontEnd"]

_PREDICT_RE = re.compile(r"^/(?:v1/models|models|predict)/([^/:]+)"
                         r"(?::predict)?$")
_ids = itertools.count(1)


def _new_request_id():
    """A process-unique request id (pid-prefixed counter)."""
    return f"{os.getpid():x}-{next(_ids):x}"


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

            def _json(self, code, payload, extra_headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

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
                elif self.path in ("/metrics", "/metrics.json"):
                    self._json(501, {"error": "the telemetry export is not "
                                     "ported to mxnet_tpu_torch"})
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
                rid = self.headers.get("X-Request-Id") or _new_request_id()
                rid_hdr = [("X-Request-Id", rid)]
                try:
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
