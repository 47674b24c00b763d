"""Minimal stdlib HTTP front-end over :class:`ServingEngine` (port of
``icek_tpu/serve/server.py``).

Protocol (kept dependency-free — stdlib ``http.server`` + numpy only):

  POST /caption   body = ``np.savez`` bytes with the per-request arrays
                  :meth:`ServingEngine.submit` documents (one image input
                  + entity/fact context).  Response: JSON
                  ``{"caption": str, "tokens": [str], "mask": [int]}``.
  GET  /healthz   ``{"ok": true}`` once the engine thread is alive.
  GET  /stats     batching counters (requests, batches, fill histogram).

The handler threads only parse/serialize; all device work funnels through
the engine's single batcher thread, so concurrent HTTP requests coalesce
into device batches exactly like direct ``submit`` callers.
"""

from __future__ import annotations

import io
import json
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from icek_torch.serve.engine import ServingEngine


def _request_handler(engine: ServingEngine, timeout: Optional[float]):
    class Handler(BaseHTTPRequestHandler):
        # serving logs go to the caller's logger, not stderr-per-request
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                s = engine.stats()
                self._reply(200, {
                    "requests": s.requests,
                    "batches": s.batches,
                    "mean_fill": round(s.mean_fill, 3),
                    "batch_fill": s.batch_fill,
                    "bucket_runs": s.bucket_runs,
                    "errors": s.errors,
                })
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/caption":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                with np.load(
                    io.BytesIO(self.rfile.read(length)), allow_pickle=False
                ) as arrays:
                    sample = {k: arrays[k] for k in arrays.files}
            except Exception as exc:  # unparseable body = caller fault
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            try:
                future = engine.submit(sample)
            except ValueError as exc:
                # submit()-side validation (bad shapes / missing keys)
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            except Exception as exc:
                self._reply(503, {"error": f"{type(exc).__name__}: {exc}"})
                return
            try:
                result = future.result(timeout=timeout)
            except (TimeoutError, futures.TimeoutError) as exc:
                # (both spellings: concurrent.futures.TimeoutError only
                # aliases the builtin from Python 3.11.)  Server saturated
                # — retryable, not the caller's fault.  Cancel so the
                # engine drops the request at batch assembly instead of
                # spending device time on an abandoned caller; without
                # this, sustained overload decodes batches nobody is
                # waiting for and the backlog never drains.
                future.cancel()
                self._reply(504, {"error": f"request timed out: {exc}"})
                return
            except Exception as exc:
                # engine closed / device failure — server-side, retryable
                self._reply(503, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._reply(200, result)

    return Handler


def make_server(
    engine: ServingEngine,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout: Optional[float] = None,
) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``serve_forever()`` runs
    it, ``shutdown()`` stops it.  ``port=0`` binds an ephemeral port
    (``server.server_address[1]`` reports it) — used by the tests."""
    return ThreadingHTTPServer(
        (host, port), _request_handler(engine, request_timeout)
    )


def encode_request(sample: dict) -> bytes:
    """Client helper: pack a sample dict into the POST /caption body."""
    buf = io.BytesIO()
    np.savez(buf, **sample)
    return buf.getvalue()
