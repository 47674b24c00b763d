"""Replica router: one serving engine per card/process behind one front
(port of ``icek_tpu/serve/router.py``).

``ServingEngine`` is single-process / single-card by design (serving scales
at the replica level).  This module makes that scale-out real:

  * ``make_router(backends)`` — a stdlib ``ThreadingHTTPServer`` reverse
    proxy.  ``POST /caption`` forwards to backends ROUND-ROBIN; a backend
    that refuses connections or errors mid-request is marked down for
    ``cooldown_s`` and the request is retried on the next backend (a dying
    replica costs one retry, never a hang).  After the cooldown the next
    request probes the backend again — recovery needs no operator action.
    ``GET /stats`` aggregates every live backend's counters plus the
    router's own (per-backend request/error counts); ``GET /healthz`` is
    OK while at least one backend accepts work.
  * ``launch_replicas(argv, n, base_port)`` — subprocess launcher: replica
    i runs ``argv`` with ``--port base+1+i``, ``ICEK_SERVE_DEVICE=i`` and,
    unless the operator set it, ``CUDA_VISIBLE_DEVICES=i``, so each process
    sees and owns exactly one card (see ``_replica_env``).

Replicas share nothing, so throughput scales in replicas by construction.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple


def _parse_backend(spec) -> Tuple[str, int]:
    if isinstance(spec, tuple):
        return spec[0], int(spec[1])
    host, _, port = spec.rpartition(":")
    return host or "127.0.0.1", int(port)


class _Backend:
    __slots__ = ("host", "port", "down_until", "requests", "errors")

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self.down_until = 0.0  # monotonic; 0 = believed healthy
        self.requests = 0
        self.errors = 0

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"


class RouterState:
    """Round-robin scheduling + down-marking shared by handler threads."""

    def __init__(self, backends, cooldown_s: float, request_timeout: float,
                 probe_timeout: float = 5.0):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.backends = [_Backend(*_parse_backend(b)) for b in backends]
        self.cooldown_s = cooldown_s
        self.request_timeout = request_timeout
        # /stats and other side-channel probes must not inherit the long
        # caption timeout: one wedged replica would stall monitoring for
        # request_timeout (600 s default) per poll.
        self.probe_timeout = probe_timeout
        self._lock = threading.Lock()
        self._next = 0

    def candidates(self) -> List[_Backend]:
        """Backends in round-robin order from the next cursor position,
        believed-healthy first (down ones last, as probes of last resort —
        if EVERY backend is down we would rather probe than refuse)."""
        with self._lock:
            start = self._next
            self._next = (self._next + 1) % len(self.backends)
        ordered = [
            self.backends[(start + i) % len(self.backends)]
            for i in range(len(self.backends))
        ]
        now = time.monotonic()
        up = [b for b in ordered if b.down_until <= now]
        down = [b for b in ordered if b.down_until > now]
        return up + down

    def mark_down(self, backend: _Backend) -> None:
        with self._lock:
            backend.down_until = time.monotonic() + self.cooldown_s
            backend.errors += 1

    def mark_up(self, backend: _Backend) -> None:
        with self._lock:
            backend.down_until = 0.0
            backend.requests += 1

    def any_up(self) -> bool:
        now = time.monotonic()
        return any(b.down_until <= now for b in self.backends)

    def snapshot(self) -> List[Dict]:
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "address": b.address,
                    "up": b.down_until <= now,
                    "requests": b.requests,
                    "errors": b.errors,
                }
                for b in self.backends
            ]


def _forward(backend: _Backend, method: str, path: str,
             body: Optional[bytes], timeout: float):
    """One proxied HTTP exchange; returns (status, payload_bytes).
    Raises OSError-family on connect/transport failure."""
    conn = http.client.HTTPConnection(backend.host, backend.port,
                                      timeout=timeout)
    try:
        headers = {}
        if body is not None:
            headers["Content-Type"] = "application/octet-stream"
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _router_handler(state: RouterState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, body: bytes,
                   content_type="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, payload: dict):
            self._reply(code, json.dumps(payload).encode())

        def do_GET(self):
            if self.path == "/healthz":
                ok = state.any_up()
                self._reply_json(200 if ok else 503, {"ok": ok})
            elif self.path == "/stats":
                per_backend, totals = [], {}
                for b in state.backends:
                    entry = {"address": b.address}
                    try:
                        status, body = _forward(
                            b, "GET", "/stats", None, state.probe_timeout
                        )
                        stats = json.loads(body)
                        entry.update(up=True, stats=stats)
                        # sum ONLY additive counters — summing per-replica
                        # means (mean_fill) or any future ratio/percentile
                        # field would produce a meaningless aggregate
                        for k in ("requests", "batches", "errors"):
                            v = stats.get(k)
                            if isinstance(v, (int, float)):
                                totals[k] = totals.get(k, 0) + v
                    except (OSError, ValueError) as exc:
                        entry.update(up=False, error=str(exc))
                    per_backend.append(entry)
                if totals.get("batches"):
                    # fleet-wide mean fill = total rows / total batches
                    totals["mean_fill"] = round(
                        totals.get("requests", 0) / totals["batches"], 3
                    )
                self._reply_json(200, {
                    "totals": totals,
                    "backends": per_backend,
                    "router": state.snapshot(),
                })
            else:
                self._reply_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            last_exc = None
            for backend in state.candidates():
                try:
                    status, payload = _forward(
                        backend, "POST", self.path, body,
                        state.request_timeout,
                    )
                except OSError as exc:
                    # connect refused / reset / timeout: the replica is
                    # gone or wedged — cool it down and try the next one
                    state.mark_down(backend)
                    last_exc = exc
                    continue
                if status in (503, 504):
                    # replica said "server-side, retryable" — honor that
                    state.mark_down(backend)
                    last_exc = RuntimeError(
                        f"{backend.address} -> {status}: {payload[:200]!r}"
                    )
                    continue
                state.mark_up(backend)
                self._reply(status, payload)
                return
            self._reply_json(503, {
                "error": "no replica available",
                "last": f"{type(last_exc).__name__}: {last_exc}"
                if last_exc else None,
            })

    return Handler


def make_router(
    backends,
    host: str = "127.0.0.1",
    port: int = 8000,
    cooldown_s: float = 2.0,
    request_timeout: float = 600.0,
    probe_timeout: float = 5.0,
) -> ThreadingHTTPServer:
    """Build (but do not start) the replica router; ``backends`` is a list
    of ``"host:port"`` strings or ``(host, port)`` tuples.  ``port=0``
    binds an ephemeral port (tests).  The returned server exposes its
    scheduling state as ``server.router_state``."""
    state = RouterState(backends, cooldown_s, request_timeout,
                        probe_timeout=probe_timeout)
    server = ThreadingHTTPServer((host, port), _router_handler(state))
    server.router_state = state
    return server


def _replica_env(i: int, base_env, env_extra) -> dict:
    """Per-replica environment: ``ICEK_SERVE_DEVICE=i`` plus, when neither
    the operator's environment nor `env_extra` already sets
    ``CUDA_VISIBLE_DEVICES``, ``CUDA_VISIBLE_DEVICES=i``: replica i then
    sees card i only (as its device 0) and cannot allocate on the others.
    Where the operator set it, the replica's ``serve`` picks card
    ``i % (cards it sees)`` from ``ICEK_SERVE_DEVICE``
    (``apps.serve_device``)."""
    env = dict(base_env, ICEK_SERVE_DEVICE=str(i), **(env_extra or {}))
    env.setdefault("CUDA_VISIBLE_DEVICES", str(i))
    return env


def launch_replicas(argv: List[str], replicas: int, base_port: int,
                    host: str = "127.0.0.1", env_extra=None):
    """Spawn ``replicas`` serving subprocesses: replica i runs ``argv``
    with ``--port base_port+1+i --host host`` appended and the per-card
    environment from :func:`_replica_env`.  Returns (procs, backend_specs)."""
    import os
    import subprocess
    import sys

    procs, specs = [], []
    for i in range(replicas):
        port = base_port + 1 + i
        env = _replica_env(i, os.environ, env_extra)
        cmd = [sys.executable] + argv + ["--port", str(port), "--host", host]
        procs.append(subprocess.Popen(cmd, env=env))
        specs.append(f"{host}:{port}")
    return procs, specs


def wait_for_healthy(backends, timeout_s: float = 600.0,
                     poll_s: float = 1.0, procs=None) -> None:
    """Block until every backend answers ``GET /healthz`` (replica warmup
    includes building the kernels — minutes on a cold build).  ``procs``
    (subprocess handles, index-aligned with ``backends``) enables
    fail-fast: a replica that exits before turning healthy raises
    immediately instead of burning the full timeout polling a dead port."""
    deadline = time.monotonic() + timeout_s
    remaining = [_parse_backend(b) for b in backends]
    while remaining:
        if procs is not None:
            # Any exit before turning healthy is fatal — even code 0 means
            # the port will never come up.
            dead = [
                f"replica {i} (pid {p.pid}) exited with code {p.returncode}"
                for i, p in enumerate(procs)
                if p.poll() is not None
            ]
            if dead:
                raise RuntimeError(
                    "replica process(es) died during warmup: "
                    + "; ".join(dead)
                )
        host, port = remaining[0]
        try:
            status, _ = _forward(_Backend(host, port), "GET", "/healthz",
                                 None, timeout=poll_s)
            if status == 200:
                remaining.pop(0)
                continue
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"backend {host}:{port} not healthy after {timeout_s}s"
            )
        time.sleep(poll_s)
