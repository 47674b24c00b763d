"""The port's serving engine, HTTP server and replica router
(``icek_torch/serve/``): the counterpart of every test in
``tests/test_serving.py``, over the port's engine on the CPU in f32, with
JAX's offline ``Evaluator.run`` over the same TEST split and weights as the
oracle (computed once for the module).  Decode is row-independent, so a
request's caption must not depend on how it was batched.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch.data import dataset as tds  # noqa: E402
from icek_torch.serve.engine import ServingEngine as _Engine  # noqa: E402
from icek_torch.serve.server import encode_request, make_server  # noqa: E402
from test_torch_common import eval_split, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def ServingEngine(cfg, wm, params, encoder_params, **kw):
    """The port's engine on the CPU (its default device is "cuda")."""
    return _Engine(cfg, wm, params, encoder_params, device="cpu", **kw)


@pytest.fixture(scope="module")
def serving_setup(tmp_path_factory):
    """(port cfg, port wordmap, port params, port encoder, port TEST split,
    tmp dir) and, once for the module, JAX's offline captions and masks of
    the split at beam 3 (batch 2: two full batches and one padded)."""
    from icek_tpu import eval_driver as jev
    from icek_tpu.data import dataset as jds

    tmp_path = tmp_path_factory.mktemp("serving")
    s = eval_split(tmp_path, "geo")
    jdata = jds.CaptionDataset(s["out_dir"], s["base"], "TEST")
    res = jev.Evaluator(s["jc"], s["jwm"], s["jp"], s["jenc"], batch_size=2,
                        beam_size=3).run(jdata, output_csv=str(tmp_path / "oracle.csv"),
                                         log=lambda line: None)
    _ORACLE.update(captions=res["captions"], masks=res["masks"])
    data = tds.CaptionDataset(s["out_dir"], s["base"], "TEST")
    return s["tc"], s["twm"], s["tp"], s["tenc"], data, tmp_path


_ORACLE = {}   # filled once by the module fixture


def _sample(data, i, mode="raw_images"):
    row = data.batch(np.array([i]), raw_images=(mode == "raw_images"))
    out = {
        mode: row[mode][0],
        "entity_features": row["entity_features"][0],
        "entity_names": data.arrays.entity_names[i],
    }
    if data.arrays.fact_names is not None:
        out["fact_features"] = row["fact_features"][0]
        out["fact_names"] = data.arrays.fact_names[i]
    return out


def _reference_captions(setup):
    """JAX's offline Evaluator captions and masks for the TEST split."""
    return _ORACLE["captions"], _ORACLE["masks"]


def test_concurrent_requests_match_offline_eval(serving_setup):
    """N client threads, arbitrary coalescing -> captions identical to the
    offline batch eval of the same rows."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    oracle_caps, oracle_masks = _reference_captions(serving_setup)
    n = len(data)
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=4, max_wait_ms=50.0,
    ) as engine:
        results = [None] * n

        def client(i):
            results[i] = engine.caption(_sample(data, i), timeout=300)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = engine.stats()
    assert [r["caption"] for r in results] == oracle_caps
    assert [r["mask"] for r in results] == oracle_masks
    assert stats.requests == n
    assert stats.errors == 0


def test_requests_coalesce_into_batches(serving_setup):
    """With a generous wait window, queued requests must share device
    batches instead of running one-by-one."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=2, max_wait_ms=2000.0,
    ) as engine:
        # warm up first so the batcher isn't stuck building kernels while the
        # queue drains one request at a time
        engine.warmup(_sample(data, 0), buckets=[1, 2])
        futures = [engine.submit(_sample(data, i % len(data))) for i in range(6)]
        for f in futures:
            f.result(timeout=300)
        stats = engine.stats()
    assert stats.requests == 6
    # max_batch=2 -> at least 3 batches; coalescing -> strictly fewer than 6
    assert 3 <= stats.batches < 6
    assert stats.bucket_runs.get(2, 0) >= 1


def test_bucket_padding_is_result_invariant(serving_setup):
    """A lone request (padded up to a bucket) and the same row decoded in
    a full batch give identical captions."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    oracle_caps, _ = _reference_captions(serving_setup)
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=4, max_wait_ms=0.0,  # launch immediately: singleton batches
    ) as engine:
        one = engine.caption(_sample(data, 1), timeout=300)
        stats = engine.stats()
    assert one["caption"] == oracle_caps[1]
    assert stats.batch_fill.get(1, 0) >= 1


def test_submit_validates_sample(serving_setup):
    cfg, wm, params, encoder_params, data, _ = serving_setup
    with ServingEngine(cfg, wm, params, encoder_params, beam_size=1) as engine:
        with pytest.raises(ValueError, match="exactly one of"):
            engine.submit({"entity_features": np.zeros((9, 5))})
        sample = _sample(data, 0)
        sample.pop("entity_names")
        with pytest.raises(ValueError, match="entity_names"):
            engine.submit(sample)
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit(_sample(data, 0))


def test_submit_rejects_malformed_shapes_in_the_callers_thread(serving_setup):
    """A wrong-shaped array must fail its own submit() with a clear
    message — never reach the batcher where np.stack would poison every
    batchmate — and valid requests keep succeeding afterwards."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=4, max_wait_ms=50.0,
    ) as engine:
        good = _sample(data, 0)
        bad = dict(good)
        ok_shape = good["entity_features"].shape
        bad["entity_features"] = np.zeros(
            (ok_shape[0] + 1, ok_shape[1]), np.float32
        )
        with pytest.raises(ValueError, match="entity_features"):
            engine.submit(bad)
        out = engine.caption(good, timeout=300)
        stats = engine.stats()
    assert isinstance(out["caption"], str)
    assert stats.errors == 0


def test_cancelled_future_does_not_poison_batchmates(serving_setup):
    """A client cancelling its Future (timeout handling) while queued must
    not error the rest of its batch — the success path skips done futures."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=4, max_wait_ms=500.0,
    ) as engine:
        engine.warmup(_sample(data, 0), buckets=[2, 4])
        f1 = engine.submit(_sample(data, 0))
        f2 = engine.submit(_sample(data, 1))
        f1.cancel()  # False if the batch already resolved it — fine either way
        out = f2.result(timeout=300)
        stats = engine.stats()
    assert isinstance(out["caption"], str)
    assert stats.errors == 0


def test_cancelled_request_skips_device_work_when_dropped(serving_setup):
    """A future cancelled while still QUEUED is dropped at batch assembly
    (set_running_or_notify_cancel) — the engine must not spend device time
    on abandoned callers (the HTTP 504 path cancels exactly this way).
    Cancellation races the batcher, so the assertion is conditional on the
    cancel having won."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=4, max_wait_ms=500.0,
    ) as engine:
        engine.warmup(_sample(data, 0), buckets=[1, 2, 4])
        f1 = engine.submit(_sample(data, 0))
        f2 = engine.submit(_sample(data, 1))
        won = f1.cancel()
        out = f2.result(timeout=300)
        stats = engine.stats()
    assert isinstance(out["caption"], str)
    assert stats.errors == 0
    if won:  # the dropped request must not be counted as served
        assert stats.requests == 1


def test_warmup_rejects_missing_image_key(serving_setup):
    """warmup() raises the same ValueError contract as submit() when the
    sample has no image input (was a bare StopIteration)."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    with ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3, max_batch=2,
    ) as engine:
        bad = {k: v for k, v in _sample(data, 0).items()
               if k not in ("raw_images", "images", "image_tokens")}
        with pytest.raises(ValueError, match="image input"):
            engine.warmup(bad)


def test_close_resolves_every_inflight_future(serving_setup):
    """close() must leave no future unresolved: everything submitted before
    close either resolves with a caption or fails with 'closed'."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    engine = ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=2, max_wait_ms=1.0,
    )
    engine.warmup(_sample(data, 0), buckets=[1, 2])
    futures = [engine.submit(_sample(data, i % len(data))) for i in range(5)]
    engine.close()
    for f in futures:
        assert f.done()
        if f.exception() is not None:
            assert "closed" in str(f.exception())
        else:
            assert isinstance(f.result()["caption"], str)


def test_http_server_roundtrip(serving_setup):
    """POST /caption over a real socket returns the oracle caption; the
    health/stats endpoints answer."""
    cfg, wm, params, encoder_params, data, _ = serving_setup
    oracle_caps, oracle_masks = _reference_captions(serving_setup)
    engine = ServingEngine(
        cfg, wm, params, encoder_params, beam_size=3,
        max_batch=4, max_wait_ms=20.0,
    )
    server = make_server(engine, "127.0.0.1", 0, request_timeout=300)
    host, port = server.server_address
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://{host}:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        req = urllib.request.Request(
            url + "/caption", data=encode_request(_sample(data, 0)),
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            result = json.load(r)
        assert result["caption"] == oracle_caps[0]
        assert result["mask"] == oracle_masks[0]
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 1
        assert stats["errors"] == 0
        # malformed body -> structured 400, not a hung socket
        bad = urllib.request.Request(
            url + "/caption", data=b"not-an-npz", method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
        # parseable body, wrong shape -> also a 400 (submit validation)
        bad_sample = _sample(data, 0)
        bad_sample["entity_features"] = np.zeros((2, 2), np.float32)
        shape_req = urllib.request.Request(
            url + "/caption", data=encode_request(bad_sample), method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(shape_req, timeout=30)
        assert err.value.code == 400
        assert "entity_features" in json.load(err.value)["error"]
    finally:
        server.shutdown()
        thread.join()
        engine.close()


# ---------------------------------------------------------------------------
# replica router (icek_torch/serve/router.py): one engine per card/process
# behind a round-robin front — the serving scale-out path
# ---------------------------------------------------------------------------


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _post_caption(addr, sample, timeout=300):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", "/caption", body=encode_request(sample))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture()
def router_setup(serving_setup):
    """Two live replica engines + HTTP servers + the router over them."""
    from icek_torch.serve import router as router_lib

    cfg, wm, params, encoder_params, data, _ = serving_setup
    engines, servers, threads = [], [], []
    for _ in range(2):
        engine = ServingEngine(
            cfg, wm, params, encoder_params, beam_size=3,
            max_batch=2, max_wait_ms=0.0,
        )
        server = make_server(engine, "127.0.0.1", 0, request_timeout=300)
        threads.append(_start(server))
        engines.append(engine)
        servers.append(server)
    router = router_lib.make_router(
        [f"127.0.0.1:{s.server_address[1]}" for s in servers],
        port=0, cooldown_s=0.2,
    )
    threads.append(_start(router))
    yield engines, servers, router, data
    router.shutdown()
    router.server_close()
    for server, engine in zip(servers, engines):
        server.shutdown()
        server.server_close()
        engine.close()
    for t in threads:
        t.join()


def test_router_round_robins_and_aggregates_stats(router_setup, serving_setup):
    engines, servers, router, data = router_setup
    oracle_caps, _ = _reference_captions(serving_setup)
    addr = ("127.0.0.1", router.server_address[1])
    n = 4
    for i in range(n):
        status, result = _post_caption(addr, _sample(data, i % len(data)))
        assert status == 200
        assert result["caption"] == oracle_caps[i % len(data)]
    # sequential successes alternate strictly between the two replicas
    per_engine = [e.stats().requests for e in engines]
    assert per_engine == [n // 2, n // 2], per_engine
    with urllib.request.urlopen(
        f"http://{addr[0]}:{addr[1]}/stats", timeout=30
    ) as r:
        agg = json.load(r)
    assert agg["totals"]["requests"] == n
    assert agg["totals"]["errors"] == 0
    # totals carry only additive counters + the recomputed fleet mean:
    # summing per-replica means would be meaningless
    assert set(agg["totals"]) <= {"requests", "batches", "errors",
                                  "mean_fill"}
    if agg["totals"].get("batches"):
        assert agg["totals"]["mean_fill"] == pytest.approx(
            n / agg["totals"]["batches"], abs=1e-3
        )
    assert [b["requests"] for b in agg["router"]] == per_engine
    assert all(b["up"] for b in agg["router"])
    with urllib.request.urlopen(
        f"http://{addr[0]}:{addr[1]}/healthz", timeout=30
    ) as r:
        assert json.load(r) == {"ok": True}


def test_router_survives_replica_death(router_setup, serving_setup):
    """Killing one replica must cost at most a retry — every subsequent
    request still succeeds on the survivor, nothing hangs, and the router
    reports the death without going unhealthy."""
    engines, servers, router, data = router_setup
    oracle_caps, _ = _reference_captions(serving_setup)
    addr = ("127.0.0.1", router.server_address[1])
    # warm both replicas through the router first
    for i in range(2):
        status, _ = _post_caption(addr, _sample(data, 0))
        assert status == 200
    servers[0].shutdown()
    servers[0].server_close()  # refuse connections, not just stop serving
    engines[0].close()
    for i in range(3):
        status, result = _post_caption(addr, _sample(data, i % len(data)))
        assert status == 200
        assert result["caption"] == oracle_caps[i % len(data)]
    snap = {b["address"]: b for b in router.router_state.snapshot()}
    dead = f"127.0.0.1:{servers[0].server_address[1]}"
    assert snap[dead]["errors"] >= 1
    with urllib.request.urlopen(
        f"http://{addr[0]}:{addr[1]}/healthz", timeout=30
    ) as r:
        assert json.load(r)["ok"] is True  # one survivor = healthy


def test_router_all_replicas_down_returns_503(serving_setup):
    """With no live backend the router answers 503 promptly (a structured
    error, not a hang) and /healthz goes unhealthy after the failure."""
    import socket

    from icek_torch.serve import router as router_lib

    _, _, _, _, data, _ = serving_setup
    # reserve-then-release a port so nothing listens on it
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    router = router_lib.make_router(
        [f"127.0.0.1:{dead_port}"], port=0, cooldown_s=60.0,
        request_timeout=5.0,
    )
    thread = _start(router)
    try:
        addr = ("127.0.0.1", router.server_address[1])
        status, payload = _post_caption(addr, _sample(data, 0), timeout=30)
        assert status == 503
        assert "no replica available" in payload["error"]
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://{addr[0]}:{addr[1]}/healthz", timeout=30
            )
        assert err.value.code == 503
    finally:
        router.shutdown()
        thread.join()


_STUB_REPLICA = '''
import argparse, json, os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ap = argparse.ArgumentParser()
ap.add_argument("--port", type=int, required=True)
ap.add_argument("--host", default="127.0.0.1")
args = ap.parse_args()
DEVICE = os.environ.get("ICEK_SERVE_DEVICE", "?")
count = [0]

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass
    def _reply(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def do_GET(self):
        if self.path == "/healthz":
            self._reply({"ok": True})
        else:
            self._reply({"requests": count[0], "device": DEVICE})
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        count[0] += 1
        self._reply({"caption": f"from-device-{DEVICE}"})

ThreadingHTTPServer((args.host, args.port), H).serve_forever()
'''


def _free_port_pair():
    """A base port p such that p+1 and p+2 are currently bindable
    (launch_replicas assigns base+1+i)."""
    import socket

    for base in range(20000, 40000, 7):
        try:
            socks = []
            for off in (1, 2):
                s = socket.socket()
                s.bind(("127.0.0.1", base + off))
                socks.append(s)
            for s in socks:
                s.close()
            return base
        except OSError:
            for s in socks:
                s.close()
    raise RuntimeError("no free port pair")


def test_launch_replicas_spawns_processes_and_pins_devices(tmp_path):
    """router.launch_replicas (the serve.py --replicas body): subprocesses
    come up on base_port+1+i with ICEK_SERVE_DEVICE=i in their env,
    wait_for_healthy gates on them, and the router round-robins real HTTP
    across the processes."""
    from icek_torch.serve import router as router_lib

    stub = tmp_path / "stub_replica.py"
    stub.write_text(_STUB_REPLICA)
    base = _free_port_pair()
    procs, specs = router_lib.launch_replicas([str(stub)], 2, base)
    router = None
    try:
        assert specs == [f"127.0.0.1:{base + 1}", f"127.0.0.1:{base + 2}"]
        router_lib.wait_for_healthy(specs, timeout_s=60, poll_s=0.2)
        router = router_lib.make_router(specs, port=0)
        rthread = _start(router)
        addr = ("127.0.0.1", router.server_address[1])
        got = set()
        for _ in range(4):
            import http.client

            conn = http.client.HTTPConnection(*addr, timeout=30)
            conn.request("POST", "/caption", body=b"x")
            resp = conn.getresponse()
            assert resp.status == 200
            got.add(json.loads(resp.read())["caption"])
            conn.close()
        # both replicas served, each pinned to its own device index
        assert got == {"from-device-0", "from-device-1"}
        with urllib.request.urlopen(
            f"http://{addr[0]}:{addr[1]}/stats", timeout=30
        ) as r:
            agg = json.load(r)
        assert agg["totals"]["requests"] == 4
    finally:
        if router is not None:
            router.shutdown()
            router.server_close()
            rthread.join()
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait(timeout=30)


def test_engine_int8_kv_serving_mode(serving_setup):
    """cfg.decode.kv_dtype="int8" (the serving option with int8 K/V) plumbs
    through the Evaluator/engine stack and still produces plausible
    captions (not bit-parity with float by design — held against JAX's
    int8 beam decode in tests/test_torch_int8_kv.py)."""
    import dataclasses

    cfg, wm, params, encoder_params, data, _ = serving_setup
    cfg8 = cfg.replace(
        decode=dataclasses.replace(cfg.decode, kv_dtype="int8")
    )
    with ServingEngine(
        cfg8, wm, params, encoder_params, beam_size=3, max_batch=2,
        max_wait_ms=0.0,
    ) as engine:
        out = engine.caption(_sample(data, 0), timeout=300)
    assert isinstance(out["caption"], str)
    assert len(out["tokens"]) > 0


def test_replica_env_pins_one_card():
    """launch_replicas must give each replica its own card: replica i gets
    CUDA_VISIBLE_DEVICES=i (it then sees card i only, as its device 0) and
    ICEK_SERVE_DEVICE=i, unless the operator's environment or env_extra
    already sets CUDA_VISIBLE_DEVICES; no TPU partition variable is set."""
    from icek_torch.serve.router import _replica_env

    env = _replica_env(2, {"PATH": "/bin"}, None)
    assert env == {"PATH": "/bin", "ICEK_SERVE_DEVICE": "2", "CUDA_VISIBLE_DEVICES": "2"}
    assert not any(k.startswith("TPU_") for k in env)
    # an operator who partitioned the cards themselves is respected verbatim
    env = _replica_env(0, {"CUDA_VISIBLE_DEVICES": "4,5"}, None)
    assert env["CUDA_VISIBLE_DEVICES"] == "4,5"
    assert env["ICEK_SERVE_DEVICE"] == "0"
    # ... including via env_extra
    env = _replica_env(1, {}, {"CUDA_VISIBLE_DEVICES": "7"})
    assert env["CUDA_VISIBLE_DEVICES"] == "7"
    assert env["ICEK_SERVE_DEVICE"] == "1"


def test_wait_for_healthy_fails_fast_on_dead_replica():
    """A replica that exits during warmup (bad checkpoint path, card
    contention) must fail the launch immediately — not burn the full
    health timeout polling a port that will never come up."""
    import subprocess
    import sys
    import time as time_mod

    from icek_torch.serve import router as router_lib

    proc = subprocess.Popen([sys.executable, "-c", "import sys; sys.exit(3)"])
    proc.wait(timeout=30)
    t0 = time_mod.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 3"):
        router_lib.wait_for_healthy(
            ["127.0.0.1:9"], timeout_s=60, poll_s=0.1, procs=[proc]
        )
    assert time_mod.monotonic() - t0 < 10


def test_stats_probe_timeout_bounds_wedged_backend():
    """GET /stats must use the short probe timeout, not the 600 s caption
    timeout: a replica that accepts connections but never responds may
    stall monitoring only briefly, and is reported down in the payload."""
    import socket
    import time as time_mod

    from icek_torch.serve import router as router_lib

    wedged = socket.socket()
    wedged.bind(("127.0.0.1", 0))
    wedged.listen(1)
    port = wedged.getsockname()[1]
    router = router_lib.make_router(
        [f"127.0.0.1:{port}"], port=0, request_timeout=600.0,
        probe_timeout=0.5,
    )
    thread = _start(router)
    try:
        t0 = time_mod.monotonic()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{router.server_address[1]}/stats", timeout=30
        ) as r:
            agg = json.load(r)
        assert time_mod.monotonic() - t0 < 10
        assert agg["backends"][0]["up"] is False
    finally:
        router.shutdown()
        router.server_close()
        thread.join()
        wedged.close()


def test_many_clients_under_fast_thread_switching(serving_setup):
    """More client threads than cores with the interpreter switching threads
    every 10 us: every request is counted once in the engine's stats and
    gets its own row's caption (the stats and the futures are shared
    between the batcher, the postprocess pool and the clients)."""
    import sys

    cfg, wm, params, encoder_params, data, _ = serving_setup
    oracle_caps, _ = _reference_captions(serving_setup)
    n_clients, per_client = 24, 3
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServingEngine(cfg, wm, params, encoder_params, beam_size=3, max_batch=4,
                           max_wait_ms=1.0) as engine:
            engine.warmup(_sample(data, 0))

            def client(c):
                for j in range(per_client):
                    i = (c + j) % len(data)
                    results[(c, j)] = (i, engine.caption(_sample(data, i), timeout=300))

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            stats = engine.stats()
    finally:
        sys.setswitchinterval(old)
    assert len(results) == n_clients * per_client
    assert all(r["caption"] == oracle_caps[i] for i, r in results.values())
    assert stats.requests == n_clients * per_client and stats.errors == 0
    assert sum(k * v for k, v in stats.batch_fill.items()) == stats.requests
    assert sum(stats.batch_fill.values()) == stats.batches == sum(stats.bucket_runs.values())
