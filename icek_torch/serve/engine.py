"""Online caption serving: dynamic micro-batching over the port's
Evaluator (port of ``icek_tpu/serve/engine.py``).

Clients arrive one request at a time; the device wants large static
batches.  The engine bridges the two:

  * one background batcher thread owns batch assembly and device dispatch;
    client threads submit single samples (:meth:`ServingEngine.submit`)
    and block on a ``concurrent.futures.Future``; host-side postprocessing
    (the copy of the ids to the host, detokenize, future resolution) runs
    on a small pool so the batcher coalesces the next batch while the
    device executes the current one;
  * requests coalesce until the largest bucket fills or the OLDEST queued
    request has waited ``max_wait_ms``: the latency/throughput knob;
  * batches pad up to a fixed ladder of bucket sizes (powers of two by
    default), so the kernels see a bounded set of shapes, and
    :meth:`ServingEngine.warmup` runs each bucket once before traffic
    (building the kernels and the cuBLAS handles).  Decode is
    row-independent (no cross-batch statistics anywhere in the model), so
    padding rows are free and a request's caption does not depend on its
    batchmates, at equal bucket sizes (another bucket is another GEMM
    shape, for which the library may pick another summation order);
  * mixed input modes in one drain (raw f16 CHW rows vs cached encoder
    tokens) split into one sub-batch per mode.

The engine is single-process / single-card by design: serving scales at
the replica level (one engine per card behind ``serve/router.py``).
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from icek_torch.core.config import Config
from icek_torch.data.codec import Wordmap
from icek_torch.decode import detok
from icek_torch.eval_driver import Evaluator

_MODE_KEYS = ("raw_images", "image_tokens", "images")
# request-side singular aliases accepted for convenience
_ALIASES = {"raw_image": "raw_images", "image": "images"}


@dataclass
class ServeStats:
    """Counters the batcher thread maintains (returned as a copy)."""

    requests: int = 0
    batches: int = 0
    batch_fill: Dict[int, int] = field(default_factory=dict)  # real rows -> n
    bucket_runs: Dict[int, int] = field(default_factory=dict)  # bucket -> n
    errors: int = 0

    @property
    def mean_fill(self) -> float:
        total = sum(k * v for k, v in self.batch_fill.items())
        return total / max(self.batches, 1)


class _Shutdown:
    pass


_SHUTDOWN = _Shutdown()


class _Pending:
    __slots__ = ("sample", "mode", "future", "t_submit")

    def __init__(self, sample, mode):
        self.sample = sample
        self.mode = mode
        self.future: Future = Future()
        self.t_submit = time.monotonic()


def _power_buckets(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class ServingEngine:
    """Dynamic-batching caption server core.

    Parameters mirror :class:`icek_torch.eval_driver.Evaluator` (params /
    encoder_params / beam_size / compute_dtype / device, "cuda" unless the
    caller asks for the CPU); serving adds:

    max_batch     largest (and default warmup) batch bucket.
    max_wait_ms   how long the oldest queued request may wait for
                  batchmates before the batch launches anyway.
    buckets       explicit bucket ladder (sorted, deduped); default is
                  powers of two up to ``max_batch``.
    """

    def __init__(
        self,
        cfg: Config,
        wordmap: Wordmap,
        params,
        encoder_params=None,
        *,
        beam_size: Optional[int] = None,
        compute_dtype=None,
        max_batch: int = 64,
        max_wait_ms: float = 3.0,
        buckets: Optional[List[int]] = None,
        device="cuda",
        encoder_qtree=None,
    ):
        self.cfg = cfg
        self.wordmap = wordmap
        self.buckets = sorted(set(buckets or _power_buckets(max_batch)))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {self.buckets}")
        self.max_batch = self.buckets[-1]
        self.max_wait_s = max_wait_ms / 1e3
        self._evaluator = Evaluator(
            cfg, wordmap, params, encoder_params,
            batch_size=self.max_batch, beam_size=beam_size,
            compute_dtype=compute_dtype, device=device, encoder_qtree=encoder_qtree,
        )
        self._queue: "queue.Queue" = queue.Queue()
        self._stats = ServeStats()
        self._stats_lock = threading.Lock()
        self._closed = False
        # serializes submit-vs-close so no request can be enqueued after
        # the shutdown sentinel (a submit that passed the closed check and
        # then lost the race would otherwise hang on its future forever)
        self._submit_lock = threading.Lock()
        self._expected_shapes = self._build_expected_shapes(cfg)
        # post-device work (host sync + detokenize + future resolution)
        # runs here so the batcher thread goes straight back to coalescing
        # the next batch while the device executes the current one
        self._post = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="icek-serve-post"
        )
        self._thread = threading.Thread(
            target=self._serve_loop, name="icek-serve-batcher", daemon=True
        )
        self._thread.start()

    @staticmethod
    def _build_expected_shapes(cfg: Config) -> Dict[str, Tuple[int, ...]]:
        d, m = cfg.data, cfg.model
        ent_cols = 10 if m.variant == "news" else 5
        shapes = {
            "raw_images": (3, d.img_size, d.img_size),
            "images": (d.img_size, d.img_size, 3),
            "image_tokens": (m.encoded_image_size ** 2, m.emb_dim),
            "entity_features": (d.entity_context_size + 1, ent_cols),
            "entity_names": (d.entity_context_size + 1, 52),
        }
        if m.has_facts:
            shapes["fact_features"] = (d.fact_context_size + 1, 3)
            shapes["fact_names"] = (d.fact_context_size + 1, 52)
        return shapes

    # ------------------------------------------------------------- client API

    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        """Queue one sample; returns a Future resolving to
        ``{"caption", "tokens", "mask"}``.

        The sample carries per-request arrays WITHOUT a batch axis:
        exactly one image input (``raw_image``/``raw_images`` f16 CHW as
        stored by the data prep, ``image``/``images`` normalized NHWC
        f32, or ``image_tokens`` cached encoder features), plus
        ``entity_features`` and ``entity_names``; fact presets also
        require ``fact_features`` and ``fact_names``.
        """
        sample = {_ALIASES.get(k, k): np.asarray(v) for k, v in sample.items()}
        mode = [k for k in _MODE_KEYS if k in sample]
        if len(mode) != 1:
            raise ValueError(
                f"sample must carry exactly one of {_MODE_KEYS} "
                f"(or the singular aliases {tuple(_ALIASES)}); got {mode}"
            )
        for key in ("entity_features", "entity_names"):
            if key not in sample:
                raise ValueError(f"sample is missing '{key}'")
        if self.cfg.model.has_facts:
            for key in ("fact_features", "fact_names"):
                if key not in sample:
                    raise ValueError(
                        f"'{self.cfg.model.variant}' preset requires '{key}'"
                    )
        # shape-check every array that gets stacked into a device batch:
        # one malformed request must fail HERE, in its own thread, not
        # inside the batcher where np.stack would poison every batchmate
        for key in (mode[0], "entity_features", "entity_names",
                    "fact_features", "fact_names"):
            want = self._expected_shapes.get(key)
            if want is None or key not in sample:
                continue
            got = tuple(sample[key].shape)
            if got != want:
                raise ValueError(
                    f"'{key}' must have shape {want} for the "
                    f"'{self.cfg.model.variant}' preset (no batch axis); "
                    f"got {got}"
                )
        pending = _Pending(sample, mode[0])
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            self._queue.put(pending)
        return pending.future

    def caption(self, sample: Dict[str, np.ndarray], timeout=None) -> Dict:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(sample).result(timeout=timeout)

    def warmup(self, sample: Dict[str, np.ndarray],
               buckets: Optional[List[int]] = None) -> None:
        """Run every given bucket (default: all) once by decoding ``sample``
        replicated, bypassing the queue: the kernels are built and the
        library handles made before traffic, so first-request latency
        excludes them."""
        sample = {_ALIASES.get(k, k): np.asarray(v) for k, v in sample.items()}
        mode = next((k for k in _MODE_KEYS if k in sample), None)
        if mode is None:  # same error contract as submit(), not StopIteration
            raise ValueError(
                f"warmup sample needs one image input of {sorted(_MODE_KEYS)}; "
                f"got keys {sorted(sample)}"
            )
        pending = _Pending(sample, mode)
        for b in sorted(set(buckets or self.buckets)):
            self._evaluator.decode_batch(self._assemble(mode, [pending], b))

    def stats(self) -> ServeStats:
        with self._stats_lock:
            return ServeStats(
                requests=self._stats.requests,
                batches=self._stats.batches,
                batch_fill=dict(self._stats.batch_fill),
                bucket_runs=dict(self._stats.bucket_runs),
                errors=self._stats.errors,
            )

    def close(self) -> None:
        """Drain the queue, stop the batcher thread, reject new submits."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            # under the lock no submit can enqueue after the sentinel, so
            # the batcher sees every real request before it
            self._queue.put(_SHUTDOWN)
        self._thread.join()
        self._post.shutdown(wait=True)
        self._fail_leftovers()  # defensive: the lock makes this a no-op

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- batcher side

    def _fail_leftovers(self) -> None:
        """Resolve (with an error) any requests still queued at shutdown —
        never leave a future unresolved."""
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                return
            if not isinstance(leftover, _Shutdown):
                leftover.future.set_exception(
                    RuntimeError("ServingEngine closed")
                )

    def _serve_loop(self):
        while True:
            first = self._queue.get()
            if isinstance(first, _Shutdown):
                self._fail_leftovers()
                return
            pending = [first]
            stop = False
            # FIRST drain everything already queued, without waiting: a
            # batch launch must never leave ready requests behind.  (The
            # deadline below only governs waiting for FUTURE arrivals —
            # measuring it against the oldest request's submit time alone
            # collapsed fills to ~1 whenever a decode outlasted the wait
            # window, serializing the whole backlog one request per batch.)
            while len(pending) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if isinstance(nxt, _Shutdown):
                    stop = True
                    break
                pending.append(nxt)
            deadline = first.t_submit + self.max_wait_s
            while not stop and len(pending) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if isinstance(nxt, _Shutdown):
                    stop = True
                    break
                pending.append(nxt)
            # one sub-batch per input mode (normally there is only one)
            by_mode: Dict[str, List[_Pending]] = {}
            for p in pending:
                by_mode.setdefault(p.mode, []).append(p)
            for mode, group in by_mode.items():
                self._run_batch(mode, group)
            if stop:
                self._fail_leftovers()
                return

    def _run_batch(self, mode: str, group: List[_Pending]):
        """Assemble + dispatch on the batcher thread; everything after the
        device call (host sync, detokenize, future resolution) happens on
        the postprocess pool so the batcher immediately coalesces the next
        batch while the device runs this one."""
        # drop requests whose caller already gave up (future.cancel() —
        # e.g. the HTTP server's request timeout) BEFORE spending device
        # time on them; under saturation this is what lets the backlog
        # drain instead of decoding batches nobody is waiting for.  A
        # surviving future is marked RUNNING here, so a later cancel
        # no-ops and result delivery in _finish_batch stays valid.
        group = [p for p in group if p.future.set_running_or_notify_cancel()]
        if not group:
            return
        n = len(group)
        bucket = self.buckets[bisect.bisect_left(self.buckets, min(n, self.max_batch))]
        try:
            batch = self._assemble(mode, group, bucket)
            ids = self._evaluator.decode_batch_async(batch)
            self._post.submit(self._finish_batch, group, ids, bucket)
        except Exception as exc:  # propagate to every caller in the batch
            self._fail_group(group, exc)

    def _finish_batch(self, group: List[_Pending], ids, bucket: int):
        n = len(group)
        try:
            ids = ids.cpu().numpy()  # blocks until the device batch finishes
            for i, p in enumerate(group):
                tokens, kinds = detok.detokenize(
                    ids[i], self.wordmap,
                    p.sample["entity_names"],
                    p.sample.get("fact_names"),
                )
                text = detok.trim_trailing_sentence(" ".join(tokens))
                if not p.future.done():  # the client may have cancelled
                    p.future.set_result(
                        {"caption": text, "tokens": tokens, "mask": kinds}
                    )
        except Exception as exc:
            self._fail_group(group, exc)
            return
        with self._stats_lock:
            self._stats.requests += n
            self._stats.batches += 1
            self._stats.batch_fill[n] = self._stats.batch_fill.get(n, 0) + 1
            self._stats.bucket_runs[bucket] = (
                self._stats.bucket_runs.get(bucket, 0) + 1
            )

    def _fail_group(self, group: List[_Pending], exc: Exception) -> None:
        with self._stats_lock:
            self._stats.errors += len(group)
        for p in group:
            if not p.future.done():
                p.future.set_exception(exc)

    def _assemble(self, mode: str, group: List[_Pending],
                  bucket: int) -> Dict[str, np.ndarray]:
        keys = [mode, "entity_features"]
        if self.cfg.model.has_facts:
            keys.append("fact_features")
        batch = {}
        for key in keys:
            rows = [p.sample[key] for p in group]
            # pad to the bucket by repeating row 0 (row-independent decode)
            rows.extend([rows[0]] * (bucket - len(rows)))
            batch[key] = np.stack(rows)
        return batch
