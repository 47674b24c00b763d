"""Streaming loader for very-large datasets, NYTimes800k scale (port of
``icek_tpu/data/streaming.py``; h5py is imported where a store is opened).

The reference protocol keeps a split's caption/context sidecars in JSON/pkl
(geo-aware/create_input_files.py:89-130), which forces full host-RAM
materialization; at ~800k images (news-knowledge-aware/README.md:6) the
news preset's entity/fact context arrays alone are several GB.  This module
keeps the steady-state training/eval memory constant in dataset size:

  * ``write_sidecar_store`` — one-time conversion of a split's sidecars
    into a single HDF5 store (``{SPLIT}_SIDECAR_{base}.h5``);
  * ``StreamingCaptionDataset`` — drop-in ``CaptionDataset`` replacement
    whose batches are read from disk per step: images from the protocol
    HDF5, sidecars from the store, and (optionally) frozen-encoder image
    tokens from a disk-backed cache written once per split
    (``{SPLIT}_TOKENS_{base}.h5``) instead of host RAM;
  * ``block_shuffled_indices`` — epoch shuffling with read locality
    (shuffle blocks, then shuffle within a window of blocks — sorted
    range reads instead of fully random rows).

The host->device overlap still comes from ``dataset.prefetch`` (depth-2
thread, double-buffered device puts) exactly as in the in-memory path.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterator, Optional

import numpy as np

from icek_torch.data import images as image_ops

_SIDE_KINDS = (
    ("caption_ids", "CAPTIONS", "json", np.int32),
    ("lengths", "CAPLENS", "json", np.int32),
    ("caption_mask", "CAPMASKS", "json", np.int32),
    ("entity_features", "ENT_FEATURES", "pkl", np.float32),
    ("entity_names", "ENT_NAMES", "pkl", np.int32),
    ("fact_features", "FACTS", "pkl", np.float32),
    ("fact_names", "FACT_NAMES", "pkl", np.int32),
)


def sidecar_store_path(data_dir: str, base_name: str, split: str) -> str:
    return os.path.join(data_dir, f"{split}_SIDECAR_{base_name}.h5")


def token_cache_path(data_dir: str, base_name: str, split: str) -> str:
    return os.path.join(data_dir, f"{split}_TOKENS_{base_name}.h5")


def write_sidecar_store(
    data_dir: str, base_name: str, split: str, has_facts: bool,
) -> str:
    """Convert one split's protocol sidecars into the HDF5 store.

    One-time conversion (run it at prep time right after
    ``InputConstructor.run``): the JSON/pkl sources are parsed once here so
    training/eval never have to again.
    """
    import h5py

    path = sidecar_store_path(data_dir, base_name, split)
    with h5py.File(path, "w") as h:
        for name, kind, fmt, dtype in _SIDE_KINDS:
            if name.startswith("fact_") and not has_facts:
                continue
            src = os.path.join(data_dir, f"{split}_{kind}_{base_name}.{fmt}")
            if fmt == "json":
                with open(src) as f:
                    arr = np.asarray(json.load(f), dtype=dtype)
            else:
                with open(src, "rb") as f:
                    arr = np.asarray(pickle.load(f), dtype=dtype)
            # contiguous layout: exact-range reads for arbitrary row sets.
            # Chunked layouts round every access up to whole chunks — with
            # shuffled row access that multiplies read volume by the chunk
            # row count (measured 15x+ on the token cache).
            h.create_dataset(name, data=arr)
    return path


class _StoreArrays:
    """CaptionArrays-compatible view over the HDF5 store: every attribute
    is an h5py dataset (row-indexable like the ndarray it replaces), never
    a full in-memory copy."""

    def __init__(self, h5file, has_facts: bool):
        self.caption_ids = h5file["caption_ids"]
        self.lengths = h5file["lengths"]
        self.caption_mask = h5file["caption_mask"]
        self.entity_features = h5file["entity_features"]
        self.entity_names = h5file["entity_names"]
        self.fact_features = h5file["fact_features"] if has_facts else None
        self.fact_names = h5file["fact_names"] if has_facts else None
        self.size = len(self.caption_ids)


def _gather_rows(dset, idx: np.ndarray) -> np.ndarray:
    """Fancy-index an h5py dataset with unsorted/duplicated indices."""
    uniq, inverse = np.unique(idx, return_inverse=True)
    rows = dset[uniq.tolist()] if len(uniq) > 1 else dset[int(uniq[0])][None]
    return rows[inverse]


class StreamingCaptionDataset:
    """One split, disk-backed: same interface as ``dataset.CaptionDataset``
    (len / batch / image_batch / cache_image_tokens / .arrays) with
    constant host memory in the dataset size."""

    def __init__(self, data_dir: str, base_name: str, split: str,
                 has_facts: bool = False, convert_if_missing: bool = True):
        import h5py

        self.split = split
        self._data_dir = data_dir
        self._base_name = base_name
        store = sidecar_store_path(data_dir, base_name, split)
        if not os.path.exists(store):
            if not convert_if_missing:
                raise FileNotFoundError(store)
            write_sidecar_store(data_dir, base_name, split, has_facts)
        self._store = h5py.File(store, "r")
        self.arrays = _StoreArrays(self._store, has_facts)
        self._h5 = h5py.File(
            os.path.join(data_dir, f"{split}_IMAGES_{base_name}.hdf5"), "r"
        )
        self._images = self._h5["images"]
        self._tokens = None  # h5py dataset once cache_image_tokens ran
        self._token_file = None
        self.open_token_cache()

    def close(self):
        """Release the HDF5 handles (store, images, token cache) AND the
        persistent epoch window/ring buffers — at batch 256 with stored
        images those hold several hundred MB per buffer key, which must
        not outlive the dataset's useful life on overcommitted hosts."""
        for attr in ("_store", "_h5", "_token_file"):
            f = getattr(self, attr, None)
            if f is not None:
                f.close()
        self._tokens = None
        self._epoch_buffers = None

    def open_token_cache(self, path: Optional[str] = None) -> bool:
        """(Re-)open the disk token cache — default: the canonical
        ``{SPLIT}_TOKENS_{base}.h5`` path.  Returns False (and leaves no
        cache attached) when the file does not exist."""
        import h5py

        path = path or token_cache_path(
            self._data_dir, self._base_name, self.split
        )
        if self._token_file is not None:
            self._token_file.close()
            self._token_file = None
            self._tokens = None
        if not os.path.exists(path):
            return False
        self._token_file = h5py.File(path, "r")
        self._tokens = self._token_file["image_tokens"]
        return True

    @property
    def token_cache_attrs(self) -> dict:
        """Root attrs of the open token-cache file (e.g. the encoder
        fingerprint eval_driver binds caches with); {} when no cache."""
        if self._token_file is None:
            return {}
        return dict(self._token_file.attrs)

    def __len__(self):
        return self.arrays.size

    @property
    def image_tokens(self):
        return self._tokens

    def raw_image_batch(self, idx: np.ndarray) -> np.ndarray:
        return _gather_rows(self._images, np.asarray(idx))

    def image_batch(self, idx: np.ndarray) -> np.ndarray:
        return image_ops.normalize_for_model(self.raw_image_batch(idx))

    def cache_image_tokens(self, encode_fn, batch_size: int = 32,
                           dtype=np.float32, raw: bool = False,
                           path: Optional[str] = None,
                           attrs: Optional[dict] = None):
        """Run the frozen encoder over the split once, writing the 196-token
        features to a disk-backed contiguous cache (NOT host RAM — at 800k
        images the tokens alone exceed any host).  raw=True as in
        CaptionDataset.cache_image_tokens (encode_fn normalizes in-graph).
        ``attrs`` are stored as root attributes of the cache file (the eval
        driver binds caches to the encoder by fingerprint this way)."""
        import h5py

        feed = self.raw_image_batch if raw else self.image_batch
        path = path or token_cache_path(
            self._data_dir, self._base_name, self.split
        )
        if self._token_file is not None:
            # release our read handle before truncating (HDF5 file locking)
            self._token_file.close()
            self._token_file = None
            self._tokens = None
        probe = np.asarray(encode_fn(feed(np.arange(1))))
        with h5py.File(path, "w") as h:
            for k, v in (attrs or {}).items():
                h.attrs[k] = v
            # contiguous (unchunked): random row gathers read exact ranges
            dset = h.create_dataset(
                "image_tokens", (len(self),) + probe.shape[1:], dtype=dtype,
            )
            dset[0] = probe[0]
            for start in range(1, len(self), batch_size):
                idx = np.arange(start, min(start + batch_size, len(self)))
                dset[start : start + len(idx)] = np.asarray(
                    encode_fn(feed(idx))
                )
        self.open_token_cache(path)

    def index_batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                      pad_partial: bool = True, process_index: int = 0,
                      process_count: int = 1) -> Iterator[np.ndarray]:
        from icek_torch.data.dataset import process_local_slices

        batches = block_shuffled_indices(
            len(self), batch_size, shuffle, seed, pad_partial
        )
        return process_local_slices(batches, process_index, process_count)

    def epoch_batches(
        self, batch_size: int, shuffle: bool, seed: int = 0,
        pad_partial: bool = True, with_images: bool = True,
        raw_images: bool = False,
        block_rows: int = 512, window_blocks: int = 4, ring_depth: int = 8,
        copy: bool = False, process_index: int = 0, process_count: int = 1,
        start_batch: int = 0,
    ):
        """Ready batch dicts for one epoch with SEQUENTIAL disk I/O and
        REUSED host buffers.

        ALIASING CONTRACT: with ``copy=False`` (the default), each yielded
        dict holds views into a ``ring_depth``-deep ring of reused buffers —
        a slot is overwritten ``ring_depth`` batches later.  That is safe for
        the training loop (depth-2 prefetch + a per-step ``float(loss)``
        sync keep the consumer well within the ring), but any consumer that
        RETAINS yielded dicts (``list(epoch_batches(...))``, accumulation
        across > ring_depth-2 batches) must pass ``copy=True`` to get
        independent arrays.

        MULTI-PROCESS: ``batch_size`` is the GLOBAL batch size.  With
        ``process_count > 1`` the shuffled block order (identical on every
        process — same seed) is dealt round-robin across processes, so each
        process range-reads ONLY its own blocks (no I/O amplification,
        unlike slicing a shared stream) and yields
        ``batch_size // process_count``-row local batches.  The union of
        per-process row streams is exactly one epoch, and every process
        yields the SAME number of batches (trailing all-padding batches
        with length 0 keep slower shards in lockstep — required for SPMD).

        Scattered per-row h5py reads are latency-bound (profiled: a random
        256-row batch of image tokens costs seconds once the store outruns
        the page cache), and per-window heap churn is just as bad on
        overcommitted hosts where fresh large allocations fault in slowly.
        So: `block_rows`-long ranges are `read_direct`-ed in random order
        straight into ONE preallocated window buffer, `window_blocks` of
        them pool into a constant-size shuffle window, and batches are
        np.take-d into a `ring_depth`-deep ring of preallocated batch
        buffers (deep enough that the prefetch pipeline never sees a slot
        reused while in flight).  Every row appears exactly once per epoch,
        randomness spans ~block_rows*window_blocks rows, disk access is
        pure range reads, and steady-state host allocation is zero.
        Remainders carry across windows; the final short batch pads by
        repeating its last row with length 0 (masked out, like the
        index-based loaders' -1 padding).
        """
        n = len(self)
        rng = np.random.default_rng(seed)
        starts = np.arange(0, n, block_rows)
        if shuffle:
            starts = rng.permutation(starts)
        n_steps = None
        if process_count > 1:
            if not pad_partial:
                raise ValueError(
                    "pad_partial=False would desynchronize SPMD processes"
                )
            if batch_size % process_count:
                raise ValueError(
                    f"global batch size {batch_size} is not divisible by "
                    f"process count {process_count}"
                )
            batch_size //= process_count  # local rows per yielded batch
            block_len = lambda s: min(int(s) + block_rows, n) - int(s)
            # every process can compute every shard's row count from the
            # (shared) shuffled block order -> a globally agreed step count
            n_steps = max(
                -(-sum(map(block_len, starts[q::process_count])) // batch_size)
                for q in range(process_count)
            )
            starts = starts[process_index::process_count]
        a = self.arrays
        sources = {
            "caption_ids": a.caption_ids,
            "caption_mask": a.caption_mask,
            "lengths": a.lengths,
            "entity_features": a.entity_features,
        }
        if a.fact_features is not None:
            sources["fact_features"] = a.fact_features
        images_from_store = False
        token_rows = getattr(self, "use_token_rows", False)
        if with_images and not token_rows:
            if self._tokens is not None:
                sources["image_tokens"] = self._tokens
            else:
                sources["images"] = self._images
                images_from_store = True
        max_rows = block_rows * window_blocks + batch_size - 1
        # buffers persist on the dataset across epochs (one live generator
        # per dataset at a time): steady-state host allocation is zero,
        # which matters on overcommitted hosts where fresh pages fault in
        # slowly
        # the key must pin the SOURCE layout too: opening/rebuilding a token
        # cache between epochs swaps "images" <-> "image_tokens" (and can
        # change the token dtype); reusing buffers keyed only on the batch
        # geometry would read_direct into a missing or mismatched buffer
        bkey = (batch_size, with_images, token_rows, block_rows,
                window_blocks, ring_depth,
                tuple(sorted((k, str(d.dtype)) for k, d in sources.items())))
        if getattr(self, "_epoch_buffers", None) is None:
            self._epoch_buffers = {}
        if bkey not in self._epoch_buffers:
            # buffers follow the source dtype: an f16 token cache stays f16
            # through the window buffer, ring and host->device transfer
            # (read_direct into a mismatched dtype would also force h5py
            # into a slow converting path)
            buf = {
                k: np.empty((max_rows,) + d.shape[1:], d.dtype)
                for k, d in sources.items()
            }
            if token_rows and with_images:
                # device-resident token cache (train/loop.py): batches carry
                # the GLOBAL row ids; the train step gathers the (B, 196, D)
                # tokens on the device from its memory, so the big stream never touches
                # the host pipeline or the host->device link.
                buf["token_rows"] = np.empty((max_rows,), np.int32)
            ring = [
                {k: np.empty((batch_size,) + v.shape[1:], v.dtype)
                 for k, v in buf.items()}
                for _ in range(ring_depth)
            ]
            self._epoch_buffers[bkey] = (buf, ring)
        buf, ring = self._epoch_buffers[bkey]
        ring_i = 0

        def finish(out, lengths_override=None):
            final = dict(out)
            if images_from_store:
                if raw_images:
                    # stored f16 CHW rows as-is (the ring slot view, zero
                    # host passes); the train step normalizes in-graph
                    final["raw_images"] = final.pop("images")
                else:
                    final["images"] = image_ops.normalize_for_model(
                        final.pop("images")
                    )
            if lengths_override is not None:
                final["lengths"] = lengths_override
            if copy:
                final = {k: np.copy(v) for k, v in final.items()}
            return final

        carry_cnt = 0
        yielded = 0
        for w in range(0, len(starts), window_blocks):
            pos = carry_cnt
            for s0 in starts[w : w + window_blocks]:
                s0 = int(s0)
                hi = int(min(s0 + block_rows, n))
                cnt = hi - s0
                for k, d in sources.items():
                    d.read_direct(buf[k], np.s_[s0:hi], np.s_[pos:pos + cnt])
                if "token_rows" in buf:
                    buf["token_rows"][pos:pos + cnt] = np.arange(
                        s0, hi, dtype=np.int32
                    )
                pos += cnt
            m = pos
            order = rng.permutation(m) if shuffle else np.arange(m)
            n_full = m // batch_size
            for i in range(n_full):
                yielded += 1
                if yielded <= start_batch:
                    # mid-epoch resume: the prefix's range reads + window
                    # shuffle replay (they feed the carry rows and the rng
                    # state), but the take/normalize/yield are skipped
                    continue
                sel = order[i * batch_size : (i + 1) * batch_size]
                out = ring[ring_i]
                ring_i = (ring_i + 1) % ring_depth
                for k, v in buf.items():
                    np.take(v, sel, axis=0, out=out[k])
                yield finish(out)
            rest = order[n_full * batch_size :]
            carry_cnt = len(rest)
            if carry_cnt:
                for k, v in buf.items():
                    v[:carry_cnt] = v[rest]
        if carry_cnt and pad_partial:
            yielded += 1
            if yielded > start_batch:
                out = ring[ring_i]
                ring_i = (ring_i + 1) % ring_depth
                for k, v in buf.items():
                    out[k][:carry_cnt] = v[:carry_cnt]
                    out[k][carry_cnt:] = v[carry_cnt - 1 : carry_cnt]
                lengths = out["lengths"].copy()
                lengths[carry_cnt:] = 0
                yield finish(out, lengths_override=lengths)
        # SPMD lockstep: shards whose block share ran short emit all-padding
        # batches (length 0, masked out) until every process has yielded the
        # globally agreed step count.
        while n_steps is not None and yielded < n_steps:
            yielded += 1
            if yielded <= start_batch:
                continue
            out = ring[ring_i]
            ring_i = (ring_i + 1) % ring_depth
            for k, v in out.items():
                v[:] = 0
            yield finish(out)

    def batch(self, idx: np.ndarray, with_images: bool = True,
              raw_images: bool = False) -> Dict[str, np.ndarray]:
        a = self.arrays
        idx = np.asarray(idx)
        pad = idx < 0                              # -1 marks padding rows
        safe = np.where(pad, 0, idx)
        out = {
            "caption_ids": _gather_rows(a.caption_ids, safe),
            "caption_mask": _gather_rows(a.caption_mask, safe),
            "lengths": np.where(pad, 0, _gather_rows(a.lengths, safe)),
            "entity_features": _gather_rows(a.entity_features, safe),
        }
        if a.fact_features is not None:
            out["fact_features"] = _gather_rows(a.fact_features, safe)
        if with_images:
            if self._tokens is not None:
                out["image_tokens"] = _gather_rows(self._tokens, safe).astype(
                    np.float32
                )
            elif raw_images:
                # stored f16 CHW rows; consumer normalizes in-graph
                out["raw_images"] = _gather_rows(self._images, safe)
            else:
                out["images"] = self.image_batch(safe)
        return out


def block_shuffled_indices(
    n: int, batch_size: int, shuffle: bool, seed: int = 0,
    pad_partial: bool = True, block: int = 1024, window_blocks: int = 16,
) -> Iterator[np.ndarray]:
    """Epoch index batches with read locality.

    Full-uniform shuffling of an 800k-row store turns every batch into
    scattered single-row reads.  Instead: partition [0, n) into contiguous
    blocks, shuffle the block order, then shuffle rows within a sliding
    window of ``window_blocks`` blocks.  Every index appears exactly once
    per epoch; randomness spans ``block * window_blocks`` rows while disk
    reads stay within ~``window_blocks`` distinct row neighborhoods per
    batch."""
    if not shuffle:
        for start in range(0, n, batch_size):
            idx = np.arange(start, min(start + batch_size, n))
            if len(idx) < batch_size:
                if not pad_partial:
                    return
                idx = np.concatenate([idx, np.full(batch_size - len(idx), -1)])
            yield idx
        return

    rng = np.random.default_rng(seed)
    n_blocks = -(-n // block)
    block_order = rng.permutation(n_blocks)
    leftover = np.empty((0,), dtype=np.int64)
    for w_start in range(0, n_blocks, window_blocks):
        window = block_order[w_start : w_start + window_blocks]
        rows = np.concatenate(
            [np.arange(b * block, min((b + 1) * block, n)) for b in window]
            + [leftover]
        )
        rng.shuffle(rows)
        n_full = (len(rows) // batch_size) * batch_size
        for start in range(0, n_full, batch_size):
            yield rows[start : start + batch_size]
        leftover = rows[n_full:]
    if len(leftover):
        if pad_partial:
            yield np.concatenate(
                [leftover, np.full(batch_size - len(leftover), -1)]
            )
        else:
            for start in range(0, len(leftover), batch_size):
                chunk = leftover[start : start + batch_size]
                if len(chunk) == batch_size:
                    yield chunk
