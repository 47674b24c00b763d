"""Data loading: reference-protocol files -> static-shape numpy batches
(port of ``icek_tpu/data/dataset.py``).

  * the HDF5 image store is opened read-only (``h5py`` is imported where a
    split is opened, so the module imports without it) and the caption /
    context sidecars are materialized as contiguous arrays once;
  * ``cache_image_tokens`` runs the frozen encoder over the split once, so
    later batches carry the 196-token image features instead of images;
  * ``epoch_batches`` yields an epoch's (shuffled, seeded) batches, from any
    batch on (mid-epoch resume);
  * ``prefetch`` stages the next batches on a background thread while the
    current one runs on the device (``stage_to`` / ``wait_staged``: pinned
    uploads on a side stream).

``data/streaming.py`` holds the disk-backed split of the same interface.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from icek_torch.data import images as image_ops


class CaptionArrays:
    """All non-image data for one split, as padded numpy arrays."""

    def __init__(self, data_dir: str, base_name: str, split: str,
                 has_facts: bool):
        def jload(kind):
            with open(os.path.join(data_dir, f"{split}_{kind}_{base_name}.json")) as f:
                return json.load(f)

        def pload(kind):
            with open(os.path.join(data_dir, f"{split}_{kind}_{base_name}.pkl"), "rb") as f:
                return pickle.load(f)

        self.caption_ids = np.asarray(jload("CAPTIONS"), dtype=np.int32)
        self.lengths = np.asarray(jload("CAPLENS"), dtype=np.int32)
        self.caption_mask = np.asarray(jload("CAPMASKS"), dtype=np.int32)
        self.entity_features = np.asarray(pload("ENT_FEATURES"), dtype=np.float32)
        self.entity_names = np.asarray(pload("ENT_NAMES"), dtype=np.int32)
        self.fact_features = None
        self.fact_names = None
        if has_facts:
            self.fact_features = np.asarray(pload("FACTS"), dtype=np.float32)
            self.fact_names = np.asarray(pload("FACT_NAMES"), dtype=np.int32)
        self.size = len(self.caption_ids)


class CaptionDataset:
    """One split: images (HDF5) + caption/context arrays."""

    # set by the train loop when the split's tokens live on the device:
    # batches then carry their row ids ("token_rows") instead of the tokens
    use_token_rows = False

    def __init__(self, data_dir: str, base_name: str, split: str,
                 has_facts: bool = False):
        import h5py

        self.split = split
        self.arrays = CaptionArrays(data_dir, base_name, split, has_facts)
        self._h5 = h5py.File(os.path.join(data_dir, f"{split}_IMAGES_{base_name}.hdf5"), "r")
        self._images = self._h5["images"]
        self.image_tokens: Optional[np.ndarray] = None  # filled by the cache step

    def __len__(self):
        return self.arrays.size

    def raw_image_batch(self, idx: np.ndarray) -> np.ndarray:
        """Stored (B, 3, H, W) float16 rows, un-normalized, for pipelines
        that normalize on the device (``images.normalize_in_graph``)."""
        # h5py fancy indexing requires strictly increasing indices; batches
        # may repeat rows (eval pads partial batches with the last index)
        uniq, inverse = np.unique(np.asarray(idx), return_inverse=True)
        raw = self._images[uniq.tolist()] if len(uniq) > 1 else (
            self._images[int(uniq[0])][None])
        return raw[inverse]

    def image_batch(self, idx: np.ndarray) -> np.ndarray:
        """Model-ready normalized NHWC images for the given indices."""
        return image_ops.normalize_for_model(self.raw_image_batch(idx))

    def cache_image_tokens(self, encode_fn, batch_size: int = 32,
                           dtype=np.float32, raw: bool = False):
        """Run the frozen encoder over the whole split once; afterwards
        batches carry (196, D) token features instead of images.
        `encode_fn` returns a host array; raw=True feeds it the stored f16
        CHW rows (it normalizes on the device)."""
        feed = self.raw_image_batch if raw else self.image_batch
        chunks = []
        for start in range(0, len(self), batch_size):
            idx = np.arange(start, min(start + batch_size, len(self)))
            chunks.append(np.asarray(encode_fn(feed(idx))).astype(dtype))
        self.image_tokens = np.concatenate(chunks, axis=0)

    def index_batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                      pad_partial: bool = True, process_index: int = 0,
                      process_count: int = 1) -> Iterator[np.ndarray]:
        """An epoch's row-id batches (uniform shuffle from `seed`).  With
        ``process_count > 1`` every process generates the same global stream
        and yields its ``batch_size // process_count``-row slice of each
        batch (``process_local_slices``)."""
        batches = batch_indices(len(self), batch_size, shuffle, seed, pad_partial)
        return process_local_slices(batches, process_index, process_count)

    def epoch_batches(self, batch_size: int, shuffle: bool, seed: int = 0,
                      pad_partial: bool = True, with_images: bool = True,
                      raw_images: bool = False, process_index: int = 0,
                      process_count: int = 1, start_batch: int = 0):
        """Batch dicts of one epoch.  ``batch_size`` is the GLOBAL batch
        size: with ``process_count > 1`` each dict holds this process's rows
        of it.  ``start_batch`` skips the first batches of the seeded epoch
        without reading them (mid-epoch resume)."""
        for j, idx in enumerate(self.index_batches(batch_size, shuffle, seed,
                                                   pad_partial, process_index,
                                                   process_count)):
            if j < start_batch:
                continue
            yield self.batch(idx, with_images=with_images, raw_images=raw_images)

    def batch(self, idx: np.ndarray, with_images: bool = True,
              raw_images: bool = False) -> Dict[str, np.ndarray]:
        a = self.arrays
        pad = idx < 0                             # -1 marks padding rows
        safe = np.where(pad, 0, idx)
        out = {
            "caption_ids": a.caption_ids[safe],
            "caption_mask": a.caption_mask[safe],
            "lengths": np.where(pad, 0, a.lengths[safe]),
            "entity_features": a.entity_features[safe],
        }
        if a.fact_features is not None:
            out["fact_features"] = a.fact_features[safe]
        if with_images:
            if self.use_token_rows:
                out["token_rows"] = safe.astype(np.int32)
            elif self.image_tokens is not None:
                out["image_tokens"] = self.image_tokens[safe]
            elif raw_images:
                out["raw_images"] = self.raw_image_batch(safe)
            else:
                out["images"] = self.image_batch(safe)
        return out


def batch_indices(n: int, batch_size: int, shuffle: bool, seed: int = 0,
                  pad_partial: bool = True) -> Iterator[np.ndarray]:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size:
            if not pad_partial:
                return
            idx = np.concatenate([idx, np.full(batch_size - len(idx), -1)])
        yield idx


def process_local_slices(batches: Iterator[np.ndarray], process_index: int,
                         process_count: int) -> Iterator[np.ndarray]:
    """This process's rows of each global index batch.

    All processes iterate the identical (identically-seeded) global stream;
    process p keeps rows [p*B/P, (p+1)*B/P) of every batch.  Union over p ==
    the global stream, and the slices concatenate back in process order."""
    if process_count == 1:
        yield from batches
        return
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    for idx in batches:
        if len(idx) % process_count:
            raise ValueError(
                f"global batch size {len(idx)} is not divisible by "
                f"process count {process_count}"
            )
        local = len(idx) // process_count
        yield idx[process_index * local : (process_index + 1) * local]


def stage_to(device):
    """The prefetch thread's upload of a batch dict: on a CUDA device, pinned
    copies sent on a side stream, returned with the event the consumer waits
    on (``wait_staged``); elsewhere the numpy batch as is, with no event."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: (batch, None)
    stream = torch.cuda.Stream(device)

    def stage(batch):
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    return stage


def wait_staged(batch, ready):
    """Make the current stream wait for a staged batch's upload and tell the
    allocator its tensors are used there."""
    if ready is None:
        return batch
    current = torch.cuda.current_stream(next(iter(batch.values())).device)
    current.wait_event(ready)
    for t in batch.values():
        t.record_stream(current)
    return batch


def prefetch(iterator, put_fn, depth: int = 2):
    """Run `put_fn` (e.g. the upload to the device) on a background thread,
    keeping `depth` batches in flight.  An error on that thread is raised to
    the consumer where the batch would have come, so a run never ends early
    without saying why."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    failure = []

    def producer():
        try:
            for item in iterator:
                q.put(put_fn(item))
        except Exception as exc:  # noqa: BLE001 - raised again by the consumer
            failure.append(exc)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item
