"""Batched evaluation driver: TEST split -> captions CSV + domain metrics
(port of ``icek_tpu/eval_driver.py``).

Images are encoded and decoded in large static batches on the device
(greedy or beam); detokenization, the CSV and the metrics stay on the host.
One batch runs the slice's whole path: normalize the raw f16 CHW rows,
ResNet-101 (BN folded when the compute dtype is not f32, or the int8
encoder when an ``encoder_qtree`` is given), the entity (and,
for the knowledge and news presets, fact) context encoders, the
precomputed cross K/V, then beam or greedy decode.  Cached image tokens
(``cache_split_tokens``) skip the encoder.

Output contract of ``Evaluator.run``, per preset:
  * ``generated_captions.csv`` with a ``generated_caption`` column (news
    adds ``generated_mask``), written with the stdlib ``csv`` module in the
    bytes pandas' ``to_csv(index=False)`` writes;
  * knowledge also writes ``generated_captions_random_facts.csv`` (the
    random-fact-object baseline) and logs both fact-accuracy reports;
  * geo feeds the Jensen-Shannon metric online.

Under a mesh (``parallel/mesh.py``) the run is data-parallel over every
process: params replicate, each process reads and decodes its rows of every
batch, the ids are all-gathered, and only the primary detokenizes, scores
and writes.
"""

from __future__ import annotations

import csv
import os
import random as _random
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from icek_torch.core.config import Config
from icek_torch.data import dataset as ds
from icek_torch.data import images as image_ops
from icek_torch.data.codec import UNK_FACT, Wordmap
from icek_torch.decode import beam as beam_lib
from icek_torch.decode import detok
from icek_torch.decode import greedy as greedy_lib
from icek_torch.models import resnet

# (mode, batch key) of the three image inputs decode_batch takes
_MODES = (("raw", "raw_images"), ("tokens", "image_tokens"), ("images", "images"))
# the batch keys a decode reads (run uploads only these)
_INPUT_KEYS = frozenset(k for _, k in _MODES) | {"entity_features", "fact_features"}


def resolve_eval_batch_size(batch_size: Optional[int], cfg: Config,
                            device="cuda") -> int:
    """Explicit arg > preset value > default by device (256 on CUDA, the
    benchmarked configuration; 64 on CPU)."""
    if batch_size is not None:
        return batch_size
    if cfg.decode.batch_size is not None:
        return cfg.decode.batch_size
    return 64 if torch.device(device).type == "cpu" else 256


def _pad_batch(idx: np.ndarray, batch_size: int) -> np.ndarray:
    """A partial batch's row ids, padded to `batch_size` with its last row."""
    if len(idx) < batch_size:
        return np.concatenate([idx, np.full(batch_size - len(idx), idx[-1])])
    return idx


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


class Evaluator:
    def __init__(self, cfg: Config, wordmap: Wordmap, params, encoder_params,
                 batch_size: Optional[int] = None,
                 beam_size: Optional[int] = None, compute_dtype=None,
                 device="cuda", mesh=None, encoder_qtree=None):
        """`params` / `encoder_params` are the port's param trees (see
        ``bridge.py``); they are moved to `device` ("cuda" unless the caller
        asks for the CPU).  Compute dtype defaults to bf16 on CUDA and f32
        on CPU.  ``encoder_qtree`` (``models/resnet_int8.py``, opt-in: it
        changes arithmetic) runs the int8 encoder; it is verified against
        `encoder_params` by fingerprint when both are given.

        With ``mesh`` (a ``DeviceMesh`` of ``parallel/mesh.py::make_mesh``)
        every process of the world calls :meth:`run` in lockstep; the run is
        on the mesh's device and ``batch_size`` must divide by the process
        count."""
        if mesh is not None:
            from icek_torch.parallel import mesh as mesh_lib

            if not mesh_lib.is_mesh(mesh):
                raise TypeError("Evaluator: mesh must be a (data, model) DeviceMesh "
                                f"(parallel/mesh.py::make_mesh), got {type(mesh)}")
            device = mesh_lib.mesh_device(mesh)
        self.mesh = mesh
        kv = beam_lib.resolve_kv_dtype(cfg.decode.kv_dtype, cfg.model)
        if kv not in (None, "int8", "int8_cross"):
            raise ValueError(
                f"kv_dtype must be None/'auto'/'int8'/'int8_cross', got {kv!r}")
        self.cfg = cfg
        self.wordmap = wordmap
        self.device = torch.device(device)
        self.params = _to_device(params, self.device)
        self.encoder_params = _to_device(encoder_params, self.device)
        self.batch_size = resolve_eval_batch_size(batch_size, cfg, self.device)
        if mesh is not None:
            import torch.distributed as dist

            self._rank, self._world = dist.get_rank(), dist.get_world_size()
            if self.batch_size % self._world:
                raise ValueError(
                    f"eval batch size {self.batch_size} is not divisible by "
                    f"process count {self._world}"
                )
        else:
            self._rank, self._world = 0, 1
        self.beam_size = beam_size if beam_size is not None else cfg.decode.beam_size
        if compute_dtype is None:
            compute_dtype = (torch.float32 if self.device.type == "cpu"
                             else torch.bfloat16)
        self.compute_dtype = compute_dtype
        # Frozen-encoder fast path for the bf16 mode: BN affines folded into
        # the conv weights.  The f32 mode keeps the exact unfolded path.
        self._encoder_folded = (
            resnet.fold_bn_params(self.encoder_params)
            if self.encoder_params is not None and compute_dtype != torch.float32
            else None
        )
        if encoder_qtree is not None:
            from icek_torch.models import resnet_int8

            if encoder_params is not None:
                # a qtree bakes the weights in: reject one quantized from
                # another checkpoint before it serves wrong encodings
                resnet_int8.verify_qtree(encoder_qtree, self.encoder_params)
            encoder_qtree = resnet_int8.to_device(encoder_qtree, self.device)
        self._encoder_qtree = encoder_qtree

    def _encode_tokens(self, images, mode: str):
        """Raw f16 CHW rows ("raw") or host-normalized NHWC images
        ("images") -> (B, 196, D) image tokens; cached tokens ("tokens")
        pass through."""
        if mode == "tokens":
            return images
        if mode == "raw":
            images = image_ops.normalize_in_graph(images)
        size = self.cfg.model.encoded_image_size
        if self._encoder_qtree is not None:
            from icek_torch.models import resnet_int8

            return resnet_int8.resnet_encode_int8(self._encoder_qtree, images, size,
                                                  compute_dtype=self.compute_dtype)
        if self._encoder_folded is not None:
            return resnet.resnet_encode_folded(self._encoder_folded, images, size,
                                               compute_dtype=self.compute_dtype)
        return resnet.resnet_encode(self.encoder_params, images, size,
                                    compute_dtype=self.compute_dtype)

    def encoder_fingerprint(self) -> str:
        """Content hash of whatever produces this Evaluator's image tokens
        (the active encoder tree, its kind, the compute dtype and the pool
        size): the key that binds cached tokens to their encoder."""
        from icek_torch.utils.fingerprint import tree_fingerprint

        if self._encoder_qtree is not None:
            tree, kind = self._encoder_qtree, "qtree"
        elif self._encoder_folded is not None:
            tree, kind = self._encoder_folded, "folded"
        else:
            tree, kind = self.encoder_params, "exact"
        return tree_fingerprint(tree, extra=(
            kind, str(self.compute_dtype), self.cfg.model.encoded_image_size))

    def cache_split_tokens(self, data: ds.CaptionDataset, cache_path: str,
                           log: Callable[[str], None] = print) -> str:
        """Encode ``data``'s images once and persist the tokens in a .npz with
        the encoder's fingerprint; later calls load them and skip the encoder
        and the image reads.  A cache built under another encoder, encoder
        kind or compute dtype, or of another length, is re-encoded.  Tokens
        are stored f32, which holds bf16 values exactly, and are encoded in
        the run's padded batches, so cached-token captions equal the image
        path's.  Returns "loaded" or "encoded".

        A streaming dataset (``data/streaming.py``) caches to a disk-backed
        HDF5 file in its sidecar layout instead of an in-RAM .npz, with the
        same fingerprint stored as a root attribute."""
        from icek_torch.data import streaming as streaming_lib

        fp = self.encoder_fingerprint()

        def loaded():
            log(f"token cache: loaded {cache_path} "
                f"({len(data)} rows, encoder {fp[:12]})")
            return "loaded"

        def encode(raw):
            # a partial chunk is padded with its last row to the run's batch
            # shape: the convolutions' algorithms are picked by batch size,
            # and in bf16 another algorithm gives other tokens
            n = len(raw)
            full = raw[_pad_batch(np.arange(n), self.batch_size)]
            with torch.inference_mode():
                tokens = self._encode_tokens(torch.as_tensor(full, device=self.device), "raw")
                return tokens[:n].to(torch.float32).cpu().numpy()

        def encode_split(**cache_kwargs):
            # one encode feed for both cache layouts
            data.cache_image_tokens(encode, batch_size=self.batch_size, dtype=np.float32,
                                    raw=True, **cache_kwargs)
            log(f"token cache: encoded + saved {cache_path} "
                f"({len(data)} rows, encoder {fp[:12]})")
            return "encoded"

        if isinstance(data, streaming_lib.StreamingCaptionDataset):
            if (data.open_token_cache(cache_path)
                    and data.token_cache_attrs.get("fingerprint") == fp
                    and len(data.image_tokens) == len(data)):
                return loaded()
            if data.image_tokens is not None:
                log("token cache: stale (different encoder/length) — re-encoding")
            return encode_split(path=cache_path, attrs={"fingerprint": fp})
        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                if str(z["fingerprint"]) == fp and len(z["tokens"]) == len(data):
                    data.image_tokens = z["tokens"]
                    return loaded()
            log("token cache: stale (different encoder/length) — re-encoding")
        result = encode_split()
        tmp = cache_path + ".tmp.npz"  # .npz suffix: savez appends it otherwise
        np.savez(tmp, tokens=data.image_tokens, fingerprint=fp)
        os.replace(tmp, cache_path)
        return result

    def decode_batch(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """One static-shape batch -> (B, max_len) extended-vocab ids.  The
        batch holds "raw_images", "image_tokens" or "images",
        "entity_features" and, for the knowledge and news presets,
        "fact_features" (B, F, 3), as numpy arrays or tensors."""
        return self.decode_batch_async(batch).cpu().numpy()

    def decode_batch_async(self, batch) -> torch.Tensor:
        """:meth:`decode_batch` without the copy to the host: returns the
        decoded ids as a tensor on the Evaluator's device; ``.cpu()`` waits
        for them.  The beam and greedy loops read their stop flag on the
        host every step, so the call returns when the decode has (almost)
        finished.  Safe to call from any thread (it enters
        ``torch.inference_mode`` itself, which is per thread)."""
        mode, key = next(((m, k) for m, k in _MODES if k in batch), (None, None))
        if mode is None:
            raise ValueError(f"batch keys {sorted(batch)}: no image input of "
                             f"{[k for _, k in _MODES]}")
        cfg, wm = self.cfg, self.wordmap
        with torch.inference_mode():
            inputs = torch.as_tensor(batch[key], device=self.device)
            ents = torch.as_tensor(batch["entity_features"], device=self.device)
            facts = batch.get("fact_features")
            if facts is not None:
                facts = torch.as_tensor(facts, device=self.device)
            num_entity_rows = ents.shape[1]
            tokens = self._encode_tokens(inputs, mode)
            ctx = greedy_lib.prepare_decode_context(
                self.params, cfg.model, tokens, ents, facts,
                compute_dtype=self.compute_dtype)
            if self.beam_size <= 1:
                return greedy_lib.greedy_decode(
                    self.params, cfg.model, len(wm), num_entity_rows,
                    wm.start_id, wm.end_id, wm.pad_id, ctx,
                    cfg.decode.max_caption_len, compute_dtype=self.compute_dtype,
                    use_fused_scores=cfg.decode.use_fused_scores,
                )
            out, _ = beam_lib.beam_decode(
                self.params, cfg.model, len(wm), num_entity_rows,
                wm.start_id, wm.end_id, wm.pad_id, ctx,
                cfg.decode.max_caption_len, beam_size=self.beam_size,
                compute_dtype=self.compute_dtype,
                use_fused_scores=cfg.decode.use_fused_scores,
                use_megakernel=cfg.decode.use_megakernel,
                kv_dtype=cfg.decode.kv_dtype,
            )
            return out

    def _stage(self):
        """The prefetch thread's upload of a (start, batch) item
        (``dataset.stage_to``)."""
        stage = ds.stage_to(self.device)

        def item(it):
            start, batch = it
            return (start, *stage(batch))

        return item

    def run(self, data: ds.CaptionDataset, js_metric=None, fact_metric=None,
            predicate_to_objects: Optional[Dict[str, List[str]]] = None,
            output_csv: str = "generated_captions.csv",
            log: Callable[[str], None] = print,
            rng: Optional[_random.Random] = None) -> Dict[str, object]:
        """Decode the whole split in batches of ``batch_size`` (the last one
        padded with its last row), detokenize, feed the metrics and write the
        CSV(s).  Returns {"captions", "masks"} and, where asked for,
        "random_baseline", "js", "fact_accuracy", "fact_accuracy_random".
        Under a mesh every process runs this in lockstep; the others than
        the primary return {"captions": None, "masks": None, "primary":
        False}."""
        cfg = self.cfg
        rng = rng or _random
        n = len(data)
        captions: List[str] = []
        masks: List[List[int]] = []
        random_baseline: List[str] = []
        num_entities = num_facts = caps_with_entities = caps_with_facts = 0

        rank, world = self._rank, self._world
        primary = rank == 0

        def batches():
            for start in range(0, n, self.batch_size):
                idx = _pad_batch(np.arange(start, min(start + self.batch_size, n)),
                                 self.batch_size)
                if world > 1:
                    # each process reads only its rows; run all-gathers the ids
                    local = self.batch_size // world
                    idx = idx[rank * local:(rank + 1) * local]
                batch = data.batch(idx, raw_images=True)
                yield start, {k: v for k, v in batch.items() if k in _INPUT_KEYS}

        # the host reads and the upload of the next batches overlap the
        # device's decode of this one
        for start, batch, ready in ds.prefetch(batches(), self._stage()):
            batch = ds.wait_staged(batch, ready)
            if self.mesh is None:
                out = self.decode_batch(batch)
            else:
                from icek_torch.parallel import mesh as mesh_lib

                out = mesh_lib.all_gather(self.decode_batch_async(batch)).cpu().numpy()
            count = min(self.batch_size, n - start)
            if not primary:
                # the others only drive the collective decode; detok, the
                # metrics and the CSV are the primary's
                continue
            for b in range(count):
                i = start + b
                ent_names = data.arrays.entity_names[i]
                fact_names = (data.arrays.fact_names[i]
                              if data.arrays.fact_names is not None else None)
                tokens, kinds = detok.detokenize(out[b], self.wordmap, ent_names, fact_names)
                raw_text = " ".join(tokens)
                text = detok.trim_trailing_sentence(raw_text)
                captions.append(text)
                masks.append(kinds)
                if 1 in kinds:
                    caps_with_entities += 1
                    num_entities += sum(1 for k in kinds if k == 1)
                if 2 in kinds:
                    caps_with_facts += 1
                    num_facts += sum(1 for k in kinds if k == 2)
                if js_metric is not None:
                    js_metric.run([int(t) for t in out[b]],
                                  data.arrays.entity_features[i], ent_names)
                if predicate_to_objects is not None and fact_names is not None:
                    # the baseline is trimmed in lockstep with the main caption
                    # (knowledge-aware/eval.py:169-172)
                    random_baseline.append(detok.trim_lockstep(
                        raw_text,
                        _random_fact_caption(tokens, kinds, fact_names,
                                             predicate_to_objects, rng)))

        if not primary:
            return {"captions": None, "masks": None, "primary": False}
        self._write_csv(output_csv, captions, masks)
        results: Dict[str, object] = {"captions": captions, "masks": masks}
        if random_baseline:
            self._write_csv(output_csv.replace(".csv", "_random_facts.csv"), random_baseline)
            results["random_baseline"] = random_baseline
        if js_metric is not None:
            results["js"] = js_metric.results()
        if fact_metric is not None:
            log("\nKNOWLEDGE-AWARE:")
            results["fact_accuracy"] = fact_metric.run(captions, log=log)
            if random_baseline:
                log("\nRANDOM FACT OBJECT BASELINE:")
                results["fact_accuracy_random"] = fact_metric.run(random_baseline, log=log)
        if cfg.model.variant == "news":
            ratio_e = round(caps_with_entities * 100 / max(n, 1), 2)
            ratio_f = round(caps_with_facts * 100 / max(n, 1), 2)
            log(f"Captions with entities: {caps_with_entities} out of {n}, {ratio_e}%")
            log(f"Captions with facts: {caps_with_facts} out of {n}, {ratio_f}%")
            log(
                "Number of generated entities (both from E and K) per caption: "
                f"{round((num_entities + num_facts) / max(n, 1), 2)}"
            )
        return results

    def _write_csv(self, path: str, captions: List[str], masks=None):
        """The reference's CSV: a ``generated_caption`` column (news adds
        ``generated_mask``, each mask as its Python list text), no index."""
        header, columns = ["generated_caption"], [captions]
        if self.cfg.model.variant == "news" and masks is not None:
            header.append("generated_mask")
            columns.append([str(m) for m in masks])
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(zip(*columns))


def _random_fact_caption(tokens: List[str], kinds: List[int], fact_names: np.ndarray,
                         predicate_to_objects: Dict[str, List[str]], rng) -> str:
    """Random-fact-object baseline caption (knowledge-aware/eval.py:81-156):
    each generated fact token is replaced by a random same-type object
    (sharing a predicate in the corpus) from the image's knowledge context.
    Returned untrimmed: the caller trims it in lockstep with the main
    caption."""
    from icek_torch.metrics.fact_accuracy import is_year

    years, others = [], []
    for row in fact_names[:-1]:
        obj = detok.name_from_row(row)
        if obj not in others and obj not in years:
            (years if is_year(obj) else others).append(obj)
    out = []
    for tok, kind in zip(tokens, kinds):
        if kind != 2:
            out.append(tok)
            continue
        if is_year(tok):
            out.append(rng.choice(years) if years else UNK_FACT)
            continue
        if not others:
            out.append(UNK_FACT)
            continue
        same_type = [tok]
        for objects in predicate_to_objects.values():
            if tok in objects:
                same_type.extend(x for x in objects if x != tok and x in others)
        out.append(rng.choice(same_type) if same_type else UNK_FACT)
    return " ".join(out)
