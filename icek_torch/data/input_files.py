"""Offline input-file construction (the reference's create_input_files.py).

Consumes the raw dataset artifacts (``captions_split.json`` +
``entity_context.pkl`` [+ ``knowledge_context.pkl``] + an images directory)
and emits the exact file protocol the reference's L1 loader expects
(SURVEY.md §1): per split ``{SPLIT}_{KIND}_{base}.{ext}`` with KINDs
IMAGES (HDF5 float16), CAPTIONS / CAPLENS / CAPMASKS (JSON),
ENT_FEATURES / ENT_NAMES (pickle), FACTS / FACT_NAMES (pickle), plus a
split-independent ``WORDMAP_{base}.json``.

Reference: geo-aware/create_input_files.py:14-356,
knowledge-aware/create_input_files.py:14-437,
news-knowledge-aware/create_input_files.py:14-448.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from typing import Dict, List, Optional

import numpy as np

from icek_torch.core.config import Config
from icek_torch.data import codec, context, images

SPLITS = ("TRAIN", "VAL", "TEST")


def _bounded_ordered_map(fn, items, workers: int, ahead: int = 4,
                         processes: bool = False):
    """Map ``fn`` over ``items`` with a worker pool, yielding results IN
    ORDER with at most ``workers * ahead`` tasks in flight — parallel
    read+resize without buffering a whole 800k-image split if the
    (single-threaded HDF5) writer ever falls behind.

    ``processes=True`` uses a fork-based process pool (``fn`` and items
    must be picklable): the decode+resize stack holds the GIL through its
    numpy inner loops, so threads alone cap out quickly."""
    if workers <= 1:
        for item in items:
            yield fn(item)
        return
    from collections import deque

    if processes:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        ex = ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("fork")
        )
    else:
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(max_workers=workers)
    with ex:
        window: deque = deque()
        for item in items:
            window.append(ex.submit(fn, item))
            if len(window) >= workers * ahead:
                yield window.popleft().result()
        while window:
            yield window.popleft().result()


class InputFileWriter:
    def __init__(
        self,
        cfg: Config,
        splits_captions_json_path: str,
        entity_context_path: str,
        image_dir: str,
        output_dir: str,
        knowledge_context_path: Optional[str] = None,
        wordmap_file_path: Optional[str] = None,
        update_wordmap: bool = False,
        seed: Optional[int] = None,
        image_workers: Optional[int] = None,
        image_processes: bool = True,
    ):
        """``image_workers``: worker count for the image read+resize
        pipeline (the prep wall-clock at NYTimes800k scale).
        None = min(8, cpu_count); 1 = the serial reference behavior.
        ``image_processes`` forks worker processes (default — the
        decode+resize stack holds the GIL through its numpy inner loops,
        so threads cap out near 1.2x); False uses threads.  Output is
        bit-identical regardless of worker count or pool kind — rows are
        written in order (tests/test_train_e2e.py::test_parallel_image_prep
        _bit_identical)."""
        self.cfg = cfg
        self.data_cfg = cfg.data
        with open(splits_captions_json_path) as f:
            self.data = json.load(f)
        with open(entity_context_path, "rb") as f:
            self.entity_contexts = pickle.load(f)
        self.knowledge_contexts = None
        if knowledge_context_path is not None:
            with open(knowledge_context_path, "rb") as f:
                self.knowledge_contexts = pickle.load(f)
        self.image_dir = image_dir
        self.output_dir = output_dir
        self.wordmap_file_path = wordmap_file_path
        self.update_wordmap = update_wordmap
        self.rng = random.Random(seed) if seed is not None else random
        if image_workers is None:
            image_workers = min(8, os.cpu_count() or 1)
        self.image_workers = max(1, image_workers)
        self.image_processes = image_processes
        os.makedirs(output_dir, exist_ok=True)

    # -- wordmap --------------------------------------------------------

    def build_wordmap(self) -> codec.Wordmap:
        if self.wordmap_file_path and not self.update_wordmap:
            with open(self.wordmap_file_path) as f:
                wm = codec.Wordmap(json.load(f))
        else:
            extra: List[str] = []
            if self.data_cfg.fold_entity_names_into_wordmap:
                # news folds processed entity-name words into the counts
                # (news create_input_files.py:381-387)
                for ctx in self.entity_contexts.values():
                    if not hasattr(ctx, "columns") or "name_processed" not in ctx.columns:
                        continue
                    names = set(ctx["name_processed"])
                    extra.extend(
                        piece
                        for name in names
                        for piece in name.split("_")
                        if len(piece)
                    )
            wm = codec.build_wordmap(
                self.data["images"],
                self.data_cfg.min_word_freq,
                self.data_cfg.split_tokens_on_underscore,
                extra,
            )
            if self.wordmap_file_path and self.update_wordmap:
                # merge a precompiled wordmap's words behind the fresh ones
                # (reference: geo-aware/create_input_files.py:303-310)
                with open(self.wordmap_file_path) as f:
                    existing = json.load(f)
                ordered = [
                    w for w, _ in sorted(wm.word_to_id.items(), key=lambda kv: kv[1])
                    if w not in (codec.Wordmap.UNK, codec.Wordmap.START,
                                 codec.Wordmap.END, codec.Wordmap.PAD)
                ]
                wm = codec.Wordmap.from_words(
                    codec.update_wordmap(existing, ordered)
                )
        path = os.path.join(
            self.output_dir, f"WORDMAP_{self.data_cfg.base_name}.json"
        )
        with open(path, "w") as f:
            json.dump(wm.to_json_dict(), f)
        return wm

    # -- per-image packing ----------------------------------------------

    def _context_rows(self, table):
        """Accept either a pandas DataFrame or a list of dicts."""
        if hasattr(table, "to_dict"):
            return table.to_dict("records")
        return list(table)

    def pack_image(self, img: dict, wm: codec.Wordmap) -> Dict:
        dc = self.data_cfg
        is_news = self.cfg.model.variant == "news"
        normalizer = None if is_news else codec.normalize_name_geo
        # context lookup key: the news dataset keys its entity/knowledge
        # contexts by ARTICLE id (img["item"],
        # news-knowledge-aware/create_input_files.py:165) while geo/
        # knowledge key by image url (geo-aware/create_input_files.py:151).
        # Fall back to "url" so url-keyed news datasets (synthetic
        # fixtures) still pack.
        ckey = img["item"] if is_news and "item" in img else img["url"]
        ent_feats, ent_names = context.pack_context(
            self._context_rows(self.entity_contexts[ckey]),
            name_key=dc.name_col,
            feature_keys=list(dc.entity_feature_cols),
            random_ranges=list(dc.entity_random_ranges),
            context_size=dc.entity_context_size,
            unk_token=codec.UNK_ENT,
            normalizer=normalizer,
            wordmap=wm,
            pack_name_word_ids=dc.pack_name_word_ids,
            truncate_input=is_news,
            rng=self.rng,
        )
        fact_feats = fact_names = None
        if self.knowledge_contexts is not None:
            fact_feats, fact_names = context.pack_context(
                self._context_rows(self.knowledge_contexts[ckey]),
                name_key="object",
                feature_keys=list(dc.fact_feature_cols),
                random_ranges=list(dc.fact_random_ranges),
                context_size=dc.fact_context_size,
                unk_token=codec.UNK_FACT,
                normalizer=normalizer,
                truncate_input=is_news,
                rng=self.rng,
            )
        ids, mask, length = context.encode_caption(
            img["tokens"], img["mask"], wm, ent_names,
            max_len=dc.max_caption_len,
            fact_names=fact_names, fact_features=fact_feats,
            entity_context_size=dc.entity_context_size,
            length_is_padded=self.knowledge_contexts is not None,
        )
        path = os.path.join(self.image_dir, img["id"])
        if not os.path.exists(path):
            path += ".jpg"
        out = {
            "split": img["split"].upper(),
            "image_path": path,
            "caption": ids,
            "caption_mask": mask,
            "caption_length": length,
            "entity_features": ent_feats,
            "entity_names": ent_names,
        }
        if fact_feats is not None:
            out["facts"] = fact_feats
            out["fact_names"] = fact_names
        return out

    # -- the full run ---------------------------------------------------

    def run(self):
        import h5py

        dc = self.data_cfg
        wm = self.build_wordmap()
        per_split = {s: [] for s in SPLITS}
        for img in self.data["images"]:
            if len(img["tokens"]) > dc.max_caption_len:
                continue
            packed = self.pack_image(img, wm)
            per_split[packed["split"]].append(packed)

        base = dc.base_name
        for split in SPLITS:
            records = per_split[split]
            h5_path = os.path.join(self.output_dir, f"{split}_IMAGES_{base}.hdf5")
            if os.path.exists(h5_path):
                os.remove(h5_path)
            with h5py.File(h5_path, "w") as h:
                dset = h.create_dataset(
                    "images",
                    (len(records), 3, dc.img_size, dc.img_size),
                    dtype="float16",
                )
                from functools import partial

                from icek_torch import native

                # build the native resize library (if available) BEFORE
                # forking workers, so children inherit it instead of racing
                # to compile it.
                native.resize_available()

                for i, arr in enumerate(
                    _bounded_ordered_map(
                        partial(images.read_and_resize, size=dc.img_size),
                        [rec["image_path"] for rec in records],
                        self.image_workers,
                        processes=self.image_processes,
                    )
                ):
                    dset[i] = arr

            def dump_json(kind, key):
                with open(
                    os.path.join(self.output_dir, f"{split}_{kind}_{base}.json"), "w"
                ) as f:
                    json.dump([rec[key] for rec in records], f)

            def dump_pkl(kind, key):
                with open(
                    os.path.join(self.output_dir, f"{split}_{kind}_{base}.pkl"), "wb"
                ) as f:
                    pickle.dump([rec[key] for rec in records], f)

            dump_json("CAPTIONS", "caption")
            dump_json("CAPLENS", "caption_length")
            dump_json("CAPMASKS", "caption_mask")
            dump_pkl("ENT_FEATURES", "entity_features")
            dump_pkl("ENT_NAMES", "entity_names")
            if self.knowledge_contexts is not None:
                dump_pkl("FACTS", "facts")
                dump_pkl("FACT_NAMES", "fact_names")
        return wm
