"""Seeded random models and batches at a preset's full width (no dataset
needed): what the profiling tools and ``chip_smoke.py`` drive."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

VOCAB = 10000
IMG, IMG_TOKENS = 256, 196
# training caption length a preset's benchmark uses
# (benchmarks/train_throughput.py's PRESET_SHAPES)
TRAIN_CAPTION_LEN = {"georic": 32, "k_georic": 102, "nytimes800k": 52, "georic_fast": 32}
# gains on the random entity and fact pointer heads that make a seeded fact
# preset emit entity and fact ids (at 1 it emits words only, so the seen /
# predicate state would never change)
POINTER_GAINS = {"k_georic": (1.6, 4.0), "nytimes800k": (2.5, 2.5)}


def shape(preset: str) -> dict:
    """E (stored entity rows), F (fact rows), P (predicates), L (decode
    steps), T (training caption) and D (width) of a preset."""
    from icek_torch.core import config as cfgs

    cfg = cfgs.get_config(preset)
    return dict(E=cfg.data.num_entity_rows, F=cfg.data.num_fact_rows,
                P=cfg.model.num_predicates, L=cfg.decode.max_caption_len,
                T=TRAIN_CAPTION_LEN[preset], D=cfg.model.emb_dim,
                news=cfg.model.variant == "news")


def model(preset: str = "georic", seed: int = 0, beam: int = 5, batch: int = 256,
          enc=None, geometry=None):
    """(cfg, wordmap, params, encoder params) of `preset` at full width with
    seeded random weights (V 10000).  The random batch-norm statistics
    (mean 0, var 1) let ResNet-101's activations grow through the residual
    sums; the 1x1 projection is scaled so the image tokens come out at
    order 1, as a trained encoder's do.  `enc` shares one encoder between
    presets.  A fact preset's predicate-head bias is drawn N(0, 1) (its init
    is 0, which would leave the vocab logits all 0 until a predicate is
    active), and its pointer heads are scaled by POINTER_GAINS.  `geometry`
    ("<emb_dim>x<num_heads>", as --geometry) replaces the transformer's
    width and heads (the encoder's projection follows the width)."""
    from icek_torch.core import config as cfgs
    from icek_torch.data.codec import Wordmap
    from icek_torch.models import captioner, resnet

    cfg = cfgs.get_config(preset)
    if geometry:
        cfg = cfgs.apply_geometry(cfg, geometry)
    cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, beam_size=beam,
                                                 batch_size=batch))
    wm = Wordmap.from_words([f"w{i}" for i in range(VOCAB - 5)] + ["."])
    g = torch.Generator().manual_seed(seed)
    params = captioner.init_captioner_params(g, cfg.model, len(wm))
    if cfg.model.has_facts:
        params["fc_predicate"]["b"] = torch.randn(cfg.model.emb_dim, generator=g)
        for head, gain in zip(("fc_entity", "fc_fact"), POINTER_GAINS[preset]):
            params[head]["w"] = params[head]["w"] * gain
    if enc is None:
        enc = resnet.init_resnet101(g, cfg.model.emb_dim)
        enc["proj"]["w"] = enc["proj"]["w"] * 3e-6
    return cfg, wm, params, enc


def entity_rows(rng, n, preset="georic"):
    """Packed entity rows: geo and knowledge (n, E, 5) [row_idx, dist, az,
    size, type]; news (n, E, 10) [row_idx, count, in_headline,
    in_first_paragraph, type, five name word ids]."""
    s = shape(preset)
    E = s["E"]
    if s["news"]:
        ents = np.zeros((n, E, 10), np.float32)
        ents[:, :, 1] = rng.integers(0, 10, (n, E))
        ents[:, :, 2:4] = rng.integers(0, 2, (n, E, 2))
        ents[:, :, 4] = rng.integers(0, 20, (n, E))
        ents[:, :, 5:] = rng.integers(5, VOCAB, (n, E, 5))
    else:
        ents = np.zeros((n, E, 5), np.float32)
        ents[:, :, 1] = rng.uniform(0, 1, (n, E))
        ents[:, :, 2] = rng.uniform(-179, 179, (n, E))
        ents[:, :, 3] = rng.uniform(0, 0.1, (n, E))
        ents[:, :, 4] = rng.integers(0, 500, (n, E))
    ents[:, :, 0] = np.arange(E)
    return ents


def fact_rows(rng, n, preset):
    """(n, F, 3) fact rows [row_idx, subject row, predicate]: a quarter to all
    of the rows are real facts on the real entity rows, the rest padding
    facts on the <unk_ent> dummy row E - 1 with predicate 0."""
    s = shape(preset)
    E, F = s["E"], s["F"]
    facts = np.zeros((n, F, 3), np.float32)
    facts[:, :, 0] = np.arange(F)
    facts[:, :, 1] = rng.integers(0, E - 1, (n, F))
    facts[:, :, 2] = rng.integers(0, s["P"], (n, F))
    real = rng.integers(F // 4, F, (n,))
    pad = np.arange(F)[None, :] >= real[:, None]
    facts[:, :, 1][pad] = E - 1
    facts[:, :, 2][pad] = 0
    return facts


def decode_batch(rng, n, preset="georic", img=IMG):
    """n rows of stored f16 CHW images (img x img) with their entity (and
    fact) rows."""
    batch = {"entity_features": entity_rows(rng, n, preset),
             "raw_images": rng.random((n, 3, img, img), dtype=np.float32).astype(np.float16)}
    if shape(preset)["F"]:
        batch["fact_features"] = fact_rows(rng, n, preset)
    return batch


def train_captions(rng, n, wm, preset="georic"):
    """Captions of T tokens (<start>, words, a few entity ids >= V and, with
    facts, fact ids >= V + E, <end>, <pad> tail) with their kinds and
    lengths."""
    s = shape(preset)
    T, E, F = s["T"], s["E"], s["F"]
    caps = rng.integers(5, VOCAB - 5, (n, T)).astype(np.int64)
    ent = rng.random((n, T)) < 0.08
    caps[ent] = VOCAB + rng.integers(0, E, int(ent.sum()))
    if F:
        fact = rng.random((n, T)) < 0.04
        caps[fact] = VOCAB + E + rng.integers(0, F, int(fact.sum()))
    lengths = rng.integers(8, T + 1, (n,))
    caps[:, 0] = wm.start_id
    for b in range(n):
        caps[b, lengths[b] - 1] = wm.end_id
        caps[b, lengths[b]:] = wm.pad_id
    kind = (caps >= VOCAB).astype(np.int64) + (caps >= VOCAB + E)
    return {"caption_ids": caps, "caption_mask": kind, "lengths": lengths.astype(np.int64)}


def train_batch(rng, n, wm, preset="georic", D=None):
    """train_captions with entity (and fact) rows and cached image tokens
    of width `D` (default: the preset's)."""
    batch = train_captions(rng, n, wm, preset)
    batch["entity_features"] = entity_rows(rng, n, preset)
    batch["image_tokens"] = rng.standard_normal((n, IMG_TOKENS, D or shape(preset)["D"]),
                                                dtype=np.float32)
    if shape(preset)["F"]:
        batch["fact_features"] = fact_rows(rng, n, preset)
    return batch
