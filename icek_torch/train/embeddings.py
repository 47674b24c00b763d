"""GloVe-format embedding loading for wordmap initialization (port of
``icek_tpu/train/embeddings.py``; reference: geo-aware/utils.py:104-145)."""

from __future__ import annotations

import math

import numpy as np

from icek_torch.data.codec import Wordmap


def load_glove_embeddings(path: str, wordmap: Wordmap, emb_dim: int,
                          seed: int = 0) -> np.ndarray:
    """Scan a GloVe text file, filling rows for wordmap words; missing words
    keep the U(-sqrt(3/d), sqrt(3/d)) init (utils.py:138-145)."""
    bound = math.sqrt(3.0 / emb_dim)
    rng = np.random.default_rng(seed)
    table = rng.uniform(-bound, bound, (len(wordmap), emb_dim)).astype(np.float32)
    vocab = set(wordmap.word_to_id)
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            pieces = line.rstrip().split(" ")
            word = pieces[0]
            if word not in vocab:
                continue
            values = [float(x) for x in pieces[1:] if x and not x.isspace()]
            if len(values) == emb_dim:
                table[wordmap.word_to_id[word]] = np.asarray(values, dtype=np.float32)
    return table
