"""Context packing and extended-vocabulary caption encoding (port of
``icek_tpu/data/context.py``).

The "context" for an image is a table of entities (and, for the knowledge/news
presets, facts).  It is packed to fixed shape so batches have static shapes:

  * entity features:  (E+1, 1 + n_feat)  rows are [row_idx, *features]
  * entity names:     (E+1, 2 + 50)      rows are [row_idx, name_len, 50 chars]
  * fact features:    (F+1, 3)           rows are [row_idx, subject_idx, predicate_idx]
  * fact names:       (F+1, 52)

The final row is always the <unk_ent>/<unk_fact> dummy; short contexts are
padded with randomized dummies (reference: geo-aware/utils.py:194-269,
news-knowledge-aware/utils.py:190-293).

Captions are encoded over the extended vocabulary  [0,V) words,
[V, V+E+1) entity rows, [V+E+1, V+E+1+F+1) fact rows, with a per-token
mask 0=word / 1=entity / 2=fact, including the reference's fuzzy
longest-substring matching of caption entities/facts against context names
(reference: geo-aware/create_input_files.py:186-269,
knowledge-aware/create_input_files.py:215-348).
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from icek_torch.data.codec import (
    PAD_CHAR,
    UNK_ENT,
    UNK_FACT,
    Wordmap,
    encode_name,
)


def _random_feature_row(
    row_idx: int,
    ranges: Sequence[Tuple[float, float]],
    rng: _random.Random,
    name_positions: Sequence[int] = (),
    name_copies: int = 5,
) -> List[float]:
    """One dummy feature row: [row_idx, random per-feature values].

    `name_positions` marks feature slots that normally hold packed name word
    ids; the random value is replicated `name_copies` times there (reference:
    news-knowledge-aware/utils.py:256-286).
    """
    row: List[float] = [row_idx]
    for i, (lo, hi) in enumerate(ranges):
        val = rng.randint(int(lo), int(hi)) if isinstance(lo, int) else rng.uniform(lo, hi)
        if i in name_positions:
            row.extend([val] * name_copies)
        else:
            row.append(val)
    return row


def pack_context(
    rows: Sequence[dict],
    name_key: str,
    feature_keys: Sequence[str],
    random_ranges: Sequence[Tuple[float, float]],
    context_size: int,
    unk_token: str,
    normalizer=None,
    wordmap: Optional[Wordmap] = None,
    pack_name_word_ids: bool = False,
    max_name_parts: int = 5,
    truncate_input: bool = False,
    rng: Optional[_random.Random] = None,
) -> Tuple[List[List[float]], List[List[int]]]:
    """Pack one image's context table into fixed-size feature/name lists.

    `rows` is a sequence of dicts (one per context element).  When
    `normalizer` is given, names are normalized first and empty results are
    dropped (geo/knowledge path); the news path passes pre-normalized names
    and `truncate_input=True` (its `.head(context_size)` behavior).
    Returns (features, names), each of length context_size + 1.
    """
    rng = rng or _random
    assert len(feature_keys) == len(random_ranges)
    name_positions = [
        i for i, k in enumerate(feature_keys) if pack_name_word_ids and k == name_key
    ]
    if name_positions:
        assert name_positions == [len(feature_keys) - 1], (
            "packed name ids must be the trailing feature columns"
        )

    features: List[List[float]] = []
    names: List[List[int]] = []
    source = rows[:context_size] if truncate_input else rows
    for row_i, row in enumerate(source):
        raw_name = row[name_key]
        name = normalizer(raw_name) if normalizer else raw_name
        if not len(name):
            continue
        feat: List[float] = [row_i]
        for key in feature_keys:
            if name_positions and key == name_key:
                ids = [wordmap.lookup(part) for part in name.split("_")][:max_name_parts]
                ids.extend([wordmap.pad_id] * (max_name_parts - len(ids)))
                feat.extend(ids)
            else:
                feat.append(row[key])
        features.append(feat)
        names.append([row_i, len(name)] + encode_name(name))

    if len(features) > context_size:
        features = features[:context_size]
        names = names[:context_size]
    else:
        while len(features) < context_size:
            idx = len(features)
            features.append(
                _random_feature_row(idx, random_ranges, rng, name_positions, max_name_parts)
            )
            names.append([idx, len(unk_token)] + encode_name(unk_token))
    # Trailing dummy row for out-of-context references.
    idx = len(features)
    features.append(
        _random_feature_row(idx, random_ranges, rng, name_positions, max_name_parts)
    )
    names.append([idx, len(unk_token)] + encode_name(unk_token))
    assert len(features) == context_size + 1 == len(names)
    return features, names


# --------------------------------------------------------------------------
# Name indices for caption encoding
# --------------------------------------------------------------------------

def entity_name_index(names: Sequence[Sequence[int]]) -> Dict[tuple, int]:
    """{packed-name chars -> first context row index} (dedup keeps first)."""
    index: Dict[tuple, int] = {}
    for row in names:
        key = tuple(row[2:])
        index.setdefault(key, row[0])
    return index


def fact_name_index(
    names: Sequence[Sequence[int]], features: Sequence[Sequence[float]]
) -> Dict[tuple, int]:
    """{(packed object chars, subject entity idx) -> first fact row index}."""
    index: Dict[tuple, int] = {}
    for row, feat in zip(names, features):
        key = (tuple(row[2:]), feat[1])
        index.setdefault(key, row[0])
    return index


def _strip_pad(chars: Sequence[int]) -> str:
    """Join non-pad char codes with '^' — the fuzzy-match comparison key."""
    return "^".join(str(c) for c in chars if c != PAD_CHAR)


def _native_fuzzy():
    try:
        from icek_torch import native

        if native.available():
            return native
    except Exception:
        pass
    return None


def fuzzy_lookup_entity(token: str, index: Dict[tuple, int]) -> Optional[int]:
    """Exact, then longest-substring match of a caption entity token against
    the context name index (reference: geo-aware/create_input_files.py:221-249).

    The quadratic fuzzy scan runs through the C++ extension when available
    (icek_torch/native); the pure-Python path is semantics-identical.
    """
    packed = tuple(encode_name(token))
    if packed in index:
        return index[packed]
    native = _native_fuzzy()
    if native is not None:
        keys = list(index.keys())
        row = native.fuzzy_lookup(list(packed), np.asarray(keys, dtype=np.int32))
        return index[keys[row]] if row >= 0 else None
    token_key = _strip_pad(packed)
    best_key, best_len = None, 0
    for cand in index:
        cand_key = _strip_pad(cand)
        if (cand_key in token_key or token_key in cand_key) and len(cand_key) > best_len:
            best_len = len(cand_key)
            best_key = cand
    return index[best_key] if best_key is not None else None


def fuzzy_lookup_fact(
    token: str, seen_entities: Sequence[int], index: Dict[tuple, int]
) -> Optional[int]:
    """Exact (object, seen-subject) pair, then longest-substring over facts
    whose subject has been seen (reference: knowledge-aware/create_input_files.py:291-335)."""
    packed = tuple(encode_name(token))
    hit = None
    for ent in seen_entities:
        if (packed, ent) in index:
            hit = index[(packed, ent)]
    if hit is not None:
        return hit
    native = _native_fuzzy()
    if native is not None:
        pairs = list(index.keys())
        seen = set(seen_entities)
        allowed = np.asarray(
            [1 if ent in seen else 0 for (_, ent) in pairs], dtype=np.uint8
        )
        keys = np.asarray([cand for (cand, _) in pairs], dtype=np.int32)
        row = native.fuzzy_lookup(list(packed), keys, allowed)
        return index[pairs[row]] if row >= 0 else None
    token_key = _strip_pad(packed)
    best, best_len = None, 0
    for (cand, cand_ent) in index:
        cand_key = _strip_pad(cand)
        if (
            (cand_key in token_key or token_key in cand_key)
            and cand_ent in seen_entities
            and len(cand_key) > best_len
        ):
            best_len = len(cand_key)
            best = (cand, cand_ent)
    return index[best] if best is not None else None


# --------------------------------------------------------------------------
# Caption encoding over the extended vocabulary
# --------------------------------------------------------------------------

def encode_caption(
    tokens: Sequence[str],
    token_mask: Sequence[int],
    wordmap: Wordmap,
    entity_names: Sequence[Sequence[int]],
    max_len: int,
    fact_names: Optional[Sequence[Sequence[int]]] = None,
    fact_features: Optional[Sequence[Sequence[float]]] = None,
    entity_context_size: Optional[int] = None,
    length_is_padded: bool = False,
) -> Tuple[List[int], List[int], int]:
    """Encode one caption to extended-vocab ids + a type mask + length.

    `length_is_padded` reproduces the reference divergence where the
    knowledge/news preps record the full padded length while geo records
    len(tokens) + 2 (reference: geo-aware/create_input_files.py:268 vs
    knowledge-aware/create_input_files.py:347).
    """
    ent_index = entity_name_index(entity_names)
    fact_index = (
        fact_name_index(fact_names, fact_features) if fact_names is not None else None
    )
    V = len(wordmap)
    ids = [wordmap.start_id]
    mask = [0]
    seen_entities: List[int] = []
    for pos, token in enumerate(tokens):
        kind = token_mask[pos]
        if kind == 0:
            ids.append(wordmap.lookup(token))
            mask.append(0)
        elif kind == 1:
            row = fuzzy_lookup_entity(token, ent_index)
            if row is None:
                row = ent_index[tuple(encode_name(UNK_ENT))]
            else:
                seen_entities.append(row)
            ids.append(V + row)
            mask.append(1)
        else:
            assert fact_index is not None and entity_context_size is not None
            row = fuzzy_lookup_fact(token, seen_entities, fact_index)
            if row is None:
                row = fact_index[(tuple(encode_name(UNK_FACT)), entity_context_size)]
            ids.append(V + entity_context_size + 1 + row)
            mask.append(2)
    pad_count = max_len - len(tokens)
    ids += [wordmap.end_id] + [wordmap.pad_id] * pad_count
    mask += [0] * (1 + pad_count)
    length = len(ids) if length_is_padded else len(tokens) + 2
    return ids, mask, length
