"""Deterministic codecs shared by the data pipeline, eval and metrics.

Implements, with identical observable behavior to the reference:
  * fixed-width char codec for entity/fact names
    (reference: geo-aware/utils.py:152-192)
  * name normalization, DBpedia flavor (geo/knowledge,
    reference: geo-aware/utils.py:290-335) and news flavor
    (reference: news-knowledge-aware/utils.py:337-381)
  * wordmap construction (reference: geo-aware/create_input_files.py:271-319,
    news-knowledge-aware/create_input_files.py:352-410)

Names are packed as numpy int arrays so downstream batching is allocation-free.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence

import numpy as np

# ord('|') — never occurs in normalized names; strips cleanly on decode.
PAD_CHAR = 124
NAME_WIDTH = 50

UNK_ENT = "<unk_ent>"
UNK_FACT = "<unk_fact>"


def encode_name(text: str, width: int = NAME_WIDTH) -> List[int]:
    """Pack a string into `width` char codes, truncating / padding with PAD_CHAR."""
    codes = [ord(c) for c in text[:width]]
    codes.extend([PAD_CHAR] * (width - len(codes)))
    return codes


def decode_name(codes: Sequence[int], length: int) -> str:
    """Inverse of encode_name given the original string length.

    Mirrors the reference's int_to_str: emits characters until `length` is
    reached (so PAD_CHAR bytes inside the window are decoded verbatim if the
    recorded length overshoots — a quirk kept for bit-parity).
    """
    out = []
    for code in codes:
        if len(out) == length:
            break
        out.append(chr(int(code)))
    return "".join(out)


# --------------------------------------------------------------------------
# Name normalization
# --------------------------------------------------------------------------

_DATE_RE = re.compile(r"([0-9]{4})\-[0-9]{2}\-[0-9]{2}")
_CIRCA_RE = re.compile(r"c\.?\s?([0-9]{4})(\-[0-9]{2}\-[0-9]{2})?")

_GEO_REPLACEMENTS = (
    ("*", ""), ("|", ""), ("''", ""), ('""', ""), ("``", ""), ('"', ""),
    (" ", "_"), ("__", "_"), ("_&_", "_and_"),
    ("railway_station", "station"), ("tube_station", "station"),
    ("s'", "s"), ("'s", "s"), ("saint", "st"), ("st.", "st"),
)


def normalize_name_geo(name: str) -> str:
    """DBpedia-flavored canonicalization (geo + knowledge presets)."""
    name = name.lower()
    for sep in ("/", "#"):
        name = name.split(sep)[-1].strip()
    for sep in ("_(", ",", "_of_england"):
        name = name.split(sep)[0].strip()
    for old, new in _GEO_REPLACEMENTS:
        name = name.replace(old, new)
    name = name.lstrip("(").rstrip(")").lstrip("_").rstrip("_")
    if name.startswith("the_"):
        name = name[len("the_"):]
    dated = _DATE_RE.findall(name)
    if dated:
        name = dated[0]
    circa = _CIRCA_RE.findall(name)
    if circa:
        name = circa[0][0]
    return name


_NEWS_STRIP = (
    ("''", ""), ("’’", ""), ('""', ""), ("``", ""), ("“", ""), ("”", ""),
    ("|", ""), ("\n", " "), ("\r", " "), ("  ", " "), (" & ", " and "),
    ("*", ""),
)


def normalize_name_news(name: str) -> str:
    """News-flavored canonicalization (nytimes preset)."""
    name = name.lower()
    for ending in ("’s", "'s"):
        if name.endswith(ending):
            name = name[: -len(ending)]
    if name.startswith("the "):
        name = name[len("the "):]
    for old, new in _NEWS_STRIP:
        name = name.replace(old, new)
    dated = _DATE_RE.findall(name)
    if dated:
        name = dated[0]
    name = name.lstrip("(").rstrip(")").lstrip("_").rstrip("_").strip()
    name = name.replace(" ", "_").replace("__", "_")
    return name


NORMALIZERS = {"geo": normalize_name_geo, "news": normalize_name_news}


# --------------------------------------------------------------------------
# Wordmap
# --------------------------------------------------------------------------

class Wordmap:
    """Vocabulary map with the reference's fixed layout:

    ``<pad>``=0, real words 1..n, then ``<unk>``, ``<start>``, ``<end>``
    (reference: geo-aware/create_input_files.py:311-315).
    """

    PAD = "<pad>"
    UNK = "<unk>"
    START = "<start>"
    END = "<end>"

    def __init__(self, mapping: Dict[str, int]):
        self.word_to_id = dict(mapping)
        self.id_to_word = {v: k for k, v in self.word_to_id.items()}

    def __len__(self) -> int:
        return len(self.word_to_id)

    def __contains__(self, word: str) -> bool:
        return word in self.word_to_id

    def __getitem__(self, word: str) -> int:
        return self.word_to_id[word]

    def get(self, word: str, default=None):
        return self.word_to_id.get(word, default)

    @property
    def pad_id(self) -> int:
        return self.word_to_id[self.PAD]

    @property
    def unk_id(self) -> int:
        return self.word_to_id[self.UNK]

    @property
    def start_id(self) -> int:
        return self.word_to_id[self.START]

    @property
    def end_id(self) -> int:
        return self.word_to_id[self.END]

    def lookup(self, word: str) -> int:
        return self.word_to_id.get(word, self.unk_id)

    def to_json_dict(self) -> Dict[str, int]:
        return dict(self.word_to_id)

    @classmethod
    def from_words(cls, words: Sequence[str]) -> "Wordmap":
        mapping = {w: i + 1 for i, w in enumerate(words)}
        mapping[cls.UNK] = len(mapping) + 1
        mapping[cls.START] = len(mapping) + 1
        mapping[cls.END] = len(mapping) + 1
        mapping[cls.PAD] = 0
        return cls(mapping)


def update_wordmap(existing: Dict[str, int], words: List[str]) -> List[str]:
    """Merge a precompiled wordmap's words into a fresh word list, dropping
    its special tokens (reference: geo-aware/create_input_files.py:303-310).
    Returns the extended word list (new words first, then carried-over)."""
    specials = {Wordmap.UNK, Wordmap.START, Wordmap.END, Wordmap.PAD}
    present = set(words)
    return words + [
        w for w in existing if w not in specials and w not in present
    ]


def build_wordmap(
    images: Iterable[dict],
    min_word_freq: int = 0,
    split_on_underscore: bool = False,
    extra_name_tokens: Iterable[str] = (),
) -> Wordmap:
    """Count train-split caption tokens and keep those above `min_word_freq`.

    geo/knowledge count only mask==0 (vocab-word) tokens
    (reference: geo-aware/create_input_files.py:291-301); news splits every
    token on "_" and additionally folds processed entity-name words in
    (reference: news-knowledge-aware/create_input_files.py:372-391).
    """
    freq: Counter = Counter()
    for img in images:
        if img["split"] != "train":
            continue
        if split_on_underscore:
            pieces: List[str] = []
            for token in img["tokens"]:
                pieces.extend(token.split("_"))
            freq.update(pieces)
        else:
            freq.update(
                tok for i, tok in enumerate(img["tokens"]) if img["mask"][i] == 0
            )
    freq.update(extra_name_tokens)
    words = [w for w in freq if freq[w] > min_word_freq]
    return Wordmap.from_words(words)
