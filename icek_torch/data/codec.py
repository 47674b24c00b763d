"""The codec pieces detokenization and the eval metrics need (port's copy
of parts of ``icek_tpu/data/codec.py``): the unknown-name markers, the
fixed-width char codec of entity/fact names, the DBpedia-flavored name
normalization and the wordmap."""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

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
    """Char codes -> string, emitting characters until `length` is reached
    (the reference's int_to_str, geo-aware/utils.py:152-192)."""
    out = []
    for code in codes:
        if len(out) == length:
            break
        out.append(chr(int(code)))
    return "".join(out)


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

    @property
    def pad_id(self) -> int:
        return self.word_to_id[self.PAD]

    @property
    def start_id(self) -> int:
        return self.word_to_id[self.START]

    @property
    def end_id(self) -> int:
        return self.word_to_id[self.END]

    @classmethod
    def from_words(cls, words: Sequence[str]) -> "Wordmap":
        mapping = {w: i + 1 for i, w in enumerate(words)}
        mapping[cls.UNK] = len(mapping) + 1
        mapping[cls.START] = len(mapping) + 1
        mapping[cls.END] = len(mapping) + 1
        mapping[cls.PAD] = 0
        return cls(mapping)
