"""Extended-vocab id sequences -> caption text (port of
``icek_tpu/decode/detok.py`` over the port's own codec).

Mirrors the reference eval decode rules (geo-aware/eval.py:86-113,
knowledge-aware/eval.py:103-171): word ids via the reverse wordmap
(skipping <start>/<end>/<pad>), entity/fact ids via the packed char-coded
name tables, out-of-range ids as <unk_ent>/<unk_fact>, then the
trailing-incomplete-sentence trim.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from icek_torch.data.codec import UNK_ENT, UNK_FACT, Wordmap, decode_name


def name_from_row(row: Sequence[int]) -> str:
    return decode_name([int(c) for c in row[2:]], int(row[1]))


def detokenize(
    seq: Sequence[int],
    wordmap: Wordmap,
    entity_names: np.ndarray,              # (E, 52)
    fact_names: Optional[np.ndarray] = None,
) -> Tuple[List[str], List[int]]:
    """Returns (tokens, per-token kind mask 0/1/2)."""
    V = len(wordmap)
    E = len(entity_names)
    skip = {wordmap.start_id, wordmap.end_id, wordmap.pad_id}
    tokens: List[str] = []
    kinds: List[int] = []
    for raw in seq:
        idx = int(raw)
        if idx >= V and idx < V + E:
            tokens.append(name_from_row(entity_names[idx - V]))
            kinds.append(1)
        elif idx >= V + E:
            if fact_names is None:
                tokens.append(UNK_ENT)
                kinds.append(1)
                continue
            fact_idx = idx - V - E
            if fact_idx >= len(fact_names):
                tokens.append(UNK_FACT)
            else:
                tokens.append(name_from_row(fact_names[fact_idx]))
            kinds.append(2)
        elif idx not in skip:
            tokens.append(wordmap.id_to_word[idx])
            kinds.append(0)
    return tokens, kinds


def trim_trailing_sentence(caption: str) -> str:
    """Drop an unterminated final sentence (geo-aware/eval.py:112-113)."""
    if not caption.endswith(".") and caption.count(".") > 1:
        return ".".join(caption.split(".")[:-1]) + "."
    return caption


def trim_lockstep(leader: str, follower: str) -> str:
    """Trim `follower`'s last sentence iff `leader` needs trimming: the
    random-fact baseline caption follows the main caption's trim
    (knowledge-aware/eval.py:169-172)."""
    if not leader.endswith(".") and leader.count(".") > 1:
        return ".".join(follower.split(".")[:-1]) + "."
    return follower


def caption_text(
    seq: Sequence[int],
    wordmap: Wordmap,
    entity_names: np.ndarray,
    fact_names: Optional[np.ndarray] = None,
) -> Tuple[str, List[int]]:
    tokens, kinds = detokenize(seq, wordmap, entity_names, fact_names)
    return trim_trailing_sentence(" ".join(tokens)), kinds
