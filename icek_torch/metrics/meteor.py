"""METEOR, pure-Python implementation.

The coco-caption METEOR the reference relies on
(geo-aware/compute_eval_metrics.py:36) spawns a Java subprocess with the
full METEOR 1.5 model (synonyms/paraphrase tables).  This implementation
covers the exact-, stem-, and synonym-match stages with the standard
METEOR parameters (alpha=0.9, beta=3.0, gamma=0.5), which reproduces the
Java scorer closely on caption-style text.

Synonym-stage data sources, in resolution order (``resolve_synonyms``):
  1. a vendored WordNet lemma table at
     ``icek_torch/metrics/data/wordnet_lemmas.json.gz`` — build it once with
     ``python tools/build_wordnet_lemmas.py`` on a machine with network
     access (WordNet's license permits redistribution with notice);
  2. the nltk WordNet corpus, when installed;
  3. otherwise the stage is DISABLED — a warning is emitted the first time
     a score is computed so numbers are never silently non-comparable
     across environments, and ``synonym_stage()`` reports the active
     source for metric metadata.
METEOR 1.5's paraphrase-table stage has no open data source and remains
approximated (documented delta vs the Java scorer).
"""

from __future__ import annotations

import gzip
import json
import os
import warnings
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5

SynonymFn = Callable[[str], FrozenSet[str]]

VENDORED_LEMMAS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "wordnet_lemmas.json.gz"
)


def _vendored_synonyms() -> Optional[SynonymFn]:
    """Lookup over the vendored lemma table, or None when not built."""
    if not os.path.exists(VENDORED_LEMMAS):
        return None
    with gzip.open(VENDORED_LEMMAS, "rt") as f:
        table: Dict[str, List[str]] = json.load(f)
    empty = frozenset()
    cache: Dict[str, FrozenSet[str]] = {}

    def lookup(word: str) -> FrozenSet[str]:
        got = cache.get(word)
        if got is None:
            raw = table.get(word)
            got = cache[word] = frozenset(raw) if raw else empty
        return got

    return lookup


def _wordnet_synonyms() -> Optional[SynonymFn]:
    """nltk-WordNet-backed synonym lookup, or None when corpus data is absent."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("test")  # raises LookupError without corpus data
    except Exception:
        return None

    def lookup(word: str) -> FrozenSet[str]:
        return frozenset(
            lemma.name().lower()
            for synset in wordnet.synsets(word)
            for lemma in synset.lemmas()
        )

    return lookup


# (stage_name, SynonymFn or None); resolved lazily on first score so the
# environment is probed when scoring actually happens.
_RESOLVED: Optional[Tuple[str, Optional[SynonymFn]]] = None


def resolve_synonyms() -> Tuple[str, Optional[SynonymFn]]:
    """Resolve (and cache) the synonym source: vendored table, then nltk
    WordNet, else disabled with a one-time loud warning."""
    global _RESOLVED
    if _RESOLVED is not None:
        return _RESOLVED
    fn = _vendored_synonyms()
    if fn is not None:
        _RESOLVED = ("vendored-wordnet", fn)
        return _RESOLVED
    fn = _wordnet_synonyms()
    if fn is not None:
        _RESOLVED = ("nltk-wordnet", fn)
        return _RESOLVED
    warnings.warn(
        "METEOR synonym stage DISABLED: no WordNet data found (neither the "
        f"vendored table {VENDORED_LEMMAS} nor the nltk corpus). Scores use "
        "exact+stem matching only and are NOT comparable with "
        "synonym-enabled environments. Build the table once with "
        "`python tools/build_wordnet_lemmas.py` (needs network).",
        stacklevel=2,
    )
    _RESOLVED = ("disabled", None)
    return _RESOLVED


def synonym_stage() -> str:
    """Name of the active synonym source ('vendored-wordnet' /
    'nltk-wordnet' / 'disabled') — recorded alongside reported scores so
    METEOR numbers are attributable to their match stages."""
    return resolve_synonyms()[0]

try:
    from nltk.stem.porter import PorterStemmer

    _STEMMER = PorterStemmer()

    def _stem(w: str) -> str:
        return _STEMMER.stem(w)

except Exception:  # pragma: no cover - nltk is expected in the image
    import warnings

    warnings.warn(
        "METEOR stem stage DISABLED: nltk's PorterStemmer is unavailable, "
        "so stem matches degrade to exact matches and scores are NOT "
        "comparable with stemmer-enabled environments.",
        stacklevel=2,
    )

    def _stem(w: str) -> str:
        return w


def _align(
    cand: List[str],
    ref: List[str],
    synonyms: Optional[SynonymFn] = None,
) -> List[Tuple[int, int]]:
    """Greedy staged alignment: exact, then stem, then synonym matches."""
    matches: List[Tuple[int, int]] = []
    used_c, used_r = set(), set()
    for stage in ("exact", "stem"):
        key = (lambda w: w) if stage == "exact" else _stem
        ref_keys = {}
        for j, w in enumerate(ref):
            if j not in used_r:
                ref_keys.setdefault(key(w), []).append(j)
        for i, w in enumerate(cand):
            if i in used_c:
                continue
            slots = ref_keys.get(key(w))
            if slots:
                j = slots.pop(0)
                matches.append((i, j))
                used_c.add(i)
                used_r.add(j)
    if synonyms is not None:
        # METEOR 1.5 wn-synonymy module: unmatched words align when their
        # synset lemma sets intersect (either direction, first free slot).
        for i, w in enumerate(cand):
            if i in used_c:
                continue
            w_syn = synonyms(w) | {w}
            for j, r in enumerate(ref):
                if j in used_r:
                    continue
                if r in w_syn or w in synonyms(r):
                    matches.append((i, j))
                    used_c.add(i)
                    used_r.add(j)
                    break
    return sorted(matches)


def _chunks(matches: List[Tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (c0, r0), (c1, r1) in zip(matches, matches[1:]):
        if c1 != c0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def meteor_sentence(
    refs: Sequence[str], cand: str, synonyms: Optional[SynonymFn] = None
) -> float:
    if synonyms is None:
        synonyms = resolve_synonyms()[1]
    cand_tokens = cand.split()
    best = 0.0
    for ref in refs:
        ref_tokens = ref.split()
        matches = _align(cand_tokens, ref_tokens, synonyms)
        m = len(matches)
        if m == 0:
            continue
        precision = m / len(cand_tokens)
        recall = m / len(ref_tokens)
        fmean = precision * recall / (ALPHA * precision + (1 - ALPHA) * recall)
        frag = _chunks(matches) / m
        penalty = GAMMA * frag ** BETA
        best = max(best, fmean * (1 - penalty))
    return best


def meteor(
    references: Sequence[Sequence[str]],
    candidates: Sequence[str],
    synonyms: Optional[SynonymFn] = None,
) -> Tuple[float, List[float]]:
    scores = [
        meteor_sentence(r, c, synonyms)
        for r, c in zip(references, candidates)
    ]
    return (sum(scores) / len(scores) if scores else 0.0), scores


class Meteor:
    def compute_score(self, gts, res):
        refs = [list(r) for r in gts]
        cands = [c[0] for c in res]
        return meteor(refs, cands)
