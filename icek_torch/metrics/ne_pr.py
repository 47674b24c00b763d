"""Named-entity precision/recall (news preset).

Re-implements news-knowledge-aware/compute_eval_metrics.py:44-89: truecase
the generated and ground-truth captions, extract named entities, and score
exact and partial precision/recall plus entities-per-caption.

The reference depends on spaCy ``en_core_web_sm`` + the ``truecase``
package; neither ships in this environment, so both are optional: when
importable they are used, otherwise a deterministic fallback runs — a
capitalization-chunk NER over a dictionary-based truecaser — preserving the
metric's comparative structure.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

_WORD_RE = re.compile(r"[A-Za-z0-9'’_-]+|[.,!?;:]")

# words that commonly start sentences but are not entity content
_STOPWORDS = {
    "the", "a", "an", "of", "in", "on", "at", "to", "and", "or", "for",
    "with", "by", "from", "is", "was", "are", "were", "this", "that",
    "it", "he", "she", "they", "his", "her", "their", "its",
}


def _load_spacy_ner() -> Optional[Callable[[str], List[str]]]:
    try:
        import spacy

        nlp = spacy.load("en_core_web_sm")

        def get_entities(text: str) -> List[str]:
            return sorted({ent.text for ent in nlp(text).ents})

        return get_entities
    except Exception:
        return None


def _load_truecaser() -> Optional[Callable[[str], str]]:
    try:
        import truecase

        return truecase.get_true_case
    except Exception:
        return None


def fallback_truecase(text: str, proper_nouns: Sequence[str] = ()) -> str:
    """Capitalize sentence starts and any word in `proper_nouns`."""
    proper = {w.lower() for w in proper_nouns}
    tokens = _WORD_RE.findall(text)
    out = []
    start = True
    for tok in tokens:
        low = tok.lower()
        if low in proper or (start and low not in _STOPWORDS):
            tok = tok[:1].upper() + tok[1:]
        out.append(tok)
        start = tok in {".", "!", "?"}
    return " ".join(out)


def fallback_ner(text: str) -> List[str]:
    """Maximal runs of capitalized tokens (optionally joined by 'of'/'the'),
    plus 4-digit years — a deterministic stand-in for spaCy NER."""
    tokens = text.split()
    ents = []
    current: List[str] = []
    for i, tok in enumerate(tokens):
        bare = tok.strip(".,!?;:")
        is_cap = bool(bare) and bare[0].isupper() and not (
            i == 0 and bare.lower() in _STOPWORDS
        )
        is_year = bool(re.fullmatch(r"[12]\d{3}", bare))
        if is_cap or (current and bare.lower() in {"of", "the"} and
                      i + 1 < len(tokens) and tokens[i + 1][:1].isupper()):
            current.append(bare)
        else:
            if current:
                ents.append(" ".join(current))
                current = []
            if is_year:
                ents.append(bare)
        if tok != bare and current:        # punctuation ends the chunk
            ents.append(" ".join(current))
            current = []
    if current:
        ents.append(" ".join(current))
    # drop single stopword-ish chunks
    ents = [e for e in ents if e.lower() not in _STOPWORDS]
    return sorted(set(ents))


class NamedEntityPR:
    def __init__(self, proper_nouns: Sequence[str] = ()):
        self._spacy = _load_spacy_ner()
        self._truecase = _load_truecaser()
        self._proper = list(proper_nouns)
        if self._spacy is None or self._truecase is None:
            import warnings

            missing = [
                name
                for name, mod in (
                    ("spaCy en_core_web_sm", self._spacy),
                    ("truecase", self._truecase),
                )
                if mod is None
            ]
            warnings.warn(
                "NE precision/recall running with deterministic fallbacks "
                f"for: {', '.join(missing)}. Numbers are NOT comparable "
                "with environments where the reference's spaCy/truecase "
                "stack is installed (news-knowledge-aware/"
                "compute_eval_metrics.py:44-89).",
                stacklevel=2,
            )

    def truecase(self, text: str) -> str:
        if self._truecase is not None:
            return self._truecase(text)
        return fallback_truecase(text, self._proper)

    def entities(self, text: str) -> List[str]:
        if self._spacy is not None:
            return self._spacy(text)
        return fallback_ner(text)

    def compute(
        self,
        generated: Sequence[str],
        ground_truth: Sequence[str],
        log=print,
    ) -> Dict[str, float]:
        results: Dict[str, float] = {}
        num_unique = []
        for mode in ("exact", "partial"):
            tp = fp = fn = 0
            for gen, true in zip(generated, ground_truth):
                gen_ents = [e.lower() for e in self.entities(self.truecase(gen))]
                true_ents = [e.lower() for e in self.entities(self.truecase(true))]
                num_unique.append(len(gen_ents))
                for ent in true_ents:
                    if mode == "exact" and (ent in gen_ents or ent in gen):
                        tp += 1
                    elif mode == "partial" and (
                        any(ent in e for e in gen_ents)
                        or any(e in ent for e in gen_ents)
                        or any(tok in gen for tok in ent.split())
                    ):
                        tp += 1
                    else:
                        fn += 1
                for ent in gen_ents:
                    if mode == "exact" and ent not in true_ents and ent not in true:
                        fp += 1
                    elif mode == "partial" and (
                        not any(ent in e for e in true_ents)
                        and not any(e in ent for e in true_ents)
                        and not any(tok in true for tok in ent.split())
                    ):
                        fp += 1
            precision = tp / (tp + fp) if (tp + fp) else 0.0
            recall = tp / (tp + fn) if (tp + fn) else 0.0
            results[f"{mode}_precision"] = precision
            results[f"{mode}_recall"] = recall
            log(f"{mode.capitalize()}:")
            log(f"Precision: {precision}")
            log(f"Recall: {recall}")
        results["entities_per_caption"] = (
            sum(num_unique) / len(num_unique) if num_unique else 0.0
        )
        # Record which backends scored, so reported numbers are attributable
        # across environments (spaCy/truecase vs the deterministic fallbacks).
        results["ner_backend"] = "spacy" if self._spacy else "fallback"
        results["truecase_backend"] = "truecase" if self._truecase else "fallback"
        log(
            "Overall number of generated unique entities per caption: "
            f"{results['entities_per_caption']}"
        )
        return results
