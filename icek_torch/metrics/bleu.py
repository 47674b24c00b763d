"""Corpus BLEU-1..4, compatible with the coco-caption scorer the reference
shells out to (geo-aware/compute_eval_metrics.py:4-8, 33-38; the reference
does NOT vendor it — this framework does).

Algorithm: clipped modified n-gram precision accumulated corpus-wide, the
"closest" reference-length rule for the brevity penalty, and the standard
coco epsilon constants so scores agree with the original to float precision.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

TINY = 1e-15
SMALL = 1e-9


def ngram_counts(tokens: Sequence[str], max_n: int = 4) -> Dict[tuple, int]:
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


def _closest_ref_len(ref_lens: List[int], test_len: int) -> int:
    return min(ref_lens, key=lambda r: (abs(r - test_len), r))


def corpus_bleu(
    references: Sequence[Sequence[str]],
    candidates: Sequence[str],
    max_n: int = 4,
) -> Tuple[List[float], List[List[float]]]:
    """references[i] is a list of reference strings for candidate i.

    Returns (corpus scores [bleu_1..bleu_n], per-sentence scores lists).
    Sentence-level scores use the coco convention (each sentence scored as a
    one-item corpus with its own brevity penalty).
    """
    assert len(references) == len(candidates)
    total_correct = [0] * max_n
    total_guess = [0] * max_n
    test_len_sum = 0
    ref_len_sum = 0
    per_sentence: List[List[float]] = [[] for _ in range(max_n)]

    for refs, cand in zip(references, candidates):
        cand_tokens = cand.split()
        ref_token_lists = [r.split() for r in refs]
        cand_counts = ngram_counts(cand_tokens, max_n)
        max_ref: Counter = Counter()
        for ref_tokens in ref_token_lists:
            for gram, cnt in ngram_counts(ref_tokens, max_n).items():
                if cnt > max_ref[gram]:
                    max_ref[gram] = cnt
        correct = [0] * max_n
        guess = [0] * max_n
        for gram, cnt in cand_counts.items():
            n = len(gram) - 1
            guess[n] += cnt
            correct[n] += min(cnt, max_ref.get(gram, 0))
        test_len = len(cand_tokens)
        ref_len = _closest_ref_len([len(r) for r in ref_token_lists], test_len)
        test_len_sum += test_len
        ref_len_sum += ref_len
        for n in range(max_n):
            total_correct[n] += correct[n]
            total_guess[n] += guess[n]
        # sentence-level
        s_log = 0.0
        ratio = (test_len + TINY) / (ref_len + SMALL)
        bp = 1.0 if ratio >= 1.0 else _safe_exp(1.0 - 1.0 / ratio)
        for n in range(max_n):
            p = float(correct[n] + TINY) / (guess[n] + SMALL)
            s_log += _safe_log(p)
            per_sentence[n].append(_safe_exp(s_log / (n + 1)) * bp)

    corpus: List[float] = []
    log_sum = 0.0
    ratio = (test_len_sum + TINY) / (ref_len_sum + SMALL)
    bp = 1.0 if ratio >= 1.0 else _safe_exp(1.0 - 1.0 / ratio)
    for n in range(max_n):
        p = float(total_correct[n] + TINY) / (total_guess[n] + SMALL)
        log_sum += _safe_log(p)
        corpus.append(_safe_exp(log_sum / (n + 1)) * bp)
    return corpus, per_sentence


def _safe_log(x: float) -> float:
    import math

    return math.log(max(x, TINY))


def _safe_exp(x: float) -> float:
    import math

    return math.exp(min(x, 700.0))


class Bleu:
    """coco-caption-shaped interface: compute_score(gts, res) where both are
    lists of lists of strings aligned by index."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts, res):
        refs = [list(r) for r in gts]
        cands = [c[0] for c in res]
        corpus, per_sentence = corpus_bleu(refs, cands, self.n)
        return corpus, per_sentence
