"""CIDEr (Consensus-based Image Description Evaluation), coco-compatible.

TF-IDF-weighted n-gram (n=1..4) cosine similarity between candidate and
references with a gaussian length penalty (sigma=6), averaged over n and
references, scaled by 10 — the scorer the reference imports from the
un-vendored coco-caption `evalfunc` (geo-aware/compute_eval_metrics.py:35).
Document frequencies are computed over the evaluation corpus's reference
sets (coco "corpus" mode).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

MAX_N = 4
SIGMA = 6.0


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _count_all(sentence: str) -> List[Counter]:
    tokens = sentence.split()
    return [_ngrams(tokens, n) for n in range(1, MAX_N + 1)]


def _tfidf_vec(counts: List[Counter], doc_freq: Dict[tuple, float], log_n: float):
    vecs = []
    norms = []
    length = 0
    for n, cnt in enumerate(counts):
        vec = {}
        norm_sq = 0.0
        for gram, c in cnt.items():
            df = math.log(max(doc_freq.get(gram, 0.0), 1.0))
            idf = log_n - df
            val = float(c) * idf
            vec[gram] = val
            norm_sq += val * val
            if n == 0:
                length += c
        vecs.append(vec)
        norms.append(math.sqrt(norm_sq))
    return vecs, norms, length


def cider_score(
    references: Sequence[Sequence[str]], candidates: Sequence[str]
) -> Tuple[float, List[float]]:
    assert len(references) == len(candidates)
    # document frequency over reference sets
    doc_freq: Dict[tuple, float] = defaultdict(float)
    ref_counts_all = []
    for refs in references:
        counts_per_ref = [_count_all(r) for r in refs]
        ref_counts_all.append(counts_per_ref)
        seen = set()
        for counts in counts_per_ref:
            for cnt in counts:
                seen.update(cnt.keys())
        for gram in seen:
            doc_freq[gram] += 1.0
    log_n = math.log(max(len(candidates), 1e-12))

    scores: List[float] = []
    for refs_counts, cand in zip(ref_counts_all, candidates):
        cand_vec, cand_norm, cand_len = _tfidf_vec(
            _count_all(cand), doc_freq, log_n
        )
        agg = 0.0
        for ref_counts in refs_counts:
            ref_vec, ref_norm, ref_len = _tfidf_vec(ref_counts, doc_freq, log_n)
            delta = float(cand_len - ref_len)
            sim_total = 0.0
            for n in range(MAX_N):
                # clipped dot product (min of candidate count-weight, ref weight)
                dot = 0.0
                for gram, val in cand_vec[n].items():
                    dot += min(val, ref_vec[n].get(gram, 0.0)) * ref_vec[n].get(
                        gram, 0.0
                    )
                if cand_norm[n] > 0 and ref_norm[n] > 0:
                    sim = dot / (cand_norm[n] * ref_norm[n])
                else:
                    sim = 0.0
                sim *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
                sim_total += sim
            agg += sim_total / MAX_N
        scores.append(10.0 * agg / max(len(refs_counts), 1))
    mean = sum(scores) / len(scores) if scores else 0.0
    return mean, scores


class Cider:
    def compute_score(self, gts, res):
        refs = [list(r) for r in gts]
        cands = [c[0] for c in res]
        return cider_score(refs, cands)
