"""ROUGE-L (longest-common-subsequence F-measure, beta=1.2), coco-compatible
(the reference's un-vendored `evalfunc.rouge`,
geo-aware/compute_eval_metrics.py:37)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

BETA = 1.2


def lcs_length(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(refs: Sequence[str], cand: str) -> float:
    cand_tokens = cand.split()
    precisions, recalls = [], []
    for ref in refs:
        ref_tokens = ref.split()
        lcs = lcs_length(ref_tokens, cand_tokens)
        precisions.append(lcs / len(cand_tokens) if cand_tokens else 0.0)
        recalls.append(lcs / len(ref_tokens) if ref_tokens else 0.0)
    p, r = max(precisions, default=0.0), max(recalls, default=0.0)
    if p == 0.0 and r == 0.0:
        return 0.0
    return ((1 + BETA ** 2) * p * r) / (r + BETA ** 2 * p)


def rouge_l(
    references: Sequence[Sequence[str]], candidates: Sequence[str]
) -> Tuple[float, List[float]]:
    scores = [rouge_l_sentence(refs, cand) for refs, cand in zip(references, candidates)]
    return (sum(scores) / len(scores) if scores else 0.0), scores


class Rouge:
    def compute_score(self, gts, res):
        refs = [list(r) for r in gts]
        cands = [c[0] for c in res]
        return rouge_l(refs, cands)
