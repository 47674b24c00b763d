"""Corpus scoring driver: BLEU-1..4, CIDEr, METEOR, ROUGE_L over a captions
CSV vs ground truth, writing the per-caption score CSV and printing corpus
scores — the reference's compute_eval_metrics.py flow
(geo-aware/compute_eval_metrics.py:33-73).  Port of
``icek_tpu/metrics/scores.py``: the per-caption CSV is written with the
stdlib ``csv`` module in the bytes pandas' ``to_csv(index=False)`` writes
(floats as their shortest repr, QUOTE_MINIMAL, "\n" line ends)."""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence

from icek_torch.metrics.bleu import Bleu
from icek_torch.metrics.cider import Cider
from icek_torch.metrics.meteor import Meteor
from icek_torch.metrics.rouge import Rouge


def score_captions(
    true_captions: Sequence[str],
    generated_captions: Sequence[str],
    ids: Optional[Sequence] = None,
    output_csv: Optional[str] = "metric_scores_for_generated_captions.csv",
    log=print,
) -> Dict[str, float]:
    assert len(true_captions) == len(generated_captions)
    gts = [[t] for t in true_captions]
    res = [[g] for g in generated_captions]
    scorers = [
        (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (Cider(), "CIDEr"),
        (Meteor(), "METEOR"),
        (Rouge(), "ROUGE_L"),
    ]
    corpus: Dict[str, float] = {}
    per_caption: Dict[str, List[float]] = {}
    for scorer, names in scorers:
        score, scores = scorer.compute_score(gts, res)
        if isinstance(names, str):
            corpus[names] = float(score)
            per_caption[names] = list(scores)
        else:
            for i, name in enumerate(names):
                corpus[name] = float(score[i])
                per_caption[name] = list(scores[i])
    if output_csv:
        table = {k: [repr(float(v)) for v in vals] for k, vals in per_caption.items()}
        if ids is not None:
            table["id"] = list(ids)
        table["true_caption"] = list(true_captions)
        table["generated_caption"] = list(generated_captions)
        with open(output_csv, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(list(table))
            writer.writerows(zip(*table.values()))
    log("\nMetric scores:\n")
    for name, value in corpus.items():
        log("%s score is %.4f." % (name, value))
    # METEOR numbers are only comparable across environments with the same
    # match stages — record the active synonym source with the output.
    from icek_torch.metrics.meteor import synonym_stage

    log("(METEOR synonym stage: %s)" % synonym_stage())
    return corpus
