"""The port's caption scores (``icek_torch/metrics/{bleu,cider,meteor,rouge,
scores,ne_pr}.py``) and its ``metrics`` verb against icek_tpu's: every
corpus and per-caption score of ``score_captions`` equal, the named-entity
precision / recall equal, and the CSV of ``python -m icek_torch.apps metrics``
byte-equal to apps/common.py's ``run_compute_eval_metrics`` (which reads
with pandas and writes with ``DataFrame.to_csv``) for geo and news, over a
captions CSV with fewer rows than the split, empty and "nan" captions.
"""

import csv
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("pandas")

from icek_torch import apps
from test_torch_common import make_raw_news_split
from test_train_e2e import WORDS, make_raw_dataset

GENERATED = [
    "a tower near the river", "the old bridge is in london", "", "nan",
    "tower_bridge near the river thames", "ancient ancient tower, in the city",
]


def _captions(rng, n):
    out = []
    for _ in range(n):
        out.append(" ".join(rng.choice(WORDS + ["tower_bridge", "new_york", "1999"],
                                       size=rng.integers(1, 9))))
    return out


def test_score_captions_match_jax():
    from icek_torch.metrics import scores as tscores
    from icek_tpu.metrics import scores as jscores

    rng = np.random.default_rng(0)
    truth = _captions(rng, 40)
    generated = _captions(rng, 38) + ["", truth[3]]
    logs = {"jax": [], "torch": []}
    want = jscores.score_captions(truth, generated, output_csv=None,
                                  log=logs["jax"].append)
    got = tscores.score_captions(truth, generated, output_csv=None,
                                 log=logs["torch"].append)
    assert got == want and len(got) == 7
    assert logs["torch"] == logs["jax"]
    from icek_torch.metrics import bleu, cider, meteor, rouge
    from icek_tpu.metrics import bleu as jbleu
    from icek_tpu.metrics import cider as jcider
    from icek_tpu.metrics import meteor as jmeteor
    from icek_tpu.metrics import rouge as jrouge

    gts, res = [[t] for t in truth], [[g] for g in generated]
    for mine, theirs in ((bleu.Bleu(4), jbleu.Bleu(4)), (cider.Cider(), jcider.Cider()),
                         (meteor.Meteor(), jmeteor.Meteor()), (rouge.Rouge(), jrouge.Rouge())):
        a, b = mine.compute_score(gts, res), theirs.compute_score(gts, res)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert meteor.synonym_stage() == jmeteor.synonym_stage()


def test_named_entity_pr_matches_jax():
    from icek_torch.metrics.ne_pr import NamedEntityPR
    from icek_tpu.metrics.ne_pr import NamedEntityPR as JNamedEntityPR

    truth = ["the mayor of New York in 1999", "Tower Bridge near the River Thames",
             "a photo of Paris", "the old town"]
    generated = ["mayor of new york in 1999", "the tower bridge", "a photo of London", ""]
    lines_t, lines_j = [], []
    got = NamedEntityPR().compute(generated, truth, log=lines_t.append)
    want = JNamedEntityPR().compute(generated, truth, log=lines_j.append)
    assert got == want and len(got) >= 4
    assert lines_t == lines_j


def _write_generated(path, captions):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(["generated_caption"])
        writer.writerows([c] for c in captions)


@pytest.mark.parametrize("preset", ["georic", "nytimes800k"])
def test_metrics_verb_csv_byte_equal_to_jax(preset, tmp_path, capsys):
    import sys

    from conftest import REPO_ROOT

    if str(REPO_ROOT) not in sys.path:
        sys.path.insert(0, str(REPO_ROOT))
    from apps import common as jcommon

    raw = tmp_path / "raw"
    raw.mkdir()
    if preset == "georic":
        make_raw_dataset(raw, n_images=16)
    else:
        make_raw_news_split(raw, 16)
    with open(raw / "captions_split.json") as f:
        n_test = sum(img["split"] == "test" for img in json.load(f)["images"])
    gen = tmp_path / "generated.csv"
    _write_generated(gen, GENERATED[:n_test - 1])      # one row short: padded with ""
    argv = ["--captions", str(gen), "--splits", str(raw / "captions_split.json")]
    jcommon.run_compute_eval_metrics(preset, argv + ["--output", str(tmp_path / "jax.csv")])
    jax_log = capsys.readouterr().out
    scores = apps.run_metrics(preset, argv + ["--output", str(tmp_path / "torch.csv")])
    torch_log = capsys.readouterr().out
    assert torch_log == jax_log and "Bleu_4 score is" in torch_log
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len(scores) == 7
    rows = list(csv.DictReader(open(tmp_path / "torch.csv")))
    assert len(rows) == n_test and rows[n_test - 1]["generated_caption"] == ""


def test_read_caption_column_reads_as_pandas(tmp_path):
    import pandas as pd

    path = tmp_path / "g.csv"
    _write_generated(path, GENERATED + ["NA", "null", 'with "quotes", and commas', "None"])
    want = pd.read_csv(path)["generated_caption"].fillna("").tolist()
    assert apps.read_caption_column(str(path)) == want
