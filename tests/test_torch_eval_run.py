"""The offline eval run: JAX ``Evaluator.run`` and the port's on the same
TEST split (written by icek_tpu's InputFileWriter, read by each package's
own CaptionDataset) with the same weights, f32 on the CPU, for the geo and
knowledge presets (news: ``test_torch_eval_news.py``).  Captions and masks
must be equal, and so must the CSV bytes (pandas in JAX, the stdlib csv
module in the port), the knowledge preset's random-fact CSV, the
fact-accuracy reports and the Jensen-Shannon results.  The JAX oracle runs
once per preset in a module fixture.
"""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import eval_driver as tev
from test_torch_common import eval_run, eval_split, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module", params=["geo", "knowledge"])
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    s = eval_split(tmp, request.param)
    return s, eval_run(s, "jax", tmp), eval_run(s, "port", tmp)


def test_run_captions_and_masks_match_jax(runs):
    s, want, got = runs
    assert got["res"]["captions"] == want["res"]["captions"]
    assert got["res"]["masks"] == want["res"]["masks"]
    assert len(got["res"]["captions"]) == 5
    kinds = {k for m in got["res"]["masks"] for k in m}
    assert 1 in kinds                                     # entity ids decoded
    if s["has_facts"]:
        assert 2 in kinds                                 # and fact ids


def test_run_csv_bytes_match_jax(runs):
    s, want, got = runs
    names = {"generated_captions.csv"}
    if s["variant"] == "knowledge":
        names.add("generated_captions_random_facts.csv")
    assert set(got["files"]) == set(want["files"]) == names
    for name in names:
        assert got["files"][name] == want["files"][name], name
    assert got["files"]["generated_captions.csv"].startswith(b"generated_caption\n")


def test_run_metrics_and_logs_match_jax(runs):
    s, want, got = runs
    assert got["lines"] == want["lines"]
    if s["variant"] == "geo":
        assert got["res"]["js"] == want["res"]["js"]
        assert got["js"].generated == want["js"].generated
        assert got["js"].random_baseline == want["js"].random_baseline
        assert any(v["n_occurrences"] for v in got["js"].generated.values())
    else:
        for key in ("random_baseline", "fact_accuracy", "fact_accuracy_random"):
            assert got["res"][key] == want["res"][key], key
        acc = got["res"]["fact_accuracy"]
        assert acc["n_temporal"] + acc["n_other"] > 0
        assert len(got["res"]["random_baseline"]) == 5
        assert "KNOWLEDGE-AWARE:" in "".join(got["lines"])


@pytest.mark.parametrize("n,batch", [(5, 2), (2, 2), (1, 4), (3, 8), (8, 8)])
def test_pad_batch_matches_jax(n, batch):
    from icek_tpu.eval_driver import _pad_batch

    idx = np.arange(10, 10 + n)
    got = tev._pad_batch(idx, batch)
    np.testing.assert_array_equal(got, _pad_batch(idx, batch))
    assert len(got) == max(n, batch) and (got[n:] == idx[-1]).all()


def test_random_fact_caption_matches_jax():
    from icek_tpu.data import codec as jcodec
    from icek_tpu.eval_driver import _random_fact_caption

    rows = np.array([[0, len(n)] + jcodec.encode_name(n)
                     for n in ("1923", "castle", "tower", "1894", "<pad>")], np.int64)
    tokens = ["built", "in", "castle", ".", "in", "1923", ".", "see", "tower"]
    kinds = [0, 0, 2, 0, 0, 2, 0, 0, 2]
    table = {"builtIn": ["castle", "tower"], "height": ["tower", "spire"]}
    for seed in range(4):
        assert tev._random_fact_caption(tokens, kinds, rows, table, random.Random(seed)) == \
            _random_fact_caption(tokens, kinds, rows, table, random.Random(seed))


def test_trim_lockstep_matches_jax():
    from icek_torch.decode import detok as tdetok
    from icek_tpu.decode import detok as jdetok

    cases = [("a house . near a lake . with trees", "a house . near 1990 . with facts"),
             ("a house . near a lake . with trees", "a . b . c ."),
             ("a house . near a lake .", "a barn . by 1990 . and more"),
             ("one sentence", "x . y")]
    for leader, follower in cases:
        assert tdetok.trim_lockstep(leader, follower) == jdetok.trim_lockstep(leader, follower)


def _geo_wordmap():
    words = ["a", "the", "of", "near", "in", "across", "along", "north_of",
             "south_of", "east_of", "west_of", "bridge", "stands"]
    wm = {w: i + 1 for i, w in enumerate(words)}
    wm["<unk>"] = len(wm) + 1
    wm["<start>"] = len(wm) + 1
    wm["<end>"] = len(wm) + 1
    wm["<pad>"] = 0
    return wm


def test_js_geo_accumulation_matches_jax():
    """The crafted sequences of tests/test_metrics.py's reference check,
    through the port's JSGeoMetric and icek_tpu's, with seeded RNGs."""
    from icek_torch.data.codec import encode_name
    from icek_torch.metrics.js_geo import JSGeoMetric
    from icek_tpu.metrics import js_geo as jjs
    from test_torch_common import BINS_AZIMUTH, BINS_DISTANCE, OSM_TYPES, _train_distributions

    wm = _geo_wordmap()
    V, E = len(wm), 4
    names = np.array([[i, len(n)] + encode_name(n) for i, n in
                      enumerate(["tower_bridge", "river_thames", "old_town", "<unk_ent>"])])
    feats = np.zeros((E, 5), dtype=np.float32)
    feats[:, 0] = np.arange(E)
    feats[:, 1] = [0.05, 0.5, 1.2, 0.3]
    feats[:, 2] = [10.0, -100.0, 170.0, 0.0]
    feats[:, 4] = [3, 7, 100, 2]
    seqs = [
        [wm["bridge"], wm["near"], V + 0, wm["stands"]],
        [wm["bridge"], wm["north_of"], wm["the"], V + 1],
        [wm["across"], wm["of"], wm["the"], V + 2],
        [wm["in"], V + 3],            # unk_ent -> skipped
        [wm["along"], V + 1, V + 0],  # entity after entity -> only first
    ]
    metrics = [cls(wm, BINS_DISTANCE, BINS_AZIMUTH, OSM_TYPES,
                   train_distributions=_train_distributions(), print_metrics=False,
                   rng=random.Random(0))
               for cls in (jjs.JSGeoMetric, JSGeoMetric)]
    for m in metrics:
        for seq in seqs:
            m.run(seq, feats, names)
    want, got = metrics
    assert got.generated == want.generated
    assert got.random_baseline == want.random_baseline
    assert sum(v["n_occurrences"] for v in got.generated.values()) == 4
    assert got.results() == want.results()
    p, q = [0.2, 0.3, 0.5], [0.4, 0.4, 0.2]
    assert JSGeoMetric.js_distance(p, q) == jjs.JSGeoMetric.js_distance(p, q)


def test_fact_accuracy_matches_jax(tmp_path):
    """The crafted captions of tests/test_metrics.py's reference check,
    through the port's FactAccuracyMetric and icek_tpu's."""
    pd = pytest.importorskip("pandas")
    import json
    import pickle

    from icek_torch.metrics import fact_accuracy as tfa
    from icek_tpu.metrics import fact_accuracy as jfa
    from test_torch_common import PREDICATE_PHRASES

    url = "http://example.com/1"
    images = [{"tokens": ["the", "tower_bridge", "built", "in", "1894"],
               "mask": [0, 1, 0, 0, 2], "url": url, "id": f"img{i}", "split": "test"}
              for i in range(4)]
    entities = {url: pd.DataFrame({"name": ["Tower Bridge", "River Thames"],
                                   "distance": [0.1, 0.2], "azimuth": [0.0, 1.0],
                                   "size": [0.1, 0.1], "type_index": [1, 2]})}
    knowledge = {url: pd.DataFrame({"subject": ["Tower Bridge", "Tower Bridge", "River Thames"],
                                    "predicate": ["built", "architect", "length"],
                                    "object": ["1894", "horace_jones", "215_miles"]})}
    paths = [tmp_path / n for n in ("captions_split.json", "entities.pkl", "knowledge.pkl")]
    paths[0].write_text(json.dumps({"images": images}))
    paths[1].write_bytes(pickle.dumps(entities))
    paths[2].write_bytes(pickle.dumps(knowledge))
    metrics = [mod.FactAccuracyMetric(*map(str, paths), {}, {"bridge": ["architect"]},
                                      PREDICATE_PHRASES) for mod in (jfa, tfa)]
    captions = ["the tower_bridge built in 1894", "the tower_bridge built in 1901",
                "a bridge near the river", "tower_bridge opened in <unk_fact>",
                "tower_bridge horace_jones"]
    for cap in captions:
        args = (cap, "the tower_bridge built in 1894", ["tower_bridge"], url)
        assert metrics[1].check_temporal(*args) == metrics[0].check_temporal(*args), cap
        assert metrics[1].check_other(cap, ["tower_bridge"], url) == \
            metrics[0].check_other(cap, ["tower_bridge"], url), cap
    text = "built in 1894 and no. 1921"
    assert tfa.extract_years(text) == jfa.extract_years(text)
    assert [tfa.is_year(t) for t in ("1894", "2020", "x", "19")] == \
        [jfa.is_year(t) for t in ("1894", "2020", "x", "19")]
    lines = ([], [])
    want = metrics[0].run(captions[:4], log=lines[0].append)
    got = metrics[1].run(captions[:4], log=lines[1].append)
    assert got == want and lines[1] == lines[0]
    assert got["n_temporal"] == 3


def test_name_codec_matches_jax():
    from icek_torch.data import codec as tcodec
    from icek_tpu.data import codec as jcodec

    for name in ("Tower Bridge", "St Paul's Cathedral", "c. 1894-05-02", "The_Shard_(London)",
                 "x" * 70, ""):
        assert tcodec.normalize_name_geo(name) == jcodec.normalize_name_geo(name)
        assert tcodec.encode_name(name) == jcodec.encode_name(name)
