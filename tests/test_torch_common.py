"""Shared fixtures for the PyTorch-port tests, and the port's config copy
held against the JAX package's presets.

The helpers build one small geo configuration in both packages, JAX
params from a fixed key (handed to the port as numpy through the
bridge), and entity rows from a numpy seed, so each test feeds the same
inputs to the JAX function and its port.
"""

import dataclasses
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import bridge
from icek_torch.core import config as tcfg


def small_cfgs(emb_dim=16, num_heads=2, ffn=24, layers=2, type_vocab=20,
               max_len=7):
    """(jax Config, port Config) for a small geo model."""
    from icek_tpu.core import config as jcfg

    kw = dict(emb_dim=emb_dim, num_heads=num_heads, decoder_ffn_dim=ffn,
              encoder_ffn_dim=ffn, num_layers=layers, type_vocab=type_vocab,
              dropout_dec=0.0, dropout_enc=0.0, dropout_pos=0.0)
    out = []
    for mod in (jcfg, tcfg):
        base = mod.georic()
        out.append(base.replace(
            model=dataclasses.replace(base.model, **kw),
            decode=dataclasses.replace(base.decode, max_caption_len=max_len),
        ))
    return tuple(out)


def jax_params_numpy(jax_model_cfg, vocab, seed=0):
    """JAX captioner params from PRNGKey(seed), as a numpy tree."""
    from icek_tpu.models import captioner

    params = captioner.init_captioner_params(
        jax.random.PRNGKey(seed), jax_model_cfg, vocab)
    return jax.tree.map(np.asarray, params)


def both_params(jax_cfg, port_cfg, vocab, seed=0):
    """(JAX params, port params) holding the same values."""
    tree = jax_params_numpy(jax_cfg.model, vocab, seed)
    return jax.tree.map(jax.numpy.asarray, tree), bridge.from_jax_params(
        tree, port_cfg.model, vocab)


def entity_rows(rng, B, E, type_vocab):
    """(B, E, 5) packed geo entity rows [row_idx, dist, az, size, type]."""
    ents = np.zeros((B, E, 5), np.float32)
    ents[:, :, 0] = np.arange(E)
    ents[:, :, 1] = rng.uniform(0, 1, (B, E))
    ents[:, :, 2] = rng.uniform(-179, 179, (B, E))
    ents[:, :, 3] = rng.uniform(0, 0.1, (B, E))
    ents[:, :, 4] = rng.integers(0, type_vocab, (B, E))
    return ents


DECODE_CASES = {
    # name: (cfg kwargs, V, E, B, image tokens, max_len, entity-head gain)
    "tiny": (dict(emb_dim=16, num_heads=2, ffn=24), 30, 5, 2, 8, 7, 1.0),
    # a stronger entity pointer head, so entity ids (>= V) get emitted
    "wide": (dict(emb_dim=40, num_heads=4, ffn=64), 60, 9, 3, 12, 10, 6.0),
}


def decode_contexts(case, seed):
    """The same decode inputs for both packages: configs, params, the
    prepared decode contexts and the special ids of DECODE_CASES[case]."""
    import jax.numpy as jnp
    from icek_torch.decode import greedy as tgreedy
    from icek_tpu.decode import greedy as jgreedy

    kw, V, E, B, P, L, gain = DECODE_CASES[case]
    jc, tc = small_cfgs(**kw, max_len=L)
    tree = jax_params_numpy(jc.model, V, seed)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * gain
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.from_jax_params(tree, tc.model, V)
    rng = np.random.default_rng(seed)
    ents = entity_rows(rng, B, E, jc.model.type_vocab)
    tokens = rng.standard_normal((B, P, jc.model.emb_dim)).astype(np.float32)
    jctx = jgreedy.prepare_decode_context(jp, jc.model, jnp.asarray(tokens),
                                          jnp.asarray(ents))
    tctx = tgreedy.prepare_decode_context(tp, tc.model, torch.as_tensor(tokens),
                                          torch.as_tensor(ents))
    ids = (V, E, V - 2, V - 1, 0)   # vocab, entity rows, start, end, pad
    return jc, tc, jp, tp, jctx, tctx, ids, L


@pytest.mark.parametrize("preset", ["georic", "k_georic", "nytimes800k"])
def test_port_presets_match_jax(preset):
    """The port's own config copy carries the JAX presets' values."""
    from icek_tpu.core import config as jcfg

    j, t = jcfg.get_config(preset), tcfg.get_config(preset)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    jd, td = dataclasses.asdict(j.decode), dataclasses.asdict(t.decode)
    assert {k: td[k] for k in jd} == jd
    jdata = dataclasses.asdict(j.data)
    tdata = dataclasses.asdict(t.data)
    assert {k: jdata[k] for k in tdata} == tdata
    assert t.model.has_facts == j.model.has_facts
    assert t.model.type_emb_dim == j.model.type_emb_dim


# ---------------------------------------------------------------------------
# the knowledge and news presets at small widths
# ---------------------------------------------------------------------------

FACT_PRESETS = {"knowledge": "k_georic", "news": "nytimes800k"}


def fact_cfgs(variant, emb_dim=24, num_heads=2, ffn=32, layers=2, type_vocab=20,
              num_predicates=12, max_len=8):
    """(jax Config, port Config) for a small knowledge or news model."""
    from icek_tpu.core import config as jcfg

    kw = dict(emb_dim=emb_dim, num_heads=num_heads, decoder_ffn_dim=ffn,
              encoder_ffn_dim=ffn, num_layers=layers, type_vocab=type_vocab,
              num_predicates=num_predicates, dropout_dec=0.0, dropout_enc=0.0,
              dropout_pos=0.0)
    out = []
    for mod in (jcfg, tcfg):
        base = mod.get_config(FACT_PRESETS[variant])
        out.append(base.replace(
            model=dataclasses.replace(base.model, **kw),
            decode=dataclasses.replace(base.decode, max_caption_len=max_len),
        ))
    return tuple(out)


def fact_entity_rows(rng, variant, B, E, type_vocab, vocab):
    """Packed entity rows: knowledge (B, E, 5) [row_idx, dist, az, size,
    type]; news (B, E, 10) [row_idx, count, in_headline, in_first_par, type,
    five name word ids]."""
    if variant == "knowledge":
        return entity_rows(rng, B, E, type_vocab)
    ents = np.zeros((B, E, 10), np.float32)
    ents[:, :, 0] = np.arange(E)
    ents[:, :, 1] = rng.integers(0, 6, (B, E))
    ents[:, :, 2:4] = rng.integers(0, 2, (B, E, 2))
    ents[:, :, 4] = rng.integers(0, type_vocab, (B, E))
    ents[:, :, 5:] = rng.integers(0, vocab, (B, E, 5))
    return ents


def fact_rows(rng, B, E, F, P):
    """(B, F, 3) fact rows [row_idx, subject row, predicate]: subjects drawn
    from the real entity rows (some repeat), the last two rows padding facts
    on the <unk_ent> dummy row E - 1 with predicate 0, as prep stores them."""
    facts = np.zeros((B, F, 3), np.float32)
    facts[:, :, 0] = np.arange(F)
    facts[:, :, 1] = rng.integers(0, E - 1, (B, F))
    facts[:, :, 2] = rng.integers(0, P, (B, F))
    facts[:, -2:, 1] = E - 1
    facts[:, -2:, 2] = 0
    return facts


FACT_DECODE_CASES = {
    # name: (variant, V, E, F, B, image tokens, max_len, entity-head gain)
    "knowledge": ("knowledge", 40, 6, 5, 3, 8, 9, 6.0),
    "news": ("news", 40, 6, 7, 3, 8, 9, 6.0),
}


def fact_decode_contexts(case, seed):
    """The same decode inputs for both packages, with facts: configs, params,
    prepared decode contexts and special ids of FACT_DECODE_CASES[case]."""
    import jax.numpy as jnp
    from icek_torch.decode import greedy as tgreedy
    from icek_tpu.decode import greedy as jgreedy

    variant, V, E, F, B, M, L, gain = FACT_DECODE_CASES[case]
    jc, tc = fact_cfgs(variant, max_len=L)
    tree = jax_params_numpy(jc.model, V, seed)
    # stronger pointer heads, so entity and fact ids (>= V) get emitted, and
    # a predicate-head bias, so the vocab logits are not all 0 before the
    # first predicate is active (its init bias is 0)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * gain
    tree["fc_fact"]["w"] = tree["fc_fact"]["w"] * gain
    brng = np.random.default_rng(seed + 100)
    tree["fc_predicate"]["b"] = brng.standard_normal(jc.model.emb_dim).astype(np.float32)
    tree["fc_fact"]["b"] = tree["fc_fact"]["b"] + 0.5
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.from_jax_params(tree, tc.model, V)
    rng = np.random.default_rng(seed)
    ents = fact_entity_rows(rng, variant, B, E, jc.model.type_vocab, V)
    facts = fact_rows(rng, B, E, F, jc.model.num_predicates)
    tokens = rng.standard_normal((B, M, jc.model.emb_dim)).astype(np.float32)
    jctx = jgreedy.prepare_decode_context(jp, jc.model, jnp.asarray(tokens),
                                          jnp.asarray(ents), jnp.asarray(facts))
    tctx = tgreedy.prepare_decode_context(tp, tc.model, torch.as_tensor(tokens),
                                          torch.as_tensor(ents), torch.as_tensor(facts))
    ids = (V, E, V - 2, V - 1, 0)   # vocab, entity rows, start, end, pad
    return jc, tc, jp, tp, jctx, tctx, ids, L


def spy_kernel_calls(monkeypatch):
    """Count the beam loop's calls of the two kernel wrappers (on the CPU
    they run their plain versions and count no launch): a dict that the
    wrapped wrappers update in place."""
    from icek_torch.kernels import copy_scores, decoder_step

    calls = {"fused_score_topk": 0, "fused_beam_decoder_step": 0}
    for mod, name in ((copy_scores, "fused_score_topk"),
                      (decoder_step, "fused_beam_decoder_step")):
        def spy(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.fixture(scope="module")
def one_torch_thread():
    """Torch on one thread for a module of many small ops: with the suite's
    other workers on the same cores, torch's thread pool waits at every op
    for threads that are not running (the token-cache file took 169 s under
    the suite's load against 15 s on one thread alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# whole splits for the eval run, the token cache and the serving engine:
# datasets written by icek_tpu's InputFileWriter, read by both packages
# ---------------------------------------------------------------------------

def port_config(jax_cfg):
    """The port's Config with every field the port has taken from a JAX
    Config (the same preset, cut to the same small widths)."""
    base = tcfg.get_config(jax_cfg.name)

    def same(dst, src):
        return dataclasses.replace(dst, **{f.name: getattr(src, f.name)
                                           for f in dataclasses.fields(dst)
                                           if hasattr(src, f.name)})

    return base.replace(model=same(base.model, jax_cfg.model),
                        data=same(base.data, jax_cfg.data),
                        train=same(base.train, jax_cfg.train),
                        decode=same(base.decode, jax_cfg.decode))


_BN_STATS = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}


def resnet_params_numpy(emb_dim, seed, proj_gain=3e-4):
    """ResNet-101 params in the JAX layout (the tree of icek_tpu's
    init_resnet101, taken by jax.eval_shape) from a numpy seed: Kaiming
    convolutions, identity batch norms, and a projection scaled so that
    32x32 images give tokens of order 1."""
    from icek_tpu.models import resnet as jres

    shapes = jax.eval_shape(lambda: jres.init_resnet101(jax.random.PRNGKey(0), emb_dim))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in _BN_STATS and keys[-2] in ("bn1", "bn2", "bn3", "down_bn"):
            return np.full(leaf.shape, _BN_STATS[keys[-1]], np.float32)
        if keys[-1] == "b":
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:3]))
        gain = proj_gain if keys[0] == "proj" else 1.0
        return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in) * gain
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def int8_nets(emb_dim, seed=3):
    """Raw and folded ResNet-101 trees of both packages for the int8 tests,
    from a numpy seed; the port's folded tree is JAX's, converted (the
    fold's float arithmetic is the float encoder's business, not the
    quantizer's)."""
    import jax.numpy as jnp
    from icek_tpu.models import resnet as jres

    raw_np = resnet_params_numpy(emb_dim, seed, proj_gain=1.0)
    raw = jax.tree.map(jnp.asarray, raw_np)
    folded = jax.jit(jres.fold_bn_params)(raw)
    return dict(raw_np=raw_np, jraw=raw, jfolded=folded,
                traw=bridge.from_jax_resnet(raw_np),
                tfolded=bridge.from_jax_resnet(jax.tree.map(np.asarray, folded)))


def tree_leaves_with_paths(tree, path=()):
    """(path, numpy leaf) pairs of a nested dict / list tree, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_paths(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _write_raw(tmp_path, images, entity_contexts, knowledge_contexts=None):
    import json
    import pickle

    with open(tmp_path / "captions_split.json", "w") as f:
        json.dump({"images": images}, f)
    with open(tmp_path / "entity_context.pkl", "wb") as f:
        pickle.dump(entity_contexts, f)
    if knowledge_contexts is not None:
        with open(tmp_path / "knowledge_context.pkl", "wb") as f:
            pickle.dump(knowledge_contexts, f)


def _raw_images(tmp_path, n, rng, size=40):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            img_dir / f"img{i}.jpg")
    return img_dir


def _split(i):
    return "train" if i < 6 else ("val" if i < 8 else "test")


GEO_PLACES = ["Tower Bridge", "River Thames", "Old Town", "St Paul's Cathedral",
              "Hyde Park", "Big Ben", "London Eye", "Covent Garden"]


def make_raw_geo_split(tmp_path, n_images):
    """A geo-preset raw dataset whose entity contexts fill the tiny preset's
    8 rows, so that decoded entity ids name real places."""
    pd = pytest.importorskip("pandas")
    from test_train_e2e import WORDS

    rng = np.random.default_rng(0)
    _raw_images(tmp_path, n_images, rng)
    images, entities = [], {}
    for i in range(n_images):
        url = f"http://example.com/{i}"
        images.append({"tokens": list(rng.choice(WORDS, size=5)) + ["tower_bridge"],
                       "mask": [0] * 5 + [1], "url": url, "id": f"img{i}",
                       "split": _split(i)})
        entities[url] = pd.DataFrame({
            "name": GEO_PLACES, "distance": rng.uniform(0, 1, 8),
            "azimuth": rng.uniform(-179, 179, 8), "size": rng.uniform(0, 0.1, 8),
            "type_index": rng.integers(0, 50, 8)})
    _write_raw(tmp_path, images, entities)


def make_raw_knowledge_split(tmp_path, n_images):
    """A knowledge-preset raw dataset whose knowledge contexts also carry the
    `subject` and `predicate` columns the fact-accuracy metric reads."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(0)
    _raw_images(tmp_path, n_images, rng)
    images, entities, knowledge = [], {}, {}
    for i in range(n_images):
        url = f"http://example.com/{i}"
        images.append({"tokens": ["the", "tower_bridge", "built", "in", "1894"],
                       "mask": [0, 1, 0, 0, 2], "url": url, "id": f"img{i}",
                       "split": _split(i)})
        entities[url] = pd.DataFrame({
            "name": ["Tower Bridge", "River Thames", "Old Town"],
            "distance": [0.1, 0.4, 0.7], "azimuth": [12.0, -45.0, 90.0],
            "size": [0.02, 0.08, 0.05], "type_index": [3, 7, 1]})
        knowledge[url] = pd.DataFrame({
            "object": ["1894", "horace_jones", "1901", "river_thames"],
            "subject": ["Tower Bridge", "Tower Bridge", "Old Town", "Tower Bridge"],
            "predicate": ["built", "architect", "built", "crosses"],
            "subject_idx_in_entity_context": [0, 0, 2, 0],
            "predicate_idx": [2, 5, 2, 7]})
    _write_raw(tmp_path, images, entities, knowledge)


def make_raw_news_split(tmp_path, n_images):
    """A news-preset raw dataset (contexts keyed by article, as in
    NYTimes800k), after test_train_e2e.py::test_news_end_to_end."""
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(1)
    _raw_images(tmp_path, n_images, rng, size=36)
    images, entities, knowledge = [], {}, {}
    for i in range(n_images):
        article = f"article{i}"
        images.append({"tokens": ["the", "mayor", "of", "new_york", "in", "1999"],
                       "mask": [0, 0, 0, 1, 0, 2], "url": f"http://news.example/{i}",
                       "item": article, "id": f"img{i}", "split": _split(i)})
        entities[article] = pd.DataFrame({
            "name_processed": ["new_york", "city_hall"], "count": [4, 1],
            "in_headline": [1, 0], "in_first_paragraph": [1, 1], "type": [2, 5]})
        knowledge[article] = pd.DataFrame({
            "object": ["1999", "giuliani"], "subject_idx_in_entity_context": [0, 0],
            "predicate_idx": [1, 3]})
    _write_raw(tmp_path, images, entities, knowledge)


def tiny_news_cfg():
    from icek_tpu.core import config as jcfg

    base = jcfg.nytimes800k()
    return base.replace(
        model=dataclasses.replace(
            base.model, emb_dim=20, decoder_ffn_dim=32, encoder_ffn_dim=32,
            num_heads=2, num_layers=1, type_vocab=10, num_predicates=8,
            encoded_image_size=4),
        data=dataclasses.replace(
            base.data, base_name="tiny_news", entity_context_size=5,
            fact_context_size=4, max_caption_len=10, img_size=32, min_word_freq=0,
            fact_random_ranges=((5, 5), (0, 0))))


EVAL_SPLITS = ("geo", "knowledge", "news")


def eval_split(tmp_path, variant, n_test=5, max_len=12, seed=7):
    """One TEST split of `n_test` rows written by icek_tpu's InputFileWriter,
    with seeded weights for both packages.  Returns a dict: jc / tc (configs,
    decode length `max_len`), jwm / twm (wordmaps), out_dir, base, has_facts,
    tree / enc (numpy params), jp / jenc (JAX), tp / tenc (port).  The pointer
    heads are scaled so that entity (and fact) ids get emitted, and geo's
    vocab bias favours "near" and "in"."""
    import jax.numpy as jnp
    from icek_tpu.data import input_files
    from icek_torch.data import codec as tcodec
    from test_train_e2e import tiny_cfg, tiny_knowledge_cfg

    n_images = 8 + n_test
    raw = tmp_path / "raw"
    raw.mkdir()
    kw = {}
    if variant == "geo":
        jc = tiny_cfg()
        make_raw_geo_split(raw, n_images)
    elif variant == "knowledge":
        jc = tiny_knowledge_cfg()
        make_raw_knowledge_split(raw, n_images)
    else:
        jc = tiny_news_cfg()
        make_raw_news_split(raw, n_images)
    if variant != "geo":
        kw["knowledge_context_path"] = str(raw / "knowledge_context.pkl")
    # prep draws the padding rows' type ids up to the preset's range (500 for
    # geo and knowledge): the type table must hold them (JAX clamps an
    # out-of-range gather, torch raises)
    type_vocab = max(jc.model.type_vocab, int(jc.data.entity_random_ranges[3][1]) + 1)
    jc = jc.replace(model=dataclasses.replace(jc.model, type_vocab=type_vocab),
                    decode=dataclasses.replace(jc.decode, max_caption_len=max_len))
    out_dir = tmp_path / "files"
    jwm = input_files.InputFileWriter(
        jc, str(raw / "captions_split.json"), str(raw / "entity_context.pkl"),
        str(raw / "images"), str(out_dir), seed=0, **kw).run()
    V = len(jwm)
    tree = jax_params_numpy(jc.model, V, seed)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * 6.0
    if variant == "geo":        # spatial words before entities feed the JS metric
        bias = tree["fc_vocab"]["b"].copy()
        bias[[jwm.word_to_id["near"], jwm.word_to_id["in"]]] += 2.0
        tree["fc_vocab"]["b"] = bias
    if jc.model.has_facts:
        tree["fc_fact"]["w"] = tree["fc_fact"]["w"] * 6.0
        tree["fc_fact"]["b"] = tree["fc_fact"]["b"] + 0.5
        tree["fc_predicate"]["b"] = np.random.default_rng(seed).standard_normal(
            jc.model.emb_dim).astype(np.float32)
    enc = resnet_params_numpy(jc.model.emb_dim, seed)
    tc = port_config(jc)
    return dict(
        variant=variant, jc=jc, tc=tc, jwm=jwm, twm=tcodec.Wordmap(jwm.word_to_id),
        out_dir=str(out_dir), base=jc.data.base_name, has_facts=jc.model.has_facts,
        raw=raw, tree=tree, enc=enc,
        jp=jax.tree.map(jnp.asarray, tree), jenc=jax.tree.map(jnp.asarray, enc),
        tp=bridge.from_jax_params(tree, tc.model, V), tenc=bridge.from_jax_resnet(enc))


def split_datasets(s, split="TEST"):
    """(JAX CaptionDataset, port CaptionDataset) over the same files."""
    from icek_torch.data import dataset as tds
    from icek_tpu.data import dataset as jds

    return (jds.CaptionDataset(s["out_dir"], s["base"], split, s["has_facts"]),
            tds.CaptionDataset(s["out_dir"], s["base"], split, s["has_facts"]))


# the eval run of both packages over one split, with the preset's metrics
EVAL_BATCH, EVAL_BEAM = 2, 3        # 5 rows: two full batches and one padded to 2
BINS_DISTANCE = [(0.0, 0.2), (0.2, 0.5), (0.5, 10.0)]
BINS_AZIMUTH = [(-180.0, -90.0), (-90.0, 0.0), (0.0, 90.0), (90.0, 180.0)]
OSM_TYPES = 60
PREDICATE_TO_OBJECTS = {"built": ["1894", "1901"], "architect": ["horace_jones"],
                        "crosses": ["river_thames"]}
PREDICATE_PHRASES = {
    "built": {"phrases": ["built in", "built"], "type": "temporal"},
    "architect": {"phrases": ["designed by", ("tower_bridge", "horace_jones")],
                  "type": "other", "synonymous_predicates": [], "entity_types": [],
                  "blocklist": [], "object_position": "right"},
    "crosses": {"phrases": ["crosses"], "type": "other", "synonymous_predicates": [],
                "entity_types": [], "blocklist": [], "object_position": "right"},
}


def _train_distributions():
    """Uniform train-set tables with every term and feature the JS metric reads."""
    table = {}
    for term in ("near", "along", "across", "in"):
        table[term] = {"distance_probs": [1 / len(BINS_DISTANCE)] * len(BINS_DISTANCE)}
        if term != "near":
            table[term]["type_probs"] = [1 / OSM_TYPES] * OSM_TYPES
    for term in ("north", "south", "east", "west"):
        table[term] = {"azimuth_probs": [1 / len(BINS_AZIMUTH)] * len(BINS_AZIMUTH)}
    return table


def js_metric(mod, wm, seed=3):
    """A JSGeoMetric of module `mod` (either package's) on synthetic bins."""
    import random

    return mod.JSGeoMetric(dict(wm.word_to_id), BINS_DISTANCE, BINS_AZIMUTH, OSM_TYPES,
                           train_distributions=_train_distributions(),
                           print_metrics=False, rng=random.Random(seed))


def fact_metric(mod, raw):
    """A FactAccuracyMetric of module `mod` over a raw knowledge dataset."""
    import copy

    return mod.FactAccuracyMetric(
        str(raw / "captions_split.json"), str(raw / "entity_context.pkl"),
        str(raw / "knowledge_context.pkl"), {"crosses": "crosses"},
        {"bridge": ["crosses"]}, copy.deepcopy(PREDICATE_PHRASES))


def eval_run(s, package, tmp_path):
    """One package's Evaluator.run over the split of ``eval_split`` at
    EVAL_BATCH / EVAL_BEAM, with the preset's metrics (JS for geo; fact
    accuracy and the random-fact baseline with random.Random(0) for
    knowledge).  Returns {"res", "lines" (logged), "files" (CSV bytes by
    name), "js" (the metric)}."""
    import random

    if package == "jax":
        from icek_tpu import eval_driver as ev_mod
        from icek_tpu.metrics import fact_accuracy as fa, js_geo as js
        ev = ev_mod.Evaluator(s["jc"], s["jwm"], s["jp"], s["jenc"], batch_size=EVAL_BATCH,
                              beam_size=EVAL_BEAM)
        data = split_datasets(s)[0]
    else:
        from icek_torch import eval_driver as ev_mod
        from icek_torch.metrics import fact_accuracy as fa, js_geo as js
        ev = ev_mod.Evaluator(s["tc"], s["twm"], s["tp"], s["tenc"], batch_size=EVAL_BATCH,
                              beam_size=EVAL_BEAM, device="cpu")
        data = split_datasets(s)[1]
    kw, lines = {}, []
    if s["variant"] == "geo":
        kw["js_metric"] = js_metric(js, s["jwm"])
    if s["variant"] == "knowledge":
        kw.update(fact_metric=fact_metric(fa, s["raw"]),
                  predicate_to_objects=PREDICATE_TO_OBJECTS, rng=random.Random(0))
    res = ev.run(data, output_csv=str(tmp_path / f"{package}_generated_captions.csv"),
                 log=lines.append, **kw)
    files = {p.name.split("_", 1)[1]: p.read_bytes()
             for p in tmp_path.glob(f"{package}_*.csv")}
    return dict(res=res, lines=lines, files=files, js=kw.get("js_metric"))


# ---------------------------------------------------------------------------
# the train loop, the checkpoints and the CLIs: the tiny geo preset of
# tests/test_train_e2e.py, its TRAIN / VAL / TEST files written by icek_tpu
# ---------------------------------------------------------------------------

def train_split(tmp_path, batch_size=2, dropout=True, **train_kw):
    """(JAX Config, port Config, files dir, JAX Wordmap) of the tiny geo
    preset over test_train_e2e.py's 6 / 2 / 2-row dataset.  The type table
    holds prep's padding type ids (up to 500); without `dropout` every rate
    is 0."""
    from icek_tpu.data import input_files
    from test_train_e2e import make_raw_dataset, tiny_cfg

    jc = tiny_cfg()
    model_kw = dict(type_vocab=int(jc.data.entity_random_ranges[3][1]) + 1)
    if not dropout:
        model_kw.update(dropout_dec=0.0, dropout_enc=0.0, dropout_pos=0.0)
    jc = jc.replace(model=dataclasses.replace(jc.model, **model_kw),
                    train=dataclasses.replace(jc.train, batch_size=batch_size, **train_kw))
    raw = tmp_path / "raw"
    raw.mkdir()
    make_raw_dataset(raw)
    out_dir = tmp_path / "files"
    wm = input_files.InputFileWriter(
        jc, str(raw / "captions_split.json"), str(raw / "entity_context.pkl"),
        str(raw / "images"), str(out_dir), seed=0).run()
    return jc, port_config(jc), str(out_dir), wm


@pytest.fixture
def tmp_dir(tmp_path):
    """tmp_path, removed when the test ends: a checkpoint of even the tiny
    presets carries a full ResNet-101 (170 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def removed_after(tmp_path_factory, name):
    """A module-scoped fixture's directory and its removal, for
    ``yield from``."""
    tmp = tmp_path_factory.mktemp(name)
    try:
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
