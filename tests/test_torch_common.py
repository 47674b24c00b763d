"""Shared fixtures for the PyTorch-port tests, and the port's config copy
held against the JAX package's presets.

The helpers build one small geo configuration in both packages, JAX
params from a fixed key (handed to the port as numpy through the
bridge), and entity rows from a numpy seed, so each test feeds the same
inputs to the JAX function and its port.
"""

import dataclasses

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
