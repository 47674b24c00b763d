"""The fact path of the port's captioner (icek_torch/models/captioner.py,
the knowledge and news variants) and its train step against the JAX
package, float32 on the CPU, small widths (d 24, 2 heads, 2 layers,
P 12, V 40, E 6, F 5; the news rows carry five name word ids).

Tolerances.  Encoders, memory and scores atol 1e-5 on values of order 1;
the 0/1 indicators and fact counts exactly.  The train step as in
tests/test_torch_train.py: loss 1e-5 relative, clipped gradients atol
1e-5 (read from the JAX step as 10 x Adam's first moment after one step).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.models import captioner as tcap
from icek_torch.train import step as tstep
from icek_tpu.models import captioner as jcap
from icek_tpu.train import step as jstep
from test_torch_common import (fact_cfgs, fact_entity_rows, fact_rows,
                               jax_params_numpy)

V, E, F, T, M, PAD = 40, 6, 5, 8, 7, 0
VARIANTS = ("knowledge", "news")
LR = 1e-3


def _batch(variant, B, seed):
    """Captions mixing words, entity ids (>= V, mask 1) and fact ids
    (>= V + E, mask 2), with <pad> tails; entity and fact rows; image
    tokens."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, V - 2, (B, T))
    kind = rng.choice(3, (B, T), p=[0.6, 0.25, 0.15])
    caps = np.where(kind == 1, V + rng.integers(0, E, (B, T)), caps)
    caps = np.where(kind == 2, V + E + rng.integers(0, F, (B, T)), caps)
    caps[:, 0] = V - 2
    lengths = rng.integers(3, T + 1, (B,))
    lengths[0] = T
    for b in range(B):
        caps[b, lengths[b]:] = PAD
    mask = np.where(caps >= V + E, 2, (caps >= V).astype(np.int64))
    return {
        "caption_ids": caps.astype(np.int32), "caption_mask": mask.astype(np.int32),
        "lengths": lengths.astype(np.int32),
        "entity_features": fact_entity_rows(rng, variant, B, E, 20, V),
        "fact_features": fact_rows(rng, B, E, F, 12),
        "image_tokens": rng.standard_normal((B, M, 24)).astype(np.float32),
    }


@functools.lru_cache(maxsize=None)
def _setup(variant, seed=0):
    jc, tc = fact_cfgs(variant)
    tree = jax_params_numpy(jc.model, V, seed)
    brng = np.random.default_rng(seed + 100)
    tree["fc_predicate"]["b"] = brng.standard_normal(24).astype(np.float32)
    tree["fc_fact"]["b"] = tree["fc_fact"]["b"] + 0.25
    return jc, tc, tree


def _params(variant, seed=0):
    jc, tc, tree = _setup(variant, seed)
    return jc, tc, jax.tree.map(jnp.asarray, tree), bridge.from_jax_params(tree, tc.model, V)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_have_the_jax_layout(variant):
    """The port's seeded init builds the JAX tree: the same keys and shapes,
    the fact keys included."""
    jc, tc, tree = _setup(variant)
    got = tcap.init_captioner_params(torch.Generator().manual_seed(0), tc.model, V)
    shapes = lambda t: jax.tree.map(lambda x: tuple(np.shape(x)), t)
    assert shapes(bridge.to_numpy(got)) == shapes(tree)
    assert {"predicate_embedding", "ctx_encoder_facts", "fc_fact", "fc_predicate"} <= set(got)
    assert float(got["fc_predicate"]["w"].abs().max()) <= 0.1


def test_bridge_checks_the_fact_keys():
    _, tc, tree = _setup("knowledge")
    bridge.from_jax_params(tree, tc.model, V)
    for key, bad in (("predicate_embedding", np.zeros((11, 24), np.float32)),
                     ("fc_predicate", {"w": np.zeros((12, 24), np.float32),
                                       "b": np.zeros((23,), np.float32)}),
                     ("fc_fact", {"w": np.zeros((24, 2), np.float32),
                                  "b": np.zeros((1,), np.float32)}),
                     ("ctx_encoder_facts", {"layers": tree["ctx_encoder_facts"]["layers"][:1]})):
        with pytest.raises(ValueError, match=key):
            bridge.from_jax_params(dict(tree, **{key: bad}), tc.model, V)


def test_count_subject_facts_matches_jax(rng):
    """Repeated subjects, the dummy last row (forced to 0) and subjects out
    of range (no row counts them)."""
    subj = rng.integers(-2, E + 2, (4, 9)).astype(np.float32)
    subj[0, :3] = E - 1
    want = jcap.count_subject_facts(jnp.asarray(subj), E)
    got = tcap.count_subject_facts(_t(subj), E)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0][:, -1].abs().max()) == 0.0 and float(got[0].max()) >= 2


@pytest.mark.parametrize("variant", VARIANTS)
def test_encoders_and_embedding_match_jax(variant):
    """encode_entities (knowledge: 6 feature columns; news: 5, times the mean
    name-word embedding), encode_facts and the 3-way embed_captions."""
    jc, tc, jp, tp = _params(variant)
    b = _batch(variant, 3, seed=1)
    j_ents = jcap.encode_entities(jp, jc.model, b["entity_features"], b["fact_features"])
    t_ents = tcap.encode_entities(tp, tc.model, _t(b["entity_features"]),
                                  _t(b["fact_features"]))
    _close(t_ents, j_ents)
    j_facts = jcap.encode_facts(jp, b["fact_features"], j_ents)
    t_facts = tcap.encode_facts(tp, _t(b["fact_features"]), t_ents)
    _close(t_facts, j_facts)
    want = jcap.embed_captions(jp, V, PAD, b["caption_ids"], b["caption_mask"], j_ents,
                               j_facts)
    got = tcap.embed_captions(tp, V, PAD, _t(b["caption_ids"]).long(),
                              _t(b["caption_mask"]).long(), t_ents, t_facts)
    _close(got, want)
    assert (b["caption_mask"] == 2).any() and (b["caption_mask"] == 1).any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_context_indicators_match_jax(variant):
    """seen_entity_mask, context_indicators (B, T, .) and the decode loops'
    single-step indicators_from_seen on (B, E) and (B, K, E) masks: exactly
    the JAX 0/1 values (the gather and scatter replace one-hot products)."""
    jc, tc, _, _ = _params(variant)
    b = _batch(variant, 3, seed=2)
    P = jc.model.num_predicates
    caps, facts = b["caption_ids"], b["fact_features"]
    facts[1, 0, 1] = E + 4            # a subject out of range is never seen
    np.testing.assert_array_equal(
        tcap.seen_entity_mask(_t(caps).long(), V, E).numpy(),
        np.asarray(jcap.seen_entity_mask(jnp.asarray(caps), V, E)))
    want = jcap.context_indicators(jnp.asarray(caps), jnp.asarray(facts), V, E, P)
    got = tcap.context_indicators(_t(caps).long(), _t(facts), V, E, P)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].sum()) > 0
    seen = (np.random.default_rng(3).random((3, 4, E)) < 0.4).astype(np.float32)
    got = tcap.indicators_from_seen(_t(seen), _t(facts), P)
    for k in range(4):
        want = jcap.indicators_from_seen(jnp.asarray(seen[:, k]), jnp.asarray(facts), P)
        one = tcap.indicators_from_seen(_t(seen[:, k]), _t(facts), P)
        for g, o, w in zip(got, one, want):
            np.testing.assert_array_equal(g[:, k].numpy(), np.asarray(w))
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("variant", VARIANTS)
def test_copy_scores_with_facts_match_jax(variant):
    """The predicate-modulated vocab head, the entity tail and the gated fact
    tail (its bias ungated), in f32 and with bf16 operands."""
    jc, tc, jp, tp = _params(variant)
    b = _batch(variant, 3, seed=4)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((3, T, 24)).astype(np.float32)
    ents = rng.standard_normal((3, E, 24)).astype(np.float32)
    facts = rng.standard_normal((3, F, 24)).astype(np.float32)
    fb, pi = jcap.context_indicators(jnp.asarray(b["caption_ids"]),
                                     jnp.asarray(b["fact_features"]), V, E, 12)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 2e-2)):
        want = jcap.copy_scores(jp, jc.model, jnp.asarray(h), jnp.asarray(ents),
                                jnp.asarray(facts), fb, pi, compute_dtype=jdt)
        got = tcap.copy_scores(tp, tc.model, _t(h), _t(ents), _t(facts), _t(fb), _t(pi),
                               compute_dtype=dt)
        assert got.shape == (3, T, V + E + F) and got.dtype == torch.float32
        _close(got, want, atol=tol)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_memory_and_forward_match_jax(variant, flash):
    """encode_memory ([image | entity ctx | fact ctx]) and the teacher-forced
    scores, stock and flash branches (JAX's flash runs the Pallas kernel in
    interpret mode; the port's wrapper its plain version)."""
    jc, tc, jp, tp = _params(variant)
    jc = jc.replace(model=dataclasses.replace(jc.model, use_flash_attention=flash))
    tc = tc.replace(model=dataclasses.replace(tc.model, use_flash_attention=flash))
    b = _batch(variant, 3, seed=5)
    tb = {k: _t(v) for k, v in b.items()}
    j_mem, _, _ = jcap.encode_memory(jp, jc.model, b["image_tokens"], b["entity_features"],
                                     b["fact_features"])
    with torch.no_grad():
        t_mem, _, t_facts = tcap.encode_memory(tp, tc.model, tb["image_tokens"],
                                               tb["entity_features"], tb["fact_features"])
    assert t_mem.shape == (3, M + E + F, 24) and t_facts.shape == (3, F, 24)
    _close(t_mem, j_mem)
    with pytest.raises(ValueError, match="fact_features"):
        tcap.encode_memory(tp, tc.model, tb["image_tokens"], tb["entity_features"])
    want = jcap.captioner_forward(
        jp, jc.model, V, PAD, b["caption_ids"], b["caption_mask"], b["image_tokens"],
        b["entity_features"], b["fact_features"])
    with torch.no_grad():
        got = tcap.captioner_forward(
            tp, tc.model, V, PAD, tb["caption_ids"].long(), tb["caption_mask"].long(),
            tb["image_tokens"], tb["entity_features"], tb["fact_features"])
    assert got.shape == (3, T, V + E + F)
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_train(variant):
    jc, _, _ = _setup(variant)
    jc = jc.replace(train=dataclasses.replace(jc.train, grad_accum_steps=1))
    opt = jstep.make_optimizer(LR)
    return opt, jstep.make_train_step(jc, V, PAD, opt, encode_images=False)


def _mu(opt_state):
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)

    walk(opt_state)
    return found[0]


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax(variant):
    """One train step of k_georic / nytimes800k at small widths: loss 1e-5
    relative, token count equal, the clipped gradients of every leaf (fact
    encoder, predicate embedding and heads included) within 1e-5, eval loss
    after the step 1e-5 relative."""
    jc, tc, jp, _ = _params(variant)
    tc = tc.replace(train=dataclasses.replace(tc.train, grad_accum_steps=1))
    _, _, tree = _setup(variant)
    tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
    batch = _batch(variant, 4, seed=6)
    jopt, (jtrain, jeval) = _jax_train(variant)
    jp, jstate, jl, jn = jtrain(jp, jopt.init(jp), None, batch, jax.random.PRNGKey(0))
    opt = tstep.make_optimizer(LR)
    state = opt.init(tp)
    train, evaluate = tstep.make_train_step(tc, V, PAD, opt, encode_images=False,
                                            device="cpu")
    _, _, loss, count = train(tp, state, None, batch, torch.Generator().manual_seed(0))
    assert int(count) == int(jn)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    mu, _ = state.moments(tp)
    got = jax.tree.leaves(bridge.to_numpy(mu))
    want = [10.0 * np.asarray(m) for m in jax.tree.leaves(_mu(jstate))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(10.0 * g, w, atol=1e-5)
    grads = bridge.to_numpy(mu)
    assert np.abs(grads["fc_predicate"]["w"]).max() > 0
    assert np.abs(grads["ctx_encoder_facts"]["layers"][0]["self_attn"]["qkv_w"]).max() > 0
    np.testing.assert_allclose(float(evaluate(tp, None, batch)[0]),
                               float(jeval(jp, None, batch)[0]), rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_with_dropout_follows_the_generator(variant):
    """Dropout on (the fact encoder draws from the one generator too): the
    same seed gives the same loss, another seed another."""
    _, tc, tree = _setup(variant)
    tc = tc.replace(model=dataclasses.replace(tc.model, dropout_enc=0.2, dropout_dec=0.2,
                                              dropout_pos=0.1),
                    train=dataclasses.replace(tc.train, grad_accum_steps=1))
    batch = _batch(variant, 4, seed=7)

    def run(seed):
        tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
        opt = tstep.make_optimizer(LR)
        train, _ = tstep.make_train_step(tc, V, PAD, opt, encode_images=False, device="cpu")
        return float(train(tp, opt.init(tp), None, batch,
                           torch.Generator().manual_seed(seed))[2])

    a, b, c = run(1), run(1), run(2)
    assert np.isfinite(a) and a == b and a != c
