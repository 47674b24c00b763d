"""The geo model at a head dim of 64 (``--geometry 128x2``, the 512x8
model's head width at a width the CPU can run) through both packages:
the teacher-forced loss and gradients of a train step at dropout 0, and
greedy and beam-5 tokens, float32 on the CPU; and a train step at a head
dim of 128 (``--geometry 256x2``, the 512x4 model's head width), where the
JAX package's flash kernel runs at head slot 128.

Both configs go through their package's ``apply_geometry``, and the port's
params come from the JAX tree through the bridge.  The JAX side runs with
``use_flash_attention=True``, so its Pallas flash kernel runs forward and
backward at head dim 64 (its head slot 64) in the interpreter; the port
runs the flash wrapper's plain version, which is what its kernels are held
to on the card.  Tolerances as tests/test_torch_train.py: loss 1e-5
relative, clipped gradients atol 1e-5; tokens exactly equal, beam scores
atol 1e-4.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icek_torch import bridge
from icek_torch.core import config as tcfg
from icek_torch.decode import beam as tbeam
from icek_torch.decode import greedy as tgreedy
from icek_torch.models import captioner as tcap
from icek_torch.train import step as tstep
from icek_tpu.core import config as jcfg
from icek_tpu.decode import beam as jbeam
from icek_tpu.decode import greedy as jgreedy
from icek_tpu.train import step as jstep
from test_torch_common import entity_rows, jax_params_numpy

GEOMETRY = "128x2"
V, E, T, P, B, PAD, L = 40, 6, 7, 10, 3, 0, 8
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(geometry=GEOMETRY):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.apply_geometry(mod.georic(), geometry)
        out.append(c.replace(
            model=dataclasses.replace(
                c.model, decoder_ffn_dim=64, encoder_ffn_dim=64, num_layers=1,
                type_vocab=20, dropout_dec=0.0, dropout_enc=0.0, dropout_pos=0.0,
                use_flash_attention=True),
            decode=dataclasses.replace(c.decode, max_caption_len=L),
            train=dataclasses.replace(c.train, grad_accum_steps=1)))
    jc, tc = out
    hd = int(geometry.split("x")[0]) // int(geometry.split("x")[1])
    assert jc.model.emb_dim // jc.model.num_heads == hd == tc.model.emb_dim // tc.model.num_heads
    return jc, tc


def _models(geometry=GEOMETRY):
    jc, tc = _cfgs(geometry)
    tree = jax_params_numpy(jc.model, V, seed=3)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * 6.0    # entity ids get emitted too
    return jc, tc, tree


@pytest.fixture(scope="module")
def models():
    return _models()


def _batch(seed=0, D=128):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, V, (B, T)).astype(np.int32)
    caps[:, 0] = V - 2
    caps[rng.random((B, T)) < 0.15] = V + rng.integers(0, E)
    lengths = np.array([T, 5, 3], np.int32)
    for b in range(B):
        caps[b, lengths[b]:] = PAD
    return {"caption_ids": caps, "caption_mask": (caps >= V).astype(np.int32),
            "lengths": lengths, "entity_features": entity_rows(rng, B, E, 20),
            "image_tokens": rng.standard_normal((B, P, D)).astype(np.float32)}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _adam_mu(opt_state):
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
    assert len(found) == 1
    return found[0]


def test_train_step_at_head_dim_64_matches_jax(models):
    """One step: the loss within 1e-5, every clipped gradient (the JAX
    step's as 10 x Adam's first moment) within 1e-5."""
    _train_step_matches(*models, _batch())


def test_train_step_at_head_dim_128_matches_jax():
    """The same step at --geometry 256x2 (two heads of 128: JAX's Pallas
    flash forward and backward at head slot 128 in the interpreter, the
    port's plain version, which the HDP-128 kernels are held to on the
    card): the loss within 1e-5, every clipped gradient within 1e-5."""
    _train_step_matches(*_models("256x2"), _batch(D=256))


def _train_step_matches(jc, tc, tree, batch):
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
    opt = jstep.make_optimizer(LR)
    jtrain, _ = jstep.make_train_step(jc, V, PAD, opt, encode_images=False)
    jp, jstate, jloss, jn = jtrain(jp, opt.init(jp), None, batch, jax.random.PRNGKey(1))

    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    scores = tcap.captioner_forward(tp, tc.model, V, PAD, b["caption_ids"].long(),
                                    b["caption_mask"].long(), b["image_tokens"],
                                    b["entity_features"])
    loss, n = tstep.caption_loss(scores, b["caption_ids"], b["lengths"], PAD)
    loss.backward()
    assert int(n) == int(jn)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = [np.clip(g, -5.0, 5.0) for g in _leaves(bridge.grads_to_numpy(tp))]
    want = [10.0 * m for m in _leaves(_adam_mu(jstate))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)


def _contexts(jc, tc, tree):
    rng = np.random.default_rng(5)
    ents = entity_rows(rng, B, E, 20)
    tokens = rng.standard_normal((B, P, 128)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = bridge.from_jax_params(tree, tc.model, V)
    jctx = jgreedy.prepare_decode_context(jp, jc.model, jnp.asarray(tokens), jnp.asarray(ents))
    tctx = tgreedy.prepare_decode_context(tp, tc.model, torch.as_tensor(tokens),
                                          torch.as_tensor(ents))
    return jp, tp, jctx, tctx, (V, E, V - 2, V - 1, PAD)


def test_decode_at_head_dim_64_matches_jax(models):
    """Greedy and beam-5 tokens exactly equal, beam scores within 1e-4; the
    entities the context encoder built through flash, and the cross K / V
    from its memory, agree within 1e-5."""
    jc, tc, tree = models
    jp, tp, jctx, tctx, ids = _contexts(jc, tc, tree)
    np.testing.assert_allclose(tctx.entities_encoded.numpy(),
                               np.asarray(jctx.entities_encoded), atol=1e-5)
    for got, want in zip(tctx.cross_kvs, jctx.cross_kvs):
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]).reshape(
                got[name].shape), atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        want_g = jgreedy.greedy_decode(jp, jc.model, *ids, jctx, L)
        want_t, want_s = jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=5,
                                           use_megakernel=False, use_fused_scores=False)
    got_g = tgreedy.greedy_decode(tp, tc.model, *ids, tctx, L)
    got_t, got_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=5,
                                     use_megakernel=False, use_fused_scores=False)
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
