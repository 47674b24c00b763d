"""Port greedy and beam decode with facts (the knowledge and news
variants) against the JAX decoders at float32 on the CPU: tokens EXACTLY
equal, beam scores within 1e-4, with the kernel switches off and on (the
port runs the kernels' plain versions, the JAX side its Pallas kernels in
the interpreter); beam 9 through the kernel wrappers; and the slice as a whole, ``Evaluator.decode_batch`` on raw f16
images with fact rows, against the JAX Evaluator.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icek_torch import bridge
from icek_torch import eval_driver as tev
from icek_torch.data import codec as tcodec
from icek_torch.decode import beam as tbeam
from icek_torch.decode import greedy as tgreedy
from icek_tpu.decode import beam as jbeam
from icek_tpu.decode import greedy as jgreedy
from test_torch_common import (FACT_DECODE_CASES, fact_cfgs, fact_decode_contexts,
                               fact_entity_rows, fact_rows, jax_params_numpy,
                               spy_kernel_calls)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("case", sorted(FACT_DECODE_CASES))
def test_greedy_tokens_match_jax(case, kernels):
    """Greedy with the fused score head off and on: the predicate-modulated
    vocab input and the [entity | fact] tail feed the kernel's plain version."""
    jc, tc, jp, tp, jctx, tctx, ids, L = fact_decode_contexts(case, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = jgreedy.greedy_decode(jp, jc.model, *ids, jctx, L, use_fused_scores=kernels)
    got = tgreedy.greedy_decode(tp, tc.model, *ids, tctx, L, use_fused_scores=kernels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    V, E = ids[0], ids[1]
    assert (got.numpy() < V).any() and (got.numpy() >= V + E).any()   # words and facts


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("case", sorted(FACT_DECODE_CASES))
def test_beam5_tokens_match_jax(case, kernels):
    """Beam 5 with the decoder-step kernel and the fused scores both off and
    both on; the seen / predicate state follows each hypothesis's parent."""
    seed = {"knowledge": 1, "news": 2}[case]      # captions mixing words, entities, facts
    jc, tc, jp, tp, jctx, tctx, ids, L = fact_decode_contexts(case, seed=seed)
    with pltpu.force_tpu_interpret_mode():
        want_t, want_s = jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=5,
                                           use_megakernel=kernels, use_fused_scores=kernels)
    got_t, got_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=5,
                                     use_megakernel=kernels, use_fused_scores=kernels)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


@pytest.mark.parametrize("case", sorted(FACT_DECODE_CASES))
def test_beam_width_9_with_facts_runs_through_the_kernels(case, monkeypatch):
    """Beam 9 with both switches on: the score head and the decoder step at
    every step, the same tokens as with both off and as JAX."""
    jc, tc, jp, tp, jctx, tctx, ids, L = fact_decode_contexts(case, seed=3)
    calls = spy_kernel_calls(monkeypatch)
    got_t, got_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=9,
                                     use_megakernel=True, use_fused_scores=True)
    assert calls["fused_score_topk"] == calls["fused_beam_decoder_step"] > 0
    off_t, _ = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=9,
                                 use_megakernel=False, use_fused_scores=False)
    want_t, want_s = jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=9)
    np.testing.assert_array_equal(got_t.numpy(), off_t.numpy())
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


def test_entity_predicates_match_jax():
    """ent_pred of the decode context: the (subject, predicate) scatter gives
    JAX's one-hot product, the <unk_ent> dummy row's padding facts included,
    and pairs out of range set nothing."""
    jc, tc, jp, tp, jctx, tctx, ids, L = fact_decode_contexts("news", seed=5)
    np.testing.assert_array_equal(tctx.ent_pred.numpy(), np.asarray(jctx.ent_pred) > 0)
    E = ids[1]
    assert tctx.ent_pred[:, E - 1, 0].all()           # the padding facts' predicate
    facts = tctx.fact_features.clone()
    facts[0, 0, 1], facts[0, 1, 2] = E + 3, -1
    got = tgreedy.entity_predicates(facts, E, tc.model.num_predicates)
    want = jgreedy.prepare_decode_context(
        jp, jc.model, jnp.zeros((3, 8, 24)), jnp.zeros((3, E, 10)),
        jnp.asarray(facts.numpy())).ent_pred
    np.testing.assert_array_equal(got.numpy(), np.asarray(want) > 0)


# ---------------------------------------------------------------------------
# the slice as a whole: Evaluator.decode_batch with fact rows
# ---------------------------------------------------------------------------

V, E, F, B, IMG, L = 40, 6, 5, 2, 64, 9


@pytest.fixture(scope="module")
def encoder():
    from icek_tpu.models import resnet as jres

    enc = jax.tree.map(np.asarray, jres.init_resnet101(jax.random.PRNGKey(6), 24))
    # random BN statistics leave the tokens ~1e5; bring them to order 1
    enc["proj"]["w"] = enc["proj"]["w"] * 3e-6
    return enc


@pytest.mark.parametrize("variant,beam", [("knowledge", 5), ("news", 5), ("news", 1)])
def test_decode_batch_with_facts_matches_jax(encoder, variant, beam):
    from icek_tpu import eval_driver as jev
    from icek_tpu.data import codec as jcodec

    jc, tc = fact_cfgs(variant, max_len=L)
    words = [f"w{i}" for i in range(V - 5)] + ["."]
    jwm, twm = jcodec.Wordmap.from_words(words), tcodec.Wordmap.from_words(words)
    assert len(jwm) == len(twm) == V
    tree = jax_params_numpy(jc.model, V, seed=7)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * 4.0
    tree["fc_fact"]["w"] = tree["fc_fact"]["w"] * 4.0
    tree["fc_predicate"]["b"] = np.random.default_rng(7).standard_normal(24).astype(
        np.float32)
    rng = np.random.default_rng(8)
    batch = {
        "raw_images": rng.uniform(0, 1, (B, 3, IMG, IMG)).astype(np.float16),
        "entity_features": fact_entity_rows(rng, variant, B, E, jc.model.type_vocab, V),
        "fact_features": fact_rows(rng, B, E, F, jc.model.num_predicates),
    }
    want = jev.Evaluator(jc, jwm, jax.tree.map(jnp.asarray, tree),
                         jax.tree.map(jnp.asarray, encoder), batch_size=B,
                         beam_size=beam).decode_batch(batch)
    ev = tev.Evaluator(tc, twm, bridge.from_jax_params(tree, tc.model, V),
                       bridge.from_jax_resnet(encoder), batch_size=B, beam_size=beam,
                       device="cpu")
    got = ev.decode_batch(batch)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (B, L) and (got >= V).any()
