"""The slice as a whole: JAX ``Evaluator.decode_batch`` and the port's
``Evaluator.decode_batch`` on the same raw f16 CHW batch and the same
weights, at float32 on the CPU (unfolded encoder, stock decode paths in
both packages).  Tokens must be EXACTLY equal, and the detokenized text
through the port's own codec must equal the JAX detok text.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch import eval_driver as tev
from icek_torch.data import codec as tcodec
from icek_torch.decode import detok as tdetok
from test_torch_common import entity_rows, jax_params_numpy, small_cfgs

V, E, B, IMG, L = 60, 9, 2, 64, 10


@pytest.fixture(scope="module")
def setup():
    from icek_tpu.data import codec as jcodec
    from icek_tpu.models import resnet as jres

    jc, tc = small_cfgs(emb_dim=40, num_heads=4, ffn=64, max_len=L)
    words = [f"w{i}" for i in range(V - 4)] + ["."]
    words = words[1:]   # V - 4 words + <unk> <start> <end> <pad> = V
    jwm, twm = jcodec.Wordmap.from_words(words), tcodec.Wordmap.from_words(words)
    assert len(jwm) == len(twm) == V
    tree = jax_params_numpy(jc.model, V, seed=5)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * 2.0   # entities get emitted
    enc = jax.tree.map(np.asarray, jres.init_resnet101(jax.random.PRNGKey(6), 40))
    # random BN statistics leave the tokens ~1e5; bring them to order 1 so
    # float32 reassociation stays far below the decode's decision margins
    enc["proj"]["w"] = enc["proj"]["w"] * 3e-6
    rng = np.random.default_rng(8)
    batch = {
        "raw_images": rng.uniform(0, 1, (B, 3, IMG, IMG)).astype(np.float16),
        "entity_features": entity_rows(rng, B, E, jc.model.type_vocab),
    }
    names = np.array([[0, len(n)] + jcodec.encode_name(n)
                      for n in (f"place_{e}" for e in range(E))], np.int64)
    return dict(jc=jc, tc=tc, jwm=jwm, twm=twm, tree=tree, enc=enc,
                batch=batch, names=names)


@pytest.mark.parametrize("beam", [5, 1])
def test_decode_batch_matches_jax(setup, beam):
    from icek_tpu import eval_driver as jev
    from icek_tpu.decode import detok as jdetok

    s = setup
    jp = jax.tree.map(jnp.asarray, s["tree"])
    jenc = jax.tree.map(jnp.asarray, s["enc"])
    want = jev.Evaluator(s["jc"], s["jwm"], jp, jenc, batch_size=B,
                         beam_size=beam).decode_batch(s["batch"])
    ev = tev.Evaluator(s["tc"], s["twm"], bridge.from_jax_params(s["tree"], s["tc"].model, V),
                       bridge.from_jax_resnet(s["enc"]), batch_size=B,
                       beam_size=beam, device="cpu")
    assert ev.compute_dtype == torch.float32 and ev._encoder_folded is None
    got = ev.decode_batch(s["batch"])
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got >= V).any() and (got < V).any()   # words and entities
    for b in range(B):
        assert (tdetok.caption_text(got[b], s["twm"], s["names"])
                == jdetok.caption_text(np.asarray(want)[b], s["jwm"], s["names"]))


def test_detok_matches_jax(setup):
    """Every id class: words, specials, entities, out-of-range ids."""
    from icek_tpu.decode import detok as jdetok

    s = setup
    seq = [s["twm"].start_id, 1, 2, V, V + E - 1, V + E + 3, s["twm"].end_id, 0, 5]
    assert tdetok.detokenize(seq, s["twm"], s["names"]) == jdetok.detokenize(
        seq, s["jwm"], s["names"])
    for text in ("a . b . c", "a . b .", "one"):
        assert tdetok.trim_trailing_sentence(text) == jdetok.trim_trailing_sentence(text)


def test_batch_size_and_dtype_defaults(setup):
    s = setup
    assert tev.resolve_eval_batch_size(None, s["tc"], "cpu") == 64
    assert tev.resolve_eval_batch_size(None, s["tc"], "cuda") == 256
    assert tev.resolve_eval_batch_size(7, s["tc"], "cuda") == 7
    ev = tev.Evaluator(s["tc"], s["twm"], bridge.from_jax_params(s["tree"], s["tc"].model, V),
                       bridge.from_jax_resnet(s["enc"]), device="cpu",
                       compute_dtype=torch.bfloat16)
    assert ev._encoder_folded is not None   # the BN-folded encoder serves bf16
    # cached image tokens skip the encoder: (B, L) ids of the extended vocab
    tokens = np.random.default_rng(3).standard_normal((B, 196, 40)).astype(np.float32)
    out = ev.decode_batch({"image_tokens": tokens,
                           "entity_features": s["batch"]["entity_features"]})
    assert out.shape == (B, L) and out.dtype == np.int64
    assert 0 <= out.min() and out.max() < V + E
    with pytest.raises(ValueError, match="no image input"):
        ev.decode_batch({"entity_features": s["batch"]["entity_features"]})
    with pytest.raises(TypeError, match="mesh must be a"):
        tev.Evaluator(s["tc"], s["twm"], {}, {}, device="cpu", mesh=object())
