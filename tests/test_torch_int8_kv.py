"""The int8 KV options of beam decode (``kv_dtype`` "int8": self caches
and cross K/V per-row int8; "int8_cross": only the cross K/V) against the
JAX package at float32 on the CPU: quantized payloads equal bit for bit
(both round half to even), beam tokens equal and scores within 1e-4, with
and without facts; "auto" resolves as JAX's does on the CPU; int8 runs the
plain decoder step (the kernel's switch None resolves to off, True raises)
while the score head still runs through its wrapper; and an Evaluator with
``kv_dtype="int8"`` decodes as JAX's does.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.decode import beam as tbeam
from icek_tpu.decode import beam as jbeam
from test_torch_common import (decode_contexts, fact_decode_contexts,  # noqa: F401
                               one_torch_thread, port_config, spy_kernel_calls)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KV_DTYPES = ("int8", "int8_cross")
CASES = {"geo": lambda: decode_contexts("wide", seed=3),
         "knowledge": lambda: fact_decode_contexts("knowledge", seed=1),
         "news": lambda: fact_decode_contexts("news", seed=2)}


def test_quantize_cross_kvs_matches_jax():
    rng = np.random.default_rng(0)
    kvs = []
    for scale in (1.0, 40.0):
        k, v = (rng.standard_normal((3, 11, 4, 10)).astype(np.float32) * scale
                for _ in range(2))
        k[0, 0, 0] = 0.0                                # an all-zero row: scale 1e-8 / 127
        v[1, :, 2, 3] = np.linspace(-2.5, 2.5, 11)      # exact half-steps of the scale
        kvs.append({"k": k, "v": v})
    want = jbeam.quantize_cross_kvs([{n: jnp.asarray(a) for n, a in c.items()} for c in kvs])
    got = tbeam.quantize_cross_kvs([{n: torch.as_tensor(a) for n, a in c.items()}
                                    for c in kvs])
    for g, w in zip(got, want):
        for name in ("kq", "vq"):
            assert g[name].dtype == torch.int8
            np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]))
        for name in ("ks", "vs"):
            assert g[name].shape == w[name].shape
            np.testing.assert_allclose(g[name].numpy(), np.asarray(w[name]), rtol=1e-6)


def test_quantize_rows_round_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5]])
    q, scale = tbeam._quantize_rows(x)
    assert float(scale) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126]]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_int8_tokens_match_jax(case, kv_dtype, monkeypatch):
    jc, tc, jp, tp, jctx, tctx, ids, L = CASES[case]()
    want_t, want_s = jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=5,
                                       kv_dtype=kv_dtype)
    calls = spy_kernel_calls(monkeypatch)
    got_t, got_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=5,
                                     kv_dtype=kv_dtype, use_fused_scores=True)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-4)
    # the plain decoder step, the score head's wrapper every step
    assert calls["fused_beam_decoder_step"] == 0 and calls["fused_score_topk"] > 0
    plain_t, _ = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=5,
                                   kv_dtype=kv_dtype, use_fused_scores=False)
    np.testing.assert_array_equal(plain_t.numpy(), got_t.numpy())
    assert (got_t.numpy() >= ids[0]).any()                # pointer ids decoded


@pytest.mark.parametrize("preset", ["georic", "k_georic", "nytimes800k"])
def test_resolve_kv_dtype_matches_jax_on_cpu(preset):
    from icek_torch.core import config as tcfg
    from icek_tpu.core import config as jcfg

    jm, tm = jcfg.get_config(preset).model, tcfg.get_config(preset).model
    for value in (None, "auto", "int8", "int8_cross"):
        assert tbeam.resolve_kv_dtype(value, tm) == jbeam.resolve_kv_dtype(value, jm)
    assert tbeam.resolve_kv_dtype("auto", tm) is None


def test_int8_refuses_the_decoder_step_kernel():
    jc, tc, jp, tp, jctx, tctx, ids, L = CASES["geo"]()
    for kv_dtype in KV_DTYPES:
        with pytest.raises(ValueError, match="megakernel"):
            tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=3, kv_dtype=kv_dtype,
                              use_megakernel=True)
        with pytest.raises(ValueError, match="megakernel"):
            jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=3, kv_dtype=kv_dtype,
                              use_megakernel=True)


def test_evaluator_with_int8_kv_decodes_as_jax(tmp_path):
    """kv_dtype="int8" from the config through Evaluator.decode_batch (cached
    image tokens, so no encoder runs), against JAX's Evaluator."""
    from icek_torch import bridge
    from icek_torch import eval_driver as tev
    from icek_torch.data import codec as tcodec
    from icek_tpu import eval_driver as jev
    from icek_tpu.data import codec as jcodec
    from test_torch_common import entity_rows, jax_params_numpy, small_cfgs

    jc, _ = small_cfgs(emb_dim=40, num_heads=4, ffn=64, max_len=10)
    jc = jc.replace(decode=dataclasses.replace(jc.decode, kv_dtype="int8"))
    tc = port_config(jc)
    assert tc.decode.kv_dtype == "int8"
    words = [f"w{i}" for i in range(56)]
    jwm, twm = jcodec.Wordmap.from_words(words), tcodec.Wordmap.from_words(words)
    tree = jax_params_numpy(jc.model, len(jwm), seed=5)
    tree["fc_entity"]["w"] = tree["fc_entity"]["w"] * 4.0
    rng = np.random.default_rng(6)
    batch = {"image_tokens": rng.standard_normal((3, 12, 40)).astype(np.float32),
             "entity_features": entity_rows(rng, 3, 9, jc.model.type_vocab)}
    want = jev.Evaluator(jc, jwm, jax.tree.map(jnp.asarray, tree), None, batch_size=3,
                         beam_size=5).decode_batch(batch)
    ev = tev.Evaluator(tc, twm, bridge.from_jax_params(tree, tc.model, len(twm)), None,
                       batch_size=3, beam_size=5, device="cpu")
    got = ev.decode_batch(batch)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got >= len(twm)).any()
