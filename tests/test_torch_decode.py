"""Port beam decode (icek_torch/decode/) against the JAX decoder at
float32 on the CPU: the top-k tie contract, beam-5 tokens EXACTLY equal,
beam scores within 1e-4.  With the kernel switches on, the port runs the
kernels' plain versions and the JAX side runs its Pallas kernels in the
interpreter.  Greedy decode is in test_torch_greedy.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icek_torch.decode import beam as tbeam
from icek_torch.decode import topk as ttopk
from icek_tpu.decode import beam as jbeam
from icek_tpu.decode import topk as jtopk
from test_torch_common import DECODE_CASES, decode_contexts, spy_kernel_calls


@pytest.mark.parametrize("k", [1, 3, 6])
def test_top_k_tie_contract(rng, k):
    """Values descending, ties to the lower index, like lax.top_k."""
    x = rng.integers(0, 4, (5, 3, 40)).astype(np.float32)   # many exact ties
    got_v, got_i = ttopk.top_k(torch.as_tensor(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    flat_v, flat_i = ttopk.top_k_two_stage(torch.as_tensor(x), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x).reshape(5, -1), k)
    np.testing.assert_array_equal(flat_i.numpy(), np.asarray(want_i))
    j2_v, j2_i = jtopk.top_k_two_stage(jnp.asarray(x), k)
    np.testing.assert_array_equal(flat_i.numpy(), np.asarray(j2_i))
    np.testing.assert_array_equal(flat_v.numpy(), np.asarray(j2_v))


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_beam5_tokens_match_jax(case, kernels):
    """Beam 5 with the megakernel and fused scores both off, and both on."""
    jc, tc, jp, tp, jctx, tctx, ids, L = decode_contexts(case, seed=2)
    with pltpu.force_tpu_interpret_mode():
        want_t, want_s = jbeam.beam_decode(
            jp, jc.model, *ids, jctx, L, beam_size=5,
            use_megakernel=kernels, use_fused_scores=kernels)
    got_t, got_s = tbeam.beam_decode(
        tp, tc.model, *ids, tctx, L, beam_size=5,
        use_megakernel=kernels, use_fused_scores=kernels)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


def test_beam_kernel_paths_agree_in_port():
    """The port's stock and kernel-switch paths give the same beams."""
    _, tc, _, tp, _, tctx, ids, L = decode_contexts("wide", seed=3)
    runs = [tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=3,
                              use_megakernel=m, use_fused_scores=f)
            for m, f in ((False, False), (True, False), (False, True))]
    for t, s in runs[1:]:
        np.testing.assert_array_equal(t.numpy(), runs[0][0].numpy())
        np.testing.assert_allclose(s.numpy(), runs[0][1].numpy(), atol=1e-5)


def test_unported_cases_raise():
    """What is not a mesh is refused as one (the mesh is ported:
    tests/test_torch_distributed.py).  The int8 KV options are ported
    (tests/test_torch_int8_kv.py); an unknown kv_dtype, and int8 with the
    decoder-step kernel asked for, raise ValueError as in JAX."""
    import dataclasses

    from icek_torch import eval_driver as tev

    _, tc, _, tp, _, tctx, ids, L = decode_contexts("tiny", seed=0)
    with pytest.raises(ValueError, match="kv_dtype"):
        tbeam.beam_decode(tp, tc.model, *ids, tctx, L, kv_dtype="int4")
    with pytest.raises(ValueError, match="megakernel"):
        tbeam.beam_decode(tp, tc.model, *ids, tctx, L, kv_dtype="int8", use_megakernel=True)
    int4 = tc.replace(decode=dataclasses.replace(tc.decode, kv_dtype="int4"))
    with pytest.raises(ValueError, match="kv_dtype"):
        tev.Evaluator(int4, None, {}, {}, device="cpu")
    with pytest.raises(TypeError, match="mesh must be a"):
        tev.Evaluator(tc, None, {}, {}, device="cpu", mesh=object())


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_beam_width_9_runs_through_the_kernels(case, monkeypatch):
    """Beam 9 (wider than the CUDA-core decoder step's 8 rows a block) with
    both kernel switches on: every step calls the score head and the decoder
    step, and gives the tokens of the run with both off and of JAX."""
    jc, tc, jp, tp, jctx, tctx, ids, L = decode_contexts(case, seed=4)
    calls = spy_kernel_calls(monkeypatch)
    got_t, got_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=9,
                                     use_megakernel=True, use_fused_scores=True)
    assert calls["fused_score_topk"] == calls["fused_beam_decoder_step"] > 0
    off_t, off_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=9,
                                     use_megakernel=False, use_fused_scores=False)
    assert calls["fused_score_topk"] == calls["fused_beam_decoder_step"]
    want_t, want_s = jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=9)
    np.testing.assert_array_equal(got_t.numpy(), off_t.numpy())
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), off_s.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_beam_width_17_runs_through_the_score_head(case, monkeypatch):
    """Beam 17 (wider than the score head's register lists) with both kernel
    switches on: every step calls the score head and the decoder step, and
    gives the tokens of the run with both off and of JAX."""
    jc, tc, jp, tp, jctx, tctx, ids, L = decode_contexts(case, seed=5)
    calls = spy_kernel_calls(monkeypatch)
    got_t, got_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=17,
                                     use_megakernel=True, use_fused_scores=True)
    assert calls["fused_score_topk"] == calls["fused_beam_decoder_step"] == L
    off_t, off_s = tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=17,
                                     use_megakernel=False, use_fused_scores=False)
    assert calls["fused_score_topk"] == calls["fused_beam_decoder_step"] == L
    want_t, want_s = jbeam.beam_decode(jp, jc.model, *ids, jctx, L, beam_size=17)
    np.testing.assert_array_equal(got_t.numpy(), off_t.numpy())
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), off_s.numpy(), atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


def test_score_head_route_predicate():
    """copy_scores.supports: widths 1 to V + T (the extended vocabulary, as
    lax.top_k takes); the wrapper refuses any other k, on the CPU too, and
    so does beam_decode before its first step; the tensor-core first pass
    takes aligned bf16 at every k (its lists in registers up to 16, in shared
    memory above) and aligned f32 up to k 16 (three TF32 products a
    product); f32 above 16 takes the wide CUDA-core pass."""
    from icek_torch.kernels import copy_scores as tcs

    assert [tcs.supports(k, 19) for k in (0, 1, 2, 5, 16, 17, 19, 20)] == [
        False] + [True] * 6 + [False]
    args = (torch.zeros(4, 8), torch.zeros(8, 16), torch.zeros(16), torch.zeros(4, 3))
    assert tcs.fused_score_topk(*args, k=17)[1].shape == (4, 17)
    assert tcs.fused_score_topk(*args, k=19)[1].shape == (4, 19)
    with pytest.raises(ValueError, match="k=20"):
        tcs.fused_score_topk(*args, k=20)
    h, wv = torch.zeros((4, 8), dtype=torch.bfloat16), torch.zeros((8, 16), dtype=torch.bfloat16)
    assert tcs.uses_tensor_cores(h, wv) and tcs.uses_tensor_cores(h.float(), wv.float())
    assert tcs.uses_tensor_cores(h, wv, k=17) and not tcs.uses_tensor_cores(h.float(), wv.float(),
                                                                          k=17)
    assert [tcs._max_tiles(k) for k in (1, 16, 17, 128, 129)] == [None] * 4 + [2]
    _, tc, _, tp, _, tctx, ids, L = decode_contexts("tiny", seed=0)
    S = ids[0] + ids[1]                           # V + E: geo's extended vocabulary
    with pytest.raises(ValueError, match=f"1 to {S}, not {S + 1}"):
        tbeam.beam_decode(tp, tc.model, *ids, tctx, L, beam_size=S + 1,
                          use_fused_scores=True)


def test_decoder_step_route_predicate_on_widths():
    """decoder_step.supports: the tensor-core route (bf16 or f32 with packed
    weights, any K: up to 16 G images a block, above in parts of an image)
    or the CUDA-core route (what it refuses: 12 heads, unpacked weights);
    no other dtype."""
    from icek_torch.kernels import decoder_step as tds
    from icek_torch.models import transformer as tfm

    dec = tfm.init_decoder_stack(torch.Generator().manual_seed(0), 2, 40, 64)
    f32, bf16 = (tds.stack_decoder_params(dec, dt) for dt in (torch.float32, torch.bfloat16))

    def caches(dt, K):
        return torch.zeros((2, 1, 4 * K, 40), dtype=dt)

    def ok(st, dt, K, H=4):
        return tds.supports(st, caches(dt, K), K, H)

    assert [ok(f32, torch.float32, K) for K in (0, 1, 5, 8, 9, 10, 17)] == [False] + [True] * 6
    assert [ok(bf16, torch.bfloat16, K) for K in (1, 9, 10, 16, 17)] == [True] * 5
    wide = [tds.uses_tensor_cores(bf16, caches(torch.bfloat16, K), K, 4) for K in (10, 16, 17)]
    assert wide == [True, True, True]                 # K 17: parts of an image
    assert [tds.uses_tensor_cores(f32, caches(torch.float32, K), K, 4) for K in (5, 20)] == [
        True, True]
    assert [tds.route(torch.bfloat16, K, True) for K in (16, 17)] == [
        "tensor_cores", "wide_tensor_cores"]
    assert [tds.route(torch.float32, K, True) for K in (5, 20)] == [
        "tensor_cores_f32", "wide_tensor_cores_f32"]
    assert [tds.image_parts(256, K, 132) for K in (16, 17, 20, 32, 33)] == [1, 2, 2, 2, 3]
    assert [tds.image_parts(32, K, 132) for K in (16, 17, 20, 32)] == [1, 3, 3, 4]
    unpacked = bf16._replace(mma=None)
    assert [ok(unpacked, torch.bfloat16, K) for K in (8, 9)] == [True, True]
    assert not tds.uses_tensor_cores(bf16, caches(torch.bfloat16, 9), 9, 12)   # 12 heads
    assert ok(bf16, torch.bfloat16, 9, H=12)          # ... take the CUDA-core route
    assert tds.route(torch.bfloat16, 9, False) == "cuda_cores"
    assert not ok(f32, torch.float16, 5)
