"""The serving kernels' plain versions (what each wrapper runs for CPU
tensors) against the JAX Pallas functions, run as tests/test_kernels.py
runs them on the CPU (the Pallas interpreter), and against the JAX
oracles (the flash backward is in tests/test_torch_norm.py).  The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances: attention outputs atol 2e-5 (as test_flash_mha_matches_oracle);
score values / lse atol 1e-4 with IDENTICAL top-k indices (as
test_fused_score_topk_matches_oracle); decoder-step hidden states and
K/V rows atol 2e-5 on layer-normed values of order 1.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icek_torch import bridge
from icek_torch.kernels import copy_scores as tcs
from icek_torch.kernels import decoder_step as tds
from icek_torch.kernels import flash_attention as tfa
from icek_tpu.kernels import copy_scores as jcs
from icek_tpu.kernels import decoder_step as jds
from icek_tpu.kernels import flash_attention as jfa


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,h", [(17, 17, 3), (13, 37, 3), (30, 301, 3), (19, 31, 10)])
def test_flash_plain_matches_pallas(rng, causal, tq, tk, h):
    B, Hd = 2, 30
    q, k, v = (rng.standard_normal((B, t, h, Hd)).astype(np.float32)
               for t in (tq, tk, tk))
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    oracle = jfa.reference_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal)
    got = tfa.flash_mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5)


@pytest.mark.parametrize("kv_len", [1, 20, 33])
def test_flash_plain_kv_len_masking(rng, kv_len):
    """Key columns at or beyond kv_len are masked (flash_mha_packed's
    kv_len, on head-packed inputs)."""
    B, tq, tk, H, Hd = 2, 9, 33, 3, 30
    q, k, v = (rng.standard_normal((B, t, H, Hd)).astype(np.float32)
               for t in (tq, tk, tk))
    slot = jfa.head_slot(Hd, jfa.resolve_slot())
    pack = lambda x: jfa.pack_heads(jnp.asarray(x).reshape(B, x.shape[1], H * Hd), H, slot)
    want = jfa.flash_mha_packed(pack(q), pack(k), pack(v), head_dim=Hd,
                                kv_len=kv_len, slot=slot)
    want = jfa.unpack_heads(want, H, Hd, slot).reshape(B, tq, H, Hd)
    got = tfa.flash_mha(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                        kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # masked keys really are ignored: truncating them gives the same result
    cut = tfa.flash_mha(torch.as_tensor(q), torch.as_tensor(k[:, :kv_len]),
                        torch.as_tensor(v[:, :kv_len]))
    np.testing.assert_allclose(got.numpy(), cut.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# fused score / top-k / logsumexp
# ---------------------------------------------------------------------------

def _jax_fused(h, wv, bv, tail, k):
    with pltpu.force_tpu_interpret_mode():
        return jcs.fused_score_topk(jnp.asarray(h), jnp.asarray(wv),
                                    jnp.asarray(bv), jnp.asarray(tail), k=k)


def _check_scores(h, wv, bv, tail, k, pallas=True):
    got = tcs.fused_score_topk(*(torch.as_tensor(a) for a in (h, wv, bv, tail)), k=k)
    wants = [jcs.reference_score_topk(jnp.asarray(h), jnp.asarray(wv),
                                      jnp.asarray(bv), jnp.asarray(tail), k=k)]
    if pallas:
        wants.append(_jax_fused(h, wv, bv, tail, k))
    for want in wants:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
    assert got[1].dtype == torch.int32
    return got


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("v", [1000, 1537])
def test_score_topk_plain_matches_pallas(rng, k, v):
    n, d, t = 16, 32, 37
    _check_scores(rng.standard_normal((n, d)).astype(np.float32),
                  rng.standard_normal((d, v)).astype(np.float32) * 0.1,
                  rng.standard_normal((v,)).astype(np.float32) * 0.01,
                  rng.standard_normal((n, t)).astype(np.float32), k)


def test_score_topk_plain_tail_winner(rng):
    n, d, v, t = 8, 16, 600, 21
    tail = np.full((n, t), -1.0, np.float32)
    tail[:, 7] = 5.0
    args = (rng.standard_normal((n, d)).astype(np.float32) * 0.01,
            np.zeros((d, v), np.float32), np.zeros((v,), np.float32), tail)
    vals, idx, _ = tcs.fused_score_topk(*(torch.as_tensor(a) for a in args), k=2)
    want_v, want_i, _ = _jax_fused(*args, 2)
    # the runner-up is a tie among signed zeros (h @ 0), which lax.top_k
    # orders by sign; the winner is what this case pins
    np.testing.assert_array_equal(idx.numpy()[:, 0], np.asarray(want_i)[:, 0])
    np.testing.assert_allclose(vals.numpy()[:, 0], np.asarray(want_v)[:, 0], atol=1e-5)
    assert np.all(idx.numpy()[:, 0] == v + 7)


@pytest.mark.parametrize("k", [3, 5])
def test_score_topk_plain_exact_ties(rng, k):
    """Exact ties go to the lowest flat index; vocab beats the tail.

    At k=5 the Pallas kernel departs from lax.top_k: its bubble insertion
    drops an incumbent displaced onto an equal later slot (it returns
    ..., 1, 2 where lax.top_k gives ..., 0, 1).  The port keeps the
    lax.top_k contract, so k=5 is held against the oracle only."""
    n, d, v, t = 4, 8, 520, 16
    bv = np.zeros((v,), np.float32)
    bv[3] = bv[400] = 2.0
    tail = np.zeros((n, t), np.float32)
    tail[:, 2] = 2.0
    _, idx, _ = _check_scores(np.zeros((n, d), np.float32),
                              np.zeros((d, v), np.float32), bv, tail, k,
                              pallas=k == 3)
    assert idx.numpy()[0].tolist() == [3, 400, v + 2, 0, 1][:k]


@pytest.mark.parametrize("k", [17, 40, 100])
def test_score_topk_plain_wide_k_matches_jax(rng, k):
    """Beams wider than 16: the plain version at k 17, 40 and 100 against
    JAX's reference_score_topk on tie-free inputs (continuous random
    scores), through fused_score_topk's CPU path and at rows whose
    extended vocabulary (V + T = 557) is wider than any k here."""
    n, d, v, t = 12, 24, 520, 37
    _check_scores(rng.standard_normal((n, d)).astype(np.float32),
                  rng.standard_normal((d, v)).astype(np.float32) * 0.1,
                  rng.standard_normal((v,)).astype(np.float32) * 0.01,
                  rng.standard_normal((n, t)).astype(np.float32), k, pallas=False)


# ---------------------------------------------------------------------------
# decoder-step megakernel
# ---------------------------------------------------------------------------

def _step_inputs(rng, B=2, K=3, L=6, M=11, D=16, H=2, i=3, seed=0):
    from icek_tpu.models import transformer as jtf

    layers = jax.tree.map(np.asarray, jtf.init_decoder_stack(
        jax.random.PRNGKey(seed), 2, D, 24))
    nL = 2
    x = rng.standard_normal((B, K, D)).astype(np.float32)
    ck = np.zeros((nL, B, L * K, D), np.float32)
    cv = np.zeros((nL, B, L * K, D), np.float32)
    ck[:, :, :i * K] = rng.standard_normal((nL, B, i * K, D))
    cv[:, :, :i * K] = rng.standard_normal((nL, B, i * K, D))
    xk = rng.standard_normal((nL, B, M, D)).astype(np.float32)
    xv = rng.standard_normal((nL, B, M, D)).astype(np.float32)
    anc = rng.integers(0, K, (B, K, L)).astype(np.int32)
    anc[:, :, i:] = np.arange(K)[None, :, None]   # own slot from step i on
    return layers, x, ck, cv, xk, xv, anc, i, H


def test_decoder_step_plain_matches_pallas_and_stock(rng):
    """One step: the port's plain version against JAX
    fused_beam_decoder_step (Pallas interpreter) and JAX _beam_decoder_step."""
    from icek_tpu.decode import beam as jbeam

    layers, x, ck, cv, xk, xv, anc, i, H = _step_inputs(rng)
    nL, B, LK, D = ck.shape
    K, L, M = x.shape[1], anc.shape[2], xk.shape[2]
    jlayers = jax.tree.map(jnp.asarray, layers)

    stacked = tds.stack_decoder_params(bridge.to_torch(layers))
    got_h, got_k, got_v = tds.fused_beam_decoder_step(
        stacked, torch.as_tensor(x), torch.as_tensor(anc), torch.as_tensor(ck),
        torch.as_tensor(cv), torch.as_tensor(xk), torch.as_tensor(xv), i,
        num_heads=H)

    # JAX megakernel: one-hot ancestry selector, lane-padded cross K/V
    jst = jds.stack_decoder_params(jlayers, H, K, L)
    cross = [{"k": jnp.asarray(xk[l]).reshape(B, M, H, D // H),
              "v": jnp.asarray(xv[l]).reshape(B, M, H, D // H)} for l in range(nL)]
    pk, pv, mem_len = jds.pad_cross_kv(cross, jnp.float32)
    sel = jax.nn.one_hot(jnp.asarray(anc), K, dtype=jnp.float32).reshape(B, K, L * K)
    want_h, want_k, want_v = jds.fused_beam_decoder_step(
        jst, jnp.asarray(x), sel, jnp.asarray(ck), jnp.asarray(cv), pk, pv, i,
        num_heads=H, head_dim=D // H, mem_len=mem_len)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), atol=2e-5)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=2e-5)

    # JAX stock step (head-mask GEMM formulation), caches written at i*K
    caches = [{"k": jnp.asarray(ck[l]), "v": jnp.asarray(cv[l])} for l in range(nL)]
    stock_h, stock_caches = jbeam._beam_decoder_step(
        jlayers, jnp.asarray(x), caches, jnp.asarray(anc), i, cross, H,
        jbeam._head_mask(H, D // H), jbeam._group_matrix(L, K), jnp.float32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(stock_h), atol=2e-5)
    for l in range(nL):
        np.testing.assert_allclose(
            got_k[l].numpy(), np.asarray(stock_caches[l]["k"])[:, i * K:(i + 1) * K],
            atol=2e-5)


def test_decoder_step_first_step(rng):
    """Step 0 (no history): only the explicit current-step term."""
    layers, x, ck, cv, xk, xv, anc, i, H = _step_inputs(rng, i=0, seed=1)
    from icek_tpu.decode import beam as jbeam

    nL, B, LK, D = ck.shape
    K, L, M = x.shape[1], anc.shape[2], xk.shape[2]
    jlayers = jax.tree.map(jnp.asarray, layers)
    cross = [{"k": jnp.asarray(xk[l]).reshape(B, M, H, D // H),
              "v": jnp.asarray(xv[l]).reshape(B, M, H, D // H)} for l in range(nL)]
    caches = [{"k": jnp.asarray(ck[l]), "v": jnp.asarray(cv[l])} for l in range(nL)]
    want_h, _ = jbeam._beam_decoder_step(
        jlayers, jnp.asarray(x), caches, jnp.asarray(anc), 0, cross, H,
        jbeam._head_mask(H, D // H), jbeam._group_matrix(L, K), jnp.float32)
    got_h, _, _ = tds.fused_beam_decoder_step(
        tds.stack_decoder_params(bridge.to_torch(layers)), torch.as_tensor(x),
        torch.as_tensor(anc), torch.as_tensor(ck), torch.as_tensor(cv),
        torch.as_tensor(xk), torch.as_tensor(xv), 0, num_heads=H)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)
