"""Port transformer (icek_torch/models/transformer.py) against the JAX
functions on the same numpy inputs, at float32 on the CPU.

Tolerance: atol 1e-5 on outputs of order 1 (the same math in another
summation order; the flash branch adds the JAX kernel's scale-first
product, still well inside it).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.models import transformer as ttf
from icek_tpu.models import transformer as jtf

ATOL = 1e-5
D, H = 40, 4


def _mha_pair(seed=0):
    p = jax.tree.map(np.asarray, jtf.init_mha(jax.random.PRNGKey(seed), D))
    p["qkv_b"] = np.random.default_rng(seed).standard_normal(3 * D).astype(np.float32) * 0.1
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_linear_and_layer_norm(rng):
    p = {"w": rng.standard_normal((D, 24)).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    x = rng.standard_normal((3, 5, D)).astype(np.float32)
    tp = bridge.to_torch(p)
    _close(ttf.linear(tp, torch.as_tensor(x)),
           jtf.linear(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    ln = {"scale": rng.standard_normal(D).astype(np.float32),
          "bias": rng.standard_normal(D).astype(np.float32)}
    _close(ttf.layer_norm(bridge.to_torch(ln), torch.as_tensor(x * 3)),
           jtf.layer_norm(jax.tree.map(jnp.asarray, ln), jnp.asarray(x * 3)))


@pytest.mark.parametrize("masked", [False, True])
def test_mha_full_sequence(rng, masked):
    jp, tp = _mha_pair()
    q = rng.standard_normal((2, 9, D)).astype(np.float32)
    kv = rng.standard_normal((2, 11, D)).astype(np.float32)
    if masked:
        kv = q
    jm = jtf.causal_mask(9) if masked else None
    tm = ttf.causal_mask(9) if masked else None
    want, _ = jtf.multi_head_attention(jp, jnp.asarray(q), jnp.asarray(kv), H, attn_mask=jm)
    got, _ = ttf.multi_head_attention(tp, torch.as_tensor(q), torch.as_tensor(kv), H, attn_mask=tm)
    _close(got, want)


def test_mha_kv_cache_branch(rng):
    """One decode step writing into the cache at cache_index, with the
    -inf mask past the current step."""
    jp, tp = _mha_pair(1)
    B, T, Hd = 2, 6, D // H
    cache_k = rng.standard_normal((B, T, H, Hd)).astype(np.float32)
    cache_v = rng.standard_normal((B, T, H, Hd)).astype(np.float32)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    for idx in (0, 3):
        want, wcache = jtf.multi_head_attention(
            jp, jnp.asarray(x), jnp.asarray(x), H,
            kv_cache={"k": jnp.asarray(cache_k), "v": jnp.asarray(cache_v)},
            cache_index=jnp.int32(idx))
        tcache = {"k": torch.as_tensor(cache_k.copy()), "v": torch.as_tensor(cache_v.copy())}
        got, gcache = ttf.multi_head_attention(
            tp, torch.as_tensor(x), torch.as_tensor(x), H, kv_cache=tcache,
            cache_index=idx)
        _close(got, want)
        _close(gcache["k"], wcache["k"])
        _close(gcache["v"], wcache["v"])


@pytest.mark.parametrize("groups", [1, 3])
def test_mha_precomputed_kv_branch(rng, groups):
    """Precomputed memory K/V, also shared by beam groups (KV batch
    smaller than the query batch: the fold at transformer.py:222-234)."""
    jp, tp = _mha_pair(2)
    B, Tq, M, Hd = 2, 1, 13, D // H
    k = rng.standard_normal((B, M, H, Hd)).astype(np.float32)
    v = rng.standard_normal((B, M, H, Hd)).astype(np.float32)
    x = rng.standard_normal((B * groups, Tq, D)).astype(np.float32)
    want, _ = jtf.multi_head_attention(
        jp, jnp.asarray(x), None, H,
        precomputed_kv={"k": jnp.asarray(k), "v": jnp.asarray(v)})
    got, _ = ttf.multi_head_attention(
        tp, torch.as_tensor(x), None, H,
        precomputed_kv={"k": torch.as_tensor(k), "v": torch.as_tensor(v)})
    _close(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_branch(rng, causal):
    """The flash branch (kernel's plain version on CPU) against the JAX
    flash branch run through the Pallas interpreter, and against the
    port's own stock branch."""
    jp, tp = _mha_pair(3)
    x = rng.standard_normal((2, 21, D)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    want, _ = jtf.multi_head_attention(
        jp, jx, jx, H, attn_mask=jtf.causal_mask(21) if causal else None,
        flash=True, causal=causal)
    got, _ = ttf.multi_head_attention(
        tp, tx, tx, H, attn_mask=ttf.causal_mask(21) if causal else None,
        flash=True, causal=causal)
    stock, _ = ttf.multi_head_attention(
        tp, tx, tx, H, attn_mask=ttf.causal_mask(21) if causal else None)
    _close(got, want)
    _close(got, stock)


@pytest.mark.parametrize("flash", [False, True])
def test_encoder_stack(rng, flash):
    params = jax.tree.map(np.asarray, jtf.init_encoder_stack(
        jax.random.PRNGKey(4), 2, D, 24))
    x = rng.standard_normal((2, 17, D)).astype(np.float32)
    want = jtf.encoder_stack(jax.tree.map(jnp.asarray, params), jnp.asarray(x), H)
    got = ttf.encoder_stack(bridge.to_torch(params), torch.as_tensor(x),
                            H, flash=flash)
    _close(got, want)


def test_decoder_stack_and_cross_kv(rng):
    """Teacher-forced decoder stack (causal), the precomputed cross K/V,
    and single-step decode through the per-layer caches."""
    params = jax.tree.map(np.asarray, jtf.init_decoder_stack(
        jax.random.PRNGKey(5), 2, D, 24))
    jp, tp = jax.tree.map(jnp.asarray, params), bridge.to_torch(params)
    B, T, M = 2, 5, 9
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mem = rng.standard_normal((B, M, D)).astype(np.float32)
    want, _ = jtf.decoder_stack(jp, jnp.asarray(x), jnp.asarray(mem), H,
                                causal_mask=jtf.causal_mask(T))
    got, _ = ttf.decoder_stack(tp, torch.as_tensor(x), torch.as_tensor(mem), H,
                               causal_mask=ttf.causal_mask(T))
    _close(got, want)

    jcross = jtf.precompute_cross_kv(jp, jnp.asarray(mem), H)
    tcross = ttf.precompute_cross_kv(tp, torch.as_tensor(mem), H)
    for jc, tc in zip(jcross, tcross):
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])

    jcache = jtf.init_self_kv_cache(2, B, T, H, D // H)
    tcache = ttf.init_self_kv_cache(2, B, T, H, D // H)
    for i in range(T):
        step = x[:, i:i + 1]
        jh, jcache = jtf.decoder_stack(jp, jnp.asarray(step), None, H,
                                       kv_caches=jcache, cache_index=jnp.int32(i),
                                       cross_kvs=jcross)
        th, tcache = ttf.decoder_stack(tp, torch.as_tensor(step), None, H,
                                       kv_caches=tcache, cache_index=i,
                                       cross_kvs=tcross)
        _close(th, jh)
        # the step equals row i of the teacher-forced pass
        _close(th[:, 0], got[:, i])


def test_tables():
    np.testing.assert_array_equal(ttf.sinusoidal_positions(30, 300),
                                  jtf.sinusoidal_positions(30, 300))
    np.testing.assert_array_equal(ttf.causal_mask(6).numpy(),
                                  np.asarray(jtf.causal_mask(6)))


def test_active_dropout_raises(rng):
    """An active dropout without a generator raises on both branches (as
    the JAX flash branch does without a key); it no longer raises for
    being unported."""
    _, tp = _mha_pair()
    x = torch.as_tensor(rng.standard_normal((1, 3, D)).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        ttf.multi_head_attention(tp, x, x, H, dropout_rate=0.1, deterministic=False)
    with pytest.raises(ValueError, match="Generator"):
        ttf.multi_head_attention(tp, x, x, H, dropout_rate=0.1,
                                 deterministic=False, flash=True)


@pytest.mark.parametrize("flash", [False, True])
def test_mha_dropout_runs_and_follows_the_generator(rng, flash):
    """rate > 0: the output differs from the deterministic one, the same
    generator seed repeats it and another seed changes it."""
    _, tp = _mha_pair()
    x = torch.as_tensor(rng.standard_normal((2, 9, D)).astype(np.float32))
    run = lambda seed: ttf.multi_head_attention(
        tp, x, x, H, dropout_rate=0.3, deterministic=False, flash=flash,
        gen=torch.Generator().manual_seed(seed))[0]
    base, _ = ttf.multi_head_attention(tp, x, x, H, flash=flash)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, base)
    assert torch.isfinite(a).all()


def test_stock_dropout_statistics():
    """dropout(): keep rate within 0.01 of 1 - rate, survivors scaled by
    1 / (1 - rate), deterministic passes untouched."""
    x = torch.ones((400, 250))
    gen = torch.Generator().manual_seed(0)
    y = ttf.dropout(x, 0.2, gen, False)
    assert abs(float((y != 0).float().mean()) - 0.8) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1.25))
    assert ttf.dropout(x, 0.2, None, True) is x
    assert ttf.dropout(x, 0.0, None, False) is x


@pytest.mark.parametrize("fused", [False, True])
def test_stacks_with_dropout_thread_one_generator(rng, fused):
    """Encoder and decoder stacks with rate > 0 on the CPU, stock and fused
    (kernel wrappers' plain versions) routes: finite, reproducible from the
    generator seed, and each dropout site advances the generator."""
    enc = bridge.to_torch(jax.tree.map(np.asarray, jtf.init_encoder_stack(
        jax.random.PRNGKey(6), 2, D, 24)))
    dec = bridge.to_torch(jax.tree.map(np.asarray, jtf.init_decoder_stack(
        jax.random.PRNGKey(7), 2, D, 24)))
    x = torch.as_tensor(rng.standard_normal((2, 11, D)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((2, 5, D)).astype(np.float32))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        mem = ttf.encoder_stack(enc, x, H, 0.2, gen, False, flash=fused)
        state = gen.get_state().clone()
        out, _ = ttf.decoder_stack(dec, y, mem, H, causal_mask=ttf.causal_mask(5),
                                   rate=0.2, gen=gen, deterministic=False,
                                   flash=fused)
        assert not torch.equal(state, gen.get_state())
        return mem, out

    (m1, o1), (m2, o2), (m3, o3) = run(3), run(3), run(4)
    assert torch.equal(m1, m2) and torch.equal(o1, o2)
    assert not torch.equal(m1, m3) and not torch.equal(o1, o3)
    assert torch.isfinite(o1).all()
