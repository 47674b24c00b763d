"""The plain versions of the training kernels (what
``icek_torch/kernels/fused_norm.py`` and the flash backward run for CPU
tensors, and what the CUDA kernels are held against on the card) against
the JAX package, plus the dropout contracts a CPU run can show.

Tolerances: rate 0 against stock ``layer_norm`` under ``jax.grad``, value
atol 2e-5, the four gradients atol 3e-4 / rtol 1e-4 (the bounds of
tests/test_kernels.py::test_fused_norm_matches_stock_layer_norm: sums over
530 rows in another order).  Flash dq / dk / dv against jax.vjp of the
Pallas kernel in interpret mode: atol 2e-5.  Keep rates within 0.01 of 1 - rate over at
least 50,000 elements.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import flash_attention as tfa
from icek_torch.kernels import fused_norm as tfn
from icek_tpu.kernels import flash_attention as jfa
from icek_tpu.kernels import fused_norm as jfn
from icek_tpu.models import transformer as jtf

N, D = 530, 36     # rows not a multiple of any block, as the JAX test


def _ln_inputs(rng):
    x, h = (rng.standard_normal((2, N // 2, D)).astype(np.float32) for _ in range(2))
    scale, bias = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    return x, h, scale, bias


def test_dropout_add_ln_rate0_matches_stock_layer_norm(rng):
    """Value and all four gradients of sum(sin(y)) against the stock JAX
    layer_norm(x + h) (not the Pallas backward, which jax 0.9 rejects)."""
    x, h, scale, bias = _ln_inputs(rng)

    def loss_ref(x_, h_, s_, b_):
        return jnp.sum(jnp.sin(jtf.layer_norm({"scale": s_, "bias": b_}, x_ + h_)))

    want = jtf.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                          jnp.asarray(x + h))
    want_g = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, h, scale, bias)))
    args = [torch.tensor(a, requires_grad=True) for a in (x, h, scale, bias)]
    got = tfn.dropout_add_ln(*args, rate=0.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    torch.sin(got).sum().backward()
    for t, g in zip(args, want_g):
        assert t.grad.shape == t.shape          # (D,) grads for (D,) parameters
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=3e-4, rtol=1e-4)


def test_dropout_add_ln_rate0_matches_pallas_forward(rng):
    """The forward against the Pallas kernel in interpret mode."""
    x, h, scale, bias = _ln_inputs(rng)
    want = jfn.dropout_add_ln(*(jnp.asarray(a) for a in (x, h, scale, bias)), rate=0.0)
    got = tfn.dropout_add_ln(*(torch.as_tensor(a) for a in (x, h, scale, bias)),
                             rate=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_dropout_add_ln_keeps_the_compute_dtype(rng):
    """bf16 in, bf16 out, statistics in float32: the bf16 result is the
    rounded float32 result of the same (bf16-valued) inputs."""
    x, h, scale, bias = (torch.as_tensor(a) for a in _ln_inputs(rng))
    xb, hb = x.bfloat16(), h.bfloat16()
    got = tfn.dropout_add_ln(xb, hb, scale, bias, rate=0.0)
    assert got.dtype == torch.bfloat16
    want = tfn.dropout_add_ln(xb.float(), hb.float(), scale, bias, rate=0.0)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_hw_dropout_statistics_and_seed(rate):
    h = torch.full((300, 512), 2.0)
    y = tfn.hw_dropout(h, rate=rate, seed=11)
    keep = y != 0
    assert abs(float(keep.float().mean()) - (1 - rate)) < 0.01
    torch.testing.assert_close(y[keep], torch.full_like(y[keep], 2.0 / (1 - rate)))
    assert torch.equal(y, tfn.hw_dropout(h, rate=rate, seed=11))
    assert not torch.equal(y, tfn.hw_dropout(h, rate=rate, seed=12))
    assert tfn.hw_dropout(h, rate=0.0) is h
    with pytest.raises(ValueError, match="seed"):
        tfn.hw_dropout(h, rate=rate)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_hw_dropout_forward_and_backward_see_one_mask(rng, rate):
    """The output is linear in h for a fixed mask, so <f(h), g> == <h, df/dh(g)>
    holds iff forward and backward saw the same mask; and the gradient is g
    scaled on the kept elements, zero elsewhere."""
    h = torch.tensor(rng.standard_normal((64, 40)).astype(np.float32), requires_grad=True)
    g = torch.as_tensor(rng.standard_normal((64, 40)).astype(np.float32))
    y = tfn.hw_dropout(h, rate=rate, seed=5)
    (dh,) = torch.autograd.grad(y, h, g)
    np.testing.assert_allclose((y * g).sum().item(), (h * dh).sum().item(), rtol=1e-5)
    keep = y != 0
    torch.testing.assert_close(dh, torch.where(keep, g / (1 - rate), 0.0))


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_add_ln_dropout_contract(rng, rate):
    """rate > 0: same seed, same output; the wrapper equals the plain
    version under the explicit mask of that seed; dh is zero exactly where
    the forward dropped h, and equals dx / (1 - rate) where it kept it."""
    x, h, scale, bias = (torch.tensor(a, requires_grad=True) for a in _ln_inputs(rng))
    y = tfn.dropout_add_ln(x, h, scale, bias, rate=rate, seed=9)
    assert torch.equal(y, tfn.dropout_add_ln(x, h, scale, bias, rate=rate, seed=9))
    assert not torch.equal(y, tfn.dropout_add_ln(x, h, scale, bias, rate=rate, seed=10))
    keep = torch.rand(h.shape, generator=torch.Generator().manual_seed(9)) < 1 - rate
    assert abs(float(keep.float().mean()) - (1 - rate)) < 0.01
    want = tfn.reference_dropout_add_ln(x, h, scale, bias, rate=rate, keep=keep)
    assert torch.equal(y, want)
    dx, dh = torch.autograd.grad(torch.sin(y).sum(), (x, h))
    assert not dh[~keep].any()
    torch.testing.assert_close(dh[keep], dx[keep] / (1 - rate))
    # and it is the layer norm of x + masked h
    z = x + torch.where(keep, h / (1 - rate), 0.0)
    stock = torch.nn.functional.layer_norm(z, (D,), scale, bias, 1e-5)
    torch.testing.assert_close(y, stock, rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_mha_dropout_statistics(rng, causal):
    """v is a (Tk x Hd) basis, so the output reads the dropped weight matrix:
    drop rate within 0.01 of the rate, survivors scaled by 1 / (1 - rate)."""
    B, Tq, Tk, H, Hd, rate = 4, 64, 24, 10, 30, 0.2
    q, k = (torch.as_tensor(rng.standard_normal((B, t, H, Hd)).astype(np.float32))
            for t in (Tq, Tk))
    v = torch.eye(Tk, Hd)[None, :, None, :].expand(B, Tk, H, Hd)
    p = tfa.flash_mha(q, k, v, causal=causal)[..., :Tk]
    pd = tfa.flash_mha(q, k, v, causal=causal, dropout_rate=rate, seed=1234)[..., :Tk]
    assert torch.equal(pd, tfa.flash_mha(q, k, v, causal=causal, dropout_rate=rate,
                                         seed=1234)[..., :Tk])
    live = p > 0                        # causal rows see only their prefix
    assert abs(float((pd[live] == 0).float().mean()) - rate) < 0.01
    survivors = pd != 0
    torch.testing.assert_close(pd[survivors], (p / (1 - rate))[survivors],
                               rtol=1e-5, atol=0)
    pd3 = tfa.flash_mha(q, k, v, causal=causal, dropout_rate=rate, seed=99)[..., :Tk]
    assert float(((pd3 == 0) != (pd == 0))[live].float().mean()) > 0.1
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_mha(q, k, v, dropout_rate=rate)


def test_reference_mha_forward_and_backward_see_one_mask(rng):
    """The output is linear in v for a fixed mask: <f(v), g> == <v, df/dv(g)>."""
    B, Tq, Tk, H, Hd, rate = 2, 32, 301, 10, 30, 0.3
    q, k, v, g = (torch.as_tensor(rng.standard_normal((B, t, H, Hd)).astype(np.float32))
                  for t in (Tq, Tk, Tk, Tq))
    v.requires_grad_(True)
    out = tfa.flash_mha(q, k, v, dropout_rate=rate, seed=7)
    (dv,) = torch.autograd.grad(out, v, g)
    np.testing.assert_allclose((out * g).sum().item(), (v * dv).sum().item(), rtol=1e-4)


def test_reference_mha_explicit_keep_mask(rng):
    """`keep` masks the softmax weights and scales the survivors."""
    B, Tq, Tk, H, Hd, rate = 2, 7, 9, 3, 30, 0.25
    q, k, v = (torch.as_tensor(rng.standard_normal((B, t, H, Hd)).astype(np.float32))
               for t in (Tq, Tk, Tk))
    keep = torch.as_tensor(rng.random((B, H, Tq, Tk)) < 0.75)
    got = tfa.reference_mha(q, k, v, dropout_rate=rate, keep=keep)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / Hd ** 0.5, dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.where(keep, w / 0.75, 0.0), v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert tfa.keep_threshold(0.2) == int(0.8 * (1 << 24))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(17, 17), (13, 37), (30, 301)])
def test_flash_plain_backward_matches_pallas_vjp(rng, causal, tq, tk):
    """dq / dk / dv of the plain version (autograd) against jax.vjp of the
    Pallas flash_mha in interpret mode, rate 0; atol 2e-5."""
    B, H, Hd = 2, 3, 30
    q, k, v, g = (rng.standard_normal((B, t, H, Hd)).astype(np.float32)
                  for t in (tq, tk, tk, tq))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tfa.flash_mha(tq_, tk_, tv_, causal=causal)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), torch.as_tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
