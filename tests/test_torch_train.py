"""The port's train and eval steps (icek_torch/train/step.py) against the
JAX package on the same numpy inputs and params, float32 on the CPU, small
geo model (d=40, 4 heads, V=60, E=9, T=7).  The forward and the loss on
their own are in tests/test_torch_captioner.py, which shares the helpers
below.

Tolerances.  Loss 1e-5 relative.  Clipped gradients atol 1e-5 (read from
the JAX step as 10 x Adam's first moment after the first step, which is
0.1 x the clipped gradient), Adam's first moment atol 1e-6 (= 0.1 x the
gradient bound) and second moment atol 1e-8.  Adam's update is
lr * m / (sqrt(v) + eps), about lr * sign(g) on the first step, so where a
gradient is numerical noise around zero (the key bias of every attention,
whose true gradient is 0) the two packages may step +-lr apart.  Updated
params are therefore compared to atol 0.02 * lr where the first step's
|gradient| exceeds 1e-6, and elsewhere only held to Adam's bound of
steps * lr (plus 2%) from the initial value.
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
from icek_tpu.train import step as jstep
from test_torch_common import entity_rows, jax_params_numpy, small_cfgs

V, E, T, P, PAD = 60, 9, 7, 12, 0
LR = 1e-3


def _cfgs(layers=1, flash=None, **drop):
    jc, tc = small_cfgs(emb_dim=40, num_heads=4, ffn=64, layers=layers, type_vocab=20)
    out = []
    for c in (jc, tc):
        out.append(c.replace(
            model=dataclasses.replace(c.model, use_flash_attention=flash, **drop),
            train=dataclasses.replace(c.train, grad_accum_steps=1)))
    return tuple(out)


def _batch(B, seed=0):
    """Captions with a few entity ids (>= V, mask 1), <pad> tails and
    lengths shorter than T."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, V, (B, T)).astype(np.int32)
    caps[:, 0] = V - 2
    caps[rng.random((B, T)) < 0.15] = V + rng.integers(0, E)
    lengths = rng.integers(2, T + 1, (B,)).astype(np.int32)
    lengths[0] = T
    for b in range(B):
        caps[b, lengths[b]:] = PAD
    caps[1, 2] = PAD                      # a <pad> target inside the length
    mask = (caps >= V).astype(np.int32)
    return {
        "caption_ids": caps, "caption_mask": mask, "lengths": lengths,
        "entity_features": entity_rows(rng, B, E, 20),
        "image_tokens": rng.standard_normal((B, P, 40)).astype(np.float32),
    }


def _params(jc, tc, seed=0):
    tree = jax_params_numpy(jc.model, V, seed)
    return jax.tree.map(jnp.asarray, tree), bridge.trainable(
        bridge.from_jax_params(tree, tc.model, V), "cpu")


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_scores(tc, tp, batch, **kw):
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    return tcap.captioner_forward(
        tp, tc.model, V, PAD, b["caption_ids"].long(), b["caption_mask"].long(),
        b["image_tokens"], b["entity_features"], **kw)


@functools.lru_cache(maxsize=None)
def _jax_steps(accum=1):
    jc, _ = _cfgs()
    jc = jc.replace(train=dataclasses.replace(jc.train, grad_accum_steps=accum))
    opt = jstep.make_optimizer(LR)
    return opt, jstep.make_train_step(jc, V, PAD, opt, encode_images=False)


def _adam_moments(opt_state):
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append((node.mu, node.nu))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


def test_train_step_matches_jax_after_1_and_3_steps():
    jc, tc = _cfgs()
    jp, tp = _params(jc, tc)
    batch = _batch(4)
    init = [a.copy() for a in _leaves(jp)]     # the JAX step donates its params
    jopt, (jtrain, _) = _jax_steps()
    jstate = jopt.init(jp)

    # the port's clipped gradients on the initial params
    loss, _ = tstep.caption_loss(_port_scores(tc, tp, batch),
                                 torch.as_tensor(batch["caption_ids"]),
                                 torch.as_tensor(batch["lengths"]), PAD)
    loss.backward()
    ggrads = [np.clip(g, -5.0, 5.0) for g in _leaves(bridge.grads_to_numpy(tp))]
    for p in jax.tree.leaves(tp):
        p.grad = None

    topt = tstep.make_optimizer(LR)
    tstate = topt.init(tp)
    ttrain, _ = tstep.make_train_step(tc, V, PAD, topt, encode_images=False,
                                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    for step in (1, 2, 3):
        jp, jstate, jl, jn = jtrain(jp, jstate, None, batch, jax.random.PRNGKey(step))
        out = ttrain(tp, tstate, None, batch, gen)
        assert out[0] is tp and out[1] is tstate          # updated in place
        assert int(out[3]) == int(jn)
        np.testing.assert_allclose(float(out[2]), float(jl), rtol=1e-5)
        if step == 2:
            continue
        mu, nu = tstate.moments(tp)
        jmu, jnu = _adam_moments(jstate)
        if step == 1:      # the clipped gradient tree, leaf by leaf
            wgrads = [10.0 * m for m in _leaves(jmu)]
            assert len(ggrads) == len(wgrads)
            for g, w in zip(ggrads, wgrads):
                np.testing.assert_allclose(g, w, atol=1e-5)
            solid = [np.abs(w) > 1e-6 for w in wgrads]
        for a, b in zip(_leaves(bridge.to_numpy(mu)), _leaves(jmu)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        for a, b in zip(_leaves(bridge.to_numpy(nu)), _leaves(jnu)):
            np.testing.assert_allclose(a, b, atol=1e-8)
        for a, b, p0, m in zip(_leaves(bridge.to_numpy(tp)), _leaves(jp), init, solid):
            np.testing.assert_allclose(a[m], b[m], atol=0.02 * LR)
            assert np.abs(a - p0).max() <= step * LR * 1.02
        assert all(p.grad is None for p in jax.tree.leaves(tp))
    assert float(out[2]) < loss.item()                    # training went downhill


def test_eval_step_matches_jax():
    jc, tc = _cfgs()
    jp, tp = _params(jc, tc, seed=1)
    batch = _batch(4, seed=1)
    _, (_, jeval) = _jax_steps()
    want, wn = jeval(jp, None, batch)
    _, teval = tstep.make_train_step(tc, V, PAD, tstep.make_optimizer(LR),
                                     encode_images=False, device="cpu")
    got, n = teval(tp, None, batch)
    assert int(n) == int(wn) and not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _port_step(tc, batch, accum, seed=0, **drop):
    tc = tc.replace(
        model=dataclasses.replace(tc.model, **drop),
        train=dataclasses.replace(tc.train, grad_accum_steps=accum))
    jc, _ = _cfgs()
    _, tp = _params(jc, tc)
    opt = tstep.make_optimizer(LR)
    state = opt.init(tp)
    train, _ = tstep.make_train_step(tc, V, PAD, opt, encode_images=False, device="cpu")
    _, _, loss, count = train(tp, state, None, batch,
                              torch.Generator().manual_seed(seed))
    mu, _ = state.moments(tp)
    return float(loss), int(count), _leaves(bridge.to_numpy(mu))


@pytest.mark.parametrize("B,accum", [(8, 2), (8, 4), (5, 2)])
def test_grad_accum_equals_the_full_batch(B, accum):
    """N microbatches of the summed NLL, scaled once by 1 / total tokens,
    equal the monolithic step (B=5 with N=2 zero-pads the tail) and the JAX
    monolithic step.  Adam's first moment is 0.1 x the clipped gradient, so
    it pins the gradients: atol 1e-6."""
    _, tc = _cfgs()
    batch = _batch(B, seed=2)
    loss1, n1, mu1 = _port_step(tc, batch, 1)
    lossN, nN, muN = _port_step(tc, batch, accum)
    assert n1 == nN
    np.testing.assert_allclose(lossN, loss1, rtol=1e-6)
    for a, b in zip(muN, mu1):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jc, _ = _cfgs()
    jp, _ = _params(jc, tc)
    jopt, (jtrain, _) = _jax_steps()
    _, _, jl, jn = jtrain(jp, jopt.init(jp), None, batch, jax.random.PRNGKey(0))
    assert int(jn) == nN
    np.testing.assert_allclose(lossN, float(jl), rtol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_train_step_with_dropout_follows_the_generator(flash):
    """Dropout rates > 0 on the CPU (stock route, and the kernel wrappers'
    plain versions with flash on): finite loss and gradients, the same
    generator seed gives the same loss, another seed another."""
    _, tc = _cfgs(flash=flash)
    batch = _batch(4, seed=4)
    drop = dict(dropout_enc=0.2, dropout_dec=0.2, dropout_pos=0.1)
    a = _port_step(tc, batch, 1, seed=1, **drop)
    b = _port_step(tc, batch, 1, seed=1, **drop)
    c = _port_step(tc, batch, 1, seed=2, **drop)
    base = _port_step(tc, batch, 1, seed=1)
    assert np.isfinite(a[0]) and all(np.isfinite(m).all() for m in a[2])
    assert a[0] == b[0] and a[0] != c[0] and a[0] != base[0]
    assert a[1] == base[1]
    # two microbatches draw different masks
    d = _port_step(tc, batch, 2, seed=1, **drop)
    assert np.isfinite(d[0]) and d[1] == a[1]


def test_optimizer_helpers():
    assert tstep.resolve_grad_accum(1) == 1
    assert tstep.resolve_grad_accum(4, "geo", 32) == 4
    assert tstep.resolve_grad_accum(None) == 1 and tstep.resolve_grad_accum(0) == 1
    assert tstep.resolve_grad_accum("auto", "geo", 256) == 1
    w = torch.zeros(3, requires_grad=True)
    opt = tstep.make_optimizer(0.5, grad_clip=5.0)
    state = opt.init({"w": w})
    w.grad = torch.tensor([100.0, -100.0, 1.0])
    opt.update(state)
    mu, nu = state.moments({"w": w})
    # the clamp comes before Adam: the first moment is 0.1 * clip(g)
    torch.testing.assert_close(mu["w"], torch.tensor([0.5, -0.5, 0.1]))
    torch.testing.assert_close(w.detach(), torch.tensor([-0.5, 0.5, -0.5]))
    assert tstep.decay_learning_rate(state, 0.8) is state
    assert state.hyperparams["learning_rate"] == pytest.approx(0.4)
    assert state.adam.param_groups[0]["lr"] == pytest.approx(0.4)
