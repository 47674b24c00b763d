"""The train step's image-carrying options (icek_torch/train/step.py)
against ``icek_tpu.train.step`` after 1 and 2 steps, f32 on the CPU, at a
small geo model (d 16, 2 heads, one layer) over ResNet-101 at 64x64 images,
batch 2, dropout 0 (so the two packages' RNGs do not matter):
``encode_images=True`` with the frozen encoder, fine-tuning
(``make_encoder_optimizer``: clip + Adam over layers 2-4 and the
projection) and ``bn_train_mode`` (batch statistics, momentum update of the
running buffers).  Also: the device token cache's gather equals the
image-token step bit for bit, ``encoder_trainable_mask`` equals JAX's, and
the refusals.

Tolerances.  Loss 1e-5 relative.  Adam's first moment (0.1 x the clipped
gradient after one step) 1e-4 relative with atol MU_ATOL (the captioner)
or ENC_MU_ATOL (the encoder); params, as in tests/test_torch_train.py, to
0.02 lr where the first moment is solid (above 50 x its atol) and
everywhere to 2 lr a step; batch-norm running statistics 1e-4 relative,
atol 1e-4 of the leaf's largest value (measured 5.1e-6); frozen encoder
leaves bit-unchanged.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.train import step as tstep
from icek_tpu.train import step as jstep
from test_torch_common import entity_rows, jax_params_numpy, resnet_params_numpy, small_cfgs
from test_torch_loop import at, tree_paths

V, E, T, PAD, B = 30, 5, 6, 0, 2
IMG = 64        # layer4 sees 2x2 positions: 8 values a channel for its batch statistics
LR, ENC_LR = 1e-3, 1e-4
MU_ATOL = 2e-6
# the encoder's gradients come back through 100 float32 convolution layers:
# their noise reads up to 3.6e-6 in Adam's first moment (layer2's)
ENC_MU_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    out = []
    for c in small_cfgs(emb_dim=16, num_heads=2, ffn=24, layers=1, type_vocab=20):
        out.append(c.replace(model=dataclasses.replace(c.model, encoded_image_size=2),
                             train=dataclasses.replace(c.train, grad_accum_steps=1)))
    return tuple(out)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, V, (B, T)).astype(np.int32)
    caps[:, 0] = V - 2
    caps[1, 4:] = PAD
    return {"caption_ids": caps, "caption_mask": np.zeros((B, T), np.int32),
            "lengths": np.array([T, 4], np.int32),
            "entity_features": entity_rows(rng, B, E, 20),
            "images": rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)}


def _encoder(seed=0):
    """ResNet-101 params with batch norms that are not the identity, so the
    train-mode statistics and the frozen running ones both bind.  The last
    batch norm of each block scales by 0.1-0.3, as a trained ResNet's small
    residual gains do: at 0.5-1.5 the 101 random layers amplify float32
    rounding until the two packages' train-mode tokens at 32x32 disagree
    completely (and by 5e-4 relative at 64x64)."""
    enc = resnet_params_numpy(16, seed, proj_gain=1e-2)
    rng = np.random.default_rng(seed + 1)

    def bn(path, x):
        key = path[-1]
        if key == "mean" and path[-2] != "proj":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if key == "scale":
            lo, hi = (0.1, 0.3) if path[-2] == "bn3" else (0.5, 1.5)
            return rng.uniform(lo, hi, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(
        lambda p, x: bn([getattr(k, "key", getattr(k, "idx", None)) for k in p], x), enc)


def _adam_mu(state):
    """Adam's first-moment tree inside an optax state."""
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)

    walk(state)
    assert len(found) == 1
    return found[0]


def _close_tree(got_tree, want_tree, want_mu, start_tree, lr, steps, resnet=False,
                mu_atol=MU_ATOL):
    """Port tree (after `steps`) against JAX's; `want_mu` JAX's first moment
    (MaskedNode leaves are frozen ones, skipped)."""
    got_np = bridge.to_numpy(got_tree, resnet=resnet)
    solid_total = 0
    for path, want in tree_paths(jax.tree.map(np.asarray, want_tree)):
        mu = at(want_mu, path)
        if not hasattr(mu, "shape"):
            continue
        mu = np.asarray(mu)
        got = at(got_np, path)
        solid = np.abs(mu) > 50 * mu_atol
        np.testing.assert_allclose(got[solid], want[solid], atol=0.02 * lr, err_msg=str(path))
        assert np.abs(got - want).max() <= 2 * steps * lr * 1.02, path
        assert np.abs(got - at(start_tree, path)).max() > 0, path      # it trained
        solid_total += solid.sum()
    assert solid_total > 100


def _mu_close(tstate, tree, want_mu, resnet=False, atol=MU_ATOL):
    mu, _ = tstate.moments(tree)
    got = bridge.to_numpy(mu, resnet=resnet)
    for path, want in tree_paths(jax.tree.map(lambda x: x, want_mu)):
        if not hasattr(want, "shape"):
            continue
        np.testing.assert_allclose(at(got, path), np.asarray(want), rtol=1e-4,
                                   atol=atol, err_msg=str(path))


def _run(mode, steps=2):
    """Both packages' train steps in `mode` ("frozen", "finetune", "bn");
    returns {"jax": [(params, encoder, mu, enc_mu, loss)], "port": ...} per
    step, plus the initial trees."""
    jc, tc = _cfgs()
    tree, enc = jax_params_numpy(jc.model, V, 0), _encoder()
    batch = _batch()
    jp, je = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, enc)
    jopt = jstep.make_optimizer(LR)
    jstate = jopt.init(jp)
    tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
    te = bridge.from_jax_resnet(enc)
    topt = tstep.make_optimizer(LR)
    tstate = topt.init(tp)
    kw = dict(encode_images=True, bn_train_mode=mode == "bn")
    if mode == "finetune":
        jeopt, teopt = (jstep.make_encoder_optimizer(je, ENC_LR),
                        tstep.make_encoder_optimizer(te, ENC_LR))
        jestate, testate = jeopt.init(je), teopt.init(te)
        jtrain, jeval = jstep.make_train_step(jc, V, PAD, jopt, encoder_optimizer=jeopt, **kw)
        ttrain, teval = tstep.make_train_step(tc, V, PAD, topt, encoder_optimizer=teopt,
                                              device="cpu", **kw)
    else:
        jtrain, jeval = jstep.make_train_step(jc, V, PAD, jopt, **kw)
        ttrain, teval = tstep.make_train_step(tc, V, PAD, topt, device="cpu", **kw)
    gen = torch.Generator().manual_seed(0)
    out = {"jax": [], "port": [], "tree": tree, "enc": enc, "batch": batch,
           "evals": (jeval, teval)}
    for step in range(steps):
        key = jax.random.PRNGKey(step)
        if mode == "finetune":
            jp, jstate, je, jestate, jl, _ = jtrain(jp, jstate, je, jestate, batch, key)
            *_, tl, _ = ttrain(tp, tstate, te, testate, batch, gen)
            emu = _adam_mu(jestate)
        elif mode == "bn":
            jp, jstate, je, jl, _ = jtrain(jp, jstate, je, batch, key)
            *_, tl, _ = ttrain(tp, tstate, te, batch, gen)
            emu = None
        else:
            jp, jstate, jl, _ = jtrain(jp, jstate, je, batch, key)
            _, _, tl, _ = ttrain(tp, tstate, te, batch, gen)
            emu = None
        out["jax"].append((jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, je),
                           jax.tree.map(np.asarray, _adam_mu(jstate)),
                           None if emu is None else jax.tree.map(np.asarray, emu),
                           float(jl)))
        out["port"].append(float(tl))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _mu_close(tstate, tp, _adam_mu(jstate))
        if mode == "finetune":
            _mu_close(testate, te, emu, resnet=True, atol=ENC_MU_ATOL)
    out.update(tp=tp, te=te, jp=jp, je=je)
    return out


@pytest.mark.parametrize("mode", ["frozen", "bn"])
def test_image_step_matches_jax_after_1_and_2_steps(mode):
    r = _run(mode)
    jparams, jenc, jmu, _, _ = r["jax"][-1]
    _close_tree(r["tp"], jparams, jmu, r["tree"], LR, 2)
    got_enc = bridge.to_numpy(r["te"], resnet=True)
    for path, want in tree_paths(jenc):
        got = at(got_enc, path)
        if mode == "bn" and path[-1] in ("mean", "var"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=str(path))
            assert not np.array_equal(got, at(r["enc"], path)), path     # they moved
        else:
            np.testing.assert_array_equal(got, at(r["enc"], path), err_msg=str(path))
    # validation reads the running statistics, as JAX's eval step does
    jeval, teval = r["evals"]
    want, wn = jeval(r["jp"], r["je"], r["batch"])
    got, n = teval(r["tp"], r["te"], r["batch"])
    assert int(n) == int(wn)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_finetune_step_matches_jax_after_1_and_2_steps():
    r = _run("finetune")
    jparams, jenc, jmu, jemu, _ = r["jax"][-1]
    _close_tree(r["tp"], jparams, jmu, r["tree"], LR, 2)
    mask = tstep.encoder_trainable_mask(r["te"])
    got_enc = bridge.to_numpy(r["te"], resnet=True)
    trained = 0
    for path, want in tree_paths(jenc):
        got = at(got_enc, path)
        if at(mask, path):
            trained += 1
            assert not np.array_equal(got, at(r["enc"], path)), path
        else:       # the stem, layer1 and every running statistic never move
            np.testing.assert_array_equal(got, at(r["enc"], path), err_msg=str(path))
            np.testing.assert_array_equal(want, at(r["enc"], path), err_msg=str(path))
    assert trained > 100
    _close_tree(r["te"], jenc, jemu, r["enc"], ENC_LR, 2, resnet=True,
                mu_atol=ENC_MU_ATOL)


def test_encoder_trainable_mask_matches_jax():
    enc = _encoder()
    want = jstep.encoder_trainable_mask(jax.tree.map(jnp.asarray, enc))
    got = tstep.encoder_trainable_mask(bridge.from_jax_resnet(enc))
    wp, gp = dict(tree_paths(want)), dict(tree_paths(got))
    assert wp == gp
    assert any(wp.values()) and not all(wp.values())
    assert not any(v for p, v in gp.items() if p[0] in ("conv1", "bn1", "layer1"))


def test_token_cache_step_equals_the_image_token_step():
    """Batches of row ids into one device tensor of the split's tokens train
    exactly as batches that carry the tokens (dropout on, same generator
    seeds)."""
    _, tc = _cfgs()
    tree = jax_params_numpy(_cfgs()[0].model, V, 3)
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((7, 4, 16)).astype(np.float32)
    base = {k: v for k, v in _batch(5).items() if k != "images"}
    rows = np.array([5, 2], np.int32)
    results = []
    for use_cache in (False, True):
        tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
        opt = tstep.make_optimizer(LR)
        state = opt.init(tp)
        train, _ = tstep.make_train_step(
            tc.replace(model=dataclasses.replace(tc.model, dropout_dec=0.2, dropout_enc=0.2)),
            V, PAD, opt, encode_images=False,
            token_cache=torch.as_tensor(cache) if use_cache else None, device="cpu")
        batch = dict(base, **({"token_rows": rows} if use_cache
                              else {"image_tokens": cache[rows]}))
        gen = torch.Generator().manual_seed(9)
        losses = [float(train(tp, state, None, batch, gen)[2]) for _ in range(2)]
        results.append((losses, bridge.to_numpy(tp)))
    assert results[0][0] == results[1][0]
    for (_, a), (_, b) in zip(tree_paths(results[0][1]), tree_paths(results[1][1])):
        np.testing.assert_array_equal(a, b)


def test_refusals_match_jax():
    jc, tc = _cfgs()
    for step_mod, cfg, kw in ((jstep, jc, {}), (tstep, tc, {"device": "cpu"})):
        opt = step_mod.make_optimizer(LR)
        with pytest.raises(ValueError, match="requires encode_images"):
            step_mod.make_train_step(cfg, V, PAD, opt, encode_images=False,
                                     bn_train_mode=True, **kw)
        accum = cfg.replace(train=dataclasses.replace(cfg.train, grad_accum_steps=2))
        with pytest.raises(ValueError, match="incompatible with bn_train_mode"):
            step_mod.make_train_step(accum, V, PAD, opt, bn_train_mode=True, **kw)
        auto = cfg.replace(train=dataclasses.replace(cfg.train, grad_accum_steps="auto"))
        step_mod.make_train_step(auto, V, PAD, opt, bn_train_mode=True, **kw)
    with pytest.raises(TypeError, match="mesh must be a"):
        tstep.make_train_step(tc, V, PAD, tstep.make_optimizer(LR), encode_images=False,
                              token_cache_mesh=object(), device="cpu")
