"""The port's (data, model) mesh (icek_torch/parallel/mesh.py) and the train
step under it, on gloo worlds of CPU processes, against the JAX package:
the sharding rule leaf for leaf, the sharded step against JAX's
single-device step and JAX's (2, 2) mesh step, the row-sharded token cache
against a host gather, and the loaders' per-process slices.

Sizes are those of tests/test_parallel.py::_setup (k_georic at d=16, V=64,
8 predicates, batch 8): all four model-sharded tables split at a model axis
of 2.  Tolerances are tests/test_torch_train.py's: loss 1e-5 relative,
Adam's first moment atol 1e-6 and second moment atol 1e-8, params atol
0.02 x lr where the first step's clipped gradient exceeds 1e-6, and
elsewhere Adam's bound of steps x lr (plus 2%) from the initial value
(there the gradient is rounding noise and Adam steps it to +-lr).  The
row-sharded gather is held bit for bit.

The steps that run the encoder (bn_train_mode's statistics over the
global batch, fine-tuning's encoder gradients) on a (2, 1) world are held
to the port's single-device step at tests/test_torch_train_options.py's
sizes and tolerances: loss 1e-5 relative; Adam's first moment 1e-4
relative with atol MU_ATOL (the captioner) or ENC_MU_ATOL (the encoder);
params 0.02 lr where that moment is solid (above 50 x its atol) and 2 lr
a step everywhere; batch-norm running statistics 1e-4 relative, atol 1e-4
of the leaf's largest value; frozen leaves bit-unchanged.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.parallel import mesh as tmesh
from icek_torch.train import step as tstep
from icek_tpu.parallel import mesh as jmesh
from icek_tpu.train import step as jstep
from test_torch_common import jax_params_numpy, port_config
from test_torch_loop import at, tree_paths
from test_torch_mesh_common import run_world

V, PAD, LR, STEPS = 64, 0, 1e-3, 2


def _setup(dropout=0.0):
    """(JAX cfg, port cfg, numpy params, batch): test_parallel.py's setup."""
    import test_parallel

    jc, _, params, batch = test_parallel._setup(V=V)
    jc = jc.replace(model=dataclasses.replace(
        jc.model, dropout_dec=dropout, dropout_enc=dropout, dropout_pos=dropout),
        train=dataclasses.replace(jc.train, grad_accum_steps=1))
    return jc, port_config(jc), jax.tree.map(np.asarray, params), batch


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _jax_steps(jc, tree, batch, mesh_shape=None):
    """[(loss, count, params, mu, nu)] after each of STEPS JAX steps, on one
    device or on a JAX mesh of `mesh_shape`."""
    opt = jstep.make_optimizer(LR)
    train, _ = jstep.make_train_step(jc, V, PAD, opt, encode_images=False)
    params = jax.tree.map(jnp.asarray, tree)
    if mesh_shape is not None:
        m = jmesh.make_mesh(*mesh_shape, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
        params = jmesh.shard_params(params, m)
        batch = jmesh.shard_batch(batch, m)
    state = opt.init(params)
    out = []
    for s in range(STEPS):
        params, state, loss, count = train(params, state, None, batch,
                                           jax.random.PRNGKey(s + 1))
        mu, nu = _moments(state)
        out.append((float(loss), int(count), _leaves(params), _leaves(mu), _leaves(nu)))
    return out


def _moments(opt_state):
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
    return found[0]


def _held(got, want, init, what):
    """One world's steps held to JAX's (see the module docstring)."""
    solid = [np.abs(10.0 * m) > 1e-6 for m in want[0][3]]
    for step, (g, w) in enumerate(zip(got, want), start=1):
        assert g["count"] == w[1], what
        np.testing.assert_allclose(g["loss"], w[0], rtol=1e-5, err_msg=what)
        for a, b in zip(_leaves(g["mu"]), w[3]):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=what)
        for a, b in zip(_leaves(g["nu"]), w[4]):
            np.testing.assert_allclose(a, b, atol=1e-8, err_msg=what)
        for a, b, p0, m in zip(_leaves(g["params"]), w[2], init, solid):
            np.testing.assert_allclose(a[m], b[m], atol=0.02 * LR, err_msg=what)
            assert np.abs(a - p0).max() <= step * LR * 1.02, what


class _Shape:
    """A stand-in for a DeviceMesh's axis sizes (the spec rule reads no more)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model):
        self.sizes = (data, model)

    def size(self, dim):
        return self.sizes[dim]


def _paths(tree, path=()):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)) and not (tree == () or isinstance(tree[0], (str, type(None)))):
        return {p: v for i, x in enumerate(tree) for p, v in _paths(x, path + (i,)).items()}
    return {path: tree}


@pytest.mark.parametrize("vocab", [64, 63])
def test_param_specs_equal_jax(vocab):
    """The port's rule leaf for leaf against JAX's PartitionSpecs on a
    (4, 2) mesh of the 8 virtual devices: a vocabulary that divides by the
    model axis, and one that falls back to replication; the predicate
    tables (8 rows) split either way."""
    import test_parallel

    _, tc, _, _ = _setup()
    _, _, jparams, _ = test_parallel._setup(V=vocab)
    tparams = bridge.from_jax_params(jax.tree.map(np.asarray, jparams), tc.model, vocab)
    jspecs = jmesh.param_specs(jparams, jmesh.make_mesh(4, 2))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): tuple(spec)
            for path, spec in flat}
    got = _paths(tmesh.param_specs(bridge.to_numpy(tparams), _Shape(4, 2)))
    assert got == want
    split = vocab % 2 == 0
    assert got[("word_embedding",)] == (("model", None) if split else ())
    assert got[("fc_vocab", "w")] == ((None, "model") if split else ())
    assert got[("predicate_embedding",)] == ("model", None)


@pytest.fixture(scope="module")
def setup():
    return _setup()


@pytest.fixture(scope="module")
def jax_single(setup):
    jc, _, tree, batch = setup
    return _jax_steps(jc, tree, batch)


GATHER = dict(n=11, width=6, rows=5, seed=3)
DROPOUT = 0.3


IMAGE_MODES = ("bn", "finetune")


@pytest.fixture(scope="module")
def image_setup():
    """(port cfg, numpy params, encoder tree, batch) of
    tests/test_torch_train_options.py: a small geo model over ResNet-101 at
    64x64 images, batch 2."""
    import test_torch_train_options as opts

    jc, tc = opts._cfgs()
    return tc, jax_params_numpy(jc.model, opts.V, 0), opts._encoder(), opts._batch()


@pytest.fixture(scope="module")
def world2(setup, image_setup, tmp_path_factory):
    """One world of 2: steps on (2, 1) and (1, 2) at dropout 0 and at
    DROPOUT, the step with an indivisible microbatch, and the (2, 1) steps
    that run the encoder in each of IMAGE_MODES."""
    import test_torch_train_options as opts

    _, tc, tree, batch = setup
    _, dtc, _, _ = _setup(DROPOUT)
    itc, itree, enc, ibatch = image_setup
    shapes = ((2, 1), (1, 2))
    return run_world(2, "jobs", ([
        ("steps_on_meshes", (shapes, tc, V, PAD, tree, batch, STEPS, LR)),
        ("steps_on_meshes", (shapes, dtc, V, PAD, tree, batch, STEPS, LR)),
        ("indivisible_microbatch", (tc, V, PAD, batch, 3)),
    ] + [("image_steps", ((2, 1), itc, opts.V, opts.PAD, itree, enc, ibatch, STEPS, LR,
                          opts.ENC_LR, mode)) for mode in IMAGE_MODES],),
        tmp_path_factory.mktemp("world2"))


@pytest.fixture(scope="module")
def world4(setup, tmp_path_factory):
    """One world of 4 as a (2, 2) mesh: the step, the step reading its
    tokens from a row-sharded cache, and the row-sharded gather."""
    _, tc, tree, batch = setup
    return run_world(4, "jobs", ([
        ("steps_on_meshes", (((2, 2),), tc, V, PAD, tree, batch, STEPS, LR)),
        ("steps_on_meshes", (((2, 2),), tc, V, PAD, tree, batch, STEPS, LR, True)),
        ("row_gather", ((2, 2), GATHER["n"], GATHER["width"], GATHER["rows"],
                        GATHER["seed"])),
    ],), tmp_path_factory.mktemp("world4"))


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_sharded_step_worlds_of_two_equal_jax(setup, jax_single, world2, shape):
    """Worlds (2, 1) and (1, 2): the sharded step equals JAX's single-device
    step after each of two steps, and every rank gathers the same full
    params."""
    got = [r[0][((2, 1), (1, 2)).index(shape)] for r in world2]
    _held(got[0], jax_single, _leaves(setup[2]), f"mesh {shape}")
    for a, b in zip(_leaves(got[0][-1]["params"]), _leaves(got[1][-1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_sharded_step_world_of_four_equals_jax_and_its_mesh(setup, jax_single, world4):
    """World (2, 2): the sharded step equals JAX's single-device step and
    JAX's own (2, 2) mesh step of the 8 virtual devices."""
    jc, _, tree, batch = setup
    got = world4[0][0][0]
    _held(got, jax_single, _leaves(tree), "mesh (2, 2) vs single device")
    _held(got, _jax_steps(jc, tree, batch, (2, 2)), _leaves(tree), "mesh (2, 2) vs JAX mesh")


def test_step_on_a_row_sharded_cache_equals_the_step_on_tokens(world4):
    """The (2, 2) step with its tokens gathered from a cache row-sharded
    over the data axis equals the step fed the tokens, bit for bit."""
    got, cached = world4[0][0][0], world4[0][1][0]
    for a, b in zip(got, cached):
        assert a["loss"] == b["loss"]
        for x, y in zip(_leaves(a["params"]), _leaves(b["params"])):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_dropout_masks_are_keyed_by_global_row(world2, shape):
    """At dropout 0.3 the (2, 1) and (1, 2) steps equal the port's
    single-device step (JAX's sharded masks equal its single-device ones, so
    the port's do too): each data shard draws its rows of the global mask.
    Same tolerances."""
    _, tc, tree, batch = _setup(dropout=DROPOUT)
    params = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
    opt = tstep.make_optimizer(LR)
    state = opt.init(params)
    train, _ = tstep.make_train_step(tc, V, PAD, opt, encode_images=False, device="cpu")
    gen = torch.Generator().manual_seed(0)
    single = []
    for _ in range(STEPS):
        _, _, loss, count = train(params, state, None, batch, gen)
        mu, nu = state.moments(params)
        single.append((float(loss), int(count), _leaves(bridge.to_numpy(params)),
                       _leaves(bridge.to_numpy(mu)), _leaves(bridge.to_numpy(nu))))
    got = world2[0][1][((2, 1), (1, 2)).index(shape)]
    _held(got, single, _leaves(tree), f"dropout mesh {shape}")
    # and they are not the masks of a step without dropout
    assert abs(got[0]["loss"] - world2[0][0][0][0]["loss"]) > 1e-4


def _tree_close(got, want, mu, start, lr, mu_atol):
    """A numpy tree after STEPS steps against the single device's: 0.02 lr
    where the single device's first moment (`mu`, by path) is solid, 2 lr a
    step everywhere; leaves `mu` lacks (frozen ones) bit-equal."""
    solid_total = 0
    for path, w in tree_paths(want):
        g, m = at(got, path), mu.get(path)
        if m is None:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        solid = np.abs(m) > 50 * mu_atol
        np.testing.assert_allclose(g[solid], w[solid], atol=0.02 * lr, err_msg=str(path))
        assert np.abs(g - w).max() <= 2 * STEPS * lr * 1.02, path
        assert np.abs(g - at(start, path)).max() > 0, path        # it trained
        solid_total += solid.sum()
    assert solid_total > 100


@pytest.mark.parametrize("mode", IMAGE_MODES)
def test_encoder_steps_on_two_data_shards_equal_one_device(image_setup, world2, mode):
    """(2, 1) with the encoder in the step: bn_train_mode normalizes by the
    global batch's statistics (the mean, then the squared deviations from
    it, each all-reduced over the data axis) and moves the running ones as
    one device does; fine-tuning all-reduces the encoder's gradients.  Both
    equal the port's single-device step (tolerances in the module
    docstring)."""
    import test_torch_train_options as opts

    tc, tree, enc, batch = image_setup
    params = bridge.trainable(bridge.from_jax_params(tree, tc.model, opts.V), "cpu")
    encoder = bridge.from_jax_resnet(enc)
    opt = tstep.make_optimizer(LR)
    state = opt.init(params)
    kw = dict(encode_images=True, bn_train_mode=mode == "bn", device="cpu")
    if mode == "finetune":
        encoder = bridge.trainable(encoder, "cpu")
        enc_opt = tstep.make_encoder_optimizer(encoder, opts.ENC_LR)
        enc_state = enc_opt.init(encoder)
        kw["encoder_optimizer"] = enc_opt
    train, _ = tstep.make_train_step(tc, opts.V, opts.PAD, opt, **kw)
    mask = tstep.encoder_trainable_mask(encoder)
    got = world2[0][3 + IMAGE_MODES.index(mode)]
    assert [r[3 + IMAGE_MODES.index(mode)] for r in world2[1:]] == [None]
    gen = torch.Generator().manual_seed(0)
    losses = []
    for step in range(STEPS):
        if mode == "finetune":
            out = train(params, state, encoder, enc_state, batch, gen)
            enc_mu = bridge.to_numpy(enc_state.moments(encoder)[0], resnet=True)
            for path, m in tree_paths(enc_mu):
                # step 2's encoder gradients read captioner params that step 1
                # moved by +-lr where its gradient was rounding noise
                if at(mask, path) and step == 0:
                    np.testing.assert_allclose(
                        at(got["enc_mu"][step], path), m, rtol=1e-4, atol=opts.ENC_MU_ATOL,
                        err_msg=f"step {step + 1} {path}")
        else:
            out = train(params, state, encoder, batch, gen)
        losses.append(float(out[-2]))
        mu = bridge.to_numpy(state.moments(params)[0])
        for path, m in tree_paths(mu):
            np.testing.assert_allclose(at(got["mu"][step], path), m, rtol=1e-4,
                                       atol=opts.MU_ATOL, err_msg=f"step {step + 1} {path}")
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    _tree_close(got["params"], bridge.to_numpy(params), dict(tree_paths(mu)), tree, LR,
                opts.MU_ATOL)
    want_enc = bridge.to_numpy(encoder, resnet=True)
    if mode == "bn":
        for path, w in tree_paths(want_enc):
            g = at(got["enc"], path)
            if path[-1] in ("mean", "var"):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                           err_msg=str(path))
                assert not np.array_equal(g, at(enc, path)), path      # they moved
            else:
                np.testing.assert_array_equal(g, at(enc, path), err_msg=str(path))
        return
    trained = {path: m for path, m in tree_paths(enc_mu) if at(mask, path)}
    _tree_close(got["enc"], want_enc, trained, enc, opts.ENC_LR, opts.ENC_MU_ATOL)


def test_sharded_row_gather_and_shard_rows(world4):
    """Each data shard holds one contiguous block of ceil(n / 2) rows, the
    tail zero-padded; the exchange equals a host gather bit for bit, f32 and
    bf16, on every rank of the (2, 2) world."""
    n, width = GATHER["n"], GATHER["width"]
    source = np.random.default_rng(GATHER["seed"]).standard_normal(
        (n, width)).astype(np.float32)
    R = -(-n // 2)
    for ranked in world4:
        r = ranked[2]
        d = r["data_index"]
        want_block = np.zeros((R, width), np.float32)
        take = source[d * R:(d + 1) * R]
        want_block[:len(take)] = take
        np.testing.assert_array_equal(r["block"], want_block)
        np.testing.assert_array_equal(r["got"], r["want"])
        np.testing.assert_array_equal(
            r["got16"], torch.as_tensor(r["want"]).to(torch.bfloat16).float().numpy())
        assert r["bf16_dtype"] == "torch.bfloat16"


def test_indivisible_microbatch_raises_jax_text(world2):
    """A microbatch whose rows do not divide by the data axis raises JAX's
    error (batch 8 in 3 microbatches of 3 rows over 2 data shards)."""
    want = ("sharded token-cache gather needs the batch (or microbatch) row count 3 "
            "divisible by the data axis (2); pick batch_size / grad_accum_steps "
            "accordingly")
    assert [r[2] for r in world2] == [want, want]


@pytest.mark.parametrize("count", [1, 2, 4])
@pytest.mark.parametrize("loader", ["memory", "streaming"])
def test_loader_slices_equal_jax_and_union_to_the_epoch(loader, count):
    """Each process's index batches equal JAX's with the same process
    arguments, and the slices concatenate back to the one-process stream."""
    from icek_torch.data import dataset as tds, streaming as tstream
    from icek_tpu.data import dataset as jds, streaming as jstream

    classes = {"memory": (tds.CaptionDataset, jds.CaptionDataset),
               "streaming": (tstream.StreamingCaptionDataset,
                             jstream.StreamingCaptionDataset)}[loader]
    port, ref = (_sized(cls, 37) for cls in classes)
    kw = dict(batch_size=8, shuffle=True, seed=5)
    whole = list(port.index_batches(**kw))
    parts = [list(port.index_batches(**kw, process_index=p, process_count=count))
             for p in range(count)]
    for p in range(count):
        want = list(ref.index_batches(**kw, process_index=p, process_count=count))
        assert len(parts[p]) == len(want) == len(whole)
        for a, b in zip(parts[p], want):
            np.testing.assert_array_equal(a, b)
    for j, batch in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([parts[p][j] for p in range(count)]),
                                      batch)


def _sized(cls, n):
    """A loader of `cls` over `n` rows whose index stream needs no files."""
    class Sized(cls):
        def __init__(self):
            pass

        def __len__(self):
            return n

    return Sized()


def global_batch_from_shards(shards):
    """The global batch the per-rank local batches stand for: the test
    counterpart of JAX's ``global_batch_from_shards`` (ranks in data order)."""
    return {k: np.concatenate([np.asarray(s[k]) for s in shards]) for k in shards[0]}


def test_shard_batch_slices_union_to_the_global_batch(setup):
    """shard_batch's per-rank slices, on stand-in meshes of every data
    index, concatenate back to the global batch."""
    _, _, _, batch = setup

    class _Rank(_Shape):
        device_type = "cpu"

        def __init__(self, data, d):
            super().__init__(data, 1)
            self.d = d

        def get_local_rank(self, axis):
            return self.d if axis == "data" else 0

    for S in (1, 2, 4):
        shards = [tmesh.shard_batch(batch, _Rank(S, d)) for d in range(S)]
        assert all(len(s["lengths"]) == 8 // S for s in shards)
        whole = global_batch_from_shards(shards)
        for k, v in batch.items():
            np.testing.assert_array_equal(whole[k], v)


@pytest.mark.parametrize("site", ["dropout", "dropout_add_ln", "hw_dropout", "flash_mha"])
def test_plain_dropout_takes_its_rows_of_the_global_mask(site):
    """On the CPU (the kernels' plain versions) a call on rows b0.. of a
    batch of B under rows=(b0, B), or inside transformer.batch_rows, equals
    those rows of the whole batch's call bit for bit."""
    from icek_torch.kernels import flash_attention as tfa, fused_norm as tfn
    from icek_torch.models import transformer as tfm

    g = torch.Generator().manual_seed(1)
    B, b0, b = 6, 2, 3
    x, h = torch.randn(B, 5, 16, generator=g), torch.randn(B, 5, 16, generator=g)
    q, k, v = (torch.randn(B, 5, 2, 8, generator=g) for _ in range(3))
    scale, bias = torch.ones(16), torch.zeros(16)

    def call(sl, rows):
        if site == "dropout":
            with tfm.batch_rows(*rows) if rows else _nothing():
                return tfm.dropout(x[sl], 0.3, torch.Generator().manual_seed(3), False)
        if site == "dropout_add_ln":
            return tfn.dropout_add_ln(x[sl], h[sl], scale, bias, rate=0.3, seed=3, rows=rows)
        if site == "hw_dropout":
            return tfn.hw_dropout(h[sl], rate=0.3, seed=3, rows=rows)
        return tfa.flash_mha(q[sl], k[sl], v[sl], dropout_rate=0.3, seed=3, rows=rows)

    whole = call(slice(None), None)
    part = call(slice(b0, b0 + b), (b0, B))
    assert torch.equal(part, whole[b0:b0 + b])
    assert not torch.equal(call(slice(b0, b0 + b), None), whole[b0:b0 + b])


def _nothing():
    import contextlib

    return contextlib.nullcontext()

