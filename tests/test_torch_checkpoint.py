"""The port's checkpoints (icek_torch/train/checkpoint.py), its reader of
flax msgpack (icek_torch/train/msgpack.py) and the optimizer-state bridge
(``bridge.from_jax_opt_leaves``), against icek_tpu and flax on the CPU.
The reader must give exactly what ``flax.serialization.msgpack_restore``
gives; everything else here is bit-exact.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.train import checkpoint as tckpt
from icek_torch.train import msgpack as tmsgpack
from icek_torch.train import step as tstep
from icek_tpu.train import checkpoint as jckpt
from icek_tpu.train import step as jstep
from test_torch_common import (jax_params_numpy, removed_after, resnet_params_numpy,  # noqa: F401
                               small_cfgs, tmp_dir)
from test_torch_loop import at, tree_paths

V = 30


def _same(got, want):
    """`got` (the port's reader) is `want` (flax's): the same containers,
    keys, scalars and array bytes; bfloat16 arrays come back as
    torch.bfloat16 tensors with the same bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == np.shape(want)
        bits = np.asarray(want).view(np.int16)
        assert got.view(torch.int16).numpy().tobytes() == bits.tobytes()
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.shape(got) == np.shape(want) and got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


def _jax_state(steps=1):
    """A small geo model's JAX params, encoder and Adam state after `steps`
    optax updates of a seeded gradient."""
    jc, _ = small_cfgs(emb_dim=8, num_heads=2, ffn=12, layers=1, type_vocab=6)
    tree = jax_params_numpy(jc.model, V, 0)
    params = jax.tree.map(jnp.asarray, tree)
    opt = jstep.make_optimizer(1e-3)
    state = opt.init(params)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
                             params)
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
    return jc, params, state


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    for tmp in removed_after(tmp_path_factory, "jax_ckpt"):
        jc, params, state = _jax_state(2)
        enc = resnet_params_numpy(8, 0)
        path = jckpt.save_checkpoint(str(tmp), "tiny", 0, 1, 2.5, params, state, enc,
                                     is_best=True, extra_meta={"geometry": "8x2"})
        yield jc, path, params, state, enc


def test_reader_equals_msgpack_restore_on_a_jax_checkpoint(jax_checkpoint):
    from flax import serialization

    _, path, *_ = jax_checkpoint
    with open(path, "rb") as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    _same(tmsgpack.restore(blob), want)
    assert want["opt_leaves"][0].shape == () and len(want["encoder_params"]["layer3"]) == 23


def test_reader_on_bf16_scalar_and_plain_leaves():
    from flax import serialization

    tree = {
        "bf16": np.asarray(jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) * 0.37),
        "bf16_0d": jnp.bfloat16(2.5),
        "bf16_scalar": np.asarray(jnp.full((), -1.75, jnp.bfloat16))[()],
        "scalars": [np.float32(1.5), np.int32(-7), np.uint8(200), np.float64(1e300),
                    np.bool_(True)],
        "empty": np.zeros((0, 3), np.float16),
        "ints": np.arange(-3, 3, dtype=np.int64),
        "py": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1, -1, -32, -33,
               -129, -32769, -2**31 - 1, 0.5, 1e-300, True, False, None, "", "é" * 40,
               "x" * 300, b"", b"\x00" * 70000],
        "nested": {"a": {"b": [{"c": np.ones(2, np.float32)}]}, "long": list(range(20))},
        "wide": {str(i): i for i in range(20)},
    }
    blob = serialization.msgpack_serialize(tree)
    _same(tmsgpack.restore(blob), serialization.msgpack_restore(blob))


def test_reader_on_a_chunked_array(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE into chunks; made small here,
    in this process only, so a 10 KB array takes the chunked form."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    tree = {"params": {"big": np.arange(2500, dtype=np.float32).reshape(50, 50),
                       "small": np.ones(3, np.float32)},
            "top": np.arange(700, dtype=np.float64)}
    blob = serialization.msgpack_serialize(tree)
    raw = tmsgpack._Reader(blob, raw=False).value()        # before the unchunking
    assert raw["params"]["big"]["__msgpack_chunked_array__"] is True
    assert len(raw["params"]["big"]["chunks"]) == 10
    got = tmsgpack.restore(blob)
    _same(got, serialization.msgpack_restore(blob))
    np.testing.assert_array_equal(got["params"]["big"], tree["params"]["big"])


@pytest.mark.parametrize("blob", [
    b"\xc7\x01\x05x",                  # ext type 5
    b"\xd4\xff\x00",                   # the timestamp ext (-1)
    b"\x92\x01",                       # truncated array
    b"\x01\x02",                       # trailing bytes
    b"\xc1",                           # the never-used type byte
    b"\x81\x01\x02",                   # an int map key
])
def test_reader_refuses_what_flax_never_writes(blob):
    with pytest.raises(ValueError):
        tmsgpack.restore(blob)


def test_from_jax_opt_leaves_against_optax():
    """optax's (count, lr, Adam count, mu, nu) leaves, before and after
    updates, become the port's {step, learning_rate, mu, nu} by param path."""
    for steps in (0, 1, 3):
        jc, params, state = _jax_state(steps)
        leaves = [np.asarray(x) for x in jax.tree.leaves(state)]
        tree = jax.tree.map(np.asarray, params)
        got = bridge.from_jax_opt_leaves(leaves, tree)
        adam = state.inner_state[1][0]
        assert got["step"] == steps == int(adam.count)
        assert got["learning_rate"] == float(state.hyperparams["learning_rate"])
        for key, want in (("mu", adam.mu), ("nu", adam.nu)):
            for path, w in tree_paths(jax.tree.map(np.asarray, want)):
                g = at(got[key], path)
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="leaves"):
        bridge.from_jax_opt_leaves(leaves[:-1], tree)
    bad = list(leaves)
    bad[3] = np.zeros(np.shape(bad[3])[:-1] + (99,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        bridge.from_jax_opt_leaves(bad, tree)


def test_opt_state_restores_and_steps_as_optax_does():
    """A restored OptState takes its next Adam step as optax takes it from
    the same state (f32; 1e-6 relative on the params)."""
    jc, params, state = _jax_state(2)
    _, tc = small_cfgs(emb_dim=8, num_heads=2, ffn=12, layers=1, type_vocab=6)
    tree = jax.tree.map(np.asarray, params)
    tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
    opt = tstep.make_optimizer(1e-3)
    tstate = opt.init(tp).restore(tp, bridge.from_jax_opt_leaves(
        [np.asarray(x) for x in jax.tree.leaves(state)], tree))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.3, p.dtype), params)
    updates, _ = jstep.make_optimizer(1e-3).update(grads, state, params)
    want = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
    for p in tstep.tree_leaves(tp):
        p.grad = torch.full_like(p, 0.3)
    opt.update(tstate)
    assert tstate.step_count() == 3
    for path, w in tree_paths(want):
        np.testing.assert_allclose(at(tp, path).detach().numpy(), w, rtol=1e-6, atol=1e-7)


def test_pt_round_trip_is_bit_exact(tmp_dir):
    jc, params, state = _jax_state(2)
    _, tc = small_cfgs(emb_dim=8, num_heads=2, ffn=12, layers=1, type_vocab=6)
    tree = jax.tree.map(np.asarray, params)
    tp = bridge.trainable(bridge.from_jax_params(tree, tc.model, V), "cpu")
    te = bridge.from_jax_resnet(resnet_params_numpy(8, 3))
    opt = tstep.make_optimizer(1e-3)
    tstate = opt.init(tp)
    for p in tstep.tree_leaves(tp):
        p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    opt.update(tstate)
    path = tckpt.save_checkpoint(str(tmp_dir), "tiny", 3, 2, 1.25, tp, tstate, te,
                                 extra_meta={"geometry": "8x2"})
    params2, opt2, enc2, meta = tckpt.load_checkpoint(path)
    assert meta == {"epoch": 3, "epochs_since_improvement": 2, "loss": 1.25,
                    "geometry": "8x2"}
    for a, b in ((tp, params2), (te, enc2)):
        la, lb = list(tree_paths(a)), list(tree_paths(b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (pa, x), (_, y) in zip(la, lb):
            assert torch.equal(x.detach(), y), pa
    tp2 = bridge.trainable(params2, "cpu")
    again = tstep.make_optimizer(1e-3).init(tp2).restore(tp2, opt2).export(tp2)
    first = tstate.export(tp)
    assert again["step"] == first["step"] == 1
    assert again["learning_rate"] == first["learning_rate"]
    for key in ("mu", "nu"):
        for (p, x), (_, y) in zip(tree_paths(first[key]), tree_paths(again[key])):
            assert torch.equal(x, y), (key, p)
    # torch.load with weights_only reads it: tensors, dicts, lists and str only
    raw = torch.load(path, weights_only=True)
    assert isinstance(raw["meta"], str) and raw["opt"]["step"] == 1


def test_rotation_names_and_best_copy(tmp_path):
    d = str(tmp_path)
    params = {"w": torch.zeros(2)}
    names = [os.path.basename(tckpt.save_checkpoint(d, "base", e, 0, 1.0, params, None,
                                                    is_best=(e == 1)))
             for e in range(4)]
    assert names == ["checkpoint_0_base.pt", "checkpoint_base.pt",
                     "checkpoint_2_base.pt", "checkpoint_base.pt"]
    step = tckpt.save_checkpoint(d, "base", 4, 0, 1.0, params, None, step=7)
    assert os.path.basename(step) == "checkpoint_STEP_base.pt"
    assert sorted(os.listdir(d)) == sorted(["checkpoint_0_base.pt", "checkpoint_base.pt",
                                            "checkpoint_2_base.pt", "BEST_checkpoint_base.pt",
                                            "checkpoint_STEP_base.pt"])
    # the BEST_ copy is epoch 1's file, the rolling file moved on to epoch 3
    assert tckpt.read_meta(os.path.join(d, "BEST_checkpoint_base.pt"))["epoch"] == 1
    assert tckpt.read_meta(os.path.join(d, "checkpoint_base.pt"))["epoch"] == 3
    assert tckpt.read_meta(step) == {"epoch": 4, "epochs_since_improvement": 0,
                                     "loss": 1.0, "step": 7}


def test_jax_checkpoint_loads_into_the_port_trees(jax_checkpoint):
    jc, path, params, state, enc = jax_checkpoint
    tparams, topt, tenc, meta = tckpt.load_checkpoint(path)
    assert meta == json.loads(json.dumps({"epoch": 0, "epochs_since_improvement": 1,
                                          "loss": 2.5, "geometry": "8x2"}))
    for p, w in tree_paths(jax.tree.map(np.asarray, params)):
        np.testing.assert_array_equal(at(tparams, p).numpy(), w)
    want_enc = bridge.from_jax_resnet(enc)
    for p, w in tree_paths(want_enc):
        assert torch.equal(at(tenc, p), w), p
    assert topt["step"] == 2
    assert tckpt.read_meta(path) == meta
    assert os.path.exists(os.path.join(os.path.dirname(path), "BEST_" + os.path.basename(path)))


def test_encoder_tree_files(tmp_dir, jax_checkpoint):
    """save_encoder_tree / load_encoder_tree round trip bit for bit; a full
    checkpoint of either package gives its encoder; a file without one
    raises."""
    _, jpath, _, _, enc = jax_checkpoint
    te = bridge.from_jax_resnet(enc)
    path = tckpt.save_encoder_tree(str(tmp_dir / "enc.pt"), te, {"emb_dim": 8})
    got, meta = tckpt.load_encoder_tree(path)
    assert meta == {"emb_dim": 8}
    for sources in (got, tckpt.load_encoder_tree(jpath)[0]):
        for p, w in tree_paths(te):
            assert torch.equal(at(sources, p), w), p
    jtree = str(tmp_dir / "enc.msgpack")
    jckpt.save_encoder_tree(jtree, jax.tree.map(jnp.asarray, enc), {"emb_dim": 8})
    got, meta = tckpt.load_encoder_tree(jtree)
    assert meta == {"emb_dim": 8}
    assert torch.equal(got["layer4"][2]["conv3"], te["layer4"][2]["conv3"])
    bare = tckpt.save_checkpoint(str(tmp_dir), "bare", 0, 0, 1.0, {"w": torch.zeros(1)}, None)
    with pytest.raises(ValueError, match="no encoder_params"):
        tckpt.load_encoder_tree(bare)
