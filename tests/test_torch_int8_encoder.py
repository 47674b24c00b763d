"""The port's int8 encoder (``icek_torch/models/resnet_int8.py`` and the
plain versions of ``kernels/int8_conv.py``) against
``icek_tpu.models.resnet_int8`` at the shapes of tests/test_resnet_int8.py
(64x64 images, encoded_size 2, emb 24, ResNet-101 at full width).

Held exactly: ``_qconv``'s int32 output at the five site kinds,
``_requant_relu``, the int8 max pool, ``quantize``'s tree (every leaf,
the fingerprint too) and the int8 codes after every site of an encode
(``observe`` / ``calibrate``: test_torch_int8_calibrate.py).  The final
tokens, against JAX's encode run site by site: 1e-5 relative to their
largest magnitude (the float32 pool and projection tail differ in
summation order).  A JAX ``.msgpack`` tree loads and verifies against the
same weights here, and a tree of other weights raises.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.kernels import int8_conv as k8
from icek_torch.models import resnet_int8 as tq
from icek_tpu.models import resnet_int8 as jq
from test_torch_common import (int8_nets, one_torch_thread,  # noqa: F401
                               resnet_params_numpy, tree_leaves_with_paths)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EMB, SIZE, ENC = 24, 64, 2


_leaves = tree_leaves_with_paths


@pytest.fixture(scope="module")
def nets():
    return int8_nets(EMB)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return [rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32),
            (rng.standard_normal((2, SIZE, SIZE, 3)) * 2).astype(np.float32)]


@pytest.fixture(scope="module")
def qtrees(nets, images):
    """(JAX qtree, the port's quantize of the same folded tree and
    observations; ``calibrate`` is held in test_torch_int8_calibrate.py).
    JAX's quantize runs eagerly, as its callers run it: under jit XLA
    rewrites ``a_in * absmax / 127`` and moves ulps."""
    obs = tq.calibrate(nets["tfolded"], [torch.from_numpy(b) for b in images],
                       compute_dtype=torch.float32)
    jobs = jax.tree.map(jnp.asarray, bridge.to_numpy(obs))
    jqt = jq.quantize(nets["jfolded"], jobs, source_params=nets["jraw"])
    tqt = tq.quantize(nets["tfolded"], obs, source_params=nets["traw"])
    return jqt, tqt


# (kernel, input channels, output channels, stride, input side): the five
# site kinds of ResNet-101
SITES = {"stem_7x7_s2": (7, 3, 64, 2, 20), "1x1_s1": (1, 64, 32, 1, 9),
         "down_1x1_s2": (1, 64, 64, 2, 9), "3x3_s1": (3, 64, 64, 1, 7),
         "3x3_s2": (3, 128, 64, 2, 8)}


@pytest.mark.parametrize("kind", sorted(SITES))
def test_qconv_matches_jax_exactly(kind):
    k, cin, cout, stride, side = SITES[kind]
    rng = np.random.default_rng(sorted(SITES).index(kind))
    lo = -127 if kind.startswith("stem") else 0
    x = rng.integers(lo, 128, (2, side, side, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(jq._qconv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tq._qconv(torch.from_numpy(x), torch.from_numpy(w).permute(3, 0, 1, 2), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_requant_relu_and_max_pool_match_jax():
    rng = np.random.default_rng(5)
    inv = np.float32(10.0)
    y = np.concatenate([rng.standard_normal(4000) * 8,
                        np.arange(-20, 140) / 10.0 + 0.05,      # the .5 boundaries
                        [-3.0, 0.0, 12.7, 99.0]]).astype(np.float32)
    np.testing.assert_array_equal(tq._requant_relu(torch.from_numpy(y), inv).numpy(),
                                  np.asarray(jq._requant_relu(jnp.asarray(y), inv)))
    for side in (8, 9):
        q = rng.integers(-128, 128, (2, side, side, 8)).astype(np.int8)
        want = jax.lax.reduce_window(
            jnp.asarray(q), jnp.int8(-128), jax.lax.max, window_dimensions=(1, 3, 3, 1),
            window_strides=(1, 2, 2, 1), padding=[(0, 0), (1, 1), (1, 1), (0, 0)])
        np.testing.assert_array_equal(k8.max_pool(torch.from_numpy(q)).numpy(),
                                      np.asarray(want))


def test_quantize_tree_matches_jax(qtrees):
    jqt, tqt = qtrees
    want = list(_leaves(bridge.from_jax_qtree(jax.tree.map(np.asarray, jqt))))
    got = list(_leaves(tqt))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    # the interchange layout is JAX's, bit for bit
    back = dict(_leaves(bridge.to_jax_qtree(tqt)))
    for path, a in _leaves(jax.tree.map(np.asarray, jqt)):
        np.testing.assert_array_equal(back[path], a, err_msg=str(path))


def _jax_sites():
    site = jax.jit(jq._site_out, static_argnums=2)
    requant = jax.jit(jq._requant_relu)
    return site, requant


def test_encode_codes_match_jax_at_every_site(qtrees, images):
    """Both encodes walked site by site from the same input: every int8
    code equal (0 of them differ), then the tokens of the whole encode.
    The encode's own entries are checked beside them: the stem from the
    float images (``stem_site``) and each block 0's fused conv3 + down
    site (``fused_site``)."""
    jqt, _ = qtrees
    qt = bridge.from_jax_qtree(jax.tree.map(np.asarray, jqt))
    site, requant = _jax_sites()
    img = images[1]
    xj = jnp.clip(jnp.round(jnp.asarray(img) * jqt["inv_img"]), -127, 127).astype(jnp.int8)
    xt = torch.clamp(torch.round(torch.from_numpy(img) * qt["inv_img"]), -127, 127
                     ).to(torch.int8)
    checked, extra = [], []

    def same(name, a, b, into=checked):
        a = np.asarray(a)
        assert int(np.sum(a != b.numpy())) == 0, f"{name}: int8 codes differ"
        into.append(name)

    same("input", xj, xt)
    xj = requant(site(jqt["conv1"], xj, 2), jqt["inv_stem"])
    xt = k8.conv_site(xt, qt["conv1"], 2, inv=qt["inv_stem"])
    same("stem", xj, xt)
    same("stem_site", xj, k8.stem_site(torch.from_numpy(img), qt["conv1"], qt["inv_img"],
                                       qt["inv_stem"]), extra)
    xj = jax.lax.reduce_window(xj, jnp.int8(-128), jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
                               [(0, 0), (1, 1), (1, 1), (0, 0)])
    xt = k8.max_pool(xt)
    same("pool", xj, xt)
    for stage in range(1, 5):
        for b, (qj, qp) in enumerate(zip(jqt[f"layer{stage}"], qt[f"layer{stage}"])):
            s = 2 if (stage > 1 and b == 0) else 1
            oj = requant(site(qj["conv1"], xj, 1), qj["inv_a1"])
            ot = k8.conv_site(xt, qp["conv1"], 1, inv=qp["inv_a1"])
            same(f"layer{stage}.{b}.a1", oj, ot)
            oj = requant(site(qj["conv2"], oj, s), qj["inv_a2"])
            ot = k8.conv_site(ot, qp["conv2"], s, inv=qp["inv_a2"])
            same(f"layer{stage}.{b}.a2", oj, ot)
            yj = site(qj["conv3"], oj, 1)
            if "down_conv" in qj:
                scj = site(qj["down_conv"], xj, s)
                sct = k8.conv_site(xt, qp["down_conv"], s)
                np.testing.assert_array_equal(sct.numpy(), np.asarray(scj))
                xj = requant(yj + scj, qj["inv_out"])
                fused = k8.fused_site(ot, xt, qp["conv3"], qp["down_conv"], s, qp["inv_out"])
                xt = k8.conv_site(ot, qp["conv3"], 1, inv=qp["inv_out"], shortcut=sct)
                same(f"layer{stage}.{b}.fused", xj, fused, extra)
            else:
                xj = requant(yj + xj.astype(jnp.float32) * qj["a_x"], qj["inv_out"])
                xt = k8.conv_site(ot, qp["conv3"], 1, inv=qp["inv_out"], shortcut=xt,
                                  a_x=qp["a_x"])
            same(f"layer{stage}.{b}.out", xj, xt)
    assert len(checked) == 3 + 33 * 3
    assert len(extra) == 1 + 4
    # JAX's encode as its sites run one by one: under one jit of the whole
    # encode XLA:CPU's fused int8 convolutions are not exact integer sums
    # (on these inputs 3803 of the 16384 final codes moved, by up to 6)
    want = np.asarray(jq.resnet_encode_int8(jqt, jnp.asarray(img), ENC, jnp.float32))
    got = tq.resnet_encode_int8(qt, torch.from_numpy(img), ENC, torch.float32).numpy()
    assert got.shape == want.shape == (2, ENC * ENC, EMB)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_jax_msgpack_qtree_loads_and_verifies(nets, qtrees, tmp_path, capsys):
    jqt, tqt = qtrees
    path = str(tmp_path / "enc_int8.msgpack")
    jq.save_qtree(jqt, path)
    loaded = tq.load_qtree(path)
    for (p, a), (_, b) in zip(_leaves(tqt), _leaves(loaded)):
        np.testing.assert_array_equal(b, a, err_msg=str(p))
    # JAX's fingerprint equals the port's for the same raw weights
    tq.verify_qtree(loaded, nets["traw"])
    other = bridge.from_jax_resnet(resnet_params_numpy(EMB, seed=4, proj_gain=1.0))
    with pytest.raises(ValueError, match="DIFFERENT encoder weights"):
        tq.verify_qtree(loaded, other)
    # the port's own file round-trips, and a tree without a fingerprint warns
    own = str(tmp_path / "enc_int8.pt")
    tq.save_qtree(tqt, own)
    for (p, a), (_, b) in zip(_leaves(tqt), _leaves(tq.load_qtree(own))):
        np.testing.assert_array_equal(b, a, err_msg=str(p))
    tq.verify_qtree({k: v for k, v in loaded.items() if k != "_fingerprint"}, other)
    assert "predates fingerprint recording" in capsys.readouterr().err
