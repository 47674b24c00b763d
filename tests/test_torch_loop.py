"""The handover from the JAX package to the port: icek_tpu trains epoch 0 of
the tiny geo preset (tests/test_train_e2e.py, dropout 0) and writes its
``.msgpack`` checkpoint; then icek_tpu and the port's
``icek_torch.train.loop.train`` each resume from that file and train
epoch 1, f32 on the CPU.  The port must continue where JAX does: the same
log lines (timing fields stripped), validation loss, meta, Adam step count
and learning rate, moments and params.

Tolerances.  Validation loss 1e-5 relative (measured 1.6e-7).  Adam's
second moment atol 1e-8 (measured 6.4e-10), first moment atol MU_ATOL =
2e-5 (measured 8.4e-6).  Adam steps lr * m / (sqrt(v) + eps), so where m is
numerical noise the packages may step up to 2 lr apart each step (the key
biases' true gradient is 0; a word embedding element read 2.05 lr apart).
Params are therefore held to 0.02 lr where JAX's first moment exceeds
50 x MU_ATOL (measured 5.7e-7 = 0.0014 lr), and everywhere to 2 lr per step
of the epoch.  The decay and early-stop path is in
tests/test_torch_loop_decay.py, the port's own resume in
tests/test_torch_loop_resume.py.
"""

import json
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import bridge
from icek_torch.train import loop as tloop
from icek_tpu.train import loop as jloop
import shutil

from test_torch_common import train_split

MU_ATOL, NU_ATOL = 2e-5, 1e-8
STEPS = 3                       # 6 TRAIN rows in batches of 2


def strip_timing(lines):
    """Log lines without the wall-clock fields of the epoch lines."""
    return [re.sub(r"\tBatch Time [^\t]*\tData Load Time [^\t]*", "", s) for s in lines]


def tree_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (i,))
    else:
        yield path, tree


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def read_jax(path):
    from flax import serialization

    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def numpy_of(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def resume_both(tmp, jc, tc, out, wm, ckpt, max_epochs):
    """JAX and the port resume from `ckpt`; returns their log lines and
    final-epoch checkpoints (JAX's restored by flax, the port's by
    torch.load)."""
    jlines, tlines = [], []
    jloop.train(jc, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp / "jax1"),
                max_epochs=max_epochs, resume_from=ckpt, log=jlines.append)
    tloop.train(tc, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp / "port1"),
                max_epochs=max_epochs, resume_from=ckpt, log=tlines.append, device="cpu")
    j = read_jax(tmp / "jax1" / "checkpoint_tiny_geo.msgpack")
    t = torch.load(tmp / "port1" / "checkpoint_tiny_geo.pt", weights_only=True)
    return jlines, tlines, j, t


def assert_same_state(j, t, start_params, lr):
    """The port's epoch checkpoint `t` against JAX's `j` (see the module
    doc for the tolerances); `start_params` is the resumed checkpoint's
    params tree."""
    jmeta, tmeta = json.loads(j["meta"]), json.loads(t["meta"])
    np.testing.assert_allclose(tmeta.pop("loss"), jmeta.pop("loss"), rtol=1e-5)
    assert tmeta == jmeta
    jo = bridge.from_jax_opt_leaves(j["opt_leaves"], j["params"])
    assert t["opt"]["step"] == jo["step"]
    np.testing.assert_allclose(t["opt"]["learning_rate"], jo["learning_rate"], rtol=1e-6)
    n = moved = 0
    for path, want in tree_paths(j["params"]):
        mu, nu = numpy_of(at(t["opt"]["mu"], path)), numpy_of(at(t["opt"]["nu"], path))
        np.testing.assert_allclose(mu, at(jo["mu"], path).numpy(), atol=MU_ATOL,
                                   err_msg=str(path))
        np.testing.assert_allclose(nu, at(jo["nu"], path).numpy(), atol=NU_ATOL,
                                   err_msg=str(path))
        got = numpy_of(at(t["params"], path))
        solid = np.abs(at(jo["mu"], path).numpy()) > 50 * MU_ATOL
        np.testing.assert_allclose(got[solid], np.asarray(want)[solid], atol=0.02 * lr,
                                   err_msg=str(path))
        assert np.abs(got - np.asarray(want)).max() <= 2 * STEPS * lr * 1.02, path
        n += solid.sum()
        moved += np.abs(got - np.asarray(at(start_params, path))).sum()
    assert n > 1000 and moved > 0
    # the frozen encoder goes through unchanged, bit for bit
    for path, want in tree_paths(j["encoder_params"]):
        np.testing.assert_array_equal(numpy_of(at(t["encoder_params"], path)), want)


@pytest.fixture(scope="module")
def handover(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("handover")
    jc, tc, out, wm = train_split(tmp, dropout=False)
    jloop.train(jc, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp / "jax"),
                max_epochs=1, log=lambda s: None)
    ckpt = str(tmp / "jax" / "checkpoint_0_tiny_geo.msgpack")
    jlines, tlines, j, t = resume_both(tmp, jc, tc, out, wm, ckpt, max_epochs=2)
    start = read_jax(ckpt)["params"]
    shutil.rmtree(tmp, ignore_errors=True)      # the checkpoints carry a ResNet-101
    return dict(jc=jc, ckpt=ckpt, jlines=jlines, tlines=tlines, j=j, t=t, start=start)


def test_jax_checkpoint_resumed_in_the_port_continues_where_jax_does(handover):
    h = handover
    assert strip_timing(h["tlines"]) == strip_timing(h["jlines"])
    assert h["tlines"][0].startswith(f"Resumed from {h['ckpt']} at epoch 1")
    assert sum(s.startswith("Epoch: [1]") for s in h["tlines"]) == STEPS
    assert_same_state(h["j"], h["t"], h["start"], h["jc"].train.decoder_lr)


def test_the_port_checkpoint_carries_the_interchange_layout(handover):
    """The port's file holds the params in bridge.py's interchange layout
    (the JAX tree's keys and shapes, HWIO convolutions) as CPU tensors, its
    Adam state keyed by param path."""
    j, t = handover["j"], handover["t"]
    for group in ("params", "encoder_params"):
        jp = dict(tree_paths(j[group]))
        tp = dict(tree_paths(t[group]))
        assert jp.keys() == tp.keys()
        for path, want in jp.items():
            assert tuple(tp[path].shape) == np.shape(want), path
            assert tp[path].device.type == "cpu"
    assert t["encoder_params"]["conv1"].shape == (7, 7, 3, 64)     # HWIO
    assert {k for k in t["opt"]} == {"step", "learning_rate", "mu", "nu"}
    assert dict(tree_paths(t["opt"]["mu"])).keys() == dict(tree_paths(j["params"])).keys()
