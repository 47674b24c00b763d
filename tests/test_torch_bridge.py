"""The port's boundaries: the param bridge round trip, the rule that the
port imports nothing of JAX or icek_tpu, and the kernel wrappers' CPU
rule (plain version for CPU tensors, and only for CPU tensors)."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import bridge
from icek_torch.kernels import copy_scores as tcs
from icek_torch.kernels import decoder_step as tds
from icek_torch.kernels import flash_attention as tfa
from icek_torch.kernels import fused_norm as tfn
from test_torch_common import jax_params_numpy, small_cfgs

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "icek_tpu"}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bit_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_captioner_round_trip_bit_equal():
    jc, tc = small_cfgs()
    tree = jax_params_numpy(jc.model, 30)
    port = bridge.from_jax_params(tree, tc.model, 30)
    assert port["decoder"]["layers"][1]["self_attn"]["qkv_w"].shape == (16, 48)
    _bit_equal(bridge.to_numpy(port), tree)
    with pytest.raises(ValueError):
        bridge.from_jax_params(tree, tc.model, 31)


def test_resnet_round_trip_bit_equal():
    from icek_tpu.models import resnet as jres

    tree = jax.tree.map(np.asarray, jres.init_resnet101(jax.random.PRNGKey(0), 24))
    port = bridge.from_jax_resnet(tree)
    # HWIO -> OIHW for every convolution, the projection included
    assert port["conv1"].shape == (64, 3, 7, 7)
    assert port["layer2"][0]["down_conv"].shape == (512, 256, 1, 1)
    assert port["proj"]["w"].shape == (24, 2048, 1, 1)
    assert port["layer1"][0]["bn1"]["var"].shape == (64,)
    _bit_equal(bridge.to_numpy(port, resnet=True), tree)


def _port_sources():
    files = sorted((ROOT / "icek_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax():
    """AST scan of every port module and chip_smoke.py."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert len(names) > 15
    assert {"icek_torch/train/step.py", "icek_torch/train/__init__.py",
            "icek_torch/kernels/fused_norm.py", "icek_torch/serve/engine.py",
            "icek_torch/serve/server.py", "icek_torch/serve/router.py",
            "icek_torch/metrics/js_geo.py", "icek_torch/metrics/fact_accuracy.py",
            "icek_torch/utils/fingerprint.py", "icek_torch/data/dataset.py",
            "icek_torch/train/loop.py", "icek_torch/train/checkpoint.py",
            "icek_torch/train/msgpack.py", "icek_torch/train/port.py",
            "icek_torch/train/embeddings.py", "icek_torch/apps/__init__.py",
            "icek_torch/apps/__main__.py", "icek_torch/utils/profiling.py",
            "icek_torch/models/resnet_int8.py", "icek_torch/kernels/int8_conv.py",
            "icek_torch/data/context.py", "icek_torch/data/input_files.py",
            "icek_torch/data/streaming.py", "icek_torch/data/images.py",
            "icek_torch/native/__init__.py", "icek_torch/metrics/bleu.py",
            "icek_torch/metrics/cider.py", "icek_torch/metrics/meteor.py",
            "icek_torch/metrics/rouge.py", "icek_torch/metrics/scores.py",
            "icek_torch/metrics/ne_pr.py", "icek_torch/apps/validate.py",
            "icek_torch/parallel/mesh.py", "icek_torch/parallel/distributed.py",
            "icek_torch/utils/roofline.py", "icek_torch/tools/profile_train_step.py",
            "icek_torch/tools/profile_eval.py", "icek_torch/tools/_synthetic.py"} <= names


def test_port_import_loads_no_jax_subprocess():
    code = (
        "import sys, icek_torch.eval_driver, icek_torch.bridge, "
        "icek_torch.kernels.decoder_step, icek_torch.kernels.copy_scores, "
        "icek_torch.kernels.flash_attention, icek_torch.kernels.fused_norm, "
        "icek_torch.train.step, icek_torch.serve, icek_torch.serve.server, "
        "icek_torch.serve.router, icek_torch.metrics.js_geo, "
        "icek_torch.metrics.fact_accuracy, icek_torch.utils.fingerprint, "
        "icek_torch.data.dataset, icek_torch.train.loop, icek_torch.train.checkpoint, "
        "icek_torch.train.msgpack, icek_torch.train.port, icek_torch.train.embeddings, "
        "icek_torch.apps, icek_torch.utils.profiling, icek_torch.models.resnet_int8, "
        "icek_torch.kernels.int8_conv, icek_torch.data.context, "
        "icek_torch.data.input_files, icek_torch.data.streaming, icek_torch.native, "
        "icek_torch.metrics.scores, icek_torch.metrics.ne_pr, icek_torch.apps.validate, "
        "icek_torch.parallel.mesh, icek_torch.parallel.distributed, "
        "icek_torch.utils.roofline, icek_torch.tools.profile_train_step, "
        "icek_torch.tools.profile_eval, icek_torch.tools._synthetic; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN | {'msgpack', 'h5py'})!r}]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _counts():
    return (tfa.flash_mha.launches, tcs.fused_score_topk.launches,
            tds.fused_beam_decoder_step.launches, tfa.flash_mha_bwd.launches,
            tfn.dropout_add_ln.launches, tfn.dropout_add_ln_bwd.launches,
            tfn.hw_dropout.launches)


def test_cpu_tensors_take_the_plain_version(rng):
    before = _counts()
    q, k, v = (torch.as_tensor(rng.standard_normal((2, t, 3, 30)).astype(np.float32))
               for t in (5, 7, 7))
    torch.testing.assert_close(tfa.flash_mha(q, k, v, kv_len=6),
                               tfa.reference_mha(q, k, v, kv_len=6), rtol=0, atol=0)
    h = torch.as_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    wv = torch.as_tensor(rng.standard_normal((8, 50)).astype(np.float32))
    bv = torch.zeros(50)
    tail = torch.as_tensor(rng.standard_normal((4, 6)).astype(np.float32))
    for got, want in zip(tcs.fused_score_topk(h, wv, bv, tail, k=3),
                         tcs.reference_score_topk(h, wv, bv, tail, k=3)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    x, hh = (torch.as_tensor(rng.standard_normal((5, 12)).astype(np.float32))
             for _ in range(2))
    scale, bias = torch.ones(12), torch.zeros(12)
    torch.testing.assert_close(
        tfn.dropout_add_ln(x, hh, scale, bias, rate=0.0),
        tfn.reference_dropout_add_ln(x, hh, scale, bias, rate=0.0), rtol=0, atol=0)
    g7 = lambda: torch.Generator().manual_seed(7)
    torch.testing.assert_close(
        tfn.dropout_add_ln(x, hh, scale, bias, rate=0.25, seed=7),
        tfn.reference_dropout_add_ln(x, hh, scale, bias, rate=0.25, gen=g7()),
        rtol=0, atol=0)
    torch.testing.assert_close(tfn.hw_dropout(x, rate=0.25, seed=7),
                               tfn.reference_hw_dropout(x, rate=0.25, gen=g7()),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        tfa.flash_mha(q, k, v, dropout_rate=0.25, seed=7),
        tfa.reference_mha(q, k, v, dropout_rate=0.25, gen=g7()), rtol=0, atol=0)
    assert _counts() == before   # no kernel was launched


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    meta = dict(device="meta")
    q = torch.empty((2, 5, 3, 30), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_mha(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tcs.fused_score_topk(torch.empty((4, 8), **meta), torch.empty((8, 50), **meta),
                             torch.empty((50,), **meta), torch.empty((4, 6), **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_mha(q, q, q, dropout_rate=0.1, seed=3)
    x = torch.empty((6, 8), **meta)
    scale = torch.empty((8,), **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tfn.dropout_add_ln(x, x, scale, scale, rate=0.1, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        tfn.hw_dropout(x, rate=0.1, seed=3)


def test_train_step_imports_without_cuda_nvcc_or_triton():
    """icek_torch.train.step (and the kernel wrappers under it) import in a
    process with no CUDA device, no nvcc on PATH and triton blocked; nothing
    is built and neither triton nor jax gets loaded."""
    code = (
        "import sys, shutil; sys.modules['triton'] = None; "
        "import torch, icek_torch.train.step as st, "
        "icek_torch.kernels._build as b, icek_torch.kernels.fused_norm; "
        "assert not torch.cuda.is_available(); "
        "assert shutil.which('nvcc') is None; "
        "assert not b._libs and not b.ptxas_reports; "
        f"bad = [m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}]; "
        "assert not bad, bad; "
        "assert callable(st.make_train_step) and callable(st.caption_loss)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), PATH="/nonexistent",
               CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_make_train_step_refuses_missing_card_and_unported_options():
    """The missing card raises; a row-sharded token cache needs a mesh (a
    DeviceMesh, and the cache itself); bn_train_mode without encode_images
    is JAX's ValueError.  The options ported since (the ResNet in the step,
    fine-tuning, train-mode batch norm, the device token cache) build."""
    from icek_torch.train import step as tstep

    _, tc = small_cfgs()
    opt = tstep.make_optimizer(1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tstep.make_train_step(tc, 30, 0, opt, encode_images=False)
    with pytest.raises(TypeError, match="token_cache_mesh must be a"):
        tstep.make_train_step(tc, 30, 0, opt, encode_images=False,
                              token_cache_mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="requires encode_images"):
        tstep.make_train_step(tc, 30, 0, opt, encode_images=False, bn_train_mode=True,
                              device="cpu")
    for kw in (dict(), dict(encoder_optimizer=tstep.make_optimizer(1e-4)),
               dict(encode_images=False, token_cache=torch.zeros(3, 4, 16)),
               dict(bn_train_mode=True)):
        train_step, eval_step = tstep.make_train_step(tc, 30, 0, opt, device="cpu", **kw)
        assert callable(train_step) and callable(eval_step)


def test_trainable_marks_leaves_without_copy():
    jc, tc = small_cfgs()
    port = bridge.from_jax_params(jax_params_numpy(jc.model, 30), tc.model, 30)
    w = port["fc_vocab"]["w"]
    out = bridge.trainable(port, "cpu")
    assert out["fc_vocab"]["w"] is w and w.requires_grad and w.is_leaf
    assert all(not g.any() for g in _leaves(bridge.grads_to_numpy(out)))
    with torch.inference_mode():          # the serving path reads them as before
        assert not (w * 2).requires_grad
