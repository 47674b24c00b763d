"""The port's prep (``icek_torch/data/input_files.py``, ``context.py``, the
host half of ``images.py`` and ``native/``) against icek_tpu's: the input
files ``InputFileWriter`` writes from the synthetic raw splits of
tests/test_train_e2e.py (geo and knowledge) are byte-equal (JSON and pickle
files byte for byte, the HDF5 image stores by value and dtype), through
the library and through ``python -m icek_torch.apps prep``; the native
fuzzy matcher and resizer (built by g++ from the port's own copies of the
sources) agree with their Python paths and with icek_tpu's.
"""

import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from icek_torch import apps
from icek_torch.core import config as tconfig
from test_torch_common import port_config
from test_train_e2e import (make_raw_dataset, make_raw_knowledge_dataset, tiny_cfg,
                            tiny_knowledge_cfg)

CASES = {"geo": (tiny_cfg, make_raw_dataset),
         "knowledge": (tiny_knowledge_cfg, make_raw_knowledge_dataset)}


def _write(package, cfg, raw, out, has_facts):
    if package == "jax":
        from icek_tpu.data.input_files import InputFileWriter
    else:
        from icek_torch.data.input_files import InputFileWriter
    kw = {"knowledge_context_path": str(raw / "knowledge_context.pkl")} if has_facts else {}
    return InputFileWriter(cfg, str(raw / "captions_split.json"),
                           str(raw / "entity_context.pkl"), str(raw / "images"), str(out),
                           seed=0, image_workers=1, **kw).run()


def _assert_same_files(want_dir, got_dir):
    want, got = sorted(os.listdir(want_dir)), sorted(os.listdir(got_dir))
    assert got == want and len(want) >= 16
    for name in want:
        a, b = os.path.join(want_dir, name), os.path.join(got_dir, name)
        if name.endswith((".hdf5", ".h5")):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert sorted(fb) == sorted(fa), name
                for key in fa:
                    assert fb[key].dtype == fa[key].dtype, (name, key)
                    np.testing.assert_array_equal(fb[key][()], fa[key][()], err_msg=name)
                assert dict(fb.attrs) == dict(fa.attrs), name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fb.read() == fa.read(), name


@pytest.fixture(scope="module", params=sorted(CASES))
def prepared(request, tmp_path_factory):
    """(variant, raw dir, JAX output dir, JAX config)."""
    make_cfg, make_raw = CASES[request.param]
    tmp = tmp_path_factory.mktemp(f"prep_{request.param}")
    raw = tmp / "raw"
    raw.mkdir()
    make_raw(raw)
    jc = make_cfg()
    _write("jax", jc, raw, tmp / "jax", jc.model.has_facts)
    return request.param, raw, tmp / "jax", jc


def test_input_files_byte_equal_to_jax(prepared, tmp_path):
    variant, raw, jax_out, jc = prepared
    wm = _write("torch", port_config(jc), raw, tmp_path / "torch", jc.model.has_facts)
    assert len(wm) > 4
    _assert_same_files(jax_out, tmp_path / "torch")


def test_prep_verb_writes_the_same_files_and_sidecars(prepared, tmp_path, monkeypatch):
    """``apps prep --streaming`` over the preset patched in: the same input
    files, and the HDF5 sidecar stores of icek_tpu's write_sidecar_store."""
    from icek_tpu.data import streaming as jstreaming

    variant, raw, jax_out, jc = prepared
    preset = "georic" if variant == "geo" else "k_georic"
    pc = port_config(jc)
    monkeypatch.setitem(tconfig.PRESETS, preset, lambda: pc)
    out = tmp_path / "torch"
    apps.run_prep(preset, ["--splits", str(raw / "captions_split.json"),
                           "--entities", str(raw / "entity_context.pkl"),
                           "--knowledge", str(raw / "knowledge_context.pkl"),
                           "--images", str(raw / "images"), "--output", str(out),
                           "--seed", "0", "--image-workers", "1", "--streaming"])
    want = tmp_path / "jax"
    want.mkdir()
    for name in os.listdir(jax_out):
        with open(jax_out / name, "rb") as f, open(want / name, "wb") as g:
            g.write(f.read())
    for split in ("TRAIN", "VAL", "TEST"):
        jstreaming.write_sidecar_store(str(want), jc.data.base_name, split,
                                       jc.model.has_facts)
    _assert_same_files(want, out)


# ---------------------------------------------------------------------------
# the native helpers


def _random_names(rng, n, alphabet="abcdefgh_", hi=20):
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, hi)))
            for _ in range(n)]


def test_fuzzy_lookup_native_python_and_jax_agree(monkeypatch):
    from icek_torch import native
    from icek_torch.data import codec, context
    from icek_tpu.data import context as jcontext

    assert native.available(), "g++ builds icek_torch/native/fuzzy_match.cpp"
    assert native.load()._name.startswith(os.path.join(
        os.path.dirname(os.path.dirname(native.__file__)), "_build"))
    rng = random.Random(0)
    names = _random_names(rng, 60)
    rows = [[i, len(n)] + codec.encode_name(n) for i, n in enumerate(names)]
    index, jindex = context.entity_name_index(rows), jcontext.entity_name_index(rows)
    queries = names + _random_names(rng, 120, hi=25)
    got = [context.fuzzy_lookup_entity(q, index) for q in queries]
    assert got == [jcontext.fuzzy_lookup_entity(q, jindex) for q in queries]
    # the Python path (no library) gives the same rows
    monkeypatch.setattr(native, "available", lambda: False)
    assert [context.fuzzy_lookup_entity(q, index) for q in queries] == got
    assert sum(g is not None for g in got) > 60

    objects = ["1894", "horace_jones", "gothic", "215_m", "brick"]
    frows, feats = [], []
    for i in range(12):
        obj = rng.choice(objects)
        frows.append([i, len(obj)] + codec.encode_name(obj))
        feats.append([i, rng.randint(0, 4), rng.randint(0, 3)])
    findex = context.fact_name_index(frows, feats)
    jfindex = jcontext.fact_name_index(frows, feats)
    for q in objects + ["horace", "unknown_thing", "1894_x"]:
        for seen in ([], [0, 1], [2], [0, 1, 2, 3, 4]):
            monkeypatch.setattr(native, "available", lambda: True)
            fast = context.fuzzy_lookup_fact(q, seen, findex)
            monkeypatch.setattr(native, "available", lambda: False)
            assert context.fuzzy_lookup_fact(q, seen, findex) == fast, (q, seen)
            assert jcontext.fuzzy_lookup_fact(q, seen, jfindex) == fast, (q, seen)


@pytest.mark.parametrize("hw", [(1066, 800), (300, 120), (120, 300), (100, 90),
                                (256, 256), (2000, 37)])
def test_native_resize_matches_scipy_and_jax(hw):
    from icek_torch import native
    from icek_torch.data import images
    from icek_tpu import native as jnative

    assert native.resize_available(), "g++ builds icek_torch/native/resize.cpp"
    img = np.random.default_rng(hw[0]).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    got = native.resize_chw_f16(img, 256, 256)
    assert np.array_equal(got.view(np.uint16), jnative.resize_chw_f16(img, 256, 256)
                          .view(np.uint16))
    # against the scipy path: the C++ source (icek_tpu's, copied) rounds
    # one value of these 196608 one float16 ulp the other way at (120, 300)
    scipy = images.resize_like_reference(img, 256, 256).transpose(2, 0, 1).astype(np.float16)
    ulps = np.abs(got.view(np.uint16).astype(np.int64) - scipy.view(np.uint16))
    assert ulps.max() <= 1 and int((ulps > 0).sum()) <= (1 if hw == (120, 300) else 0)


def test_prepare_array_gray_rgba_and_scipy_route(monkeypatch):
    from icek_torch.data import images
    from icek_tpu.data import images as jimages

    rng = np.random.default_rng(2)
    for shape in ((310, 475), (310, 475, 4), (310, 475, 3)):
        img = rng.integers(0, 256, size=shape, dtype=np.uint8)
        native_out = images.prepare_array(img.copy(), 64)
        monkeypatch.setenv("ICEK_NATIVE_RESIZE", "0")
        scipy_out = images.prepare_array(img.copy(), 64)
        monkeypatch.delenv("ICEK_NATIVE_RESIZE")
        assert native_out.dtype == np.float16 and native_out.shape == (3, 64, 64)
        assert np.array_equal(native_out.view(np.uint16), scipy_out.view(np.uint16))
        assert np.array_equal(native_out.view(np.uint16),
                              jimages.prepare_array(img.copy(), 64).view(np.uint16))
