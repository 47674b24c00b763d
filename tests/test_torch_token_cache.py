"""The port's token cache (``Evaluator.cache_split_tokens``) and the
encoder fingerprint it is keyed by, on a TEST split written by icek_tpu's
InputFileWriter: the first call encodes, the second loads, another encoder
re-encodes; captions from the cached tokens equal the image path's, in f32
and in bf16 (bf16 tokens round-trip through the f32 cache exactly).
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import bridge
from icek_torch import eval_driver as tev
from icek_torch.data import dataset as tds
from icek_torch.utils.fingerprint import tree_fingerprint
from test_torch_common import (EVAL_BEAM, eval_split, one_torch_thread,  # noqa: F401
                               resnet_params_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return eval_split(tmp_path_factory.mktemp("cache"), "geo")


def _evaluator(s, enc=None, dtype=torch.float32):
    return tev.Evaluator(s["tc"], s["twm"], s["tp"], s["tenc"] if enc is None else enc,
                         batch_size=2, beam_size=EVAL_BEAM, device="cpu",
                         compute_dtype=dtype)


def _data(s):
    return tds.CaptionDataset(s["out_dir"], s["base"], "TEST", s["has_facts"])


def _captions(ev, data, tmp_path, name):
    return ev.run(data, output_csv=str(tmp_path / name), log=lambda line: None)["captions"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_encodes_loads_and_rebinds_to_the_encoder(split, tmp_path, dtype):
    s = split
    ev = _evaluator(s, dtype=dtype)
    oracle = _captions(ev, _data(s), tmp_path, "a.csv")
    cache = str(tmp_path / "TEST_TOKENS_tiny_geo.npz")
    lines = []
    data = _data(s)
    assert ev.cache_split_tokens(data, cache, log=lines.append) == "encoded"
    assert data.image_tokens.shape == (5, 16, 20) and data.image_tokens.dtype == np.float32
    assert "image_tokens" in data.batch(np.array([0, 1]))
    assert _captions(ev, data, tmp_path, "b.csv") == oracle
    data2 = _data(s)
    assert ev.cache_split_tokens(data2, cache, log=lines.append) == "loaded"
    np.testing.assert_array_equal(data2.image_tokens, data.image_tokens)
    assert _captions(ev, data2, tmp_path, "c.csv") == oracle
    # another checkpoint's encoder must not consume the stale cache
    other = _evaluator(s, enc=bridge.from_jax_resnet(resnet_params_numpy(20, 9)), dtype=dtype)
    assert other.encoder_fingerprint() != ev.encoder_fingerprint()
    data3 = _data(s)
    assert other.cache_split_tokens(data3, cache, log=lines.append) == "encoded"
    assert not np.array_equal(data3.image_tokens, data.image_tokens)
    assert [ln.split(":")[1].split()[0] for ln in lines] == ["encoded", "loaded", "stale",
                                                             "encoded"]
    # a split of another length is stale too
    short = _data(s)
    short.arrays.size = 4
    assert other.cache_split_tokens(short, cache, log=lines.append) == "encoded"


def test_cached_tokens_are_the_encoders_output(split, tmp_path):
    """The encoder runs on the run's batch shape only (the last of the 5
    rows padded to a chunk of 2, as run() pads it), and the cache holds
    exactly its bf16 output."""
    s = split
    ev = _evaluator(s, dtype=torch.bfloat16)
    data = _data(s)
    shapes, encode = [], ev._encode_tokens
    ev._encode_tokens = lambda x, mode: (shapes.append(tuple(x.shape)), encode(x, mode))[1]
    ev.cache_split_tokens(data, str(tmp_path / "t.npz"), log=lambda line: None)
    assert shapes == [(2, 3, 32, 32)] * 3
    del ev._encode_tokens
    raw = torch.as_tensor(data.raw_image_batch(np.arange(5)))
    with torch.inference_mode():
        want = ev._encode_tokens(raw, "raw")
    assert want.dtype == torch.bfloat16
    np.testing.assert_array_equal(data.image_tokens, want.float().numpy())


def test_fingerprint_properties(split):
    s = split
    exact = _evaluator(s)
    folded = _evaluator(s, dtype=torch.bfloat16)
    half = _evaluator(s, dtype=torch.float16)
    fps = {exact.encoder_fingerprint(), folded.encoder_fingerprint(),
           half.encoder_fingerprint()}
    assert len(fps) == 3                       # exact / folded, and each dtype
    # stable: the same weights (a deep copy too) hash the same
    assert exact.encoder_fingerprint() == _evaluator(s).encoder_fingerprint()
    assert tree_fingerprint(s["tenc"]) == tree_fingerprint(copy.deepcopy(s["tenc"]))
    # one weight changed -> another hash
    changed = copy.deepcopy(s["tenc"])
    changed["layer3"][4]["conv2"][0, 0, 0, 0] += 1e-3
    assert tree_fingerprint(changed) != tree_fingerprint(s["tenc"])
    # bf16 leaves hash their raw bytes; the structure and context count too
    t = {"w": torch.ones(3, dtype=torch.bfloat16)}
    u = {"w": torch.tensor([1.0, 1.0, 1.0078125], dtype=torch.bfloat16)}
    assert tree_fingerprint(t) != tree_fingerprint(u)
    assert tree_fingerprint(t) != tree_fingerprint({"v": t["w"]})
    assert tree_fingerprint(t) != tree_fingerprint(t, extra=("folded",))
    assert tree_fingerprint([t["w"]]) != tree_fingerprint(t)


def test_streaming_dataset_raises(split, tmp_path):
    """The port's streaming split caches its tokens (this raised before the
    streaming loader was ported): an HDF5 file bound by fingerprint, with
    the in-memory cache's tokens; a second call loads it
    (tests/test_torch_streaming.py holds the rest)."""
    from icek_torch.data import streaming

    s = split
    ev = _evaluator(s)
    stream = streaming.StreamingCaptionDataset(s["out_dir"], s["base"], "TEST")
    path = str(tmp_path / "s.h5")
    assert ev.cache_split_tokens(stream, path, log=lambda line: None) == "encoded"
    assert stream.token_cache_attrs["fingerprint"] == ev.encoder_fingerprint()
    mem = _data(s)
    ev.cache_split_tokens(mem, str(tmp_path / "m.npz"), log=lambda line: None)
    np.testing.assert_array_equal(stream.image_tokens[()], mem.image_tokens)
    stream.close()
    again = streaming.StreamingCaptionDataset(s["out_dir"], s["base"], "TEST")
    assert ev.cache_split_tokens(again, path, log=lambda line: None) == "loaded"
    again.close()


def test_dataset_batches_match_jax(split):
    """The port's CaptionDataset reads the files as icek_tpu's does: every
    array of ``batch`` (host-normalized images, stored f16 rows, padding rows
    -1), and ``batch_indices`` walks the same order."""
    from icek_tpu.data import dataset as jds
    from test_torch_common import split_datasets

    jdata, tdata = split_datasets(split)
    idx = np.array([4, 0, 0, 2, -1])
    for raw in (False, True):
        want, got = jdata.batch(idx, raw_images=raw), tdata.batch(idx, raw_images=raw)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for args in ((5, 2, False), (5, 2, True, 3), (5, 2, False, 0, False), (4, 4, True)):
        for a, b in zip(tds.batch_indices(*args), jds.batch_indices(*args), strict=True):
            np.testing.assert_array_equal(a, b)


def test_prefetch_raises_the_producers_error():
    def items():
        yield 1
        raise OSError("read failed")

    got = []
    with pytest.raises(OSError, match="read failed"):
        for item in tds.prefetch(items(), lambda x: x * 10):
            got.append(item)
    assert got == [10]
    assert list(tds.prefetch(iter(range(5)), lambda x: -x, depth=1)) == [0, -1, -2, -3, -4]
