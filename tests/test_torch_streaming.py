"""The port's streaming loader (``icek_torch/data/streaming.py``) against
icek_tpu's and against the port's in-memory loader, on a geo split written
by icek_tpu's InputFileWriter: the sidecar store, ``batch`` (unsorted rows,
duplicates, -1 padding), the shuffled epoch of ``epoch_batches`` (ring
buffers, block reads, the padded last batch, ``start_batch``) and
``block_shuffled_indices`` equal; ``Evaluator.cache_split_tokens`` on a
streaming split writes a disk cache bound by fingerprint whose tokens and
captions equal the in-memory cache's; and the loop trains from the store.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from icek_torch import eval_driver as tev
from icek_torch.data import dataset as tds
from icek_torch.data import streaming as tstream
from icek_tpu.data import streaming as jstream
from test_torch_common import EVAL_BEAM, eval_split, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return eval_split(tmp_path_factory.mktemp("stream"), "geo")


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sidecar_store_and_batches_match_jax_and_in_memory(split):
    s = split
    for sp in ("TRAIN", "TEST"):
        path = tstream.write_sidecar_store(s["out_dir"], s["base"], sp, False)
        with h5py.File(path, "r") as h:
            want = {k: h[k][()] for k in h}
        jpath = jstream.write_sidecar_store(s["out_dir"], s["base"], sp, False)
        with h5py.File(jpath, "r") as h:
            _same(want, {k: h[k][()] for k in h})
    stream = tstream.StreamingCaptionDataset(s["out_dir"], s["base"], "TRAIN")
    jax_stream = jstream.StreamingCaptionDataset(s["out_dir"], s["base"], "TRAIN")
    mem = tds.CaptionDataset(s["out_dir"], s["base"], "TRAIN")
    assert len(stream) == len(mem) == len(jax_stream) == 6
    assert isinstance(stream.arrays.caption_ids, h5py.Dataset)     # never in RAM
    idx = np.array([3, 0, 3, 5, -1, -1])
    for raw in (False, True):
        got = stream.batch(idx, raw_images=raw)
        _same(got, jax_stream.batch(idx, raw_images=raw))
        _same(got, mem.batch(idx, raw_images=raw))
    np.testing.assert_array_equal(stream.arrays.entity_names[2], mem.arrays.entity_names[2])
    for st in (stream, jax_stream):
        st.close()


@pytest.mark.parametrize("start_batch", [0, 1])
def test_epoch_batches_match_jax(split, start_batch):
    s = split
    stream = tstream.StreamingCaptionDataset(s["out_dir"], s["base"], "TRAIN")
    jax_stream = jstream.StreamingCaptionDataset(s["out_dir"], s["base"], "TRAIN")
    kw = dict(shuffle=True, seed=3, raw_images=True, block_rows=2, window_blocks=2,
              ring_depth=3, copy=True, start_batch=start_batch)
    got = list(stream.epoch_batches(4, **kw))
    want = list(jax_stream.epoch_batches(4, **kw))
    assert len(got) == len(want) == 2 - start_batch
    for g, w in zip(got, want):
        _same(g, w)
    assert (got[-1]["lengths"] == 0).sum() == 2      # the padded last batch
    for st in (stream, jax_stream):
        st.close()


@pytest.mark.parametrize("n,batch,block,window,pad", [
    (100, 8, 16, 2, True), (37, 5, 8, 3, False), (6, 4, 512, 4, True)])
def test_block_shuffled_indices_match_jax(n, batch, block, window, pad):
    for shuffle in (True, False):
        got = list(tstream.block_shuffled_indices(n, batch, shuffle, 7, pad, block, window))
        want = list(jstream.block_shuffled_indices(n, batch, shuffle, 7, pad, block, window))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_streaming_dataset_token_cache(split, tmp_path):
    """cache_split_tokens on a streaming split: an HDF5 cache on disk with
    the fingerprint as a root attribute, the same tokens as the in-memory
    .npz cache, loaded by a second call, re-encoded for another encoder;
    captions from it equal the image path's."""
    s = split
    ev = tev.Evaluator(s["tc"], s["twm"], s["tp"], s["tenc"], batch_size=2,
                       beam_size=EVAL_BEAM, device="cpu")
    mem = tds.CaptionDataset(s["out_dir"], s["base"], "TEST")
    assert ev.cache_split_tokens(mem, str(tmp_path / "t.npz"), log=lambda x: None) == "encoded"
    path = str(tmp_path / "TEST_TOKENS.h5")
    stream = tstream.StreamingCaptionDataset(s["out_dir"], s["base"], "TEST")
    lines = []
    assert ev.cache_split_tokens(stream, path, log=lines.append) == "encoded"
    assert isinstance(stream.image_tokens, h5py.Dataset)
    assert stream.token_cache_attrs["fingerprint"] == ev.encoder_fingerprint()
    np.testing.assert_array_equal(stream.image_tokens[()], mem.image_tokens)
    stream.close()          # HDF5 locks a file another handle still reads
    again = tstream.StreamingCaptionDataset(s["out_dir"], s["base"], "TEST")
    assert ev.cache_split_tokens(again, path, log=lines.append) == "loaded"
    image_path = tds.CaptionDataset(s["out_dir"], s["base"], "TEST")
    want = ev.run(image_path, output_csv=str(tmp_path / "a.csv"), log=lambda x: None)
    got = ev.run(again, output_csv=str(tmp_path / "b.csv"), log=lambda x: None)
    assert got["captions"] == want["captions"]
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    other = {**s["tenc"], "proj": {k: v * 2 for k, v in s["tenc"]["proj"].items()}}
    ev2 = tev.Evaluator(s["tc"], s["twm"], s["tp"], other, batch_size=2,
                        beam_size=EVAL_BEAM, device="cpu")
    assert ev2.cache_split_tokens(again, path, log=lines.append) == "encoded"
    assert "stale" in lines[-2]
    again.close()


def test_loop_trains_from_the_store(split, tmp_path):
    from icek_torch.train import loop as tloop

    s = split
    cfg = s["tc"].replace(data=dataclasses.replace(s["tc"].data, streaming=True),
                          train=dataclasses.replace(s["tc"].train, batch_size=4))
    logs = []
    result = tloop.train(cfg, s["out_dir"], len(s["twm"]), s["twm"].pad_id,
                         checkpoint_dir=str(tmp_path), max_epochs=1, log=logs.append,
                         device="cpu")
    assert np.isfinite(result.best_loss) and result.epochs_run == 1
    # the frozen encoder's tokens were cached on disk beside the store
    with h5py.File(tstream.token_cache_path(s["out_dir"], s["base"], "TRAIN"), "r") as h:
        assert h["image_tokens"].shape[0] == 6
