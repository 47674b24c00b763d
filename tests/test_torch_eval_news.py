"""The offline eval run of the news preset, and ``decode_batch`` on cached
image tokens: JAX's and the port's Evaluator on the same split and weights,
f32 on the CPU (the geo and knowledge runs: ``test_torch_eval_run.py``).
The news CSV adds the ``generated_mask`` column, and the run logs the
entity and fact counts; both must equal JAX's byte for byte.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import eval_driver as tev
from test_torch_common import (EVAL_BEAM, eval_run, eval_split,  # noqa: F401
                               one_torch_thread, split_datasets)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def news(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("news")
    s = eval_split(tmp, "news")
    return s, eval_run(s, "jax", tmp), eval_run(s, "port", tmp)


def test_news_captions_masks_and_csv_match_jax(news):
    s, want, got = news
    assert got["res"]["captions"] == want["res"]["captions"]
    assert got["res"]["masks"] == want["res"]["masks"]
    kinds = {k for m in got["res"]["masks"] for k in m}
    assert {1, 2} <= kinds
    assert set(got["files"]) == set(want["files"]) == {"generated_captions.csv"}
    body = got["files"]["generated_captions.csv"]
    assert body == want["files"]["generated_captions.csv"]
    assert body.startswith(b"generated_caption,generated_mask\n")
    assert body.count(b"\n") == 6                       # header + 5 rows


def test_news_log_lines_match_jax(news):
    s, want, got = news
    assert got["lines"] == want["lines"]
    assert [ln.split(":")[0] for ln in got["lines"]] == [
        "Captions with entities", "Captions with facts",
        "Number of generated entities (both from E and K) per caption"]


def test_decode_batch_on_image_tokens_matches_jax(tmp_path):
    from icek_tpu import eval_driver as jev

    s = eval_split(tmp_path, "geo")
    jdata, tdata = split_datasets(s)
    idx = np.array([0, 3, 4])
    tokens = np.random.default_rng(4).standard_normal((3, 16, 20)).astype(np.float32)
    jb, tb = jdata.batch(idx, with_images=False), tdata.batch(idx, with_images=False)
    jb["image_tokens"] = tb["image_tokens"] = tokens
    want = jev.Evaluator(s["jc"], s["jwm"], s["jp"], s["jenc"], batch_size=3,
                         beam_size=EVAL_BEAM).decode_batch(jb)
    ev = tev.Evaluator(s["tc"], s["twm"], s["tp"], s["tenc"], batch_size=3,
                       beam_size=EVAL_BEAM, device="cpu")
    got = ev.decode_batch(tb)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got >= len(s["twm"])).any()                 # entity ids among them
    ids = ev.decode_batch_async(tb)
    assert torch.is_tensor(ids) and ids.device.type == "cpu"
    np.testing.assert_array_equal(ids.numpy(), got)
