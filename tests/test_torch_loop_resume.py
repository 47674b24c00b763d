"""The port's fault tolerance (icek_torch/train/loop.py,
icek_torch/train/checkpoint.py), the counterparts of
tests/test_preempt_resume.py: a run stopped by a real SIGTERM saves a STEP
checkpoint, and resuming from it finishes the epoch bit for bit as the
uninterrupted run does (dropout on: every step's generator is seeded from
(seed, epoch, batch index)); interval STEP checkpoints; the resume ranking
over the port's ``.pt`` files and JAX's ``.msgpack`` files; the loader's
``start_batch``; the device token cache's placement rule.  f32 on the CPU.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch.data import dataset as tds
from icek_torch.train import checkpoint as tckpt
from icek_torch.train import loop as tloop
from test_torch_common import tmp_dir, train_split  # noqa: F401
from test_torch_loop import tree_paths

BASE = "tiny_geo"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Bit-identity on the CPU holds on one thread: with several, torch's CPU
    backward of an indexed embedding (index_put_ with accumulate) sums
    repeated rows in no fixed order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return train_split(tmp_path_factory.mktemp("split"))


def _train(split, ckpt_dir, **kw):
    _, tc, out, wm = split
    return tloop.train(tc, out, len(wm), wm.pad_id, checkpoint_dir=str(ckpt_dir),
                       device="cpu", **kw)


def _bit_equal_checkpoints(a_path, b_path):
    a = torch.load(a_path, weights_only=True)
    b = torch.load(b_path, weights_only=True)
    assert json.loads(a["meta"]) == json.loads(b["meta"])
    assert a["opt"]["step"] == b["opt"]["step"] > 0
    assert a["opt"]["learning_rate"] == b["opt"]["learning_rate"]
    for group in ("params", "encoder_params"):
        la, lb = list(tree_paths(a[group])), list(tree_paths(b[group]))
        assert [p for p, _ in la] == [p for p, _ in lb] and la
        for (path, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), (group, path)
    for key in ("mu", "nu"):
        for (path, x), (_, y) in zip(tree_paths(a["opt"][key]), tree_paths(b["opt"][key])):
            assert torch.equal(x, y), (key, path)


def test_sigterm_preempt_then_resume_bit_exact(split, tmp_dir):
    """Stop a run mid-epoch with a real SIGTERM; resume from the STEP file;
    the completed epoch-0 checkpoint equals the uninterrupted run's."""
    cfg = split[1]
    assert cfg.model.dropout_dec > 0          # the dropout draws must line up too
    _train(split, tmp_dir / "a", max_epochs=1, log=lambda s: None)

    dir_b = tmp_dir / "b"
    fired = []

    def killing_log(msg):
        # print_freq 1: every batch logs; the signal lands after batch 0, so
        # the next step's callback saves step 2
        if "Epoch: [0][0/" in msg and not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    lines = []
    result = _train(split, dir_b, max_epochs=1,
                    log=lambda s: (lines.append(s), killing_log(s)))
    assert result.preempted
    step_file = dir_b / f"checkpoint_STEP_{BASE}.pt"
    assert step_file.exists()
    meta = tckpt.read_meta(str(step_file))
    assert meta["epoch"] == 0 and 0 < meta["step"] < -(-6 // cfg.train.batch_size)
    assert lines[-1] == f"PREEMPTED: saved {step_file} at epoch 0 batch {meta['step']}"
    assert tckpt.latest_checkpoint(str(dir_b), BASE) == str(step_file)

    result2 = _train(split, dir_b, max_epochs=1, resume_from=str(step_file),
                     log=lambda s: None)
    assert not result2.preempted
    assert not step_file.exists()      # the completed epoch removes the STEP file
    _bit_equal_checkpoints(tmp_dir / "a" / f"checkpoint_0_{BASE}.pt",
                           dir_b / f"checkpoint_0_{BASE}.pt")


def test_interval_step_checkpoints(split, tmp_dir, monkeypatch):
    """checkpoint_every_steps writes the rolling STEP file during the epoch
    and removes it once the epoch checkpoint lands; ICEK_METRICS_LOG gets an
    epoch record and ICEK_PROFILE_DIR a Chrome trace of the first epoch."""
    import dataclasses

    metrics, profile = tmp_dir / "m" / "metrics.jsonl", tmp_dir / "profile"
    monkeypatch.setenv("ICEK_METRICS_LOG", str(metrics))
    monkeypatch.setenv("ICEK_PROFILE_DIR", str(profile))

    jc, tc, out, wm = split
    tc = tc.replace(train=dataclasses.replace(tc.train, checkpoint_every_steps=1))
    step_file = tmp_dir / f"checkpoint_STEP_{BASE}.pt"
    seen = []

    def spy_log(msg):
        if step_file.exists():
            seen.append(tckpt.read_meta(str(step_file))["step"])

    tloop.train(tc, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp_dir),
                max_epochs=1, log=spy_log, device="cpu")
    assert seen and seen == sorted(seen) and max(seen) >= 2
    assert not step_file.exists()
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["event"] for r in records] == ["epoch"]
    assert records[0]["epoch"] == 0 and records[0]["lr"] == tc.train.decoder_lr
    assert np.isfinite(records[0]["train_loss"]) and np.isfinite(records[0]["val_loss"])
    assert "traceEvents" in json.loads((profile / "trace.json").read_text())


def test_latest_checkpoint_ranks_step_files_of_both_kinds(tmp_path):
    """Resume order over .pt and JAX .msgpack files alike: epoch-0 file <
    mid-epoch-1 STEP file < epoch-1 file; BEST_ copies never count."""
    from icek_tpu.train import checkpoint as jckpt

    d = str(tmp_path)
    params = {"w": torch.zeros(2)}
    p0 = jckpt.save_checkpoint(d, BASE, 0, 0, 1.0, {"w": np.zeros(2)}, None, is_best=True)
    assert tckpt.latest_checkpoint(d, BASE) == p0
    ps = tckpt.save_checkpoint(d, BASE, 1, 0, 1.0, params, None, step=3)
    assert tckpt.latest_checkpoint(d, BASE) == ps
    p1 = jckpt.save_checkpoint(d, BASE, 1, 0, 0.9, {"w": np.zeros(2)}, None)
    assert tckpt.latest_checkpoint(d, BASE) == p1
    p2 = tckpt.save_checkpoint(d, BASE, 1, 0, 0.8, params, None, step=5, is_best=False)
    assert tckpt.latest_checkpoint(d, BASE) == p1          # (2, 0) > (1, 5)
    p3 = tckpt.save_checkpoint(d, BASE, 2, 0, 0.7, params, None, is_best=True)
    assert tckpt.latest_checkpoint(d, BASE) == p3
    assert os.path.exists(os.path.join(d, "BEST_" + os.path.basename(p3)))
    assert tckpt.latest_checkpoint(str(tmp_path / "absent"), BASE) is None
    assert p2 != p3


@pytest.mark.parametrize("k", [0, 1, 3])
def test_index_loader_start_batch(split, k):
    """The port's epoch batches are JAX's, and start_batch skips a prefix of
    the seeded epoch."""
    from icek_tpu.data import dataset as jds

    out = split[2]
    data = tds.CaptionDataset(out, BASE, "TRAIN")
    full = list(data.epoch_batches(2, shuffle=True, seed=5))
    tail = list(data.epoch_batches(2, shuffle=True, seed=5, start_batch=k))
    want = list(jds.CaptionDataset(out, BASE, "TRAIN").epoch_batches(2, shuffle=True, seed=5))
    assert len(full) == len(want) == 3
    for a, b in zip(full, want):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert len(tail) == max(0, len(full) - k)
    for a, b in zip(full[k:], tail):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_token_rows_replace_the_tokens(split):
    """With use_token_rows a batch carries its row ids (-1 padding rows read
    row 0), as JAX's loader does."""
    from icek_tpu.data import dataset as jds

    out = split[2]
    tdata, jdata = (mod.CaptionDataset(out, BASE, "VAL") for mod in (tds, jds))
    for data in (tdata, jdata):
        data.image_tokens = np.ones((len(data), 16, 20), np.float32)
        data.use_token_rows = True
    idx = np.array([1, 0, -1])
    got, want = tdata.batch(idx), jdata.batch(idx)
    assert got.keys() == want.keys() and "image_tokens" not in got
    np.testing.assert_array_equal(got["token_rows"], want["token_rows"])
    assert got["token_rows"].dtype == np.int32


@pytest.mark.parametrize("n_rows,row_bytes,budget_gb,dp", [
    (1000, 2**20, 4.0, 1),          # fits: replicated
    (1000, 2**20, 0.5, 1),          # does not fit one card, no mesh
    (1000, 2**20, 0.5, 4),          # one data shard's rows fit: sharded
    (1000, 2**20, 0.1, 4),          # not even a shard
    (1000, 2**20, 0.0, 1),          # disabled
    (0, 2**20, 4.0, 1),             # nothing to cache
    (4096, 2**18, 1.0, 1),          # exactly the budget
])
def test_token_cache_placement(n_rows, row_bytes, budget_gb, dp):
    from icek_tpu.train import loop as jloop

    assert tloop.resolve_token_cache_placement(n_rows, row_bytes, budget_gb, dp) == \
        jloop.resolve_token_cache_placement(n_rows, row_bytes, budget_gb, dp)


def test_step_generator_depends_on_seed_epoch_and_batch_only():
    draw = lambda *key: torch.rand(4, generator=tloop.step_generator(*key))  # noqa: E731
    assert torch.equal(draw(0, 1, 2), draw(0, 1, 2))
    assert not torch.equal(draw(0, 1, 2), draw(0, 1, 3))
    assert not torch.equal(draw(0, 1, 2), draw(0, 2, 2))
    assert not torch.equal(draw(0, 1, 2), draw(1, 1, 2))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_cpu_run_computes_in_float32_whatever_the_config_says(split, tmp_dir, monkeypatch,
                                                               name):
    """cfg.train.compute_dtype picks the dtype on the card; the CPU runs the
    plain versions in float32 for either name."""
    _, tc, out, wm = split
    seen = {}

    def capture(*args, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(tloop.step_lib, "make_train_step", capture)
    cfg = tc.replace(train=dataclasses.replace(tc.train, compute_dtype=name))
    with pytest.raises(_Stop):
        tloop.train(cfg, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp_dir),
                    device="cpu")
    assert seen["compute_dtype"] == torch.float32


def test_train_refuses_an_unknown_compute_dtype(split, tmp_dir):
    _, tc, out, wm = split
    cfg = tc.replace(train=dataclasses.replace(tc.train, compute_dtype="float16"))
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        tloop.train(cfg, out, len(wm), wm.pad_id, checkpoint_dir=str(tmp_dir),
                    device="cpu")
