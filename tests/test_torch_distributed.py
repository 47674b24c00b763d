"""The port's multi-process runtime (icek_torch/parallel/distributed.py),
whole runs over a gloo world of two CPU processes against one process,
and the replicas' cards (fault F3).

Whole runs (the port's counterparts of tests/test_multiprocess_real.py and
tests/test_distributed.py's two-process eval): ``train.loop.train`` over a
(2, 1) mesh of the tiny geo preset (tests/test_train_e2e.py, 6 / 2 / 2 rows,
global batch 2, dropout on) against the one-process run, epoch losses
within 1e-5 relative (the data axis sums the same terms in another order);
only the primary writes the checkpoint and the metric log, in the
one-process format.  ``Evaluator.run`` over the same world writes the
one-process CSV byte for byte.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import torch.distributed as dist

from icek_torch.parallel import distributed as tdist
from icek_tpu.parallel import distributed as jdist
from test_torch_common import EVAL_BATCH, EVAL_BEAM, eval_run, eval_split, train_split
from test_torch_mesh_common import run_world

_TOPOLOGY_VARS = ("ICEK_COORDINATOR", "ICEK_NUM_PROCESSES", "ICEK_PROCESS_ID", "RANK",
                  "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def no_topology(monkeypatch):
    for var in _TOPOLOGY_VARS:
        monkeypatch.delenv(var, raising=False)


def test_single_process_is_a_no_op(no_topology):
    info = tdist.maybe_initialize(device="cpu")
    assert (info.index, info.count, info.is_primary) == (0, 1, True)
    assert not dist.is_initialized()
    assert tdist.process_info() == tdist.ProcessInfo(0, 1)


def test_force_without_topology_raises_jax_text(no_topology):
    """--distributed with nothing to run on fails loudly with JAX's words,
    instead of running N independent unsharded replicas."""
    with pytest.raises(RuntimeError) as exc:
        tdist.maybe_initialize(force=True, device="cpu")
    jax_text = ("--distributed was requested but no multi-process topology "
                "was found: set ICEK_COORDINATOR/ICEK_NUM_PROCESSES/ICEK_PROCESS_ID")
    assert str(exc.value).startswith(jax_text)
    assert not dist.is_initialized()


def test_partial_topology_and_card_requests_raise(no_topology, monkeypatch):
    """An explicit topology needs all three variables; a run that asked for
    the card never falls back to gloo."""
    monkeypatch.setenv("ICEK_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="ICEK_PROCESS_ID"):
        tdist.maybe_initialize(device="cpu")
    assert tdist.backend_for("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.backend_for("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.ensure_initialized("cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("batch,count", [(256, 1), (256, 4), (6, 2), (6, 4), (7, 2)])
def test_local_batch_size_matches_jax(batch, count):
    try:
        want = jdist.local_batch_size(batch, count)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            tdist.local_batch_size(batch, count)
        assert str(exc.value) == str(e)
    else:
        assert tdist.local_batch_size(batch, count) == want
    assert tdist.local_batch_size(8) == 8         # one process


def test_single_rank_mesh(no_topology):
    """--mesh 1,1 without a launcher runs a single-rank group; a mesh larger
    than the world raises."""
    import argparse

    from icek_torch import apps
    from icek_torch.parallel import mesh as tmesh

    args = argparse.Namespace(distributed=False, mesh="1,1", device="cpu")
    try:
        mesh = apps.resolve_parallel(args)
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tmesh.axis_size(mesh, "data") == tmesh.axis_size(mesh, "model") == 1
        assert tmesh.mesh_device(mesh) == torch.device("cpu")
        with pytest.raises(ValueError, match="needs 2 processes"):
            tmesh.make_mesh(2, 1)
    finally:
        tdist.shutdown()
    assert apps.resolve_parallel(argparse.Namespace(distributed=False, mesh=None,
                                                    device="cpu")) is None


# --------------------------------------------------------------------------
# F3: replicas and their cards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device,replica,n,want", [
    ("cuda", "0", 2, "cuda:0"), ("cuda", "1", 2, "cuda:1"), ("cuda", "3", 2, "cuda:1"),
    ("cuda", "2", 1, "cuda:0"), ("cuda:1", "0", 2, "cuda:1"), ("cpu", "1", 2, "cpu"),
    ("cuda", None, 2, "cuda"),
])
def test_serve_device(device, replica, n, want):
    """A bare "cuda" in replica i runs on cuda:{i % cards} (JAX's
    devices[i % n]); an explicit card or the CPU wins."""
    from icek_torch import apps

    assert apps.serve_device(device, replica, n) == want


def test_run_serve_puts_each_replica_on_its_own_card(monkeypatch):
    """Fault F3: with CUDA_VISIBLE_DEVICES=4,5 set by the operator the
    router leaves it alone, both replicas see two cards, and replicas 0 and
    1 must build their engines on cuda:0 and cuda:1 (they both took "cuda",
    card 0, before)."""
    from icek_torch import apps
    from icek_torch.serve import engine as tengine
    from icek_torch.serve import router

    class Built(Exception):
        pass

    seen = []

    def engine(*_a, device, **_k):
        seen.append(device)
        raise Built

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(apps, "load_wordmap", lambda *_a: None)
    monkeypatch.setattr(apps, "_load_model", lambda cfg, _args: (cfg, {}, {}))
    monkeypatch.setattr(tengine, "ServingEngine", engine)
    for i in (0, 1):
        env = router._replica_env(i, {"CUDA_VISIBLE_DEVICES": "4,5"}, None)
        assert env["CUDA_VISIBLE_DEVICES"] == "4,5"
        monkeypatch.setenv("ICEK_SERVE_DEVICE", env["ICEK_SERVE_DEVICE"])
        with pytest.raises(Built):
            apps.run_serve("georic", ["--checkpoint", "absent.pt"])
    assert seen == ["cuda:0", "cuda:1"]


# --------------------------------------------------------------------------
# whole runs on a world of two
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process train and eval runs, and the same runs on a (2, 1)
    gloo world (one spawn for both)."""
    import shutil

    from icek_torch.train import loop as tloop

    tmp = tmp_path_factory.mktemp("runs")
    try:
        (tmp / "train").mkdir()
        _, tc, out, wm = train_split(tmp / "train")
        one = {"lines": []}
        os.environ["ICEK_METRICS_LOG"] = str(tmp / "one.jsonl")
        try:
            one["result"] = tloop.train(tc, out, len(wm), wm.pad_id,
                                        checkpoint_dir=str(tmp / "one"), max_epochs=1,
                                        log=one["lines"].append, device="cpu")
        finally:
            del os.environ["ICEK_METRICS_LOG"]
        (tmp / "eval").mkdir()
        s = eval_split(tmp / "eval", "geo")
        one["csv"] = eval_run(s, "torch", tmp / "eval")["files"]["generated_captions.csv"]
        (tmp / "csv").mkdir()
        ev_args = (s["tc"], dict(s["twm"].word_to_id), s["tp"], s["tenc"], s["out_dir"],
                   s["base"], str(tmp / "csv"))
        ranks = run_world(2, "train_and_eval",
                          (tc, out, len(wm), wm.pad_id, str(tmp / "ckpt"), str(tmp),
                           ev_args), tmp / "world")
        two = dict(ranks=ranks, ckpt=tmp / "ckpt", csv=tmp / "csv",
                   metrics=[tmp / f"metrics{r}.jsonl" for r in (0, 1)],
                   one_metrics=tmp / "one.jsonl", one_ckpt=tmp / "one",
                   base=tc.data.base_name)
        yield one, two
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _epoch_record(path):
    records = [json.loads(line) for line in open(path).read().splitlines()]
    assert [r["event"] for r in records] == ["epoch"]
    return records[0]


def test_two_process_train_equals_one_process(runs):
    one, two = runs
    want = _epoch_record(two["one_metrics"])
    got = _epoch_record(two["metrics"][0])
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    for rank in two["ranks"]:
        np.testing.assert_allclose(rank["best_loss"], one["result"].best_loss, rtol=1e-5)
        assert len(rank["lines"]) == len(one["lines"])
    assert got["steps"] == want["steps"] == 3


def test_only_the_primary_writes_in_the_one_process_format(runs):
    from icek_torch.train import checkpoint as tckpt

    _, two = runs
    name = f"checkpoint_0_{two['base']}.pt"
    assert not os.path.exists(two["metrics"][1])
    assert not (two["ckpt"] / "rank1").exists()
    got = tckpt.load_checkpoint(str(two["ckpt"] / "rank0" / name))
    want = tckpt.load_checkpoint(str(two["one_ckpt"] / name))
    meta = {k: v for k, v in got[3].items() if k != "loss"}
    assert meta == {k: v for k, v in want[3].items() if k != "loss"}
    np.testing.assert_allclose(got[3]["loss"], want[3]["loss"], rtol=1e-5)
    for tree_got, tree_want in ((got[0], want[0]), (got[1]["mu"], want[1]["mu"])):
        flat_got, flat_want = _flat(tree_got), _flat(tree_want)
        assert flat_got.keys() == flat_want.keys()
        for k in flat_want:
            assert flat_got[k].shape == flat_want[k].shape, k
    assert got[1]["step"] == want[1]["step"] == 3


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat(x, path + (i,)).items()}
    return {path: tree}


def test_two_process_eval_writes_the_one_process_csv(runs):
    one, two = runs
    assert (two["csv"] / "rank0.csv").read_bytes() == one["csv"]
    assert not (two["csv"] / "rank1.csv").exists()
    assert two["ranks"][1]["eval"] == {"captions": None, "masks": None, "primary": False}
    assert (EVAL_BATCH, EVAL_BEAM) == (2, 3)      # the worker's batch and beam
