"""The port's command-line entry points (``python -m icek_torch.apps``),
over ``--device cpu`` and the tiny geo preset of tests/test_train_e2e.py
(patched in for "georic"): the counterparts of tests/test_apps_cli.py's
kv-dtype, batch / accumulation and geometry plumbing, a train -> eval
pipeline whose CSV equals the port's ``Evaluator.run`` on the same
checkpoint (and eval of a reference ``.pth.tar``), a serve round trip, the
refusals of the flags that wait for a
later slice, ``--help`` for the three verbs and the argv ``--replicas``
builds.
"""

import csv
import http.client
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch import apps
from icek_torch.core import config as tconfig
from conftest import REPO_ROOT as ROOT_DIR
from test_torch_common import (one_torch_thread, removed_after, tmp_dir,  # noqa: F401
                               train_split)

# one torch thread: the int8 encoder's float64 convolutions took 99 s under
# the suite's six workers with torch's thread pool, 3 s alone
pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = "tiny_geo"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch trained through ``run_train``: (port Config, files dir,
    checkpoint dir)."""
    for tmp in removed_after(tmp_path_factory, "apps"):
        _, tc, out, _ = train_split(tmp)
        mp = pytest.MonkeyPatch()
        mp.setitem(tconfig.PRESETS, "georic", lambda: tc)
        ckpt_dir = tmp / "ckpts"
        apps.run_train("georic", ["--data-dir", out, "--checkpoint-dir", str(ckpt_dir),
                                  "--epochs", "1", "--device", "cpu"])
        mp.undo()
        yield tc, out, ckpt_dir


@pytest.fixture()
def tiny_preset(trained, monkeypatch):
    monkeypatch.setitem(tconfig.PRESETS, "georic", lambda: trained[0])
    return trained


def test_train_eval_pipeline_csv_equals_the_evaluator(tiny_preset, tmp_dir):
    from icek_torch import eval_driver
    from icek_torch.data import dataset as tds
    from icek_torch.data.codec import Wordmap
    from icek_torch.train import checkpoint as tckpt

    tc, out, ckpt_dir = tiny_preset
    best = ckpt_dir / f"BEST_checkpoint_0_{BASE}.pt"
    assert best.exists() and (ckpt_dir / f"checkpoint_0_{BASE}.pt").exists()
    csv_path = tmp_dir / "generated_captions.csv"
    apps.run_eval("georic", ["--data-dir", out, "--checkpoint", str(best),
                             "--batch-size", "2", "--beam", "3", "--output", str(csv_path),
                             "--metric-data", str(tmp_dir / "absent"), "--device", "cpu"])
    params, _, enc, _ = tckpt.load_checkpoint(str(best))
    with open(os.path.join(out, f"WORDMAP_{BASE}.json")) as f:
        wm = Wordmap(json.load(f))
    ev = eval_driver.Evaluator(tc, wm, params, enc, batch_size=2, beam_size=3, device="cpu")
    want_path = tmp_dir / "want.csv"
    ev.run(tds.CaptionDataset(out, BASE, "TEST"), output_csv=str(want_path),
           log=lambda s: None)
    assert csv_path.read_bytes() == want_path.read_bytes()
    with open(csv_path, newline="") as f:
        assert len(list(csv.reader(f))) == 1 + 2          # header + the TEST rows


def test_serve_answers_a_caption_round_trip(tiny_preset, monkeypatch):
    from icek_torch.data import dataset as tds
    from icek_torch.eval_driver import Evaluator
    from icek_torch.serve import server as server_lib
    from icek_torch.train import checkpoint as tckpt
    from icek_torch.data.codec import Wordmap

    tc, out, ckpt_dir = tiny_preset
    best = str(ckpt_dir / f"BEST_checkpoint_0_{BASE}.pt")
    made = []
    make = server_lib.make_server
    monkeypatch.setattr(server_lib, "make_server",
                        lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    thread = threading.Thread(target=apps.run_serve, args=("georic", [
        "--data-dir", out, "--checkpoint", best, "--port", "0", "--beam", "3",
        "--max-batch", "1", "--device", "cpu"]), daemon=True)
    thread.start()
    try:
        for _ in range(600):
            if made or not thread.is_alive():
                break
            thread.join(0.1)
        assert made, "run_serve did not start a server"
        data = tds.CaptionDataset(out, BASE, "TEST")
        row = data.batch(np.array([0]), raw_images=True)
        sample = {"raw_images": row["raw_images"][0],
                  "entity_features": row["entity_features"][0],
                  "entity_names": data.arrays.entity_names[0]}
        conn = http.client.HTTPConnection(*made[0].server_address, timeout=300)
        conn.request("POST", "/caption", body=server_lib.encode_request(sample))
        resp = conn.getresponse()
        assert resp.status == 200
        got = json.loads(resp.read())
        conn.close()
    finally:
        if made:
            made[0].shutdown()
        thread.join(60)
    assert not thread.is_alive()
    params, _, enc, _ = tckpt.load_checkpoint(best)
    with open(os.path.join(out, f"WORDMAP_{BASE}.json")) as f:
        wm = Wordmap(json.load(f))
    res = Evaluator(tc, wm, params, enc, batch_size=1, beam_size=3, device="cpu").run(
        data, output_csv=os.devnull, log=lambda s: None)
    assert got["caption"] == res["captions"][0]


def test_kv_dtype_cli_plumbs_to_evaluator(tiny_preset, monkeypatch, tmp_path):
    from icek_torch import eval_driver

    _, out, ckpt_dir = tiny_preset
    ckpt = str(ckpt_dir / f"checkpoint_0_{BASE}.pt")
    captured = {}

    class SpyEvaluator:
        def __init__(self, spy_cfg, *a, **kw):
            captured["cfg"], captured["device"] = spy_cfg, kw.get("device")

        def run(self, *a, **kw):
            captured["ran"] = True

    monkeypatch.setattr(eval_driver, "Evaluator", SpyEvaluator)
    common = ["--data-dir", out, "--checkpoint", ckpt, "--metric-data",
              str(tmp_path / "absent"), "--device", "cpu"]
    apps.run_eval("georic", common + ["--kv-dtype", "int8"])
    assert captured["ran"] and captured["device"] == "cpu"
    assert captured["cfg"].decode.kv_dtype == "int8"
    apps.run_eval("georic", common)
    assert captured["cfg"].decode.kv_dtype is None
    apps.run_eval("georic", common + ["--kv-dtype", "auto"])
    assert captured["cfg"].decode.kv_dtype == "auto"


def test_train_cli_batch_and_accum_plumb(tiny_preset, monkeypatch):
    from icek_torch.train import loop as tloop

    tc, out, _ = tiny_preset
    captured = {}

    def spy_train(spy_cfg, *a, **kw):
        captured["cfg"], captured["device"] = spy_cfg, kw["device"]

    monkeypatch.setattr(tloop, "train", spy_train)
    apps.run_train("georic", ["--data-dir", out, "--batch-size", "256",
                              "--grad-accum", "auto"])
    assert captured["cfg"].train.batch_size == 256
    assert captured["cfg"].train.grad_accum_steps == "auto"
    assert captured["device"] == "cuda"                    # the default
    apps.run_train("georic", ["--data-dir", out, "--grad-accum", "4"])
    assert captured["cfg"].train.batch_size == tc.train.batch_size
    assert captured["cfg"].train.grad_accum_steps == 4
    apps.run_train("georic", ["--data-dir", out])
    assert captured["cfg"].train.grad_accum_steps == tc.train.grad_accum_steps
    # --grad-accum 1 (falsy) still overrides the "auto" default
    apps.run_train("georic", ["--data-dir", out, "--grad-accum", "1"])
    assert captured["cfg"].train.grad_accum_steps == 1


def test_train_cli_resume_applies_recorded_geometry(tiny_preset, monkeypatch, tmp_dir):
    from icek_torch.train import loop as tloop

    _, out, _ = tiny_preset
    ckpt_dir = tmp_dir / "ckpts"
    apps.run_train("georic", ["--data-dir", out, "--checkpoint-dir", str(ckpt_dir),
                              "--geometry", "16x4", "--epochs", "1", "--device", "cpu"])
    assert tconfig.geometry_of(tconfig.get_config("georic")) == "20x2"
    captured = {}

    def spy_train(spy_cfg, *a, **kw):
        captured["cfg"], captured["resume"] = spy_cfg, kw.get("resume_from")

    monkeypatch.setattr(tloop, "train", spy_train)
    resume = ["--data-dir", out, "--checkpoint-dir", str(ckpt_dir), "--resume", "auto"]
    apps.run_train("georic", resume)
    assert tconfig.geometry_of(captured["cfg"]) == "16x4" and captured["resume"]
    apps.run_train("georic", resume + ["--geometry", "16X4"])     # case is not a conflict
    assert tconfig.geometry_of(captured["cfg"]) == "16x4"
    with pytest.raises(ValueError, match="conflicts"):
        apps.run_train("georic", resume + ["--geometry", "16x2"])


@pytest.mark.parametrize("verb,flag", [
    ("train", ["--streaming"]), ("train", ["--distributed"]), ("train", ["--mesh", "4,1"]),
    ("eval", ["--streaming"]), ("eval", ["--distributed"]), ("eval", ["--mesh", "auto"]),
    ("eval", ["--encoder-int8", "2"]), ("eval", ["--encoder-qtree", "q.pt"]),
    ("serve", ["--encoder-qtree", "q.pt"]),
])
def test_unported_flags_exit_non_zero(verb, flag, capsys):
    """Every flag is ported: each passes the parser and the run fails where
    the arguments are wrong.  --distributed without a topology raises JAX's
    RuntimeError; --mesh 4,1 in a world of one process raises; --mesh auto
    runs a single-rank gloo group, which the run destroys when it fails on
    the absent files, as --streaming, --encoder-int8 and --encoder-qtree do."""
    import torch.distributed as dist

    argv = ["--data-dir", "absent", "--device", "cpu"] + flag
    if verb != "train":
        argv += ["--checkpoint", "absent.pt"]
    if flag == ["--distributed"]:
        with pytest.raises(RuntimeError, match="no multi-process topology"):
            apps.RUNNERS[verb]("georic", argv)
    elif flag == ["--mesh", "4,1"]:
        with pytest.raises(ValueError, match="needs 4 processes"):
            apps.RUNNERS[verb]("georic", argv)
    else:
        with pytest.raises(FileNotFoundError):
            apps.RUNNERS[verb]("georic", argv)
    assert "not ported yet" not in capsys.readouterr().err
    assert not dist.is_initialized()


@pytest.mark.parametrize("verb", apps.VERBS)
def test_help_for_each_verb(verb):
    out = subprocess.run([sys.executable, "-m", "icek_torch.apps", verb, "georic", "--help"],
                         cwd=ROOT_DIR, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT_DIR)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"usage: python -m icek_torch.apps {verb} georic")
    assert "--device" in out.stdout


def test_main_rejects_unknown_verbs_and_presets():
    for argv in (["bogus", "georic"], ["train", "bogus"], []):
        with pytest.raises(SystemExit) as exc:
            apps.main(argv)
        assert exc.value.code == 2


@pytest.mark.parametrize("verb", apps.HOST_VERBS + apps.TOOL_VERBS)
def test_help_for_each_host_verb(verb):
    argv = [verb] + (["georic"] if verb in apps.HOST_VERBS else []) + ["--help"]
    out = subprocess.run([sys.executable, "-m", "icek_torch.apps", *argv],
                         cwd=ROOT_DIR, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT_DIR)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith(f"usage: python -m icek_torch.apps {' '.join(argv[:-1])}")


def test_replicas_launch_this_serve_command(monkeypatch):
    """serve --replicas N launches N ``python -m icek_torch.apps serve``
    processes of the same command, without --replicas / --port / --host
    (the router gives each its own port)."""
    from icek_torch.serve import router as router_lib

    calls = []

    def spy(argv, replicas, base_port, host="127.0.0.1", env_extra=None):
        calls.append((argv, replicas, base_port, host))
        raise RuntimeError("stop")

    monkeypatch.setattr(router_lib, "launch_replicas", spy)
    argv = ["--checkpoint", "c.pt", "--replicas", "2", "--port=9000", "--host",
            "0.0.0.0", "--beam", "3", "--device", "cuda"]
    with pytest.raises(RuntimeError, match="stop"):
        apps.run_serve("georic", argv)
    assert calls == [(["-m", "icek_torch.apps", "serve", "georic", "--checkpoint", "c.pt",
                       "--beam", "3", "--device", "cuda"], 2, 9000, "0.0.0.0")]


def test_eval_takes_a_reference_pth_tar(tiny_preset, tmp_dir):
    """run_eval on a reference-style .pth.tar (whole pickled modules) writes
    the CSV of Evaluator.run over the trees train/port.py imports from it."""
    from icek_torch import eval_driver
    from icek_torch.data import dataset as tds
    from icek_torch.data.codec import Wordmap
    from icek_torch.train import port as tport
    from test_model_parity import TinyEncoder, torch_seed
    from test_torch_common import jax_params_numpy
    from test_torch_port_weights import ReferenceDecoder, _reference_state

    tc, out, _ = tiny_preset
    with open(os.path.join(out, f"WORDMAP_{BASE}.json")) as f:
        wm = Wordmap(json.load(f))
    import dataclasses

    from icek_tpu.core import config as jcfg

    jmodel = jcfg.ModelConfig(**dataclasses.asdict(tc.model))   # the same fields
    tree = jax_params_numpy(jmodel, len(wm), 5)
    torch_seed(9)
    encoder = TinyEncoder(emb_dim=tc.model.emb_dim).eval()
    with torch.no_grad():
        encoder.conv1.weight.mul_(1e-2)
    path = str(tmp_dir / "checkpoint_0_reference.pth.tar")
    torch.save({"epoch": 0, "epochs_since_improvement": 0, "loss": 1.0,
                "encoder": encoder, "decoder": ReferenceDecoder(_reference_state(tree, jmodel)),
                "encoder_optimizer": None, "decoder_optimizer": None}, path)
    csv_path = tmp_dir / "generated_captions.csv"
    apps.run_eval("georic", ["--data-dir", out, "--checkpoint", path, "--batch-size", "2",
                             "--beam", "3", "--output", str(csv_path), "--metric-data",
                             str(tmp_dir / "absent"), "--device", "cpu"])
    params, enc, _ = tport.load_reference_checkpoint(path, tc.model)
    want_path = tmp_dir / "want.csv"
    eval_driver.Evaluator(tc, wm, params, enc, batch_size=2, beam_size=3, device="cpu").run(
        tds.CaptionDataset(out, BASE, "TEST"), output_csv=str(want_path), log=lambda s: None)
    assert csv_path.read_bytes() == want_path.read_bytes()


# ---------------------------------------------------------------------------
# the int8 encoder, the streaming loader and the dataset linter through the CLIs


def test_eval_encoder_int8_calibrates_on_val(tiny_preset, tmp_dir):
    """eval --encoder-int8 1 writes the CSV of an Evaluator whose int8 tree
    was calibrated on one VAL batch; quantize writes that tree, and eval
    --encoder-qtree with it writes the same CSV."""
    from icek_torch import eval_driver
    from icek_torch.data import dataset as tds
    from icek_torch.data.codec import Wordmap
    from icek_torch.models import resnet_int8
    from icek_torch.train import checkpoint as tckpt

    tc, out, ckpt_dir = tiny_preset
    best = str(ckpt_dir / f"BEST_checkpoint_0_{BASE}.pt")
    common = ["--data-dir", out, "--checkpoint", best, "--batch-size", "2", "--beam", "3",
              "--metric-data", str(tmp_dir / "absent"), "--device", "cpu"]
    apps.run_eval("georic", common + ["--encoder-int8", "1", "--output",
                                      str(tmp_dir / "int8.csv")])
    params, _, enc, _ = tckpt.load_checkpoint(best)
    qtree = apps.calibrate_qtree(enc, tds.CaptionDataset(out, BASE, "VAL"), 1, 2, "cpu")
    with open(os.path.join(out, f"WORDMAP_{BASE}.json")) as f:
        wm = Wordmap(json.load(f))
    ev = eval_driver.Evaluator(tc, wm, params, enc, batch_size=2, beam_size=3, device="cpu",
                               encoder_qtree=qtree)
    ev.run(tds.CaptionDataset(out, BASE, "TEST"), output_csv=str(tmp_dir / "want.csv"),
           log=lambda s: None)
    assert (tmp_dir / "int8.csv").read_bytes() == (tmp_dir / "want.csv").read_bytes()
    tree_path = str(tmp_dir / "enc_int8.pt")
    apps.run_quantize("georic", ["--data-dir", out, "--checkpoint", best, "--batches", "1",
                                 "--batch-size", "2", "--output", tree_path,
                                 "--device", "cpu"])
    resnet_int8.verify_qtree(resnet_int8.load_qtree(tree_path), enc)
    apps.run_eval("georic", common + ["--encoder-qtree", tree_path, "--output",
                                      str(tmp_dir / "qtree.csv")])
    assert (tmp_dir / "qtree.csv").read_bytes() == (tmp_dir / "want.csv").read_bytes()


def test_serve_and_train_plumb_the_new_flags(tiny_preset, monkeypatch, tmp_dir):
    from icek_torch.models import resnet_int8
    from icek_torch.serve import engine as engine_lib
    from icek_torch.serve import server as server_lib
    from icek_torch.train import loop as tloop

    _, out, ckpt_dir = tiny_preset
    best = str(ckpt_dir / f"BEST_checkpoint_0_{BASE}.pt")
    tree_path = str(tmp_dir / "enc_int8.pt")
    resnet_int8.save_qtree({"inv_img": torch.tensor(2.0)}, tree_path)
    captured = {}

    class SpyEngine:
        def __init__(self, *a, **kw):
            captured.update(kw)

    monkeypatch.setattr(engine_lib, "ServingEngine", SpyEngine)
    monkeypatch.setattr(server_lib, "make_server",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("stop")))
    with pytest.raises(RuntimeError, match="stop"):
        apps.run_serve("georic", ["--data-dir", out, "--checkpoint", best,
                                  "--encoder-qtree", tree_path, "--device", "cpu"])
    assert float(captured["encoder_qtree"]["inv_img"]) == 2.0
    monkeypatch.setattr(tloop, "train", lambda cfg, *a, **kw: captured.update(cfg=cfg))
    apps.run_train("georic", ["--data-dir", out, "--streaming"])
    assert captured["cfg"].data.streaming
    apps.run_train("georic", ["--data-dir", out])
    assert not captured["cfg"].data.streaming


def test_eval_streaming_writes_the_in_memory_csv(tiny_preset, tmp_dir):
    _, out, ckpt_dir = tiny_preset
    best = str(ckpt_dir / f"BEST_checkpoint_0_{BASE}.pt")
    common = ["--data-dir", out, "--checkpoint", best, "--batch-size", "2", "--beam", "3",
              "--metric-data", str(tmp_dir / "absent"), "--device", "cpu"]
    apps.run_eval("georic", common + ["--output", str(tmp_dir / "mem.csv")])
    apps.run_eval("georic", common + ["--streaming", "--cache-tokens", "--output",
                                      str(tmp_dir / "stream.csv")])
    assert os.path.exists(os.path.join(out, f"TEST_TOKENS_{BASE}.h5"))
    assert (tmp_dir / "stream.csv").read_bytes() == (tmp_dir / "mem.csv").read_bytes()


def test_validate_verb_passes_prepared_files_and_flags_a_broken_one(tiny_preset, tmp_dir,
                                                                     capsys):
    import shutil

    _, out, _ = tiny_preset
    assert apps.main(["validate", out, "--base-name", BASE, "--img-size", "32"]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    broken = tmp_dir / "broken"
    shutil.copytree(out, broken)
    with open(broken / f"TEST_CAPLENS_{BASE}.json", "w") as f:
        json.dump([2], f)                       # one row where the split has two
    assert apps.main(["validate", str(broken), "--base-name", BASE, "--img-size", "32"]) == 1
    assert "TEST: CAPLENS has 1 rows" in capsys.readouterr().out
