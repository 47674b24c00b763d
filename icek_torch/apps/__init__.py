"""Command-line entry points of the port (copies of ``apps/common.py``'s
``run_train``, ``run_eval`` and ``run_serve`` over ``icek_torch``):

    python -m icek_torch.apps train|eval|serve \\
        georic|k_georic|nytimes800k|georic_fast [flags]

Every flag of the JAX CLIs is accepted.  ``--device`` (default ``cuda``)
is the one flag they lack: it is how a caller asks for the CPU.  Flags
whose path is not ported yet exit non-zero through ``parser.error`` and
name the slice they wait for: ``--streaming`` (the HDF5 sidecar, with
prep), ``--distributed`` and ``--mesh`` (the mesh), ``--encoder-int8`` and
``--encoder-qtree`` (the int8 encoder).  Checkpoints: the port's ``.pt``,
JAX's ``.msgpack`` and the reference's ``.pth.tar``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from icek_torch.core import config as config_lib
from icek_torch.data.codec import Wordmap

VERBS = ("train", "eval", "serve")
# flag -> the slice its path waits for
UNPORTED = {
    "streaming": "the streaming loader (HDF5 sidecar), with prep",
    "distributed": "the mesh slice",
    "mesh": "the mesh slice",
    "encoder_int8": "the int8 encoder",
    "encoder_qtree": "the int8 encoder",
}


def load_wordmap(data_dir: str, base_name: str) -> Wordmap:
    with open(os.path.join(data_dir, f"WORDMAP_{base_name}.json")) as f:
        return Wordmap(json.load(f))


def base_parser(verb: str, preset: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m icek_torch.apps {verb} {preset}",
                                description=description)
    p.add_argument("--data-dir", default="img_caption_data/input_dataset_files/",
                   help="directory with the packed input files")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' to run there)")
    return p


def add_parallel_args(p: argparse.ArgumentParser, verb: str):
    p.add_argument("--distributed", action="store_true",
                   help="multi-process runtime (not ported yet: the mesh slice)")
    p.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                   help=f"{verb} over a (data, model) device mesh (not ported yet: "
                        "the mesh slice)")


def _refuse_unported(p: argparse.ArgumentParser, args) -> None:
    for name, slice_ in UNPORTED.items():
        if getattr(args, name, None):
            p.error(f"--{name.replace('_', '-')} is not ported yet (waits for {slice_})")


def _load_model(cfg, args):
    """(cfg, params, encoder_params) of ``--checkpoint``: a reference
    ``.pth.tar`` or a ``.pt`` / ``.msgpack`` checkpoint, whose recorded
    geometry ``--geometry`` must agree with."""
    from icek_torch.train import checkpoint as ckpt_lib
    from icek_torch.train import port

    if args.checkpoint.endswith(".pth.tar"):
        params, encoder_params, _ = port.load_reference_checkpoint(args.checkpoint,
                                                                   cfg.model)
        return cfg, params, encoder_params
    params, _, encoder_params, meta = ckpt_lib.load_checkpoint(args.checkpoint)
    return config_lib.resolve_geometry(cfg, meta, flag=args.geometry), params, \
        encoder_params


def run_train(preset: str, argv=None):
    cfg = config_lib.get_config(preset)
    p = base_parser("train", preset, f"Train the {preset} captioner")
    p.add_argument("--checkpoint-dir", default=".")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume from (.pt, or a JAX .msgpack); 'auto' "
                        "picks the most recent in --checkpoint-dir (mid-epoch STEP "
                        "files rank by resume position), so re-running the same "
                        "command after a preemption continues where it stopped")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--reset-stale", action="store_true",
                   help="on resume, zero the epochs-since-improvement counter (the "
                        "reference's zero_out_epochs_since_improvement knob, "
                        "geo-aware/train.py:54)")
    p.add_argument("--glove", default=None,
                   help="path to GloVe-format embeddings for word init")
    p.add_argument("--encoder-weights", default=None, metavar="FILE",
                   help="initialize the image encoder from pretrained weights: a "
                        "torchvision resnet101 state_dict .pth, or an encoder tree "
                        "or checkpoint (.pt or JAX .msgpack); the 1x1 projection is "
                        "freshly initialized when the file carries none")
    p.add_argument("--streaming", action="store_true",
                   help="stream batches from the HDF5 sidecar store (not ported yet)")
    p.add_argument("--batch-size", type=int, default=None, metavar="B",
                   help="training batch size (default: the reference's per-preset "
                        "value)")
    p.add_argument("--grad-accum", default=None, metavar="N",
                   type=lambda s: s if s == "auto" else int(s),
                   help="split each batch into N sequential microbatches, "
                        "accumulating gradients before the single optimizer update "
                        "(exact full-batch-mean semantics, ~1/N peak activation "
                        "memory); 'auto' resolves to 1 until a table is measured on "
                        "the H100. Incompatible with TrainConfig.bn_train_mode")
    p.add_argument("--geometry", default=None, metavar="DxH",
                   help="from-scratch transformer geometry '<emb_dim>x<num_heads>' "
                        "(e.g. 256x8). Not checkpoint parity with the reference; "
                        "recorded in checkpoints so eval/serve pick it up. "
                        "Incompatible with --glove (GloVe vectors are 300-d).")
    add_parallel_args(p, "train")
    args = p.parse_args(argv)
    _refuse_unported(p, args)

    from icek_torch.train import checkpoint as ckpt_lib

    resume = args.resume
    if resume == "auto":
        resume = ckpt_lib.latest_checkpoint(args.checkpoint_dir, cfg.data.base_name)
        print(f"auto-resume: {resume or 'no checkpoint found, fresh run'}")
    if resume:
        # a resumed run trains at the checkpoint's recorded geometry
        cfg = config_lib.resolve_geometry(cfg, ckpt_lib.read_meta(resume),
                                          flag=args.geometry)
    elif args.geometry:
        cfg = config_lib.apply_geometry(cfg, args.geometry)
    if args.glove and cfg.model.emb_dim != 300:
        raise SystemExit("--glove requires emb_dim=300 (GloVe 42B vectors); "
                         f"geometry {config_lib.geometry_of(cfg)} is incompatible")

    from icek_torch.train import loop as train_loop
    from icek_torch.train.embeddings import load_glove_embeddings

    if args.batch_size:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=args.batch_size))
    if args.grad_accum is not None:
        # `is not None`: --grad-accum 1 must override the "auto" default
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    grad_accum_steps=args.grad_accum))
    wm = load_wordmap(args.data_dir, cfg.data.base_name)
    pretrained = None
    if args.glove:
        pretrained = load_glove_embeddings(args.glove, wm, cfg.model.emb_dim)
    return train_loop.train(
        cfg, args.data_dir, len(wm), wm.pad_id,
        checkpoint_dir=args.checkpoint_dir,
        pretrained_embeddings=pretrained,
        resume_from=resume,
        max_epochs=args.epochs,
        reset_epochs_since_improvement=args.reset_stale,
        encoder_weights=args.encoder_weights,
        device=args.device,
    )


def run_eval(preset: str, argv=None):
    cfg = config_lib.get_config(preset)
    p = base_parser("eval", preset, f"Evaluate the {preset} captioner on the TEST split")
    p.add_argument("--checkpoint", required=True,
                   help=".pt or JAX .msgpack checkpoint, or reference .pth.tar")
    p.add_argument("--reference-dir", default=None,
                   help="reference subproject dir (for unpickling the classes inside "
                        "a .pth.tar checkpoint)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="decode batch size (default: 256 on CUDA, 64 on CPU)")
    p.add_argument("--beam", type=int, default=None,
                   help="beam size (default: preset; 1 = greedy)")
    p.add_argument("--metric-data", default="data",
                   help="directory with the metric pkl tables")
    p.add_argument("--splits", default="img_caption_data/captions_split.json")
    p.add_argument("--entities", default="img_caption_data/entity_context.pkl")
    p.add_argument("--knowledge", default="img_caption_data/knowledge_context.pkl")
    p.add_argument("--output", default="generated_captions.csv")
    p.add_argument("--streaming", action="store_true",
                   help="read the TEST split via the streaming loader (not ported yet)")
    p.add_argument("--encoder-int8", type=int, default=0, metavar="N",
                   help="quantize the frozen ResNet encoder to int8, calibrating on N "
                        "VAL batches (not ported yet)")
    p.add_argument("--encoder-qtree", default=None, metavar="FILE",
                   help="use an already calibrated int8 encoder tree (not ported yet)")
    p.add_argument("--geometry", default=None, metavar="DxH",
                   help="transformer geometry of the checkpoint (normally read from "
                        "its meta)")
    p.add_argument("--kv-dtype", choices=["int8", "int8_cross", "auto"], default=None,
                   help="quantize the beam-decode KV caches (decode/beam.py); 'auto' "
                        "is float on every device; int8 modes are not bit parity "
                        "with the float pipeline")
    p.add_argument("--cache-tokens", nargs="?", const="auto", default=None,
                   metavar="FILE",
                   help="encode the TEST split once and cache the encoder tokens "
                        "(default FILE: TEST_TOKENS_{base}.npz in --data-dir); later "
                        "runs with the same checkpoint load the cache and skip the "
                        "encoder and the image reads. Caches are bound to the "
                        "encoder weights by fingerprint")
    add_parallel_args(p, "decode")
    args = p.parse_args(argv)
    _refuse_unported(p, args)

    if args.kv_dtype:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, kv_dtype=args.kv_dtype))

    from icek_torch import eval_driver
    from icek_torch.data import dataset as ds

    wm = load_wordmap(args.data_dir, cfg.data.base_name)
    if args.checkpoint.endswith(".pth.tar") and args.reference_dir:
        # the pickled modules resolve against the reference's own models.py,
        # which imports torchvision: stub it where it is not loaded
        import types

        if "torchvision" not in sys.modules:
            stub = types.ModuleType("torchvision")
            stub.models = types.SimpleNamespace(resnet101=None)
            sys.modules["torchvision"] = stub
        sys.path.insert(0, args.reference_dir)
    cfg, params, encoder_params = _load_model(cfg, args)
    data = ds.CaptionDataset(args.data_dir, cfg.data.base_name, "TEST", cfg.model.has_facts)
    evaluator = eval_driver.Evaluator(cfg, wm, params, encoder_params,
                                      batch_size=args.batch_size, beam_size=args.beam,
                                      device=args.device)
    if args.cache_tokens:
        default_path = os.path.join(args.data_dir, f"TEST_TOKENS_{cfg.data.base_name}.npz")
        evaluator.cache_split_tokens(
            data, default_path if args.cache_tokens == "auto" else args.cache_tokens)

    js_metric = fact_metric = predicate_to_objects = None
    if cfg.model.variant == "geo" and os.path.isdir(args.metric_data):
        from icek_torch.metrics.js_geo import JSGeoMetric

        js_metric = JSGeoMetric.from_data_dir(dict(wm.word_to_id), args.metric_data)
    if cfg.model.variant == "knowledge" and os.path.isdir(args.metric_data):
        import pickle

        from icek_torch.metrics.fact_accuracy import FactAccuracyMetric

        fact_metric = FactAccuracyMetric.from_data_dir(
            args.splits, args.entities, args.knowledge, args.metric_data)
        with open(os.path.join(args.metric_data, "predicate_to_objects.pkl"), "rb") as f:
            predicate_to_objects = pickle.load(f)
    return evaluator.run(data, js_metric=js_metric, fact_metric=fact_metric,
                         predicate_to_objects=predicate_to_objects,
                         output_csv=args.output)


def _strip_flag(argv, name, has_value=True):
    """Remove ``name [value]`` / ``name=value`` occurrences from argv."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == name:
            skip = has_value
            continue
        if has_value and tok.startswith(name + "="):
            continue
        out.append(tok)
    return out


def replica_argv(preset: str, argv):
    """The command line of one ``--replicas`` replica: this same serve
    command without --replicas / --port / --host (``launch_replicas`` adds
    each replica's own port and host)."""
    raw = list(argv)
    for flag in ("--replicas", "--port", "--host"):
        raw = _strip_flag(raw, flag)
    return ["-m", "icek_torch.apps", "serve", preset] + raw


def _run_serve_router(preset, argv, args):
    """serve --replicas N: spawn N single-engine replica processes of this
    same command (``router.launch_replicas`` gives each its port and
    ``CUDA_VISIBLE_DEVICES``), then front them with the round-robin router
    on --port."""
    from icek_torch.serve import router as router_lib

    raw = sys.argv[1:] if argv is None else argv
    procs, specs = router_lib.launch_replicas(replica_argv(preset, raw), args.replicas,
                                              args.port, host=args.host)
    try:
        print(f"waiting for {args.replicas} replicas {specs} "
              f"(warmup includes building the kernels)", flush=True)
        router_lib.wait_for_healthy(specs, procs=procs)
        server = router_lib.make_router(specs, args.host, args.port)
        print(f"routing over {specs} on "
              f"http://{args.host}:{server.server_address[1]}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait()


def run_serve(preset: str, argv=None):
    """Online serving entry point (the reference has no serving path; see
    ``serve/engine.py``).  Blocks in ``serve_forever`` until the server is
    shut down."""
    cfg = config_lib.get_config(preset)
    p = base_parser("serve", preset, f"Serve the {preset} captioner over HTTP")
    p.add_argument("--checkpoint", required=True,
                   help=".pt or JAX .msgpack checkpoint, or reference .pth.tar")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--beam", type=int, default=None,
                   help="beam size (default: preset; 1 = greedy)")
    p.add_argument("--max-batch", type=int, default=64, help="largest dynamic-batch bucket")
    p.add_argument("--max-wait-ms", type=float, default=3.0,
                   help="how long the oldest request waits for batchmates")
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once on a TEST-split sample before "
                        "accepting traffic")
    p.add_argument("--encoder-qtree", default=None, metavar="FILE",
                   help="serve with the int8 encoder from a calibrated tree (not "
                        "ported yet)")
    p.add_argument("--replicas", type=int, default=1,
                   help="run N replica engines (one process per card, "
                        "CUDA_VISIBLE_DEVICES=i) behind a round-robin router on --port")
    p.add_argument("--kv-dtype", choices=["int8", "int8_cross", "auto"], default=None,
                   help="quantize the beam-decode KV caches (decode/beam.py); int8 "
                        "modes are not bit parity with the float pipeline")
    p.add_argument("--geometry", default=None, metavar="DxH",
                   help="transformer geometry of the checkpoint, for checkpoints "
                        "that do not record it")
    args = p.parse_args(argv)
    _refuse_unported(p, args)

    if args.kv_dtype:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, kv_dtype=args.kv_dtype))
    if args.replicas > 1:
        return _run_serve_router(preset, argv, args)

    from icek_torch.serve.engine import ServingEngine
    from icek_torch.serve.server import make_server

    wm = load_wordmap(args.data_dir, cfg.data.base_name)
    cfg, params, encoder_params = _load_model(cfg, args)
    engine = ServingEngine(cfg, wm, params, encoder_params, beam_size=args.beam,
                           max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                           device=args.device)
    if args.warmup:
        import numpy as np

        from icek_torch.data import dataset as ds

        data = ds.CaptionDataset(args.data_dir, cfg.data.base_name, "TEST",
                                 cfg.model.has_facts)
        row = data.batch(np.array([0]), raw_images=True)
        sample = {k: v[0] for k, v in row.items()
                  if k in ("raw_images", "images", "image_tokens",
                           "entity_features", "fact_features")}
        sample["entity_names"] = data.arrays.entity_names[0]
        if data.arrays.fact_names is not None:
            sample["fact_names"] = data.arrays.fact_names[0]
        print("warmup: buckets", engine.buckets, flush=True)
        engine.warmup(sample)
    server = make_server(engine, args.host, args.port)
    print(f"serving {preset} on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()


RUNNERS = {"train": run_train, "eval": run_eval, "serve": run_serve}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(
        prog="python -m icek_torch.apps",
        description="Train, evaluate or serve a captioner with the PyTorch port.")
    p.add_argument("verb", choices=VERBS)
    p.add_argument("preset", choices=sorted(config_lib.PRESETS))
    if len(argv) < 2 or argv[0] not in VERBS or argv[1] not in config_lib.PRESETS:
        p.parse_args(argv[:2])         # usage, or an argparse error (exit 2)
        return 2
    RUNNERS[argv[0]](argv[1], argv[2:])
    return 0
