"""Command-line entry points of the port (copies of ``apps/common.py``'s
runners and of the host tools under ``tools/``, over ``icek_torch``):

    python -m icek_torch.apps train|eval|serve|prep|metrics|quantize \\
        georic|k_georic|nytimes800k|georic_fast [flags]
    python -m icek_torch.apps validate DATA_DIR [--preset P] [flags]
    python -m icek_torch.apps port-encoder WEIGHTS.pth OUT.pt [flags]

``prep`` writes the input files from a raw split (``create_input_files``),
``metrics`` scores a captions CSV (``compute_eval_metrics``), ``quantize``
calibrates and writes an int8 encoder tree (``tools/quantize_encoder.py``),
``validate`` lints prepared files (``tools/validate_dataset.py``) and
``port-encoder`` turns torchvision ResNet-101 weights into an encoder tree
(``tools/port_torchvision_encoder.py``).  Every flag of the JAX CLIs is
accepted.  ``--device`` (default ``cuda``) is the one flag they lack: it is
how a caller asks for the CPU.  ``train`` and ``eval`` take
``--distributed`` and ``--mesh DATA,MODEL|auto``: one process per card
(``torchrun`` or the ``ICEK_*`` variables, ``parallel/distributed.py``), NCCL
on CUDA and gloo with ``--device cpu``.  Checkpoints: the port's ``.pt``,
JAX's ``.msgpack`` and the reference's ``.pth.tar``; int8 trees: the port's
``.pt`` and JAX's ``.msgpack``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

from icek_torch.core import config as config_lib
from icek_torch.data.codec import Wordmap

# verbs that run the model on --device, the host-only verbs of a preset, and
# the host tools, which take their own arguments
VERBS = ("train", "eval", "serve", "quantize")
HOST_VERBS = ("prep", "metrics")
PRESET_VERBS = VERBS + HOST_VERBS
TOOL_VERBS = ("validate", "port-encoder")


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
                   help="start the multi-process runtime (one process per card) "
                        "before anything touches the card; topology from "
                        "ICEK_COORDINATOR/ICEK_NUM_PROCESSES/ICEK_PROCESS_ID or "
                        "the torchrun environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT, LOCAL_RANK)")
    p.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                   help=f"{verb} over a (data, model) mesh of DATA x MODEL processes, "
                        "e.g. '4,2'; 'auto' = every process on the data axis. Implied "
                        "(auto) by --distributed")


def resolve_parallel(args):
    """Start the process group and build the mesh, if asked for (``None``
    otherwise).  Must run before anything else touches the card.  A world of
    one process (``--mesh 1,1`` without a launcher) runs a single-rank
    group."""
    if not (args.distributed or args.mesh):
        return None
    from icek_torch.parallel import distributed
    from icek_torch.parallel import mesh as mesh_lib

    # force: --distributed with no topology must fail, not run N independent
    # unsharded replicas
    info = distributed.maybe_initialize(force=args.distributed, device=args.device)
    if args.distributed:
        print(f"distributed: process {info.index}/{info.count}")
    shape = {}
    if args.mesh and args.mesh != "auto":
        data_ax, model_ax = (int(x) for x in args.mesh.split(","))
        shape = dict(data=data_ax, model=model_ax)
    try:
        return mesh_lib.make_mesh(device=args.device, **shape)
    except BaseException:
        distributed.shutdown()
        raise


def _with_mesh(run, mesh):
    """run(), then the process group of `mesh` destroyed (when there is one)."""
    try:
        return run()
    finally:
        if mesh is not None:
            from icek_torch.parallel import distributed

            distributed.shutdown()


def serve_device(device: str, replica: Optional[str] = None, n_cards: int = 0) -> str:
    """The device a serving process runs on: `device` (``--device``) as
    given, except that a bare "cuda" in replica `replica` of ``--replicas``
    (``ICEK_SERVE_DEVICE``) becomes ``cuda:{replica % n_cards}`` (JAX's
    ``devices[i % n]``), its own card among the `n_cards` it sees whatever
    ``CUDA_VISIBLE_DEVICES`` the operator set."""
    if replica is None or device != "cuda" or n_cards < 1:
        return device
    return f"cuda:{int(replica) % n_cards}"


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
                   help="stream batches from the HDF5 sidecar store "
                        "(data/streaming.py; built on first use)")
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
    mesh = resolve_parallel(args)
    return _with_mesh(lambda: _run_train(cfg, args, resume, mesh), mesh)


def _run_train(cfg, args, resume, mesh):
    from icek_torch.train import loop as train_loop
    from icek_torch.train.embeddings import load_glove_embeddings

    if args.streaming:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, streaming=True))
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
        mesh=mesh,
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
                   help="read the TEST split via the streaming loader")
    p.add_argument("--encoder-int8", type=int, default=0, metavar="N",
                   help="quantize the frozen ResNet encoder to int8 (PTQ, "
                        "models/resnet_int8.py), calibrating activation scales on "
                        "the first N VAL batches (TEST, with a warning, only where "
                        "there is no VAL split); CHANGES ARITHMETIC: captions may "
                        "differ slightly from the bf16 pipeline")
    p.add_argument("--encoder-qtree", default=None, metavar="FILE",
                   help="use an already calibrated int8 encoder tree (the quantize "
                        "verb's .pt, or a JAX .msgpack); overrides --encoder-int8")
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
    if args.cache_tokens and (args.distributed or args.mesh):
        raise SystemExit("--cache-tokens requires a single-process run "
                         "(no --distributed)")

    if args.kv_dtype:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, kv_dtype=args.kv_dtype))
    mesh = resolve_parallel(args)
    return _with_mesh(lambda: _run_eval(cfg, args, mesh), mesh)


def _run_eval(cfg, args, mesh):
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
    if args.streaming:
        from icek_torch.data import streaming

        data = streaming.StreamingCaptionDataset(args.data_dir, cfg.data.base_name, "TEST",
                                                 cfg.model.has_facts)
    else:
        data = ds.CaptionDataset(args.data_dir, cfg.data.base_name, "TEST",
                                 cfg.model.has_facts)
    encoder_qtree = None
    if args.encoder_qtree:
        from icek_torch.models import resnet_int8

        encoder_qtree = resnet_int8.load_qtree(args.encoder_qtree)
    elif args.encoder_int8:
        bs = eval_driver.resolve_eval_batch_size(args.batch_size, cfg, args.device)
        # calibrate on VAL, never on the TEST split whose metrics the run
        # reports; TEST only, with a warning, where no VAL files exist
        try:
            calib_data = ds.CaptionDataset(args.data_dir, cfg.data.base_name, "VAL",
                                           cfg.model.has_facts)
            calib_split = "VAL"
        except OSError:
            calib_data, calib_split = data, "TEST"
            print("[encoder-int8] WARNING: no VAL split found — calibrating "
                  "on TEST, the split being reported (train/test leak; "
                  "prefer the quantize verb with --split VAL)")
        print(f"[encoder-int8] calibrating on {args.encoder_int8} {calib_split} "
              f"batches of {bs} (PTQ — arithmetic differs from bf16)")
        encoder_qtree = calibrate_qtree(encoder_params, calib_data, args.encoder_int8, bs,
                                        args.device)
    evaluator = eval_driver.Evaluator(cfg, wm, params, encoder_params,
                                      batch_size=args.batch_size, beam_size=args.beam,
                                      device=args.device, mesh=mesh,
                                      encoder_qtree=encoder_qtree)
    if args.cache_tokens:
        if args.streaming:
            from icek_torch.data import streaming

            default_path = streaming.token_cache_path(args.data_dir, cfg.data.base_name,
                                                      "TEST")
        else:
            default_path = os.path.join(args.data_dir,
                                        f"TEST_TOKENS_{cfg.data.base_name}.npz")
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


def calibrate_qtree(encoder_params, data, n_batches: int, batch_size: int, device,
                    mode: str = "max", percentile: float = 99.5):
    """An int8 encoder tree calibrated on the first `n_batches` batches of
    `data` (host-normalized images), bound to `encoder_params` by
    fingerprint.  The folded float encoder observes on `device`, in bf16 on
    CUDA and f32 on the CPU."""
    import numpy as np
    import torch

    from icek_torch import bridge
    from icek_torch.models import resnet, resnet_int8

    device = torch.device(device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    folded = resnet.fold_bn_params(bridge.to_device(encoder_params, device))

    def batches():
        for b in range(n_batches):
            idx = np.arange(b * batch_size, min((b + 1) * batch_size, len(data)))
            if len(idx) == 0:
                return
            yield torch.as_tensor(data.batch(idx)["images"], device=device)

    return resnet_int8.calibrate_and_quantize(folded, batches(), dtype,
                                              source_params=encoder_params,
                                              mode=mode, percentile=percentile)

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
                   help="serve with the int8 PTQ encoder from a calibrated tree (the "
                        "quantize verb's .pt, or a JAX .msgpack); changes arithmetic "
                        "against the bf16 pipeline")
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

    if args.kv_dtype:
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, kv_dtype=args.kv_dtype))
    if args.replicas > 1:
        return _run_serve_router(preset, argv, args)

    import torch

    from icek_torch.serve.engine import ServingEngine
    from icek_torch.serve.server import make_server

    # a --replicas replica runs on its own card (ICEK_SERVE_DEVICE=i)
    device = serve_device(args.device, os.environ.get("ICEK_SERVE_DEVICE"),
                          torch.cuda.device_count())

    wm = load_wordmap(args.data_dir, cfg.data.base_name)
    cfg, params, encoder_params = _load_model(cfg, args)
    encoder_qtree = None
    if args.encoder_qtree:
        from icek_torch.models import resnet_int8

        encoder_qtree = resnet_int8.load_qtree(args.encoder_qtree)
    engine = ServingEngine(cfg, wm, params, encoder_params, beam_size=args.beam,
                           max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                           device=device, encoder_qtree=encoder_qtree)
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


def run_prep(preset: str, argv=None):
    """Input files from a raw split (``apps/common.py``'s
    ``run_create_input_files``); ``--streaming`` also writes the HDF5
    sidecar stores."""
    cfg = config_lib.get_config(preset)
    p = argparse.ArgumentParser(prog=f"python -m icek_torch.apps prep {preset}",
                                description=f"Create input files for the {preset} preset")
    p.add_argument("--splits", default="img_caption_data/captions_split.json")
    p.add_argument("--entities", default="img_caption_data/entity_context.pkl")
    p.add_argument("--knowledge", default="img_caption_data/knowledge_context.pkl")
    p.add_argument("--images", default="img_caption_data/images/")
    p.add_argument("--output", default="img_caption_data/input_dataset_files/")
    p.add_argument("--wordmap", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--streaming", action="store_true",
                   help="additionally build the HDF5 sidecar stores for the "
                        "constant-memory streaming loader")
    p.add_argument("--image-workers", type=int, default=None,
                   help="workers for the image read+resize pipeline (default "
                        "min(8, cpus); 1 = serial); output is bit-identical regardless")
    p.add_argument("--image-pool", choices=["process", "thread"], default="process",
                   help="worker kind (process default: the resize stack holds the "
                        "GIL, threads cap out ~1.2x)")
    args = p.parse_args(argv)
    from icek_torch.data.input_files import InputFileWriter

    writer = InputFileWriter(
        cfg, args.splits, args.entities, args.images, args.output,
        knowledge_context_path=args.knowledge if cfg.model.has_facts else None,
        wordmap_file_path=args.wordmap, seed=args.seed,
        image_workers=args.image_workers,
        image_processes=args.image_pool == "process",
    )
    writer.run()
    if args.streaming:
        from icek_torch.data import streaming

        for split in ("TRAIN", "VAL", "TEST"):
            streaming.write_sidecar_store(args.output, cfg.data.base_name, split,
                                          cfg.model.has_facts)


# pandas' default missing-value strings: read_csv(...).fillna("") makes them ""
_NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"))


def read_caption_column(path: str, column: str = "generated_caption"):
    """One column of a captions CSV as ``pd.read_csv(path)[column]
    .fillna("")`` reads it, with the stdlib ``csv`` module."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return ["" if r[column] in _NA_STRINGS else r[column] for r in rows]


def run_metrics(preset: str, argv=None):
    """Score a captions CSV against the split's ground truth
    (``apps/common.py``'s ``run_compute_eval_metrics``)."""
    cfg = config_lib.get_config(preset)
    p = argparse.ArgumentParser(prog=f"python -m icek_torch.apps metrics {preset}",
                                description=f"Score generated captions for the {preset} preset")
    p.add_argument("--captions", default="generated_captions.csv")
    p.add_argument("--splits", default="img_caption_data/captions_split.json")
    p.add_argument("--output", default="metric_scores_for_generated_captions.csv")
    args = p.parse_args(argv)
    from icek_torch.metrics.scores import score_captions

    generated_raw = read_caption_column(args.captions)
    with open(args.splits) as f:
        data = json.load(f)
    # news filters test images by the prep max_len (news compute_eval_
    # metrics.py:27-30); geo/knowledge take every test image and pad missing
    # generated rows with "" (geo compute_eval_metrics.py:15-30)
    if cfg.model.variant == "news":
        test_imgs = [img for img in data["images"]
                     if img["split"] == "test"
                     and len(img["tokens"]) <= cfg.data.max_caption_len]
    else:
        test_imgs = [img for img in data["images"] if img["split"] == "test"]
    # underscores become spaces in both columns for every preset
    true_captions = [" ".join(img["tokens"]).replace("_", " ") for img in test_imgs]
    generated = [(generated_raw[i] if i < len(generated_raw) else "").replace("_", " ")
                 for i in range(len(test_imgs))]
    ids = [img["id"] for img in test_imgs]
    if cfg.model.variant == "news":
        from icek_torch.metrics.ne_pr import NamedEntityPR

        NamedEntityPR().compute(generated, true_captions)
    return score_captions(true_captions, generated, ids, output_csv=args.output)


def run_quantize(preset: str, argv=None):
    """Calibrate and write an int8 encoder tree (``tools/quantize_encoder.py``):
    the folded float encoder observes N batches of a prepared split, the
    tree is quantized and saved with ``torch.save`` for ``eval`` / ``serve
    --encoder-qtree``."""
    cfg = config_lib.get_config(preset)
    p = base_parser("quantize", preset,
                    f"Calibrate and persist an int8 PTQ tree for the {preset} encoder")
    p.add_argument("--checkpoint", required=True,
                   help=".pt or JAX .msgpack checkpoint, or an encoder tree file")
    p.add_argument("--split", default="VAL", choices=["TRAIN", "VAL", "TEST"],
                   help="split to draw calibration batches from (default VAL — "
                        "never calibrate on TEST when TEST is what you report)")
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--calib-mode", default="max", choices=["max", "percentile"],
                   help="activation-scale statistic: 'max' (running max) or "
                        "'percentile' (percentile over per-image maxima)")
    p.add_argument("--percentile", type=float, default=99.5,
                   help="percentile for --calib-mode percentile")
    p.add_argument("--output", required=True, help="output .pt path")
    args = p.parse_args(argv)

    from icek_torch.data import dataset as ds
    from icek_torch.models import resnet_int8
    from icek_torch.train import checkpoint as ckpt_lib

    encoder_params, _ = ckpt_lib.load_encoder_tree(args.checkpoint)
    data = ds.CaptionDataset(args.data_dir, cfg.data.base_name, args.split,
                             cfg.model.has_facts)
    print(f"calibrating on up to {args.batches} x {args.batch_size} {args.split} "
          f"images ({len(data)} available)", flush=True)
    qtree = calibrate_qtree(encoder_params, data, args.batches, args.batch_size,
                            args.device, mode=args.calib_mode, percentile=args.percentile)
    resnet_int8.save_qtree(qtree, args.output)
    size_mb = os.path.getsize(args.output) / 1e6
    print(f"wrote {args.output} ({size_mb:.1f} MB int8 tree)")
    return qtree


def run_port_encoder(argv=None):
    """torchvision ResNet-101 weights -> an encoder tree file for ``train
    --encoder-weights`` (``tools/port_torchvision_encoder.py``)."""
    p = argparse.ArgumentParser(
        prog="python -m icek_torch.apps port-encoder",
        description="Convert torchvision resnet101 weights into an encoder tree")
    p.add_argument("weights", help="torch file: state_dict .pth, {'state_dict': ...} "
                                   "wrapper, or module")
    p.add_argument("output", help="output encoder tree (.pt)")
    p.add_argument("--emb-dim", type=int, default=300,
                   help="projection width (the model's d_model; 300 for every "
                        "reference preset)")
    p.add_argument("--seed", type=int, default=0,
                   help="rng seed for the fresh 1x1 projection")
    args = p.parse_args(argv)

    from icek_torch.train import checkpoint as ckpt
    from icek_torch.train import port

    from icek_torch import bridge

    tree = port.load_torchvision_encoder(args.weights, args.emb_dim, args.seed)
    leaves = []
    bridge._map(tree, lambda t, _path: leaves.append(t))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    ckpt.save_encoder_tree(args.output, tree,
                           meta={"source": os.path.basename(args.weights),
                                 "emb_dim": args.emb_dim, "proj_seed": args.seed})
    print(f"wrote {args.output}: {len(leaves)} arrays, {nbytes / 2**20:.1f} MiB "
          f"(emb_dim={args.emb_dim})")
    return tree


RUNNERS = {"train": run_train, "eval": run_eval, "serve": run_serve, "prep": run_prep,
           "metrics": run_metrics, "quantize": run_quantize}


def run_validate(argv=None) -> int:
    from icek_torch.apps import validate

    return validate.main(argv)


TOOLS = {"validate": run_validate, "port-encoder": run_port_encoder}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in TOOLS:
        rc = TOOLS[argv[0]](argv[1:])
        return rc if isinstance(rc, int) else 0
    p = argparse.ArgumentParser(
        prog="python -m icek_torch.apps",
        description="Prepare data for, train, evaluate, score, quantize or serve a "
                    "captioner with the PyTorch port.",
        epilog=f"host tools: {', '.join(TOOL_VERBS)} (python -m icek_torch.apps "
               "<tool> --help)")
    p.add_argument("verb", choices=PRESET_VERBS)
    p.add_argument("preset", choices=sorted(config_lib.PRESETS))
    if len(argv) < 2 or argv[0] not in PRESET_VERBS or argv[1] not in config_lib.PRESETS:
        p.parse_args(argv[:2])         # usage, or an argparse error (exit 2)
        return 2
    RUNNERS[argv[0]](argv[1], argv[2:])
    return 0
