"""The training run: the epoch loop with the reference's plateau decay and
early stop (geo-aware/train.py:57-220); port of ``icek_tpu/train/loop.py``.

As in the JAX package:
  * the frozen image encoder runs once per split (the token cache), and on
    the card the train split's tokens are lifted into device memory when
    they fit ``device_token_cache_gb`` (batches then carry row ids);
  * batches are static-shape with masked padding, prefetched and, on CUDA,
    uploaded on a side stream (``data.dataset.stage_to``);
  * mid-epoch STEP checkpoints (every ``checkpoint_every_steps`` batches, or
    on SIGTERM) resume bit-identically: the loader skips the epoch's prefix
    and every step's dropout generator is seeded from (seed, epoch, global
    batch index) (``step_generator``), the port's counterpart of
    ``fold_in(fold_in(k_train, epoch), i)``;
  * under a (data, model) mesh (``parallel/mesh.py``, one process per card)
    the params shard, each process loads its data index's rows of every
    global batch, and every process gathers the sharded tables before a
    checkpoint that only the primary writes, in the single-process format
    (a run saved on one world size resumes on another).
The log lines are the JAX package's, word for word.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from icek_torch import bridge
from icek_torch.core import config as config_lib
from icek_torch.core.config import Config
from icek_torch.data import dataset as ds
from icek_torch.data import images as image_ops
from icek_torch.models import captioner, resnet
from icek_torch.train import checkpoint as ckpt
from icek_torch.train import step as step_lib
from icek_torch.utils import profiling

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Meter:
    """Running value / average (the reference's AverageMeter,
    geo-aware/utils.py:51-68)."""

    def __init__(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


@dataclasses.dataclass
class TrainResult:
    best_loss: float
    epochs_run: int
    params: dict
    encoder_params: dict
    preempted: bool = False


class Preempted(Exception):
    """Raised by the step callback after the preemption checkpoint is
    written; unwinds run_epoch so train() can return cleanly."""


def step_generator(seed: int, epoch: int, i: int) -> torch.Generator:
    """The dropout generator of global batch `i` of `epoch`: a CPU generator
    seeded from (seed, epoch, i) alone, so a resumed epoch draws what the
    uninterrupted one drew."""
    words = np.random.SeedSequence((seed, epoch, i)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))


def _data_slice(mesh) -> dict:
    """The loader's process arguments: this rank's data index and the data
    axis's size under a mesh (ranks of one data index load the same rows)."""
    if mesh is None:
        return {}
    from icek_torch.parallel import mesh as mesh_lib

    return {"process_index": mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS),
            "process_count": mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)}


def run_epoch(
    train_step, params, opt_state, encoder_params, data: ds.CaptionDataset,
    batch_size: int, seed: int, epoch: int, print_freq: int = 100,
    log: Callable[[str], None] = print, enc_opt_state=None,
    bn_train_mode: bool = False, raw_images: bool = False,
    start_batch: int = 0, step_callback=None, device="cuda", mesh=None, timer=None,
):
    """One epoch from batch ``start_batch`` on.  On CUDA the losses stay on
    the device and are read at print boundaries and at the end; on the CPU
    every step.  ``step_callback(i, params, opt_state, encoder_params,
    enc_opt_state)`` runs after every step (the fault-tolerance hook; may
    raise :class:`Preempted` after saving).  Under `mesh` `batch_size` is
    the global batch and this process loads its rows of it.  `timer` (a
    ``profiling.StepTimer``) splits each iteration into data and step time."""
    batch_time, data_time, losses = Meter(), Meter(), Meter()
    timer = timer if timer is not None else profiling.StepTimer()
    start = time.time()
    n_batches = -(-len(data) // batch_size)
    batches = ds.prefetch(
        data.epoch_batches(batch_size, shuffle=True, seed=epoch, raw_images=raw_images,
                           start_batch=start_batch, **_data_slice(mesh)),
        ds.stage_to(device),
    )
    fine_tune = enc_opt_state is not None
    staged = torch.device(device).type == "cuda"
    pending = []

    def drain():
        for loss, count in pending:
            losses.update(float(loss), int(count))
        pending.clear()

    for i, (batch, ready) in enumerate(batches, start=start_batch):
        data_time.update(time.time() - start)
        batch = ds.wait_staged(batch, ready)
        timer.data_ready()
        gen = step_generator(seed, epoch, i)
        if fine_tune:
            (params, opt_state, encoder_params, enc_opt_state, loss,
             count) = train_step(params, opt_state, encoder_params, enc_opt_state,
                                 batch, gen)
        elif bn_train_mode:
            params, opt_state, encoder_params, loss, count = train_step(
                params, opt_state, encoder_params, batch, gen)
        else:
            params, opt_state, loss, count = train_step(
                params, opt_state, encoder_params, batch, gen)
        if staged:
            pending.append((loss, count))
            if i % print_freq == 0:
                drain()
        else:
            losses.update(float(loss), int(count))
        if step_callback is not None:
            step_callback(i, params, opt_state, encoder_params, enc_opt_state)
        timer.step_done()
        batch_time.update(time.time() - start)
        start = time.time()
        if i % print_freq == 0:
            log(
                f"Epoch: [{epoch}][{i}/{n_batches}]\t"
                f"Batch Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                f"Data Load Time {data_time.val:.3f} ({data_time.avg:.3f})\t"
                f"Loss {losses.val:.4f} ({losses.avg:.4f})"
            )
    drain()
    return params, opt_state, losses.avg, encoder_params, enc_opt_state


def run_validation(
    eval_step, params, encoder_params, data: ds.CaptionDataset,
    batch_size: int, print_freq: int = 100, log: Callable[[str], None] = print,
    raw_images: bool = False, device="cuda", mesh=None,
):
    losses = Meter()
    n_batches = -(-len(data) // batch_size)
    batches = ds.prefetch(
        data.epoch_batches(batch_size, shuffle=False, raw_images=raw_images,
                           **_data_slice(mesh)),
        ds.stage_to(device),
    )
    staged = torch.device(device).type == "cuda"
    pending = []

    def drain():
        for loss, count in pending:
            losses.update(float(loss), int(count))
        pending.clear()

    for i, (batch, ready) in enumerate(batches):
        loss, count = eval_step(params, encoder_params, ds.wait_staged(batch, ready))
        if staged:
            pending.append((loss, count))
            if i % print_freq == 0:
                drain()
        else:
            losses.update(float(loss), int(count))
        if i % print_freq == 0:
            log(f"Validation: [{i}/{n_batches}]\tLoss {losses.val:.4f} ({losses.avg:.4f})")
    drain()
    return losses.avg


def resolve_token_cache_placement(
    n_rows: int, row_bytes: int, budget_gb: float, dp: int
) -> Optional[str]:
    """Device token-cache placement (``TrainConfig.device_token_cache_gb``):
    "replicated" when the whole cache fits one card's budget, "sharded" when
    it does not but one data shard's rows do (the mesh pools the budget over
    `dp` cards), None when neither holds it."""
    budget = budget_gb * 2**30
    if budget <= 0 or n_rows <= 0:
        return None
    if n_rows * row_bytes <= budget:
        return "replicated"
    if dp > 1 and -(-n_rows // dp) * row_bytes <= budget:
        return "sharded"
    return None


class _GatheredOptState:
    """An ``OptState`` as a checkpoint sees it under a mesh: ``export``
    gives the moments all-gathered to full size (built on every process,
    the collective, before the primary writes)."""

    def __init__(self, opt_state, params, mesh, specs):
        from icek_torch.parallel import mesh as mesh_lib

        self.state = opt_state.export(
            params, gather=lambda tree: mesh_lib.gather_for_host(tree, mesh, specs))

    def export(self, _params):
        return self.state


def train(
    cfg: Config,
    data_dir: str,
    vocab_size: int,
    pad_id: int,
    checkpoint_dir: str = ".",
    pretrained_embeddings: Optional[np.ndarray] = None,
    resume_from: Optional[str] = None,
    max_epochs: Optional[int] = None,
    reset_epochs_since_improvement: bool = False,
    log: Callable[[str], None] = print,
    mesh=None,
    encoder_weights: Optional[str] = None,
    device="cuda",
) -> TrainResult:
    """Full training run for one preset on `device` ("cuda" unless the
    caller asks for the CPU); returns the best params.  `resume_from` takes
    the port's ``.pt`` checkpoints and JAX ``.msgpack`` ones.

    With `mesh` (``parallel/mesh.py::make_mesh``) every process of the mesh
    calls this: ``tc.batch_size`` is the GLOBAL batch, the run is on the
    mesh's device, and the returned params are this rank's shards."""
    mesh_lib = None
    if mesh is not None:
        from icek_torch.parallel import distributed
        from icek_torch.parallel import mesh as mesh_lib

        device = mesh_lib.mesh_device(mesh)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run there")
    tc = cfg.train
    if tc.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"train: compute_dtype {tc.compute_dtype!r} is not one of "
                         f"{sorted(_COMPUTE_DTYPES)}")
    # the CPU runs the plain versions, in float32 whatever the config says
    compute_dtype = (torch.float32 if device.type == "cpu"
                     else _COMPUTE_DTYPES[tc.compute_dtype])
    has_facts = cfg.model.has_facts
    if cfg.data.streaming:
        # disk-backed splits: sidecars from the HDF5 store, token caches on
        # disk (data/streaming.py)
        from icek_torch.data import streaming

        split_cls = streaming.StreamingCaptionDataset
    else:
        split_cls = ds.CaptionDataset
    train_data = split_cls(data_dir, cfg.data.base_name, "TRAIN", has_facts)
    val_data = split_cls(data_dir, cfg.data.base_name, "VAL", has_facts)

    gen = torch.Generator().manual_seed(tc.seed)
    params = captioner.init_captioner_params(gen, cfg.model, vocab_size)
    if pretrained_embeddings is not None:
        params["word_embedding"] = torch.as_tensor(pretrained_embeddings,
                                                   dtype=torch.float32)
    if encoder_weights:
        # the reference's torchvision resnet101(pretrained=True)
        # (geo-aware/models.py:14-16, train.py:90)
        from icek_torch.train import port

        encoder_params = port.resolve_encoder_weights(
            encoder_weights, cfg.model.emb_dim, seed=tc.seed)
        log(f"encoder initialized from {encoder_weights}")
    else:
        encoder_params = resnet.init_resnet101(gen, cfg.model.emb_dim)

    start_epoch, stale, best_loss, resume_step, restored_opt = 0, 0, float("inf"), 0, None
    if resume_from:
        params, restored_opt, enc, meta = ckpt.load_checkpoint(resume_from)
        recorded_geom = meta.get("geometry")
        if recorded_geom and recorded_geom != config_lib.geometry_of(cfg):
            raise ValueError(
                f"resume checkpoint {resume_from} records geometry "
                f"{recorded_geom} but the config is "
                f"{config_lib.geometry_of(cfg)}; apply the recorded "
                f"geometry (core.config.apply_geometry) before resuming"
            )
        if enc is not None:
            encoder_params = enc
        if "step" in meta:
            # a mid-epoch checkpoint: re-enter the same epoch at its batch
            start_epoch = meta["epoch"]
            resume_step = meta["step"]
        else:
            start_epoch = meta["epoch"] + 1
        stale = meta["epochs_since_improvement"]
        if reset_epochs_since_improvement:
            # the reference's zero_out_epochs_since_improvement knob
            # (geo-aware/train.py:54,108-123)
            stale = 0
        best_loss = meta["loss"]
        log(
            f"Resumed from {resume_from} at epoch {start_epoch}"
            + (f" batch {resume_step}" if resume_step else "")
            + (" (stale counter reset)" if reset_epochs_since_improvement else "")
        )

    specs = None
    primary = True
    if mesh is not None:
        params, specs = mesh_lib.shard_params(params, mesh)
        primary = distributed.process_info().is_primary
        if restored_opt is not None:
            # checkpoints hold full-size moments: keep this rank's blocks
            local = lambda t, spec: mesh_lib.local_slice(t, spec, mesh)  # noqa: E731
            restored_opt = dict(restored_opt,
                                mu=mesh_lib.map_specs(restored_opt["mu"], specs, local),
                                nu=mesh_lib.map_specs(restored_opt["nu"], specs, local))
    params = bridge.trainable(params, device)
    encoder_params = bridge.to_device(encoder_params, device)
    optimizer = step_lib.make_optimizer(tc.decoder_lr, tc.grad_clip)
    opt_state = optimizer.init(params)
    if restored_opt is not None:
        opt_state.restore(params, restored_opt)

    encoder_optimizer = enc_opt_state = None
    encode_images = tc.fine_tune_encoder or tc.bn_train_mode
    # image-carrying bf16 batches ship the stored f16 rows and normalize on
    # the device; f32 keeps the exact host normalize
    raw_image_batches = encode_images and compute_dtype == torch.bfloat16
    if tc.fine_tune_encoder:
        encoder_optimizer = step_lib.make_encoder_optimizer(
            encoder_params, tc.encoder_lr, tc.grad_clip)
        enc_opt_state = encoder_optimizer.init(encoder_params)
    elif not tc.bn_train_mode:
        # the frozen encoder runs once per split; bf16 stores f16 tokens of
        # the stored f16 rows normalized on the device, f32 exact tokens
        raw_feed = compute_dtype == torch.bfloat16
        cache_dtype = np.float16 if raw_feed else np.float32

        @torch.no_grad()
        def encode(imgs):
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(device)
            if raw_feed:
                x = image_ops.normalize_in_graph(x)
            return resnet.resnet_encode(
                encoder_params, x, cfg.model.encoded_image_size,
                compute_dtype=compute_dtype).float().cpu().numpy()

        for split_data in (train_data, val_data):
            split_data.cache_image_tokens(encode, dtype=cache_dtype, raw=raw_feed)

    # the train split's tokens in device memory when they fit the budget:
    # batches carry row ids and the step gathers the tokens on the device
    # Under a mesh a cache within one card's budget is replicated; one that
    # exceeds it but whose data shard fits is row-sharded over the data axis
    # (mesh.shard_rows) and read with mesh.sharded_row_gather.
    token_cache = token_cache_mesh = None
    if (not encode_images and device.type != "cpu" and tc.device_token_cache_gb > 0
            and train_data.image_tokens is not None):
        tokens = train_data.image_tokens
        n_rows = int(tokens.shape[0])
        # stored in the compute dtype on the card
        row_bytes = int(np.prod(tokens.shape[1:])) * compute_dtype.itemsize
        nbytes = n_rows * row_bytes
        dp = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS) if mesh is not None else 1
        placement = resolve_token_cache_placement(
            n_rows, row_bytes, tc.device_token_cache_gb, dp)
        if placement == "replicated":
            # np.asarray(tokens[:]) reads a streaming split's disk cache whole
            token_cache = torch.from_numpy(np.asarray(tokens[:])).to(device).to(compute_dtype)
            train_data.use_token_rows = True
            log(f"device token cache: {nbytes / 2**20:.0f} MiB in HBM"
                f"{' (replicated over mesh)' if mesh is not None else ''}; "
                "batches carry row ids only")
        elif placement == "sharded":
            token_cache = mesh_lib.shard_rows(tokens, mesh, compute_dtype)
            token_cache_mesh = mesh
            train_data.use_token_rows = True
            log(f"device token cache: {nbytes / 2**20:.0f} MiB row-sharded over {dp} "
                f"data shards ({nbytes / dp / 2**20:.0f} MiB/card); batches carry "
                "row ids only")

    train_step, eval_step = step_lib.make_train_step(
        cfg, vocab_size, pad_id, optimizer,
        compute_dtype=compute_dtype,
        encode_images=encode_images,
        encoder_optimizer=encoder_optimizer,
        bn_train_mode=tc.bn_train_mode,
        token_cache=token_cache,
        token_cache_mesh=token_cache_mesh,
        device=device,
        mesh=mesh,
        param_specs=specs,
    )

    # one writer of the metric log under a mesh
    metric_log = profiling.MetricLogger(
        (os.environ.get("ICEK_METRICS_LOG") or None) if primary else None)
    profile_dir = profiling.profile_dir_from_env()

    # fault tolerance: a SIGTERM sets the flag; the step callback then writes
    # the rolling STEP checkpoint and unwinds through Preempted.  Interval
    # saves are deterministic across processes, so they stay on under a
    # mesh; the signal path is single-process only.
    preempt_flag = threading.Event()
    prev_handler = None
    catch_signals = (tc.save_on_preempt
                     and (mesh is None or distributed.process_info().count == 1)
                     and threading.current_thread() is threading.main_thread())

    def host_state(p, o, e):
        """(params, optimizer state, encoder params) full-size for a
        checkpoint: under a mesh the sharded tables and their moments
        all-gathered (a collective every process joins)."""
        if mesh is None:
            return p, o, e
        return (mesh_lib.gather_for_host(p, mesh, specs),
                _GatheredOptState(o, p, mesh, specs), e)
    if catch_signals:
        prev_handler = signal.signal(signal.SIGTERM, lambda *_: preempt_flag.set())

    def make_step_callback(epoch, stale, best_loss):
        every = tc.checkpoint_every_steps
        if not every and not catch_signals:
            return None

        def step_cb(i, p, o, e, eo):
            preempt = preempt_flag.is_set()
            if not preempt and not (every and (i + 1) % every == 0):
                return
            save_p, save_o, save_e = host_state(p, o, e)
            if primary:
                path = ckpt.save_checkpoint(
                    checkpoint_dir, cfg.data.base_name, epoch, stale, best_loss,
                    save_p, save_o, save_e, step=i + 1,
                    extra_meta={"geometry": config_lib.geometry_of(cfg)})
                if preempt:
                    log(f"PREEMPTED: saved {path} at epoch {epoch} batch {i + 1}")
            if preempt:
                raise Preempted
        return step_cb

    epochs = max_epochs if max_epochs is not None else tc.epochs
    epoch = start_epoch
    preempted = False
    try:
        for epoch in range(start_epoch, epochs):
            if stale == tc.max_epochs_since_improvement:
                break
            if stale > 0 and stale % tc.lr_decay_every == 0:
                opt_state = step_lib.decay_learning_rate(opt_state, tc.lr_decay_factor)
                if enc_opt_state is not None:
                    enc_opt_state = step_lib.decay_learning_rate(
                        enc_opt_state, tc.lr_decay_factor)
                log("DECAYING learning rate to "
                    f"{float(opt_state.hyperparams['learning_rate']):.6f}")
            timer = profiling.StepTimer()
            try:
                with profiling.trace(profile_dir if epoch == start_epoch else None):
                    (params, opt_state, train_loss, encoder_params,
                     enc_opt_state) = run_epoch(
                        train_step, params, opt_state, encoder_params, train_data,
                        tc.batch_size, tc.seed, epoch, tc.print_freq, log,
                        enc_opt_state=enc_opt_state,
                        bn_train_mode=tc.bn_train_mode and not tc.fine_tune_encoder,
                        raw_images=raw_image_batches,
                        start_batch=resume_step if epoch == start_epoch else 0,
                        step_callback=make_step_callback(epoch, stale, best_loss),
                        device=device, mesh=mesh, timer=timer,
                    )
            except Preempted:
                preempted = True
                break
            val_loss = run_validation(
                eval_step, params, encoder_params, val_data, tc.batch_size,
                tc.print_freq, log, raw_images=raw_image_batches, device=device,
                mesh=mesh)
            metric_log.log("epoch", epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                           lr=float(opt_state.hyperparams["learning_rate"]),
                           **timer.summary())
            is_best = val_loss < best_loss
            best_loss = min(val_loss, best_loss)
            stale = 0 if is_best else stale + 1
            if not is_best:
                log(f"Epochs since last improvement: {stale}")
            save_p, save_o, save_e = host_state(params, opt_state, encoder_params)
            if primary:
                ckpt.save_checkpoint(
                    checkpoint_dir, cfg.data.base_name, epoch, stale, val_loss,
                    save_p, save_o, save_e, is_best,
                    extra_meta={"geometry": config_lib.geometry_of(cfg)})
                # the completed epoch outranks any STEP file from its interior
                step_file = os.path.join(checkpoint_dir,
                                         f"checkpoint_STEP_{cfg.data.base_name}.pt")
                if os.path.exists(step_file):
                    os.remove(step_file)
    finally:
        if catch_signals:
            signal.signal(signal.SIGTERM, prev_handler)
    return TrainResult(best_loss, epoch + 1 - start_epoch, params, encoder_params,
                       preempted=preempted)
