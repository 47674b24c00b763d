#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (icek_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device   the card's name and power limit, torch / CUDA versions; TF32
              off for every float32 comparison;
  2. build    nvcc builds every kernel from icek_torch/csrc/ (one process
              per source, all at once) and prints ptxas's register,
              shared-memory and spill report;
  3. kernels  each kernel at the shapes the geo serving and training paths
              give it, held against its plain PyTorch version on the card
              in f32 and bf16 (flash attention at all three attention
              sites of a train step, f32 on the TF32 forward timed beside
              the CUDA-core forward it replaced, and bf16 whose rows start
              mid-word on the TF32 forward too; the score head in f32 on its
              3xTF32 tensor-core pass at k 1, 2, 5, 10 and 16, beside the
              CUDA-core pass it replaced, every f32 3xTF32 route with its
              TF32 bound beside the 67 TF/s one; the dropout kernels at rate 0.2 under the
              mask the kernel itself exports, with the mask's keep rate and
              the forward / backward mask identity; the decoder step on
              both its routes in bf16 and in f32, tensor cores (f32: three
              TF32 products a product) and CUDA cores), and
              timed with CUDA events beside its plain version, a one-call
              PyTorch yardstick where one exists, and the card's bound for
              the same work; the loops' instruction counts of the
              tensor-core decoder step are logged; then every kernel again
              at the knowledge (k_georic) and news (nytimes800k) shapes:
              flash at their entity and fact encoders and decoder sites, the
              score head with the [entity | fact] tail, the decoder step at
              40 steps over memories of 548 and 598 rows; the LayerNorm
              forward and backward and the dropout kernel at every row count
              the three presets' train steps give them (norm_rows: 8192 to
              77056), each also timed on the host (the wrapper's own cost a
              call while the device runs ahead); the score head's wide first
              pass at N 640 (geo beam 20) at k 17, 20, 32 and 64, each call's
              first pass held to its route; the flash backward at rate 0 at
              every site too (held, and timed as `rate0_ms`, SDPA's work);
              flash at head dims 40, 64, 75 and 128 (check_flash_wide: f32
              and odd-Hd or misaligned bf16 on the TF32 kernels, aligned
              bf16 on the tensor-core ones, forward and backward at rate 0
              and 0.2, causal and not, beside the CUDA-core forward, SDPA
              and the bound; 64 x 8 heads, the --geometry 512x8 model's, at
              all three train-step sites, where the backward at HDP 64 runs
              the wgmma pair in bf16 and the TF32 pair split by integer
              rounding in f32, its rate-0 time beside SDPA's; the bf16
              forward at HDP 64 and 128 on wgmma at every site, timed
              beside the mma.sync forward it replaced, both designs' keep
              words held equal at rate 0.2);
  4. serve    each preset at full width (ResNet-101 at 256x256, d=300, 10
              heads, 3 layers (+ 3 fact-encoder layers), V=10000; geo E 301,
              knowledge E 301 / F 51 / P 3000, news E 101 / F 301 / P 3500
              with name ids; beam 5, 30 steps geo and 40 the others; weights
              from a seed) answers requests through Evaluator.decode_batch:
              a warm-up, 3 timed beam-5 batches of 256 raw f16 CHW images and
              one greedy batch, with every kernel's launches held to the
              counts the code predicts (the flash forward and the score
              head's first pass by route too); then the share of beam-5 tokens the
              decoder-step kernel and the stock step agree on is logged (not
              asserted), and for the fact presets the same share between the
              plain bf16 and plain f32 decodes beside it;
  5. check    the same f32 Evaluators on the card and on the CPU for two
              images: image tokens, memory and first-step scores agree,
              beam-5 tokens equal; the card's f32 beam-5 decode runs the
              decoder step's f32 tensor-core route every step, the TF32
              flash forward in every encoder layer and the score head's
              f32 tensor-core pass every step, and so does an f32 greedy
              decode;
  6. train    each preset takes train steps through
              train.step.make_train_step: batch 256, captions of 32 (geo),
              102 (knowledge) and 52 (news) tokens, cached image tokens,
              bf16 with the preset's dropout, one warm-up and 6 (geo) or 3
              timed steps, the training kernels' launch counts read around
              the timed steps and held to the counts the code predicts; the
              deterministic eval loss must fall; the geo step again in
              float32 (the flash forward's and backward's TF32 kernels, no
              CUDA-core forward; 3 timed steps, the launches held by route,
              the loss falling, beside the bf16 step's
              samples/s) and, at dropout 0, one f32 step at batch 256 held
              to the plain path on the card (loss 1e-4, gradients 1e-3 in
              relative L2 over the tree); then a 2-sample f32
              step without dropout on the card against the same step on the
              CPU;
  6b. 512x8   the geo model at --geometry 512x8 (D 512, 8 heads of 64;
              geometry_path): beam-5 serving of batches of 256 (flash on
              the wgmma forward, the bf16 decoder step on its tensor-core
              route with the cross heads padded to 64: 30 a batch, none on
              the CUDA-core kernel; launches by route held), f32 beam tokens
              equal to the CPU's (the f32 step on its f32 tensor-core route
              at pad 64, counted), an f32 beam-5 batch of 256 (30 f32
              tensor-core steps a batch, none on the CUDA-core kernel; ms a
              batch, captions/s and its breakdown), bf16 train steps at
              batch 256 with the preset's
              dropout and f32 ones (forwards on mma / tf32, the encoder's on
              wgmma, a backward launch each on the same route,
              flash_mha_bwd.routes held), the f32 step at dropout 0 held to
              the CPU's over the gradient tree, the decoder step at this
              width in both dtypes beside the CUDA-core kernel;
  6c. 512x4   the geo model at --geometry 512x4 (D 512, 4 heads of 128;
              geometry_hd128_path): bf16 train steps at batch 256 with the
              preset's dropout (every backward on the HDP-128 wgmma pair,
              none on another pair: flash_mha_bwd.kernels held) and f32
              ones (the HDP-128 TF32 pair), the f32 step at dropout 0 held to the
              CPU's over the gradient tree; no serving (its beam loop would
              run the CUDA-core decoder step);
  wide beam   the score head at k 10 and 20 and the decoder step at K 10
              and 20 (both routes, each dtype; K 20: parts of an image a
              tensor-core block) against their plain versions, then geo beams 10 and 20
              in bf16 and f32 through Evaluator.decode_batch against the
              plain path: every step through the kernels (k 20: the score
              head's wide first pass, its lists in shared memory), each
              route's count (the score head's first pass by route too) held
              to the prediction, f32 tokens equal, captions/s of 3 warm
              batches.
  7. leave    a user's captions leave the system (captions_leave): at full
              width, bf16, Evaluator.run over an in-memory 600-row split of
              each preset (batches of 256, the last padded; geo with a
              JSGeoMetric, knowledge with a predicate_to_objects table and
              its random-fact CSV, news with the mask column): the CSV's
              rows, geo's captions equal to the detok of decode_batch on the
              same padded batches, geo's launches held to the prediction,
              the run's captions/s beside decode_batch alone and its host
              parts; the token cache (encoded, loaded, stale for a changed
              encoder; cached captions equal to the image path's); the geo
              ServingEngine (max batch 64, 3 ms) warmed on every bucket under
              16 client threads and 512 requests (requests/s, p50 / p99,
              fill, buckets; each group held to decode_batch on its padded
              batch in bf16 and, on 64 more requests, in f32; one POST
              /caption); kv_dtype int8 and int8_cross against float on news
              and geo (no decoder-step launch, a score-head launch a step).
  8. train    the training run (train_run), geo at full width, bf16, over an
              in-memory 1024 / 256 / 256-row TRAIN / VAL / TEST split put in
              CaptionDataset's place: train.loop.train for 2 epochs at batch
              256 (token cache, device token cache, launches held to the
              prediction, samples/s of each epoch beside phase 6's step, the
              cache's encode seconds, a checkpoint's size and save / load
              seconds); the same run stopped by SIGTERM after batch 1 of
              epoch 1 and resumed from its STEP file, its epoch-1 checkpoint
              equal bit for bit; 3 steps at batch 32 with the ResNet inside,
              fine-tuned (frozen leaves bit-unchanged, trainable ones moved)
              and with bn_train_mode (running statistics moved, the stem's
              and layer4's last bn1 held to torch's BatchNorm2d to 1e-5, a
              margin that tells the unbiased running variance from the
              biased one at layer4); icek_torch.apps run_train,
              run_eval (captions equal to Evaluator.run's) and run_serve on
              port 0 with one POST /caption; run_train --geometry 512x8 for
              an epoch and run_eval from its checkpoint (geometry_cli).
  9. int8     the int8 encoder (int8_encoder), geo at full width: (a) the
              int8 site kernels of csrc/int8_conv.cu against their plain
              versions (float64 convolution, float32 epilogue) at the five
              site kinds at batch 256 (the 1x1 / 1 sites with each of their
              three epilogues), at the four fused conv3 + down sites and the
              stem from the float images, the int32 accumulators and the
              codes bit-equal, each on its route, timed beside the plain
              version, torch._int_mm plus an epilogue of torch ops (1x1 /
              1), cuDNN's bf16 convolution of the site and the bound (int8
              bytes at 3.35 TB/s or operations at 1979 TOPS), with the
              wrapper's host us a call; every distinct site of an encode
              timed alone (the sum of its 100 launches, the bound over them
              and over the same encode's 104 launches without the fused
              entries); the int8 max pool (the strip kernel bit-equal at
              the encode's shape, odd ones and rows staged as segments of
              columns; its first design is timed beside it by
              `python -m icek_torch.kernels._variants --parent ROOT
              int8_conv base 256 pool`); F.conv2d's and F.max_pool2d's
              answers on int8 CUDA tensors logged; (b) calibration on 2
              batches and the cosine of the int8 tokens against the folded
              bf16 encoder's (logged);
              (c) Evaluator.decode_batch with the tree in turns with the
              float encoder (captions/s, encode ms, token and caption
              agreement), each route's site launches a decode held to
              resnet_int8.site_routes (100) and one pool launch; (d) eval
              --encoder-int8 2, quantize, eval --encoder-qtree and serve
              --encoder-qtree with one POST /caption over an in-memory split;
              (e) the metrics verb over phase 7's geo and news CSVs; (f) the
              g++ builds of the native matcher and resizer against their
              Python paths.  Which of h5py, PIL and scipy the machine lacks
              is logged first.
 10. mesh     the mesh on torch.distributed (mesh_phase), a (1, 1) mesh of
              one NCCL rank on the card, geo at full width: (a) 4 train
              steps through make_train_step(mesh=...) (batch 256, cached
              tokens, bf16, dropout on) bit-equal to the same steps without
              a mesh in params, losses and Adam state, the training
              kernels' launches equal; (a') the dropout kernels keyed by
              global batch row (a data shard's half of a batch of 256 gets
              the whole batch's rows, outputs and gradients); (b) train.loop.train(mesh=...) for
              one epoch over an in-memory 512 / 256-row split, its
              checkpoint bit-equal to the run without a mesh; (c)
              Evaluator(mesh=...).run over 256 rows, the CSV equal and the
              serving kernels' launches equal; (d) a row-sharded token
              cache read by sharded_row_gather, bit-equal to a plain index;
              (e) icek_torch/utils/roofline.py turns phase 6's geo step and
              phase 4's beam-5 batch medians into MFU and HBM utilization,
              and icek_torch/tools/profile_train_step summarizes one geo
              step by op class (with the traces below): the card's time,
              above 0, with every training kernel of the port in its
              class, or the run fails.  The bf16 and HBM
              peaks every bound uses come from the roofline's table.
After the phases one more train step and one more beam-5 batch of each
preset run under torch.profiler, which logs the ten largest device operations and the
device's idle share, and the profiler gives the score head's device time
per kernel, and the norm kernels' and their library chains' at every row
count, on phase 3's inputs.  Before
them 3 greedy batches are timed warm.  Nothing is timed after a profiler
session; a fault of those traces is logged and changes nothing (phase
10 (e)'s summary is checked).
The last two lines are the card's nvidia-smi name/power limit and
{"ok": true, "device": {...}}; the kernels' JSON line comes before them.

    python3 chip_smoke.py --paired <checkout root> <label>

times the geo serving path (3 beam-5 batches after a warm-up), int8 geo
beam-5 serving (a tree calibrated on one batch: 3 batches' captions/s and 3
encodes' ms), 6 geo train
steps (and 3 in float32), 3 news (nytimes800k) train steps, 3 geo beam-20
batches of 32 images in bf16 and in f32, 3 warm greedy batches, the norm
wrappers' host ms a call and the norm kernels' device ms at every
train-step row count of the port in another checkout (the parent
of a change, say) with this script's own timing code, and prints one line
"PAIRED {...}": run it in turns (parent, change, change, parent) within one
call to compare two trees on one card.

    python -m torch.distributed.run --nproc-per-node 4 chip_smoke.py --mesh-world

runs the mesh across four cards of one host, one NCCL rank a card
(mesh_world): the geo f32 train step on (4, 1), (2, 2) and (1, 4) against
card 0 alone at the CPU tests' tolerances, the step from a row-sharded
token cache bit for bit, the row-sharded gather, the bf16 step at batch 256
a card beside one card's, and a beam-5 eval run across the world; rank 0
prints one "MESH4 {...}" line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the card's bf16 and HBM peaks come from icek_torch/utils/roofline.py's
# table (set_peaks); its f32 peak, which that table lacks, is the H100 SXM's
HBM_BYTES_PER_S = None
PEAK_FLOPS = {torch.bfloat16: None, torch.float32: 67e12}
# the H100 SXM's dense TF32 rate (NVIDIA's data sheet: half the bf16 rate);
# an f32 route that runs three TF32 products a product (3xTF32) is bounded
# by 3 x its operations at this rate (bound_tf32_ms)
TF32_FLOPS = 494.7e12
SEED = 0
BATCH, BEAM, MAX_LEN, VOCAB, ENT_ROWS, IMG = 256, 5, 30, 10000, 301, 256
CAP_LEN, TRAIN_STEPS, RATE = 32, 6, 0.2
IMG_TOKENS = 196
# the knowledge and news presets at full width (icek_torch/tools/_synthetic.py
# builds their seeded models and batches); 3 timed train steps each
FACT_PRESETS = ("k_georic", "nytimes800k")
FACT_TRAIN_STEPS = 3
NORM_KERNELS = ("dropout_add_ln", "dropout_add_ln_bwd", "hw_dropout")
# beams wider than 8 (fault F1's width) and than the score head's register
# lists (F1b's), at batch 32
WIDE_BEAMS, WIDE_BATCH = (10, 20), 32


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fn, rounds=3, iters=20) -> float:
    """The median of `rounds` cuda_ms readings: a flash kernel's and SDPA's
    times at a site, where one round of 20 calls once read 38% high on an
    H100 (the bf16 Hd-64 backward: 1.2134 ms, 0.8829-0.9011 in four other
    runs of this script)."""
    return statistics.median(cuda_ms(fn, iters) for _ in range(rounds))


def host_ms(fn, iters=20, rounds=5, warmup=3) -> float:
    """Host ms per call of `fn` while the device runs ahead: the wrapper's own
    cost (checks, bindings, launch), with no synchronise inside a round; the
    median of `rounds` rounds of `iters` calls (the host is shared, so one
    round can catch another process's burst)."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def set_peaks():
    """HBM_BYTES_PER_S and the bf16 peak from the roofline's table for this
    card."""
    global HBM_BYTES_PER_S
    from icek_torch.utils import roofline

    peaks = roofline.chip_peaks()
    require(peaks is not None, f"the roofline has no peaks for {roofline.device_name()}")
    PEAK_FLOPS[torch.bfloat16], HBM_BYTES_PER_S = peaks


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_tf32_ms(nbytes: float, flops: float) -> tuple:
    """The least time for f32 work done as three TF32 products a product:
    its bytes at the HBM rate, or 3 x its operations at the TF32 rate.  Where
    this is below bound_ms(.., float32) (the f32 CUDA cores' 67 TF/s), it is
    the card's least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------------
# phase 3: kernels at main-path shapes
# --------------------------------------------------------------------------

def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (at least 1)."""
    if isinstance(got, (tuple, list)):
        return max(_rel_err(a, b) for a, b in zip(got, want))
    return max_err(got, want) / max(1.0, float(want.float().abs().max()))


def _flash_site(dev, dtype, Tq, Tk, H=10, Hd=30):
    """q, k, v as strided views of fused projections (self-attention: one
    QKV projection; cross: a Q and a KV projection), and a d_out."""
    B = BATCH
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    if Tq == Tk:
        q, k, v = (t.view(B, Tk, H, Hd) for t in rnd(B, Tk, 3 * H * Hd).split(H * Hd, dim=-1))
    else:
        q = rnd(B, Tq, H * Hd).view(B, Tq, H, Hd)
        k, v = (t.view(B, Tk, H, Hd) for t in rnd(B, Tk, 2 * H * Hd).split(H * Hd, dim=-1))
    return q, k, v, rnd(B, Tq, H, Hd)


# the three attention sites of the geo train step: (name, Tq, Tk, causal)
FLASH_SITES = (("encoder", ENT_ROWS, ENT_ROWS, False), ("self", CAP_LEN, CAP_LEN, True),
               ("cross", CAP_LEN, 14 * 14 + ENT_ROWS, False))


def _flash_work(dtype, Tq, Tk, causal, backward, H=10, Hd=30):
    """(bytes, operations) of one attention: q, k, v, o (forward) or q, dO,
    dq, k, v, dk, dv (backward) moved once; two (forward) or five (backward)
    products over the visible (query, key) pairs, at the true head dim."""
    B = BATCH
    esz = torch.finfo(dtype).bits // 8
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    rows = 3 * Tq + 4 * Tk if backward else 2 * Tq + 2 * Tk
    return esz * B * H * Hd * rows, (5 if backward else 2) * 2 * B * H * pairs * Hd


def _flash_bounds(dtype, Tq, Tk, causal, backward, H=10, Hd=30):
    """The card's least time for one attention (_flash_work) at the dtype's
    peak: bf16 tensor cores, or the f32 CUDA cores' 67 TF/s."""
    return bound_ms(*_flash_work(dtype, Tq, Tk, causal, backward, H, Hd), dtype)


def _tf32_bound(dtype, work) -> dict:
    """An f32 record's 3xTF32 bound beside its 67 TF/s one; {} for bf16."""
    if dtype != torch.float32:
        return {}
    bms, by = bound_tf32_ms(*work)
    return dict(bound_tf32_ms=bms, bound_tf32_by=by)


FLASH_TOLS = ((torch.float32, 1e-4, 1e-4), (torch.bfloat16, 3e-2, 4e-2))


def _flash_one_site(dev, dtype, tol, btol, name, Tq, Tk, causal, serving, relative, H=10,
                    Hd=30, shift=False):
    """One attention site: at rate 0 when `serving` (the context encoder's
    serving launch, against SDPA), and at rate 0.2 under the kernel's own mask
    forward and backward, with the mask's keep rate and the forward /
    backward mask identity; the dropout forward is held `relative` to the
    largest expected value where that exceeds 1 (sites whose rows put a few
    keys' worth of v into an output: a bf16 ulp there exceeds the tolerance),
    else absolutely.  Returns (serving record or None, forward record,
    backward record; the backward's `rate0_ms` at rate 0, SDPA's own work).
    The kernels' and SDPA's times are medians of three rounds (median_ms).
    (H, Hd) give the heads; `shift` moves q, k, v one element into their
    buffers (bf16 rows that start mid-word: the TF32 kernels).  The CUDA-core
    forward is timed beside f32, and beside bf16 above Hd 32, the calls it
    once served; where the bf16 forward runs on wgmma (Hd above 32), the
    mma.sync forward it replaced too (`mma_sync_ms`,
    through its entry), and at rate 0.2 both designs' keep words are held
    equal on every cell the backward reads."""
    from icek_torch.kernels import flash_attention as fa

    B = BATCH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, d_out = _flash_site(dev, dtype, Tq, Tk, H, Hd)
    if shift:
        q, k, v = (_odd_offset(t) for t in (q, k, v))
    f32 = dtype == torch.float32
    # aligned bf16 of an even head dim: the tensor-core kernels; the rest the
    # TF32 forward and backward
    family = "mma" if not f32 and Hd % 2 == 0 and not shift else "tf32"
    require(fa.route(q, k, v) == family,
            f"flash {name} {dtype} Hd {Hd}: unexpected kernel family {fa.route(q, k, v)}")
    cores_too = f32 or Hd > 32
    # the CUDA-core forward the TF32 one replaced, reached through its entry
    cores = lambda rate=0.0: fa._forward(q, k, v, Tk, causal, rate, 77, via="cuda_cores")[0]
    wgmma = fa.uses_wgmma_forward(q, k, v)
    # the mma.sync forward the wgmma one replaced (above Hd 32), through its entry
    mma_sync = lambda rate=0.0: fa._forward(q, k, v, Tk, causal, rate, 77, via="mma_sync")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    res = None
    if serving:                 # rate 0: the serving launch
        got = fa.flash_mha(q, k, v)
        want = fa.reference_mha(q, k, v)
        torch.cuda.synchronize()
        err = max_err(got, want)
        require(err <= tol, f"flash {name} {dtype}: max abs err {err} > {tol}")
        bms, by = _flash_bounds(dtype, Tq, Tk, causal, False, H, Hd)
        res = dict(max_abs_err=err, tol=tol, ms=median_ms(lambda: fa.flash_mha(q, k, v)),
                   plain_ms=cuda_ms(lambda: fa.reference_mha(q, k, v)),
                   library_ms=median_ms(lambda: sdpa(qh, kh, vh)),
                   bound_ms=bms, bound_by=by, route=family,
                   **_tf32_bound(dtype, _flash_work(dtype, Tq, Tk, causal, False, H, Hd)))
        if cores_too:
            cerr = max_err(cores(), want)
            require(cerr <= tol, f"flash {name} CUDA-core forward: max abs err {cerr} > {tol}")
            res.update(cuda_cores_ms=cuda_ms(cores), cuda_cores_err=cerr)
        if wgmma:
            before = fa.flash_mha.wgmma
            fa.flash_mha(q, k, v)
            require(fa.flash_mha.wgmma == before + 1, f"flash {name} Hd {Hd}: not on wgmma")
            merr = max_err(mma_sync()[0], want)
            require(merr <= tol, f"flash {name} mma.sync forward: max abs err {merr} > {tol}")
            res.update(mma_sync_ms=median_ms(lambda: mma_sync()[0]), mma_sync_err=merr,
                       kernel=f"flash_fwd_wgmma_kernel<{64 if Hd <= 64 else 128}, false>")
        del got, want

    # rate 0.2 under the kernel's own mask; keep rate; one mask both ways
    keep = fa.keep_mask(B, H, Tq, Tk, rate=RATE, seed=77, device=dev)
    kept = float(keep.float().mean())
    require(abs(kept - (1 - RATE)) <= 0.005, f"flash mask keep rate {kept}")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    run = lambda: fa.flash_mha(*leaves, causal=causal, dropout_rate=RATE, seed=77)
    plain = lambda: fa.reference_mha(*leaves, causal=causal, dropout_rate=RATE, keep=keep)
    out, ref = run(), plain()
    got = torch.autograd.grad(out, leaves, d_out, retain_graph=True)
    want = torch.autograd.grad(ref, leaves, d_out, retain_graph=True)
    torch.cuda.synchronize()
    derr = max_err(out.detach(), ref.detach())
    dheld = _rel_err(out.detach(), ref.detach()) if relative else derr
    require(dheld <= tol, f"flash dropout {name} {dtype}: err {dheld} > {tol}")
    err, rel = max_err(got, want), _rel_err(got, want)
    require(rel <= btol, f"flash backward {name} {dtype}: err {rel} > {btol} "
                         "of the largest expected value")
    # <f(v), g> == <v, df/dv(g)>: forward and backward saw one mask
    lhs, rhs = float((out.detach().float() * d_out.float()).sum()), \
        float((leaves[2].detach().float() * got[2].float()).sum())
    ident = abs(lhs - rhs) / max(abs(lhs), 1.0)
    require(ident <= (1e-3 if dtype == torch.float32 else 3e-2),
            f"flash backward {name} {dtype}: mask identity off by {ident}")
    extra = {}
    if wgmma:       # one keep word per lane and cell, from both designs
        words = fa._forward(q, k, v, Tk, causal, RATE, 77)[2]
        parent = mma_sync(RATE)[2]
        cells = fa.keep_cells_written(Tq, Tk, Tk, causal).to(dev)[None, None, :, :, None]
        same = bool(torch.equal(torch.where(cells, words, 0), torch.where(cells, parent, 0)))
        require(same, f"flash {name} Hd {Hd}: the wgmma forward's keep words differ from the "
                      "mma.sync forward's")
        extra.update(keep_words_equal=same, mma_sync_ms=median_ms(lambda: mma_sync(RATE)[0]))
    with torch.no_grad():
        fms, fplain = median_ms(run), cuda_ms(plain, iters=5)
        if cores_too and Hd <= 32:      # the CUDA-core forward under the same mask
            cerr = _rel_err(cores(RATE), ref.detach()) if relative else \
                max_err(cores(RATE), ref.detach())
            require(cerr <= tol, f"flash dropout {name} CUDA-core forward: err {cerr} > {tol}")
            extra = dict(cuda_cores_ms=cuda_ms(lambda: cores(RATE)), cuda_cores_err=cerr)
    bms_ = median_ms(lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True))
    bplain = cuda_ms(lambda: torch.autograd.grad(ref, leaves, d_out, retain_graph=True),
                     iters=5)
    del ref, want, keep, got
    # yardstick: SDPA and its backward under autograd, rate 0 (it has no such
    # mask), on (B, H, T, Hd) copies
    lib_in = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    lib_out = sdpa(*lib_in, is_causal=causal)
    lib_g = d_out.transpose(1, 2).contiguous()
    with torch.no_grad():
        flib = median_ms(lambda: sdpa(qh, kh, vh, is_causal=causal))
    blib = median_ms(lambda: torch.autograd.grad(lib_out, lib_in, lib_g, retain_graph=True))
    bound, by = _flash_bounds(dtype, Tq, Tk, causal, False, H, Hd)
    fwd = dict(rate=RATE, max_abs_err=derr, keep_rate=kept, ms=fms, plain_ms=fplain,
               library_ms=flib, bound_ms=bound, bound_by=by, **extra,
               **_tf32_bound(dtype, _flash_work(dtype, Tq, Tk, causal, False, H, Hd)))
    bound, by = _flash_bounds(dtype, Tq, Tk, causal, True, H, Hd)
    bwd = dict(max_abs_err=err, rel_err=rel, tol=btol, mask_identity=ident, ms=bms_,
               plain_ms=bplain, library_ms=blib, bound_ms=bound, bound_by=by,
               **_tf32_bound(dtype, _flash_work(dtype, Tq, Tk, causal, True, H, Hd)))
    # the backward at SDPA's own work, rate 0, held to the plain version too
    out0, ref0 = fa.flash_mha(*leaves, causal=causal), fa.reference_mha(*leaves, causal=causal)
    rel0 = _rel_err(torch.autograd.grad(out0, leaves, d_out, retain_graph=True),
                    torch.autograd.grad(ref0, leaves, d_out))
    require(rel0 <= btol, f"flash backward {name} {dtype} rate 0: err {rel0} > {btol}")
    bwd.update(rate0_rel_err=rel0, rate0_ms=median_ms(
        lambda: torch.autograd.grad(out0, leaves, d_out, retain_graph=True)))
    del out, out0, ref0, lib_out, lib_in
    return res, fwd, bwd


def check_flash(dev):
    """Forward and backward at the three sites of the geo train step (encoder
    301 x 301, decoder self 32 x 32 causal, cross 32 x 497) at rate 0.2 under
    the kernel's own mask, and at the encoder site at rate 0 (the serving
    shape, and the work SDPA's backward does); returns (forward results,
    backward results) by dtype.  bf16 runs the tensor-core kernels, f32 the
    TF32 forward and backward (three TF32 products a product), timed beside
    the CUDA-core forward the TF32 one replaced (`cuda_cores_ms`) and its
    3xTF32 bound (`bound_tf32_ms`) beside the 67 TF/s one."""
    fwd, bwd = {}, {}
    for dtype, tol, btol in FLASH_TOLS:
        f, b = {}, {}
        for name, Tq, Tk, causal in FLASH_SITES:
            # the decoder's sites are held relative to their largest value
            serve, f[name], b[name] = _flash_one_site(dev, dtype, tol, btol, name, Tq, Tk,
                                                      causal, name == "encoder",
                                                      name != "encoder")
            if serve is not None:
                fwd[dtype] = dict(serve, dropout=f["encoder"])
        fwd[dtype].update({"self": f["self"], "cross": f["cross"]})
        bwd[dtype] = dict(b["encoder"], self=b["self"], cross=b["cross"])
        log(f"kernel flash_attention {dtype}: {fwd[dtype]}")
        log(f"kernel flash_attention_bwd {dtype}: {bwd[dtype]}")
    return fwd, bwd


# the backward's kernels at padded head dim 64, by route (the 512x8 path),
# and at 128 (the 512x4 path)
HD64_BWD_KERNELS = {"mma": ["flash_bwd_dq_wgmma_kernel<64, *>", "flash_bwd_dkv_wgmma_kernel<64, *>"],
                    "tf32": ["flash_bwd_dq_tf32_kernel<float, 64, 4, *>",
                             "flash_bwd_dkv_tf32_kernel<float, 64, 4, *>"]}
HD128_BWD_KERNELS = {"mma": ["flash_bwd_dq_wgmma_kernel<128, *>",
                             "flash_bwd_dkv_wgmma_kernel<128, *>"],
                     "tf32": ["flash_bwd_dq_tf32_kernel<float, 128, 4, *>",
                              "flash_bwd_dkv_tf32_kernel<float, 128, 4, *>"]}

# head dims above 32 (fault F4): (Hd, heads) with D near the geo widths; 64 x 8
# and 128 x 4 are the --geometry 512x8 and 512x4 models, at all three
# train-step sites; the others at the encoder and the causal decoder self site
WIDE_HEADS = ((64, 8), (40, 8), (75, 4), (128, 4))


def check_flash_wide(dev):
    """Flash forward and backward at head dims 40, 64, 75 and 128 (padded to
    64 or 128): f32 on the TF32 kernels, aligned bf16 on the tensor-core
    kernels (odd Hd 75 and, at Hd 64, rows that start mid-word on the TF32
    ones), each at rate 0 (the serving launch, against SDPA, beside the
    CUDA-core forward) and at rate 0.2 under the kernel's own mask, forward
    and backward, at the tolerances of FLASH_TOLS; {Hd: {dtype label: {site:
    record}}}."""
    out = {}
    for Hd, H in WIDE_HEADS:
        sites = FLASH_SITES if Hd in (64, 128) else FLASH_SITES[:2]
        cases = [(dt, tol, btol, False) for dt, tol, btol in FLASH_TOLS]
        if Hd == 64:
            cases.append((torch.bfloat16, FLASH_TOLS[1][1], FLASH_TOLS[1][2], True))
        rec = {}
        for dtype, tol, btol, shift in cases:
            label = str(dtype).replace("torch.", "") + (" misaligned" if shift else "")
            rec[label] = {}
            for name, Tq, Tk, causal in sites:
                serve, f, b = _flash_one_site(dev, dtype, tol, btol, name, Tq, Tk, causal,
                                              name == "encoder", name != "encoder", H=H,
                                              Hd=Hd, shift=shift)
                rec[label][name] = dict(serving=serve, dropout=f, backward=b)
                log(f"kernel flash_attention Hd {Hd} x {H} heads {label} {name} {Tq}x{Tk}: "
                    f"serving {serve}; rate {RATE} {f}; backward {b}")
        out[Hd] = rec
    return out


def _odd_offset(t):
    """The same values in a buffer that starts one element later."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def check_flash_bf16_tf32(dev):
    """bf16 whose head rows start mid-word (the TF32 forward as one exact
    pass) at the three geo sites, rate 0 and 0.2 under the kernel's own mask,
    within the bf16 tolerance (3e-2 of the largest value, at least 1) of the
    plain version; timed beside the aligned call's tensor-core forward and
    the CUDA-core forward on the same inputs.  {site: record}."""
    from icek_torch.kernels import flash_attention as fa

    B, H, tol = BATCH, 10, FLASH_TOLS[1][1]
    out = {}
    for name, Tq, Tk, causal in FLASH_SITES:
        q, k, v, _ = _flash_site(dev, torch.bfloat16, Tq, Tk)
        mq, mk, mv = (_odd_offset(t) for t in (q, k, v))
        require(fa.route(mq, mk, mv) == "tf32" and fa.route(q, k, v) == "mma",
                f"flash bf16 {name}: routes {fa.route(mq, mk, mv)} / {fa.route(q, k, v)}")
        rec = {}
        for rate in (0.0, RATE):
            keep = fa.keep_mask(B, H, Tq, Tk, rate=rate, seed=78, device=dev) if rate else None
            run = lambda: fa.flash_mha(mq, mk, mv, causal=causal, dropout_rate=rate, seed=78)
            want = fa.reference_mha(q, k, v, causal=causal, dropout_rate=rate, keep=keep)
            err = _rel_err(run(), want)
            require(err <= tol, f"flash bf16 TF32 {name} rate {rate}: err {err} > {tol}")
            cores = lambda: fa._forward(mq, mk, mv, Tk, causal, rate, 78, via="cuda_cores")[0]
            rec[f"rate {rate}"] = dict(
                rel_err=err, tol=tol, ms=cuda_ms(run),
                mma_ms=cuda_ms(lambda: fa.flash_mha(q, k, v, causal=causal, dropout_rate=rate,
                                                    seed=78)),
                cuda_cores_ms=cuda_ms(cores), cuda_cores_rel_err=_rel_err(cores(), want))
            del want, keep
        out[name] = rec
        log(f"kernel flash_attention bf16 misaligned (TF32 route) {name} {Tq}x{Tk}: {rec}")
    return out


def fact_flash_sites(shape):
    """The attention sites of a knowledge / news train step: (name, Tq, Tk,
    causal, a serving site too)."""
    E, F, T = shape["E"], shape["F"], shape["T"]
    return (("entity_encoder", E, E, False, True), ("fact_encoder", F, F, False, True),
            ("self", T, T, True, False), ("cross", T, IMG_TOKENS + E + F, False, False))


def check_flash_facts(dev, shape):
    """Flash forward and backward at a fact preset's four sites (T 51 is
    less than one 64-row tile; 301 and 598 end in partial tiles); returns
    {dtype: {site: {"serving", "dropout", "backward"}}}.  Every dropout
    forward is held as the geo decoder's sites are: the fact encoder's 51
    keys put outputs above 4."""
    out = {}
    for dtype, tol, btol in FLASH_TOLS:
        out[dtype] = {}
        for name, Tq, Tk, causal, serving in fact_flash_sites(shape):
            serve, f, b = _flash_one_site(dev, dtype, tol, btol, name, Tq, Tk, causal,
                                          serving, True)
            out[dtype][name] = dict(serving=serve, dropout=f, backward=b)
            log(f"kernel flash_attention {dtype} {name} {Tq}x{Tk}: serving {serve}; "
                f"rate {RATE} {f}; backward {b}")
    return out


def device_split(fn, parts, reps=10) -> dict:
    """Device ms per call of the kernels whose names hold each of `parts`, from
    torch.profiler over `reps` calls of `fn`.  Instrumentation only: a fault
    is logged and gives {}."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for part in parts:
                    if part in e.name:
                        span = (e.time_range.end - e.time_range.start) / 1e3 / reps
                        out[part] = out.get(part, 0.0) + span
        return out
    except Exception as e:                       # noqa: BLE001
        log(f"device split of {parts}: torch.profiler failed: {type(e).__name__}: {e}")
        return {}


SCORE_SHAPES = (("beam", BATCH * BEAM, BEAM), ("greedy", BATCH, 2))     # (label, rows, k)


def _score_inputs(dev, dtype, n, t=ENT_ROWS, predicates=0):
    """h (n, 300), Wv, bv and an (n, t) tail; with `predicates`, h is
    modulated row by row as the fact presets' vocab input is: times the
    projection of a sparse 0/1 predicate indicator."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    h = torch.randn((n, 300), generator=g, device=dev)
    if predicates:
        ind = (torch.rand((n, predicates), generator=g, device=dev) < 0.01).float()
        w = (torch.rand((predicates, 300), generator=g, device=dev) * 2 - 1) * 0.1
        h = h * (ind @ w + torch.randn((300,), generator=g, device=dev))
    wv = ((torch.rand((300, VOCAB), generator=g, device=dev) * 2 - 1) * 0.1).to(dtype)
    bv = torch.randn((VOCAB,), generator=g, device=dev) * 0.01
    tail = torch.randn((n, t), generator=g, device=dev)
    return h.to(dtype), wv, bv, tail


def device_splits(dev, kernels, norm, wide_k):
    """Add to phase 3's records the device time of each of the score head's
    two kernels (`parts_ms`; also at wide k 20, `wide_k`), and at every row count of `norm` (check_norm_rows's
    results) that of the LayerNorm forward and the dropout kernel
    (`device_ms`), of the LayerNorm backward's two kernels (`parts_ms`) and of
    each one's library chain (`library_device_ms`: F.dropout; F.layer_norm(x +
    F.dropout(h)) and its backward under autograd), from torch.profiler on
    phase 3's inputs.  Run after every timed phase, so that no profiler
    session comes before a timed run."""
    from icek_torch.kernels import copy_scores as cs

    for dtype in (torch.float32, torch.bfloat16):
        for shape, n, k in SCORE_SHAPES:
            h, wv, bv, tail = _score_inputs(dev, dtype, n)
            rec = kernels["fused_score_topk"][dtype]
            rec = rec if shape == "beam" else rec["greedy"]
            rec["parts_ms"] = device_split(lambda: cs.fused_score_topk(h, wv, bv, tail, k=k),
                                           ("score_partial", "score_merge"))
        h, wv, bv, tail = _score_inputs(dev, dtype, WIDE_BATCH * 20)
        wide_k[dtype][20]["parts_ms"] = device_split(
            lambda: cs.fused_score_topk(h, wv, bv, tail, k=20), ("score_partial", "score_merge"))
        log(f"device split {dtype}: score head {kernels['fused_score_topk'][dtype]['parts_ms']}"
            f", greedy {kernels['fused_score_topk'][dtype]['greedy']['parts_ms']}"
            f", wide k 20 {wide_k[dtype][20]['parts_ms']}")
        for n, (ln_f, ln_b, drop) in norm.items():
            norm_device_split(dev, dtype, n, ln_f[dtype], ln_b[dtype], drop[dtype])


def norm_device_split(dev, dtype, N, ln_f, ln_b, drop):
    """Device ms per call of the three norm kernels, their library chains
    and a same-bytes element-wise kernel at N rows, each in a profiler
    session of its own (so each loop re-reads its own inputs, from L2 where
    they fit, as the others do)."""
    from icek_torch.kernels import fused_norm as fn

    F = torch.nn.functional
    D, DF = 300, 512
    x, h, gy, scale, bias, rnd = _norm_inputs(dev, dtype, N)
    hf = rnd(N, DF).to(dtype)
    s32 = scale.float().contiguous()

    ln_f["device_ms"] = device_split(
        lambda: fn.dropout_add_ln(x, h, scale, bias, rate=RATE, seed=55), ("ln_fwd",)).get("ln_fwd")
    parts = device_split(lambda: fn.dropout_add_ln_bwd(x, h, s32, gy, RATE, 55, 1e-5),
                         ("ln_bwd_kernel", "ln_bwd_reduce"))
    ln_b["parts_ms"] = {k: parts.get(k) for k in ("ln_bwd_kernel", "ln_bwd_reduce")}
    drop["device_ms"] = device_split(lambda: fn.hw_dropout(hf, rate=RATE, seed=56),
                                     ("dropout",)).get("dropout")
    ps, pb = scale.to(dtype), bias.to(dtype)
    ln_f["library_device_ms"] = device_split(
        lambda: F.layer_norm(x + F.dropout(h, RATE), (D,), ps, pb), ("",)).get("")
    leaves = [t.detach().requires_grad_(True) for t in (x, h, ps, pb)]
    out = F.layer_norm(leaves[0] + F.dropout(leaves[1], RATE), (D,), leaves[2], leaves[3])
    ln_b["library_device_ms"] = device_split(
        lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True), ("",)).get("")
    drop["library_device_ms"] = device_split(lambda: F.dropout(hf, RATE), ("",)).get("")
    # what the card reaches on the same traffic: one element-wise PyTorch
    # kernel that reads and writes the same bytes (x + h into y; h * 1.25)
    y, out = torch.empty_like(x), torch.empty_like(hf)
    ln_f["same_bytes_ms"] = device_split(lambda: torch.add(x, h, out=y), ("",)).get("")
    drop["same_bytes_ms"] = device_split(lambda: torch.mul(hf, 1.25, out=out), ("",)).get("")
    log(f"device split {dtype} N {N}: LayerNorm forward {ln_f['device_ms']} (library chain "
        f"{ln_f['library_device_ms']}, x + h {ln_f['same_bytes_ms']}), backward "
        f"{ln_b['parts_ms']} (library chain {ln_b['library_device_ms']}), dropout "
        f"{drop['device_ms']} (F.dropout {drop['library_device_ms']}, h * 1.25 "
        f"{drop['same_bytes_ms']})")


def _score_record(dev, dtype, tol, n, k, t=ENT_ROWS, predicates=0):
    """The score head at (n rows, top k, tail t) against its plain version,
    timed beside its bound and the library chain."""
    from icek_torch.decode import topk
    from icek_torch.kernels import copy_scores as cs

    h, wv, bv, tail = _score_inputs(dev, dtype, n, t, predicates)
    # bf16: a tensor-core pass at every k; f32: up to k 16 (3xTF32), the
    # wide CUDA-core pass above
    expect = cs.route(dtype, k)
    require(cs.route(dtype, k, cs.aligned(h, wv)) == expect,
            f"score/top-k {dtype} k={k}: unexpected kernel family")
    before = dict(cs.fused_score_topk.routes)
    got = cs.fused_score_topk(h, wv, bv, tail, k=k)
    want = cs.reference_score_topk(h, wv, bv, tail, k=k)
    torch.cuda.synchronize()
    taken = [r for r, n in cs.fused_score_topk.routes.items() if n != before[r]]
    require(taken == [expect], f"score/top-k {dtype} k={k}: first pass {taken}")
    f32_ties = None
    if dtype == torch.float32 and expect == "tensor_cores":
        # three TF32 products rank as exact arithmetic does where the plain
        # f32 product cannot: its own sums lie up to 4e-6 from float64's and
        # swap pairs that close (a pair 1.3e-7 apart at k 10 and 16 here).
        # So the indices are held to the plain version in float64, and each
        # place where the f32 plain version ranks otherwise is logged with
        # its exact gap.
        scores64 = torch.cat([h.double() @ wv.double() + bv.double(), tail.double()], dim=1)
        exact = topk.top_k(scores64, k)[1]
        require(torch.equal(got[1].long(), exact),
                f"score/top-k f32 n={n} t={t} k={k}: indices differ from the float64 ranking")
        f32_ties = [(r, c, int(got[1][r, c]), int(want[1][r, c]),
                     float(scores64[r, got[1][r, c]] - scores64[r, want[1][r, c]]))
                    for r, c in (got[1] != want[1]).nonzero().tolist()]
        if f32_ties:
            log(f"score/top-k f32 n={n} t={t} k={k}: the plain f32 version ranks "
                f"{len(f32_ties)} entries otherwise (row, rank, kernel's index, plain index, "
                f"float64 gap): {f32_ties}")
        del scores64
    elif k <= cs.REGISTER_K:
        require(torch.equal(got[1], want[1]), f"score/top-k {dtype} n={n} t={t}: indices differ")
    else:
        # as tests/test_torch_gpu.py::test_score_kernel_wide_k: distinct
        # indices whose plain scores are their values, so an index that
        # differs from the plain version's ties it within tol
        scores = torch.cat([h.float() @ wv.float() + bv, tail], dim=1)
        ierr = max_err(torch.gather(scores, 1, got[1].long()), got[0])
        distinct = bool((got[1].sort(dim=1).values.diff(dim=1) != 0).all())
        differ = int((got[1] != want[1]).sum())
        require(distinct and ierr <= tol and differ <= 4 * n * k // 65536 + 2,
                f"score/top-k {dtype} n={n} k={k}: indices {differ} differ, "
                f"distinct {distinct}, score err {ierr}")
    err = max_err((got[0], got[2]), (want[0], want[2]))
    require(err <= tol, f"score/top-k {dtype} n={n} t={t}: max abs err {err} > {tol}")

    def library():
        s = torch.cat([torch.addmm(bv.to(dtype), h, wv).float(), tail], dim=1)
        return torch.topk(s, k), torch.logsumexp(s, dim=1)

    run = lambda: cs.fused_score_topk(h, wv, bv, tail, k=k)
    nbytes = (h.numel() * h.element_size() + wv.numel() * wv.element_size()
              + 4 * VOCAB + 4 * tail.numel() + n * (8 * k + 4))
    bms, by = bound_ms(nbytes, 2 * n * 300 * VOCAB, dtype)
    rec = dict(max_abs_err=err, tol=tol, route=expect, plain_f32_ties=f32_ties,
               ms=cuda_ms(run),
               plain_ms=cuda_ms(lambda: cs.reference_score_topk(h, wv, bv, tail, k=k)),
               library_ms=cuda_ms(library), bound_ms=bms, bound_by=by)
    if dtype == torch.float32 and expect == "tensor_cores":
        # the CUDA-core pass it replaced: the same values, h 4 bytes into its
        # buffer (no 16-byte copies), held to the plain version too
        hc = _odd_offset(h)
        require(cs.route(dtype, k, cs.aligned(hc, wv)) == "cuda_cores", "shifted h's route")
        cores = lambda: cs.fused_score_topk(hc, wv, bv, tail, k=k)
        cgot = cores()
        require(torch.equal(cgot[1], want[1]) and max_err((cgot[0], cgot[2]),
                                                          (want[0], want[2])) <= tol,
                f"score/top-k f32 n={n} k={k}: the CUDA-core pass disagrees")
        rec.update(cuda_cores_ms=cuda_ms(cores),
                   **_tf32_bound(dtype, (nbytes, 2 * n * 300 * VOCAB)))
    return rec


def check_scores(dev, shapes=SCORE_SHAPES):
    """The score head at the beam (1280 rows, k 5) and greedy (256, k 2)
    shapes, or at `shapes`; both dtypes run a tensor-core first pass up to
    k 16 (f32 as three TF32 products, timed beside the CUDA-core pass it
    replaced), above k 16 the wide ones (lists in shared memory; f32 on the
    CUDA cores)."""
    res = {}
    for shape, n, k in shapes:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-4)):
            timed = _score_record(dev, dtype, tol, n, k)
            log(f"kernel fused_score_topk {dtype} {shape} n={n} k={k}: {timed}")
            if shape == "greedy":
                res[dtype]["greedy"] = timed
            else:
                res[dtype] = timed
    return res


F32_KS = (1, 10, 16)      # the f32 tensor-core pass's other list lengths, at the beam rows


def check_scores_f32_ks(dev):
    """The f32 tensor-core first pass at N 1280 and k 1, 10 and 16 (beside
    the CUDA-core pass it replaced); {k: record}."""
    res = {}
    for k in F32_KS:
        res[k] = _score_record(dev, torch.float32, 1e-4, BATCH * BEAM, k)
        log(f"kernel fused_score_topk float32 n={BATCH * BEAM} k={k}: {res[k]}")
    return res


WIDE_KS = (17, 20, 32, 64)        # the wide first pass at geo beam 20's rows


def check_scores_wide(dev):
    """The score head's wide first pass (k above 16) at N = 640 rows (geo
    beam 20 at WIDE_BATCH images) at k 17, 20, 32 and 64, both dtypes;
    {dtype: {k: record}}."""
    res = {}
    for k in WIDE_KS:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-4)):
            timed = _score_record(dev, dtype, tol, WIDE_BATCH * 20, k)
            log(f"kernel fused_score_topk {dtype} wide n={WIDE_BATCH * 20} k={k}: {timed}")
            res.setdefault(dtype, {})[k] = timed
    return res


def check_scores_facts(dev, shape):
    """The score head at a fact preset's shapes: tail [E | F] (352 or 402
    columns), h modulated per row by the predicate projection."""
    res = {}
    tail = shape["E"] + shape["F"]
    for label, n, k in SCORE_SHAPES:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-4)):
            timed = _score_record(dev, dtype, tol, n, k, tail, shape["P"])
            log(f"kernel fused_score_topk {dtype} {label} n={n} k={k} tail {tail}: {timed}")
            res.setdefault(dtype, {})[label] = timed
    return res


def _decoder_step_inputs(dev, dtype, step, L=MAX_LEN, M=IMG_TOKENS + ENT_ROWS, B=BATCH,
                         K=BEAM, geometry=None):
    from icek_torch.core import config as cfgs
    from icek_torch.kernels import decoder_step as dsk
    from icek_torch.models import transformer as tfm

    m = cfgs.georic().model
    if geometry:
        m = cfgs.apply_geometry(cfgs.georic(), geometry).model
    g = torch.Generator().manual_seed(SEED + 2)
    layers = tfm.init_decoder_stack(g, m.num_layers, m.emb_dim, m.decoder_ffn_dim)
    layers = {"layers": [_tree(l, dev, dtype) for l in layers["layers"]]}
    stacked = dsk.stack_decoder_params(layers, dtype)
    nL, D = m.num_layers, m.emb_dim
    gd = torch.Generator(device=dev).manual_seed(SEED + 3)
    rnd = lambda *s: torch.randn(s, generator=gd, device=dev)
    x = rnd(B, K, D)
    caches = torch.zeros((2, nL, B, L * K, D), device=dev)
    caches[:, :, :, :step * K] = rnd(2, nL, B, step * K, D)
    ck, cv = (c.to(dtype).contiguous() for c in caches)
    xk, xv = (rnd(nL, B, M, D).to(dtype) for _ in range(2))
    anc = torch.randint(0, K, (B, K, L), generator=gd, device=dev, dtype=torch.int32)
    anc[:, :, step:] = torch.arange(K, device=dev, dtype=torch.int32)[None, :, None]
    return stacked, x, anc, ck, cv, xk, xv, m


def _decoder_step_work(anc, step, m, dtype, M):
    """(bytes, flops) one decoder step needs for these inputs: each input
    read once (the cache rows the ancestry actually selects), each output
    written once."""
    B, K, _ = anc.shape
    nL, D, H, F = m.num_layers, m.emb_dim, m.num_heads, m.decoder_ffn_dim
    Hd = D // H
    esz = torch.finfo(dtype).bits // 8
    hist = anc[:, :, :step].long() + torch.arange(step, device=anc.device) * K
    live_rows = sum(int(torch.unique(hist[b]).numel()) for b in range(B)) if step else 0
    weights = nL * (D * 3 * D + 3 * D * D + 2 * D * F)
    nbytes = (esz * (2 * nL * B * M * D + 2 * nL * live_rows * D + weights + B * K * D)
              + 4 * (nL * (3 * D + 3 * D + F + D + 6 * D)) + 4 * anc.numel()
              + 4 * B * K * D + esz * 2 * nL * B * K * D)
    flops = nL * B * (2 * K * weights // nL
                      + 4 * K * H * (step + 1) * Hd + 4 * K * H * M * Hd)
    return nbytes, flops


def _tree(tree, dev, dtype):
    if isinstance(tree, dict):
        return {k: _tree(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, dev, dtype) for v in tree]
    return tree.to(dev, dtype) if tree.is_floating_point() else tree.to(dev)


def check_decoder_step(dev, L=MAX_LEN, M=IMG_TOKENS + ENT_ROWS, B=BATCH, K=BEAM):
    """The decoder step at the middle step of the beam shape (B 256, K 5,
    L steps, memory M; or B images of K hypotheses), bf16 and f32, each on
    both routes: the tensor-core one the beam loop takes (bf16 products or
    three TF32 products; G images a block up to K 16, parts of an image
    above), fed the head-padded cross K/V the loop lays out once per batch,
    and the CUDA-core one, taken when the weights come without their packed
    copy (its time is the tensor-core route's "was"); each against its plain
    version and the bound."""
    from icek_torch.kernels import decoder_step as dsk

    res = {}
    step = L // 2
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.15)):
        stacked, x, anc, ck, cv, xk, xv, m = _decoder_step_inputs(dev, dtype, step, L, M, B, K)
        H = m.num_heads
        nbytes, flops = _decoder_step_work(anc, step, m, dtype, M)
        bms, by = bound_ms(nbytes, flops, dtype)
        want = dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
        plain_ms = cuda_ms(lambda: dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv,
                                                               step, num_heads=H), iters=5)
        require(dsk.uses_tensor_cores(stacked, ck, K, H),
                f"decoder step {dtype} B {B} K {K} L {L}: not the tensor-core route")
        nL, B, _, D = xk.shape
        heads = dsk.pad_cross_heads([{"k": xk[l].view(B, M, H, D // H),
                                      "v": xv[l].view(B, M, H, D // H)} for l in range(nL)], dtype)
        routes = {dsk.route(dtype, K, True): (stacked, (None, None), {"cross_heads": heads}),
                  "cuda_cores": (stacked._replace(mma=None), (xk, xv), {})}
        timed = {}
        for route, (st, cross, kw) in routes.items():
            counts = {r: c.launches for r, c in dsk.fused_beam_decoder_step.routes.items()}
            run = lambda: dsk.fused_beam_decoder_step(st, x, anc, ck, cv, *cross, step,
                                                      num_heads=H, **kw)
            got = run()
            torch.cuda.synchronize()
            ran = [r for r, c in dsk.fused_beam_decoder_step.routes.items()
                   if c.launches != counts[r]]
            require(ran == [route], f"decoder step {dtype} K {K}: ran {ran}, not {route}")
            err = max_err(got, want)
            require(err <= tol, f"decoder step {dtype} {route} M {M}: max abs err {err} > {tol}")
            again = run()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"decoder step {dtype} {route}: two launches differ")
            timed[route] = dict(route=route, max_abs_err=err, tol=tol, ms=cuda_ms(run),
                                plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by)
            if route != "cuda_cores":   # f32: three TF32 products a product
                timed[route].update(_tf32_bound(dtype, (nbytes, flops)))
            log(f"kernel decoder_step {dtype} {route} B {B} K {K} L {L} M {M} step {step}: "
                f"{timed[route]}")
        res[dtype] = timed[dsk.route(dtype, K, True)]
        res[dtype]["cuda_cores"] = timed["cuda_cores"]
    return res


def check_decoder_step_geometry(dev, geometry, L=MAX_LEN, M=IMG_TOKENS + ENT_ROWS, B=BATCH,
                                K=BEAM, want_routes=None):
    """The decoder step of a --geometry model at the middle step of the beam
    shape, bf16 and f32, on the route the beam loop takes there (at heads
    of 33 to 64 dims both on the tensor cores with the cross heads padded to
    64), held to `want_routes` ({dtype: route})
    when given, against its plain version and the bound, two launches
    bit-identical, and timed beside the CUDA-core kernel on the same inputs
    (`cuda_cores_ms`: the tensor-core route's "was"); {"bfloat16" /
    "float32": record}."""
    from icek_torch.kernels import decoder_step as dsk

    res = {}
    step = L // 2
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 0.15)):
        stacked, x, anc, ck, cv, xk, xv, m = _decoder_step_inputs(dev, dtype, step, L, M, B, K,
                                                                  geometry)
        H = m.num_heads
        tc = dsk.uses_tensor_cores(stacked, ck, K, H)
        route = dsk.route(dtype, K, tc)
        if want_routes:
            require(route == want_routes[dtype],
                    f"decoder step {geometry} {dtype}: route {route}, not {want_routes[dtype]}")
        nbytes, flops = _decoder_step_work(anc, step, m, dtype, M)
        bms, by = bound_ms(nbytes, flops, dtype)
        want = dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
        plain_ms = cuda_ms(lambda: dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv,
                                                               step, num_heads=H), iters=5)
        nL, B, _, D = xk.shape
        if tc:
            heads = dsk.pad_cross_heads([{"k": xk[l].view(B, M, H, D // H),
                                          "v": xv[l].view(B, M, H, D // H)}
                                         for l in range(nL)], dtype)
            run = lambda: dsk.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None, step,
                                                      num_heads=H, cross_heads=heads)
        else:
            run = lambda: dsk.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, step,
                                                      num_heads=H)
        before = dsk.fused_beam_decoder_step.routes[route].launches
        got = run()
        torch.cuda.synchronize()
        require(dsk.fused_beam_decoder_step.routes[route].launches == before + 1,
                f"decoder step {geometry} {dtype}: not on {route}")
        err = max_err(got, want)
        require(err <= tol, f"decoder step {geometry} {dtype} {route}: max abs err {err} > {tol}")
        again = run()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"decoder step {geometry} {dtype} {route}: two launches differ")
        key = str(dtype).replace("torch.", "")
        res[key] = dict(route=route, max_abs_err=err, tol=tol, ms=cuda_ms(run),
                        plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                        shape=f"{geometry} B {B} K {K} L {L} M {M} step {step}")
        if tc:      # the CUDA-core kernel on unpadded K/V, as the route ran before
            cores = stacked._replace(mma=None)
            run_cores = lambda: dsk.fused_beam_decoder_step(cores, x, anc, ck, cv, xk, xv, step,
                                                            num_heads=H)
            cerr = max_err(run_cores(), want)
            require(cerr <= tol, f"decoder step {geometry} {dtype} cuda_cores: max abs err "
                                 f"{cerr} > {tol}")
            tname = "bf16" if dtype == torch.bfloat16 else "float"
            res[key].update(cuda_cores_ms=cuda_ms(run_cores, iters=5), cuda_cores_err=cerr,
                            kernel=f"decoder_step_mma_kernel<{tname}, "
                                   f"{dsk.head_pad(m.emb_dim // H)}>")
        log(f"kernel decoder_step {geometry} {dtype}: {res[key]}")
    return res


def decoder_step_sass():
    """The instruction count of each loop of the tensor-core decoder step
    (cuobjdump; its registers and spills are in the build's ptxas lines)."""
    from icek_torch.kernels import _build, _sass

    try:
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", _build._lib_path("decoder_step")],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        for line in _sass.report(sass, "decoder_step_mma_kernel"):
            log(f"  sass {line}")
    except Exception as e:                       # noqa: BLE001
        log(f"sass of decoder_step_mma_kernel: {type(e).__name__}: {e}")


def _norm_inputs(dev, dtype, N=BATCH * ENT_ROWS):
    """x, h, gy (N, 300) in dtype, f32 scale and bias, and the seeded draw
    that made them (phase 3 draws the dropout inputs from it next)."""
    D = 300
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x, h, gy = (rnd(N, D).to(dtype) for _ in range(3))
    scale, bias = 1 + 0.1 * rnd(D), 0.1 * rnd(D)
    return x, h, gy, scale, bias, rnd


def check_norm(dev, N=BATCH * ENT_ROWS):
    """dropout_add_ln forward and backward at (N, 300) and hw_dropout at
    (N, 512), rate 0.2 under the kernels' own mask, with each mask's keep
    rate; timed with CUDA events (`ms`) and on the host (`host_ms`: the
    wrapper's own cost per call while the device runs ahead, as the train
    step calls it) beside the plain version, the library calls and the
    bound.  Returns (ln forward, ln backward, dropout) results by dtype."""
    from icek_torch.kernels import fused_norm as fn

    F = torch.nn.functional
    D, DF = 300, 512
    ln_f, ln_b, drop = {}, {}, {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        x, h, gy, scale, bias, rnd = _norm_inputs(dev, dtype, N)
        esz = x.element_size()
        keep = fn.keep_mask(N, D, rate=RATE, seed=55, device=dev)
        kept = float(keep.float().mean())
        require(abs(kept - (1 - RATE)) <= 0.005, f"norm mask keep rate {kept}")
        leaves = [t.detach().requires_grad_(True) for t in (x, h, scale, bias)]
        out = fn.dropout_add_ln(*leaves, rate=RATE, seed=55)
        got = torch.autograd.grad(out, leaves, gy, retain_graph=True)
        ref = fn.reference_dropout_add_ln(*leaves, rate=RATE, keep=keep)
        want = torch.autograd.grad(ref, leaves, gy, retain_graph=True)
        torch.cuda.synchronize()
        ferr = max_err(out, ref)
        require(ferr <= tol, f"dropout_add_ln {dtype}: max abs err {ferr} > {tol}")
        # dx, dh: a few output ulps; dscale, dbias: sums over N rows in another
        # order, held relative to their size
        berr = max_err(got[:2], want[:2])
        perr = _rel_err(got[2:], want[2:])
        require(berr <= 4 * tol and perr <= tol,
                f"dropout_add_ln backward {dtype}: dx/dh err {berr}, dscale/dbias rel {perr}")
        require(not bool(got[1][~keep].any()), "dh is non-zero where the forward dropped h")

        def library():
            return F.layer_norm(x + F.dropout(h, RATE), (D,), scale.to(dtype), bias.to(dtype))

        lib_leaves = [t.detach().requires_grad_(True)
                      for t in (x, h, scale.to(dtype), bias.to(dtype))]
        lib_out = F.layer_norm(lib_leaves[0] + F.dropout(lib_leaves[1], RATE), (D,),
                               lib_leaves[2], lib_leaves[3])
        bms, by = bound_ms(3 * N * D * esz, 8 * N * D, dtype)
        ln_f[dtype] = dict(
            max_abs_err=ferr, tol=tol, keep_rate=kept,
            ms=cuda_ms(lambda: fn.dropout_add_ln(x, h, scale, bias, rate=RATE, seed=55)),
            plain_ms=cuda_ms(lambda: fn.reference_dropout_add_ln(
                x, h, scale, bias, rate=RATE, keep=keep)),
            library_ms=cuda_ms(library), bound_ms=bms, bound_by=by,
            # as the train step calls it: leaves that require grad
            host_ms=host_ms(lambda: fn.dropout_add_ln(*leaves, rate=RATE, seed=55)),
            library_host_ms=host_ms(lambda: F.layer_norm(
                lib_leaves[0] + F.dropout(lib_leaves[1], RATE), (D,), lib_leaves[2],
                lib_leaves[3])))
        bms, by = bound_ms(5 * N * D * esz, 20 * N * D, dtype)
        # `ms` and `library_ms` both time a backward under autograd, which
        # passes through the engine's device thread (into a Python Function
        # for the kernel) and so carries host time; `wrapper_ms` times the
        # kernels' own wrapper (device_splits adds each side's device time)
        s32 = scale.float().contiguous()
        ln_b[dtype] = dict(
            max_abs_err=berr, param_rel_err=perr, tol=4 * tol,
            ms=cuda_ms(lambda: torch.autograd.grad(out, leaves, gy, retain_graph=True)),
            wrapper_ms=cuda_ms(lambda: fn.dropout_add_ln_bwd(x, h, s32, gy, RATE, 55, 1e-5)),
            plain_ms=cuda_ms(lambda: torch.autograd.grad(ref, leaves, gy, retain_graph=True)),
            library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, gy,
                                                           retain_graph=True)),
            bound_ms=bms, bound_by=by,
            host_ms=host_ms(lambda: fn.dropout_add_ln_bwd(x, h, s32, gy, RATE, 55, 1e-5)))
        log(f"kernel dropout_add_ln {dtype} N {N}: {ln_f[dtype]}")
        log(f"kernel dropout_add_ln_bwd {dtype} N {N}: {ln_b[dtype]}")
        del out, ref, got, want, lib_out, keep

        hf = rnd(N, DF).to(dtype).requires_grad_(True)
        gf = rnd(N, DF).to(dtype)
        keep = fn.keep_mask(N, DF, rate=RATE, seed=56, device=dev)
        y = fn.hw_dropout(hf, rate=RATE, seed=56)
        (dh,) = torch.autograd.grad(y, hf, gf)
        torch.cuda.synchronize()
        derr = max(max_err(y, fn.reference_hw_dropout(hf.detach(), rate=RATE, keep=keep)),
                   max_err(dh, fn.reference_hw_dropout(gf, rate=RATE, keep=keep)))
        dtol = 1e-5 if dtype == torch.float32 else tol     # x * 1.25 against x / 0.8
        require(derr <= dtol, f"hw_dropout {dtype}: max abs err {derr} > {dtol}")
        kept = float(keep.float().mean())
        require(abs(kept - (1 - RATE)) <= 0.005, f"hw_dropout mask keep rate {kept}")
        hd = hf.detach()
        bms, by = bound_ms(2 * N * DF * esz, N * DF, dtype)
        drop[dtype] = dict(
            max_abs_err=derr, tol=dtol, keep_rate=kept,
            ms=cuda_ms(lambda: fn.hw_dropout(hd, rate=RATE, seed=56)),
            plain_ms=cuda_ms(lambda: fn.reference_hw_dropout(hd, rate=RATE, keep=keep)),
            library_ms=cuda_ms(lambda: F.dropout(hd, RATE)), bound_ms=bms, bound_by=by,
            host_ms=host_ms(lambda: fn.hw_dropout(hf, rate=RATE, seed=56)),
            library_host_ms=host_ms(lambda: F.dropout(hf, RATE)))
        log(f"kernel hw_dropout {dtype} N {N}: {drop[dtype]}")
    return ln_f, ln_b, drop


def _compact(bf, f32):
    """A kernel record at one shape: the bf16 numbers, the f32 time and error
    (and device, host and library times where the record has them)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    extra = ("device_ms", "parts_ms", "library_device_ms", "same_bytes_ms", "host_ms",
             "library_host_ms", "wrapper_ms", "keep_rate")
    out = dict({k: bf[k] for k in keys}, f32_ms=f32["ms"], f32_max_abs_err=f32["max_abs_err"])
    out.update({k: bf[k] for k in extra if k in bf})
    out.update({"f32_" + k: f32[k] for k in ("device_ms", "parts_ms", "library_device_ms")
                if k in f32})
    return out


def check_norm_rows(dev):
    """check_norm at every row count of norm_rows(): {rows: (ln forward, ln
    backward, dropout) results by dtype}."""
    out = {}
    for n, sites in norm_rows().items():
        log(f"norm kernels at {n} rows ({', '.join(sites)})")
        out[n] = check_norm(dev, n)
    return out


def check_kernels_facts(dev, shape):
    """Phase 3 at a fact preset's shapes: flash at its four attention sites,
    the score head with its [E | F] tail, the decoder step at L 40 and
    memory M = 196 + E + F (the tensor-core route must still hold it); the
    LayerNorm and dropout kernels are checked at every row count of every
    preset by check_norm_rows.  Returns {kernel: {shape label: compact
    record}}."""
    bf, f32 = torch.bfloat16, torch.float32
    flash = check_flash_facts(dev, shape)
    out = {"flash_attention": {}, "flash_attention_bwd": {}}
    for site, rec in flash[bf].items():
        other = flash[f32][site]
        if rec["serving"] is not None:
            out["flash_attention"][site] = _compact(rec["serving"], other["serving"])
        out["flash_attention"][f"{site} rate {RATE}"] = _compact(rec["dropout"],
                                                                 other["dropout"])
        out["flash_attention_bwd"][f"{site} rate {RATE}"] = _compact(rec["backward"],
                                                                     other["backward"])
    scores = check_scores_facts(dev, shape)
    out["fused_score_topk"] = {k: _compact(scores[bf][k], scores[f32][k])
                               for k in ("beam", "greedy")}
    M = IMG_TOKENS + shape["E"] + shape["F"]
    step = check_decoder_step(dev, shape["L"], M)
    label = f"L {shape['L']} M {M} step {shape['L'] // 2}"
    out["decoder_step"] = {label: _compact(step[bf], step[f32]),
                           label + " cuda cores": _compact(step[bf]["cuda_cores"],
                                                           step[f32]["cuda_cores"])}
    return out


# --------------------------------------------------------------------------
# phase 4: the full-width main path, one preset at a time
# --------------------------------------------------------------------------

def preset_shape(preset):
    """E, F, P, L (decode steps), T (training caption) and D of a preset."""
    from icek_torch.tools import _synthetic

    return _synthetic.shape(preset)


def full_width_model(preset="georic", enc=None, geometry=None):
    """A preset at full width with seeded random weights (V 10000, beam 5,
    batch 256), as icek_torch/tools/_synthetic.py builds it; `enc` shares
    one encoder between presets; `geometry` as --geometry."""
    from icek_torch.tools import _synthetic

    model = _synthetic.model(preset, SEED, BEAM, BATCH, enc, geometry=geometry)
    require(len(model[1]) == VOCAB, "wordmap size")
    return model


def make_batch(rng, n, preset="georic"):
    """n decode rows of IMG x IMG stored images with entity (and fact) rows."""
    from icek_torch.tools import _synthetic

    return _synthetic.decode_batch(rng, n, preset, IMG)


def entity_names(n):
    """(n, 52) char-coded name rows in the stored layout [_, len, codes]."""
    rows = []
    for e in range(n):
        name = f"place_{e}"
        rows.append([0, len(name)] + [ord(c) for c in name] + [124] * (50 - len(name)))
    return np.array(rows, np.int64)


# the decoder step's launch counters by route (kernels/decoder_step.py::route):
# bf16 at K <= 16 (the main path), f32 at K <= 16, beams wider than 16 in
# bf16 and f32, and the CUDA-core kernel
DECODER_ROUTES = {"decoder_step": "tensor_cores", "decoder_step_f32": "tensor_cores_f32",
                  "decoder_step_wide": "wide_tensor_cores",
                  "decoder_step_wide_f32": "wide_tensor_cores_f32",
                  "decoder_step_cuda_cores": "cuda_cores"}


def decoder_launches(**counts):
    """Every decoder-step route's count: `counts`, the others 0."""
    return {name: counts.get(name, 0) for name in DECODER_ROUTES}


def decoder_counter(dtype, K):
    """The counter name of the route the beam loop takes at (dtype, K)."""
    from icek_torch.kernels import decoder_step

    route = decoder_step.route(dtype, K, True)
    return next(name for name, r in DECODER_ROUTES.items() if r == route)


def counters():
    """The launch counts of the serving path's kernels (the decoder step by
    route: bf16 at the beam shape takes the tensor-core one)."""
    from icek_torch.kernels import copy_scores, decoder_step, flash_attention

    routes = decoder_step.fused_beam_decoder_step.routes
    return {"flash_attention": flash_attention.flash_mha,
            "fused_score_topk": copy_scores.fused_score_topk,
            **{name: routes[r] for name, r in DECODER_ROUTES.items()}}


def serving_prediction(cfg, beam_batches, greedy_batches, decoder="decoder_step"):
    """The serving launches the code predicts, every batch running all L
    steps (random weights never end all of a batch's hypotheses): the context
    encoders' layers once a batch (entity, and fact with facts), the score head
    once a step of every batch, the decoder step's bf16 tensor-core route once
    a step of a beam batch (greedy runs the plain decoder), its other routes
    never; `decoder` names the route a beam step takes (the CUDA-core one
    above 10 heads or a head dim of 32)."""
    m, L = cfg.model, cfg.decode.max_caption_len
    batches = beam_batches + greedy_batches
    return {"flash_attention": m.num_layers * (2 if m.has_facts else 1) * batches,
            "fused_score_topk": L * batches, **decoder_launches(**{decoder: L * beam_batches})}


def route_counts():
    """The forward flash launches and the score head's first passes by
    route (flash_mha.routes, fused_score_topk.routes), as flash_<route> and
    score_<route>, and flash_wgmma: the mma route's launches of the wgmma
    forward (heads wider than 32)."""
    from icek_torch.kernels import copy_scores, flash_attention

    return {**{f"flash_{r}": n for r, n in flash_attention.flash_mha.routes.items()},
            "flash_wgmma": flash_attention.flash_mha.wgmma,
            **{f"score_{r}": n for r, n in copy_scores.fused_score_topk.routes.items()}}


def zero_route_counts():
    from icek_torch.kernels import copy_scores, flash_attention

    for counts in (flash_attention.flash_mha.routes, copy_scores.fused_score_topk.routes,
                   flash_attention.flash_mha_bwd.routes, flash_attention.flash_mha_bwd.kernels):
        counts.update(dict.fromkeys(counts, 0))
    flash_attention.flash_mha.wgmma = 0


def wide_heads(m) -> bool:
    """Whether a model's heads are wider than 32 dims: its bf16 flash
    forwards run on wgmma, and its bf16 decoder step pads the cross heads
    to 64."""
    return m.emb_dim // m.num_heads > 32


def bwd_route_counts():
    """The flash backward's launches by route (flash_mha_bwd.routes): mma
    (bf16; at head dims above 32 the wgmma pair) and tf32."""
    from icek_torch.kernels import flash_attention

    return dict(flash_attention.flash_mha_bwd.routes)


def bwd_pair_counts():
    """The flash backward's launches by kernel pair (flash_mha_bwd.kernels,
    flash_attention.BWD_KERNELS)."""
    from icek_torch.kernels import flash_attention

    return dict(flash_attention.flash_mha_bwd.kernels)


def bwd_pair_prediction(m, dtype, n) -> dict:
    """Every backward pair's count when a model with config `m` takes `n`
    backward launches in `dtype`: all on the pair its head dim takes (bf16:
    the mma.sync pair at 32 dims or fewer, the wgmma pair above; f32: the
    TF32 pair of the padded head dim), none on another."""
    from icek_torch.kernels import flash_attention as fa

    hdp = fa.head_pad(m.emb_dim // m.num_heads)
    pair = (f"tf32_{hdp}" if dtype == torch.float32
            else "mma_sync32" if hdp == 32 else f"wgmma{hdp}")
    return {name: n if name == pair else 0 for name in fa.BWD_KERNELS}


def route_prediction(**counts):
    """Every route's count: `counts`, the others 0."""
    return {name: counts.get(name, 0) for name in route_counts()}


def _read_serving_counts():
    return {name: fn.launches for name, fn in counters().items()}


def _zero_serving_counts():
    for fn in counters().values():
        fn.launches = 0


def norm_sites(preset="georic"):
    """The train step's residual-dropout LayerNorm sites, by the stack they
    sit in: {stack: (rows, layers, LayerNorms a layer)} at batch BATCH and
    the preset's shapes.  The entity encoder runs over E rows an image, the
    fact encoder (facts only) over F, the decoder over the T caption tokens;
    an encoder layer has two residual LayerNorms and a decoder layer three,
    and each layer one FFN dropout."""
    from icek_torch.core import config as cfgs

    s, layers = preset_shape(preset), cfgs.get_config(preset).model.num_layers
    sites = {"entity_encoder": (BATCH * s["E"], layers, 2)}
    if s["F"]:
        sites["fact_encoder"] = (BATCH * s["F"], layers, 2)
    sites["decoder"] = (BATCH * s["T"], layers, 3)
    return sites


def norm_rows():
    """Every row count the three presets' train steps give the LayerNorm and
    dropout kernels, with the (preset, stack) sites at each."""
    rows = {}
    for preset in ("georic", *FACT_PRESETS):
        for stack, (n, _, _) in norm_sites(preset).items():
            rows.setdefault(n, []).append(f"{preset} {stack}")
    return dict(sorted(rows.items()))


def train_counters(preset="georic"):
    """Likewise for the train step, with the launches one step makes (from
    norm_sites): one attention per encoder layer and two per decoder layer,
    the residual LayerNorms forward and backward, and one FFN dropout per
    layer each way through one entry point."""
    from icek_torch.kernels import flash_attention, fused_norm

    sites = norm_sites(preset)
    enc = sum(layers for stack, (_, layers, _) in sites.items() if stack != "decoder")
    dec = sites["decoder"][1]
    ln = sum(layers * per for _, layers, per in sites.values())
    return {"flash_attention": (flash_attention.flash_mha, enc + 2 * dec),
            "flash_attention_bwd": (flash_attention.flash_mha_bwd, enc + 2 * dec),
            "dropout_add_ln": (fused_norm.dropout_add_ln, ln),
            "dropout_add_ln_bwd": (fused_norm.dropout_add_ln_bwd, ln),
            "hw_dropout": (fused_norm.hw_dropout, 2 * (enc + dec))}


def serve(dev, model, preset="georic", decoder="decoder_step", label=None):
    """A warm-up, 3 timed beam-5 batches of 256 raw f16 images and one greedy
    batch through Evaluator.decode_batch, with every kernel's launches held
    to the code's prediction (`decoder`: the decoder step's route counter a
    beam step takes).  `label` names the model in the log."""
    from icek_torch import eval_driver
    from icek_torch.decode import detok

    cfg, wm, params, enc = model
    s = preset_shape(preset)
    L, S = s["L"], VOCAB + s["E"] + s["F"]
    ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev)
    require(ev.compute_dtype == torch.bfloat16 and ev.batch_size == BATCH,
            "the main path serves bf16 at batch 256")
    rng = np.random.default_rng(SEED)
    batches = [make_batch(rng, BATCH, preset) for _ in range(4)]
    t0 = time.perf_counter()
    ev.decode_batch(batches[0])                                  # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _zero_serving_counts()
    zero_route_counts()
    times, outs = [], []
    for b in batches[1:]:
        t0 = time.perf_counter()
        outs.append(ev.decode_batch(b))
        times.append(time.perf_counter() - t0)
    greedy = eval_driver.Evaluator(cfg, wm, ev.params, ev.encoder_params, device=dev,
                                   beam_size=1)
    t0 = time.perf_counter()
    g_out = greedy.decode_batch(batches[0])
    greedy_s = time.perf_counter() - t0
    launches = _read_serving_counts()
    routes = route_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = serving_prediction(cfg, len(times), 1, decoder)
    # every serving forward is a context encoder's
    want_routes = route_prediction(
        flash_mma=want["flash_attention"], score_tensor_cores=want["fused_score_topk"],
        flash_wgmma=want["flash_attention"] if wide_heads(cfg.model) else 0)
    preset = label or preset
    log(f"{preset} serving launches (3 beam-5 batches + 1 greedy batch): {launches}, by "
        f"route {routes}; predicted {want}, {want_routes}")
    require(launches == want, f"{preset}: serving launches {launches} != predicted {want}")
    require(routes == want_routes, f"{preset}: serving routes {routes} != {want_routes}")
    for out in outs + [g_out]:
        require(out.shape == (BATCH, L), f"output shape {out.shape}")
        require(out.min() >= 0 and out.max() < S, "token ids out of range")
    pointer_share = float(np.mean([(o >= VOCAB).mean() for o in outs]))
    fact_share = float(np.mean([(o >= VOCAB + s["E"]).mean() for o in outs]))
    names = entity_names(s["E"])
    for b in range(3):
        text, k = detok.caption_text(outs[0][b], wm, names)
        log(f"{preset} caption {b}: {text[:120]!r} (kinds {k[:10]})")
    caps = [BATCH / t for t in times]
    summary = dict(
        warmup_s=warm_s, batch_ms=[t * 1e3 for t in times],
        captions_per_s_median=statistics.median(caps),
        captions_per_s_all=BATCH * len(times) / sum(times),
        greedy_batch_ms=greedy_s * 1e3, peak_mem_gb=peak_gb, routes=routes,
        pointer_token_share=pointer_share, fact_token_share=fact_share)
    log(f"{preset} serving (batch {BATCH}, beam {BEAM}, L {L}, bf16): {summary}")
    require(cfg.model.variant == "geo" or pointer_share > 0,
            f"{preset}: no entity id emitted, so the seen / predicate state was never driven")
    log(f"{preset} serving breakdown: {breakdown(ev, batches[1])}")
    log(f"{preset} serving, beam-5 tokens with the decoder-step kernel against the stock "
        f"step (bf16, not asserted: near-tie picks follow the summation order): "
        f"{megakernel_agreement(ev, batches[1])}")
    if cfg.model.variant != "geo":
        log(f"{preset} serving, beam-5 token agreement between precisions and routes "
            f"(not asserted): {precision_agreement(ev, batches[1])}")
    return launches, summary, batches[1]


def _context(ev, batch):
    """(decode context, raw image tensor) of one batch on the Evaluator's
    device, as decode_batch builds it."""
    from icek_torch.decode import greedy

    raw = torch.as_tensor(batch["raw_images"], device=ev.device)
    ents = torch.as_tensor(batch["entity_features"], device=ev.device)
    facts = batch.get("fact_features")
    facts = None if facts is None else torch.as_tensor(facts, device=ev.device)
    ctx = greedy.prepare_decode_context(ev.params, ev.cfg.model, ev._encode_tokens(raw, "raw"),
                                        ents, facts, compute_dtype=ev.compute_dtype)
    return ctx, ents.shape[1]


def megakernel_agreement(ev, batch):
    """Share of equal beam-5 tokens (and of equal captions) between
    use_megakernel on and off for one batch; after the counted run."""
    from icek_torch.decode import beam

    cfg, wm = ev.cfg, ev.wordmap
    with torch.inference_mode():
        ctx, E = _context(ev, batch)
        outs = [beam.beam_decode(ev.params, cfg.model, len(wm), E, wm.start_id, wm.end_id,
                                 wm.pad_id, ctx, cfg.decode.max_caption_len, beam_size=BEAM,
                                 compute_dtype=ev.compute_dtype, use_megakernel=on)[0]
                for on in (True, False)]
    same = outs[0] == outs[1]
    return dict(tokens=float(same.float().mean()), captions=float(same.all(dim=1).float().mean()))


def precision_agreement(ev, batch):
    """Witness for the kernel-vs-stock agreement above: beam-5 tokens of one
    batch decoded with the plain step and scores in bf16 and in f32 (from the
    same image tokens), and with the kernels in bf16, each pair's share of
    equal tokens and captions.  If the bf16 kernel's disagreement with the
    stock bf16 step comes from near-tie picks, the plain bf16 run disagrees
    with the plain f32 run about as often."""
    from icek_torch.decode import beam, greedy

    cfg, wm = ev.cfg, ev.wordmap

    def run(dtype, kernels):
        ctx = greedy.prepare_decode_context(ev.params, cfg.model, tokens.to(dtype), ents, facts,
                                            compute_dtype=dtype)
        return beam.beam_decode(ev.params, cfg.model, len(wm), ents.shape[1], wm.start_id,
                                wm.end_id, wm.pad_id, ctx, cfg.decode.max_caption_len,
                                beam_size=BEAM, compute_dtype=dtype, use_megakernel=kernels,
                                use_fused_scores=kernels)[0]

    with torch.inference_mode():
        raw = torch.as_tensor(batch["raw_images"], device=ev.device)
        ents = torch.as_tensor(batch["entity_features"], device=ev.device)
        facts = torch.as_tensor(batch["fact_features"], device=ev.device)
        tokens = ev._encode_tokens(raw, "raw")
        outs = {"kernels_bf16": run(torch.bfloat16, True),
                "plain_bf16": run(torch.bfloat16, False),
                "plain_f32": run(torch.float32, False)}
    res = {}
    for a, b in (("kernels_bf16", "plain_bf16"), ("plain_bf16", "plain_f32"),
                 ("kernels_bf16", "plain_f32")):
        same = outs[a] == outs[b]
        res[f"{a} vs {b}"] = dict(tokens=float(same.float().mean()),
                                  captions=float(same.all(dim=1).float().mean()))
    return res


def time_greedy_warm(dev, model, reps=3) -> list:
    """Host ms of `reps` greedy (beam 1) batches after one warm-up batch;
    not part of the counted main path."""
    from icek_torch import eval_driver

    cfg, wm, params, enc = model
    greedy = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, beam_size=1)
    rng = np.random.default_rng(SEED + 7)
    batches = [make_batch(rng, BATCH) for _ in range(reps + 1)]
    greedy.decode_batch(batches[0])
    out = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        greedy.decode_batch(b)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def breakdown(ev, batch):
    """Per-stage device time of one beam-5 batch (synchronized stages)."""
    from icek_torch.decode import beam, greedy

    cfg, wm = ev.cfg, ev.wordmap
    stages = {}
    with torch.inference_mode():
        t = time.perf_counter()
        raw = torch.as_tensor(batch["raw_images"], device=ev.device)
        ents = torch.as_tensor(batch["entity_features"], device=ev.device)
        facts = batch.get("fact_features")
        facts = None if facts is None else torch.as_tensor(facts, device=ev.device)
        torch.cuda.synchronize()
        stages["upload_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        tokens = ev._encode_tokens(raw, "raw")
        torch.cuda.synchronize()
        stages["encode_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        ctx = greedy.prepare_decode_context(ev.params, cfg.model, tokens, ents, facts,
                                            compute_dtype=ev.compute_dtype)
        torch.cuda.synchronize()
        stages["context_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        beam.beam_decode(ev.params, cfg.model, len(wm), ents.shape[1], wm.start_id,
                         wm.end_id, wm.pad_id, ctx, cfg.decode.max_caption_len,
                         beam_size=BEAM, compute_dtype=ev.compute_dtype)
        torch.cuda.synchronize()
        stages["decode_ms"] = (time.perf_counter() - t) * 1e3
    return stages


def time_decode(ev, batch, reps=3) -> list:
    """Host ms of `reps` Evaluator.decode_batch calls on `batch` (warm)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ev.decode_batch(batch)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def wide_beam(dev, model):
    """Beams wider than 8 (fault F1) and than 16 (F1b): geo beam 10 and beam 20
    through Evaluator.decode_batch, bf16 and f32, kernels on (the defaults)
    against the plain path (both switches off).  The score head runs at k 10
    on its register lists (tensor cores; f32 as three TF32 products) and at
    k 20 on its wide first pass (lists in shared memory), bf16 on the tensor
    cores and f32 on the CUDA cores; the context encoder's flash forward on
    the bf16 tensor-core kernel or the TF32 one; the
    decoder step on its tensor-core routes in both dtypes (K 10: G images a
    block; K 20: parts of an image a block), never on the CUDA-core kernel.  Each
    route's count is held to that; f32 tokens must equal the plain path's, bf16
    agreement is logged, and each width's captions/s (3 warm batches).  First
    the two kernels alone at each width's shapes against their plain
    versions."""
    from icek_torch import eval_driver
    from icek_torch.kernels import copy_scores as cs

    cfg, wm, params, enc = model
    batch = make_batch(np.random.default_rng(SEED + 11), WIDE_BATCH)
    plain_cfg = cfg.replace(decode=dataclasses.replace(
        cfg.decode, use_megakernel=False, use_fused_scores=False))
    L = cfg.decode.max_caption_len
    res = {}
    for K in WIDE_BEAMS:
        kernels = dict(fused_score_topk=check_scores(dev, ((f"wide k {K}", WIDE_BATCH * K, K),)),
                       decoder_step=check_decoder_step(dev, B=WIDE_BATCH, K=K))
        out = {}
        for dtype in (torch.bfloat16, torch.float32):
            kw = dict(device=dev, beam_size=K, batch_size=WIDE_BATCH, compute_dtype=dtype)
            ev = eval_driver.Evaluator(cfg, wm, params, enc, **kw)
            _zero_serving_counts()
            zero_route_counts()
            got = ev.decode_batch(batch)
            routes = _read_serving_counts()
            routes.update({r: n for r, n in route_counts().items() if n})
            batch_ms = time_decode(ev, batch)
            want = eval_driver.Evaluator(plain_cfg, wm, params, enc, **kw).decode_batch(batch)
            expect = dict(flash_attention=cfg.model.num_layers, fused_score_topk=L,
                          **decoder_launches(**{decoder_counter(dtype, K): L}))
            expect[f"score_{cs.route(dtype, K)}"] = L
            expect["flash_mma" if dtype == torch.bfloat16 else "flash_tf32"] = \
                cfg.model.num_layers
            log(f"wide beam: geo beam {K} {dtype}, {WIDE_BATCH} images, routes {routes} "
                f"(expected {expect})")
            require(routes == expect, f"wide beam {K} {dtype}: routes {routes} != {expect}")
            same = float((got == want).mean())
            if dtype == torch.float32:
                require(np.array_equal(got, want),
                        f"wide beam: f32 beam-{K} tokens differ from the plain path")
            out[str(dtype)] = dict(routes=routes, token_agreement=same, batch_ms=batch_ms,
                                   captions_per_s=WIDE_BATCH / statistics.median(batch_ms) * 1e3)
            log(f"wide beam: geo beam {K} {dtype}: token agreement with the plain path {same}, "
                f"{out[str(dtype)]['captions_per_s']:.1f} captions/s")
        out["kernels"] = {name: {str(dt): {k: rec[dt][k] for k in
                                           ("max_abs_err", "ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by", "route", "cuda_cores_ms",
                                            "bound_tf32_ms") if k in rec[dt]}
                                 for dt in rec} for name, rec in kernels.items()}
        for dt, rec in kernels["decoder_step"].items():       # the CUDA-core kernel's "was"
            out["kernels"]["decoder_step"][str(dt)]["cuda_cores_ms"] = rec["cuda_cores"]["ms"]
        res[f"beam {K}"] = out
    return res


# --------------------------------------------------------------------------
# phase 7: a user's captions leave the system, offline and online
# --------------------------------------------------------------------------

EVAL_ROWS = 600                 # two full batches of 256 and one of 88, padded to 256
ENGINE_CLIENTS, ENGINE_REQUESTS, ENGINE_MAX_BATCH, ENGINE_WAIT_MS = 16, 512, 64, 3.0
ENGINE_F32_REQUESTS = 64


def memory_split(rng, n, preset="georic"):
    """A TEST split of `n` rows held in memory (the card's machine reads no
    HDF5): the port's CaptionDataset with its arrays and image rows set
    directly, so its own batch / raw_image_batch / cache_image_tokens serve
    it.  Entity names as entity_names(); fact names are years and objects
    ("1800".., "obj_<k>"), the last row the padding fact."""
    from icek_torch.data import dataset as tdata

    s = preset_shape(preset)
    batch = make_batch(rng, n, preset)
    a = tdata.CaptionArrays.__new__(tdata.CaptionArrays)
    a.caption_ids = np.zeros((n, 2), np.int32)
    a.lengths = np.ones((n,), np.int32)
    a.caption_mask = np.zeros((n, 2), np.int32)
    a.entity_features = batch["entity_features"]
    a.entity_names = np.broadcast_to(entity_names(s["E"]), (n, s["E"], 52))
    a.fact_features = batch.get("fact_features")
    a.fact_names = None
    if s["F"]:
        objs = [str(1800 + f) if f % 3 == 0 else f"obj_{f}" for f in range(s["F"] - 1)]
        rows = [[0, len(o)] + [ord(c) for c in o] + [124] * (50 - len(o))
                for o in objs + ["<pad>"]]
        a.fact_names = np.broadcast_to(np.array(rows, np.int32), (n, s["F"], 52))
    a.size = n

    class MemorySplit(tdata.CaptionDataset):
        def __init__(self):
            self.split, self.arrays, self._images = "TEST", a, batch["raw_images"]
            self.image_tokens = None

    return MemorySplit


def _padded_batches(split, batch_size):
    """The batches Evaluator.run decodes: row ids padded with the last row."""
    from icek_torch import eval_driver

    n = len(split)
    return [eval_driver._pad_batch(np.arange(s, min(s + batch_size, n)), batch_size)
            for s in range(0, n, batch_size)]


def _csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _time_calls(obj, name, iterator=False):
    """Shadow obj.<name> with a wrapper that appends each call's host seconds
    to the returned list (with `iterator`, the seconds each next() of the
    iterators it returns waits); the returned function puts it back."""
    inner, times = getattr(obj, name), []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        times.append(time.perf_counter() - t0)
        return out

    def timed_iter(*a, **k):
        it = iter(inner(*a, **k))
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                times.append(time.perf_counter() - t0)
            yield item

    setattr(obj, name, timed_iter if iterator else timed)

    def undo():
        if getattr(inner, "__self__", None) is obj:
            delattr(obj, name)                  # a bound method: the class's again
        else:
            setattr(obj, name, inner)

    return times, undo


def eval_run(dev, models, workdir):
    """Evaluator.run over a 600-row split of each preset at full width (bf16,
    batch 256, beam 5): geo with a JSGeoMetric on synthetic bins, knowledge
    with a predicate_to_objects table (the random-fact CSV), news (the mask
    column).  The geo run's launches are held to the prediction (3 batches,
    every step), its CSV to 600 rows equal to the detok of decode_batch on
    the same padded batches; its captions/s (host clock: reads, upload,
    decode, detok, metric and CSV) beside decode_batch alone on those
    batches.  Returns (geo launches, summary, geo split class, geo
    captions)."""
    import random

    from icek_torch import eval_driver
    from icek_torch.decode import detok
    from icek_torch.metrics.js_geo import JSGeoMetric

    out, geo = {}, None
    for preset, model in models.items():
        cfg, wm, params, enc = model
        split_cls = memory_split(np.random.default_rng(SEED + 21), EVAL_ROWS, preset)
        data = split_cls()
        ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev)
        ev.decode_batch(data.batch(np.arange(BATCH), raw_images=True))          # warm-up
        kw, lines = {}, []
        if preset == "georic":
            kw["js_metric"] = JSGeoMetric(
                dict(wm.word_to_id), [(0.0, 0.25), (0.25, 0.5), (0.5, 1.01)],
                [(-180.0, -90.0), (-90.0, 0.0), (0.0, 90.0), (90.0, 180.0)], 500,
                print_metrics=False, rng=random.Random(SEED))
        if preset == "k_georic":                   # the knowledge report's baseline
            objs = [detok.name_from_row(r) for r in data.arrays.fact_names[0][:-1]]
            kw["predicate_to_objects"] = {f"p{k}": objs[k::7] for k in range(7)}
            kw["rng"] = random.Random(SEED)
        path = os.path.join(workdir, f"{preset}_generated_captions.csv")
        from icek_torch import eval_driver as evd

        timers = {"decode_batch": _time_calls(ev, "decode_batch"),
                  "detokenize": _time_calls(evd.detok, "detokenize"),
                  "write_csv": _time_calls(ev, "_write_csv"),
                  "random_fact_caption": _time_calls(evd, "_random_fact_caption"),
                  "wait_for_batch": _time_calls(evd.ds, "prefetch", iterator=True)}
        _zero_serving_counts()
        t0 = time.perf_counter()
        res = ev.run(data, output_csv=path, log=lines.append, **kw)
        run_s = time.perf_counter() - t0
        launches = _read_serving_counts()
        for _, undo in timers.values():
            undo()
        decode_in_run = timers.pop("decode_batch")[0]
        decode_in_run_s = sum(decode_in_run)
        rows = _csv_rows(path)
        require(len(rows) == EVAL_ROWS + 1 and len(res["captions"]) == EVAL_ROWS,
                f"{preset} eval run: {len(rows) - 1} CSV rows, {len(res['captions'])} captions")
        rec = dict(run_s=run_s, captions_per_s=EVAL_ROWS / run_s, launches=launches,
                   decode_in_run_s=decode_in_run_s, decode_calls_ms=[t * 1e3 for t in decode_in_run],
                   host_in_run_s=run_s - decode_in_run_s,
                   host_parts_s={k: sum(times) for k, (times, _) in timers.items()},
                   csv_header=rows[0], log_lines=lines)
        if preset == "georic":
            want = serving_prediction(cfg, 3, 0)
            require(launches == want, f"eval run launches {launches} != predicted {want}")
            caps, decode_s = [], 0.0
            for idx in _padded_batches(data, ev.batch_size):
                batch = data.batch(idx, raw_images=True)
                t0 = time.perf_counter()
                ids = ev.decode_batch(batch)
                decode_s += time.perf_counter() - t0
                caps += [detok.caption_text(ids[j], wm, data.arrays.entity_names[i])[0]
                         for j, i in enumerate(idx[:min(len(idx), EVAL_ROWS - len(caps))])]
            require(caps == res["captions"] and [r[0] for r in rows[1:]] == caps,
                    "eval run: captions differ from decode_batch on the same padded batches")
            rec.update(decode_batch_s=decode_s, decode_batch_captions_per_s=EVAL_ROWS / decode_s,
                       js=res["js"][0])
            geo = (launches, split_cls, res["captions"])
        elif preset == "k_georic":
            rand = _csv_rows(path.replace(".csv", "_random_facts.csv"))
            require(len(rand) == EVAL_ROWS + 1, f"random-fact CSV: {len(rand) - 1} rows")
            rec["random_fact_differs"] = float(np.mean(
                [a != b for a, b in zip(res["random_baseline"], res["captions"])]))
        else:
            require(rows[0] == ["generated_caption", "generated_mask"],
                    f"news CSV header {rows[0]}")
            require(len(lines) == 3 and lines[0].startswith("Captions with entities"),
                    f"news log lines {lines}")
        log(f"eval run {preset}: {rec}")
        out[preset] = rec
        del ev, data
    return geo[0], out, geo[1], geo[2]


def token_cache(dev, model, split_cls, image_captions, workdir):
    """Evaluator.cache_split_tokens on the geo split: "encoded", then
    "loaded" from a fresh split, then "encoded" again for an encoder with one
    weight changed; the run over the cached tokens gives the image path's
    captions exactly (bf16 tokens round-trip through the f32 cache)."""
    from icek_torch import eval_driver

    cfg, wm, params, enc = model
    ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev)
    cache = os.path.join(workdir, "TEST_TOKENS_geo.npz")
    first = split_cls()
    t0 = time.perf_counter()
    got = [ev.cache_split_tokens(first, cache, log=log)]
    encode_s = time.perf_counter() - t0
    second = split_cls()
    t0 = time.perf_counter()
    got.append(ev.cache_split_tokens(second, cache, log=log))
    load_s = time.perf_counter() - t0
    changed = {k: v for k, v in enc.items()}
    changed["proj"] = {"w": enc["proj"]["w"].clone(), "b": enc["proj"]["b"]}
    changed["proj"]["w"].view(-1)[0] += 1e-3
    stale = eval_driver.Evaluator(cfg, wm, params, changed, device=dev)
    got.append(stale.cache_split_tokens(split_cls(), cache, log=log))
    del stale
    require(got == ["encoded", "loaded", "encoded"], f"token cache: {got}")
    # the cache encodes a partial chunk padded to the run's batch shape: the
    # same rows encoded as a batch of their own (another cuDNN algorithm)
    tail = first._images[(EVAL_ROWS // BATCH) * BATCH:]
    with torch.inference_mode():
        alone = ev._encode_tokens(torch.as_tensor(tail, device=dev), "raw").float().cpu()
    partial_diff = float((alone - torch.as_tensor(first.image_tokens[-len(tail):])).abs().max())
    require(np.array_equal(first.image_tokens, second.image_tokens), "token cache: reload differs")
    _zero_serving_counts()
    t0 = time.perf_counter()
    res = ev.run(second, output_csv=os.path.join(workdir, "cached.csv"), log=log)
    run_s = time.perf_counter() - t0
    launches = _read_serving_counts()
    require(res["captions"] == image_captions,
            "token cache: captions from cached tokens differ from the image path's")
    rec = dict(results=got, encode_s=encode_s, load_s=load_s, run_s=run_s,
               captions_per_s=EVAL_ROWS / run_s, launches=launches,
               cache_mb=os.path.getsize(cache) / 1e6,
               partial_batch_alone_max_abs_diff=partial_diff)
    log(f"token cache: {rec}")
    return rec


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def serving_engine(dev, model, split_cls, batch_256_captions):
    """The geo ServingEngine (max_batch 64, max_wait 3 ms, every bucket warmed)
    under 16 client threads submitting 512 requests: every future resolves;
    requests/s, p50 / p99 latency, mean fill and the bucket histogram.  Each
    group the engine decoded is held to decode_batch on the same padded batch
    (same bucket, same shapes: equal ids), in bf16 here and in f32 on 64 more
    requests; the token agreement with the rows' offline batch-256 decode is
    logged (another bucket is another GEMM shape).  One POST /caption round
    trip through make_server on port 0."""
    import threading
    import urllib.request

    from icek_torch import eval_driver
    from icek_torch.serve.engine import ServingEngine
    from icek_torch.serve.server import encode_request, make_server

    cfg, wm, params, enc = model
    data = split_cls()

    def sample(i):
        return {"raw_images": data._images[i],
                "entity_features": data.arrays.entity_features[i],
                "entity_names": data.arrays.entity_names[i]}

    def drive(engine, n, clients):
        lat, results = [None] * n, [None] * n

        def client(c):
            for i in range(c, n, clients):
                t0 = time.perf_counter()
                results[i] = engine.submit(sample(i % EVAL_ROWS)).result(timeout=600)
                lat[i] = time.perf_counter() - t0

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0, lat, results

    def recorded(engine):
        """Record every batch the engine decodes and the ids it got."""
        groups, inner = [], engine._evaluator.decode_batch_async

        def spy(batch):
            ids = inner(batch)
            groups.append((batch, ids))
            return ids

        engine._evaluator.decode_batch_async = spy
        return groups

    def hold_groups(groups, engine, limit):
        """decode_batch on each recorded group's own padded batch (up to
        `limit` groups a bucket), in the engine's compute dtype."""
        dtype = engine._evaluator.compute_dtype
        offline = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, compute_dtype=dtype)
        checked = {}
        for batch, ids in groups:
            b = len(batch["raw_images"])
            if checked.get(b, 0) >= limit:
                continue
            require(np.array_equal(offline.decode_batch(batch), ids.cpu().numpy()),
                    f"serving engine {dtype}: a bucket-{b} group differs from decode_batch")
            checked[b] = checked.get(b, 0) + 1
        return checked

    rec = {}
    with ServingEngine(cfg, wm, params, enc, max_batch=ENGINE_MAX_BATCH,
                       max_wait_ms=ENGINE_WAIT_MS, device=dev) as engine:
        t0 = time.perf_counter()
        engine.warmup(sample(0))
        rec["warmup_s"] = time.perf_counter() - t0
        groups = recorded(engine)
        _zero_serving_counts()
        wall, lat, results = drive(engine, ENGINE_REQUESTS, ENGINE_CLIENTS)
        launches = _read_serving_counts()
        stats = engine.stats()
        require(all(r is not None and isinstance(r["caption"], str) for r in results),
                "serving engine: a future did not resolve")
        require(stats.requests == ENGINE_REQUESTS and stats.errors == 0,
                f"serving engine: {stats}")
        require(launches["flash_attention"] == cfg.model.num_layers * stats.batches
                and launches["fused_score_topk"] > 0 and launches["decoder_step"] > 0,
                f"serving engine launches {launches} over {stats.batches} batches")
        server = make_server(engine, "127.0.0.1", 0, request_timeout=600)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = server.server_address
            req = urllib.request.Request(f"http://{host}:{port}/caption",
                                         data=encode_request(sample(7)), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                http = json.load(r)
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        require(http["caption"] == results[7]["caption"],
                "serving engine: POST /caption differs from the engine's caption")
    rec.update(requests=ENGINE_REQUESTS, clients=ENGINE_CLIENTS, wall_s=wall,
               requests_per_s=ENGINE_REQUESTS / wall,
               p50_ms=_percentile(lat, 0.5) * 1e3, p99_ms=_percentile(lat, 0.99) * 1e3,
               batches=stats.batches, mean_fill=stats.mean_fill,
               bucket_runs=dict(sorted(stats.bucket_runs.items())),
               launches=launches,
               launches_per_batch={k: v / stats.batches for k, v in launches.items()})
    rec["groups_checked"] = hold_groups(groups, engine, 2)
    # row independence across buckets, logged: each request's caption against
    # its row's caption in the offline batch-256 decode of the eval run
    same = [results[i]["caption"] == batch_256_captions[i] for i in range(BATCH)]
    rec["caption_agreement_with_batch_256"] = float(np.mean(same))
    with ServingEngine(cfg, wm, params, enc, max_batch=ENGINE_MAX_BATCH,
                       max_wait_ms=ENGINE_WAIT_MS, compute_dtype=torch.float32,
                       device=dev) as engine:
        engine.warmup(sample(0), buckets=[8, 16])
        groups = recorded(engine)
        _zero_serving_counts()
        wall32, _, _ = drive(engine, ENGINE_F32_REQUESTS, ENGINE_CLIENTS)
        launches32 = _read_serving_counts()
        require(launches32["decoder_step_f32"] > 0
                and launches32["decoder_step"] == launches32["decoder_step_cuda_cores"] == 0,
                f"serving engine f32: decoder-step launches {launches32}")
        rec["f32"] = dict(requests_per_s=ENGINE_F32_REQUESTS / wall32, launches=launches32,
                          bucket_runs=dict(sorted(engine.stats().bucket_runs.items())))
    rec["f32"]["groups_checked"] = hold_groups(groups, engine, 2)
    log(f"serving engine: {rec}")
    return rec


def int8_kv(dev, models):
    """Beam 5 at full width with kv_dtype "int8" and "int8_cross" against
    float, on one batch of news (and of geo), in turns (float, int8,
    int8_cross, int8_cross, int8, float): per int8 batch no decoder-step
    launch and one score-head launch a step; decoder-step True refused; the
    token agreement with float logged, captions/s of each mode."""
    from icek_torch import eval_driver

    out = {}
    for preset in ("nytimes800k", "georic"):
        cfg, wm, params, enc = models[preset]
        L = cfg.decode.max_caption_len
        batch = make_batch(np.random.default_rng(SEED + 31), BATCH, preset)
        evs = {kv: eval_driver.Evaluator(
                   cfg.replace(decode=dataclasses.replace(cfg.decode, kv_dtype=kv)),
                   wm, params, enc, device=dev) for kv in (None, "int8", "int8_cross")}
        ids = {kv: ev.decode_batch(batch) for kv, ev in evs.items()}        # warm-ups
        times = {kv: [] for kv in evs}
        for kv in (None, "int8", "int8_cross", "int8_cross", "int8", None):
            _zero_serving_counts()
            t0 = time.perf_counter()
            got = evs[kv].decode_batch(batch)
            times[kv].append(time.perf_counter() - t0)
            launches = _read_serving_counts()
            require(np.array_equal(got, ids[kv]), f"int8 kv {preset} {kv}: not repeatable")
            if kv is not None:
                want = dict(flash_attention=cfg.model.num_layers * (2 if cfg.model.has_facts
                                                                     else 1),
                            fused_score_topk=L, **decoder_launches())
                require(launches == want, f"int8 kv {preset} {kv}: launches {launches} != {want}")
        try:
            bad = cfg.replace(decode=dataclasses.replace(cfg.decode, kv_dtype="int8",
                                                         use_megakernel=True))
            eval_driver.Evaluator(bad, wm, params, enc, device=dev).decode_batch(batch)
            raise RuntimeError("int8 kv: use_megakernel=True was not refused")
        except ValueError as e:
            require("megakernel" in str(e), f"int8 kv: {e}")
        rec = {}
        for kv in evs:
            name = kv or "float"
            rec[name] = dict(batch_ms=[t * 1e3 for t in times[kv]],
                             captions_per_s=BATCH / statistics.median(times[kv]))
            if kv is not None:
                same = ids[kv] == ids[None]
                rec[name].update(token_agreement=float(same.mean()),
                                 caption_agreement=float(same.all(axis=1).mean()),
                                 launches_per_batch=want)
        log(f"int8 kv {preset} (batch {BATCH}, beam {BEAM}, L {L}, bf16): {rec}")
        out[preset] = rec
        del evs
    return out


def captions_leave(dev, models, keep_csvs=None):
    """Phase 7 in a scratch directory of its own (TMPDIR): the eval run, the
    token cache, the serving engine and the int8 KV options.  With
    `keep_csvs` (a directory), the geo and news CSVs are copied there."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory(prefix="icek_eval_") as workdir:
        launches, runs, geo_split, captions = eval_run(dev, models, workdir)
        for preset in ("georic", "nytimes800k") if keep_csvs else ():
            name = f"{preset}_generated_captions.csv"
            shutil.copy(os.path.join(workdir, name), os.path.join(keep_csvs, name))
        cache = token_cache(dev, models["georic"], geo_split, captions, workdir)
        engine = serving_engine(dev, models["georic"], geo_split, captions)
    return dict(eval_run=runs, eval_run_launches=launches, token_cache=cache,
                serving_engine=engine, int8_kv=int8_kv(dev, models))


# --------------------------------------------------------------------------
# phase 8: the training run end to end
# --------------------------------------------------------------------------

RUN_ROWS = {"TRAIN": 1024, "VAL": 256, "TEST": 256}
RUN_EPOCHS, FT_BATCH, FT_STEPS = 2, 32, 3


def run_split(rng, wm, rows=RUN_ROWS):
    """The loop's and the CLIs' TRAIN / VAL / TEST splits of the geo preset
    in memory (`rows` of each), so that the phase needs no HDF5 reader: a
    CaptionDataset subclass with CaptionDataset's signature, which the phase
    puts in its place while it runs.  Each open builds a fresh split over the
    same arrays."""
    from icek_torch.data import dataset as tdata
    from icek_torch.tools import _synthetic

    arrays = {}
    for split, n in rows.items():
        caps = train_captions(rng, n, wm)
        arrays[split] = (caps, _synthetic.entity_rows(rng, n),
                         rng.random((n, 3, IMG, IMG), dtype=np.float32).astype(np.float16))

    class RunSplit(tdata.CaptionDataset):
        def __init__(self, data_dir, base_name, split, has_facts=False):
            caps, ents, raw = arrays[split]
            n = len(raw)
            a = tdata.CaptionArrays.__new__(tdata.CaptionArrays)
            a.caption_ids = caps["caption_ids"].astype(np.int32)
            a.lengths = caps["lengths"].astype(np.int32)
            a.caption_mask = caps["caption_mask"].astype(np.int32)
            a.entity_features = ents
            a.entity_names = np.broadcast_to(entity_names(ENT_ROWS), (n, ENT_ROWS, 52))
            a.fact_features = a.fact_names = None
            a.size = n
            self.split, self.arrays, self._images, self.image_tokens = split, a, raw, None

    return RunSplit


class _SplitsInMemory:
    """Put `split_cls` in CaptionDataset's place for the block (the loop and
    the CLIs open their splits through it), and back afterwards."""

    def __init__(self, split_cls):
        from icek_torch.data import dataset as tdata

        self.mod, self.split_cls = tdata, split_cls

    def __enter__(self):
        self.real = self.mod.CaptionDataset
        self.mod.CaptionDataset = self.split_cls

    def __exit__(self, *exc):
        self.mod.CaptionDataset = self.real


def _bn_input(enc, images, where):
    """The bf16 input of the stem's batch norm (`where` None) or of block
    (stage, index)'s bn1 in the encoder's train-mode forward on `images`."""
    from icek_torch.models import resnet

    bf16 = torch.bfloat16
    with torch.no_grad():
        x = resnet.conv(resnet._to_nchw(images), enc["conv1"], 2, bf16)
        if where is None:
            return x
        x = resnet.max_pool_3x3_s2(torch.relu(resnet.batch_norm(enc["bn1"], x, True)[0]))
        for stage in range(1, 5):
            blocks = enc[f"layer{stage}"]
            for b, block in enumerate(blocks):
                if (stage, b) == (where[0], where[1] % len(blocks)):
                    return resnet.conv(x, block["conv1"], 1, bf16)
                x = resnet.bottleneck(block, x, resnet._stride(stage, b), bf16, True)
    raise ValueError(f"no block {where}")


def _leaves_with_paths(tree, path=()):
    """(path, tensor) of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _checkpoint_diff(a_path, b_path) -> list:
    """The leaves (and meta) in which two checkpoints differ, with their
    largest difference."""
    a, b = (torch.load(p, weights_only=True) for p in (a_path, b_path))
    diffs = [] if a["meta"] == b["meta"] else [("meta", a["meta"], b["meta"])]
    if a["opt"]["step"] != b["opt"]["step"]:
        diffs.append(("opt step", a["opt"]["step"], b["opt"]["step"]))
    for group in (("params",), ("encoder_params",), ("opt", "mu"), ("opt", "nu")):
        x, y = a, b
        for k in group:
            x, y = x[k], y[k]
        for (path, u), (_, v) in zip(_leaves_with_paths(x), _leaves_with_paths(y)):
            if not torch.equal(u, v):
                diffs.append((group + path, float((u.float() - v.float()).abs().max())))
    return diffs


def train_loop_phase(dev, model, split_cls, workdir, step_summary):
    """`loop`: train() over the 1024 / 256-row split, 2 epochs at batch 256,
    print_freq 1, from the seeded geo encoder (``encoder_weights``, a .pt
    encoder tree): the split's tokens cached, then lifted into the device
    token cache; launches held to 2 epochs x (4 train steps + 1 validation
    batch) of the code's prediction; samples/s of each epoch (host clock,
    data path included) beside phase 6's step alone, the token cache's
    encode seconds, a checkpoint's size and its save and load seconds.
    `resume`: the same run stopped by SIGTERM after batch 1 of epoch 1 and
    resumed from its STEP file ends in the uninterrupted run's epoch-1
    checkpoint, bit for bit."""
    import signal

    from icek_torch.train import checkpoint as tckpt
    from icek_torch.train import loop as tloop

    cfg, wm, _, enc = model
    enc_path = tckpt.save_encoder_tree(os.path.join(workdir, "encoder.pt"), enc,
                                       {"emb_dim": cfg.model.emb_dim})
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=BATCH, print_freq=1,
                                                epochs=RUN_EPOCHS))
    base = cfg.data.base_name
    counted = train_counters()
    steps, val_batches = RUN_ROWS["TRAIN"] // BATCH, RUN_ROWS["VAL"] // BATCH
    # a validation batch runs the deterministic forward: the flash forward at
    # every attention site and no dropout kernel
    per_val = {name: (per_step if name == "flash_attention" else 0)
               for name, (_, per_step) in counted.items()}
    want = {name: RUN_EPOCHS * (steps * per_step + val_batches * per_val[name])
            for name, (_, per_step) in counted.items()}
    log(f"train run launches predicted over {RUN_EPOCHS} epochs x ({steps} steps + "
        f"{val_batches} validation batch): {want}")

    def run(ckpt_dir, lines, **kw):
        return tloop.train(cfg, workdir, VOCAB, wm.pad_id, checkpoint_dir=ckpt_dir,
                           max_epochs=RUN_EPOCHS, log=lines.append, encoder_weights=enc_path,
                           device=dev, **kw)

    dir_a, dir_b = os.path.join(workdir, "run_a"), os.path.join(workdir, "run_b")
    timers = {"epoch": _time_calls(tloop, "run_epoch"),
              "validation": _time_calls(tloop, "run_validation"),
              "encode": _time_calls(split_cls, "cache_image_tokens"),
              "save": _time_calls(tckpt, "save_checkpoint")}
    lines = []
    with _SplitsInMemory(split_cls):
        for fn, _ in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = run(dir_a, lines)
        loop_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, (fn, _) in counted.items()}
    for _, undo in timers.values():
        undo()
    epoch_s, val_s = timers["epoch"][0], timers["validation"][0]
    final = os.path.join(dir_a, f"checkpoint_{base}.pt")
    t0 = time.perf_counter()
    tckpt.load_checkpoint(final)
    load_s = time.perf_counter() - t0
    steps_logged = [s for s in lines if s.startswith("Epoch")]

    def field(name):        # "<name> <value> (<average>)" of every step's line
        return [float(s.split(name + " ", 1)[1].split()[0]) for s in steps_logged]

    losses = field("Loss")
    loop = dict(
        loop_s=loop_s, epoch_s=epoch_s, validation_s=val_s,
        samples_per_s_by_epoch=[RUN_ROWS["TRAIN"] / t for t in epoch_s],
        step_alone_samples_per_s=step_summary["samples_per_s_median"],
        token_cache_encode_s=timers["encode"][0], checkpoint_save_s=timers["save"][0],
        checkpoint_bytes=os.path.getsize(final), checkpoint_load_s=load_s,
        launches=launches, launches_predicted=want, best_loss=result.best_loss,
        train_losses=losses, step_batch_s=field("Batch Time"),
        step_data_wait_s=field("Data Load Time"),
        log_lines=[s for s in lines if not s.startswith("Epoch")])
    log(f"train run loop: {loop}")
    require(any(s.startswith("device token cache:") for s in lines),
            "the loop did not lift the split's tokens into the device token cache")
    require(launches == want, f"train run launches {launches} != predicted {want}")
    require(len(epoch_s) == RUN_EPOCHS and math.isfinite(result.best_loss)
            and all(math.isfinite(x) for x in losses), f"train run: {result}, {losses}")

    step_file = os.path.join(dir_b, f"checkpoint_STEP_{base}.pt")
    fired = []

    def killing_log(msg):
        if msg.startswith("Epoch: [1][1/") and not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    with _SplitsInMemory(split_cls):
        stopped = tloop.train(cfg, workdir, VOCAB, wm.pad_id, checkpoint_dir=dir_b,
                              max_epochs=RUN_EPOCHS, log=killing_log,
                              encoder_weights=enc_path, device=dev)
        require(stopped.preempted and os.path.exists(step_file),
                f"SIGTERM did not preempt the run: {stopped}")
        step_meta = tckpt.read_meta(step_file)
        picked = tckpt.latest_checkpoint(dir_b, base)
        require(picked == step_file, f"latest_checkpoint picked {picked}, not {step_file}")
        t0 = time.perf_counter()
        resumed = run(dir_b, [], resume_from=step_file)
        resume_s = time.perf_counter() - t0
    diffs = _checkpoint_diff(final, os.path.join(dir_b, f"checkpoint_{base}.pt"))
    resume = dict(step_meta=step_meta, resume_s=resume_s, preempted_again=resumed.preempted,
                  step_file_removed=not os.path.exists(step_file), differing=diffs[:20],
                  n_differing=len(diffs))
    log(f"train run resume: {resume}")
    require(not diffs, f"the resumed run's epoch-1 checkpoint differs from the "
                       f"uninterrupted run's in {len(diffs)} places: {diffs[:20]}")
    require(resume["step_file_removed"] and not resumed.preempted, f"resume: {resume}")
    return loop, resume, enc_path


def finetune_phase(dev, model):
    """Geo, bf16, batch 32, 3 steps with the ResNet inside the step: with
    fine-tuning, the stem, layer1 and every batch-norm statistic stay
    bit-unchanged and every trainable leaf moves; with bn_train_mode, every
    running statistic moves, the weights do not, and the running statistics
    after the first step of the stem's batch norm and of layer4's last
    block's bn1 match torch's BatchNorm2d (momentum 0.1, train mode) on the
    same input to 1e-5 of their largest value.  At the stem (n = 401408 per
    channel) the unbiased and the biased running variance differ by less than
    that; at layer4 (n = 1568) by more, which the phase checks, so the check
    tells the two conventions apart.  ms a step."""
    from icek_torch import bridge
    from icek_torch.data import images as image_ops
    from icek_torch.models import resnet
    from icek_torch.tools import _synthetic
    from icek_torch.train import step as step_lib

    cfg, wm, params, enc = model
    rng = np.random.default_rng(SEED + 41)
    batch = train_captions(rng, FT_BATCH, wm)
    batch["entity_features"] = _synthetic.entity_rows(rng, FT_BATCH)
    batch["raw_images"] = rng.random((FT_BATCH, 3, IMG, IMG), dtype=np.float32).astype(np.float16)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    out = {}
    for mode in ("fine_tune_encoder", "bn_train_mode"):
        p = bridge.trainable(copy.deepcopy(params), dev)
        e = bridge.to_device(copy.deepcopy(enc), dev)
        start = {path: t.clone() for path, t in _leaves_with_paths(e)}
        optimizer = step_lib.make_optimizer(cfg.train.decoder_lr, cfg.train.grad_clip)
        opt_state = optimizer.init(p)
        if mode == "fine_tune_encoder":
            eopt = step_lib.make_encoder_optimizer(e, cfg.train.encoder_lr, cfg.train.grad_clip)
            estate = eopt.init(e)
            train_step, _ = step_lib.make_train_step(
                cfg, VOCAB, wm.pad_id, optimizer, compute_dtype=torch.bfloat16,
                encoder_optimizer=eopt, device=dev)
            call = lambda gen: train_step(p, opt_state, e, estate, batch, gen)[4]  # noqa: E731
        else:
            # torch's BatchNorm2d on the inputs of the stem's batch norm and of
            # layer4's last bn1, recomputed by the step's own forward
            images = image_ops.normalize_in_graph(batch["raw_images"])
            refs, gap = {}, None
            for where, bn in ((None, e["bn1"]), ((4, -1), e["layer4"][-1]["bn1"])):
                x = _bn_input(e, images, where).float()
                ref = torch.nn.BatchNorm2d(x.shape[1], momentum=0.1).to(dev).train()
                ref.running_mean.copy_(bn["mean"])
                ref.running_var.copy_(bn["var"])
                with torch.no_grad():
                    ref(x)
                refs[where] = ref
                if where is not None:   # the biased convention's running variance
                    biased = 0.9 * bn["var"] + 0.1 * torch.var(x, dim=(0, 2, 3),
                                                               correction=0)
                    gap = float((ref.running_var - biased).abs().max()
                                / ref.running_var.abs().max())
            train_step, _ = step_lib.make_train_step(
                cfg, VOCAB, wm.pad_id, optimizer, compute_dtype=torch.bfloat16,
                bn_train_mode=True, device=dev)
            call = lambda gen: train_step(p, opt_state, e, batch, gen)[3]  # noqa: E731
        times, losses = [], []
        for s in range(FT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(call(torch.Generator().manual_seed(SEED + s))))
            times.append((time.perf_counter() - t0) * 1e3)
            if s == 0 and mode == "bn_train_mode":
                bn_err = {where: max(float((bn[k] - getattr(refs[where], f"running_{k}"))
                                           .abs().max())
                                     / float(getattr(refs[where], f"running_{k}").abs().max())
                                     for k in ("mean", "var"))
                          for where, bn in ((None, e["bn1"]),
                                            ((4, -1), e["layer4"][-1]["bn1"]))}
        mask = dict(_leaves_with_paths(step_lib.encoder_trainable_mask(e)))
        moved = {path: not torch.equal(t, start[path]) for path, t in _leaves_with_paths(e)}
        stats = [path for path in moved if path[-1] in ("mean", "var")]
        rec = dict(step_ms=times, step_ms_median_of_last=statistics.median(times[1:]),
                   losses=losses, leaves=len(moved), moved=sum(moved.values()))
        require(all(math.isfinite(x) for x in losses), f"{mode}: losses {losses}")
        if mode == "fine_tune_encoder":
            frozen = [path for path in moved if not mask[path]]
            rec.update(trainable=sum(mask.values()), frozen=len(frozen))
            require(not any(moved[path] for path in frozen),
                    f"{mode}: frozen leaves moved: {[p for p in frozen if moved[p]][:5]}")
            require(all(moved[path] for path in moved if mask[path]),
                    f"{mode}: trainable leaves that did not move: "
                    f"{[p for p in moved if mask[p] and not moved[p]][:5]}")
        else:
            rec.update(running_stats=len(stats), stem_stats_rel_err=bn_err[None],
                       layer4_stats_rel_err=bn_err[(4, -1)], layer4_biased_var_gap=gap)
            require(all(moved[path] for path in stats),
                    f"{mode}: running statistics that did not move: "
                    f"{[p for p in stats if not moved[p]][:5]}")
            require(not any(moved[path] for path in moved if path not in stats),
                    f"{mode}: encoder weights moved")
            require(max(bn_err.values()) <= 1e-5,
                    f"{mode}: running statistics {bn_err} from BatchNorm2d's")
            require(gap > 1e-5, f"{mode}: layer4's biased and unbiased running "
                                f"variances differ by only {gap}")
        log(f"train run {mode} (geo, batch {FT_BATCH}, bf16): {rec}")
        out[mode] = rec
        del p, e, opt_state
    return out


def cli_phase(dev, model, split_cls, workdir, enc_path):
    """In-process through icek_torch.apps on the in-memory split: run_train
    georic for one epoch at batch 256 from the seeded encoder; run_eval from
    its BEST_ checkpoint and from a checkpoint of the seeded (untrained)
    model, each CSV with a row for every TEST row and the captions of
    Evaluator.run on the same checkpoint (one epoch on random captions
    teaches the model to end at once, so the BEST_ captions come out empty;
    the seeded model's carry words); run_serve on port 0 with one POST
    /caption round trip."""
    import http.client
    import threading

    from icek_torch import apps, eval_driver
    from icek_torch.core import config as cfgs
    from icek_torch.serve import server as server_lib
    from icek_torch.train import checkpoint as tckpt

    cfg, wm, params, enc = model
    base = cfg.data.base_name
    data_dir, ckpt_dir = os.path.join(workdir, "files"), os.path.join(workdir, "cli")
    os.makedirs(data_dir)
    with open(os.path.join(data_dir, f"WORDMAP_{base}.json"), "w") as f:
        json.dump(wm.word_to_id, f)
    out = {}
    with _SplitsInMemory(split_cls):
        t0 = time.perf_counter()
        apps.run_train("georic", ["--data-dir", data_dir, "--checkpoint-dir", ckpt_dir,
                                  "--epochs", "1", "--batch-size", str(BATCH),
                                  "--encoder-weights", enc_path])
        out["train_s"] = time.perf_counter() - t0
        best = os.path.join(ckpt_dir, f"BEST_checkpoint_0_{base}.pt")
        require(os.path.exists(best), f"run_train wrote no {best}")
        seeded = tckpt.save_checkpoint(os.path.join(workdir, "seeded"), base, 0, 0, 0.0,
                                       params, None, enc)
        test = split_cls(data_dir, base, "TEST")
        for name, ckpt in (("best", best), ("seeded", seeded)):
            csv_path = os.path.join(workdir, f"{name}_generated_captions.csv")
            _zero_serving_counts()
            t0 = time.perf_counter()
            apps.run_eval("georic", ["--data-dir", data_dir, "--checkpoint", ckpt,
                                     "--batch-size", str(BATCH), "--beam", str(BEAM),
                                     "--output", csv_path,
                                     "--metric-data", os.path.join(workdir, "absent")])
            eval_s = time.perf_counter() - t0
            launches = _read_serving_counts()
            rows = _csv_rows(csv_path)
            p, _, e, _ = tckpt.load_checkpoint(ckpt)
            ev = eval_driver.Evaluator(cfgs.get_config("georic"), wm, p, e,
                                       batch_size=BATCH, beam_size=BEAM, device=dev)
            res = ev.run(test, output_csv=os.path.join(workdir, "want.csv"), log=lambda s: None)
            require(len(rows) == RUN_ROWS["TEST"] + 1,
                    f"run_eval CSV: {len(rows) - 1} rows for {RUN_ROWS['TEST']} TEST rows")
            require([r[0] for r in rows[1:]] == res["captions"],
                    f"run_eval's captions of the {name} checkpoint differ from "
                    f"Evaluator.run's on the same checkpoint")
            out[name] = dict(eval_s=eval_s, csv_rows=len(rows) - 1, launches=launches,
                             nonempty=sum(bool(c) for c in res["captions"]),
                             first_caption=res["captions"][0])
            del ev
        require(out["seeded"]["nonempty"] == RUN_ROWS["TEST"],
                f"the seeded model's captions: {out['seeded']}")
        # the seeded model's captions run every step (the BEST_ model's end
        # early): one batch of the serving prediction
        want = serving_prediction(cfgs.get_config("georic"), 1, 0)
        require(out["seeded"]["launches"] == want,
                f"run_eval launches {out['seeded']['launches']} != predicted {want}")

        made = []
        make = server_lib.make_server
        server_lib.make_server = lambda *a, **k: made.append(make(*a, **k)) or made[-1]
        thread = threading.Thread(target=apps.run_serve, daemon=True, args=("georic", [
            "--data-dir", data_dir, "--checkpoint", seeded, "--port", "0",
            "--max-batch", "8"]))
        try:
            thread.start()
            for _ in range(1200):
                if made or not thread.is_alive():
                    break
                thread.join(0.1)
            require(bool(made), "run_serve started no server")
            row = test.batch(np.array([0]), raw_images=True)
            sample = {"raw_images": row["raw_images"][0],
                      "entity_features": row["entity_features"][0],
                      "entity_names": np.ascontiguousarray(test.arrays.entity_names[0])}
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection(*made[0].server_address, timeout=300)
            conn.request("POST", "/caption", body=server_lib.encode_request(sample))
            resp = conn.getresponse()
            status, reply = resp.status, json.loads(resp.read())
            conn.close()
            out["serve_round_trip_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            server_lib.make_server = make
            if made:
                made[0].shutdown()
            thread.join(60)
    require(status == 200 and bool(reply.get("caption")),
            f"POST /caption: {status} {reply}")
    require(not thread.is_alive(), "run_serve did not return after shutdown")
    # a batch of 1 against the offline batch of 256: equal in f32, mostly in
    # bf16 (ROADMAP.md section 3, row independence); logged, not asserted
    out.update(served_caption=reply["caption"],
               served_equals_offline=reply["caption"] == out["seeded"]["first_caption"])
    log(f"train run cli: {out}")
    return out


def geometry_cli(dev, model, split_cls, workdir):
    """The CLIs at --geometry 512x8 on phase 8's in-memory split (its data
    directory from cli_phase): run_train georic --geometry 512x8 for one
    epoch at batch 256 from the 512x8 model's seeded encoder, every flash
    forward on the bf16 tensor-core kernels (the encoders' on wgmma); run_eval from its BEST_
    checkpoint, which records the geometry and re-applies it, every flash
    forward on them again and a CSV row for every TEST row."""
    from icek_torch import apps
    from icek_torch.train import checkpoint as tckpt

    cfg, _, _, enc = model
    base = cfg.data.base_name
    data_dir, ckpt_dir = os.path.join(workdir, "files"), os.path.join(workdir, "cli_geometry")
    enc_path = tckpt.save_encoder_tree(os.path.join(workdir, "encoder_geometry.pt"), enc,
                                       {"emb_dim": cfg.model.emb_dim})
    out = {}
    with _SplitsInMemory(split_cls):
        zero_route_counts()
        t0 = time.perf_counter()
        apps.run_train("georic", ["--data-dir", data_dir, "--checkpoint-dir", ckpt_dir,
                                  "--epochs", "1", "--batch-size", str(BATCH),
                                  "--geometry", GEOMETRY, "--encoder-weights", enc_path])
        out.update(train_s=time.perf_counter() - t0, train_routes=route_counts())
        best = os.path.join(ckpt_dir, f"BEST_checkpoint_0_{base}.pt")
        require(os.path.exists(best), f"run_train --geometry {GEOMETRY} wrote no {best}")
        out["recorded_geometry"] = tckpt.read_meta(best).get("geometry")
        csv_path = os.path.join(workdir, "geometry_generated_captions.csv")
        zero_route_counts()
        t0 = time.perf_counter()
        apps.run_eval("georic", ["--data-dir", data_dir, "--checkpoint", best,
                                 "--batch-size", str(BATCH), "--beam", str(BEAM),
                                 "--output", csv_path,
                                 "--metric-data", os.path.join(workdir, "absent")])
        out.update(eval_s=time.perf_counter() - t0, eval_routes=route_counts(),
                   csv_rows=len(_csv_rows(csv_path)) - 1)
    require(out["recorded_geometry"] == GEOMETRY,
            f"the checkpoint records geometry {out['recorded_geometry']}")
    require(out["csv_rows"] == RUN_ROWS["TEST"],
            f"run_eval --geometry CSV: {out['csv_rows']} rows for {RUN_ROWS['TEST']} TEST rows")
    for what in ("train_routes", "eval_routes"):
        r = out[what]
        require(r["flash_mma"] > 0 and r["flash_tf32"] == r["flash_cuda_cores"] == 0
                and r["flash_wgmma"] == r["flash_mma"] > 0,
                f"--geometry {GEOMETRY} CLI {what}: flash routes {r}")
    log(f"train run cli at --geometry {GEOMETRY}: {out}")
    return out


def train_run(dev, models, step_summary):
    """Phase 8 in a scratch directory of its own, deleted at the end: the
    loop, its preempted and resumed twin, the image-carrying steps and the
    CLIs, also at --geometry 512x8."""
    import tempfile

    model = models["georic"]
    split_cls = run_split(np.random.default_rng(SEED + 31), model[1])
    with tempfile.TemporaryDirectory(prefix="icek_train_") as workdir:
        loop, resume, enc_path = train_loop_phase(dev, model, split_cls, workdir, step_summary)
        finetune = finetune_phase(dev, model)
        cli = cli_phase(dev, model, split_cls, workdir, enc_path)
        cli_geometry = geometry_cli(dev, full_width_model(geometry=GEOMETRY), split_cls,
                                    workdir)
    return dict(loop=loop, resume=resume, finetune=finetune, cli=cli,
                cli_geometry=cli_geometry)


# --------------------------------------------------------------------------
# phase 9: the int8 encoder (csrc/int8_conv.cu), its CLIs, metrics, native
# --------------------------------------------------------------------------

INT8_TOPS = 1979e12                       # H100 SXM dense int8
INT8_CALIB_BATCHES = 2
# (name, input side, Cin, Cout, kernel, stride, epilogue) at batch 256 of
# 256x256 images: the five site kinds of ResNet-101, 1x1 / 1 with each of
# its three epilogues; "1x1_s1" (layer3's conv1, 22 launches an encode) is
# the kernels line's headline.  The stem here is its launch on int8 codes
# (the mma.sync kernel: C = 3); the encode's stem is "stem_float" below.
INT8_SITES = (
    ("stem_7x7_s2", IMG, 3, 64, 7, 2, "q8"),
    ("1x1_s1", 16, 1024, 256, 1, 1, "q8"),
    ("1x1_s1_int8_shortcut", 16, 256, 1024, 1, 1, "q8_q8sc"),
    ("1x1_s1_f32_shortcut", 32, 128, 512, 1, 1, "q8_f32sc"),
    ("down_1x1_s2", 64, 256, 512, 1, 2, "f32"),
    ("3x3_s1", 16, 256, 256, 3, 1, "q8"),
    ("3x3_s2", 64, 128, 128, 3, 2, "q8"),
)


def encode_sites():
    """{site key: launches} of one int8 encode of IMG x IMG images
    (resnet_int8.encode_sites: 24 distinct sites, 100 launches)."""
    from icek_torch.models import resnet_int8

    sites = resnet_int8.encode_sites(IMG)
    require(len(sites) == 24, f"encode sites: {len(sites)} distinct")
    return sites


def _int8_site(dev, g, cin, cout, k):
    K = k * k * cin
    return {"wq": torch.randint(-127, 128, (cout, k, k, cin), generator=g, device=dev,
                                dtype=torch.int8),
            "es": (torch.rand(cout, generator=g, device=dev) + 0.5) / (127.0 * 64 * K ** 0.5),
            "b": torch.randn(cout, generator=g, device=dev) * 0.1}


def _int8_site_inputs(dev, g, side, cin, cout, k, stride, mode):
    from icek_torch.kernels import int8_conv as k8

    lo = -127 if cin == 3 else 0
    x = torch.randint(lo, 128, (BATCH, side, side, cin), generator=g, device=dev,
                      dtype=torch.int8)
    site = _int8_site(dev, g, cin, cout, k)
    ho = k8.out_hw(side, k, stride)
    shortcut = None
    if mode == "q8_f32sc":
        shortcut = torch.randn((BATCH, ho, ho, cout), generator=g, device=dev)
    elif mode == "q8_q8sc":
        shortcut = torch.randint(0, 128, (BATCH, ho, ho, cout), generator=g, device=dev,
                                 dtype=torch.int8)
    kw = dict(inv=None if mode == "f32" else torch.tensor(127 / 3.0), shortcut=shortcut,
              a_x=torch.tensor(1 / 127.0) if mode == "q8_q8sc" else None)
    return x, site, kw, ho


def _int8_unit(dev, g, key):
    """(run, plain, acc, acc_plain) of an encode site key at BATCH: the
    launch, its plain version, and the int32 sums where the site has them
    alone (qconv, the stem's acc; None for the fused site)."""
    from icek_torch.kernels import int8_conv as k8

    inv = torch.tensor(127 / 3.0)
    if key[0] == "stem":
        images = torch.randn((BATCH, 3, key[1], key[1]), generator=g, device=dev
                             ).permute(0, 2, 3, 1)
        site, inv_img = _int8_site(dev, g, 3, 64, 7), torch.tensor(127 / 4.0)
        return ((lambda: k8.stem_site(images, site, inv_img, inv)),
                (lambda: k8.reference_stem_site(images, site, inv_img, inv)),
                (lambda: k8.stem_site(images, site, inv_img, acc=True)),
                (lambda: k8.reference_stem_site(images, site, inv_img, acc=True)))
    if key[0] == "fused":
        _, side, cin, cmid, cout, s = key
        ho = k8.out_hw(side, 1, s)
        xq = torch.randint(0, 128, (BATCH, side, side, cin), generator=g, device=dev,
                           dtype=torch.int8)
        out = torch.randint(0, 128, (BATCH, ho, ho, cmid), generator=g, device=dev,
                            dtype=torch.int8)
        c3, dn = _int8_site(dev, g, cmid, cout, 1), _int8_site(dev, g, cin, cout, 1)
        return ((lambda: k8.fused_site(out, xq, c3, dn, s, inv)),
                (lambda: k8.reference_fused_site(out, xq, c3, dn, s, inv)), None, None)
    _, side, cin, cout, k, s, mode = key
    x, site, kw, _ = _int8_site_inputs(dev, g, side, cin, cout, k, s, mode)
    return ((lambda: k8.conv_site(x, site, s, **kw)),
            (lambda: k8.reference_site(x, site, s, **kw)),
            (lambda: k8.qconv(x, site["wq"], s)),
            (lambda: k8.reference_qconv(x, site["wq"], s)))


def _int8_site_work(side, cin, cout, k, stride, mode):
    """(bytes, operations) of one site: int8 x and weight read once, the
    shortcut read once, es / b, the output written once."""
    from icek_torch.kernels import int8_conv as k8

    ho = k8.out_hw(side, k, stride)
    m = BATCH * ho * ho
    out_b = {"f32": 4}.get(mode, 1)
    sc_b = {"q8_f32sc": 4, "q8_q8sc": 1}.get(mode, 0)
    nbytes = BATCH * side * side * cin + cout * k * k * cin + 8 * cout + m * cout * (out_b + sc_b)
    return nbytes, 2.0 * m * cout * k * k * cin


def _unit_work(key):
    """(bytes, operations) of an encode site key's launch: a conv site as
    _int8_site_work; the fused site reads both activations and both weights
    and writes the codes; the stem reads the float32 images."""
    from icek_torch.kernels import int8_conv as k8

    if key[0] == "conv":
        return _int8_site_work(*key[1:])
    if key[0] == "fused":
        _, side, cin, cmid, cout, s = key
        ho = k8.out_hw(side, 1, s)
        m = BATCH * ho * ho
        nbytes = BATCH * side * side * cin + m * cmid + cout * (cin + cmid) + 16 * cout + m * cout
        return nbytes, 2.0 * m * cout * (cin + cmid)
    _, side, cin, cout, k, s = key
    ho = k8.out_hw(side, k, s)
    m = BATCH * ho * ho
    return (4 * BATCH * side * side * cin + cout * k * k * cin + 8 * cout + m * cout,
            2.0 * m * cout * k * k * cin)


def _unfused_units(key):
    """The launches of a site key without the fused entries: the fused site
    as the down site (float32 out) and conv3 with the float32 shortcut; the
    stem as its launch on int8 codes."""
    from icek_torch.kernels import int8_conv as k8

    if key[0] == "fused":
        _, side, cin, cmid, cout, s = key
        return [(side, cin, cout, 1, s, "f32"), (k8.out_hw(side, 1, s), cmid, cout, 1, 1, "q8_f32sc")]
    if key[0] == "stem":
        return [(key[1], 3, 64, 7, 2, "q8")]
    return [key[1:]]


def _bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_TOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_int8_sites(dev):
    """(a) the int8 site kernels against their plain versions at each site
    kind (the int32 accumulators and the epilogue's codes bit-equal), timed
    beside the plain version, cuBLASLt's int8 GEMM (torch._int_mm) plus an
    epilogue of torch ops at the 1x1 / 1 sites, cuDNN's bf16 convolution of
    the same site, and the bound, each with its route and the wrapper's host
    us a call; the same for the four fused sites and the stem from float
    images; then every distinct site of an encode timed alone (the
    per-encode sum of its 100 launches); the int8 max pool against its
    plain version.  F.conv2d and F.max_pool2d are tried on int8 CUDA
    tensors and their refusals logged."""
    import torch.nn.functional as F

    from icek_torch.kernels import int8_conv as k8

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    refusals = {}
    probe = torch.zeros((2, 8, 8, 64), dtype=torch.int8, device=dev).permute(0, 3, 1, 2)
    for name, fn in (("F.conv2d", lambda: F.conv2d(probe, torch.zeros(
            (64, 64, 3, 3), dtype=torch.int8, device=dev))),
            ("F.max_pool2d", lambda: F.max_pool2d(probe, 3, 2, 1))):
        try:
            fn()
            refusals[name] = "ran"
        except (RuntimeError, NotImplementedError) as e:
            refusals[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    log(f"int8 on CUDA in the library: {refusals}")

    def routes():
        return {r: n.launches for r, n in k8.conv_site.routes.items()}

    def on_route(fn, name):
        """fn's result and the route its single launch took."""
        before = routes()
        out = fn()
        torch.cuda.synchronize()
        ran = [r for r, n in routes().items() if n != before[r]]
        require(len(ran) == 1 and routes()[ran[0]] == before[ran[0]] + 1,
                f"int8 site {name}: launches {ran}")
        return out, ran[0] if ran else None

    rows = {}
    for name, side, cin, cout, k, stride, mode in INT8_SITES:
        x, site, kw, ho = _int8_site_inputs(dev, g, side, cin, cout, k, stride, mode)
        acc, _ = on_route(lambda: k8.qconv(x, site["wq"], stride), name)
        got, route = on_route(lambda: k8.conv_site(x, site, stride, **kw), name)
        want_acc = k8.reference_qconv(x, site["wq"], stride)
        want = k8.reference_site(x, site, stride, **kw)
        require(route == k8.route(cin, cout, k, stride, side, side),
                f"int8 site {name}: route {route}")
        require(torch.equal(acc, want_acc), f"int8 site {name}: int32 accumulators differ")
        diff = int((got != want).sum())
        require(got.dtype == want.dtype and diff == 0,
                f"int8 site {name}: {diff} outputs differ from the plain version")
        ms = cuda_ms(lambda: k8.conv_site(x, site, stride, **kw))
        plain_ms = cuda_ms(lambda: k8.reference_site(x, site, stride, **kw), iters=2, warmup=1)
        bound, bound_by = _bound_ms(*_int8_site_work(side, cin, cout, k, stride, mode))
        _, ops = _int8_site_work(side, cin, cout, k, stride, mode)
        library_ms = None
        if k == 1 and stride == 1:
            a2 = x.reshape(-1, cin)
            b2 = site["wq"].reshape(cout, cin).t()

            def library():
                y = torch._int_mm(a2, b2).to(torch.float32) * site["es"] + site["b"]
                if kw["inv"] is None:
                    return y
                if kw["shortcut"] is not None:
                    sc = kw["shortcut"].reshape(-1, cout)
                    y = y + (sc if sc.dtype == torch.float32 else sc.to(torch.float32) * kw["a_x"])
                return k8.requant_relu(y, kw["inv"])
            try:
                lib = library().reshape(got.shape)
            except RuntimeError as e:           # the yardstick only: logged
                log(f"int8 site {name}: torch._int_mm refused: {e}")
            else:
                require(torch.equal(lib, want), f"int8 site {name}: _int_mm + epilogue differs")
                library_ms = cuda_ms(library)
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = site["wq"].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=(k - 1) // 2))
        rows[name] = dict(site=(BATCH, side, side, cin, cout, k, stride, mode), route=route,
                          ms=ms, plain_ms=plain_ms, library_ms=library_ms, cudnn_bf16_ms=cudnn_ms,
                          bound_ms=bound, bound_by=bound_by, tops=ops / ms / 1e9,
                          max_abs_err=0.0, acc_max=int(want_acc.abs().max()),
                          host_us=host_ms(lambda: k8.conv_site(x, site, stride, **kw),
                                          iters=50) * 1e3)
        log(f"int8 site {name}: {rows[name]}")
        del x, site, kw, acc, got, want, want_acc, xb, wb
    # the encode's own entries: the fused conv3 + down sites and the stem
    # from float images, each against its plain version
    for key in sorted(k for k in encode_sites() if k[0] != "conv"):
        name = f"{key[0]}_{'x'.join(map(str, key[1:]))}" if key[0] == "fused" else "stem_float"
        run, plain, acc_fn, acc_plain = _int8_unit(dev, g, key)
        got, route = on_route(run, name)
        require(route == key[0], f"int8 site {name}: route {route}")
        if acc_fn is not None:
            acc, _ = on_route(acc_fn, name)
            require(torch.equal(acc, acc_plain()), f"int8 site {name}: int32 sums differ")
        diff = int((got != plain()).sum())
        require(diff == 0, f"int8 site {name}: {diff} codes differ from the plain version")
        ms = cuda_ms(run)
        nbytes, ops = _unit_work(key)
        bound, bound_by = _bound_ms(nbytes, ops)
        if key[0] == "fused":       # the two bf16 convolutions of the same site
            _, side, cin, cmid, cout, s = key
            ho = k8.out_hw(side, 1, s)
            xb, yb = (torch.randn((BATCH, c, h, h), generator=g, device=dev).to(torch.bfloat16)
                      .contiguous(memory_format=torch.channels_last)
                      for c, h in ((cin, side), (cmid, ho)))
            wd, w3 = (torch.randn((cout, c, 1, 1), generator=g, device=dev).to(torch.bfloat16)
                      .contiguous(memory_format=torch.channels_last) for c in (cin, cmid))
            cudnn = lambda: F.conv2d(yb, w3) + F.conv2d(xb, wd, stride=s)
        else:
            xb = torch.randn((BATCH, 3, key[1], key[1]), generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            wb = torch.randn((64, 3, 7, 7), generator=g, device=dev).to(torch.bfloat16)
            cudnn = lambda: F.conv2d(xb, wb, stride=2, padding=3)
        rows[name] = dict(site=(BATCH,) + key[1:], route=route, ms=ms,
                          plain_ms=cuda_ms(plain, iters=2, warmup=1), library_ms=None,
                          cudnn_bf16_ms=cuda_ms(cudnn), bound_ms=bound, bound_by=bound_by,
                          tops=ops / ms / 1e9, max_abs_err=0.0,
                          host_us=host_ms(run, iters=50) * 1e3)
        log(f"int8 site {name}: {rows[name]}")
        del run, plain, acc_fn, acc_plain, got, cudnn
    per_encode = dict(ms=0.0, bound_ms=0.0, bound_unfused_ms=0.0, launches=0, sites={})
    for key, count in sorted(encode_sites().items(), key=str):
        run = _int8_unit(dev, g, key)[0]
        ms = cuda_ms(run, iters=10)
        bound, _ = _bound_ms(*_unit_work(key))
        unfused = sum(_bound_ms(*_int8_site_work(*u))[0] for u in _unfused_units(key))
        per_encode["ms"] += count * ms
        per_encode["bound_ms"] += count * bound
        per_encode["bound_unfused_ms"] += count * unfused
        per_encode["launches"] += count
        per_encode["sites"]["x".join(map(str, key))] = dict(launches=count, ms=ms, bound_ms=bound)
        del run
    log(f"int8 encode's {per_encode['launches']} site launches timed alone (batch {BATCH}): "
        f"{per_encode}")
    x = torch.randint(-128, 128, (BATCH, IMG // 2, IMG // 2, 64), generator=g, device=dev,
                      dtype=torch.int8)
    got = k8.max_pool(x)
    torch.cuda.synchronize()
    require(torch.equal(got, k8.reference_max_pool(x)), "int8 max pool differs")
    # the strip kernel at odd heights and widths, 16- and 4-byte pieces, rows
    # wide enough for one-row strips and rows staged as segments of columns,
    # bit-equal to the plain version
    odd = {}
    for shape in ((BATCH, 67, 67, 64), (3, 17, 13, 64), (2, 9, 31, 16), (2, 7, 5, 12),
                  (1, 1, 1, 64), (2, 5, 400, 64), (2, 5, 1600, 64)):
        xo = torch.randint(-128, 128, shape, generator=g, device=dev, dtype=torch.int8)
        ok = torch.equal(k8.max_pool(xo), k8.reference_max_pool(xo))
        require(ok, f"int8 max pool differs at {shape}")
        odd["x".join(map(str, shape))] = ok
    nbytes = x.numel() + got.numel()
    pool = dict(ms=cuda_ms(lambda: k8.max_pool(x)),
                plain_ms=cuda_ms(lambda: k8.reference_max_pool(x), iters=5),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
                max_abs_err=0.0, bit_equal_shapes=odd)
    log(f"int8 max pool ({tuple(x.shape)}): {pool}")
    return rows, per_encode, pool, refusals


def _int8_counts():
    from icek_torch.kernels import int8_conv as k8

    return k8.conv_site.launches, k8.max_pool.launches


def _int8_routes():
    from icek_torch.kernels import int8_conv as k8

    return {r: n.launches for r, n in k8.conv_site.routes.items()}


def _zero_int8_counts():
    from icek_torch.kernels import int8_conv as k8

    k8.conv_site.launches = k8.max_pool.launches = 0
    for n in k8.conv_site.routes.values():
        n.launches = 0


def int8_serving(dev, model):
    """(b) calibrate on 2 batches and quantize, the cosine of the int8
    tokens against the folded bf16 encoder's on a third batch (logged, not
    asserted); (c) Evaluator.decode_batch with the tree in turns with the
    float encoder (float, int8, int8, float): captions/s, encode ms, each
    route's site launches a decode held to site_routes (100) and one pool
    launch, the other kernels' counts held to the serving prediction, token
    and caption agreement logged."""
    from icek_torch import bridge, eval_driver
    from icek_torch.data import images as image_ops
    from icek_torch.models import resnet, resnet_int8

    cfg, wm, params, enc = model
    rng = np.random.default_rng(SEED + 41)
    batches = [make_batch(rng, BATCH) for _ in range(INT8_CALIB_BATCHES + 1)]
    enc_dev = bridge.to_device(enc, dev)
    folded = resnet.fold_bn_params(enc_dev)
    size = cfg.model.encoded_image_size

    def images(b):
        return image_ops.normalize_in_graph(torch.as_tensor(b["raw_images"], device=dev))

    t0 = time.perf_counter()
    with torch.inference_mode():
        qtree = resnet_int8.calibrate_and_quantize(
            folded, (images(b) for b in batches[:INT8_CALIB_BATCHES]), torch.bfloat16,
            source_params=enc_dev)
    calib_s = time.perf_counter() - t0
    qdev = resnet_int8.to_device(qtree, dev)
    with torch.inference_mode():
        held = images(batches[-1])
        want = resnet.resnet_encode_folded(folded, held, size, torch.bfloat16).float()
        got = resnet_int8.resnet_encode_int8(qdev, held, size, torch.bfloat16).float()
    require(got.shape == want.shape == (BATCH, IMG_TOKENS, cfg.model.emb_dim)
            and bool(torch.isfinite(got).all()), "int8 tokens: shape or non-finite")
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    quality = dict(calibrate_s=calib_s, token_cosine_mean=float(cos.mean()),
                   token_cosine_min=float(cos.min()),
                   tensor_cosine=float(torch.nn.functional.cosine_similarity(
                       got.flatten(), want.flatten(), dim=0)))
    log(f"int8 encoder quality (bf16 folded encoder as reference, not asserted): {quality}")
    del held, want, got

    want_routes = resnet_int8.site_routes(qtree, IMG)
    n_sites = sum(want_routes.values())
    require(n_sites == sum(encode_sites().values()) and want_routes["mma_sync"] == 0,
            f"int8 serving: the tree's site routes {want_routes}")
    evs = {"float": eval_driver.Evaluator(cfg, wm, params, enc, device=dev),
           "int8": eval_driver.Evaluator(cfg, wm, params, enc, device=dev,
                                         encoder_qtree=qtree)}
    batch = batches[-1]
    ids = {k: ev.decode_batch(batch) for k, ev in evs.items()}          # warm-ups
    raw = torch.as_tensor(batch["raw_images"], device=dev)
    times = {k: [] for k in evs}
    enc_ms = {k: [] for k in evs}
    for kind in ("float", "int8", "int8", "float"):
        ev = evs[kind]
        _zero_serving_counts()
        _zero_int8_counts()
        t0 = time.perf_counter()
        out = ev.decode_batch(batch)
        times[kind].append(time.perf_counter() - t0)
        convs, pools = _int8_counts()
        routes = _int8_routes()
        launches = _read_serving_counts()
        want = serving_prediction(cfg, 1, 0)
        require(launches == want, f"int8 serving {kind}: launches {launches} != {want}")
        require((convs, pools) == ((n_sites, 1) if kind == "int8" else (0, 0)),
                f"int8 serving {kind}: {convs} site and {pools} pool launches")
        require(routes == (want_routes if kind == "int8" else dict.fromkeys(routes, 0)),
                f"int8 serving {kind}: site routes {routes}, predicted {want_routes}")
        require(np.array_equal(out, ids[kind]), f"int8 serving {kind}: not repeatable")
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev._encode_tokens(raw, "raw")
                torch.cuda.synchronize()
                enc_ms[kind].append((time.perf_counter() - t0) * 1e3)
    same = ids["int8"] == ids["float"]
    rec = {k: dict(batch_ms=[t * 1e3 for t in times[k]],
                   captions_per_s=BATCH / statistics.median(times[k]),
                   encode_ms=enc_ms[k], encode_ms_median=statistics.median(enc_ms[k]))
           for k in evs}
    rec.update(token_agreement=float(same.mean()),
               caption_agreement=float(same.all(axis=1).mean()),
               launches_per_batch=dict(int8_conv=n_sites, int8_maxpool=1, **want),
               routes_per_batch=want_routes)
    log(f"int8 encoder serving (geo, batch {BATCH}, beam {BEAM}, bf16 tail): {rec}")
    del evs
    return qtree, quality, rec


def int8_cli(dev, model, workdir):
    """(d) in-process through icek_torch.apps over an in-memory split (VAL
    512 rows, TEST 256): eval --encoder-int8 2 (calibrated on two VAL
    batches, an encode's site launches (100, encode_sites) for the
    TEST batch, a CSV row for every TEST row), quantize of the same two
    batches, eval --encoder-qtree with its file (the same CSV), and serve
    --encoder-qtree on port 0 with one POST /caption."""
    import http.client
    import threading

    from icek_torch import apps
    from icek_torch.models import resnet_int8
    from icek_torch.serve import server as server_lib
    from icek_torch.train import checkpoint as tckpt

    cfg, wm, params, enc = model
    base = cfg.data.base_name
    n_sites = sum(encode_sites().values())
    split_cls = run_split(np.random.default_rng(SEED + 51), wm,
                          rows={"TRAIN": 8, "VAL": 2 * BATCH, "TEST": BATCH})
    data_dir = os.path.join(workdir, "files")
    os.makedirs(data_dir)
    with open(os.path.join(data_dir, f"WORDMAP_{base}.json"), "w") as f:
        json.dump(wm.word_to_id, f)
    seeded = tckpt.save_checkpoint(os.path.join(workdir, "seeded"), base, 0, 0, 0.0,
                                   params, None, enc)
    common = ["--data-dir", data_dir, "--checkpoint", seeded, "--batch-size", str(BATCH),
              "--beam", str(BEAM), "--metric-data", os.path.join(workdir, "absent")]
    out = {}
    with _SplitsInMemory(split_cls):
        csv_int8 = os.path.join(workdir, "int8.csv")
        _zero_int8_counts()
        t0 = time.perf_counter()
        apps.run_eval("georic", common + ["--encoder-int8", str(INT8_CALIB_BATCHES),
                                          "--output", csv_int8])
        out["eval_int8_s"] = time.perf_counter() - t0
        out["eval_int8_launches"] = _int8_counts()
        rows = _csv_rows(csv_int8)
        require(len(rows) == BATCH + 1, f"eval --encoder-int8: {len(rows) - 1} CSV rows")
        require(out["eval_int8_launches"] == (n_sites, 1),
                f"eval --encoder-int8 launches {out['eval_int8_launches']}")
        tree = os.path.join(workdir, "encoder_int8.pt")
        t0 = time.perf_counter()
        apps.run_quantize("georic", ["--data-dir", data_dir, "--checkpoint", seeded,
                                     "--batches", str(INT8_CALIB_BATCHES),
                                     "--batch-size", str(BATCH), "--output", tree])
        out["quantize_s"] = time.perf_counter() - t0
        out["qtree_mb"] = os.path.getsize(tree) / 1e6
        resnet_int8.verify_qtree(resnet_int8.load_qtree(tree), enc)
        csv_tree = os.path.join(workdir, "qtree.csv")
        apps.run_eval("georic", common + ["--encoder-qtree", tree, "--output", csv_tree])
        out["qtree_csv_equals_int8_csv"] = _csv_rows(csv_tree) == rows
        made = []
        make = server_lib.make_server
        server_lib.make_server = lambda *a, **k: made.append(make(*a, **k)) or made[-1]
        thread = threading.Thread(target=apps.run_serve, daemon=True, args=("georic", [
            "--data-dir", data_dir, "--checkpoint", seeded, "--port", "0",
            "--max-batch", "8", "--encoder-qtree", tree]))
        try:
            _zero_int8_counts()
            thread.start()
            for _ in range(1200):
                if made or not thread.is_alive():
                    break
                thread.join(0.1)
            require(bool(made), "run_serve --encoder-qtree started no server")
            test = split_cls(data_dir, base, "TEST")
            row = test.batch(np.array([0]), raw_images=True)
            sample = {"raw_images": row["raw_images"][0],
                      "entity_features": row["entity_features"][0],
                      "entity_names": np.ascontiguousarray(test.arrays.entity_names[0])}
            conn = http.client.HTTPConnection(*made[0].server_address, timeout=300)
            conn.request("POST", "/caption", body=server_lib.encode_request(sample))
            resp = conn.getresponse()
            status, reply = resp.status, json.loads(resp.read())
            conn.close()
            out["serve_launches"] = _int8_counts()
        finally:
            server_lib.make_server = make
            if made:
                made[0].shutdown()
            thread.join(60)
    require(status == 200 and "caption" in reply, f"POST /caption: {status} {reply}")
    require(out["serve_launches"] == (n_sites, 1),
            f"serve --encoder-qtree launches {out['serve_launches']}")
    out["served_caption"] = reply.get("caption")
    log(f"int8 encoder CLIs: {out}")
    return out


def metrics_verb(csv_paths):
    """(e) python -m icek_torch.apps metrics over phase 7's geo and news CSVs
    against a synthetic captions_split.json of as many TEST images (tokens
    of the wordmap's words): the seven scores and the seconds."""
    import tempfile

    from icek_torch import apps

    out = {}
    rng = np.random.default_rng(SEED + 61)
    words = [f"w{i}" for i in range(50)] + ["place_1", "new_york", "1999"]
    with tempfile.TemporaryDirectory(prefix="icek_metrics_") as workdir:
        for preset, path in csv_paths.items():
            n = len(_csv_rows(path)) - 1
            images = [{"tokens": list(rng.choice(words, size=int(rng.integers(3, 12)))),
                       "split": "test", "id": f"img{i}"} for i in range(n)]
            splits = os.path.join(workdir, f"{preset}_split.json")
            with open(splits, "w") as f:
                json.dump({"images": images}, f)
            t0 = time.perf_counter()
            scores = apps.run_metrics(preset, ["--captions", path, "--splits", splits,
                                               "--output", os.path.join(workdir, "m.csv")])
            seconds = time.perf_counter() - t0
            rows = _csv_rows(os.path.join(workdir, "m.csv"))
            require(len(rows) == n + 1 and len(scores) == 7 and
                    all(math.isfinite(v) for v in scores.values()),
                    f"metrics {preset}: {len(rows) - 1} rows, {scores}")
            out[preset] = dict(scores=scores, seconds=seconds, captions=n)
    log(f"metrics verb: {out}")
    return out


def native_helpers():
    """(f) the g++ builds of icek_torch/native's fuzzy matcher and resizer,
    held against their Python paths on random names and images."""
    import random

    from icek_torch import native
    from icek_torch.data import codec, context, images

    t0 = time.perf_counter()
    require(native.available() and native.resize_available(), "native: g++ build failed")
    build_s = time.perf_counter() - t0
    rng = random.Random(SEED)
    names = ["".join(rng.choice("abcdefgh_") for _ in range(rng.randint(1, 20)))
             for _ in range(60)]
    index = context.entity_name_index([[i, len(n)] + codec.encode_name(n)
                                       for i, n in enumerate(names)])
    queries = names + ["".join(rng.choice("abcdefgh_") for _ in range(rng.randint(1, 25)))
                       for _ in range(120)]
    fast = [context.fuzzy_lookup_entity(q, index) for q in queries]
    real = native.available
    native.available = lambda: False
    try:
        slow = [context.fuzzy_lookup_entity(q, index) for q in queries]
    finally:
        native.available = real
    require(fast == slow, "native fuzzy matcher differs from the Python path")
    nrng = np.random.default_rng(SEED)
    ulps = []
    for hw in ((1066, 800), (300, 120), (120, 300), (100, 90)):
        img = nrng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
        a = native.resize_chw_f16(img, IMG, IMG).view(np.uint16).astype(np.int64)
        b = images.resize_like_reference(img, IMG, IMG).transpose(2, 0, 1).astype(
            np.float16).view(np.uint16)
        ulps.append(int(np.abs(a - b).max()))
        require(ulps[-1] <= 1, f"native resize {hw}: {ulps[-1]} float16 ulps from scipy")
    out = dict(build_s=build_s, fuzzy_queries=len(queries),
               fuzzy_hits=sum(x is not None for x in fast), resize_max_ulps=ulps)
    log(f"native helpers: {out}")
    return out


def int8_encoder(dev, models, csv_paths):
    """Phase 9: (a) the int8 site kernel and pool against their plain
    versions, (b, c) the int8 encoder serving beside float, (d) its CLIs,
    (e) the metrics verb, (f) the native helpers; the packages that prep's
    writer and the streaming loader need are looked for first, and what the
    machine lacks is named (the CPU tests hold those parts)."""
    import importlib.util
    import tempfile

    lacks = [m for m in ("h5py", "PIL", "scipy") if importlib.util.find_spec(m) is None]
    log(f"phase 9: this machine lacks {lacks or 'nothing'} "
        f"(h5py: prep's writer and the streaming loader; PIL: prep's image reads)")
    sites, per_encode, pool, refusals = check_int8_sites(dev)
    qtree, quality, serving = int8_serving(dev, models["georic"])
    del qtree
    with tempfile.TemporaryDirectory(prefix="icek_int8_") as workdir:
        cli = int8_cli(dev, models["georic"], workdir)
    return dict(sites=sites, per_encode=per_encode, pool=pool, library_refusals=refusals,
                quality=quality, serving=serving, cli=cli, metrics=metrics_verb(csv_paths),
                native=native_helpers(), lacks=lacks)


# --------------------------------------------------------------------------
# phase 10: the mesh on torch.distributed, a world of one on the card
# --------------------------------------------------------------------------

MESH_STEPS = 4
MESH_RUN_ROWS = {"TRAIN": 512, "VAL": 256, "TEST": 256}
MESH_CACHE_ROWS = 1024


def _opt_state_equal(a_state, a_params, b_state, b_params) -> list:
    """The Adam leaves (step count, moments) in which two states differ."""
    diffs = [] if a_state.step_count() == b_state.step_count() else ["step"]
    for i, (x, y) in enumerate(zip(a_state.moments(a_params), b_state.moments(b_params))):
        for (path, u), (_, v) in zip(_leaves_with_paths(x), _leaves_with_paths(y)):
            if not torch.equal(u, v):
                diffs.append((("mu", "nu")[i],) + path)
    return diffs


def mesh_step(dev, model, mesh):
    """(a) MESH_STEPS geo train steps at full width (batch 256, cached tokens,
    bf16, dropout on) through make_train_step(mesh=...) against the same
    steps without a mesh: params, losses and Adam state bit-equal, the
    training kernels' launches equal (each path's counts zeroed just before
    it and read just after).  Returns the launches and the mesh step's
    host ms."""
    from icek_torch import bridge
    from icek_torch.parallel import mesh as mesh_lib
    from icek_torch.train import step as step_lib

    cfg, wm, params, _ = model
    batch = make_train_batch(np.random.default_rng(SEED + 5), BATCH, wm)
    counted = train_counters()
    runs = {}
    for name in ("plain", "mesh"):
        p = copy.deepcopy(params)
        if name == "mesh":
            p, specs = mesh_lib.shard_params(p, mesh)
            rows = mesh_lib.shard_batch(batch, mesh)
        else:
            rows = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        p = bridge.trainable(p, dev)
        optimizer = step_lib.make_optimizer(cfg.train.decoder_lr, cfg.train.grad_clip)
        state = optimizer.init(p)
        train_step, _ = step_lib.make_train_step(
            cfg, VOCAB, wm.pad_id, optimizer, compute_dtype=torch.bfloat16,
            encode_images=False, device=dev, **({"mesh": mesh, "param_specs": specs}
                                                if name == "mesh" else {}))
        gen = torch.Generator().manual_seed(SEED)
        torch.cuda.synchronize()
        for fn, _ in counted.values():
            fn.launches = 0
        losses, times = [], []
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            _, _, loss, count = train_step(p, state, None, rows, gen)
            losses.append(float(loss))
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, (fn, _) in counted.items()}
        runs[name] = dict(params=p, state=state, losses=losses, count=int(count),
                          launches=launches, step_ms=times)
    a, b = runs["plain"], runs["mesh"]
    diffs = [path for (path, u), (_, v) in zip(_leaves_with_paths(a["params"]),
                                               _leaves_with_paths(b["params"]))
             if not torch.equal(u, v)]
    diffs += _opt_state_equal(a["state"], a["params"], b["state"], b["params"])
    rec = dict(losses=b["losses"], plain_losses=a["losses"], count=b["count"],
               launches=b["launches"], plain_launches=a["launches"], step_ms=b["step_ms"],
               plain_step_ms=a["step_ms"], differing=diffs[:20],
               # the first mesh step starts the NCCL communicators
               step_ms_median=statistics.median(b["step_ms"][1:]),
               plain_step_ms_median=statistics.median(a["step_ms"][1:]))
    log(f"mesh (a) train steps, (1, 1) NCCL mesh against no mesh: {rec}")
    require(not diffs and a["losses"] == b["losses"] and a["count"] == b["count"],
            f"mesh train steps differ from the steps without a mesh: {diffs[:20]}, "
            f"losses {b['losses']} vs {a['losses']}")
    require(b["launches"] == a["launches"]
            and all(v == per * MESH_STEPS for v, (_, per) in
                    zip(b["launches"].values(), counted.values())),
            f"mesh train launches {b['launches']} != {a['launches']}")
    return rec


def mesh_rows(dev):
    """(a') The dropout kernels keyed by global batch row, as a data shard of
    a wider mesh calls them: at the geo decoder's sites in bf16 (captions of
    32, d 300, FFN 512, 10 heads), rows 128.. of a batch of 256 under
    rows=(128, 256) give the whole batch's outputs and gradients for those
    rows, bit for bit."""
    from icek_torch.kernels import flash_attention as fa
    from icek_torch.kernels import fused_norm as fn

    g = torch.Generator().manual_seed(SEED + 45)
    B, b0, T, D, F, H = BATCH, BATCH // 2, CAP_LEN, 300, 512, 10
    b, bf16 = B - b0, torch.bfloat16
    x, h = (torch.randn((B, T, D), generator=g).to(dev, bf16) for _ in range(2))
    f = torch.randn((B, T, F), generator=g).to(dev, bf16)
    q, k, v = (torch.randn((B, T, H, D // H), generator=g).to(dev, bf16) for _ in range(3))
    scale, bias = torch.ones(D, device=dev), torch.zeros(D, device=dev)
    sites = {
        "dropout_add_ln": (lambda t, r: fn.dropout_add_ln(t[0], t[1], scale, bias, rate=RATE,
                                                          seed=61, rows=r), (x, h)),
        "hw_dropout": (lambda t, r: fn.hw_dropout(t[0], rate=RATE, seed=62, rows=r), (f,)),
        "flash_attention": (lambda t, r: fa.flash_mha(t[0], t[1], t[2], causal=True,
                                                      dropout_rate=RATE, seed=63, rows=r),
                            (q, k, v)),
    }
    out = {}
    for name, (call, inputs) in sites.items():
        whole = [t.clone().requires_grad_(True) for t in inputs]
        part = [t[b0:].clone().requires_grad_(True) for t in inputs]
        y_whole, y_part = call(whole, None), call(part, (b0, B))
        gy = torch.randn(y_whole.shape, generator=g).to(dev, bf16)
        y_whole.backward(gy)
        y_part.backward(gy[b0:])
        out[name] = bool(torch.equal(y_part, y_whole[b0:])) and all(
            torch.equal(p.grad, w.grad[b0:]) for p, w in zip(part, whole))
        # and not the masks of rows 0..: the offset changes what is dropped
        out[name + "_differs_from_rows_0"] = not torch.equal(
            call([t[b0:] for t in inputs], None), y_part)
    log(f"mesh (a') dropout kernels keyed by global row (rows {b0}.. of {B}, {b} rows): {out}")
    require(all(out.values()), f"the kernels' global-row masks differ: {out}")
    return out


def mesh_loop(dev, model, mesh, workdir):
    """(b) train.loop.train(mesh=...) for one epoch over an in-memory
    512 / 256-row split against the same run without a mesh: the epoch
    checkpoints bit-equal."""
    from icek_torch.train import loop as tloop

    cfg, wm, _, enc = model
    from icek_torch.train import checkpoint as tckpt

    enc_path = tckpt.save_encoder_tree(os.path.join(workdir, "encoder.pt"), enc,
                                       {"emb_dim": cfg.model.emb_dim})
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=BATCH, epochs=1))
    split_cls = run_split(np.random.default_rng(SEED + 41), wm, MESH_RUN_ROWS)
    base = cfg.data.base_name
    out = {}
    with _SplitsInMemory(split_cls):
        for name in ("plain", "mesh"):
            lines = []
            t0 = time.perf_counter()
            res = tloop.train(cfg, workdir, VOCAB, wm.pad_id,
                              checkpoint_dir=os.path.join(workdir, name), max_epochs=1,
                              log=lines.append, encoder_weights=enc_path, device=dev,
                              mesh=mesh if name == "mesh" else None)
            out[name] = dict(best_loss=res.best_loss, run_s=time.perf_counter() - t0,
                             cache=[s for s in lines if s.startswith("device token cache")])
    ckpt = f"checkpoint_0_{base}.pt"
    diffs = _checkpoint_diff(os.path.join(workdir, "plain", ckpt),
                             os.path.join(workdir, "mesh", ckpt))
    out["differing"] = diffs[:20]
    log(f"mesh (b) train loop, 1 epoch: {out}")
    require(not diffs, f"the mesh run's checkpoint differs in {len(diffs)} places: "
                       f"{diffs[:20]}")
    return out


def mesh_eval(dev, model, mesh, workdir):
    """(c) Evaluator(mesh=...).run over 256 geo rows against the run without
    a mesh: the CSVs equal, the serving kernels' launches equal."""
    from icek_torch import eval_driver

    cfg, wm, params, enc = model
    split_cls = memory_split(np.random.default_rng(SEED + 43), BATCH)
    out = {}
    for name in ("plain", "mesh"):
        ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev,
                                   mesh=mesh if name == "mesh" else None)
        path = os.path.join(workdir, f"{name}.csv")
        _zero_serving_counts()
        t0 = time.perf_counter()
        ev.run(split_cls(), output_csv=path, log=lambda *_: None)
        out[name] = dict(run_s=time.perf_counter() - t0, launches=_read_serving_counts(),
                         rows=len(_csv_rows(path)) - 1)
        del ev
    same = open(os.path.join(workdir, "plain.csv"), "rb").read() == \
        open(os.path.join(workdir, "mesh.csv"), "rb").read()
    out["csv_equal"] = same
    log(f"mesh (c) eval run, 256 rows: {out}")
    require(same and out["mesh"]["rows"] == BATCH, "the mesh eval CSV differs")
    require(out["mesh"]["launches"] == out["plain"]["launches"]
            == serving_prediction(cfg, 1, 0),
            f"mesh eval launches {out['mesh']['launches']} != {out['plain']['launches']}")
    return out


def mesh_gather(dev, mesh):
    """(d) A token cache of MESH_CACHE_ROWS geo rows row-sharded over the data
    axis (shard_rows, bf16) read by sharded_row_gather against a plain index
    of the cache, bit for bit."""
    from icek_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(SEED + 47)
    tokens = rng.standard_normal((MESH_CACHE_ROWS, IMG_TOKENS, 300),
                                 dtype=np.float32).astype(np.float16)
    block = mesh_lib.shard_rows(tokens, mesh, torch.bfloat16)
    rows = torch.as_tensor(rng.integers(0, MESH_CACHE_ROWS, (BATCH,)), device=dev)
    got = mesh_lib.sharded_row_gather(block, rows, mesh)
    want = torch.as_tensor(tokens).to(dev).to(torch.bfloat16)[rows]
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_lib.sharded_row_gather(block, rows, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rec = dict(equal=bool(torch.equal(got, want)), shape=list(got.shape),
               gather_ms=times, gather_ms_median=statistics.median(times))
    log(f"mesh (d) row-sharded token cache gather: {rec}")
    require(rec["equal"] and got.dtype == torch.bfloat16,
            "sharded_row_gather differs from a plain index of the cache")
    return rec


def utilization(model, train_summary, serving_summary, card) -> dict:
    """(e) The roofline (icek_torch/utils/roofline.py) over the geo train
    step's and the beam-5 batch's measured medians: the step's model FLOPs
    (train_step_flops, batch 256, T 32); the decode's FLOPs and floor bytes
    (decode_step_flops / decode_step_bytes over the 30 steps, beam 5) over
    the whole batch's time, and the whole pipeline's (eval_pipeline_costs,
    ResNet included)."""
    from icek_torch.utils import roofline

    cfg = model[0]
    m, s = cfg.model, preset_shape("georic")
    E, F, T, L = s["E"], s["F"], s["T"], s["L"]
    step_s = train_summary["step_ms_median"] / 1e3
    batch_s = statistics.median(serving_summary["batch_ms"]) / 1e3
    train_flops = BATCH * roofline.train_step_flops(m, VOCAB, E, F, T)
    dec_flops = BATCH * BEAM * sum(roofline.decode_step_flops(m, VOCAB, E, F, t)
                                   for t in range(1, L + 1))
    dec_bytes = BATCH * sum(roofline.decode_step_bytes(m, E, F, t, beam=BEAM)
                            for t in range(1, L + 1))
    pipe_flops, pipe_bytes = roofline.eval_pipeline_costs(m, VOCAB, E, F, BEAM, L)
    out = dict(
        peaks=roofline.chip_peaks(),
        train_step=dict(step_ms=step_s * 1e3, flops=train_flops,
                        **roofline.utilization(train_flops, step_s)),
        beam_decode=dict(batch_ms=batch_s * 1e3, flops=dec_flops, hbm_bytes=dec_bytes,
                         **roofline.utilization(dec_flops, batch_s, dec_bytes)),
        eval_pipeline=dict(flops=BATCH * pipe_flops, hbm_bytes=BATCH * pipe_bytes,
                           **roofline.utilization(BATCH * pipe_flops, batch_s,
                                                  BATCH * pipe_bytes)))
    log(f"card: {card}; mesh (e) utilization (roofline over the geo train step and "
        f"beam-5 batch medians): {json.dumps(out)}")
    require(out["train_step"].get("mfu_pct", 0) > 0 and
            out["beam_decode"].get("hbm_util_pct", 0) > 0,
            f"the roofline knows no peaks for {card}")
    return out


def mesh_phase(dev, models, train_summary, serving_summary, card) -> dict:
    """Phase 10: a (1, 1) mesh (a single-rank NCCL group on the card): (a)
    the geo train step, (b) the loop, (c) the eval run, (d) the row-sharded
    token cache's gather, each against the path without a mesh; (e) the
    roofline's utilization of the geo step and beam batch.  The group is
    destroyed at the end."""
    import tempfile

    from icek_torch.parallel import distributed
    from icek_torch.parallel import mesh as mesh_lib

    model = models["georic"]
    mesh = mesh_lib.make_mesh(1, 1, device=dev.type)
    try:
        log(f"phase 10: mesh {mesh}, backend {torch.distributed.get_backend()}")
        step = mesh_step(dev, model, mesh)
        rows = mesh_rows(dev)
        with tempfile.TemporaryDirectory(prefix="icek_mesh_") as workdir:
            loop = mesh_loop(dev, model, mesh, workdir)
            ev = mesh_eval(dev, model, mesh, workdir)
        gather = mesh_gather(dev, mesh)
    finally:
        distributed.shutdown()
    util = utilization(model, train_summary, serving_summary, card)
    return dict(step=step, rows=rows, loop=loop, eval=ev, gather=gather, utilization=util)


# --------------------------------------------------------------------------
# --mesh-world: the mesh across the cards of one host (torchrun, NCCL)
# --------------------------------------------------------------------------

WORLD_SHAPES = ((4, 1), (2, 2), (1, 4))
WORLD_BATCH, WORLD_STEPS, WORLD_LR = 64, 2, 1e-3


def _world_step(dev, model, mesh, batch, steps, dtype, cache=False):
    """`steps` geo train steps on `mesh` (None: this card alone) over the
    global `batch` (cached tokens; from a row-sharded cache with `cache`);
    returns every rank's view of the full params and Adam moments, the
    losses and the step times."""
    from icek_torch import bridge
    from icek_torch.parallel import mesh as mesh_lib
    from icek_torch.train import step as step_lib

    cfg, wm, params, _ = model
    p = copy.deepcopy(params)
    specs, kw = None, {}
    if mesh is None:
        rows = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    else:
        p, specs = mesh_lib.shard_params(p, mesh)
        rows = mesh_lib.shard_batch(batch, mesh)
        if cache:
            r0, b = mesh_lib.data_rows(mesh, len(batch["lengths"]))
            rows.pop("image_tokens")
            rows["token_rows"] = torch.arange(r0, r0 + b, device=dev)
            kw = dict(token_cache=mesh_lib.shard_rows(batch["image_tokens"], mesh, dtype),
                      token_cache_mesh=mesh)
    p = bridge.trainable(p, dev)
    optimizer = step_lib.make_optimizer(WORLD_LR, cfg.train.grad_clip)
    state = optimizer.init(p)
    train_step, _ = step_lib.make_train_step(
        cfg, VOCAB, wm.pad_id, optimizer, compute_dtype=dtype, encode_images=False,
        device=dev, mesh=mesh, param_specs=specs, **kw)
    gen = torch.Generator().manual_seed(SEED)
    losses, times = [], []
    full = (lambda t: t) if mesh is None else (  # noqa: E731
        lambda t: mesh_lib.gather_for_host(t, mesh, specs))
    cpu = lambda t: [x.detach().float().cpu().clone()  # noqa: E731
                     for _, x in _leaves_with_paths(full(t))]
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_step(p, state, None, rows, gen)[2]))
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            mu1 = cpu(state.moments(p)[0])
    mu, nu = state.moments(p)
    return dict(params=cpu(p), mu=cpu(mu), nu=cpu(nu), mu1=mu1, losses=losses,
                step_ms=times)


def _world_held(got, want, init) -> dict:
    """A mesh's steps against one card's, at tests/test_torch_mesh.py's
    tolerances: loss 1e-5 relative, Adam's first moment atol 1e-6, second
    1e-8; params 0.02 x lr where the first step's clipped gradient exceeds
    1e-6 (as tests/test_torch_train.py holds them) and the last first
    moment 50 x its tolerance (as tests/test_torch_loop.py does): Adam
    divides a moment by its root second moment, so a gradient near 0 or
    near eps in either step lets summation noise move the param by a
    fraction of lr; Adam's bound of steps x lr everywhere."""
    out = dict(loss_rel=max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
               mu=max(float((a - b).abs().max()) for a, b in zip(got["mu"], want["mu"])),
               nu=max(float((a - b).abs().max()) for a, b in zip(got["nu"], want["nu"])))
    solid = [(m1.abs() > 1e-7) & (m.abs() > 50 * 1e-6)
             for m1, m in zip(want["mu1"], want["mu"])]
    out["params_solid"] = max(float((a - b)[s].abs().max()) if s.any() else 0.0
                              for a, b, s in zip(got["params"], want["params"], solid))
    out["params_moved"] = max(float((a - p0).abs().max())
                              for a, p0 in zip(got["params"], init))
    out["ok"] = (out["loss_rel"] <= 1e-5 and out["mu"] <= 1e-6 and out["nu"] <= 1e-8
                 and out["params_solid"] <= 0.02 * WORLD_LR
                 and out["params_moved"] <= WORLD_STEPS * WORLD_LR * 1.02)
    return out


def mesh_world(kind="cuda") -> int:
    """``python -m torch.distributed.run --nproc-per-node 4 chip_smoke.py
    --mesh-world``: the mesh over four cards of one host, one NCCL rank a
    card.  Rank 0 builds the kernels, the others load them.  On each mesh of
    WORLD_SHAPES: two geo f32 train steps at full width (global batch 64,
    cached tokens, dropout on, its masks keyed by global row) against the
    same steps on card 0 alone, at the CPU tests' tolerances; (4, 1) again
    with the tokens from a cache row-sharded over the four data shards, bit
    for bit; the row-sharded gather of 256 rows against a plain index; the
    bf16 step of the main path at batch 256 a card over (4, 1) beside one
    card's batch-256 step (samples/s, losses logged); a beam-5 eval run over
    the world against card 0's (captions agreement logged).  Rank 0 prints
    one ``MESH4 {...}`` line; a failed check exits 1."""
    import torch.distributed as dist

    from icek_torch.kernels import _build
    from icek_torch.parallel import distributed
    from icek_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = distributed.maybe_initialize(force=True, device=kind)
    primary = info.is_primary
    if kind == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        if primary:
            _build.build_all()
        dist.barrier()
        _build.build_all()
        set_peaks()
    else:                                       # a rehearsal on gloo
        dev = torch.device("cpu")
    card = smi_name_power() if primary and kind == "cuda" else kind
    model = full_width_model()
    out, failed = {"world": info.count, "card": card}, []
    batch = make_train_batch(np.random.default_rng(SEED + 7), WORLD_BATCH, model[1])
    init = [t.detach().float().cpu() for _, t in _leaves_with_paths(model[2])]
    single = _world_step(dev, model, None, batch, WORLD_STEPS, torch.float32)
    for shape in WORLD_SHAPES:
        mesh = mesh_lib.make_mesh(*shape, device=kind)
        got = _world_step(dev, model, mesh, batch, WORLD_STEPS, torch.float32)
        held = _world_held(got, single, init)
        out[f"f32 {shape}"] = dict(held, losses=got["losses"], single=single["losses"])
        if not held["ok"]:
            failed.append(f"f32 mesh {shape}")
        if shape == (4, 1):
            cached = _world_step(dev, model, mesh, batch, WORLD_STEPS, torch.float32,
                                 cache=True)
            same = cached["losses"] == got["losses"] and all(
                torch.equal(a, b) for a, b in zip(cached["params"], got["params"]))
            out["row_sharded_cache_step_bit_equal"] = same
            if not same:
                failed.append("cached step")
            tokens = np.random.default_rng(SEED + 47).standard_normal(
                (1000, IMG_TOKENS, 300), dtype=np.float32).astype(np.float16)
            block = mesh_lib.shard_rows(tokens, mesh, torch.bfloat16)
            ids = np.random.default_rng(SEED + 48).integers(0, 1000, (BATCH,))
            r0, b = mesh_lib.data_rows(mesh, BATCH)
            local = torch.as_tensor(ids[r0:r0 + b], device=dev)
            gathered = mesh_lib.sharded_row_gather(block, local, mesh)
            want = torch.as_tensor(tokens[ids[r0:r0 + b]]).to(dev).to(torch.bfloat16)
            ok = torch.tensor(int(torch.equal(gathered, want)), device=dev)
            dist.all_reduce(ok)
            out["row_gather_bit_equal_ranks"] = int(ok)
            if int(ok) != info.count:
                failed.append("row gather")
            # the main path's step: bf16, batch 256 a card
            big = make_train_batch(np.random.default_rng(SEED + 5), BATCH * 4, model[1])
            world = _world_step(dev, model, mesh, big, 4, torch.bfloat16)
            alone = _world_step(dev, model, None, {k: v[:BATCH] for k, v in big.items()},
                                4, torch.bfloat16)
            w_ms = statistics.median(world["step_ms"][1:])
            a_ms = statistics.median(alone["step_ms"][1:])
            out["bf16 (4, 1) step"] = dict(
                step_ms=world["step_ms"], samples_per_s=4 * BATCH / w_ms * 1e3,
                one_card_step_ms=alone["step_ms"], one_card_samples_per_s=BATCH / a_ms * 1e3,
                scaling=(4 * BATCH / w_ms) / (BATCH / a_ms), losses=world["losses"])
            out["eval"] = _world_eval(dev, model, mesh, primary)
    if primary:
        log(f"card: {card}; mesh world: {json.dumps(out, default=str)}")
        print("MESH4 " + json.dumps({"ok": not failed, "failed": failed,
                                     "world": info.count}))
    distributed.shutdown()
    return 1 if failed else 0


def _world_eval(dev, model, mesh, primary) -> dict:
    """Evaluator.run over 256 geo rows across the world (64 rows a card)
    against card 0 alone: the share of equal captions (bf16 encodes and
    decodes batches of 64 and 256 with other algorithms, so equality is
    logged, not held)."""
    import tempfile

    from icek_torch import eval_driver

    cfg, wm, params, enc = model
    split_cls = memory_split(np.random.default_rng(SEED + 43), BATCH)
    with tempfile.TemporaryDirectory(prefix="icek_world_") as d:
        ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, mesh=mesh)
        t0 = time.perf_counter()
        res = ev.run(split_cls(), output_csv=os.path.join(d, "world.csv"),
                     log=lambda *_: None)
        world_s = time.perf_counter() - t0
        if not primary:
            return {}
        alone = eval_driver.Evaluator(cfg, wm, params, enc, device=dev)
        t0 = time.perf_counter()
        ref = alone.run(split_cls(), output_csv=os.path.join(d, "one.csv"),
                        log=lambda *_: None)
        one_s = time.perf_counter() - t0
    agree = float(np.mean([a == b for a, b in zip(res["captions"], ref["captions"])]))
    return dict(world_run_s=world_s, one_card_run_s=one_s, caption_agreement=agree,
                rows=len(res["captions"]))


# the op classes of profile_train_step that one geo train step must show
PROFILED_CLASSES = ("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd", "dropout")


def profile_summary(dev, step_once, card):
    """(e) The profiling tool's summary (icek_torch/tools/profile_train_step)
    of one geo train step, by op class: read from the card's kernels, with
    a total above 0 and every training kernel of the port in its class."""
    import tempfile

    from icek_torch.tools import profile_train_step as pts

    lines = []
    with tempfile.TemporaryDirectory(prefix="icek_profile_") as d:
        path = pts.trace(step_once, d, 1)
        source = pts.trace_ops(path)[0]
        total, rows = pts.summarize(path, 1, out=lines.append)
    for line in lines:
        log(f"card: {card}; profile_train_step, one geo step: {line}")
    classes = {name: count for name, (_, count) in rows}
    want = "device" if dev.type == "cuda" else "host"
    require(source == want and total > 0,
            f"profile_train_step read {source} time ({total} ms), not the {want}'s")
    missing = [c for c in PROFILED_CLASSES if not classes.get(c)]
    require(not missing, f"profile_train_step found no {missing} in one geo step: "
            f"{sorted(classes)}")


# --------------------------------------------------------------------------
# phase 5: card vs CPU at f32
# --------------------------------------------------------------------------

def cross_check(dev, model, preset="georic", decoder="decoder_step_f32"):
    from icek_torch import eval_driver
    from icek_torch.decode import greedy as greedy_lib
    from icek_torch.kernels import decoder_step as dsk
    from icek_torch.models import captioner
    from icek_torch.models import transformer as tfm

    cfg, wm, params, enc = model
    m = cfg.model
    batch = make_batch(np.random.default_rng(SEED + 9), 2, preset)
    L = preset_shape(preset)["L"]
    got, routes = {}, {}
    for where in (dev, "cpu"):
        ev = eval_driver.Evaluator(cfg, wm, params, enc, device=where,
                                   compute_dtype=torch.float32)
        with torch.inference_mode():
            raw = torch.as_tensor(batch["raw_images"], device=ev.device)
            ents = torch.as_tensor(batch["entity_features"], device=ev.device)
            facts = batch.get("fact_features")
            facts = None if facts is None else torch.as_tensor(facts, device=ev.device)
            tokens = ev._encode_tokens(raw, "raw")
            memory, ents_enc, facts_enc = captioner.encode_memory(ev.params, m, tokens, ents,
                                                                  facts)
            ctx = greedy_lib.prepare_decode_context(ev.params, m, tokens, ents, facts)
            K, D = BEAM, m.emb_dim
            start = torch.full((2, K), wm.start_id, device=ev.device)
            x = (captioner.embed_captions(ev.params, VOCAB, wm.pad_id, start,
                                          torch.zeros_like(start), ents_enc)
                 * math.sqrt(D) + torch.as_tensor(tfm.sinusoidal_positions(1, D)[0],
                                                  device=ev.device))
            caches = torch.zeros((m.num_layers, 2, L * K, D), device=ev.device)
            anc = torch.arange(K, device=ev.device)[None, :, None].expand(2, K, L)
            stacked = dsk.stack_decoder_params(ev.params["decoder"])
            ck, cv = dsk.stack_cross_kv(ctx.cross_kvs, torch.float32)
            h, _, _ = dsk.fused_beam_decoder_step(stacked, x, anc.contiguous(), caches,
                                                  caches.clone(), ck, cv, 0,
                                                  num_heads=m.num_heads)
            ind = {}
            if m.has_facts:     # nothing is seen before the first step
                ind = dict(fact_before=torch.zeros((2, K, facts.shape[1]), device=ev.device),
                           predicate_indicator=torch.zeros((2, K, m.num_predicates),
                                                           device=ev.device))
            scores = captioner.copy_scores(ev.params, m, h, ents_enc, facts_enc, **ind)
        _zero_serving_counts()
        zero_route_counts()
        ids = ev.decode_batch(batch)
        if where is dev:        # the f32 beam-5 decode on the f32 tensor-core routes
            launches = {k: v for k, v in _read_serving_counts().items() if k in DECODER_ROUTES}
            want = decoder_launches(**{decoder: L})
            require(launches == want, f"{preset} f32 decode: decoder-step launches {launches} "
                                      f"!= {want}")
            routes["decoder"] = launches
            layers = m.num_layers * (2 if m.has_facts else 1)
            routes["beam"] = route_counts()
            want = route_prediction(flash_tf32=layers, score_tensor_cores=L)
            require(routes["beam"] == want, f"{preset} f32 beam-5 decode: routes "
                                            f"{routes['beam']} != {want}")
            # greedy in f32: the score head's f32 tensor-core pass each step
            zero_route_counts()
            eval_driver.Evaluator(cfg, wm, params, enc, device=dev, compute_dtype=torch.float32,
                                  beam_size=1).decode_batch(batch)
            routes["greedy"] = route_counts()
            require(routes["greedy"] == want, f"{preset} f32 greedy decode: routes "
                                              f"{routes['greedy']} != {want}")
        got[where] = [t.cpu() for t in (tokens, memory, scores)] + [ids]
    names = ("image tokens", "memory", "first-step scores")
    errs = {}
    for i, name in enumerate(names):
        a, b = got[dev][i], got["cpu"][i]
        scale = float(b.abs().max())
        errs[name] = float((a - b).abs().max()) / max(scale, 1e-30)
        require(errs[name] <= 1e-4, f"{preset} card vs CPU {name}: rel err {errs[name]} > 1e-4")
    agree = float((got[dev][3] == got["cpu"][3]).mean())
    log(f"{preset} card vs CPU at f32 (max abs err / max |cpu|, tol 1e-4): {errs}; "
        f"beam-5 token agreement {agree:.3f}; routes {routes}")
    require(agree == 1.0, f"{preset}: the card's f32 beam-5 tokens differ from the CPU's "
                          f"(agreement {agree})")
    return errs, agree, routes


# --------------------------------------------------------------------------
# phase 6: train steps at full width
# --------------------------------------------------------------------------

def train_captions(rng, n, wm, preset="georic"):
    from icek_torch.tools import _synthetic

    return _synthetic.train_captions(rng, n, wm, preset)


def make_train_batch(rng, n, wm, preset="georic", D=None):
    """Training rows with entity (and fact) rows and cached image tokens
    (of width D: the preset's by default)."""
    from icek_torch.tools import _synthetic

    return _synthetic.train_batch(rng, n, wm, preset, D)


def run_train_path(dev, model, preset="georic", steps=TRAIN_STEPS):
    from icek_torch import bridge
    from icek_torch.models import captioner
    from icek_torch.train import step as step_lib

    cfg, wm, params, _ = model
    m = cfg.model
    T = preset_shape(preset)["T"]
    require((m.dropout_enc, m.dropout_dec, m.dropout_pos) == (0.2, 0.2, 0.1),
            "the train path runs the preset's dropout rates")
    params = bridge.trainable(copy.deepcopy(params), dev)
    optimizer = step_lib.make_optimizer(cfg.train.decoder_lr, cfg.train.grad_clip)
    opt_state = optimizer.init(params)
    train_step, eval_step = step_lib.make_train_step(
        cfg, VOCAB, wm.pad_id, optimizer, compute_dtype=torch.bfloat16,
        encode_images=False, device=dev)
    batch = make_train_batch(np.random.default_rng(SEED + 5), BATCH, wm, preset, m.emb_dim)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(SEED)
    counted = train_counters(preset)

    eval_before = float(eval_step(params, None, batch)[0])
    t0 = time.perf_counter()
    _, _, loss, count = train_step(params, opt_state, None, batch, gen)     # warm-up
    losses = [float(loss)]
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counted.values():
        fn.launches = 0
    zero_route_counts()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, _, loss, count = train_step(params, opt_state, None, batch, gen)
        losses.append(float(loss))            # reading the loss waits for the step
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, (fn, _) in counted.items()}
    # every forward on the bf16 tensor-core kernels, at any head dim (on
    # wgmma above 32 dims)
    routes = route_counts()
    flash_n = counted["flash_attention"][1] * steps
    want_routes = route_prediction(flash_mma=flash_n,
                                   flash_wgmma=flash_n if wide_heads(m) else 0)
    require(routes == want_routes, f"{preset} bf16 train step: routes {routes} != {want_routes}")
    # and every backward on the bf16 tensor-core pair
    bwd_routes = bwd_route_counts()
    want_bwd = {"mma": counted["flash_attention_bwd"][1] * steps, "tf32": 0}
    require(bwd_routes == want_bwd,
            f"{preset} bf16 train step: backward routes {bwd_routes} != {want_bwd}")
    # ... on the pair of the model's head dim (at 128 the wgmma pair, none on
    # the mma.sync pair it replaced)
    bwd_pairs = bwd_pair_counts()
    want_pairs = bwd_pair_prediction(m, torch.bfloat16, want_bwd["mma"])
    require(bwd_pairs == want_pairs,
            f"{preset} bf16 train step: backward pairs {bwd_pairs} != {want_pairs}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_after = float(eval_step(params, None, batch)[0])
    log(f"{preset} train path launches over {steps} steps: {launches}")
    for name, (_, per_step) in counted.items():
        require(launches[name] == per_step * steps,
                f"{preset} kernel {name}: {launches[name]} launches, expected "
                f"{per_step} x {steps}")
    require(all(math.isfinite(l) for l in losses), f"non-finite loss in {losses}")
    require(math.isfinite(eval_after) and eval_after < eval_before,
            f"{preset} eval loss did not fall: {eval_before} -> {eval_after}")

    # one more step, stage by stage (each synchronised)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    def forward():
        scores = captioner.captioner_forward(
            params, m, VOCAB, wm.pad_id, batch["caption_ids"], batch["caption_mask"],
            batch["image_tokens"].to(torch.bfloat16), batch["entity_features"],
            batch.get("fact_features"), gen=gen, deterministic=False,
            compute_dtype=torch.bfloat16, score_dtype=torch.bfloat16)
        return step_lib.caption_loss(scores, batch["caption_ids"], batch["lengths"],
                                     wm.pad_id)[0]

    loss = timed("forward_ms", forward)
    timed("backward_ms", loss.backward)
    timed("optimizer_ms", lambda: optimizer.update(opt_state))

    summary = dict(
        warmup_s=warm_s, step_ms=[t * 1e3 for t in times],
        step_ms_median=statistics.median(times) * 1e3,
        samples_per_s_median=BATCH / statistics.median(times),
        tokens_per_step=int(count), losses=losses, eval_loss_before=eval_before,
        eval_loss_after=eval_after, peak_mem_gb=peak_gb, routes=routes,
        bwd_routes=bwd_routes, bwd_pairs=bwd_pairs, **stages)
    log(f"{preset} train path (batch {BATCH}, T {T}, bf16, dropout on): {summary}")
    return launches, summary, lambda: float(train_step(params, opt_state, None, batch, gen)[2])


F32_STEPS = 3


# the batch of the dropout-0 step held to the CPU's (f32_train_path, oracle "cpu")
CPU_ORACLE_BATCH = 64


def f32_train_path(dev, model, bf16_summary, oracle="plain"):
    """Phase 6's f32 geo train step: batch 256, cached tokens, captions of 32,
    the preset's dropout, compute dtype float32 (the flash forward's and
    backward's TF32 kernels at every attention site), one warm-up and
    F32_STEPS timed steps beside the bf16 step's samples/s; launches held to
    the prediction (9 flash forward launches a step, all on the TF32 route,
    and 9 backward launches) and the eval loss must fall.  The plain
    path draws its masks from its own generator, so the same step at dropout
    0 is held to it instead: one step each from the same parameters, the
    loss within 1e-4 and Adam's first moments (0.1 x the clipped gradients)
    within 1e-3 over the whole tree (relative L2), each leaf's worst element
    logged.  With `oracle` "cpu" that step is held to the plain path on the
    CPU instead, both at CPU_ORACLE_BATCH rows: at --geometry 512x8 the
    card's plain path is the one off (on an H100: 4.96e-3 from the CPU in
    the tree, 99.8% of it in decoder layer 0's self-attention weights,
    where the kernels are 2.80e-4 from the CPU)."""
    from icek_torch import bridge
    from icek_torch.train import step as step_lib

    cfg, wm, params, _ = model
    rows = make_train_batch(np.random.default_rng(SEED + 5), BATCH, wm, D=cfg.model.emb_dim)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in rows.items()}

    def make(c, where=dev):
        p = bridge.trainable(copy.deepcopy(params), where)
        optimizer = step_lib.make_optimizer(c.train.decoder_lr, c.train.grad_clip)
        state = optimizer.init(p)
        return (p, state) + step_lib.make_train_step(
            c, VOCAB, wm.pad_id, optimizer, compute_dtype=torch.float32,
            encode_images=False, device=where)

    p, state, train_step, eval_step = make(cfg)
    gen = torch.Generator().manual_seed(SEED)
    counted = train_counters()
    eval_before = float(eval_step(p, None, batch)[0])
    losses = [float(train_step(p, state, None, batch, gen)[2])]        # warm-up
    for fn, _ in counted.values():
        fn.launches = 0
    zero_route_counts()
    times = []
    for _ in range(F32_STEPS):
        t0 = time.perf_counter()
        losses.append(float(train_step(p, state, None, batch, gen)[2]))
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, (fn, _) in counted.items()}
    routes = route_counts()
    # every forward on the TF32 kernel, none on the CUDA-core one it replaced
    want = route_prediction(flash_tf32=counted["flash_attention"][1] * F32_STEPS)
    require(routes == want, f"f32 train step: routes {routes} != {want}")
    bwd_routes = bwd_route_counts()
    want_bwd = {"mma": 0, "tf32": counted["flash_attention_bwd"][1] * F32_STEPS}
    require(bwd_routes == want_bwd, f"f32 train step: backward routes {bwd_routes} != {want_bwd}")
    bwd_pairs = bwd_pair_counts()
    want_pairs = bwd_pair_prediction(cfg.model, torch.float32, want_bwd["tf32"])
    require(bwd_pairs == want_pairs, f"f32 train step: backward pairs {bwd_pairs} != {want_pairs}")
    eval_after = float(eval_step(p, None, batch)[0])
    for name, (_, per_step) in counted.items():
        require(launches[name] == per_step * F32_STEPS,
                f"f32 train step kernel {name}: {launches[name]} launches, expected "
                f"{per_step} x {F32_STEPS}")
    require(all(math.isfinite(l) for l in losses) and eval_after < eval_before,
            f"f32 train step: losses {losses}, eval loss {eval_before} -> {eval_after}")
    del p, state, train_step, eval_step

    cfg0 = cfg.replace(model=dataclasses.replace(
        cfg.model, dropout_enc=0.0, dropout_dec=0.0, dropout_pos=0.0))
    plain0 = cfg0.replace(model=dataclasses.replace(cfg0.model, use_flash_attention=False))
    n0 = BATCH if oracle == "plain" else CPU_ORACLE_BATCH
    res = {}
    for name, c, where in (("kernels", cfg0, dev),
                           ("plain", plain0, dev if oracle == "plain" else "cpu")):
        p, state, train_step, _ = make(c, where)
        b = {k: torch.as_tensor(v[:n0], device=where) for k, v in rows.items()}
        flash_before = counted["flash_attention_bwd"][0].launches
        loss = float(train_step(p, state, None, b, torch.Generator().manual_seed(0))[2])
        flash_bwd = counted["flash_attention_bwd"][0].launches - flash_before
        mu, _ = state.moments(p)
        res[name] = (loss, [t.float().cpu() for t in step_lib.tree_leaves(mu)], flash_bwd)
        del p, state, train_step
    (l_k, g_k, n_k), (l_p, g_p, n_p) = res["kernels"], res["plain"]
    require((n_k, n_p) == (counted["flash_attention_bwd"][1], 0),
            f"f32 dropout-0 steps: flash backward launches {n_k} / {n_p}")
    loss_rel = abs(l_k - l_p) / abs(l_p)
    tree_rel = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(g_k, g_p))
                         / sum(float((b ** 2).sum()) for b in g_p))
    # logged, not held: train_cross_check's per-leaf measure; a ReLU unit whose
    # input lies within the two forwards' rounding of 0 passes its gradient in
    # one path and not the other, which puts percent-level differences into
    # a few elements (the CUDA-core backward this route replaced gave the
    # same ones)
    top = max(float(g.abs().max()) for g in g_p)
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 0.01 * top)
                   for a, b in zip(g_k, g_p))
    require(loss_rel <= 1e-4 and tree_rel <= 1e-3,
            f"f32 dropout-0 step: loss rel {loss_rel} (tol 1e-4), gradient tree rel L2 "
            f"{tree_rel} (tol 1e-3)")
    summary = dict(step_ms=[t * 1e3 for t in times],
                   step_ms_median=statistics.median(times) * 1e3,
                   samples_per_s_median=BATCH / statistics.median(times),
                   bf16_samples_per_s_median=bf16_summary["samples_per_s_median"],
                   launches=launches, routes=routes, bwd_routes=bwd_routes,
                   bwd_pairs=bwd_pairs, losses=losses,
                   eval_loss_before=eval_before, eval_loss_after=eval_after,
                   dropout0_loss_rel=loss_rel, dropout0_oracle=f"{oracle} at batch {n0}",
                   dropout0_grad_tree_rel=tree_rel, dropout0_worst_leaf_rel=grad_rel)
    log(f"f32 geo train path (batch {BATCH}, T {CAP_LEN}, float32, dropout on): {summary}")
    return summary


def train_cross_check(dev, model, preset="georic"):
    """A 2-sample f32 step without dropout on the card against the same step
    on the CPU: loss, and Adam's first moments (0.1 x the clipped gradients)
    leaf by leaf relative to the leaf's largest value (at least 1% of the
    tree's largest, so leaves whose true gradient is 0 do not compare noise)."""
    from icek_torch import bridge
    from icek_torch.train import step as step_lib

    cfg, wm, params, _ = model
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, dropout_enc=0.0, dropout_dec=0.0, dropout_pos=0.0))
    batch = make_train_batch(np.random.default_rng(SEED + 6), 2, wm, preset, cfg.model.emb_dim)
    res = {}
    for where in ("cpu", dev):
        p = bridge.trainable(copy.deepcopy(params), where)
        optimizer = step_lib.make_optimizer(cfg.train.decoder_lr, cfg.train.grad_clip)
        state = optimizer.init(p)
        train_step, _ = step_lib.make_train_step(
            cfg, VOCAB, wm.pad_id, optimizer, compute_dtype=torch.float32,
            encode_images=False, device=where)
        _, _, loss, _ = train_step(p, state, None, batch, torch.Generator().manual_seed(0))
        mu, _ = state.moments(p)
        res[where] = (float(loss), [t.cpu() for t in step_lib.tree_leaves(mu)])
    (l_cpu, g_cpu), (l_dev, g_dev) = res["cpu"], res[dev]
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    top = max(float(g.abs().max()) for g in g_cpu)
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 0.01 * top)
                   for a, b in zip(g_dev, g_cpu))
    log(f"{preset} train step, card vs CPU at f32, 2 samples, no dropout: loss {l_dev} vs "
        f"{l_cpu} (rel {loss_rel}); worst leaf gradient rel err {grad_rel} (tol 1e-4)")
    require(loss_rel <= 1e-4 and grad_rel <= 1e-4, f"{preset}: card vs CPU train step disagrees")
    return loss_rel, grad_rel


# --------------------------------------------------------------------------
# phase 6b: the geo model at --geometry 512x8 (heads of 64), train and serve
# --------------------------------------------------------------------------

GEOMETRY = "512x8"      # the Transformer-base width: D 512, 8 heads of 64
GEOMETRY_TRAIN_STEPS = 3


def geometry_path(dev):
    """The geo preset at --geometry 512x8 (D 512, 8 heads of 64, 3 layers,
    FFN 512, seeded weights, its own ResNet-101 projecting to 512) through
    the entry points, with the kernel routes held: beam-5 serving of batches
    of 256 through Evaluator.decode_batch (serve: every flash forward on the
    bf16 wgmma forward, the score head's tensor-core pass, the decoder step
    on its tensor-core route with the cross heads padded to 64, 30 a batch
    and none on the CUDA-core kernel; bf16 token agreement with the stock
    step logged); the f32 Evaluators on the card and on the CPU
    (cross_check: f32 beam tokens equal, the flash forwards on the TF32
    kernels, the decoder step on its f32 tensor-core route); an f32 beam-5
    batch of 256 (f32_serving: 30 f32 tensor-core steps a batch); bf16 train
    steps at batch 256 with the preset's dropout (run_train_path: forwards
    on mma, the encoder's on wgmma, one backward launch each, the wgmma
    backward pair reading the wgmma forward's lse and keep bits); the f32 step
    (f32_train_path: TF32 forwards and backwards, at dropout 0 held to the
    CPU's step over the gradient tree); and the decoder step at this width
    on each dtype's route.  Returns its records."""
    model = full_width_model(geometry=GEOMETRY)
    m = model[0].model
    require((m.emb_dim, m.num_heads, m.num_layers) == (512, 8, 3),
            f"--geometry {GEOMETRY}: D {m.emb_dim}, {m.num_heads} heads, {m.num_layers} layers")
    label = f"geo {GEOMETRY}"
    # heads of 64: both dtypes on the tensor cores (pad 64)
    launches, serving, _ = serve(dev, model, decoder="decoder_step", label=label)
    checked = cross_check(dev, model, decoder="decoder_step_f32")
    f32_serve = f32_serving(dev, model, label)
    train_launches, train, _ = run_train_path(dev, model, steps=GEOMETRY_TRAIN_STEPS)
    f32 = f32_train_path(dev, model, train, oracle="cpu")
    step = check_decoder_step_geometry(
        dev, GEOMETRY, want_routes={torch.bfloat16: "tensor_cores",
                                    torch.float32: "tensor_cores_f32"})
    del model
    rec = dict(serving=serving, serving_launches=launches, f32_check=checked,
               f32_serving=f32_serve, train=train, train_launches=train_launches, f32_train=f32,
               decoder_step=step)
    log(f"{label} path: captions/s {serving['captions_per_s_median']}, f32 captions/s "
        f"{f32_serve['captions_per_s_median']}, bf16 samples/s "
        f"{train['samples_per_s_median']}, f32 samples/s {f32['samples_per_s_median']}")
    return rec


# --------------------------------------------------------------------------
# phase 6c: the geo model at --geometry 512x4 (heads of 128), train
# --------------------------------------------------------------------------

GEOMETRY_HD128 = "512x4"     # D 512 as 512x8, 4 heads of 128: the flash backward at HDP 128


def geometry_hd128_path(dev):
    """The geo preset at --geometry 512x4 (D 512, 4 heads of 128, 3 layers,
    FFN 512, seeded weights) trained through the entry points: bf16 train
    steps at batch 256 with the preset's dropout (run_train_path: every
    forward on the wgmma forward, every backward on the HDP-128 wgmma pair
    reading its lse and keep bits, none on another pair) and the f32 step
    (f32_train_path: the TF32 forward and the HDP-128 TF32 pair; at dropout
    0 held to the CPU's step over the gradient tree, as 512x8's).  No serving: a 512x4 beam loop
    would run the CUDA-core decoder step (heads above 64 dims).  Returns its
    records."""
    model = full_width_model(geometry=GEOMETRY_HD128)
    m = model[0].model
    require((m.emb_dim, m.num_heads, m.num_layers) == (512, 4, 3),
            f"--geometry {GEOMETRY_HD128}: D {m.emb_dim}, {m.num_heads} heads, "
            f"{m.num_layers} layers")
    t0 = time.perf_counter()
    train_launches, train, _ = run_train_path(dev, model, steps=GEOMETRY_TRAIN_STEPS)
    f32 = f32_train_path(dev, model, train, oracle="cpu")
    del model
    rec = dict(train=train, train_launches=train_launches, f32_train=f32,
               phase_s=time.perf_counter() - t0)
    log(f"geo {GEOMETRY_HD128} path: bf16 samples/s {train['samples_per_s_median']} "
        f"(step {train['step_ms_median']} ms), f32 samples/s {f32['samples_per_s_median']} "
        f"(step {f32['step_ms_median']} ms); backward pairs {train['bwd_pairs']} / "
        f"{f32['bwd_pairs']}")
    return rec


def f32_serving(dev, model, label):
    """The f32 beam-5 batch of 256 through Evaluator.decode_batch: a warm-up,
    then three timed batches (host clock, from the numpy batch to the ids),
    the decoder step's launches held to L a batch on its f32 tensor-core
    route and none on any other, the upload / encode / context / decode
    breakdown of one batch, and (logged, not asserted) its beam-5 token
    agreement with the stock f32 step on the same batch."""
    from icek_torch import eval_driver

    cfg, wm, params, enc = model
    L = cfg.decode.max_caption_len
    ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, compute_dtype=torch.float32)
    require(ev.batch_size == BATCH, f"{label} f32 serving: batch {ev.batch_size}")
    rng = np.random.default_rng(SEED + 13)
    batches = [make_batch(rng, BATCH) for _ in range(4)]
    ev.decode_batch(batches[0])                                  # warm-up
    _zero_serving_counts()
    times = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        out = ev.decode_batch(b)
        times.append((time.perf_counter() - t0) * 1e3)
        require(out.shape == (BATCH, L) and out.min() >= 0 and out.max() < VOCAB + ENT_ROWS,
                f"{label} f32 serving: ids {out.shape}, {out.min()}..{out.max()}")
    launches = {k: v for k, v in _read_serving_counts().items() if k in DECODER_ROUTES}
    want = decoder_launches(decoder_step_f32=L * len(times))
    require(launches == want, f"{label} f32 beam-5 batches: decoder-step launches {launches} "
                              f"!= {want}")
    ms = statistics.median(times)
    rec = dict(batch_ms=times, batch_ms_median=ms, captions_per_s_median=BATCH / ms * 1e3,
               decoder_launches_per_batch={k: v // len(times) for k, v in launches.items()},
               breakdown=breakdown(ev, batches[1]),
               stock_step_agreement=megakernel_agreement(ev, batches[1]))
    log(f"{label} f32 serving (batch {BATCH}, beam {BEAM}, L {L}): {rec}")
    return rec


# --------------------------------------------------------------------------
# after the phases: one traced train step and one traced beam-5 batch
# --------------------------------------------------------------------------

PORT_KERNELS = ("flash_fwd", "flash_bwd", "ln_fwd", "ln_bwd", "dropout_",
                "score_partial", "score_merge", "decoder_step_kernel", "decoder_step_mma_kernel")


def trace_device(what, fn):
    """Run `fn` once under torch.profiler and log the ten device operations
    that took most time and the device's idle share (1 - the union of the
    device operations' intervals over the host's wall time, which includes
    the profiler's own cost).  Instrumentation only: whatever goes wrong here
    is logged and the run goes on."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
        if not spans:
            log(f"trace of {what}: torch.profiler recorded no device operation")
            return
        by_name, busy_us, reach = {}, 0.0, spans[0][0]
        for start, end, name in spans:
            n, total = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, total + (end - start))
            busy_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
        span_ms = (reach - spans[0][0]) / 1e3
        log(f"trace of {what}: host wall {wall_ms:.2f} ms under the profiler, "
            f"{len(spans)} device operations, device busy {busy_us / 1e3:.2f} ms, "
            f"first to last device operation {span_ms:.2f} ms, idle share "
            f"{1 - busy_us / 1e3 / wall_ms:.3f} of the wall, "
            f"{1 - busy_us / 1e3 / span_ms:.3f} of the device span")
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
        for name, (n, total) in ranked[:10]:
            log(f"  trace {what}: {total / 1e3:8.3f} ms {n:5d} x {name[:110]}")
        # the port's own kernels by template instance, whatever their rank: the
        # device time of launches too short for phase 3's event timing to see
        for name, (n, total) in ranked:
            if any(k in name for k in PORT_KERNELS):
                short = name.split("(anonymous namespace)::", 1)[-1].split("(")[0]
                log(f"  trace {what}, port kernel: {total / 1e3:8.3f} ms {n:5d} x {short}")
    except Exception as e:                       # noqa: BLE001
        log(f"trace of {what}: torch.profiler failed: {type(e).__name__}: {e}")


def trace_serving(dev, model, batch, preset="georic"):
    """One beam-5 batch under the profiler, through an Evaluator of its own
    (the timed one is gone, so that it does not weigh on the train path's
    peak memory), warmed by one batch first."""
    from icek_torch import eval_driver

    cfg, wm, params, enc = model
    ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev)
    ev.decode_batch(batch)
    what = "one beam-5 batch" if preset == "georic" else f"one {preset} beam-5 batch"
    trace_device(what, lambda: ev.decode_batch(batch))


def norm_wrapper_host_ms(dev, N=13312) -> dict:
    """Host ms a call of the three norm wrappers at N rows (bf16; the news
    decoder's rows), called as the train step calls them, while the device
    runs ahead."""
    from icek_torch.kernels import fused_norm as fn

    x, h, gy, scale, bias, rnd = _norm_inputs(dev, torch.bfloat16, N)
    leaves = [t.detach().requires_grad_(True) for t in (x, h, scale, bias)]
    hf = rnd(N, 512).to(torch.bfloat16).requires_grad_(True)
    s32 = scale.float().contiguous()
    return {"dropout_add_ln": host_ms(lambda: fn.dropout_add_ln(*leaves, rate=RATE, seed=55),
                                      iters=50),
            "dropout_add_ln_bwd": host_ms(
                lambda: fn.dropout_add_ln_bwd(x, h, s32, gy, RATE, 55, 1e-5), iters=50),
            "hw_dropout": host_ms(lambda: fn.hw_dropout(hf, rate=RATE, seed=56), iters=50)}


def norm_kernels_device_ms(dev) -> dict:
    """Device ms a call of the three norm kernels (forward, backward kernel
    and reduction, dropout) at every train-step row count, bf16 and f32,
    each in a profiler session of its own: one code for any tree."""
    from icek_torch.kernels import fused_norm as fn

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for N in norm_rows():
            x, h, gy, scale, bias, rnd = _norm_inputs(dev, dtype, N)
            hf = rnd(N, 512).to(dtype)
            s32 = scale.float().contiguous()
            out[f"{str(dtype)[6:]} {N}"] = dict(
                forward=device_split(lambda: fn.dropout_add_ln(x, h, scale, bias, rate=RATE,
                                                               seed=55), ("ln_fwd",)).get("ln_fwd"),
                backward=device_split(lambda: fn.dropout_add_ln_bwd(x, h, s32, gy, RATE, 55, 1e-5),
                                      ("ln_bwd",)).get("ln_bwd"),
                dropout=device_split(lambda: fn.hw_dropout(hf, rate=RATE, seed=56),
                                     ("dropout",)).get("dropout"))
    return out


def paired_int8_serving(dev, model, batches):
    """int8 geo beam-5 serving at BATCH through the public entry points: a
    tree calibrated on batches[0] (bf16), a warm-up decode, then 3 batches'
    ms and 3 encodes' ms (Evaluator._encode_tokens, synchronized), and a
    hash of the first timed batch's ids (equal trees' int8 decodes equal)."""
    import hashlib

    from icek_torch import bridge, eval_driver
    from icek_torch.data import images as image_ops
    from icek_torch.models import resnet, resnet_int8

    cfg, wm, params, enc = model
    with torch.inference_mode():
        enc_dev = bridge.to_device(enc, dev)
        folded = resnet.fold_bn_params(enc_dev)
        raw = image_ops.normalize_in_graph(torch.as_tensor(batches[0]["raw_images"], device=dev))
        qtree = resnet_int8.calibrate_and_quantize(folded, [raw], torch.bfloat16,
                                                   source_params=enc_dev)
    ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, encoder_qtree=qtree)
    ev.decode_batch(batches[0])
    batch_ms, ids = [], None
    for b in batches[1:]:
        t0 = time.perf_counter()
        out = ev.decode_batch(b)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        ids = out if ids is None else ids
    raw_images = torch.as_tensor(batches[1]["raw_images"], device=dev)
    encode_ms = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev._encode_tokens(raw_images, "raw")
            torch.cuda.synchronize()
            encode_ms.append((time.perf_counter() - t0) * 1e3)
    del ev
    return dict(batch_ms=batch_ms, captions_per_s_median=BATCH / statistics.median(batch_ms) * 1e3,
                encode_ms=encode_ms, encode_ms_median=statistics.median(encode_ms),
                ids_sha=hashlib.sha256(np.ascontiguousarray(ids).tobytes()).hexdigest()[:16])


def paired(root, label) -> int:
    """Geo serving (bf16, and f32 at beam 5 and batch 256), geo (bf16 and f32)
    and news train-step, geo beam-20 (bf16 and f32) and warm greedy times of
    the checkout at `root`, through
    the public entry points alone
    (Evaluator.decode_batch, train.step.make_train_step), so one timing code
    serves any two trees."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from icek_torch import bridge, eval_driver
    from icek_torch.kernels import _build
    from icek_torch.train import step as step_lib

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[{label}] {os.path.dirname(_build.__file__)}: build {time.perf_counter() - t0:.1f} s")
    cfg, wm, params, enc = model = full_width_model()
    ev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev)
    rng = np.random.default_rng(SEED)
    batches = [make_batch(rng, BATCH) for _ in range(4)]
    ev.decode_batch(batches[0])
    batch_ms = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        ev.decode_batch(b)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    ev32 = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, compute_dtype=torch.float32)
    ev32.decode_batch(batches[0])
    f32_batch_ms = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        ev32.decode_batch(b)
        f32_batch_ms.append((time.perf_counter() - t0) * 1e3)
    del ev32
    int8 = paired_int8_serving(dev, model, batches)

    def train_ms(model, preset, steps, dtype=torch.bfloat16):
        """Host ms of `steps` train steps after a warm-up, each to its loss."""
        cfg_, wm_, params_, _ = model
        tparams = bridge.trainable(copy.deepcopy(params_), dev)
        optimizer = step_lib.make_optimizer(cfg_.train.decoder_lr, cfg_.train.grad_clip)
        opt_state = optimizer.init(tparams)
        train_step, _ = step_lib.make_train_step(cfg_, VOCAB, wm_.pad_id, optimizer,
                                                 compute_dtype=dtype,
                                                 encode_images=False, device=dev)
        tb = make_train_batch(np.random.default_rng(SEED + 5), BATCH, wm_, preset)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in tb.items()}
        gen = torch.Generator().manual_seed(SEED)
        float(train_step(tparams, opt_state, None, tb, gen)[2])
        out = []
        for _ in range(steps):
            t0 = time.perf_counter()
            float(train_step(tparams, opt_state, None, tb, gen)[2])
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    step_ms = train_ms(model, "georic", TRAIN_STEPS)
    f32_ms = train_ms(model, "georic", F32_STEPS, torch.float32)
    news_ms = train_ms(full_width_model("nytimes800k", enc=enc), "nytimes800k",
                       FACT_TRAIN_STEPS)
    wide = {}
    for dtype in (torch.bfloat16, torch.float32):      # geo beam 20, the wide score pass
        wev = eval_driver.Evaluator(cfg, wm, params, enc, device=dev, beam_size=20,
                                    batch_size=WIDE_BATCH, compute_dtype=dtype)
        wb = make_batch(np.random.default_rng(SEED + 11), WIDE_BATCH)
        wev.decode_batch(wb)
        wide[str(dtype)] = WIDE_BATCH / statistics.median(time_decode(wev, wb)) * 1e3
    greedy_ms = time_greedy_warm(dev, model)
    norm_host = norm_wrapper_host_ms(dev)
    norm_device = norm_kernels_device_ms(dev)       # the profiler after every timed run
    L = cfg.decode.max_caption_len
    out = {"label": label, "card": smi_name_power(), "batch_ms": batch_ms,
           "captions_per_s_median": BATCH / statistics.median(batch_ms) * 1e3,
           "host_ms_per_beam_step_median": statistics.median(batch_ms) / L,
           "f32_batch_ms": f32_batch_ms,
           "f32_captions_per_s_median": BATCH / statistics.median(f32_batch_ms) * 1e3,
           "int8": int8,
           "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
           "samples_per_s_median": BATCH / statistics.median(step_ms) * 1e3,
           "f32_step_ms": f32_ms, "f32_samples_per_s_median": BATCH / statistics.median(f32_ms) * 1e3,
           "beam20_captions_per_s": wide,
           "news_step_ms": news_ms, "news_step_ms_median": statistics.median(news_ms),
           "greedy_warm_ms": greedy_ms, "norm_wrapper_host_ms": norm_host,
           "norm_device_ms": norm_device}
    print("PAIRED " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--paired":
        return paired(sys.argv[2], sys.argv[3])
    if len(sys.argv) == 2 and sys.argv[1] == "--mesh-world":
        return mesh_world()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    from icek_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_peaks()
    card = smi_name_power()
    log(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    decoder_step_sass()
    rows = run_phases(dev, card)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(dev, card) -> list:
    """Phases 3 to 6, the wide beam, the traces and the device splits on `dev`; returns
    the kernels' JSON rows."""
    flash_fwd, flash_bwd = check_flash(dev)
    flash_bf16_tf32 = check_flash_bf16_tf32(dev)
    flash_wide = check_flash_wide(dev)
    kernels = {"flash_attention": flash_fwd, "flash_attention_bwd": flash_bwd,
               "fused_score_topk": check_scores(dev),
               "decoder_step": check_decoder_step(dev)}
    score_f32_ks = check_scores_f32_ks(dev)
    wide_k = check_scores_wide(dev)
    norm = check_norm_rows(dev)
    kernels["dropout_add_ln"], kernels["dropout_add_ln_bwd"], kernels["hw_dropout"] = \
        norm[BATCH * ENT_ROWS]
    fact_kernels = {preset: check_kernels_facts(dev, preset_shape(preset))
                    for preset in FACT_PRESETS}

    geo = full_width_model()
    models = {"georic": geo}
    models.update({p: full_width_model(p, enc=geo[3]) for p in FACT_PRESETS})
    launches, summary, serve_batch = serve(dev, geo)
    served = {p: serve(dev, models[p], p) for p in FACT_PRESETS}
    checked = {preset: cross_check(dev, model, preset) for preset, model in models.items()}
    train_launches, train_summary, step_once = run_train_path(dev, geo)
    f32_train = f32_train_path(dev, geo, train_summary)
    wide_geo = geometry_path(dev)
    wide_geo128 = geometry_hd128_path(dev)
    trained = {p: run_train_path(dev, models[p], p, FACT_TRAIN_STEPS) for p in FACT_PRESETS}
    for preset, model in models.items():
        train_cross_check(dev, model, preset)
    wide = wide_beam(dev, geo)
    greedy_warm = time_greedy_warm(dev, geo)
    summary.update(greedy_warm_ms=greedy_warm,
                   greedy_warm_median_ms=statistics.median(greedy_warm))
    import tempfile

    with tempfile.TemporaryDirectory(prefix="icek_csvs_") as csv_dir:
        leave = captions_leave(dev, models, keep_csvs=csv_dir)
        run8 = train_run(dev, models, train_summary)
        int8 = int8_encoder(dev, models, {p: os.path.join(csv_dir, f"{p}_generated_captions.csv")
                                          for p in ("georic", "nytimes800k")})
    mesh = mesh_phase(dev, models, train_summary, summary, card)
    # after every timed run, so the profiler cannot disturb one
    trace_device("one train step", step_once)
    profile_summary(dev, step_once, card)
    del step_once
    trace_serving(dev, geo, serve_batch)
    for p in FACT_PRESETS:
        trace_device(f"one {p} train step", trained[p][2])
        trace_serving(dev, models[p], served[p][2], p)
    device_splits(dev, kernels, norm, wide_k)

    # name: (source, the TPU kernel it replaces)
    tpu = "icek_tpu/kernels/"
    meta = {
        "flash_attention": ("flash_attention.cu", tpu + "flash_attention.py:268"),
        "flash_attention_bwd": ("flash_attention.cu", tpu + "flash_attention.py:287"),
        "fused_score_topk": ("score_topk.cu", tpu + "copy_scores.py:107"),
        "decoder_step": ("decoder_step.cu", tpu + "decoder_step.py:296"),
        "dropout_add_ln": ("fused_norm.cu", tpu + "fused_norm.py:159"),
        "dropout_add_ln_bwd": ("fused_norm.cu", tpu + "fused_norm.py:176"),
        "hw_dropout": ("fused_norm.cu", tpu + "fused_norm.py:268"),
    }
    rows, sites = [], norm_rows()
    for name, by_dtype in kernels.items():
        bf, f32 = by_dtype[torch.bfloat16], by_dtype[torch.float32]
        row = {
            "name": name, "route": "cuda", "source": "icek_torch/csrc/" + meta[name][0],
            "replaces": meta[name][1],
            # counted on the path that runs the kernel: per TRAIN_STEPS train
            # steps, or over the serving run (3 beam batches + 1 greedy batch)
            "launches": train_launches.get(name, launches.get(name)),
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
            "dtype": "bfloat16", "tol": bf["tol"],
            "f32": {k: f32[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                        "library_ms", "bound_ms", "rate0_ms", "bound_tf32_ms",
                                        "cuda_cores_ms") if k in f32},
        }
        if name in launches and name in train_launches:
            row["launches_serving"] = launches[name]
        for extra in ("dropout", "self", "cross", "rate0_ms", "parts_ms", "greedy",
                      "wrapper_ms", "library_device_ms", "cuda_cores", "device_ms", "host_ms",
                      "library_host_ms", "keep_rate", "same_bytes_ms"):
            if extra in bf:
                row[extra] = bf[extra]
        # the knowledge and news presets: launches on their paths, and the
        # kernel at their shapes (bf16, with the f32 time and error)
        row["presets"] = {p: dict(launches_serving=served[p][0].get(name),
                                  launches_train=trained[p][0].get(name),
                                  shapes=fact_kernels[p].get(name))
                          for p in FACT_PRESETS}
        if name in ("fused_score_topk", "decoder_step"):    # beams 10 and 20
            row["wide_beams"] = {b: rec["kernels"][name] for b, rec in wide.items()}
        if name == "decoder_step":      # the CUDA-core kernel in f32; the f32 route's launches
            row["f32_cuda_cores"] = f32["cuda_cores"]
            row["launches_f32_beam10"] = wide["beam 10"]["torch.float32"]["routes"][
                "decoder_step_f32"]
        if name == "fused_score_topk":              # the wide first pass at N 640
            row["wide_k"] = {str(dt): {k: {f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                                             "library_ms", "bound_ms", "parts_ms")
                                           if f in r} for k, r in recs.items()}
                             for dt, recs in wide_k.items()}
        if name == "flash_attention_bwd":           # phase 6's f32 geo step
            row["f32_train_step"] = {k: f32_train[k] for k in (
                "launches", "routes", "samples_per_s_median", "bf16_samples_per_s_median",
                "dropout0_loss_rel", "dropout0_grad_tree_rel", "dropout0_worst_leaf_rel")}
        if name in leave["eval_run_launches"]:      # phase 7's geo eval run and engine
            row["launches_eval_run"] = leave["eval_run_launches"][name]
            row["launches_per_engine_batch"] = \
                leave["serving_engine"]["launches_per_batch"][name]
        if name in run8["loop"]["launches"]:        # phase 8's loop (2 epochs)
            row["launches_train_run"] = run8["loop"]["launches"][name]
        # phase 10 under a (1, 1) mesh: MESH_STEPS train steps, or the
        # 256-row eval run
        row["launches_mesh"] = mesh["step"]["launches"].get(
            name, mesh["eval"]["mesh"]["launches"].get(name))
        if name in NORM_KERNELS:        # every row count of every preset
            i = NORM_KERNELS.index(name)
            row["rows"] = {str(n): dict(_compact(rec[i][torch.bfloat16],
                                                 rec[i][torch.float32]), sites=sites[n])
                           for n, rec in norm.items()}
        rows.append(row)
    # the decoder step's wide route (geo beam 20, 32 images: three blocks an
    # image), launches from beam 20's bf16 decode
    wide20 = wide["beam 20"]
    bf, f32 = (wide20["kernels"]["decoder_step"][str(dt)] for dt in (torch.bfloat16, torch.float32))
    rows.append({
        "name": "decoder_step_wide", "route": "cuda", "source": "icek_torch/csrc/decoder_step.cu",
        "replaces": meta["decoder_step"][1],
        "launches": wide20[str(torch.bfloat16)]["routes"]["decoder_step_wide"],
        **{k: bf[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "cuda_cores_ms")},
        "dtype": "bfloat16", "tol": 0.15, "shape": f"B {WIDE_BATCH} K 20 step {MAX_LEN // 2}",
        "f32": dict(f32, launches=wide20[str(torch.float32)]["routes"]["decoder_step_wide_f32"],
                    tol=1e-3)})
    # the f32 routes on three TF32 products a product: the flash
    # forward at the geo encoder, rate 0, with its launches on the f32 geo
    # train step (phase 6), and the score head's first pass at geo beam 5,
    # with its launches in the f32 geo beam-5 decode (phase 5); each beside
    # the CUDA-core kernel it replaced, timed in this run.  bound_ms is the
    # least of the two bounds (3 TF32 products at 494.7 TF/s, or the f32
    # CUDA cores' 67 TF/s), both given.
    for name, rec, launches_f32, extra in (
            ("flash_attention_tf32", flash_fwd[torch.float32],
             f32_train["routes"]["flash_tf32"],
             dict(site=f"geo encoder B {BATCH} T {ENT_ROWS} rate 0",
                  dropout={k: flash_fwd[torch.float32]["dropout"][k] for k in (
                      "max_abs_err", "ms", "plain_ms", "library_ms", "cuda_cores_ms",
                      "bound_ms", "bound_tf32_ms")},
                  self=flash_fwd[torch.float32]["self"], cross=flash_fwd[torch.float32]["cross"],
                  bf16_misaligned=flash_bf16_tf32,
                  presets={p: fact_kernels[p]["flash_attention"] for p in FACT_PRESETS})),
            ("fused_score_topk_tf32", kernels["fused_score_topk"][torch.float32],
             checked["georic"][2]["beam"]["score_tensor_cores"],
             dict(site=f"geo beam N {BATCH * BEAM} k {BEAM}",
                  greedy=kernels["fused_score_topk"][torch.float32]["greedy"],
                  ks={str(k): r for k, r in score_f32_ks.items()},
                  launches_f32_greedy=checked["georic"][2]["greedy"]["score_tensor_cores"],
                  presets={p: fact_kernels[p]["fused_score_topk"] for p in FACT_PRESETS}))):
        least = min(rec["bound_ms"], rec["bound_tf32_ms"])
        rows.append({
            "name": name, "route": "cuda", "source": "icek_torch/csrc/" + meta[name[:-5]][0],
            "replaces": meta[name[:-5]][1], "launches": launches_f32,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": least,
            "bound_by": rec["bound_tf32_by"] if least == rec["bound_tf32_ms"] else rec["bound_by"],
            "library_ms": rec["library_ms"], "dtype": "float32", "tol": rec["tol"],
            "cuda_cores_ms": rec["cuda_cores_ms"], "bound_tf32_ms": rec["bound_tf32_ms"],
            "bound_f32_cores_ms": rec["bound_ms"], **extra})
    # head dims above 32 (F4): the --geometry 512x8 model's Hd 64 at the
    # encoder site (B 256, T 301, 8 heads), on each family's route, forward
    # at rate 0 and backward at rate 0.2, with the path's launches (the bf16
    # forward's: the wgmma kernel's, which takes every site); the other head
    # dims and sites nested
    for fam, dtype, key in (("mma", torch.bfloat16, "bfloat16"), ("tf32", torch.float32,
                                                                    "float32")):
        site = flash_wide[64][key]["encoder"]
        run = wide_geo["train"] if fam == "mma" else wide_geo["f32_train"]
        for kind, rec, launches_n in (
                ("", site["serving"], run["routes"]["flash_wgmma"]
                 if fam == "mma" else run["routes"]["flash_tf32"]),
                ("_bwd", site["backward"], wide_geo["train_launches"]["flash_attention_bwd"]
                 if fam == "mma" else run["launches"]["flash_attention_bwd"])):
            least, by = rec["bound_ms"], rec["bound_by"]
            if "bound_tf32_ms" in rec and rec["bound_tf32_ms"] < least:
                least, by = rec["bound_tf32_ms"], rec["bound_tf32_by"]
            name = f"flash_attention{kind}_{fam}_hd64"
            rows.append({
                "name": name, "route": "cuda", "source": "icek_torch/csrc/flash_attention.cu",
                "replaces": meta["flash_attention" + kind][1], "launches": launches_n,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": least, "bound_by": by,
                "library_ms": rec["library_ms"], "dtype": key, "tol": rec["tol"],
                "site": f"--geometry {GEOMETRY} encoder B {BATCH} T {ENT_ROWS} H 8 Hd 64, "
                        + ("rate 0" if kind == "" else f"rate {RATE}"),
                **{k: rec[k] for k in ("cuda_cores_ms", "rate0_ms", "bound_tf32_ms")
                   if k in rec},
                "launches_serving": (wide_geo["serving"]["routes"]["flash_wgmma"]
                                     if fam == "mma" and kind == "" else None),
                **({"kernel": rec["kernel"], "mma_sync_ms": rec["mma_sync_ms"],
                    "over_library": rec["ms"] / rec["library_ms"]}
                   if fam == "mma" and kind == "" else {}),
                **({"bwd_routes": run["bwd_routes"], "kernels": HD64_BWD_KERNELS[fam],
                    "rate0_over_library": rec["rate0_ms"] / rec["library_ms"]}
                   if kind == "_bwd" else {}),
                "sites": {n: flash_wide[64][key][n] for n in ("self", "cross")},
                "head_dims": {str(hd): flash_wide[hd] for hd in flash_wide if hd != 64},
                **({"misaligned_bf16": flash_wide[64]["bfloat16 misaligned"]}
                   if fam == "tf32" else {})})
    # the backward at padded head dim 128 (the --geometry 512x4 path): the
    # encoder site (B 256, T 301, 4 heads of 128) at rate 0.2, each new pair
    # with its launches on the 512x4 train steps and its rate-0 time beside
    # SDPA's (the pair it replaced is timed beside it by
    # `python -m icek_torch.kernels._variants --parent ROOT flash_attention base 0,0.2 4x128
    # f32,bf16`)
    for fam, key in (("mma", "bfloat16"), ("tf32", "float32")):
        rec = flash_wide[128][key]["encoder"]["backward"]
        run = wide_geo128["train"] if fam == "mma" else wide_geo128["f32_train"]
        least, by = rec["bound_ms"], rec["bound_by"]
        if "bound_tf32_ms" in rec and rec["bound_tf32_ms"] < least:
            least, by = rec["bound_tf32_ms"], rec["bound_tf32_by"]
        rows.append({
            "name": f"flash_attention_bwd_{fam}_hd128", "route": "cuda",
            "source": "icek_torch/csrc/flash_attention.cu",
            "replaces": meta["flash_attention_bwd"][1],
            "launches": (wide_geo128["train_launches"]["flash_attention_bwd"] if fam == "mma"
                         else run["launches"]["flash_attention_bwd"]),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": least, "bound_by": by, "library_ms": rec["library_ms"], "dtype": key,
            "tol": rec["tol"],
            "site": f"--geometry {GEOMETRY_HD128} encoder B {BATCH} T {ENT_ROWS} H 4 Hd 128, "
                    f"rate {RATE}",
            **{k: rec[k] for k in ("rate0_ms", "bound_tf32_ms") if k in rec},
            "rate0_over_library": rec["rate0_ms"] / rec["library_ms"],
            "kernels": HD128_BWD_KERNELS[fam], "bwd_pairs": run["bwd_pairs"],
            "step_ms_median": run["step_ms_median"]})
    step = wide_geo["decoder_step"]
    bf, f32 = step["bfloat16"], step["float32"]
    rows.append({
        "name": "decoder_step_512x8", "route": "cuda", "source": "icek_torch/csrc/decoder_step.cu",
        "replaces": meta["decoder_step"][1],
        "launches": wide_geo["serving_launches"]["decoder_step"],
        **{k: bf[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "shape", "tol", "kernel", "cuda_cores_ms")},
        "launches_cuda_cores": wide_geo["serving_launches"]["decoder_step_cuda_cores"],
        "decoder_route": bf["route"], "dtype": "bfloat16", "f32": f32,
        "launches_f32": wide_geo["f32_check"][2]["decoder"]})
    # its f32 route (decoder_step_mma_kernel<float, 64>), launches from the
    # f32 beam-5 batches of 256 (per batch)
    f32_batch = wide_geo["f32_serving"]
    rows.append({
        "name": "decoder_step_512x8_f32", "route": "cuda",
        "source": "icek_torch/csrc/decoder_step.cu", "replaces": meta["decoder_step"][1],
        "launches": f32_batch["decoder_launches_per_batch"]["decoder_step_f32"],
        **{k: f32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "shape", "tol", "kernel", "cuda_cores_ms")},
        "launches_cuda_cores": f32_batch["decoder_launches_per_batch"]["decoder_step_cuda_cores"],
        "decoder_route": f32["route"], "dtype": "float32",
        "batch_ms_median": f32_batch["batch_ms_median"],
        "captions_per_s_median": f32_batch["captions_per_s_median"]})
    head = int8["sites"]["1x1_s1"]
    rows.append({
        "name": "int8_conv", "route": "cuda", "source": "icek_torch/csrc/int8_conv.cu",
        "replaces": "icek_tpu/models/resnet_int8.py:73",
        "launches": int8["serving"]["launches_per_batch"]["int8_conv"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "site": head["site"], "tol": 0,
        "sites": {k: {f: v[f] for f in ("route", "ms", "plain_ms", "library_ms", "cudnn_bf16_ms",
                                         "bound_ms", "bound_by", "tops", "host_us")}
                  for k, v in int8["sites"].items()},
        "per_encode": {k: int8["per_encode"][k] for k in ("ms", "bound_ms",
                                                          "bound_unfused_ms", "launches")},
        "routes_per_encode": int8["serving"]["routes_per_batch"],
        "launches_eval_cli": int8["cli"]["eval_int8_launches"][0]})
    pool = int8["pool"]
    rows.append({
        "name": "int8_maxpool", "route": "cuda", "source": "icek_torch/csrc/int8_conv.cu",
        "replaces": "icek_tpu/models/resnet_int8.py:353",
        "launches": int8["serving"]["launches_per_batch"]["int8_maxpool"],
        **{k: pool[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "bit_equal_shapes")},
        "tol": 0})
    log(f"card: {card}; train path: {json.dumps(train_summary)}")
    log(f"card: {card}; f32 train path: {json.dumps(f32_train)}")
    log(f"card: {card}; --geometry {GEOMETRY} path: {json.dumps(wide_geo, default=str)}")
    log(f"card: {card}; --geometry {GEOMETRY_HD128} path: "
        f"{json.dumps(wide_geo128, default=str)}")
    log(f"card: {card}; main path: {json.dumps(summary)}")
    for p in FACT_PRESETS:
        log(f"card: {card}; {p} serving: {json.dumps(served[p][1])}")
        log(f"card: {card}; {p} train path: {json.dumps(trained[p][1])}")
    log(f"card: {card}; wide beams (geo beams {WIDE_BEAMS}): {json.dumps(wide)}")
    for what, rec in leave.items():
        log(f"card: {card}; {what}: {json.dumps(rec)}")
    for what, rec in run8.items():
        log(f"card: {card}; train run {what}: {json.dumps(rec, default=str)}")
    for what in ("quality", "serving", "cli", "metrics", "native", "library_refusals"):
        log(f"card: {card}; int8 encoder {what}: {json.dumps(int8[what], default=str)}")
    for what, rec in mesh.items():
        log(f"card: {card}; mesh {what}: {json.dumps(rec, default=str)}")
    return rows


if __name__ == "__main__":
    sys.exit(main())
