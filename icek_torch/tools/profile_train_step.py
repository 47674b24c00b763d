"""Profile the port's train step under ``torch.profiler`` and print where
the device time goes, by op class (port of ``tools/profile_train_step.py``).

Per-op device times say WHERE the time goes; they are no savings
predictor (launches overlap, the host may hold the card back): decide
changes with end-to-end A/B runs.

Usage: python -m icek_torch.tools.profile_train_step [batch] [preset]
           [trace_dir] [accum] [--device cuda|cpu]

STEPS steps are timed after one warm-up and then traced.  The step is the
preset's at full width with seeded random weights, bf16 on
the card (f32 on the CPU), over cached image tokens.  `accum` profiles the
gradient-accumulation step at that microbatch count.  The Chrome trace
lands in `trace_dir/trace.json`.  Without a card, pass ``--device cpu``:
the summary then reads the host's operator times.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import tempfile
import time
from typing import Callable, List, Tuple

# (class, name fragments), first match wins: the port's kernels by their
# csrc names, then the library kernels by family
OP_CLASSES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd", ("flash_bwd",)),
    ("score_topk", ("score_partial", "score_merge")),
    ("decoder_step", ("decoder_step",)),
    ("ln_fwd", ("ln_fwd",)),
    ("ln_bwd", ("ln_bwd",)),
    ("dropout", ("dropout_kernel", "dropout_flat_kernel")),
    ("int8_conv", ("int8_conv", "maxpool_strip_kernel")),
    ("indexing_backward", ("indexing_backward", "index_put", "embedding_dense_backward",
                           "embedding_backward", "index_add", "scatter_add")),
    ("attention", ("fmha", "flash_attn", "attention", "softmax")),
    ("gemm", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_", "ampere_", "aten::mm",
              "aten::addmm", "aten::bmm", "aten::matmul", "aten::linear", "aten::einsum",
              "aten::baddbmm", "aten::convolution", "conv")),
    ("copy", ("memcpy", "memset", "copy", "aten::cat", "aten::to", "aten::clone",
              "aten::contiguous", "catarraybatched")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "unrolled", "aten::")),
)
STEPS = 10
# chrome-trace categories of device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def op_class(name: str) -> str:
    """The class of one traced op: a port kernel, GEMM, attention, element-wise,
    copies, indexing_backward, or "other"."""
    low = name.lower()
    for cls, frags in OP_CLASSES:
        if any(f.lower() in low for f in frags):
            return cls
    return "other"


def find_trace(trace_dir: str) -> str:
    """The newest Chrome trace (``*.json``) under `trace_dir`."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def trace_ops(trace_path: str) -> Tuple[str, List[Tuple[str, float]]]:
    """(source, [(op name, ms)]): the device's kernels and copies when the
    trace holds any ("device"), else the host's operators by self time, each
    nested call's time taken from its caller ("host")."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in _DEVICE_CATS]
    if device:
        return "device", [(e.get("name", ""), e["dur"] / 1e3) for e in device]
    host = collections.defaultdict(list)
    for e in spans:
        if e.get("cat") == "cpu_op":
            host[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in host.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []                              # [end, event, self us]
        for e in evs:
            while stack and e["ts"] >= stack[-1][0]:
                _, top, self_us = stack.pop()
                out.append((top.get("name", ""), self_us / 1e3))
            if stack:
                stack[-1][2] -= e["dur"]
            stack.append([e["ts"] + e["dur"], e, float(e["dur"])])
        out.extend((top.get("name", ""), self_us / 1e3) for _, top, self_us in stack)
    return "host", out


def summarize(trace_path: str, steps: int, out: Callable[[str], None] = print):
    """Print the traced time by op class; returns (total ms, [(class, [ms,
    count])] largest first)."""
    source, ops = trace_ops(trace_path)
    groups = collections.defaultdict(lambda: [0.0, 0])
    total = 0.0
    for name, ms in ops:
        g = groups[op_class(name)]
        g[0] += ms
        g[1] += 1
        total += ms
    rows = sorted(groups.items(), key=lambda kv: -kv[1][0])
    out(f"{source} total: {total:.2f} ms over {steps} steps "
        f"({total / max(steps, 1):.2f} ms/step attributed)")
    out(f"{'op class':<40}{'total ms':>10}{'ms/step':>10}{'count':>8}")
    for name, (ms, count) in rows[:30]:
        out(f"{name:<40}{ms:>10.2f}{ms / max(steps, 1):>10.3f}{count:>8}")
    return total, rows


def trace(fn: Callable[[], object], trace_dir: str, steps: int = 1) -> str:
    """Run `fn` `steps` times under ``torch.profiler`` (the card's kernels
    too, where there is one); returns the Chrome trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        for _ in range(steps):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def make_step(batch: int, preset: str, accum, device):
    """(one-step closure, its token count reader) of the preset's train step
    at full width over a seeded batch."""
    import dataclasses

    import numpy as np
    import torch

    from icek_torch import bridge
    from icek_torch.tools import _synthetic
    from icek_torch.train import step as step_lib

    cfg, wm, params, _ = _synthetic.model(preset)
    if accum is not None:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, grad_accum_steps=accum if accum == "auto" else int(accum)))
    device = torch.device(device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    params = bridge.trainable(params, device)
    optimizer = step_lib.make_optimizer(cfg.train.decoder_lr, cfg.train.grad_clip)
    opt_state = optimizer.init(params)
    train_step, _ = step_lib.make_train_step(
        cfg, len(wm), wm.pad_id, optimizer, compute_dtype=dtype, encode_images=False,
        device=device)
    rows = _synthetic.train_batch(np.random.default_rng(5), batch, wm, preset)
    rows = {k: torch.as_tensor(v, device=device) for k, v in rows.items()}
    gen = torch.Generator().manual_seed(0)

    def step():
        return float(train_step(params, opt_state, None, rows, gen)[2])

    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m icek_torch.tools.profile_train_step",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=256)
    p.add_argument("preset", nargs="?", default="georic")
    p.add_argument("trace_dir", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "icek_train_trace"))
    p.add_argument("accum", nargs="?", default=os.environ.get("ICEK_ACCUM"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    step = make_step(args.batch, args.preset, args.accum, args.device)
    step()                                                    # warm-up
    sync = torch.cuda.synchronize if torch.device(args.device).type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    sync()
    step_s = (time.perf_counter() - t0) / STEPS
    print(json.dumps({"preset": args.preset, "batch": args.batch, "accum": args.accum,
                      "step_ms": step_s * 1e3, "samples_per_s": args.batch / step_s}))
    summarize(trace(step, args.trace_dir, STEPS), STEPS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
