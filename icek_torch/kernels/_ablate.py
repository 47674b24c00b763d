"""Where the tensor-core decoder step's time goes, on the card.

    python -m icek_torch.kernels._ablate [step ...]      (default: 15)

builds ``csrc/decoder_step.cu`` as it is and in variants, each a copy with
one part changed or cut out by text replacement, all with nvcc at once, and
times ``fused_beam_decoder_step`` on each at the beam shape (B 256, K 5, the
geo decoder's widths, seeded random inputs, the cross K/V laid out by
``pad_cross_heads`` beforehand as the beam loop does) with CUDA events,
every variant twice, in turns.  A variant that cuts a part out computes
the wrong thing; only its time is read.  The others are held against the
plain version at the card tests' 0.15.  A replacement that no longer
matches the source raises: change the variants with the kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from icek_torch.kernels import _build
from icek_torch.kernels import decoder_step as dsk

_HINTS_OFF = [
    ("ldg16_hint(wp[j] + kp * 32, keep)", "__ldg(wp[j] + kp * 32)"),
    ("cp_async16_hint(smem_u32(kd + r * PQ + 8 * c), a.xk + src, ok, stream);",
     "cp_async16(smem_u32(kd + r * PQ + 8 * c), a.xk + src, ok);"),
    ("cp_async16_hint(smem_u32(vd + r * PQ + 8 * c), a.xv + src, ok, stream);",
     "cp_async16(smem_u32(vd + r * PQ + 8 * c), a.xv + src, ok);"),
]
_NO_CROSS_MATH = [("        if (hh >= H) continue;\n", "        continue;\n")]
# name: (text replacements, images a block or None for the wrapper's choice)
VARIANTS = {
    "as built": ([], None),
    "G = 1 image a block": ([], 1),
    "G = 3 images a block": ([], 3),
    "no L2 eviction hints": (_HINTS_OFF, None),
    "cut: the six linears": (
        [("  const uint64_t keep = l2_policy_evict_last();\n",
          "  const uint64_t keep = l2_policy_evict_last();\n  if (kpairs > 0) return;\n")], None),
    "cut: cross-attention math": (_NO_CROSS_MATH, None),
    "cut: cross-attention math and stream": (
        _NO_CROSS_MATH + [("    if (s < total) {\n", "    if (false) {\n")], None),
    "cut: self-attention": (
        [("for (int task = tid >> 1; task < R * H; task += MT / 2)",
          "for (int task = tid >> 1; task < 0; task += MT / 2)")], None),
}


def _variant_source(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"_ablate: {old.strip()!r} is no longer in decoder_step.cu")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    """name -> ctypes.CDLL of the variant (nvcc processes started together)."""
    with open(os.path.join(_build.CSRC, "decoder_step.cu")) as f:
        src = f.read()
    out_dir = os.path.join(_build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (pairs, _)) in enumerate(VARIANTS.items()):
        cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(_variant_source(src, pairs))
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.FLAGS, "-I", _build.CSRC,
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"_ablate: nvcc failed for {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def beam_inputs(step: int, B: int = 256, K: int = 5, L: int = 30, M: int = 497, seed: int = 0):
    """The geo decoder (3 layers, D 300, H 10, F 512) in bf16 at step `step`."""
    from icek_torch.models import transformer as tfm

    nL, D, H, F = 3, 300, 10, 512
    g = torch.Generator().manual_seed(seed)
    layers = tfm.init_decoder_stack(g, nL, D, F)
    layers = {"layers": [{k: _to(v) for k, v in lay.items()} for lay in layers["layers"]]}
    stacked = dsk.stack_decoder_params(layers, torch.bfloat16)
    rnd = lambda *s: torch.randn(s, generator=g).to("cuda", torch.bfloat16)
    x = rnd(B, K, D)
    caches = torch.zeros((2, nL, B, L * K, D), dtype=torch.bfloat16, device="cuda")
    caches[:, :, :, :step * K] = rnd(2, nL, B, step * K, D)
    ck, cv = caches[0].contiguous(), caches[1].contiguous()
    xk, xv = rnd(nL, B, M, D), rnd(nL, B, M, D)
    anc = torch.randint(0, K, (B, K, L), generator=g, dtype=torch.int32)
    anc[:, :, step:] = torch.arange(K, dtype=torch.int32)[None, :, None]
    heads = dsk.pad_cross_heads([{"k": xk[l].view(B, M, H, D // H), "v": xv[l].view(B, M, H, D // H)}
                                 for l in range(nL)], torch.bfloat16)
    return stacked, x, anc.cuda(), ck, cv, xk, xv, heads, H


def _to(tree):
    if isinstance(tree, dict):
        return {k: _to(v) for k, v in tree.items()}
    return tree.to("cuda", torch.bfloat16)


def _ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(steps) -> None:
    libs = build_variants()
    print(f"{torch.cuda.get_device_name(0)}; {len(libs)} variants of decoder_step.cu", flush=True)
    chosen = dsk.images_per_block
    try:
        for step in steps:
            stacked, x, anc, ck, cv, xk, xv, heads, H = beam_inputs(step)
            want = dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                G = VARIANTS[name][1]
                dsk.images_per_block = chosen if G is None else (lambda B, K, sms, G=G: G)
                _build._libs["decoder_step"] = libs[name]
                run = lambda: dsk.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None,
                                                          step, num_heads=H, cross_heads=heads)
                got = run()
                torch.cuda.synchronize()
                if not times[name] and not name.startswith("cut"):
                    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
                    if err > 0.15:
                        raise RuntimeError(f"_ablate: {name!r} at step {step}: max abs err {err}")
                times[name].append(_ms(run))
            for name, t in times.items():
                print(f"step {step}: {name:40s} {t[0]:.4f} {t[1]:.4f} ms", flush=True)
    finally:
        dsk.images_per_block = chosen
        _build._libs.pop("decoder_step", None)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [15])
