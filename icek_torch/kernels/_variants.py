"""Where a kernel's time goes, on the card: variants of its source, one process each.

    python -m icek_torch.kernels._variants fused_norm base,nophilox,copyonly [ROWS] [RATE]
    python -m icek_torch.kernels._variants decoder_step base,g1,nolinears [STEP ...]

builds each named variant of ``csrc/<source>.cu`` (the source with the
variant's text replacements, ``VARIANTS``) with the wrappers' flags, all
nvcc processes at once, then times each in a process of its own, in the
order given and then backwards, so a drift shows:

* ``fused_norm``: the LayerNorm forward (``ln_fwd``) and the dropout
  (``dropout``) with torch.profiler, each kernel in a profiler session of
  its own, at ROWS (comma-separated row counts; default the train steps'
  8192, 13312, 26112 and 77056) and RATE (default 0.2), in bf16 and f32;
* ``decoder_step``: ``fused_beam_decoder_step`` in bf16 at the beam shape
  (B 256, K 5, the geo decoder's widths, seeded random inputs, the cross
  K/V laid out by ``pad_cross_heads`` beforehand as the beam loop does) at
  each STEP (default 15), with CUDA events.

Each variant is held against its kernel's plain version, except those in
``CUTS``, which cut work out and so compute wrong results: only their time
is read, and their error is printed.  A replacement that no longer matches
the source raises: change the variants with the kernel.

One process a variant: with several builds of one source loaded into one
process, every launch ran the last-loaded build's kernels (a variant with a
wrong mask returned the base's exact results).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from icek_torch.kernels import _build

_SPAN = "__global__ void __launch_bounds__(FWD_THREADS) ln_fwd_span_kernel("
_LOADS = ("          cp_async16_n(smem_u32(dst + c), x + src, bytes);\n"
          "          cp_async16_n(smem_u32(dst + G + c), h + src, bytes);")
_Z_BEGIN = "    // z = x + dropout(h); each row's sum (groups past the tensor read as 0)\n"
_Z_END = ("        store_chunk<T>(y, base + (long long)c * CE, total, pack_chunk(out));\n"
          "      }\n    }\n  }\n  cp_async_wait<0>();")
_TEAMS = ("__host__ __device__ constexpr int fwd_team_lanes(int G) "
          "{ return G <= 16 * 5 ? 16 : 32; }")
_PERSIST = "ln_fwd_pick(D)<<<static_cast<unsigned>(nblocks),"
_MIN_SETS = "constexpr long long FWD_SPAN_MIN_SETS = 2;"
_HINTS_OFF = [
    ("ldg16_hint(wp[j] + kp * 32, keep)", "__ldg(wp[j] + kp * 32)"),
    ("cp_async16_hint(smem_u32(kd + r * PQ + 8 * c), a.xk + src, ok, stream);",
     "cp_async16(smem_u32(kd + r * PQ + 8 * c), a.xk + src, ok);"),
    ("cp_async16_hint(smem_u32(vd + r * PQ + 8 * c), a.xv + src, ok, stream);",
     "cp_async16(smem_u32(vd + r * PQ + 8 * c), a.xv + src, ok);"),
]
_NO_CROSS_MATH = [("        if (hh >= H) continue;\n", "        continue;\n")]

# source -> name -> [(text, replacement)] or, for a replacement of everything
# between two marks, [((begin, end), replacement)]
VARIANTS = {
    "fused_norm": {
        "base": [],
        # keep flags without Philox (0xE: column 0 of a group dropped, the
        # rest kept; the check draws the same, so the results still check)
        "nophilox": [("  if (thresh >= KEEP_ALL) return 0xFu;\n",
                      "  if (thresh >= KEEP_ALL || seed != 0x7fffffffu) return "
                      "thresh >= KEEP_ALL ? 0xFu : 0xEu;\n")],
        # the forward's row sums without shuffles
        "noshfl": [("    const float mean0 = team_sum<LPR>(sum0) / D, mean1 = team_sum<LPR>(sum1) / D;",
                    "    const float mean0 = sum0 / D, mean1 = sum1 / D;"),
                   ("    const float rstd0 = rsqrtf(team_sum<LPR>(sq0) / D + eps);\n"
                    "    const float rstd1 = rsqrtf(team_sum<LPR>(sq1) / D + eps);",
                    "    const float rstd0 = rsqrtf(sq0 / D + eps), rstd1 = rsqrtf(sq1 / D + eps);")],
        # the forward's data path alone: x through the ring into y
        "copyonly": [((_Z_BEGIN, _Z_END),
                      "#pragma unroll\n    for (int i = 0; i < NC; ++i) {\n"
                      "      const int c = l + LPR * i;\n"
                      "      if (c < G && sp < spans)\n"
                      "        store_chunk<T>(y, base + (long long)c * CE, total, cur[c]);\n"
                      "    }\n    __syncwarp();\n"
                      "    stage = stage == FWD_STAGES - 1 ? 0 : stage + 1;\n  }\n"
                      "  cp_async_wait<0>();")],
        # the forward's arithmetic alone: no copies
        "computeonly": [(_LOADS, "          (void)dst; (void)src; (void)bytes;")],
        "stages3": [("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 3;")],
        "warp32": [(_TEAMS, "__host__ __device__ constexpr int fwd_team_lanes(int G) "
                            "{ return G < 0 ? 16 : 32; }")],
        "regs128": [(_SPAN, _SPAN.replace("(FWD_THREADS)", "(FWD_THREADS, 4)"))],
        "nopersist": [(_PERSIST, "ln_fwd_pick(D)<<<static_cast<unsigned>("
                                 "(spans + per_block - 1) / per_block),")],
        # every aligned bf16 row count through the span kernel, or none
        "allspan": [(_MIN_SETS, _MIN_SETS.replace("= 2", "= 0"))],
        "nospan": [(_MIN_SETS, _MIN_SETS.replace("= 2", "= 1LL << 40"))],
        "drop4": [("constexpr int DROP_UNROLL = 2;", "constexpr int DROP_UNROLL = 4;")],
        "drop8": [("constexpr int DROP_UNROLL = 2;", "constexpr int DROP_UNROLL = 8;")],
        "dropldg": [("  if (e + CE <= total) return __ldcs(reinterpret_cast<const R*>(p + e));",
                     "  if (e + CE <= total) return *reinterpret_cast<const R*>(p + e);")],
    },
    "decoder_step": {
        "base": [],
        "g1": [],                                   # one image a block (IMAGES)
        "g3": [],                                   # three images a block
        "nohints": _HINTS_OFF,                      # no L2 eviction hints
        "nolinears": [("  const uint64_t keep = l2_policy_evict_last();\n",
                       "  const uint64_t keep = l2_policy_evict_last();\n"
                       "  if (kpairs > 0) return;\n")],
        "nocrossmath": _NO_CROSS_MATH,              # the cross-attention's math
        "nocross": _NO_CROSS_MATH + [("    if (s < total) {\n", "    if (false) {\n")],
        "noself": [("for (int task = tid >> 1; task < R * H; task += MT / 2)",
                    "for (int task = tid >> 1; task < 0; task += MT / 2)")],
    },
}
CUTS = {"fused_norm": {"noshfl", "copyonly", "computeonly"},
        "decoder_step": {"nolinears", "nocrossmath", "nocross", "noself"}}
IMAGES = {"g1": 1, "g3": 3}          # decoder_step: images a block instead of the wrapper's choice


def variant_source(source: str, name: str, src: str) -> str:
    """`src` with variant `name`'s replacements, each of which must match."""
    for old, new in VARIANTS[source][name]:
        if isinstance(old, tuple):
            begin, end = old
            if begin not in src or end not in src:
                raise ValueError(f"{source} variant {name!r}: its marks are not in the source")
            a, b = src.index(begin), src.index(end) + len(end)
            src = src[:a] + new + src[b:]
        else:
            if old not in src:
                raise ValueError(f"{source} variant {name!r}: {old[:60]!r} not in the source")
            src = src.replace(old, new)
    return src


def _device_ms(fn, part: str, reps: int = 20) -> float:
    """Device ms a call of the kernels whose names hold `part`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and part in e.name) / reps


def _event_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _held(source: str, name: str, what: str, err: float, tol: float) -> str:
    if err > tol and name not in CUTS[source]:
        raise RuntimeError(f"{source} variant {name!r}: {what} max abs err {err:.3g} > {tol}")
    return f"err {err:.3g}"


def time_fused_norm(name: str, args) -> None:
    from icek_torch.kernels import fused_norm as fn

    rows = [int(r) for r in (args[0] if args else "8192,13312,26112,77056").split(",")]
    rate = float(args[1]) if len(args) > 1 else 0.2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    for dtype, tol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-4)):
        for n in rows:
            x, h = (torch.randn((n, 300), generator=g, device=dev).to(dtype) for _ in range(2))
            hf = torch.randn((n, 512), generator=g, device=dev).to(dtype)
            scale = 1 + 0.1 * torch.randn(300, generator=g, device=dev)
            bias = 0.1 * torch.randn(300, generator=g, device=dev)
            keep = fn.keep_mask(n, 300, rate=rate, seed=55, device=dev)
            kf = fn.keep_mask(n, 512, rate=rate, seed=56, device=dev)
            fwd = lambda: fn.dropout_add_ln(x, h, scale, bias, rate=rate, seed=55)
            drop = lambda: fn._dropout_launch(hf, rate, 56)
            err = float((fwd().float() - fn.reference_dropout_add_ln(
                x, h, scale, bias, rate=rate, keep=keep).float()).abs().max())
            derr = float((drop().float() - fn.reference_hw_dropout(
                hf, rate=rate, keep=kf).float()).abs().max()) if rate else 0.0
            print(f"{name} {str(dtype)[6:]} {n} rate {rate}: ln_fwd "
                  f"{_device_ms(fwd, 'ln_fwd'):.4f} ms "
                  f"({_held('fused_norm', name, 'ln_fwd', err, tol)}), dropout "
                  f"{_device_ms(drop, 'dropout'):.4f} ms "
                  f"({_held('fused_norm', name, 'dropout', derr, tol)})", flush=True)


def beam_inputs(step: int, B: int = 256, K: int = 5, L: int = 30, M: int = 497, seed: int = 0):
    """The geo decoder (3 layers, D 300, H 10, F 512) in bf16 at step `step`."""
    from icek_torch.kernels import decoder_step as dsk
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


def time_decoder_step(name: str, args) -> None:
    from icek_torch.kernels import decoder_step as dsk

    if name in IMAGES:
        dsk.images_per_block = lambda B, K, sms, G=IMAGES[name]: G
    for step in [int(a) for a in args] or [15]:
        stacked, x, anc, ck, cv, xk, xv, heads, H = beam_inputs(step)
        want = dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
        run = lambda: dsk.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None, step,
                                                  num_heads=H, cross_heads=heads)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(run(), want))
        print(f"{name} step {step}: {_event_ms(run):.4f} ms "
              f"({_held('decoder_step', name, 'step', err, 0.15)})", flush=True)


TIMERS = {"fused_norm": time_fused_norm, "decoder_step": time_decoder_step}


def main(source: str, names, args) -> None:
    out_dir = os.path.join(_build.BUILD_DIR, "variants", source)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, source + ".cu")) as f:
        src = f.read()
    procs = {}
    for name in names:
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(source, name, src))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.FLAGS, "-I", _build.CSRC,
             "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} variant {name!r}:\n{log}")
    print(f"{torch.cuda.get_device_name(0)}; variants {', '.join(names)} of {source}.cu",
          flush=True)
    for name in list(names) + list(names)[::-1]:
        subprocess.run([sys.executable, "-m", "icek_torch.kernels._variants", "--one", source,
                        name, os.path.join(out_dir, name + ".so"), *args], check=True)


if __name__ == "__main__":
    if len(sys.argv) >= 5 and sys.argv[1] == "--one":
        _build.use_variant(sys.argv[2], sys.argv[4])
        TIMERS[sys.argv[2]](sys.argv[3], sys.argv[5:])
    elif len(sys.argv) >= 3 and sys.argv[1] in VARIANTS:
        main(sys.argv[1], sys.argv[2].split(","), sys.argv[3:])
    else:
        sys.exit(__doc__)
