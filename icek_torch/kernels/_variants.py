"""Where a kernel's time goes, on the card: variants of its source, one process each.

    python -m icek_torch.kernels._variants fused_norm base,nophilox,copyonly [ROWS] [RATE]
    python -m icek_torch.kernels._variants decoder_step base,g1,nolinears [STEP ...] [bf16] [f32] [BxK ...] [wDxH ...]
    python -m icek_torch.kernels._variants score_topk base,nolist,nolse [K,K,...] [N]
    python -m icek_torch.kernels._variants flash_attention base,nophilox [RATE,RATE,...] [HxHd] [f32,bf16] [TqxTk[c],...]
    python -m icek_torch.kernels._variants int8_conv base,gather,epfirst,ep1,nostore,noepi,nomma [BATCH] [KINDS]
    python -m icek_torch.kernels._variants --parent ROOT <source> base,... [args]

builds each named variant of ``csrc/<source>.cu`` (the source with the
variant's text replacements, ``VARIANTS``) with the wrappers' flags, all
nvcc processes at once, then times each in a process of its own, in the
order given and then backwards, so a drift shows:

* ``fused_norm``: the LayerNorm forward (``ln_fwd``) and the dropout
  (``dropout``) with torch.profiler, each kernel in a profiler session of
  its own, at ROWS (comma-separated row counts; default the train steps'
  8192, 13312, 26112 and 77056) and RATE (default 0.2), in bf16 and f32;
* ``decoder_step``: ``fused_beam_decoder_step`` at the geo decoder's widths,
  or at each width w<D>x<H> named (w512x8: --geometry 512x8's 8 heads of
  64) (seeded random inputs, the cross K/V laid out by ``pad_cross_heads``
  beforehand as the beam loop does where the tensor-core route takes
  them) in each dtype named (bf16, f32; default bf16), at each shape BxK
  (default 256x5, the beam shape) and each STEP (default 15), with CUDA
  events.  Names in ``TWEAKS`` change the
  wrapper's choices instead of the source (``cores``: the CUDA-core
  kernel).  Each run saves its outputs, and with ``--parent`` the parent's
  are compared with the first variant's bit for bit;
* ``score_topk``: ``fused_score_topk`` at N rows (default 640, geo beam
  20's; 1280 is geo beam 5's, 256 greedy's), D 300, V 10000, tail 301,
  seeded random inputs, at each K (default 20), in bf16 and f32, with CUDA
  events, and the first pass and the merge apart (torch.profiler); where f32
  takes the tensor-core pass (K <= 16) also the CUDA-core pass it replaced
  (the same h 4 bytes into its buffer);
* ``flash_attention``: at the geo encoder site (B 256, T 301, H 10, Hd 30,
  or the heads HxHd, such as 8x64 for --geometry 512x8, or several
  comma-separated; q, k, v strided
  views of one fused QKV projection), or at the sites named (a fourth
  argument such as ``32x32c,32x497``: Tq x Tk, ``c`` causal; a cross
  site's q from its own projection), at each RATE (default 0 and 0.2), in
  each dtype named (default f32), with CUDA events: the forward (and
  beside it the CUDA-core forward it replaced, through its entry; in bf16
  above head dim 32 also the device times of the routed forward and of the
  mma.sync forward, torch.profiler in alternating rounds), then the
  backward (dQ, then dK/dV) and its two kernels apart (torch.profiler);
  each run saves its outputs, and with ``--parent`` the parent's are
  compared with the first variant's bit for bit;
* ``int8_conv``: every distinct site of an int8 encode of 256x256 images
  at BATCH (default 256; ``resnet_int8.encode_sites``, computed by this
  process and handed to each run, so a parent tree is timed on the same
  list), the seven site shapes of ``chip_smoke.py``'s ``INT8_SITES`` and
  the max pool (``POOL_SITES``, kind ``pool``: with ``--parent`` the tree a
  pool design replaced is timed beside it), seeded int8 inputs, CUDA
  events: the site ms, each held bit for bit to the plain version, and the
  per-encode sum (launches x ms; the pool not in it).  A tree
  without ``fused_site`` / ``stem_site`` runs a fused site as its down
  and conv3 launches and the stem as the encode ran it (torch's
  quantization, then the site); ``stem_int8`` is the stem's launch on int8
  codes in both.  KINDS (comma-separated: conv, fused, stem, stem_int8, pool)
  times only those sites.  With ``--parent`` the outputs are compared bit
  for bit.

The base build's ptxas report (registers, shared memory, spills of every
kernel) is printed first.  With ``--parent ROOT`` (a checkout of another
tree, such as the parent commit unpacked by ``git archive`` into a
git-ignored directory) that tree's source and package are timed too, as
``parent``, by this module's timer, before and after the variants: a
before-and-after in one call on one card.

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
    ("cp_async16_hint(smem_u32(kd + r * PQ + PAD<T> * c), a.xk + src, ok, stream);",
     "cp_async16(smem_u32(kd + r * PQ + PAD<T> * c), a.xk + src, ok);"),
    ("cp_async16_hint(smem_u32(vd + r * PQ + PAD<T> * c), a.xv + src, ok, stream);",
     "cp_async16(smem_u32(vd + r * PQ + PAD<T> * c), a.xv + src, ok);"),
]
_NO_CROSS_MATH = [("        if (hh >= H) continue;\n", "        continue;\n")]
# the f32 cross tile's S = Q K^T: one chain of HP / 8 k8 steps, or four at pad 64
_S_CHAIN = """#pragma unroll
    for (int e = 0; e < 4; ++e) sv[j][e] = 0.f;
#pragma unroll
    for (int ds = 0; ds < HP / 8; ++ds) {
      uint32_t q4[4];                   // Q rows g, g + 8 by dims 8 ds + t, + 4
      ldsm_x4(q4, qt + 8 * ds);
      mma3(sv[j], split_frag(q4), __uint_as_float(kb[ds >> 1][2 * (ds & 1)]),
           __uint_as_float(kb[ds >> 1][2 * (ds & 1) + 1]));
    }
"""
_S_CHAINS = """    constexpr int SC = HP == 64 ? 4 : 1, NK = HP / 8 / SC;
    float part[SC][4] = {};
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int q = 0; q < SC; ++q) {
        const int ds = q * NK + k;
        uint32_t q4[4];
        ldsm_x4(q4, qt + 8 * ds);
        mma3(part[q], split_frag(q4), __uint_as_float(kb[ds >> 1][2 * (ds & 1)]),
             __uint_as_float(kb[ds >> 1][2 * (ds & 1) + 1]));
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sv[j][e] = part[0][e];
#pragma unroll
      for (int q = 1; q < SC; ++q) sv[j][e] += part[q][e];
    }
"""


# source -> name -> [(text, replacement)] or, for a replacement of everything
# between two marks, [((begin, end), replacement)]
# the TF32 flash forward's P V: V split by split_tf32_bits (the kernel), or
# by split_tf32<2>'s cvt.rna pair (its first build)
_FWD_PV = "          mma_add_bits<P>(acc[n], pa, vr[0], vr[FP]);\n"
_FWD_PV_RNA = "          mma_add<P>(acc[n], pa, vr[0], vr[FP]);\n"
# the TF32 flash forward with K or V split once a tile by the block (hi in
# place, lo in a tile of its own), so the warps load the pieces: the same
# pieces as the per-warp split, so the same bits
_FWD_HEAD = ("    T* __restrict__ o, float* __restrict__ lse, const Shape& a) {\n"
             "  constexpr int P = std::is_same<T, float>::value ? 2 : 1;   "
             "// bf16 is exact in one piece\n")
_FWD_WAIT = ("    cp_async_wait<1>();\n    __syncthreads();\n    if (k0 < warp_end) {\n"
             "      const float(*kt)[FP] = ks[it & 1];\n")


def _fwd_presplit(which):
    """The replacements that split `which` ("ks" or "vs") once a tile."""
    lo = "klo" if which == "ks" else "vlo"
    convert = f"""    cp_async_wait<1>();
    __syncthreads();
    if constexpr (P == 2) {{
      float(*cur)[FP] = {which}[it & 1];
      for (int e = threadIdx.x; e < TILE * 32; e += NT) {{
        uint32_t x[2];
        split_tf32<2>(cur[e >> 5][e & 31], x);
        cur[e >> 5][e & 31] = __uint_as_float(x[0]);
        {lo}[e >> 5][e & 31] = __uint_as_float(x[1]);
      }}
      __syncthreads();
    }}
    if (k0 < warp_end) {{
      const float(*kt)[FP] = ks[it & 1];
"""
    reps = [(_FWD_HEAD, _FWD_HEAD + f"  __shared__ __align__(16) float {lo}[TILE][FP];\n"),
            (_FWD_WAIT, convert)]
    if which == "vs":
        reps.append((_FWD_PV, """          if constexpr (P == 2) {
            const float* vl = &vlo[8 * j + 2 * t][8 * n + g];
            const uint32_t h0 = __float_as_uint(vr[0]), h1 = __float_as_uint(vr[FP]);
            const uint32_t l0 = __float_as_uint(vl[0]), l1 = __float_as_uint(vl[FP]);
            float s3[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(s3, pa.p[0], l0, l1);
            mma_tf32(s3, pa.p[1], h0, h1);
            mma_tf32(s3, pa.p[0], h0, h1);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[n][i] += s3[i];
          } else {
            mma_add<P>(acc[n], pa, vr[0], vr[FP]);
          }
"""))
    else:
        reps.append(("        first_product<P, BITS>(x[j], qa, &kt[8 * j + g][t]);\n", """        if constexpr (P == 2) {
          const float* bh = &kt[8 * j + g][t];
          const float* bl = &klo[8 * j + g][t];
          float c3[3][4];
#pragma unroll
          for (int w = 0; w < 3; ++w)
#pragma unroll
            for (int i = 0; i < 4; ++i) c3[w][i] = 0.f;
#pragma unroll
          for (int ds = 0; ds < 4; ++ds) {
            const uint32_t x0 = __float_as_uint(bh[8 * ds]), y0 = __float_as_uint(bh[8 * ds + 4]);
            const uint32_t x1 = __float_as_uint(bl[8 * ds]), y1 = __float_as_uint(bl[8 * ds + 4]);
            mma_tf32(c3[0], qa[ds].p[0], x0, y0);
            mma_tf32(c3[1], qa[ds].p[1], x0, y0);
            mma_tf32(c3[2], qa[ds].p[0], x1, y1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) x[j][i] = c3[0][i] + (c3[1][i] + c3[2][i]);
        } else {
          first_product<P, BITS>(x[j], qa, &kt[8 * j + g][t]);
        }
"""))
    return reps


# the bf16 backward's dispatch at HDP 64, and the TF32 kernels' split there
_WG64 = "  } else {   // the wgmma pair"
_BITS64 = "template <int HDP> __host__ __device__ constexpr bool tf32_bits() { return HDP >= 64; }"
_DQ_STEP = ("#pragma unroll (HDP > 64 ? 4 : 2)\n      for (int jj = 0; jj < SPW; ++jj) {\n"
            "        const int j")
_DKV_STEP = ("#pragma unroll (HDP > 64 ? 4 : 2)\n    for (int jj = 0; jj < SPW; ++jj) {\n"
             "      const int j")
# the TF32 backward at HDP 128: the 8-key (query) steps formed at once (dQ,
# dK/dV), and the warps that share a 16-row group
_STEPS = "constexpr int steps_at_once() { return HDP > 64 ? 2 : 1; }"
_GROUP = "constexpr int group_warps() { return HDP > 64 ? 2 : 1; }"
# the TF32 backward at HDP 64 with the B operands of its first and second
# products split once a tile by the block (hi in place, lo in a tile of its
# own, the integer split: the same pieces, so the same bits) instead of by
# each warp
_PRE_HELPERS = """template <typename Rows>
__device__ __forceinline__ void first_product_pre(float (&s)[4], const Rows& a, const float* bh,
                                                  const float* bl) {
  float c[3][4];
#pragma unroll
  for (int w = 0; w < 3; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[w][i] = 0.f;
#pragma unroll
  for (int ds = 0; ds < Rows::DS; ++ds) {
    const FragA<2> f = a(ds);
    const uint32_t x0 = __float_as_uint(bh[8 * ds]), y0 = __float_as_uint(bh[8 * ds + 4]);
    const uint32_t x1 = __float_as_uint(bl[8 * ds]), y1 = __float_as_uint(bl[8 * ds + 4]);
    mma_tf32(c[0], f.p[0], x0, y0);
    mma_tf32(c[1], f.p[1], x0, y0);
    mma_tf32(c[2], f.p[0], x1, y1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = c[0][i] + (c[1][i] + c[2][i]);
}

__device__ __forceinline__ void mma_add_pre(float (&c)[4], const FragA<2>& a, const float* bh,
                                            const float* bl, int FP) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.p[0], __float_as_uint(bl[0]), __float_as_uint(bl[FP]));
  mma_tf32(t, a.p[1], __float_as_uint(bh[0]), __float_as_uint(bh[FP]));
  mma_tf32(t, a.p[0], __float_as_uint(bh[0]), __float_as_uint(bh[FP]));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

"""


def _pre_pass(hi, lo, cur):
    return f"""    if constexpr (P == 2 && BITS) {{
      float(*ch)[FP] = {hi}[{cur}];
      float(*cl)[FP] = {lo[0]}, (*cm)[FP] = {lo[1]};
      float(*ch2)[FP] = {hi.replace('ks', 'vs').replace('qs', 'gs')}[{cur}];
      for (int e = threadIdx.x; e < TK * HDP; e += NT) {{
        const int r = e / HDP, d = e % HDP;
        uint32_t x[2];
        split_tf32_bits(ch[r][d], x);
        ch[r][d] = __uint_as_float(x[0]);
        cl[r][d] = __uint_as_float(x[1]);
        split_tf32_bits(ch2[r][d], x);
        ch2[r][d] = __uint_as_float(x[0]);
        cm[r][d] = __uint_as_float(x[1]);
      }}
      __syncthreads();
    }}
"""


_PRESPLIT64 = [
    ("// The backward's two first products of a step",
     _PRE_HELPERS + "// The backward's two first products of a step"),
    ("  // dO, dq: contiguous (B, Tq, H, Hd)\n",
     "  __shared__ __align__(16) float klo[TK][FP], vlo[TK][FP];\n"
     "  // dO, dq: contiguous (B, Tq, H, Hd)\n"),
    ("      cp_async_wait<1>();\n      __syncthreads();\n"
     "      const float(*kt)[FP] = ks[it & 1];\n",
     "      cp_async_wait<1>();\n      __syncthreads();\n"
     + _pre_pass("ks", ("klo", "vlo"), "it & 1")
     + "      const float(*kt)[FP] = ks[it & 1];\n"),
    ("          first_products<P, BITS>(x, d, qa, ga, &kt[8 * j + g][t], &vt[8 * j + g][t]);\n",
     """          if constexpr (P == 2 && BITS) {
            first_product_pre(x, qa, &kt[8 * j + g][t], &klo[8 * j + g][t]);
            first_product_pre(d, ga, &vt[8 * j + g][t], &vlo[8 * j + g][t]);
          } else {
            first_products<P, BITS>(x, d, qa, ga, &kt[8 * j + g][t], &vt[8 * j + g][t]);
          }
"""),
    ("          mma_add_as<P, BITS>(acc[n], dsa, kr[0], kr[FP]);\n",
     """          if constexpr (P == 2 && BITS)
            mma_add_pre(acc[n], dsa, kr, &klo[8 * j + 2 * t][8 * n + g], FP);
          else
            mma_add_as<P, BITS>(acc[n], dsa, kr[0], kr[FP]);
"""),
    ("  const int cq = g & 3;\n",
     "  __shared__ __align__(16) float qlo[TK][FP], glo[TK][FP];\n"
     "  const int cq = g & 3;\n"),
    ("    const int buf = (it - first) & 1;\n    const float(*qt)[FP] = qs[buf];\n",
     "    const int buf = (it - first) & 1;\n"
     + _pre_pass("qs", ("qlo", "glo"), "buf")
     + "    const float(*qt)[FP] = qs[buf];\n"),
    ("        first_products<P, BITS>(st, dpt, ka, va, &qt[8 * j + g][t], &gt[8 * j + g][t]);\n",
     """        if constexpr (P == 2 && BITS) {
          first_product_pre(st, ka, &qt[8 * j + g][t], &qlo[8 * j + g][t]);
          first_product_pre(dpt, va, &gt[8 * j + g][t], &glo[8 * j + g][t]);
        } else {
          first_products<P, BITS>(st, dpt, ka, va, &qt[8 * j + g][t], &gt[8 * j + g][t]);
        }
"""),
    ("        mma_add_as<P, BITS>(dva[n], pa, gr[0], gr[FP]);\n"
     "        mma_add_as<P, BITS>(dka[n], dsa, qr[0], qr[FP]);\n",
     """        if constexpr (P == 2 && BITS) {
          mma_add_pre(dva[n], pa, gr, &glo[qi][8 * n + g], FP);
          mma_add_pre(dka[n], dsa, qr, &qlo[qi][8 * n + g], FP);
        } else {
          mma_add_as<P, BITS>(dva[n], pa, gr[0], gr[FP]);
          mma_add_as<P, BITS>(dka[n], dsa, qr[0], qr[FP]);
        }
"""),
]
# the f32 score pass's stage: h and Wv split by integer rounding (the
# kernel), each k-step's three products summed in the stage's sum
_SCORE_A = "        split_tf32_bits(__uint_as_float(a[i]), p);\n"
_SCORE_B = """        mma_tf32(part[n], x.p[0], b0[1], b1[1]);
        mma_tf32(part[n], x.p[1], b0[0], b1[0]);
        mma_tf32(part[n], x.p[0], b0[0], b1[0]);
"""
_SCORE_SPLIT_B = """        split_tf32_bits(wq[8 * n], b0);
        split_tf32_bits(wq[4 * WP + 8 * n], b1);
"""
# ... the ring split once a stage by the block (hi in place, lo in a stage of
# its own after the ring), so the warps load the pieces
_SCORE_PRESPLIT = [
    ("  const size_t ring = tc_ring_bytes<T>();\n",
     "  const size_t ring = tc_ring_bytes<T>() + (sizeof(T) == 4 ? sizeof(float) * Tc<float>::BK * "
     "Tc<float>::WP : 0);\n"),
    ("    issue(s + TC_STAGES - 1);\n",
     """    issue(s + TC_STAGES - 1);
    if constexpr (KS == 8) {
      auto* st = ring + (s % TC_STAGES) * BK * WP;
      auto* lo = ring + TC_STAGES * BK * WP;
      for (int e = tid; e < BK * BV; e += TC_THREADS) {
        const int r = e / BV, c = e - r * BV;
        uint32_t x[2];
        split_tf32_bits(st[r * WP + c], x);
        st[r * WP + c] = __uint_as_float(x[0]);
        lo[r * WP + c] = __uint_as_float(x[1]);
      }
      __syncthreads();
    }
"""),
    ("    stage_products(acc, a_src, ring + (s % TC_STAGES) * BK * WP + b_off, d0,\n"
     "                   min(BK, dpad - d0) / KS);\n",
     """    if constexpr (KS == 8)
      stage_products(acc, a_src, ring + (s % TC_STAGES) * BK * WP + b_off, d0,
                     min(BK, dpad - d0) / KS, ring + TC_STAGES * BK * WP + b_off);
    else
      stage_products(acc, a_src, ring + (s % TC_STAGES) * BK * WP + b_off, d0,
                     min(BK, dpad - d0) / KS);
"""),
    ("__device__ __forceinline__ void stage_products(float (&acc)[8][4], const float* a_src,\n"
     "                                               const float* w, int d0, int steps) {\n",
     "__device__ __forceinline__ void stage_products(float (&acc)[8][4], const float* a_src,\n"
     "                                               const float* w, int d0, int steps,\n"
     "                                               const float* wl) {\n"),
    (_SCORE_SPLIT_B, """        const float* wlq = wl + 8 * q * WP;
        b0[0] = __float_as_uint(wq[8 * n]);
        b1[0] = __float_as_uint(wq[4 * WP + 8 * n]);
        b0[1] = __float_as_uint(wlq[8 * n]);
        b1[1] = __float_as_uint(wlq[4 * WP + 8 * n]);
""")]

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
        "g1": [],                                   # one image a block (TWEAKS)
        "g3": [],                                   # three images a block
        "w8": [],                                   # wide beams: 8 rows a block
        "w16": [],                                  # wide beams: 16 rows a block
        "cores": [],                                # the CUDA-core kernel
        "nohints": _HINTS_OFF,                      # no L2 eviction hints
        "nolinears": [("  const uint64_t keep = l2_policy_evict_last();\n",
                       "  const uint64_t keep = l2_policy_evict_last();\n"
                       "  if (kpairs > 0) return;\n")],
        "nocrossmath": _NO_CROSS_MATH,              # the cross-attention's math
        "nocross": _NO_CROSS_MATH + [("    if (s < total) {\n", "    if (false) {\n")],
        "noself": [("for (int task = tid >> 1; task < R * H; task += MT / 2)",
                    "for (int task = tid >> 1; task < 0; task += MT / 2)")],
        # f32 weights packed as TF32 hi and lo (pack_hilo), not split in
        # registers: twice the L2 bytes, no split of B (f32 only)
        "hilo": [("""    uint4 b0[NTW], b1[NTW];
    auto fetch = [&](uint4 (&b)[NTW], int kp) {
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        b[j] = (ok[j] && kp < kpairs) ? ldg16_hint(wp[j] + kp * 32, keep)
                                      : make_uint4(0u, 0u, 0u, 0u);
    };
    auto step = [&](const uint4 (&b)[NTW], int kp) {""", """    uint4 b0[2 * NTW], b1[2 * NTW];
    auto fetch = [&](uint4 (&b)[2 * NTW], int kp) {
#pragma unroll
      for (int j = 0; j < 2 * NTW; ++j)
        b[j] = (ok[j / 2] && kp < kpairs) ? ldg16_hint(wp[j / 2] + kp * 64 + (j & 1), keep)
                                          : make_uint4(0u, 0u, 0u, 0u);
    };
    auto step = [&](const uint4 (&b)[2 * NTW], int kp) {"""),
                 ("      wp[j] = W + ((long long)(ok[j] ? n0 + j : 0) * kpairs) * 32 + lane;",
                  "      wp[j] = W + (((long long)(ok[j] ? n0 + j : 0) * kpairs) * 32 + lane) * 2;"),
                 ("""          float s[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(s, f0, __uint_as_float(b[j].x), __uint_as_float(b[j].y));
          mma3(s, f1, __uint_as_float(b[j].z), __uint_as_float(b[j].w));""",
                  """          float s[4] = {0.f, 0.f, 0.f, 0.f};
          const uint4 h0 = b[2 * j], h1 = b[2 * j + 1];
          mma_tf32(s, f0.p[0], h0.z, h0.w);
          mma_tf32(s, f0.p[1], h0.x, h0.y);
          mma_tf32(s, f0.p[0], h0.x, h0.y);
          mma_tf32(s, f1.p[0], h1.z, h1.w);
          mma_tf32(s, f1.p[1], h1.x, h1.y);
          mma_tf32(s, f1.p[0], h1.x, h1.y);"""),
                 ("(round_up(din, KP) / KP) * 32;", "(round_up(din, KP) / KP) * 64;")],
        # f32 at pad 64: the self-attention fetching a row ahead, as the other layouts do
        "ahead": [("constexpr bool AHEAD = SW * sizeof(Word) <= 64;", "constexpr bool AHEAD = true;")],
        # f32 at pad 64: S's eight k8 steps in four chains of their own
        # (contiguous quarters), added in f32
        "s4": [(_S_CHAIN, _S_CHAINS)],
        # the linears' weight loads three k-pairs ahead of the products, not two
        "ahead3": [("""    fetch(b0, 0);
    fetch(b1, 1);
    for (int kp = 0; kp < kpairs; kp += 2) {
      step(b0, kp);
      fetch(b0, kp + 2);
      if (kp + 1 < kpairs) {
        step(b1, kp + 1);
        fetch(b1, kp + 3);
      }
    }""", """    uint4 b2[NTW];
    fetch(b0, 0);
    fetch(b1, 1);
    fetch(b2, 2);
    for (int kp = 0; kp < kpairs; kp += 3) {
      step(b0, kp);
      fetch(b0, kp + 3);
      if (kp + 1 < kpairs) {
        step(b1, kp + 1);
        fetch(b1, kp + 4);
      }
      if (kp + 2 < kpairs) {
        step(b2, kp + 2);
        fetch(b2, kp + 5);
      }
    }""")],
    },
    "score_topk": {
        "base": [],
        # the wide first passes: no row's list takes a tile
        "nolist": [("    for (int r = warp * 16; r < warp * 16 + 16 && r0 + r < N; ++r)\n",
                    "    for (int r = warp * 16; r < 0; ++r)\n")],
        # the wide first passes: no online logsumexp
        "nolse": [("                lse_update<16>(m_run[r], s_run[r], x);\n", ""),
                  ("      lse_update<4>(m_run[a], s_run[a], x);\n", "")],
        # the f32 tensor-core pass: 64-deep ring stages (one block an SM at D 300)
        "bk64": [("  static constexpr int KS = 8, BK = 32, WP = BV + 8, HP = 4;",
                  "  static constexpr int KS = 8, BK = 64, WP = BV + 8, HP = 4;")],
        # ... its stage summed with the running sum in the tensor cores
        "tcacc": [(_SCORE_B, _SCORE_B.replace("part[n]", "acc[n]"))],
        # ... each k-step's three products summed apart and added in f32
        "kstep": [(_SCORE_B, """        float t3[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(t3, x.p[0], b0[1], b1[1]);
        mma_tf32(t3, x.p[1], b0[0], b1[0]);
        mma_tf32(t3, x.p[0], b0[0], b1[0]);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] += t3[e];
""")],
        # ... h and Wv split by split_tf32<2>'s cvt.rna pair (its first build)
        "rna": [(_SCORE_A, "        split_tf32<2>(__uint_as_float(a[i]), p);\n"),
                (_SCORE_SPLIT_B, "        split_tf32<2>(wq[8 * n], b0);\n"
                                 "        split_tf32<2>(wq[4 * WP + 8 * n], b1);\n")],
        # ... the ring split once a stage by the block
        "presplit": _SCORE_PRESPLIT,
        # ... its products cut (the ring still turns, the epilogue runs)
        "nommaf32": [("    if (q < steps) {\n      uint32_t a[4];\n      ldsm_x4(a, a_src + d0 + 8 * q);",
                      "    if (q < 0) {\n      uint32_t a[4];\n      ldsm_x4(a, a_src + d0 + 8 * q);")],
    },
    "int8_conv": {
        "base": [],
        # a tile's es / b and shortcut fetched before its k-stages, not behind
        "epfirst": [("        const int b0 = m0 / hw, oh0 = (m0 - b0 * hw) / a.Wo;   // a box tile's origin\n",
                     "        const int b0 = m0 / hw, oh0 = (m0 - b0 * hw) / a.Wo;   // a box tile's origin\n"
                     "        fetch_epilogue(m0, n0);\n"),
                    ("        }\n        fetch_epilogue(m0, n0);\n      }\n", "        }\n      }\n")],
        # every 3x3 and strided site gathered by the producer (cp.async), none
        # by TMA boxes: the two loaders timed in one call
        "gather": [("  if (box_tile(Ho, Wo, &bh, &bb) && stride * Wo <= 256 && stride * bh <= 256) return A_BOX;",
                    "  if (box_tile(Ho, Wo, &bh, &bb) && stride * Wo < 0) return A_BOX;")],
        # the int8 epilogue's global stores cut
        "nostore": [("          if (rt + r < mlim && gc < a.N)\n"
                     "            *reinterpret_cast<int4*>(static_cast<int8_t*>(a.out) +",
                     "          if (rt + r < mlim && gc < 0)\n"
                     "            *reinterpret_cast<int4*>(static_cast<int8_t*>(a.out) +")],
        # the int8 epilogue's arithmetic cut (stores of the staging rows stay)
        "noepi": [("#pragma unroll\n          for (int j = 0; j < BN / 8; ++j) {",
                   "#pragma unroll\n          for (int j = 0; j < 0; ++j) {")],
        # the products cut (the ring still turns)
        "nomma": [("            Wgmma<BN>::run(acc[gi], smem_desc<BK>(at + 32 * k), smem_desc<BK>(bt + 32 * k),\n"
                   "                           kt > 0 || k > 0);\n", "")],
        # the stem's producer without its quantization, its raw fetch (16-byte
        # path) or its A-row stores (cuts)
        "stemnoquant": [("        for (int i = pt; i < 21 * (2 * RAW_BOX / 4); i += 128) {",
                         "        for (int i = pt; i < 0; i += 128) {")],
        "stemnoraw": [("        if (a.raw_tma) {\n          if (pt == 0) {",
                       "        if (a.raw_tma) {\n          if (pt == 0) mbar_arrive(raw_full(buf));\n"
                       "          if (pt < 0) {")],
        "stemnorows": [('              asm volatile("st.shared.v4.u32',
                        '              if (a.M < 0) asm volatile("st.shared.v4.u32')],
        # one epilogue buffer: the next tile's es / b and shortcut wait for
        # this tile's epilogue
        "ep1": [("      const int j = tcount & 1;\n      mbar_wait(ep_empty(j), ((tcount >> 1) & 1) ^ 1);",
                 "      const int j = 0;\n      mbar_wait(ep_empty(j), (tcount & 1) ^ 1);"),
                ("      const int ej = tcount & 1;\n      mbar_wait(ep_full(ej), (tcount >> 1) & 1);",
                 "      const int ej = 0;\n      mbar_wait(ep_full(ej), tcount & 1);")],
    },
    "flash_attention": {
        "base": [],
        # the TF32 dK/dV kernel's keep words from its counters, not Philox
        "nophilox": [("  const uint4 r = philox4x32_10(a.seed, STREAM_FLASH, "
                      "mask_row_block(a, b, h, query) + kblk);",
                      "  const uint4 r = make_uint4(query * 0x9E3779B9u, "
                      "static_cast<uint32_t>(kblk) * 0x85EBCA6Bu, 0x7fffffffu, 0xc0000000u);")],
        # the TF32 kernels' dQ, dK and dV summed by the tensor cores, not f32 adds
        # the TF32 kernels' dQ, dK and dV summed by the tensor cores, not f32 adds
        "tcacc": [("        mma_add_as<P, BITS>(acc[n], dsa, kr[0], kr[FP]);",
                   "        mma_pieces<P>(acc[n], dsa, kr[0], kr[FP]);"),
                  ("        mma_add_as<P, BITS>(dva[n], pa, gr[0], gr[FP]);\n"
                   "        mma_add_as<P, BITS>(dka[n], dsa, qr[0], qr[FP]);",
                   "        mma_pieces<P>(dva[n], pa, gr[0], gr[FP]);\n"
                   "        mma_pieces<P>(dka[n], dsa, qr[0], qr[FP]);")],
        # the bf16 backward at HDP 64 on the mma.sync pair (its first design)
        # instead of the wgmma pair
        "mma64": [(_WG64, "  } else if constexpr (HDP == 64) {\n"
                   "    err = launch_dq_mma<HDP, 4>(q, k, v, o, d_o, lse, kw, delta, dq, B, a, s);\n"
                   "    if (err) return err;\n"
                   "    return launch_dkv_mma<HDP, 4>(q, k, v, d_o, lse, delta, kw, dk, dv, B, a, s);\n"
                   + _WG64)],
        # the TF32 backward at HDP 128 one 8-key step at a time
        "jb1": [(_STEPS, _STEPS.replace("HDP > 64 ? 2 : 1", "1"))],
        # ... one warp a 16-row group (one block of four warps an SM), two
        # steps at once
        "wg1": [(_GROUP, _GROUP.replace("HDP > 64 ? 2 : 1", "1"))],

        # the TF32 backward's 8-key (query) steps unrolled once or four times, not twice
        "unroll1": [(_DQ_STEP, _DQ_STEP.replace("? 4 : 2)", "? 4 : 1)")),
                    (_DKV_STEP, _DKV_STEP.replace("? 4 : 2)", "? 4 : 1)"))],
        "unroll4": [(_DQ_STEP, _DQ_STEP.replace("? 4 : 2)", "? 4 : 4)")),
                    (_DKV_STEP, _DKV_STEP.replace("? 4 : 2)", "? 4 : 4)"))],
        "presplit64": _PRESPLIT64,
        # the wgmma dK/dV kernel held to 168 registers (three blocks an SM)
        "wg3": [("__global__ void __launch_bounds__(128) flash_bwd_dkv_wgmma_kernel(",
                 "__global__ void __launch_bounds__(128, 3) flash_bwd_dkv_wgmma_kernel(")],
        # the TF32 kernels at HDP 64 split by cvt.rna (their first design),
        # not by integer rounding
        "rna64": [(_BITS64, _BITS64.replace("HDP >= 64", "HDP == 128"))],
        # ... with only the backward's second products split by integer
        # rounding (at every head dim)
        "bits2nd": [(_BITS64, _BITS64.replace("HDP >= 64", "false")),
                    ("  if constexpr (BITS) {\n    mma_add_bits<P>(c, a, b0, b1);",
                     "  if constexpr (P == 2) {\n    mma_add_bits<P>(c, a, b0, b1);")],
        # the dQ kernel's pass 0 skipped: delta and lse2 left unwritten (cut)
        "onepass": [("  for (int pass = 0; pass < 2; ++pass) {", "  for (int pass = 1; pass < 2; ++pass) {")],
        # the TF32 forward's P V with V split by cvt.rna (its first build)
        "fwdrna": [(_FWD_PV, _FWD_PV_RNA)],
        # the TF32 forward with K, or V, split once a tile by the block
        "presplitk": _fwd_presplit("ks"),
        "presplitv": _fwd_presplit("vs"),
        # the TF32 forward's P V products cut (cut)
        "fwdnopv": [(_FWD_PV, "")],
        # the TF32 forward's S products cut: x from one shared load (cut)
        "fwdnos": [("        first_product<P, BITS>(x[j], qa, &kt[8 * j + g][t]);\n",
                    "        x[j][0] = x[j][1] = x[j][2] = x[j][3] = kt[8 * j + g][t];\n")],
        # the TF32 backward at HDP 64 on 32-row tiles (the forward's)
        "bwdtk32": [("__host__ __device__ constexpr int ftile_of() "
                     "{ return HDP > (BWD ? 64 : 32) ? 32 : 64; }",
                     "__host__ __device__ constexpr int ftile_of() { return HDP > 32 ? 32 : 64; }")],
        # the first build at HDP 64: 64-row tiles and the split operands in
        # shared memory in both directions
        "hdp64first": [("__host__ __device__ constexpr int ftile_of() "
                        "{ return HDP > (BWD ? 64 : 32) ? 32 : 64; }",
                        "__host__ __device__ constexpr int ftile_of() { return HDP > 64 ? 32 : 64; }"),
                       ("__host__ __device__ constexpr bool split_smem() "
                        "{ return HDP > (BWD ? 64 : 32); }",
                        "__host__ __device__ constexpr bool split_smem() { return HDP > 32; }")],
        # 16-byte staging at HDP 32 as well (the branch in the first build)
        "vec32": [("  if (HDP > 32 && vec) {\n    constexpr int LPR = HDP / 8",
                   "  if (vec) {\n    constexpr int LPR = HDP / 8"),
                  ("    if (HDP > 32 && vec) {   // as in stage_rows",
                   "    if (vec) {   // as in stage_rows")],
        # no 16-byte staging at any head dim (compiled out, as at HDP 32)
        "novec": [("  if (HDP > 32 && vec) {\n    constexpr int LPR = HDP / 8",
                   "  if (false && vec) {\n    constexpr int LPR = HDP / 8"),
                  ("    if (HDP > 32 && vec) {   // as in stage_rows",
                   "    if (false && vec) {   // as in stage_rows")],
        # the TF32 forward with no register bound at HDP 32 (ptxas's own choice)
        "nolb": [("__global__ void __launch_bounds__(NW * 32, 16 / NW) flash_fwd_tf32_hd32_kernel(",
                  "__global__ void __launch_bounds__(NW * 32) flash_fwd_tf32_hd32_kernel(")],
        # the forward's split Q in registers at HDP 64 as well
        "fwdregs": [("__host__ __device__ constexpr bool split_smem() "
                     "{ return HDP > (BWD ? 64 : 32); }",
                     "__host__ __device__ constexpr bool split_smem() { return HDP > 64; }")],
    },
}
CUTS = {"fused_norm": {"noshfl", "copyonly", "computeonly"},
        "decoder_step": {"nolinears", "nocrossmath", "nocross", "noself"},
        "score_topk": {"nolist", "nolse", "nommaf32"},
        "flash_attention": {"nophilox", "onepass", "fwdnopv", "fwdnos"},
        "int8_conv": {"nostore", "noepi", "nomma", "stemnoquant", "stemnoraw", "stemnorows"}}
# decoder_step: the wrapper's choices changed (images a block, rows a block of
# a wide beam's image, the CUDA-core kernel for every call)
TWEAKS = {"g1": dict(images=1), "g3": dict(images=3), "w8": dict(wide_rows=8),
          "w16": dict(wide_rows=16), "cores": dict(cores=True), "hilo": dict(hilo=True)}


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


def _device_split(fn, parts, reps: int = 20) -> dict:
    """Device ms a call of the kernels whose names hold each of `parts`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {part: sum(ms for name, ms in spans if part in name) / reps for part in parts}


def _device_ms(fn, part: str, reps: int = 20) -> float:
    """Device ms a call of the kernels whose names hold `part`."""
    return _device_split(fn, (part,), reps)[part]


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


def beam_inputs(step: int, B: int = 256, K: int = 5, L: int = 30, M: int = 497, seed: int = 0,
                dtype=torch.bfloat16, D: int = 300, H: int = 10, F: int = 512):
    """The geo decoder (3 layers, D 300, H 10, F 512; or the widths given,
    such as --geometry 512x8's D 512, H 8) in `dtype` at step `step`."""
    from icek_torch.kernels import decoder_step as dsk
    from icek_torch.models import transformer as tfm

    nL = 3
    g = torch.Generator().manual_seed(seed)
    layers = tfm.init_decoder_stack(g, nL, D, F)
    layers = {"layers": [{k: _to(v, dtype) for k, v in lay.items()} for lay in layers["layers"]]}
    stacked = dsk.stack_decoder_params(layers, dtype)
    rnd = lambda *s: torch.randn(s, generator=g).to("cuda", dtype)
    x = rnd(B, K, D)
    caches = torch.zeros((2, nL, B, L * K, D), dtype=dtype, device="cuda")
    caches[:, :, :, :step * K] = rnd(2, nL, B, step * K, D)
    ck, cv = caches[0].contiguous(), caches[1].contiguous()
    xk, xv = rnd(nL, B, M, D), rnd(nL, B, M, D)
    anc = torch.randint(0, K, (B, K, L), generator=g, dtype=torch.int32)
    anc[:, :, step:] = torch.arange(K, dtype=torch.int32)[None, :, None]
    heads = None
    if D // H <= 32 or dsk.uses_tensor_cores(stacked, ck, K, H):
        heads = dsk.pad_cross_heads([{"k": xk[l].view(B, M, H, D // H),
                                      "v": xv[l].view(B, M, H, D // H)} for l in range(nL)], dtype)
    return stacked, x, anc.cuda(), ck, cv, xk, xv, heads, H


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to("cuda", dtype)


_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def pack_hilo(w):
    """(nL, din, dout) f32 -> (nL, dout/8, din/16, 32, 2, 4): pack_tf32's order
    with each k8 step's (b0, b1) as TF32 hi then lo (hi = the rna rounding,
    lo = w - hi), a 16-byte word a k8 step (the ``hilo`` variant)."""
    from icek_torch.kernels import decoder_step as dsk

    p = dsk.pack_tf32(w)                                    # (..., 32, 4): step 0 b0 b1, step 1
    bits = p.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = p - hi
    v = torch.stack([hi.view(*p.shape[:-1], 2, 2), lo.view(*p.shape[:-1], 2, 2)], dim=-2)
    return v.reshape(*p.shape[:-1], 2, 4).contiguous()     # per step: hi b0 b1, lo b0 b1


def decoder_step_cases(args):
    """(dtype names, (B, K) shapes, steps, (D, H) widths) of the decoder_step
    timer's args; a width is written w<D>x<H> (w512x8), default the geo
    decoder's 300x10."""
    dtypes = [a for a in args if a in _DTYPES] or ["bf16"]
    shapes = [tuple(int(v) for v in a.split("x")) for a in args
              if "x" in a and not a.startswith("w")] or [(256, 5)]
    steps = [int(a) for a in args if a.isdigit()] or [15]
    widths = [tuple(int(v) for v in a[1:].split("x")) for a in args if a.startswith("w")]
    return dtypes, shapes, steps, widths or [(300, 10)]


def time_decoder_step(name: str, args, save: str = None) -> None:
    from icek_torch.kernels import decoder_step as dsk

    tweak = TWEAKS.get(name, {})
    if "images" in tweak:
        dsk.images_per_block = lambda B, K, sms, G=tweak["images"]: G
    if "wide_rows" in tweak:
        n = tweak["wide_rows"]
        dsk.image_parts = lambda B, K, sms: 1 if K <= dsk.ROWS else -(-K // n)
    dtypes, shapes, steps, widths = decoder_step_cases(args)
    outputs = {}
    for (D, H), dt, (B, K), step in ((w, d, s, t) for w in widths for d in dtypes
                                     for s in shapes for t in steps):
        stacked, x, anc, ck, cv, xk, xv, heads, H = beam_inputs(
            step, B, K, dtype=_DTYPES[dt], D=D, H=H)
        if tweak.get("cores"):
            stacked = stacked._replace(mma=None)
        if tweak.get("hilo"):
            stacked = stacked._replace(mma=dsk.PackedLinears(*(pack_hilo(w) for w in (
                stacked.qkv_w, stacked.so_w, stacked.cq_w, stacked.co_w, stacked.f1_w,
                stacked.f2_w))))
        want = dsk.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step,
                                          num_heads=H)
        if D // H > 32 and not dsk.uses_tensor_cores(stacked, ck, K, H):
            # the CUDA-core kernel on unpadded K/V (a tree without the
            # pad-64 layout pads no head wider than 32)
            run = lambda: dsk.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv,
                                                      step, num_heads=H)
        else:
            run = lambda: dsk.fused_beam_decoder_step(
                stacked, x, anc, ck, cv, None, None, step, num_heads=H,
                cross_heads=heads)
        got = run()
        label = "" if (D, H) == (300, 10) else f"{D}x{H} "
        outputs[f"{label}{dt} {B}x{K} step {step}"] = [t.cpu() for t in got]
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        tol = 0.15 if dt == "bf16" else 1e-3
        print(f"{name} {label}{dt} B {B} K {K} step {step}: {_event_ms(run):.4f} ms "
              f"({_held('decoder_step', name, 'step', err, tol)})", flush=True)
    if save:
        torch.save(outputs, save)


def _shifted(h):
    """h's values 4 bytes into a buffer of their own (no 16-byte copies)."""
    buf = torch.empty(h.numel() + 1, dtype=h.dtype, device=h.device)
    buf[1:].copy_(h.reshape(-1))
    return buf[1:].view(h.shape)


def score_inputs(dtype, n: int = 640, t: int = 301, seed: int = 1):
    """h (n, 300), Wv (300, 10000), bv and an (n, t) tail on the card, as
    chip_smoke.py's score records draw them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((n, 300), generator=g, device="cuda")
    wv = ((torch.rand((300, 10000), generator=g, device="cuda") * 2 - 1) * 0.1).to(dtype)
    bv = torch.randn((10000,), generator=g, device="cuda") * 0.01
    tail = torch.randn((n, t), generator=g, device="cuda")
    return h.to(dtype), wv, bv, tail


def time_score_topk(name: str, args) -> None:
    from icek_torch.kernels import copy_scores as cs

    n = int(args[1]) if len(args) > 1 else 640
    for k in [int(a) for a in (args[0] if args else "20").split(",")]:
        for dtype in (torch.bfloat16, torch.float32):
            h, wv, bv, tail = score_inputs(dtype, n)
            run = lambda: cs.fused_score_topk(h, wv, bv, tail, k=k)
            got, want = run(), cs.reference_score_topk(h, wv, bv, tail, k=k)
            err = max(float((a - b).abs().max()) for a, b in ((got[0], want[0]), (got[2], want[2])))
            differ = int((got[1] != want[1]).sum())
            # against the exact (float64) values: the arithmetic's own error
            exact = torch.cat([h.double() @ wv.double() + bv.double(), tail.double()], dim=1)
            f64 = float((got[0].double() - exact.topk(k, dim=1).values).abs().max())
            del exact
            parts = _device_split(run, ("score_partial", "score_merge"))
            cores = ""
            if dtype == torch.float32 and k <= 16 and hasattr(cs, "aligned"):
                hc = _shifted(h)
                cores_run = lambda: cs.fused_score_topk(hc, wv, bv, tail, k=k)
                cores = f", CUDA-core pass {_event_ms(cores_run):.4f} ms"
            print(f"{name} {str(dtype)[6:]} N {n} k {k}: {_event_ms(run):.4f} ms, "
                  f"first pass {parts['score_partial']:.4f} ms, merge "
                  f"{parts['score_merge']:.4f} ms{cores}, {differ} indices differ from the "
                  f"plain version's, values {f64:.3g} from float64 "
                  f"({_held('score_topk', name, 'values / lse', err, 1e-4)})", flush=True)


def flash_inputs(dtype=torch.float32, B: int = 256, T: int = 301, H: int = 10, Hd: int = 30,
                 Tk: int = None):
    """q, k, v (autograd leaves, strided views of one fused QKV projection,
    or with Tk a Q and a fused KV projection) and a d_out at the geo
    encoder site (T 301) or another site of T queries and Tk keys."""
    g = torch.Generator(device="cuda").manual_seed(0)
    if Tk is None or Tk == T:
        qkv = torch.randn((B, T, 3 * H * Hd), generator=g, device="cuda").to(dtype)
        views = [t.view(B, T, H, Hd) for t in qkv.split(H * Hd, dim=-1)]
    else:
        q = torch.randn((B, T, H * Hd), generator=g, device="cuda").to(dtype)
        kv = torch.randn((B, Tk, 2 * H * Hd), generator=g, device="cuda").to(dtype)
        views = [q.view(B, T, H, Hd)] + [t.view(B, Tk, H, Hd) for t in kv.split(H * Hd, dim=-1)]
    leaves = [t.detach().requires_grad_(True) for t in views]
    return leaves, torch.randn((B, T, H, Hd), generator=g, device="cuda").to(dtype)


def time_flash_attention(name: str, args, save: str = None) -> None:
    outs = {}
    for heads in (args[1] if len(args) > 1 else "10x30").split(","):
        H, Hd = (int(x) for x in heads.split("x"))
        for site in (args[3] if len(args) > 3 else "301x301").split(","):
            tq, tk = (int(x) for x in site.rstrip("c").split("x"))
            for dt in (args[2] if len(args) > 2 else "f32").split(","):
                _time_flash(name, args, {"f32": torch.float32, "bf16": torch.bfloat16}[dt], H,
                            Hd, outs, tq, tk, site.endswith("c"))
    if save:
        torch.save(outs, save)


def _time_flash(name, args, dtype, H, Hd, outs, tq=301, tk=301, causal=False) -> None:
    from icek_torch.kernels import flash_attention as fa

    leaves, d_out = flash_inputs(dtype, T=tq, H=H, Hd=Hd, Tk=tk)
    B, T, H, _ = d_out.shape
    Tk = leaves[1].shape[1]
    q, k, v = (t.detach() for t in leaves)
    label = (f"{str(dtype)[6:]} {H}x{Hd} geo encoder" if (tq, tk, causal) == (301, 301, False)
             else f"{str(dtype)[6:]} {H}x{Hd} {tq}x{tk}{' causal' if causal else ''}")
    ftol, btol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 4e-2)
    for rate in [float(a) for a in (args[0] if args else "0,0.2").split(",")]:
        keep = fa.keep_mask(B, H, T, Tk, rate=rate, seed=77, device="cuda") if rate else None
        fwd = lambda: fa.flash_mha(q, k, v, causal=causal, dropout_rate=rate, seed=77)
        ref = fa.reference_mha(q, k, v, causal=causal, dropout_rate=rate, keep=keep)
        got = fwd()
        outs[f"{label} rate {rate} forward"] = got.cpu()
        err = float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))
        cores = ""
        # a tree with routes, and the CUDA-core forward's dropout (Hd <= 32)
        if hasattr(fa, "route") and (rate == 0 or Hd <= 32):
            cores_run = lambda: fa._forward(q, k, v, Tk, causal, rate, 77, via="cuda_cores")[0]
            cores = f", CUDA-core forward {_event_ms(cores_run):.4f} ms"
        if dtype == torch.bfloat16 and Hd > 32 and hasattr(fa, "uses_wgmma_forward"):
            # device ms (torch.profiler, 100 calls a session) of the routed
            # forward and of the mma.sync forward, in three alternating rounds
            sync = lambda: fa._forward(q, k, v, Tk, causal, rate, 77, via="mma_sync")[0]
            rounds = [(_device_ms(fwd, "flash_fwd", 100), _device_ms(sync, "flash_fwd", 100))
                      for _ in range(3)]
            cores += (", device " + " / ".join(f"{a:.4f}" for a, _ in rounds)
                      + " ms, mma.sync forward device " + " / ".join(f"{b:.4f}" for _, b in rounds)
                      + " ms")
        print(f"{name} {label} rate {rate}: forward {_event_ms(fwd):.4f} ms{cores} "
              f"({_held('flash_attention', name, 'forward', err, ftol)})", flush=True)
        del ref, keep
        out = fa.flash_mha(*leaves, causal=causal, dropout_rate=rate, seed=77)
        bwd = lambda: torch.autograd.grad(out, leaves, d_out, retain_graph=True)
        keep = fa.keep_mask(B, H, T, Tk, rate=rate, seed=77, device="cuda") if rate else None
        ref = fa.reference_mha(*leaves, causal=causal, dropout_rate=rate, keep=keep)
        want = torch.autograd.grad(ref, leaves, d_out)
        got = bwd()
        outs[f"{label} rate {rate} backward"] = [x.cpu() for x in got]
        err = max(float((a.float() - b.float()).abs().max()) / max(1.0, float(b.abs().max()))
                  for a, b in zip(got, want))
        del ref, want, keep
        parts = _device_split(bwd, ("bwd_dq", "bwd_dkv"))
        print(f"{name} {label} rate {rate}: backward {_event_ms(bwd):.4f} ms, dQ "
              f"{parts['bwd_dq']:.4f} ms, dK/dV {parts['bwd_dkv']:.4f} ms "
              f"({_held('flash_attention', name, 'backward', err, btol)})", flush=True)
        del out


# chip_smoke.py's INT8_SITES at 256x256 images: the five site kinds, 1x1 / 1
# with each of its epilogues (timed, not in the per-encode sum)
INT8_SITES = (("stem_int8", 256, 3, 64, 7, 2, "q8"), ("conv", 16, 1024, 256, 1, 1, "q8"),
              ("conv", 16, 256, 1024, 1, 1, "q8_q8sc"), ("conv", 32, 128, 512, 1, 1, "q8_f32sc"),
              ("conv", 64, 256, 512, 1, 2, "f32"), ("conv", 16, 256, 256, 3, 1, "q8"),
              ("conv", 64, 128, 128, 3, 2, "q8"))
# the int8 max pool at the encode's stem output (64 x 64 images' is 128 x 128
# at 256 x 256) and at odd sides: (kind, H, W, C)
POOL_SITES = (("pool", 128, 128, 64), ("pool", 67, 67, 64))


def int8_units():
    """[(site key, launches an encode)]: the encode's distinct sites, the
    stem's int8 launch (counted in a parent's 104-launch sum) and
    ``INT8_SITES`` (0)."""
    from icek_torch.models import resnet_int8

    units = sorted(resnet_int8.encode_sites(256).items(), key=str)
    return [list(k) for k, _ in units], [n for _, n in units]


def _int8_inputs(key, batch: int):
    """Seeded inputs of site `key` (the same in every process) and its run
    and plain version, through whatever entry points this tree's package has."""
    import zlib

    from icek_torch.kernels import int8_conv as k8

    g = torch.Generator(device="cuda").manual_seed(zlib.crc32(repr(key).encode()))
    dev = torch.device("cuda")
    i8 = lambda lo, *shape: torch.randint(lo, 128, shape, generator=g, device=dev,
                                          dtype=torch.int8)

    def site(cin, cout, k):
        K = k * k * cin
        return {"wq": i8(-127, cout, k, k, cin),
                "es": (torch.rand(cout, generator=g, device=dev) + 0.5) / (127.0 * 64 * K ** 0.5),
                "b": torch.randn(cout, generator=g, device=dev) * 0.1}

    inv = torch.tensor(127 / 3.0)
    kind = key[0]
    if kind == "pool":
        xq = i8(-128, batch, *key[1:])
        return (lambda: k8.max_pool(xq)), (lambda: k8.reference_max_pool(xq)), 1
    if kind in ("stem", "stem_int8"):
        side = key[1]
        images = torch.randn((batch, 3, side, side), generator=g, device=dev).permute(0, 2, 3, 1)
        st, inv_img = site(3, 64, 7), torch.tensor(127 / 4.0)
        if kind == "stem_int8":
            xq = k8.quantize_images(images, inv_img) if hasattr(k8, "quantize_images") else \
                torch.clamp(torch.round(images * inv_img), -127, 127).to(torch.int8)
            return (lambda: k8.conv_site(xq, st, 2, inv=inv)), \
                (lambda: k8.reference_site(xq, st, 2, inv=inv)), 1
        if hasattr(k8, "stem_site"):
            run = lambda: k8.stem_site(images, st, inv_img, inv)
        else:
            run = lambda: k8.conv_site(torch.clamp(torch.round(images.to(torch.float32) * inv_img),
                                                   -127, 127).to(torch.int8).contiguous(),
                                       st, 2, inv=inv)
        plain = lambda: k8.reference_site(torch.clamp(torch.round(images * inv_img), -127, 127)
                                          .to(torch.int8), st, 2, inv=inv)
        return run, plain, 1
    if kind == "fused":
        _, side, cin, cmid, cout, s = key
        ho = k8.out_hw(side, 1, s)
        xq, out = i8(0, batch, side, side, cin), i8(0, batch, ho, ho, cmid)
        c3, dn = site(cmid, cout, 1), site(cin, cout, 1)
        if hasattr(k8, "fused_site"):
            run, launches = (lambda: k8.fused_site(out, xq, c3, dn, s, inv)), 1
        else:
            run, launches = (lambda: k8.conv_site(out, c3, 1, inv=inv,
                                                  shortcut=k8.conv_site(xq, dn, s))), 2
        plain = lambda: k8.reference_site(out, c3, 1, inv, shortcut=k8.reference_site(xq, dn, s))
        return run, plain, launches
    _, side, cin, cout, k, s, mode = key
    x, st = i8(0, batch, side, side, cin), site(cin, cout, k)
    ho = k8.out_hw(side, k, s)
    kw = dict(inv=None if mode == "f32" else inv)
    if mode == "q8_q8sc":
        kw.update(shortcut=i8(0, batch, ho, ho, cout), a_x=torch.tensor(1 / 127.0))
    elif mode == "q8_f32sc":
        kw.update(shortcut=torch.randn((batch, ho, ho, cout), generator=g, device=dev))
    return (lambda: k8.conv_site(x, st, s, **kw)), (lambda: k8.reference_site(x, st, s, **kw)), 1


def time_int8_conv(name: str, args, save: str = None) -> None:
    import json

    from icek_torch.kernels import int8_conv as k8

    batch = int(args[0]) if args and args[0].isdigit() else 256
    keys, counts = json.loads(args[1]) if len(args) > 1 else int8_units()
    keys = [tuple(k) for k in keys] + [tuple(k) for k in INT8_SITES + POOL_SITES]
    counts = list(counts) + [0] * len(INT8_SITES + POOL_SITES)
    if len(args) > 2:                   # only the sites of these kinds
        kinds = args[2].split(",")
        keys, counts = zip(*[(k, n) for k, n in zip(keys, counts) if k[0] in kinds])
    outputs, unit_ms, total, launches = {}, {}, 0.0, 0
    for key, count in zip(keys, counts):
        run, plain, n = _int8_inputs(key, batch)
        got = run()
        torch.cuda.synchronize()
        diff = int((got != plain()).sum())
        if diff and name not in CUTS["int8_conv"]:
            raise RuntimeError(f"int8_conv variant {name!r} {key}: {diff} outputs differ from "
                               f"the plain version")
        outputs[repr(key)] = got.cpu()
        unit_ms[key[0]] = ms = _event_ms(run, iters=10)
        held = f"{diff} outputs differ (a cut)" if diff else "bit-equal to the plain version"
        print(f"{name} {key} batch {batch}: {ms:.4f} ms, {n} launch(es), host "
              f"{_host_us(run):.1f} us a call, x {count} an encode, {held}", flush=True)
        total += count * ms
        launches += count * n
        del run, plain, got
    # the site launches alone: a tree without stem_site quantized with torch ops first
    kernels = total if hasattr(k8, "stem_site") or "stem" not in unit_ms else \
        total - unit_ms["stem"] + unit_ms["stem_int8"]
    print(f"{name} per-encode sum: {total:.4f} ms as the encode runs its sites, "
          f"{kernels:.4f} ms over its {launches} site launches alone (batch {batch})",
          flush=True)
    if save:
        torch.save(outputs, save)


def _host_us(run, reps: int = 50) -> float:
    """The wrapper's host cost a call (us) while the device runs ahead."""
    import time

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


TIMERS = {"fused_norm": time_fused_norm, "decoder_step": time_decoder_step,
          "score_topk": time_score_topk, "flash_attention": time_flash_attention,
          "int8_conv": time_int8_conv}
# timers that save their outputs, compared with the parent's bit for bit
SAVES = {"decoder_step": time_decoder_step, "int8_conv": time_int8_conv,
         "flash_attention": time_flash_attention}


def _nvcc(src_path: str, include: str, out: str):
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.FLAGS, "-I", include, "-o", out, src_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(source: str, names, args, parent: str = None) -> None:
    out_dir = os.path.join(_build.BUILD_DIR, "variants", source)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, source + ".cu")) as f:
        src = f.read()
    procs = {}
    for name in names:
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(source, name, src))
        procs[name] = _nvcc(path, _build.CSRC, path[:-3] + ".so")
    if parent:
        parent_csrc = os.path.join(os.path.abspath(parent), "icek_torch", "csrc")
        procs["parent"] = _nvcc(os.path.join(parent_csrc, source + ".cu"), parent_csrc,
                                os.path.join(out_dir, "parent.so"))
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} variant {name!r}:\n{log}")
        if name in (names[0], "parent"):
            for line in log.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"ptxas {source} {name}: {line.strip()}", flush=True)
    print(f"{torch.cuda.get_device_name(0)}; variants {', '.join(names)} of {source}.cu"
          + (f", and {parent}'s as parent" if parent else ""), flush=True)
    if source == "int8_conv":         # one list of sites for this tree and the parent
        import json

        args = [args[0] if args else "256", json.dumps(int8_units())] + list(args[1:])
    order = list(names) + list(names)[::-1]
    for name in (["parent"] + order + ["parent"]) if parent else order:
        so = os.path.join(out_dir, name + ".so")
        if name == "parent":        # this timer against the other tree's package
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", source, name, so,
                            *args], check=True, cwd=parent,
                           env=dict(os.environ, PYTHONPATH=os.path.abspath(parent)))
        else:
            subprocess.run([sys.executable, "-m", "icek_torch.kernels._variants", "--one", source,
                            name, so, *args], check=True)
    if parent and source in SAVES:
        same_bits(os.path.join(out_dir, "parent.pt"), os.path.join(out_dir, names[0] + ".pt"))


def same_bits(parent_pt: str, base_pt: str) -> None:
    """Print, case by case, whether the parent's outputs and the first
    variant's are the same bits."""
    want, got = torch.load(parent_pt), torch.load(base_pt)
    for case, outs in got.items():
        outs, ref = (outs, want[case]) if isinstance(outs, list) else ([outs], [want[case]])
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, ref))
        same = all(torch.equal(a, b) for a, b in zip(outs, ref))
        print(f"parent vs {os.path.basename(base_pt)[:-3]} {case}: "
              f"{'bit-equal' if same else f'differ, max abs {diff:.3g}'}", flush=True)


if __name__ == "__main__":
    argv = sys.argv[1:]
    root = None
    if len(argv) >= 2 and argv[0] == "--parent":
        root, argv = argv[1], argv[2:]
    if len(argv) >= 4 and argv[0] == "--one":
        _build.use_variant(argv[1], argv[3])
        if argv[1] in SAVES:
            SAVES[argv[1]](argv[2], argv[4:], save=argv[3][:-3] + ".pt")
        else:
            TIMERS[argv[1]](argv[2], argv[4:])
    elif len(argv) >= 2 and argv[0] in VARIANTS:
        main(argv[0], argv[1].split(","), argv[2:], root)
    else:
        sys.exit(__doc__)
