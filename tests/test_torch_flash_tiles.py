"""The tiling of the tensor-core flash-attention kernels
(``icek_torch/csrc/flash_attention.cu``), emulated in torch on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what they
do tile by tile is written out here with the same loop bounds, skip rules
and masks, and held against the plain version:

* forward: a block of 64 (32 when Tq <= 32) query rows, a warp of 16, key
  tiles of 64; tiles beyond ``kv_len`` or above the diagonal are skipped,
  the straddling tile is masked by element; online softmax in the log2
  domain; the logsumexp is saved; dropout(P) is rounded to the working
  dtype before its product with V;
* dQ: the same walk, 32 keys at a time, P recomputed from the logsumexp,
  delta = rowsum(dO * O), dS rounded to the working dtype before dS K;
* dK/dV: a warp of 16 keys, query tiles of 64 walked 32 queries at a time
  from the block's own diagonal, transposed scores, P^T and dS^T rounded.

The mask is an explicit ``keep`` tensor.  f32 results are held to 1e-5
against ``reference_mha`` and its autograd (same math, another summation
order); two shapes also against the JAX package's Pallas kernel in
interpret mode at rate 0, atol 2e-5 as tests/test_torch_kernels.py and
tests/test_torch_norm.py hold the plain version; bf16 to the card's
tolerances (3e-2 forward, 4e-2 backward of the largest expected value).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import flash_attention as tfa
from icek_tpu.kernels import flash_attention as jfa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small torch ops; with the suite's other
    workers on the same cores, torch's thread pool waits at every op's
    barrier for threads that are not running.  One thread each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TILE, CHUNK, WARP = 64, 32, 16
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _rounded(x, dtype):
    return x.to(dtype).to(torch.float32)


def _heads_first(t):
    return t.to(torch.float32).permute(0, 2, 1, 3)          # (B, H, T, Hd)


def _row_end(rows, kv_len, causal):
    """Keys each of `rows` may see: [0, end)."""
    return torch.clamp(rows + 1, max=kv_len) if causal else torch.full_like(rows, kv_len)


def tiled_forward(q, k, v, *, kv_len, causal, rate=0.0, keep=None):
    """(out (B, Tq, H, Hd) in q's dtype, lse (B, H, Tq) f32)."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf = map(_heads_first, (q, k, v))
    c = LOG2E / math.sqrt(Hd)
    block = WARP * (4 if Tq > 32 else 2)
    out = torch.zeros((B, H, Tq, Hd))
    lse = torch.zeros((B, H, Tq))
    for blk0 in range(0, Tq, block):
        blk_end = min(kv_len, blk0 + block) if causal else kv_len
        for row0 in range(blk0, min(blk0 + block, Tq), WARP):
            rows = torch.arange(row0, min(row0 + WARP, Tq))
            warp_end = min(kv_len, row0 + WARP) if causal else kv_len
            m = torch.full((B, H, len(rows)), -math.inf)
            l = torch.zeros((B, H, len(rows)))
            acc = torch.zeros((B, H, len(rows), Hd))
            for k0 in range(0, blk_end, TILE):
                if k0 >= warp_end:
                    continue
                keys = torch.arange(k0, min(k0 + TILE, Tk))
                s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
                if k0 + TILE > kv_len or (causal and k0 + TILE > row0 + 1):
                    hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
                    s = s.masked_fill(hidden, -math.inf)
                m_new = torch.maximum(m, s.amax(-1) * c)
                assert torch.isfinite(m_new).all()      # key 0 is visible to every row
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * c - m_new[..., None])
                l = l * alpha + p.sum(-1)               # the sum takes every key
                if keep is not None:
                    p = torch.where(keep[:, :, rows][..., keys], p, 0.0)
                acc = acc * alpha[..., None] + _rounded(p, q.dtype) @ vf[:, :, keys]
                m = m_new
            out[:, :, rows] = acc * (1.0 / (1.0 - rate) / l)[..., None]
            lse[:, :, rows] = (m + torch.log2(l)) * LN2
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def tiled_dq(q, k, v, out, d_out, lse, *, kv_len, causal, rate=0.0, keep=None):
    """(dq (B, Tq, H, Hd) in q's dtype, delta (B, H, Tq) f32)."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf, of, gf = map(_heads_first, (q, k, v, out, d_out))
    scale, inv = 1.0 / math.sqrt(Hd), 1.0 / (1.0 - rate)
    delta = (of * gf).sum(-1)
    block = WARP * (4 if Tq > 32 else 2)
    dq = torch.zeros((B, H, Tq, Hd))
    for blk0 in range(0, Tq, block):
        blk_end = min(kv_len, blk0 + block) if causal else kv_len
        for row0 in range(blk0, min(blk0 + block, Tq), WARP):
            rows = torch.arange(row0, min(row0 + WARP, Tq))
            warp_end = min(kv_len, row0 + WARP) if causal else kv_len
            acc = torch.zeros((B, H, len(rows), Hd))
            for kc in range(0, -(-blk_end // TILE) * TILE, CHUNK):
                if kc >= warp_end:
                    continue
                keys = torch.arange(kc, min(kc + CHUNK, Tk))
                s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
                dp = gf[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
                p = torch.exp2((s * scale - lse[:, :, rows, None]) * LOG2E)
                if not (kc + CHUNK <= kv_len and (not causal or kc + CHUNK <= row0 + 1)):
                    hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
                    p = p.masked_fill(hidden, 0.0)
                if keep is not None:
                    dp = torch.where(keep[:, :, rows][..., keys], dp * inv, 0.0)
                ds = _rounded(p * (dp - delta[:, :, rows, None]), q.dtype)
                acc = acc + ds @ kf[:, :, keys]
            dq[:, :, rows] = acc * scale
    return dq.permute(0, 2, 1, 3).to(q.dtype), delta


def tiled_dkv(q, k, v, d_out, lse, delta, *, kv_len, causal, rate=0.0, keep=None):
    """(dk, dv), (B, Tk, H, Hd) in k's dtype."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf, gf = map(_heads_first, (q, k, v, d_out))
    live = (torch.arange(Tk) < kv_len)[:, None]      # rows at or beyond kv_len load as zero
    kf, vf = kf * live, vf * live
    scale, inv = 1.0 / math.sqrt(Hd), 1.0 / (1.0 - rate)
    block = WARP * (4 if Tk > 32 else 2)
    dk = torch.zeros((B, H, Tk, Hd))
    dv = torch.zeros((B, H, Tk, Hd))
    for blk0 in range(0, Tk, block):
        first = blk0 // TILE if causal else 0
        last = -(-Tq // TILE) if blk0 < kv_len else first
        for key0 in range(blk0, min(blk0 + block, Tk), WARP):
            keys = torch.arange(key0, min(key0 + WARP, Tk))
            for qc in range(first * TILE, last * TILE, CHUNK):
                if qc >= Tq or (causal and qc + CHUNK - 1 < key0):
                    continue
                rows = torch.arange(qc, min(qc + CHUNK, Tq))
                st = kf[:, :, keys] @ qf[:, :, rows].transpose(-1, -2)
                dpt = vf[:, :, keys] @ gf[:, :, rows].transpose(-1, -2)
                p = torch.exp2((st * scale - lse[:, :, None, rows]) * LOG2E)
                if not (qc + CHUNK <= Tq and key0 + WARP <= kv_len
                        and (not causal or key0 + WARP - 1 <= qc)):
                    hidden = keys[:, None] >= kv_len
                    if causal:
                        hidden = hidden | (keys[:, None] > rows[None, :])
                    p = p.masked_fill(hidden, 0.0)
                pd = p
                if keep is not None:
                    kept = keep[:, :, rows][..., keys].transpose(-1, -2)
                    pd = torch.where(kept, p * inv, 0.0)
                    dpt = torch.where(kept, dpt * inv, 0.0)
                ds = _rounded(p * (dpt - delta[:, :, None, rows]), q.dtype)
                dv[:, :, keys] += _rounded(pd, q.dtype) @ gf[:, :, rows]
                dk[:, :, keys] += ds @ qf[:, :, rows]
    return tuple((t * s).permute(0, 2, 1, 3).to(k.dtype) for t, s in ((dk, scale), (dv, 1.0)))


def tiled_attention(q, k, v, d_out, **kw):
    out, lse = tiled_forward(q, k, v, **kw)
    dq, delta = tiled_dq(q, k, v, out, d_out, lse, **kw)
    return (out, dq) + tiled_dkv(q, k, v, d_out, lse, delta, **kw)


def _inputs(seed, tq, tk, B=2, H=2, Hd=30):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, Hd)).astype(np.float32) for t in (tq, tk, tk, tq)]


def _keep(seed, rate, B, H, tq, tk):
    if not rate:
        return None
    rng = np.random.default_rng(seed + 1000)
    return torch.as_tensor(rng.random((B, H, tq, tk)) < 1.0 - rate)


def _plain(q, k, v, d_out, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.reference_mha(*leaves, dropout_rate=kw.pop("rate"), **kw)
    return (out.detach(),) + torch.autograd.grad(out, leaves, d_out)


# the three shapes of the geo train step, then ragged ones around the 16-row,
# 32-key and 64-key tile edges
SHAPES = [(301, 301, 301, False), (32, 32, 32, True), (32, 497, 497, False),
          (1, 1, 1, False), (15, 17, 17, False), (65, 129, 129, False),
          (13, 37, 30, False), (70, 70, 70, True), (65, 129, 100, True),
          (129, 65, 40, True)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("tq,tk,kv_len,causal", SHAPES)
def test_tiled_flash_matches_plain_f32(tq, tk, kv_len, causal, rate):
    """Output, dq, dk, dv of the tile walk against the plain version and its
    autograd under the same mask, f32, atol 1e-5; keys at or beyond kv_len
    get exactly zero gradients."""
    q, k, v, g = map(torch.as_tensor, _inputs(tq * 1000 + tk, tq, tk))
    keep = _keep(tq + tk, rate, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    got = tiled_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)
    assert not got[2][:, kv_len:].any() and not got[3][:, kv_len:].any()


@pytest.mark.parametrize("tq,tk,kv_len,causal", [(301, 301, 301, False), (32, 32, 32, True),
                                                 (32, 497, 497, False), (65, 129, 100, True)])
def test_tiled_flash_bf16_rounding_within_card_tolerances(tq, tk, kv_len, causal):
    """With bf16 inputs, P and dS are rounded to bf16 before their second
    product (as the kernels and the TPU kernel do): the result stays within
    the tolerances the card's checks use against the plain version, 3e-2
    forward and 4e-2 backward of the largest expected value (at least 1)."""
    rate = 0.2
    q, k, v, g = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(7 + tq, tq, tk))
    keep = _keep(tq * tk, rate, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    got = tiled_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.bfloat16
        tol = (3e-2 if i == 0 else 4e-2) * max(1.0, float(b.float().abs().max()))
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=tol)


@pytest.mark.parametrize("tq,tk,causal", [(32, 32, True), (15, 17, False)])
def test_tiled_flash_matches_pallas(tq, tk, causal):
    """The tile walk against the JAX package's Pallas kernel (interpret mode
    on the CPU) and its vjp, rate 0, atol 2e-5."""
    q, k, v, g = _inputs(3 * tq + tk, tq, tk, H=3)
    want_out, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, causal=causal),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (want_out,) + tuple(vjp(jnp.asarray(g)))
    got = tiled_attention(*map(torch.as_tensor, (q, k, v, g)), kv_len=tk, causal=causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


def test_tiled_forward_saves_the_logsumexp():
    """The saved per-row value is the logsumexp of the visible scaled
    scores, which is all the backward needs of the forward's softmax."""
    q, k, v, _ = map(torch.as_tensor, _inputs(5, 70, 70))
    _, lse = tiled_forward(q, k, v, kv_len=50, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    j = torch.arange(70)
    hidden = (j[None, :] >= 50) | (j[None, :] > j[:, None])
    want = torch.logsumexp(s.masked_fill(hidden, -math.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)


def test_saved_keep_flags_are_found_from_the_transposed_side():
    """The tensor-core forward saves its dropout mask one bit a score, each
    lane the 32 scores it owns of a 16-row x 64-key cell (bit 4 j + i =
    accumulator register i of 8-key tile j).  The dK/dV kernel owns
    transposed tiles (16 keys x 32 queries) and computes, per register,
    which cell, lane and bit to read.  Both index maps, written out as in
    the source, must meet on every (query, key)."""
    Tq, Tk = 128, 192
    owner = {}                                   # (query, key) -> (cell, lane, bit)
    for rows16 in range(Tq // 16):
        for tile in range(Tk // 64):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(8):
                    for i in range(4):
                        query = 16 * rows16 + g + 8 * (i >> 1)
                        key = 64 * tile + 8 * j + 2 * t + (i & 1)
                        owner[query, key] = ((rows16, tile), lane, 4 * j + i)
    assert len(owner) == Tq * Tk
    seen = set()
    for key0 in range(0, Tk, 16):                # a warp's keys
        for qc in range(0, Tq, 32):              # a chunk of queries
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                keep_lane = 8 * t + (g >> 1)
                keep_bit = 4 * ((key0 & 63) >> 3) + (g & 1)
                for j in range(4):
                    for i in range(4):
                        query = qc + 8 * j + 2 * t + (i & 1)
                        key = key0 + g + 8 * (i >> 1)
                        cell = ((qc >> 4) + (j >> 1), key0 // 64)
                        found = (cell, keep_lane + 4 * (i & 1),
                                 keep_bit + 4 * (i >> 1) + 2 * (j & 1))
                        assert found == owner[query, key], (key0, qc, lane, j, i)
                        seen.add((query, key))
    assert len(seen) == Tq * Tk


def test_sass_report_counts_loops():
    """`kernels/_sass.report` on a dump in cuobjdump's format: it picks the
    kernel by name, counts its instructions and finds the backward branch."""
    from icek_torch.kernels import _sass

    dump = """
\tFunction : _Z9other_fn
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   EXIT ;
\tFunction : _Z3fwdILi4EE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /* 0x000000000c08723c */
        /*0020*/                   MUFU.EX2 R5, R5 ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/               @P1 BRA 0x60 ;
        /*0050*/                   EXIT ;
"""
    lines = _sass.report(dump, "fwdILi4")
    assert lines[0] == "_Z3fwdILi4EE: 6 instructions"
    assert lines[1:] == ["  loop 0x10..0x30: 3 instructions (HMMA 1, MUFU 1, BRA 1)"]
    assert _sass.report(dump, "no_such_kernel") == []


def test_timing_variants_match_the_kernel_source():
    """``python -m icek_torch.kernels._variants flash_attention`` (the card's
    breakdown of the f32 backward) edits csrc/flash_attention.cu by text
    replacement: every variant's replacements still find their text and
    change it, and the braces of the result still balance."""
    import os

    from icek_torch.kernels import _build, _variants

    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    variants = _variants.VARIANTS["flash_attention"]
    assert _variants.CUTS["flash_attention"] <= set(variants)
    for name in variants:
        out = _variants.variant_source("flash_attention", name, src)
        assert (out != src) == (name != "base"), name
        assert out.count("{") - out.count("}") == src.count("{") - src.count("}"), name
