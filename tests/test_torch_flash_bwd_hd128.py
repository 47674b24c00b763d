"""The flash backward at padded head dim 128 (``icek_torch/csrc/
flash_attention.cu``), emulated in torch on the CPU.

Two kernel pairs run there on the card (tests/test_torch_gpu.py):

* bf16: ``flash_bwd_dq_wgmma_kernel<128, DROP>`` and
  ``flash_bwd_dkv_wgmma_kernel<128, DROP>``, the HDP-64 wgmma pair's walk
  (a warpgroup owns 64 rows; 64-row tiles; the keep flags of four 16-row
  cells a tile) with every staged tile two 64-dim halves of 128-byte rows
  in the 128-byte swizzle: S and dP (S^T and dP^T) take eight k-steps, both
  operands read from shared memory (the SS form: the block's own Q and dO,
  or K and V, staged once), and each second product is one m64n64k16 a
  k-step and half, so dQ (dK, dV) sums the two halves' columns apart;
* f32 (and bf16 that misses the alignment or has an odd head dim): the
  TF32 pair, every operand split by integer rounding at HDP 128 as at 64
  (the TF32 forward too, so S stays the same bits in all three kernels),
  32-row tiles, the split A operands in a 16-row group's shared-memory
  region; two warps share each group, the first taking 8-key (query) steps
  0 and 1 of every tile, the second steps 2 and 3, and a warp forms its two
  steps' S and dP (S^T and dP^T) at once, each step's chains summed over the
  d-steps in first_product's order (so the same bits); the pair folds its
  pass-0 row statistics in warp order, and adds its dQ (dK, dV) sums at the
  end, the first warp's plus the second's.

Here the two walks are held against ``reference_mha``'s autograd and the
JAX package's Pallas backward (interpret mode, head slot 128): the bf16
walk at head dims 96, 100 and 128 (even dims: an odd one, 75, takes the
TF32 pair), the TF32 walk at 75, 96 and 128; the two-half swizzled tiles
through the descriptor model as both operands; the TF32 walk's S and dP
against the forward's to the bit; each launch's shared memory and live
registers against an H100's limits; and the route from shape to pair.
"""

import math
import os
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import _build
from icek_torch.kernels import flash_attention as tfa
from icek_tpu.kernels import flash_attention as jfa
from test_torch_flash_bwd_hd64 import (_desc_fields, _f64_grads, _hf, _inputs, _read_b, _rel,
                                       _row_end, _second, _stage, _sw, _sw128_desc_of)
from test_torch_flash_tf32_fwd import (_f32, first_product, scale_c, scaled_scores, split_of,
                                       tf32_forward)
from test_torch_flash_tiles import _keep, _plain, _rounded, tiled_forward

TILE, KSTEP, HALF = 64, 16, 64
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small torch ops: one thread each (see the tiles files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def src():
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        return f.read()


def _halves(x, hd):
    """x (..., Hd) padded with zeros to 128 dims, as two 64-dim halves."""
    x = torch.nn.functional.pad(x, (0, 128 - hd))
    return x[..., :HALF], x[..., HALF:]


def _ss(a, b, hd):
    """a b^T over the padded head dim as the SS products form it: eight
    k-steps of 16 dims, k-steps 0-3 from the first half of each tile."""
    out = 0.0
    for (ah, bh) in zip(_halves(a, hd), _halves(b, hd)):
        for ks in range(0, HALF, KSTEP):
            out = out + ah[..., ks:ks + KSTEP] @ bh[..., ks:ks + KSTEP].transpose(-1, -2)
    return out


def _by_halves(p, x, hd):
    """p x (p: rows x 64 keys / queries, x: 64 rows x Hd) as the second
    products form it: one m64n64 product a 16-row k-step and 64-dim half,
    the halves' columns apart, cut back to Hd."""
    cols = []
    for xh in _halves(x, hd):
        acc = 0.0
        for kk in range(0, p.shape[-1], KSTEP):
            acc = acc + p[..., kk:kk + KSTEP] @ xh[..., kk:kk + KSTEP, :]
        cols.append(acc)
    return torch.cat(cols, dim=-1)[..., :hd]


def wgmma128_dq(q, k, v, out, d_out, lse, *, kv_len, causal, rate=0.0, keep=None):
    """(dq in q's dtype, delta) of flash_bwd_dq_wgmma_kernel<128>'s walk:
    blocks of 64 query rows, 64-key tiles up to the block's end, S and dP
    from the block's staged Q and dO rows and the key tile (SS, two halves),
    dS rounded to the working dtype, dQ += dS K by half and k-step."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf, of, gf = map(_hf, (q, k, v, out, d_out))
    scale, inv = 1.0 / math.sqrt(Hd), 1.0 / (1.0 - rate)
    delta = (of * gf).sum(-1)
    dq = torch.zeros((B, H, Tq, Hd))
    for blk0 in range(0, Tq, TILE):
        rows = torch.arange(blk0, min(blk0 + TILE, Tq))
        blk_end = min(kv_len, blk0 + TILE) if causal else kv_len
        acc = torch.zeros((B, H, len(rows), Hd))
        for k0 in range(0, blk_end, TILE):
            keys = torch.arange(k0, min(k0 + TILE, Tk))
            # rows past kv_len of the block's end stage as zeros
            kt = kf[:, :, keys] * (keys < blk_end)[:, None]
            vt = vf[:, :, keys] * (keys < blk_end)[:, None]
            s = _ss(qf[:, :, rows], kt, Hd)
            dp = _ss(gf[:, :, rows], vt, Hd)
            p = torch.exp2((s * scale - lse[:, :, rows, None]) * LOG2E)
            hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
            p = p.masked_fill(hidden, 0.0)
            if keep is not None:
                dp = torch.where(keep[:, :, rows][..., keys], dp * inv, 0.0)
            ds = _rounded(p * (dp - delta[:, :, rows, None]), q.dtype)
            acc = acc + _by_halves(ds, kt, Hd)
        dq[:, :, rows] = acc * scale
    return dq.permute(0, 2, 1, 3).to(q.dtype), delta


def wgmma128_dkv(q, k, v, d_out, lse, delta, *, kv_len, causal, rate=0.0, keep=None):
    """(dk, dv) of flash_bwd_dkv_wgmma_kernel<128>'s walk: blocks of 64 keys
    (K and V staged once, rows at or beyond kv_len as zeros), 64-query tiles
    from the block's diagonal (causal), S^T and dP^T by the SS products, P^T
    and dS^T rounded, dV += P^T dO and dK += dS^T Q by half and k-step."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf, gf = map(_hf, (q, k, v, d_out))
    live = (torch.arange(Tk) < kv_len)[:, None]
    kf, vf = kf * live, vf * live
    scale, inv = 1.0 / math.sqrt(Hd), 1.0 / (1.0 - rate)
    dk = torch.zeros((B, H, Tk, Hd))
    dv = torch.zeros((B, H, Tk, Hd))
    for blk0 in range(0, Tk, TILE):
        keys = torch.arange(blk0, min(blk0 + TILE, Tk))
        first = blk0 // TILE if causal else 0
        last = -(-Tq // TILE) if blk0 < kv_len else first
        for it in range(first, last):
            rows = torch.arange(it * TILE, min(it * TILE + TILE, Tq))
            st = _ss(kf[:, :, keys], qf[:, :, rows], Hd)
            dpt = _ss(vf[:, :, keys], gf[:, :, rows], Hd)
            p = torch.exp2((st * scale - lse[:, :, None, rows]) * LOG2E)
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
            pd = _rounded(pd, q.dtype)
            dv[:, :, keys] += _by_halves(pd, gf[:, :, rows], Hd)
            dk[:, :, keys] += _by_halves(ds, qf[:, :, rows], Hd)
    return tuple((t * s).permute(0, 2, 1, 3).to(k.dtype) for t, s in ((dk, scale), (dv, 1.0)))


def wgmma128_attention(q, k, v, d_out, **kw):
    out, lse = tiled_forward(q, k, v, **kw)      # the wgmma forward's values
    dq, delta = wgmma128_dq(q, k, v, out, d_out, lse, **kw)
    return (out, dq) + wgmma128_dkv(q, k, v, d_out, lse, delta, **kw)


# the 512x4 model's three sites at a short length, and ragged ones around
# the 16-row and 64-row tile edges
SHAPES = [(40, 40, 40, False), (32, 70, 70, False), (65, 129, 100, True), (15, 17, 17, False)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [96, 100, 128])
@pytest.mark.parametrize("tq,tk,kv_len,causal", SHAPES)
def test_wgmma128_walk_matches_plain(tq, tk, kv_len, causal, hd, rate):
    """The HDP-128 wgmma pair's walk in f32: dq, dk, dv within 1e-5 of the
    plain version's autograd under the same explicit mask; keys at or
    beyond kv_len get exactly zero gradients."""
    q, k, v, g = map(torch.as_tensor, _inputs(tq * 100 + hd + 11, tq, tk, hd))
    keep = _keep(tq + tk + hd, rate, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    got = wgmma128_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)
    assert not got[2][:, kv_len:].any() and not got[3][:, kv_len:].any()


@pytest.mark.parametrize("hd", [96, 128])
def test_wgmma128_walk_bf16_within_card_tolerances(hd):
    """bf16 inputs, P and dS rounded to bf16 before their second products:
    within the card's 4e-2 of the largest expected value, at rate 0.2."""
    tq, tk, kv_len, causal = 65, 129, 100, True
    q, k, v, g = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(hd + 1, tq, tk, hd))
    keep = _keep(hd, 0.2, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=0.2, keep=keep)
    got = wgmma128_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.bfloat16
        tol = (3e-2 if i == 0 else 4e-2) * max(1.0, float(b.float().abs().max()))
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=tol)


def _pallas_grads(q, k, v, g, causal):
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("tq,tk,causal,hd", [(32, 32, True, 128), (15, 70, False, 128),
                                             (40, 40, False, 96)])
def test_wgmma128_walk_matches_pallas(tq, tk, causal, hd):
    """Against the JAX package's Pallas backward (``_flash_bwd`` in
    interpret mode, head slot 128) through its vjp, rate 0, atol 2e-5."""
    q, k, v, g = _inputs(7 * tq + tk + hd, tq, tk, hd)
    want = _pallas_grads(q, k, v, g, causal)
    got = wgmma128_attention(*map(torch.as_tensor, (q, k, v, g)), kv_len=tk, causal=causal)[1:]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


# --------------------------------------------------------------------------
# the TF32 pair at HDP 128
# --------------------------------------------------------------------------

TK, STEP = 32, 8


def _part(idx):
    """The warp of a pair that takes key (query) `idx`: steps 0-1 of a
    32-row tile the first, steps 2-3 the second."""
    return (idx % TK) // 16


def _fold(x, d, part):
    """The pair's pass-0 statistics folded in warp order (fold_group_rows):
    per row (m, l, w) of each warp's keys, then M, L, W."""
    M = torch.full(x.shape[:-1], -math.inf)
    L, W = torch.zeros(x.shape[:-1]), torch.zeros(x.shape[:-1])
    for p in range(2):
        mine = (part == p)[None, None, None, :]
        xp = x.masked_fill(~mine, -math.inf)
        m = xp.amax(-1)
        e = torch.exp2(xp - torch.where(m == -math.inf, 0.0, m)[..., None])
        l, w = e.sum(-1), (e * d).sum(-1)
        live = m != -math.inf
        mn = torch.maximum(M, m)
        fo = torch.where(M == -math.inf, 0.0, torch.exp2(M - torch.where(live, mn, M)))
        fp = torch.exp2(m - torch.where(live, mn, m))
        L = torch.where(live, L * fo + l * fp, L)
        W = torch.where(live, W * fo + w * fp, W)
        M = torch.where(live, mn, M)
    return M, L, W


def tf32_128_dq(q, k, v, d_out, *, kv_len, causal, rate=0.0, keep=None):
    """(dq, lse2, delta) of flash_bwd_dq_tf32_kernel's walk at HDP 128:
    blocks of 64 rows, groups of 16, 8-key steps up to the group's end; each
    warp of the pair takes its steps (_part); pass 0 takes (m, l, w) of each
    warp's keys from the kernel's own x = S c and dP' and folds them; pass 1
    forms P, dS (rounded to the working dtype) and each warp adds its steps'
    dS K in order (dS split as acc_as_a splits it, K by integer rounding: hi
    lo, lo hi, hi hi into a zeroed sum, then one f32 add); dQ is the first
    warp's sum plus the second's."""
    B, Tq, H, Hd = q.shape
    qf, kf, vf, gf = map(_hf, (q, k, v, d_out))
    pieces = 2 if q.dtype == torch.float32 else 1
    inv = 1.0 / (1.0 - rate)
    dq = torch.zeros((B, H, Tq, Hd))
    lse2 = torch.zeros((B, H, Tq))
    delta = torch.zeros((B, H, Tq))
    for row0 in range(0, Tq, 16):
        rows = torch.arange(row0, min(row0 + 16, Tq))
        blk0 = row0 - row0 % 64
        blk_end = min(kv_len, blk0 + 64) if causal else kv_len
        warp_end = min(blk_end, row0 + 16) if causal else kv_len
        keys = torch.arange(0, -(-warp_end // STEP) * STEP)
        keys = keys[keys < k.shape[1]]
        x = scaled_scores(qf[:, :, rows], kf[:, :, keys], pieces, Hd)
        d = first_product(gf[:, :, rows], vf[:, :, keys], pieces, 128)
        hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
        x = x.masked_fill(hidden, -math.inf)
        if keep is not None:
            d = torch.where(keep[:, :, rows][..., keys], d * inv, 0.0)
        m, l, w = _fold(x, d, _part(keys))
        dl = torch.where(l > 0, w / l, 0.0)[..., None]
        l2 = torch.where(l > 0, m + torch.log2(l), 0.0)[..., None]
        ds = _rounded(torch.exp2(x - l2) * (d - dl), q.dtype)
        acc = [torch.zeros((B, H, len(rows), Hd)) for _ in range(2)]
        for j in range(0, len(keys), STEP):
            p = int(_part(keys[j]))
            acc[p] = acc[p] + _second(ds[..., j:j + STEP], kf[:, :, keys[j:j + STEP]], pieces, 128)
        dq[:, :, rows] = (acc[0] + acc[1]) * _f32(1.0 / math.sqrt(Hd))
        lse2[:, :, rows], delta[:, :, rows] = l2[..., 0], dl[..., 0]
    return dq.permute(0, 2, 1, 3).to(q.dtype), lse2, delta


def tf32_128_dkv(q, k, v, d_out, lse2, delta, *, kv_len, causal, rate=0.0, keep=None):
    """(dk, dv) of flash_bwd_dkv_tf32_kernel's walk at HDP 128: groups of 16
    keys, 32-query tiles from the block's causal start, 8-query steps (a
    causally hidden step skipped); each warp of the pair takes its steps and
    sums its dV += P^T dO and dK += dS^T Q as tf32_128_dq does; dK and dV
    are the first warp's sums plus the second's."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf, gf = map(_hf, (q, k, v, d_out))
    live = (torch.arange(Tk) < kv_len)[:, None]
    kf, vf = kf * live, vf * live
    pieces = 2 if q.dtype == torch.float32 else 1
    inv = 1.0 / (1.0 - rate)
    dk = torch.zeros((B, H, Tk, Hd))
    dv = torch.zeros((B, H, Tk, Hd))
    for key0 in range(0, Tk, 16):
        keys = torch.arange(key0, min(key0 + 16, Tk))
        blk0 = key0 - key0 % 64
        q_first = (blk0 // TK) * TK if causal else 0
        if blk0 >= kv_len or q_first >= Tq:
            continue
        rows = torch.arange(q_first, Tq)
        rows = rows[~(causal & (rows - rows % STEP + STEP - 1 < key0))]
        xt = scaled_scores(kf[:, :, keys], qf[:, :, rows], pieces, Hd)
        dpt = first_product(vf[:, :, keys], gf[:, :, rows], pieces, 128)
        p = torch.exp2(xt - lse2[:, :, None, rows])
        hidden = keys[:, None] >= kv_len
        if causal:
            hidden = hidden | (keys[:, None] > rows[None, :])
        p = p.masked_fill(hidden, 0.0)
        pd = p
        if keep is not None:
            kept = keep[:, :, rows][..., keys].transpose(-1, -2)
            pd = torch.where(kept, p * inv, 0.0)
            dpt = torch.where(kept, dpt * inv, 0.0)
        pd = _rounded(pd, q.dtype)
        ds = _rounded(p * (dpt - delta[:, :, None, rows]), q.dtype)
        sk = [torch.zeros((B, H, len(keys), Hd)) for _ in range(2)]
        sv = [torch.zeros((B, H, len(keys), Hd)) for _ in range(2)]
        for j in range(0, len(rows), STEP):
            r, w = rows[j:j + STEP], int(_part(rows[j]))
            sv[w] = sv[w] + _second(pd[..., j:j + STEP], gf[:, :, r], pieces, 128)
            sk[w] = sk[w] + _second(ds[..., j:j + STEP], qf[:, :, r], pieces, 128)
        dk[:, :, keys], dv[:, :, keys] = sk[0] + sk[1], sv[0] + sv[1]
    scale = _f32(1.0 / math.sqrt(Hd))
    return tuple(t.permute(0, 2, 1, 3).to(k.dtype) for t in (dk * scale, dv))


def tf32_128_backward(q, k, v, d_out, **kw):
    dq, lse2, delta = tf32_128_dq(q, k, v, d_out, **kw)
    return (dq,) + tf32_128_dkv(q, k, v, d_out, lse2, delta, **kw)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [75, 96, 128])
@pytest.mark.parametrize("tq,tk,kv_len,causal", [(40, 40, 40, False), (65, 129, 100, True)])
def test_tf32_128_walk_within_1e_5_of_f64(tq, tk, kv_len, causal, hd, rate):
    """The TF32 pair's walk at HDP 128 (every operand split by integer
    rounding, 32-row tiles, two warps a group) against float64 autograd under the
    same mask: dq, dk, dv within 1e-5 of the largest value, where the card
    holds the kernels to 1e-4; keys at or beyond kv_len get zeros."""
    q, k, v, g = map(torch.as_tensor, _inputs(tq + 5 * hd, tq, tk, hd))
    keep = _keep(tq * hd + 1, rate, 2, 2, tq, tk)
    got = tf32_128_backward(q, k, v, g, kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    want = _f64_grads(q, k, v, g, rate, keep, kv_len=kv_len, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("hd", [75, 128])
def test_tf32_128_walk_matches_pallas(hd):
    """Against the JAX package's Pallas backward in interpret mode (head
    slot 128) through its vjp, rate 0, within 1e-4 (the card's f32
    tolerance)."""
    tq, tk, causal = 40, 70, True
    q, k, v, g = _inputs(13 * hd, tq, tk, hd)
    want = _pallas_grads(q, k, v, g, causal)
    got = tf32_128_backward(*map(torch.as_tensor, (q, k, v, g)), kv_len=tk, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


def test_tf32_128_pair_fold_keeps_one_hot_rows_exact(src):
    """Logits in the hundreds (one-hot softmax rows) with the winner in
    either warp's keys: the pair's folded statistics have l exactly 1 and w
    exactly the winner's dP', so P = 2^(x - lse2) is exactly 1 and dS exactly
    0, as with one warp a group; the source folds in warp order with the
    model's arithmetic."""
    rng = np.random.default_rng(4)
    T, Hd = 64, 128
    q = torch.as_tensor(rng.standard_normal((1, 1, T, Hd)) * 20, dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((1, 1, T, Hd)) * 20, dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((1, 1, T, T)), dtype=torch.float32)
    x = scaled_scores(q, k, 2, Hd)
    keys = torch.arange(T)
    m, l, w = _fold(x, d, _part(keys))
    win = x.argmax(-1)
    one_hot = (torch.exp2(x - x.amax(-1, keepdim=True)) > 0).sum(-1) == 1
    assert int(one_hot.sum()) > T // 4
    assert {int(p) for p in _part(win[one_hot])} == {0, 1}
    assert torch.equal(l[one_hot], torch.ones_like(l[one_hot]))
    assert torch.equal(w[one_hot], d.gather(-1, win[..., None])[..., 0][one_hot])
    body = src[src.index("void fold_group_rows("):]
    body = body[:body.index("\n}\n")]
    for text in ("for (int p = 0; p < WG; ++p) {", "if (e[0] == -INFINITY) continue;",
                 "const float fo = M == -INFINITY ? 0.f : fast_exp2(M - mn), fp = fast_exp2(e[0] - mn);",
                 "L = fmaf(L, fo, e[1] * fp);", "W = fmaf(W, fo, e[2] * fp);"):
        assert text in body, text
    dq = src[src.index("flash_bwd_dq_tf32_kernel("):src.index("flash_bwd_dkv_tf32_kernel(")]
    assert "const int j = part * SPW + jj;      // this warp's share of the tile's steps" in dq
    assert "if (part == 0 && t == 0 && row < a.Tq) {" in dq
    assert "add_group_sums<WG, DS>(acc, reinterpret_cast<float*>(smem), grp, part, lane);" in dq


@pytest.mark.parametrize("hd", [96, 128])
def test_tf32_128_scores_are_the_forward_s_to_the_bit(hd):
    """At HDP 128 the forward's x of every visited 32-key tile, the dQ
    kernel's x (Q as A) and the dK/dV kernel's x^T (K as A) are one bit
    pattern, and so are dP and dP^T: the integer split is applied to every
    operand alike and hi hi + (lo hi + hi lo) is symmetric in its operands.
    The model forms each step's three chains as first_product does; that
    first_products_steps, which forms two steps at once in both kernels,
    issues each step's chains in that order is held by the source check
    (test_steps_at_once_keep_first_product_s_chains), not here.  The scores
    differ from cvt.rna's (the split at HDP 32)."""
    tq = tk = 96
    q, k, v, g = map(torch.as_tensor, _inputs(53 + hd, tq, tk, hd))
    seen = {}
    tf32_forward(q, k, v, kv_len=90, causal=True, scores=seen, tile=32, block=64)
    qf, kf, vf, gf = map(_hf, (q, k, v, g))
    c = _f32(scale_c(hd))
    x_dq = first_product(qf, kf, 2, 128) * c
    x_dkv = (first_product(kf, qf, 2, 128) * c).transpose(-1, -2)
    x_one = scaled_scores(qf, kf, 2, hd)
    assert torch.equal(x_dq.view(torch.int32), x_one.view(torch.int32))
    assert torch.equal(x_dkv.view(torch.int32), x_one.view(torch.int32))
    for (row0, k0), x in seen.items():
        rows, cols = slice(row0, row0 + x.shape[2]), slice(k0, k0 + x.shape[3])
        assert torch.equal(x.view(torch.int32),
                           x_one[:, :, rows, cols].contiguous().view(torch.int32))
    dp = first_product(gf, vf, 2, 128)
    dpt = first_product(vf, gf, 2, 128).transpose(-1, -2)
    assert torch.equal(dp.view(torch.int32), dpt.view(torch.int32))
    assert split_of(128) is split_of(64) and split_of(128) is not split_of(32)
    assert not torch.equal(x_one, first_product(qf, kf, 2, 32) * c)   # cvt.rna's


def test_steps_at_once_keep_first_product_s_chains(src):
    """The source: first_products_steps issues, for each step, the mma of
    first_product's three chains (hi hi: A piece 0 with B's hi; lo hi: A
    piece 1 with B's hi; hi lo: A piece 0 with B's lo) over the d-steps in
    order, sums them as first_product does; at HDP 128 two warps share a
    group and each takes its two steps of a tile at once, one step at a
    time (and one warp a group) at HDP 32 and 64."""
    body = src[src.index("void first_products_steps("):]
    body = body[:body.index("\n}\n")]
    for text in ("mma_tf32(c1[j][0], f1.p[0], x1[0], y1[0]);",
                 "mma_tf32(c1[j][1], f1.p[1], x1[0], y1[0]);",
                 "mma_tf32(c1[j][2], f1.p[0], x1[1], y1[1]);",
                 "mma_tf32(c2[j][2], f2.p[0], x2[1], y2[1]);",
                 "s[j][i] = c1[j][0][i] + (c1[j][1][i] + c1[j][2][i]);",
                 "dp[j][i] = c2[j][0][i] + (c2[j][1][i] + c2[j][2][i]);",
                 "for (int ds = 0; ds < Rows::DS; ++ds) {"):
        assert text in body, text
    one = src[src.index("void first_product("):]
    one = one[:one.index("\n}\n")]
    for text in ("mma_tf32(c[0], f.p[0], x[0], y[0]);", "mma_tf32(c[1], f.p[1], x[0], y[0]);",
                 "mma_tf32(c[2], f.p[0], x[1], y[1]);",
                 "s[i] = c[0][i] + (c[1][i] + c[2][i]);"):
        assert text in one, text
    assert "constexpr int steps_at_once() { return HDP > 64 ? 2 : 1; }" in src
    assert "constexpr int group_warps() { return HDP > 64 ? 2 : 1; }" in src
    assert src.count("JB = steps_at_once<HDP>();") == 2
    assert ("template <int HDP> __host__ __device__ constexpr bool tf32_bits() "
            "{ return HDP >= 64; }") in src
    assert src.count("BITS = tf32_bits<HDP>();") == 3     # the forward's and the pair's


# --------------------------------------------------------------------------
# the two-half swizzled tiles and the matrix descriptors
# --------------------------------------------------------------------------

def _read_a(mem, start, sbo):
    """The 64 x 16 A operand (m, k) that an SS wgmma m64n64k16 reads
    through a K-major 128-byte-swizzle descriptor: element (m, k) at start
    + (m % 8) 128 + (m / 8) SBO + 2 k."""
    out = np.zeros((64, KSTEP), dtype=np.int64)
    for m in range(64):
        for kk in range(KSTEP):
            out[m, kk] = mem[_sw(start + (m % 8) * 128 + (m // 8) * sbo + 2 * kk) // 2]
    return out


@pytest.mark.parametrize("vec", [True, False])
def test_two_half_tiles_read_as_both_operands(src, vec):
    """A 64-row tile (keys or queries) x 128 head dims is staged as two
    swizzled tiles of 128-byte rows, SW_TILE bytes apart, half x holding
    dims 64 x ..: through the source's descriptor, k-step ks of S = Q K^T
    (S^T = K Q^T) reads 32 (ks % 4) bytes into half ks / 4 of both tiles,
    as A (rows x 16 dims) and as B (K-major), and k-step kk of a second
    product reads 2048 kk bytes into each half (MN-major: 16 rows x 64
    dims), one m64n64 product a half."""
    full = np.arange(TILE * 128, dtype=np.int64).reshape(TILE, 128)
    mem = np.concatenate([_stage(full[:, 64 * x:64 * x + 64], vec) for x in range(2)])
    sw_tile = TILE * 128
    desc_of = _sw128_desc_of(src)
    for ks in range(8):
        at = sw_tile * (ks >> 2) + 32 * (ks & 3)
        f = _desc_fields(desc_of(at))
        assert f["sbo"] == 1024 and f["layout"] == 1
        np.testing.assert_array_equal(_read_a(mem, f["start"], f["sbo"]),
                                      full[:, 16 * ks:16 * ks + 16])
        got = _read_b(mem, f["start"], f["sbo"], True)
        np.testing.assert_array_equal(got.T, full[:, 16 * ks:16 * ks + 16])
    for kk in range(4):
        for x in range(2):
            f = _desc_fields(desc_of(x * sw_tile + 2048 * kk))
            got = _read_b(mem, f["start"], f["sbo"], False)
            np.testing.assert_array_equal(got, full[16 * kk:16 * kk + 16, 64 * x:64 * x + 64])
    body = src[src.index("void wgmma_ss_rows("):]
    body = body[:body.index("\n}\n")]
    assert "const uint32_t at = SW_TILE * (ks >> 2) + 32 * (ks & 3);" in body
    assert "wgmma_ss<true>(d, sw128_desc(xa + at), sw128_desc(ya + at));" in body
    assert "wgmma_rs<true, 1>(acc[x], dsf[kk], sw128_desc(kt + x * SW_TILE + 2048 * kk));" in src
    assert "wgmma_rs<true, 1>(dva[x], pf[kk], sw128_desc(gt + x * SW_TILE + 2048 * kk));" in src
    assert "wgmma_rs<true, 1>(dka[x], dsf[kk], sw128_desc(qt + x * SW_TILE + 2048 * kk));" in src
    # the SS form: both operands by descriptor, neither transposed
    ss = src[src.index("void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b)"):]
    assert '", %32, %33, p, 1, 1, 0, 0;\\n}\\n"' in ss[:900]


def test_ss_operands_are_the_block_s_own_rows(src):
    """At HDP 128 the dQ kernel stages its 64 query rows of Q and dO once
    (rows from blockIdx.x * TILE, zeros past Tq) and the dK/dV kernel its 64
    keys of K and V (zeros at or beyond kv_len), each half of each in the
    first cp.async group, before the loop's first wait."""
    dq = src[src.index("flash_bwd_dq_wgmma_kernel("):src.index("flash_bwd_dkv_wgmma_kernel(")]
    assert ("stage_sw128<NT>(qtile + x * SW_TILE, qp + 64 * x, a.q_st, blockIdx.x * TILE, a.Tq,"
            in dq)
    assert ("stage_sw128<NT>(gtile + x * SW_TILE, d_o + obase + 64 * x, ost, blockIdx.x * TILE, "
            "a.Tq," in dq)
    assert "wgmma_ss_rows<HDP>(s, qtile, kt);" in dq and "wgmma_ss_rows<HDP>(dp, gtile, vt);" in dq
    assert dq.index("stage_sw128<NT>(qtile") < dq.index("stage(0);\n  cp_async_commit();")
    dkv = src[src.index("flash_bwd_dkv_wgmma_kernel("):]
    dkv = dkv[:dkv.index("\n}\n")]
    assert ("stage_sw128<NT>(ktile + x * SW_TILE, kbase + 64 * x, a.k_st, blk_key0, a.kv_len,"
            in dkv)
    assert "wgmma_ss_rows<HDP>(st, ktile, qt);" in dkv and "wgmma_ss_rows<HDP>(dpt, vtile, gt);" in dkv
    assert dkv.index("stage_sw128<NT>(ktile") < dkv.index("if (first < last) stage(first);")


# --------------------------------------------------------------------------
# shared memory and registers against an H100, and the route
# --------------------------------------------------------------------------

SMEM_LIMIT = 232448       # a block's shared memory on an H100 (sm_90)
SM_SMEM = 233472          # an SM's
REGS_SM, REGS_THREAD = 65536, 255


def _formula(src, name):
    m = re.search(rf"constexpr int {name}\(\) {{\n  return ([^;]+);", src)
    return m.group(1)


def test_hd128_launch_shared_memory(src):
    """The wgmma pair at HDP 128: dQ two buffers of K and V and the block's
    Q and dO (twelve swizzled tiles) and 1024 bytes of alignment, 99,328
    bytes; dK/dV two buffers of Q and dO, K and V, and the lse and delta
    rows, 100,352: both above 48 KB (the launch opts in) and two blocks an
    SM.  At HDP 64 the formulas give the HDP-64 pair's layout."""
    tile = TILE * 128

    def of(name):
        expr = _formula(src, name)
        assert "(HDP > 64 ? 6 : 4)" in expr
        expr = expr.replace("(HDP > 64 ? 6 : 4)", "(6 if HDP > 64 else 4)")
        expr = expr.replace("SW_TILE", str(tile)).replace("TILE", "64")
        return lambda hdp: eval(expr.replace("HDP", str(hdp)))

    dq, dkv = of("wg_dq_bytes"), of("wg_dkv_bytes")
    assert (dq(128), dkv(128)) == (99328, 100352)
    assert (dq(64), dkv(64)) == (4 * tile + 1024, 4 * tile + 2 * 2 * 64 * 4 + 1024)
    assert max(dq(128), dkv(128)) <= SMEM_LIMIT
    assert SM_SMEM // (dkv(128) + 1024) >= 2          # 1 KB a block reserved
    for name in ("launch_dq_wgmma(", "launch_dkv_wgmma("):
        body = src[src.index(name):]
        assert "if (const int err = allow_smem(kernel, smem)) return err;" in body[:700]


def test_hd128_live_registers_fit_an_h100():
    """The registers each new launch keeps live a thread at its peak,
    counted from the kernels' arrays: within 255, and the SM's blocks on the
    register file (the wgmma pair: two blocks of 128 threads, as its shared
    memory allows; the TF32 pair: its one block of 256, two warps a group).
    wgmma dQ: the dQ accumulator (2 halves x 32), S and dP (2 x 32), dS (4 x
    4); wgmma dK/dV: dK and dV (2 x 2 halves x 32), S^T and dP^T (2 x 32),
    P^T and dS^T (2 x 16); TF32 dQ (f32): dQ (16 x 4), its two steps'
    chains of S and dP (2 x 2 x 3 x 4), the two split A fragments of a
    d-step (2 x 2 pieces x 4); TF32 dK/dV: dK and dV (2 x 16 x 4), its two
    steps' chains (2 x 2 x 3 x 4), the fragments."""
    counts = {"wgmma dq 128": (2 * 32 + 2 * 32 + 16, 128, 2),
              "wgmma dkv 128": (2 * 2 * 32 + 2 * 32 + 2 * 16, 128, 2),
              "tf32 dq 128": (16 * 4 + 2 * 2 * 3 * 4 + 2 * 2 * 4, 256, 1),
              "tf32 dkv 128": (2 * 16 * 4 + 2 * 2 * 3 * 4 + 2 * 2 * 4, 256, 1)}
    for name, (n, threads, blocks) in counts.items():
        assert n <= REGS_THREAD - 15, name             # room for indices and addresses
        assert REGS_SM // (threads * min(REGS_THREAD, n + 15)) >= blocks, name


def test_hdp128_routes_to_the_new_pairs(src):
    """Shape alone picks the pair: bf16 at an even head dim of 65-128 with
    aligned rows runs the wgmma pair at HDP 128, f32 (and odd or misaligned
    bf16) the TF32 pair; the pairs these replaced there (the mma.sync pair,
    the cvt.rna TF32 pair) are on no route and have no entry."""
    bf = lambda hd: torch.zeros((2, 9, 4, hd), dtype=torch.bfloat16)
    f32 = lambda hd: torch.zeros((2, 9, 4, hd))
    for hd in (66, 96, 100, 128):
        assert tfa.bwd_kernels(bf(hd), bf(hd), bf(hd)) == "wgmma128"
        assert tfa.bwd_kernels(f32(hd), f32(hd), f32(hd)) == "tf32_128"
    assert tfa.bwd_kernels(bf(75), bf(75), bf(75)) == "tf32_128"
    assert tfa.bwd_kernels(bf(64), bf(64), bf(64)) == "wgmma64"
    assert tfa.bwd_kernels(bf(30), bf(30), bf(30)) == "mma_sync32"
    assert set(tfa.flash_mha_bwd.kernels) == set(tfa.BWD_KERNELS)
    assert not {"mma_sync128", "tf32_rna128"} & set(tfa.BWD_KERNELS)
    body = src[src.index("int backward_mma("):src.index("ICEK_EXPORT int flash_bwd_bf16_mma(")]
    assert "} else {   // the wgmma pair" in body
    assert "launch_dq_wgmma<HDP>(" in body and "launch_dkv_wgmma<HDP>(" in body
    assert "launch_dq_mma<HDP" not in body and "launch_dkv_mma<HDP" not in body
    main = src[src.index("ICEK_EXPORT int flash_bwd_bf16_mma("):]
    main = main[:main.index("\n}\n")]
    assert "backward_mma<128>(" in main
    assert "flash_bwd_bf16_mma_sync" not in src and "flash_bwd_f32_tf32_rna" not in src
    assert "RNA" not in src and "SYNC" not in src
