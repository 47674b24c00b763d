"""The flash backward at padded head dim 64 (``icek_torch/csrc/
flash_attention.cu``), emulated in torch on the CPU.

Two kernel pairs run there on the card (tests/test_torch_gpu.py):

* bf16: ``flash_bwd_dq_wgmma_kernel`` and ``flash_bwd_dkv_wgmma_kernel``, a
  block one warpgroup of four warps owning 64 rows (warp w rows 16 w ..),
  every product one wgmma m64n64k16 a k-step over a whole 64-row tile: dQ
  walks the key tiles up to the block's causal end, each tile whole (no
  warp skips one), masked by element; dK/dV walks the query tiles from the
  block's own diagonal, 64 queries at a time, reading the forward's keep
  flags from four 16-row cells a tile;
* f32 (and misaligned bf16): the TF32 pair of PR 12's shape, with every
  operand split by integer rounding at HDP 64 (hi = rna(x), lo = x - hi
  with its low 13 bits truncated by the tensor cores) in the forward, the
  dQ kernel and the dK/dV kernel alike, so S and dP stay the same bits in
  all three.

Here their walks are held against ``reference_mha``'s autograd and the JAX
package's Pallas backward (interpret mode), at head dims 40, 64 and 75
(the last padded to 128, where the TF32 kernels split by integer rounding
too: tests/test_torch_flash_bwd_hd128.py); the wgmma kernels' swizzled staging and their matrix descriptors
against the tiles they must read (a model of the descriptor's address
arithmetic); the keep-flag index map from the transposed side; the TF32
emulation's S and dP against the forward's to the bit; and each launch's
shared memory and live registers against an H100's limits.
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
from test_torch_flash_tf32_fwd import (_exact, _f32, first_product, hd_pad, scale_c,
                                       scaled_scores, split_of, tf32_forward)
from test_torch_flash_tiles import _keep, _plain, _rounded, tiled_forward

TILE, WARP, STEP, KSTEP = 64, 16, 8, 16
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


def _hf(t):
    return t.to(torch.float32).permute(0, 2, 1, 3)          # (B, H, T, Hd)


def _row_end(rows, kv_len, causal):
    return torch.clamp(rows + 1, max=kv_len) if causal else torch.full_like(rows, kv_len)


def _inputs(seed, tq, tk, hd, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, hd)).astype(np.float32) for t in (tq, tk, tk, tq)]


# --------------------------------------------------------------------------
# the wgmma pair (bf16, HDP 64)
# --------------------------------------------------------------------------

def wgmma_dq(q, k, v, out, d_out, lse, *, kv_len, causal, rate=0.0, keep=None):
    """(dq in q's dtype, delta (B, H, Tq)) of flash_bwd_dq_wgmma_kernel's walk:
    blocks of 64 query rows, key tiles of 64 up to the block's end, every
    row of the block through every tile (masked by element), dS rounded to
    the working dtype, dQ += dS K one 16-key k-step at a time."""
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
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            dp = gf[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
            p = torch.exp2((s * scale - lse[:, :, rows, None]) * LOG2E)
            hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
            p = p.masked_fill(hidden, 0.0)
            if keep is not None:
                dp = torch.where(keep[:, :, rows][..., keys], dp * inv, 0.0)
            ds = _rounded(p * (dp - delta[:, :, rows, None]), q.dtype)
            for kk in range(0, len(keys), KSTEP):
                acc = acc + ds[..., kk:kk + KSTEP] @ kf[:, :, keys[kk:kk + KSTEP]]
        dq[:, :, rows] = acc * scale
    return dq.permute(0, 2, 1, 3).to(q.dtype), delta


def wgmma_dkv(q, k, v, d_out, lse, delta, *, kv_len, causal, rate=0.0, keep=None):
    """(dk, dv) of flash_bwd_dkv_wgmma_kernel's walk: blocks of 64 keys (rows
    at or beyond kv_len load as zeros), query tiles of 64 from the block's
    diagonal (causal) to the end, P^T and dS^T rounded, dV += P^T dO and dK
    += dS^T Q one 16-query k-step at a time."""
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
            st = kf[:, :, keys] @ qf[:, :, rows].transpose(-1, -2)
            dpt = vf[:, :, keys] @ gf[:, :, rows].transpose(-1, -2)
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
            for kk in range(0, len(rows), KSTEP):
                r = rows[kk:kk + KSTEP]
                dv[:, :, keys] += pd[..., kk:kk + KSTEP] @ gf[:, :, r]
                dk[:, :, keys] += ds[..., kk:kk + KSTEP] @ qf[:, :, r]
    return tuple((t * s).permute(0, 2, 1, 3).to(k.dtype) for t, s in ((dk, scale), (dv, 1.0)))


def wgmma_attention(q, k, v, d_out, **kw):
    out, lse = tiled_forward(q, k, v, **kw)      # the tensor-core forward, unchanged
    dq, delta = wgmma_dq(q, k, v, out, d_out, lse, **kw)
    return (out, dq) + wgmma_dkv(q, k, v, d_out, lse, delta, **kw)


# the 512x8 model's three sites at a short length, and ragged ones around
# the 16-row and 64-row tile edges
SHAPES = [(40, 40, 40, False), (32, 32, 32, True), (32, 70, 70, False),
          (65, 129, 100, True), (70, 70, 70, True), (15, 17, 17, False)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [40, 64])
@pytest.mark.parametrize("tq,tk,kv_len,causal", SHAPES)
def test_wgmma_walk_matches_plain(tq, tk, kv_len, causal, hd, rate):
    """The wgmma pair's walk in f32: dq, dk, dv within 1e-5 of the plain
    version's autograd under the same explicit mask; keys at or beyond
    kv_len get exactly zero gradients."""
    q, k, v, g = map(torch.as_tensor, _inputs(tq * 100 + hd + 7, tq, tk, hd))
    keep = _keep(tq + tk + hd, rate, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    got = wgmma_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)
    assert not got[2][:, kv_len:].any() and not got[3][:, kv_len:].any()


@pytest.mark.parametrize("hd", [40, 64])
def test_wgmma_walk_bf16_within_card_tolerances(hd):
    """bf16 inputs, P and dS rounded to bf16 before their second products:
    within the card's 4e-2 of the largest expected value, at rate 0.2."""
    tq, tk, kv_len, causal = 65, 129, 100, True
    q, k, v, g = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(hd, tq, tk, hd))
    keep = _keep(hd, 0.2, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=0.2, keep=keep)
    got = wgmma_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.bfloat16
        tol = (3e-2 if i == 0 else 4e-2) * max(1.0, float(b.float().abs().max()))
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=tol)


@pytest.mark.parametrize("tq,tk,causal", [(32, 32, True), (15, 70, False)])
def test_wgmma_walk_matches_pallas(tq, tk, causal):
    """Against the JAX package's Pallas backward (``_flash_bwd`` in
    interpret mode, head slot 64) through its vjp, rate 0, atol 2e-5."""
    q, k, v, g = _inputs(5 * tq + tk, tq, tk, 64)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = wgmma_attention(*map(torch.as_tensor, (q, k, v, g)), kv_len=tk, causal=causal)[1:]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


def test_wgmma_dkv_keep_flags_are_the_forward_s():
    """The forward saves one bit a score, lane l of a 16-row x 64-key cell
    holding its 32 scores (bit 4 j + i: register i of 8-key tile j).  The
    wgmma dK/dV kernel's warp owns 16 keys of a 64-key block and a 64-query
    tile as eight n8 tiles j of S^T; register i of tile j is (query 8 j + 2
    t + i % 2, key g + 8 (i / 2)), read from cell 4 it + j / 2, lane
    keep_lane + 4 (i % 2), bit keep_bit + 4 (i / 2) + 2 (j % 2), as the
    source computes them.  Both maps meet on every (query, key)."""
    Tq, Tk = 192, 128
    owner = {}
    for rows16 in range(Tq // 16):
        for tile in range(Tk // 64):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(8):
                    for i in range(4):
                        query = 16 * rows16 + g + 8 * (i >> 1)
                        key = 64 * tile + 8 * j + 2 * t + (i & 1)
                        owner[query, key] = ((rows16, tile), lane, 4 * j + i)
    seen = set()
    for blk in range(Tk // TILE):
        for warp in range(4):
            key0 = blk * TILE + 16 * warp
            for it in range(Tq // TILE):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    keep_lane = 8 * t + (g >> 1)
                    keep_bit = 4 * ((key0 & 63) >> 3) + (g & 1)
                    for j in range(8):
                        for i in range(4):
                            query = it * TILE + 8 * j + 2 * t + (i & 1)
                            key = key0 + g + 8 * (i >> 1)
                            found = ((4 * it + (j >> 1), blk), keep_lane + 4 * (i & 1),
                                     keep_bit + 4 * (i >> 1) + 2 * (j & 1))
                            assert found == owner[query, key], (key0, it, lane, j, i)
                            seen.add((query, key))
    assert len(seen) == Tq * Tk


def test_wgmma_kernels_read_the_cells_and_bits_modelled(src):
    """The source's index arithmetic is the one the walk above models."""
    body = src[src.index("flash_bwd_dkv_wgmma_kernel("):src.index("// ===========", src.index(
        "flash_bwd_dkv_wgmma_kernel("))]
    assert "keep_cell(a, b, h, 4 * it + rs, blockIdx.x) + keep_lane +" in body
    assert "(kw[j >> 1][i & 1] >> (keep_bit + 4 * (i >> 1) + 2 * (j & 1))) & 1u" in body
    assert "const int first = a.causal ? blk_key0 / TILE : 0;" in body
    # second-product k-steps of 16 queries (keys) all past the end add
    # zeros and are skipped: the walk above takes only the rows that exist
    assert "const int nk = min(4, (a.Tq - q0 + 15) / 16);" in body
    dq = src[src.index("flash_bwd_dq_wgmma_kernel("):src.index("flash_bwd_dkv_wgmma_kernel(")]
    assert "keep_cell(a, b, h, row0 >> 4, it) + lane" in dq
    assert "((word >> (4 * j + i)) & 1u)" in dq
    assert "const int nk = min(4, (blk_end - k0 + 15) / 16);" in dq
    assert ("const int blk_end = a.causal ? min(a.kv_len, (int)(blockIdx.x + 1) * TILE) "
            ": a.kv_len;") in dq


# --------------------------------------------------------------------------
# the swizzled tiles and the matrix descriptors
# --------------------------------------------------------------------------

def _sw128_chunk(r, j):
    return j ^ (r & 7)


def _stage(tile, vec):
    """The bytes of one staged 64 x 64 bf16 tile, as stage_sw128 writes it
    (16-byte copies, or 4-byte words), as a (8192,) int16 array of bf16
    bit patterns indexed by byte offset / 2."""
    mem = np.full(TILE * 64, -1, dtype=np.int64)
    for r in range(TILE):
        if vec:
            for c in range(8):
                off = r * 128 + (_sw128_chunk(r, c) << 4)
                mem[off // 2:off // 2 + 8] = tile[r, 8 * c:8 * c + 8]
        else:
            for w in range(32):
                off = r * 128 + (_sw128_chunk(r, w >> 2) << 4) + 4 * (w & 3)
                mem[off // 2:off // 2 + 2] = tile[r, 2 * w:2 * w + 2]
    assert (mem >= 0).all()
    return mem


def _desc_fields(desc):
    return dict(start=(desc & 0x3FFF) << 4, lbo=((desc >> 16) & 0x3FFF) << 4,
                sbo=((desc >> 32) & 0x3FFF) << 4, layout=desc >> 62)


def _sw(addr):
    """Swizzle<3,4,3> of a byte address in a 1024-aligned tile: bits 4-6 ^=
    bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _read_b(mem, start, sbo, k_major):
    """The 16 x 64 B operand (k, n) that a wgmma m64n64k16 reads through a
    128-byte-swizzle descriptor: K-major, element (n, k) at start + (n % 8)
    128 + (n / 8) SBO + 2 k; MN-major, element (k, n) at start + (k % 8) 128
    + (k / 8) SBO + 2 n (one 64-element span along n)."""
    out = np.zeros((KSTEP, 64), dtype=np.int64)
    for kk in range(KSTEP):
        for n in range(64):
            if k_major:
                addr = start + (n % 8) * 128 + (n // 8) * sbo + 2 * kk
            else:
                addr = start + (kk % 8) * 128 + (kk // 8) * sbo + 2 * n
            out[kk, n] = mem[_sw(addr) // 2]
    return out


def _sw128_desc_of(src):
    """The descriptor the source builds, as a function of the address."""
    body = src[src.index("uint64_t sw128_desc(uint32_t addr) {"):]
    expr = body[body.index("return") + 6:body.index(";")]
    lbo = int(re.search(r"\((\d+)ull << 16\)", expr).group(1))
    sbo = int(re.search(r"\((\d+)ull << 32\)", expr).group(1))
    layout = int(re.search(r"\((\d+)ull << 62\)", expr).group(1))
    assert "(addr & 0x3FFFF) >> 4" in expr
    return lambda addr: ((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (layout << 62)


@pytest.mark.parametrize("vec", [True, False])
def test_swizzled_tile_reads_as_both_operands(src, vec):
    """A staged tile of 64 rows (keys, or queries) x 64 head dims, read
    through the source's descriptor: K-major at start + 32 bytes a k-step
    gives rows x d (the B of S = Q K^T and S^T = K Q^T), MN-major at start
    + 2048 bytes a k-step gives 16 rows x d (the B of dQ += dS K, dV += P^T
    dO, dK += dS^T Q); the layout is the 128-byte swizzle (1), the 8-row
    groups 1024 bytes apart."""
    tile = np.arange(TILE * 64, dtype=np.int64).reshape(TILE, 64)
    mem = _stage(tile, vec)
    desc_of = _sw128_desc_of(src)
    for ks in range(4):                                  # K-major: 16 head dims a k-step
        f = _desc_fields(desc_of(32 * ks))
        assert f["layout"] == 1 and f["sbo"] == 1024
        got = _read_b(mem, f["start"], f["sbo"], True)
        np.testing.assert_array_equal(got.T, tile[:, 16 * ks:16 * ks + 16])
    for kk in range(4):                                  # MN-major: 16 rows a k-step
        f = _desc_fields(desc_of(2048 * kk))
        got = _read_b(mem, f["start"], f["sbo"], False)
        np.testing.assert_array_equal(got, tile[16 * kk:16 * kk + 16])
    assert "sw128_desc(kt + 32 * ks)" in src and "sw128_desc(kt + x * SW_TILE + 2048 * kk)" in src
    assert "sw128_desc(qt + 32 * ks)" in src and "sw128_desc(gt + x * SW_TILE + 2048 * kk)" in src
    assert "__device__ __forceinline__ int sw128_chunk(int r, int j) { return j ^ (r & 7); }" in src


# --------------------------------------------------------------------------
# the TF32 pair at HDP 64
# --------------------------------------------------------------------------

def tf32_dq(q, k, v, d_out, *, kv_len, causal, rate=0.0, keep=None):
    """(dq, lse2, delta) of flash_bwd_dq_tf32_kernel's walk: blocks of 64
    rows, warps of 16, 8-key steps up to the warp's end; pass 0 takes lse2
    and delta from the kernel's own x = S c and dP', pass 1 forms P, dS
    (rounded to the working dtype) and adds each step's dS K (dS split as
    acc_as_a splits it, K by integer rounding at HDP 64: hi lo, lo hi, hi
    hi into a zeroed sum, then one f32 add)."""
    B, Tq, H, Hd = q.shape
    hdp = hd_pad(Hd)
    qf, kf, vf, gf = map(_hf, (q, k, v, d_out))
    pieces = 2 if q.dtype == torch.float32 else 1
    inv = 1.0 / (1.0 - rate)
    dq = torch.zeros((B, H, Tq, Hd))
    lse2 = torch.zeros((B, H, Tq))
    delta = torch.zeros((B, H, Tq))
    for row0 in range(0, Tq, WARP):
        rows = torch.arange(row0, min(row0 + WARP, Tq))
        blk0 = row0 - row0 % 64
        blk_end = min(kv_len, blk0 + 64) if causal else kv_len
        warp_end = min(blk_end, row0 + WARP) if causal else kv_len
        keys = torch.arange(0, -(-warp_end // STEP) * STEP)
        keys = keys[keys < k.shape[1]]
        x = scaled_scores(qf[:, :, rows], kf[:, :, keys], pieces, Hd)
        d = first_product(gf[:, :, rows], vf[:, :, keys], pieces, hdp)
        hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
        x = x.masked_fill(hidden, -math.inf)
        if keep is not None:
            d = torch.where(keep[:, :, rows][..., keys], d * inv, 0.0)
        m = x.amax(-1, keepdim=True)
        l = torch.exp2(x - m).sum(-1, keepdim=True)
        dl = (torch.exp2(x - m) * d).sum(-1, keepdim=True) / l
        l2 = m + torch.log2(l)
        ds = _rounded(torch.exp2(x - l2) * (d - dl), q.dtype)
        acc = torch.zeros((B, H, len(rows), Hd))
        for j in range(0, len(keys), STEP):
            acc = acc + _second(ds[..., j:j + STEP], kf[:, :, keys[j:j + STEP]], pieces, hdp)
        dq[:, :, rows] = acc * _f32(1.0 / math.sqrt(Hd))
        lse2[:, :, rows], delta[:, :, rows] = l2[..., 0], dl[..., 0]
    return dq.permute(0, 2, 1, 3).to(q.dtype), lse2, delta


def _second(a, b, pieces, hdp):
    """One step's a b (a: rows x 8, b: 8 x Hd) as mma_add_as forms it: a
    split as acc_as_a splits it, b by integer rounding at HDP 64 and by
    cvt.rna elsewhere; hi lo, lo hi, hi hi into a zeroed sum."""
    if pieces == 1:
        return _exact(a, b)
    (ah, al), (bh, bl) = split_of(hdp)(a), split_of(hdp)(b)
    t = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for x, y in ((ah, bl), (al, bh), (ah, bh)):
        t = t + _exact(x, y)
    return t


def tf32_dkv(q, k, v, d_out, lse2, delta, *, kv_len, causal, rate=0.0, keep=None):
    """(dk, dv) of flash_bwd_dkv_tf32_kernel's walk: warps of 16 keys, 8-query
    steps from the block's causal start; S^T and dP^T through first_product
    with K and V as A, P^T = 2^(x^T - lse2), the second products as in
    tf32_dq."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    hdp = hd_pad(Hd)
    tile = 64 if hdp <= 64 else 32
    qf, kf, vf, gf = map(_hf, (q, k, v, d_out))
    live = (torch.arange(Tk) < kv_len)[:, None]
    kf, vf = kf * live, vf * live
    pieces = 2 if q.dtype == torch.float32 else 1
    inv = 1.0 / (1.0 - rate)
    dk = torch.zeros((B, H, Tk, Hd))
    dv = torch.zeros((B, H, Tk, Hd))
    for key0 in range(0, Tk, WARP):
        keys = torch.arange(key0, min(key0 + WARP, Tk))
        blk0 = key0 - key0 % 64
        if blk0 >= kv_len:
            continue
        q_first = (blk0 // tile) * tile if causal else 0
        if q_first >= Tq:
            continue
        rows = torch.arange(q_first, Tq)
        rows = rows[~(causal & (rows - rows % STEP + STEP - 1 < key0))]
        xt = scaled_scores(kf[:, :, keys], qf[:, :, rows], pieces, Hd)
        dpt = first_product(vf[:, :, keys], gf[:, :, rows], pieces, hdp)
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
        for j in range(0, len(rows), STEP):
            r = rows[j:j + STEP]
            dv[:, :, keys] += _second(pd[..., j:j + STEP], gf[:, :, r], pieces, hdp)
            dk[:, :, keys] += _second(ds[..., j:j + STEP], qf[:, :, r], pieces, hdp)
    scale = _f32(1.0 / math.sqrt(Hd))
    return tuple(t.permute(0, 2, 1, 3).to(k.dtype) for t in (dk * scale, dv))


def tf32_backward(q, k, v, d_out, **kw):
    dq, lse2, delta = tf32_dq(q, k, v, d_out, **kw)
    return (dq,) + tf32_dkv(q, k, v, d_out, lse2, delta, **kw)


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / max(1.0, float(want.abs().max()))


def _f64_grads(q, k, v, d_out, rate=0.0, keep=None, **kw):
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    out = tfa.reference_mha(*leaves, dropout_rate=rate, keep=keep, **kw)
    return torch.autograd.grad(out, leaves, d_out.double())


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [40, 64, 75])
@pytest.mark.parametrize("tq,tk,kv_len,causal", [(40, 40, 40, False), (65, 129, 100, True),
                                                 (32, 70, 70, False)])
def test_tf32_walk_within_1e_5_of_f64(tq, tk, kv_len, causal, hd, rate):
    """The TF32 pair's walk (HDP 64: integer split; Hd 75 pads to 128:
    the integer split too, 32-query tiles) against float64 autograd
    under the same mask: dq, dk, dv within 1e-5 of the largest value, where
    the card holds the kernels to 1e-4."""
    q, k, v, g = map(torch.as_tensor, _inputs(tq + 3 * hd, tq, tk, hd))
    keep = _keep(tq * hd, rate, 2, 2, tq, tk)
    got = tf32_backward(q, k, v, g, kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    want = _f64_grads(q, k, v, g, rate, keep, kv_len=kv_len, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) < 1e-5, (name, _rel(a, b))
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def test_tf32_walk_matches_pallas():
    """Against the JAX package's Pallas backward in interpret mode (head
    slot 64) through its vjp, rate 0, within 1e-4 (the card's f32 tolerance)."""
    tq, tk, causal = 40, 70, True
    q, k, v, g = _inputs(77, tq, tk, 64)
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = tf32_backward(*map(torch.as_tensor, (q, k, v, g)), kv_len=tk, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("hd", [40, 64])
def test_tf32_scores_are_the_forward_s_to_the_bit(hd):
    """At HDP 64 the forward's x of every visited tile, the dQ kernel's x (Q
    as A) and the dK/dV kernel's x^T (K as A) are one bit pattern, and so
    are dQ's dP = dO V^T and dK/dV's dP^T = V dO^T: the integer split is
    applied to every operand alike and hi hi + (lo hi + hi lo) is symmetric
    in its operands."""
    tq = tk = 130
    q, k, v, g = map(torch.as_tensor, _inputs(41 + hd, tq, tk, hd))
    seen = {}
    tf32_forward(q, k, v, kv_len=120, causal=True, scores=seen, tile=32, block=64)
    qf, kf, vf, gf = map(_hf, (q, k, v, g))
    x_dq = scaled_scores(qf, kf, 2, hd)
    x_dkv = scaled_scores(kf, qf, 2, hd).transpose(-1, -2)
    assert torch.equal(x_dq.view(torch.int32), x_dkv.view(torch.int32))
    for (row0, k0), x in seen.items():
        rows, cols = slice(row0, row0 + x.shape[2]), slice(k0, k0 + x.shape[3])
        assert torch.equal(x.view(torch.int32), x_dq[:, :, rows, cols].contiguous().view(torch.int32))
    dp = first_product(gf, vf, 2, 64)
    dpt = first_product(vf, gf, 2, 64).transpose(-1, -2)
    assert torch.equal(dp.view(torch.int32), dpt.view(torch.int32))
    # and they differ from the cvt.rna scores of the other head dims
    assert not torch.equal(x_dq, first_product(qf, kf, 2, 32) * _f32(scale_c(hd)))


def test_tf32_one_hot_rows_keep_p_exactly_one():
    """Logits in the hundreds at HDP 64: the forward's P of the winning key
    and the backward's, 2^(x - lse2) from its own pass 0 (lse2 = max), are
    both exactly 1 and the losers' exactly 0."""
    rng = np.random.default_rng(12)
    T, Hd = 64, 64
    q = torch.as_tensor(rng.standard_normal((1, 1, T, Hd)) * 20, dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((1, 1, T, Hd)) * 20, dtype=torch.float32)
    x = scaled_scores(q, k, 2, Hd)[0, 0]
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(-1, keepdim=True)
    one_hot = (p > 0).sum(-1) == 1
    assert int(one_hot.sum()) > T // 4
    lse2 = (m + torch.log2(l))[one_hot]
    bwd = torch.exp2(scaled_scores(k, q, 2, Hd)[0, 0].T[one_hot] - lse2)
    assert torch.equal((p / l)[one_hot], bwd)
    assert set(bwd.unique().tolist()) == {0.0, 1.0}


def test_split_by_head_dim_in_the_source(src):
    """HDP 64 (and since the HDP-128 redesign 128) takes the integer split:
    HDP 32 keeps cvt.rna (its bits); the bf16 backward keeps the mma.sync
    pair at HDP 32 and takes the wgmma pair at 64 and 128."""
    assert ("template <int HDP> __host__ __device__ constexpr bool tf32_bits() "
            "{ return HDP >= 64; }") in src
    assert "split_as<P, BITS>(bp[8 * ds], x);" in src
    body = src[src.index("int backward_mma("):src.index("ICEK_EXPORT int flash_bwd_bf16_mma(")]
    assert "launch_dq_mma<32, 4>" in body and "launch_dkv_mma<32, 2>" in body
    assert "} else {   // the wgmma pair" in body
    assert "launch_dq_wgmma<HDP>(" in body and "launch_dq_mma<HDP" not in body


# --------------------------------------------------------------------------
# shared memory and registers against an H100
# --------------------------------------------------------------------------

SMEM_LIMIT = 232448       # a block's shared memory on an H100 (sm_90)
SM_SMEM = 233472          # an SM's
REGS_SM, REGS_THREAD = 65536, 255


def _const(src, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    return m.group(1)


def test_wgmma_launch_shared_memory(src):
    """SW_TILE is a 64-row tile of 128-byte rows; the dQ launch asks for
    four of them and 1024 bytes of alignment, dK/dV besides the two
    buffers' lse and delta rows: 33 and 34 KB, under the default 48 KB (no
    opt-in), six blocks an SM by shared memory."""
    assert _const(src, "SW_TILE") == "TILE * 128"
    tile = 64 * 128
    dq = eval(_const(src, "WG_DQ_BYTES").replace("SW_TILE", str(tile)))
    dkv = eval(_const(src, "WG_DKV_BYTES").replace("SW_TILE", str(tile)).replace("TILE", "64"))
    assert (dq, dkv) == (4 * tile + 1024, 4 * tile + 2 * 2 * 64 * 4 + 1024)
    assert max(dq, dkv) <= 48 * 1024 <= SMEM_LIMIT
    assert SM_SMEM // dkv >= 6


def test_live_registers_fit_an_h100():
    """The registers each launch keeps live a thread at its peak, counted
    from the kernels' arrays: within 255, and at least two blocks an SM on
    the register file.  wgmma dQ: Q and dO fragments (2 x 4 k-steps x 4),
    the dQ, S and dP accumulators (3 x 32), dS (4 x 4); wgmma dK/dV: K and
    V (2 x 16), dK, dV, S^T, dP^T (4 x 32), P^T and dS^T (2 x 16); TF32
    at HDP 64 (f32): Q and dO, or K and V, split in registers (2 x 8
    d-steps x 2 pieces x 4), the accumulator(s) (dQ 8 x 4; dK and dV 2 x 8
    x 4) and two steps' chains of S and dP (2 x 2 x 3 x 4, unrolled by two;
    one step's in dK/dV, whose accumulators take the room)."""
    counts = {"wgmma dq": 2 * 16 + 3 * 32 + 16,
              "wgmma dkv": 2 * 16 + 4 * 32 + 2 * 16,
              "tf32 dq": 2 * 8 * 2 * 4 + 8 * 4 + 2 * 2 * 3 * 4,
              "tf32 dkv": 2 * 8 * 2 * 4 + 2 * 8 * 4 + 2 * 3 * 4}
    for name, n in counts.items():
        assert n <= REGS_THREAD - 16, name             # room for indices and addresses
        assert REGS_SM // (128 * min(REGS_THREAD, n + 16)) >= 2, name
