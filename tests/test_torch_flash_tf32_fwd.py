"""The TF32 flash forward (``icek_torch/csrc/flash_attention.cu``,
``flash_fwd_tf32_kernel``: float32 and misaligned bfloat16 at head dims up
to 32), emulated in torch on the CPU.

What is emulated, with the kernel's loop bounds and skip rules:

* a block of 64 query rows (32 when Tq <= 32), a warp of 16, key tiles of
  64; tiles beyond ``kv_len`` or above the causal diagonal skipped, the
  straddling tile masked by element;
* the scores 8 keys at a time as ``first_product`` forms them: each operand
  split into hi = rna(x) and lo = rna(x - hi) (``cvt.rna.tf32.f32``), the
  hi hi, lo hi and hi lo terms each summed exactly (float64: products of
  TF32 values are exact there) and added hi hi + (lo hi + hi lo) in f32;
  then x = S (scale log2 e) rounded once, as the dQ kernel rounds it;
* the online softmax in the log2 domain once a tile; P = 2^(x - max)
  rounded to the working dtype and split as above (``acc_as_a``), O += P V
  one 8-key step at a time, V split by integer rounding
  (``split_tf32_bits``: hi = rna(x), lo = x - hi with its low 13 bits
  truncated by the tensor cores), each step's three terms (hi lo, lo hi, hi
  hi) summed into a zeroed accumulator and added to O by an f32 add
  (``mma_add_bits``); bf16 as one exact term.

The emulation is held to float64 within 1e-5, to ``reference_mha`` in f32
and to the JAX package's Pallas forward (interpret mode) within 1e-4, the
card's f32 tolerance.  Its scores are the TF32 backward's to the bit (the
dQ kernel's S and the dK/dV kernel's S^T through ``first_products``, the
same rounded scale), so a one-hot row's P is exactly 1 in both directions;
and its lanes draw exactly ``keep_mask``'s Philox blocks.
"""

import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import _build
from icek_torch.kernels import flash_attention as tfa
from icek_tpu.kernels import flash_attention as jfa
from test_torch_decoder_tiles import split_tf32 as split_bits
from test_torch_tf32_split import split, tf32_rna

TILE, WARP, STEP = 64, 16, 8
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small torch ops: one thread each (see the tiles files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _exact(a, b):
    """a @ b summed exactly (float64), rounded to f32 once."""
    return (a.double() @ b.double()).float()


def hd_pad(hd):
    """The kernels' padded head dim (``hd_pad`` in the source)."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def split_of(hdp):
    """How the kernels of padded head dim `hdp` split an operand
    (``split_as`` / ``tf32_bits``): by integer rounding at HDP 64 and 128
    (lo's low 13 bits truncated by the tensor cores), by cvt.rna at 32."""
    return split_bits if hdp >= 64 else split


def first_product(a, b, pieces, hdp=32):
    """S = a b^T as first_product forms it: hi hi + (lo hi + hi lo) in f32,
    each term's sum exact; one exact term for bf16 values (P = 1).  At HDP
    64 both operands are split by integer rounding (``split_of``)."""
    if pieces == 1:
        return _exact(a, b.transpose(-1, -2))
    (ah, al), (bh, bl) = split_of(hdp)(a), split_of(hdp)(b)
    bt = lambda t: t.transpose(-1, -2)
    return _exact(ah, bt(bh)) + (_exact(al, bt(bh)) + _exact(ah, bt(bl)))


def pv_step(p, v, pieces, hdp=32):
    """One 8-key step's P V as mma_add_bits forms it into a zeroed
    accumulator (P split as acc_as_a splits it, V by integer rounding): hi
    lo, then lo hi, then hi hi, each added in f32."""
    if pieces == 1:
        return _exact(p, v)
    (ph, pl), (vh, vl) = split_of(hdp)(p), split_bits(v)
    t = torch.zeros(p.shape[:-1] + v.shape[-1:])
    for a, b in ((ph, vl), (pl, vh), (ph, vh)):
        t = t + _exact(a, b)
    return t


def scale_c(hd):
    """The kernel's c = scale * LOG2E, both f32 (``a.scale`` is 1 / sqrt(Hd)
    as the wrapper passes it, a C float)."""
    return float(_f32(1.0 / math.sqrt(hd)) * _f32(LOG2E))


def scaled_scores(a, b, pieces, hd):
    """x = S c rounded once (__fmul_rn), the kernels' log2-domain scores."""
    return first_product(a, b, pieces, hd_pad(hd)) * _f32(scale_c(hd))


def _heads_first(t):
    return t.to(torch.float32).permute(0, 2, 1, 3)          # (B, H, T, Hd)


def _row_end(rows, kv_len, causal):
    return torch.clamp(rows + 1, max=kv_len) if causal else torch.full_like(rows, kv_len)


def tf32_forward(q, k, v, *, kv_len, causal, rate=0.0, keep=None, scores=None, tile=TILE,
                 block=None):
    """(out (B, Tq, H, Hd) in q's dtype, lse (B, H, Tq) f32) of the TF32
    forward's walk; `scores`, a dict, collects each visited tile's x by
    (row0, k0).  `tile` is the key tile (``ftile_of``: 64, and 32 at a
    padded head dim of 128), `block` the query rows of a block (default:
    64, 32 when Tq <= 32, as at head dims up to 32)."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    pieces = 2 if q.dtype == torch.float32 else 1
    qf, kf, vf = map(_heads_first, (q, k, v))
    block = block or WARP * (4 if Tq > 32 else 2)
    out = torch.zeros((B, H, Tq, Hd))
    lse = torch.zeros((B, H, Tq))
    inv = _f32(1.0 / (1.0 - rate))
    for blk0 in range(0, Tq, block):
        blk_end = min(kv_len, blk0 + block) if causal else kv_len
        for row0 in range(blk0, min(blk0 + block, Tq), WARP):
            rows = torch.arange(row0, min(row0 + WARP, Tq))
            warp_end = min(kv_len, row0 + WARP) if causal else kv_len
            m = torch.full((B, H, len(rows)), -math.inf)
            l = torch.zeros((B, H, len(rows)))
            acc = torch.zeros((B, H, len(rows), Hd))
            for k0 in range(0, blk_end, tile):
                if k0 >= warp_end:
                    continue
                keys = torch.arange(k0, min(k0 + tile, Tk))
                x = scaled_scores(qf[:, :, rows], kf[:, :, keys], pieces, Hd)
                if scores is not None:
                    scores[row0, k0] = x.clone()
                if k0 + tile > kv_len or (causal and k0 + tile > row0 + 1):
                    hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
                    x = x.masked_fill(hidden, -math.inf)
                m_new = torch.maximum(m, x.amax(-1))
                assert torch.isfinite(m_new).all()      # key k0 is visible to every row
                alpha = torch.exp2(m - m_new)
                l = l * alpha
                acc = acc * alpha[..., None]
                p = torch.exp2(x - m_new[..., None])
                l = l + p.sum(-1)                       # the sum takes every key
                if keep is not None:
                    p = torch.where(keep[:, :, rows][..., keys], p, 0.0)
                p = p.to(q.dtype).to(torch.float32)
                for j in range(0, len(keys), STEP):
                    acc = acc + pv_step(p[..., j:j + STEP], vf[:, :, keys[j:j + STEP]], pieces,
                                        hd_pad(Hd))
                m = m_new
            out[:, :, rows] = acc * (inv / l)[..., None]
            lse[:, :, rows] = (m + torch.log2(l)) * LN2
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _inputs(seed, tq, tk, B=2, H=2, Hd=30):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, Hd)).astype(np.float32) for t in (tq, tk, tk)]


def _keep(seed, rate, B, H, tq, tk):
    if not rate:
        return None
    rng = np.random.default_rng(seed + 1000)
    return torch.as_tensor(rng.random((B, H, tq, tk)) < 1.0 - rate)


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / max(1.0, float(want.abs().max()))


# the geo train step's three sites, the fact presets' 51-row encoder, and
# ragged ones around the 16-row, 8-key and 64-key tile edges
SHAPES = [(301, 301, 301, False), (32, 32, 32, True), (32, 497, 497, False),
          (51, 51, 51, False), (15, 17, 17, False), (65, 129, 100, True), (13, 37, 30, False)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("tq,tk,kv_len,causal", SHAPES)
def test_tf32_forward_within_1e_5_of_f64(tq, tk, kv_len, causal, rate):
    """Output and logsumexp of the walk against the same attention in
    float64 under the same mask: within 1e-5 of the largest value (at least
    1), where the card's checks hold the kernel to 1e-4."""
    q, k, v = map(torch.as_tensor, _inputs(tq * 1000 + tk, tq, tk))
    keep = _keep(tq + tk, rate, 2, 2, tq, tk)
    got, lse = tf32_forward(q, k, v, kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    want = tfa.reference_mha(q.double(), k.double(), v.double(), kv_len=kv_len, causal=causal,
                             dropout_rate=rate, keep=keep)
    assert _rel(got, want) < 1e-5
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(30)
    j = torch.arange(tk)
    hidden = j[None, :] >= kv_len
    if causal:
        hidden = hidden | (j[None, :] > torch.arange(tq)[:, None])
    want_lse = torch.logsumexp(s.masked_fill(hidden, -math.inf), dim=-1)
    assert float((lse.double() - want_lse).abs().max()) < 1e-5


@pytest.mark.parametrize("tq,tk,kv_len,causal", [(301, 301, 301, False), (32, 32, 32, True),
                                                 (32, 497, 497, False), (65, 129, 100, True)])
def test_tf32_forward_matches_plain_f32(tq, tk, kv_len, causal):
    """Against the port's plain version in float32 within 1e-4 (the card's
    FLASH_TOLS), at rate 0 and at rate 0.2 under the same mask."""
    q, k, v = map(torch.as_tensor, _inputs(7 * tq + tk, tq, tk))
    for rate in (0.0, 0.2):
        keep = _keep(tq * tk, rate, 2, 2, tq, tk)
        got, _ = tf32_forward(q, k, v, kv_len=kv_len, causal=causal, rate=rate, keep=keep)
        want = tfa.reference_mha(q, k, v, kv_len=kv_len, causal=causal, dropout_rate=rate,
                                 keep=keep)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


@pytest.mark.parametrize("tq,tk,kv_len,causal", [(32, 32, 32, True), (15, 33, 20, False),
                                                 (40, 70, 70, True)])
def test_tf32_forward_matches_pallas(tq, tk, kv_len, causal):
    """Against the JAX package's Pallas forward in interpret mode (through
    flash_mha_packed, which takes kv_len), rate 0, within 1e-4."""
    B, H, Hd = 2, 3, 30
    q, k, v = _inputs(3 * tq + tk, tq, tk, B=B, H=H)
    slot = jfa.head_slot(Hd, jfa.resolve_slot())
    pack = lambda x: jfa.pack_heads(jnp.asarray(x).reshape(B, x.shape[1], H * Hd), H, slot)
    want = jfa.flash_mha_packed(pack(q), pack(k), pack(v), head_dim=Hd, kv_len=kv_len,
                                causal=causal, slot=slot)
    want = jfa.unpack_heads(want, H, Hd, slot).reshape(B, tq, H, Hd)
    got, _ = tf32_forward(*map(torch.as_tensor, (q, k, v)), kv_len=kv_len, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_tf32_forward_bf16_one_exact_pass():
    """bf16 inputs (the misaligned bf16 route): one TF32 pass is exact on
    bf16 values and on P rounded to bf16, so the walk stays within the
    card's bf16 tolerance (3e-2 of the largest value) of the plain version."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(17, 65, 129))
    got, _ = tf32_forward(q, k, v, kv_len=100, causal=True)
    want = tfa.reference_mha(q, k, v, kv_len=100, causal=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want.float()) < 3e-2


def test_one_tf32_pass_misses_the_f32_tolerance():
    """Why three terms: the forward with hi hi alone (one TF32 pass) is off
    by more than the 1e-4 the card holds f32 to, at the geo encoder's
    shape."""
    q, k, v = map(torch.as_tensor, _inputs(23, 301, 301))
    qf, kf, vf = map(_heads_first, (q, k, v))
    s = _exact(tf32_rna(qf), tf32_rna(kf).transpose(-1, -2)) / math.sqrt(30)
    p = torch.softmax(s, dim=-1)
    one = _exact(tf32_rna(p), tf32_rna(vf)).permute(0, 2, 1, 3)
    want = tfa.reference_mha(q.double(), k.double(), v.double())
    three, _ = tf32_forward(q, k, v, kv_len=301, causal=False)
    assert _rel(one, want) > 1e-4 > 1e-5 > _rel(three, want)


def _dq_scores(q, k, hd):
    """The dQ kernel's x of every (row, key): first_products' S with Q as A."""
    return scaled_scores(q, k, 2, hd)


def _dkv_scores(q, k, hd):
    """The dK/dV kernel's x^T: first_products' S^T with K as A, then scaled."""
    return scaled_scores(k, q, 2, hd)


def test_forward_scores_are_the_backward_s_to_the_bit():
    """Every visited tile's x in the forward walk equals, bit for bit, the
    dQ kernel's x (S = Q K^T, Q as A) and the transpose of the dK/dV
    kernel's (S^T = K Q^T, K as A): first_product sums hi hi + (lo hi + hi
    lo), symmetric in its operands, and all three round x = S c alike."""
    tq = tk = 130
    q, k, v = map(torch.as_tensor, _inputs(31, tq, tk))
    seen = {}
    tf32_forward(q, k, v, kv_len=120, causal=True, scores=seen)
    qf, kf = _heads_first(q), _heads_first(k)
    dq = _dq_scores(qf, kf, 30)
    dkv = _dkv_scores(qf, kf, 30).transpose(-1, -2)
    assert torch.equal(dq.view(torch.int32), dkv.view(torch.int32))
    for (row0, k0), x in seen.items():
        rows, cols = slice(row0, row0 + x.shape[2]), slice(k0, k0 + x.shape[3])
        assert torch.equal(x.view(torch.int32), dq[:, :, rows, cols].contiguous().view(torch.int32))
    assert len(seen) == 4 + 4 * 2 + 2         # the tiles the three blocks' warps visit


def test_one_hot_rows_have_the_backward_s_p():
    """Logits in the hundreds (a decoder's first self-attention at init)
    make softmax one-hot.  The forward's P of the winning key, 2^(x - max)
    over a sum of exactly 1, and the backward's, 2^(x - lse2) from its own
    pass 0 (lse2 = max + log2 1 = max), are both exactly 1 and the losers'
    both exactly 0: the same P in both directions."""
    rng = np.random.default_rng(11)
    T, Hd = 64, 30
    q = torch.as_tensor(rng.standard_normal((1, 1, T, Hd)) * 20, dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((1, 1, T, Hd)) * 20, dtype=torch.float32)
    x = _dq_scores(q, k, Hd)[0, 0]
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(-1, keepdim=True)
    one_hot = (p > 0).sum(-1) == 1
    assert int(one_hot.sum()) > T // 4
    fwd = (p / l)[one_hot]
    lse2 = (m + torch.log2(l))[one_hot]
    bwd = torch.exp2(_dkv_scores(q, k, Hd)[0, 0].T[one_hot] - lse2)
    assert torch.equal(fwd, bwd)
    assert set(fwd.unique().tolist()) == {0.0, 1.0}


def test_kernels_form_x_through_first_product():
    """The source: the forward and the dQ kernel form x from first_product
    (first_products calls it for S and dP) and round it by the same
    __fmul_rn(x, c) with c = scale * LOG2E; the dK/dV kernel rounds its S^T
    alike."""
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    fwd = src[src.index("flash_fwd_tf32_body("):src.index("// The TF32 forward's kernels.")]
    assert "first_product<P, BITS>(x[j], qa, &kt[8 * j + g][t]);" in fwd
    assert "x[j][i] = __fmul_rn(x[j][i], c);" in fwd
    assert "const float c = a.scale * LOG2E;" in fwd
    assert "first_product<P, BITS>(s, a1, b1);\n  first_product<P, BITS>(dp, a2, b2);" in src
    # the forward and both backward kernels take one split a head dim
    assert src.count("BITS = tf32_bits<HDP>();") == 3
    assert "x[i] = __fmul_rn(x[i], c);" in src
    assert "fast_exp2(__fmul_rn(st[i], c) - ((i & 1) ? L.y : L.x))" in src


def test_forward_lanes_draw_keep_mask_s_blocks():
    """keep4_rows in the TF32 forward: lane (g, t) holds (row row0 + g + 8 (i
    / 2), key k0 + 8 j + 2 t + i % 2) of step j of tile k0; the even lane of
    a pair draws row g's block, the odd lane row g + 8's, at mblk + (k0 + 8
    j) / 4 with mblk = mask_row_block(b, h, its row) + t / 2; they trade two
    words.  Every score gets the block and word keep_mask_kernel gives it:
    block0 + row * Tk4 / 4 + key / 4 (row the global (b, h, q) row), word
    key % 4."""
    B, H, Tq, Tk = 2, 3, 40, 70
    blk0 = tfa.block0(5, H, Tq, Tk)             # rows 5 .. of a larger batch
    tk4 = -(-Tk // 4)

    def row_block(b, h, row):                   # mask_row_block
        return blk0 + ((b * H + h) * Tq + row) * tk4

    seen = {}
    for b in range(B):
        for h in range(H):
            block = WARP * (4 if Tq > 32 else 2)
            for row0 in range(0, -(-Tq // block) * block, WARP):
                for k0 in range(0, Tk, TILE):
                    for j in range(TILE // STEP):
                        drawn = {}
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            own_row = row0 + g + (8 if t & 1 else 0)
                            drawn[lane] = row_block(b, h, own_row) + (t >> 1) + ((k0 + 8 * j) >> 2)
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            odd = t & 1
                            own, other = drawn[lane], drawn[lane ^ 1]
                            regs = [(other, 2) if odd else (own, 0),
                                    (other, 3) if odd else (own, 1),
                                    (own, 2) if odd else (other, 0),
                                    (own, 3) if odd else (other, 1)]
                            for i, got in enumerate(regs):
                                row, key = row0 + g + 8 * (i >> 1), k0 + 8 * j + 2 * t + (i & 1)
                                if row < Tq and key < Tk:
                                    seen[b, h, row, key] = got
    assert len(seen) == B * H * Tq * Tk
    for (b, h, row, key), got in seen.items():
        # keep_mask_kernel: thread ((b H + h) Tq + row) Tk4 / 4 + key / 4, word key % 4
        want = (blk0 + ((b * H + h) * Tq + row) * tk4 + key // 4, key % 4)
        assert got == want, (b, h, row, key)


def test_flash_route_rule():
    """flash_attention.route, case by case: aligned bf16 with an even head
    dim <= 128 takes the bf16 tensor-core kernels (mma); float32, and bf16
    that misses the alignment or has an odd head dim, up to 128 the TF32
    kernels (tf32); no head dim goes to the CUDA-core forward any more, and
    a head dim above 128 raises, as the JAX package's head_slot does."""
    def qkv(dtype, hd, shift=0):
        buf = torch.zeros(2 * 5 * 3 * hd + shift, dtype=dtype)
        q = buf[shift:].view(2, 5, 3, hd)
        return q, q, q

    assert tfa.route(*qkv(torch.bfloat16, 30)) == "mma"
    assert tfa.route(*qkv(torch.float32, 30)) == "tf32"
    assert tfa.route(*qkv(torch.bfloat16, 30, shift=1)) == "tf32"     # mid-word rows
    assert tfa.route(*qkv(torch.bfloat16, 31)) == "tf32"
    assert tfa.route(*qkv(torch.float32, 8)) == "tf32"
    assert tfa.route(*qkv(torch.float32, 64)) == "tf32"
    assert tfa.route(*qkv(torch.bfloat16, 64)) == "mma"
    assert tfa.route(*qkv(torch.bfloat16, 64, shift=1)) == "tf32"
    assert tfa.route(*qkv(torch.bfloat16, 75)) == "tf32"
    assert tfa.route(*qkv(torch.bfloat16, 128)) == "mma"
    assert tfa.route(*qkv(torch.float32, 128)) == "tf32"
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dim 129"):
            tfa.route(*qkv(dtype, 129))
    assert set(tfa.flash_mha.routes) == set(tfa.ROUTES) == {"mma", "tf32", "cuda_cores"}
