"""The f32 flash backward's tensor-core arithmetic (``icek_torch/csrc/
flash_attention.cu``, ``flash_bwd_dq_tf32_kernel`` and
``flash_bwd_dkv_tf32_kernel``), emulated in torch on the CPU.

What is emulated:

* ``cvt.rna.tf32.f32``: round an f32 to TF32 (10 mantissa bits) to nearest,
  ties away from zero, by bit arithmetic on the f32's bits (add half of the
  13 dropped bits' weight to the magnitude, then clear them);
* the 3xTF32 split of an operand x into hi = rna(x) and lo = rna(x - hi),
  and a product as lo hi + hi lo + hi hi: each term's sum over the depth
  exact (float64: products of TF32 values are exact there), the three
  added in f32, as the kernels accumulate in f32;
* one TF32 pass, hi hi alone, for comparison;
* the backward's five products at an encoder-like site (B 2, H 2, T 301,
  Hd 30; inputs from numpy's seeded generator): S = Q K^T, dP = dO V^T,
  dV = P^T dO, dQ = dS K, dK = dS^T Q, with the softmax, delta =
  rowsum(P dP) and dS in f32, as the kernels form them.

dQ, dK and dV are held against the same backward in float64: three terms
within 1e-5 of the largest value (at least 1), where the card's checks hold
the kernels to 1e-4, and one pass off by more than 1e-4 (it cannot pass
them).  Besides: the fragment layouts of mma.sync m16n8k8 that let an
accumulator tile be the next product's A operand without a shuffle, and
the lanes that share a Philox block in the dQ and dK/dV kernels.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def tf32_rna(x):
    """x (float32 tensor) rounded to TF32, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return (sign | (mag & ~0x1FFF)).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32(a, b, terms=3):
    """a @ b (float32) as the kernels take it: three TF32 products (or one),
    each summed exactly, added in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    exact = lambda u, v: (u.double() @ v.double()).float()
    if terms == 1:
        return exact(ah, bh)
    return (exact(al, bh) + exact(ah, bl)) + exact(ah, bh)


def backward(q, k, v, d_out, mm):
    """dQ, dK, dV of softmax(Q K^T / sqrt(Hd)) V (heads first: (B, H, T, Hd))
    with every product through `mm` and the rest in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm(q, k.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    dp = mm(d_out, v.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)       # the kernels' delta: rowsum(P dP)
    ds = p * (dp - delta)
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), d_out))


@pytest.fixture(scope="module")
def site():
    rng = np.random.default_rng(1230)
    q, k, v, d_out = (torch.as_tensor(rng.standard_normal((2, 2, 301, 30)), dtype=torch.float32)
                      for _ in range(4))
    want = backward(*(t.double() for t in (q, k, v, d_out)), lambda a, b: a @ b)
    return (q, k, v, d_out), want


def _rel(got, want):
    return float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_three_tf32_terms_within_1e_5_of_f64(site, which):
    inputs, want = site
    got = backward(*inputs, lambda a, b: mm_tf32(a, b, 3))
    assert _rel(got[which], want[which]) < 1e-5


def test_one_tf32_pass_breaks_the_1e_4_checks(site):
    inputs, want = site
    got = backward(*inputs, lambda a, b: mm_tf32(a, b, 1))
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) > 1e-4, errs


def test_f32_itself_is_within_1e_5_of_f64(site):
    """The yardstick: plain f32 products (the plain version on the card)."""
    inputs, want = site
    got = backward(*inputs, lambda a, b: a @ b)
    assert max(_rel(g, w) for g, w in zip(got, want)) < 1e-5


def test_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                     # TF32's spacing on [1, 2)
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      3.0, 0.0, -0.0], dtype=torch.float32)
    want = [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, 0.0, -0.0]
    got = tf32_rna(x)
    assert got.tolist() == want
    assert torch.signbit(got[-1])
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_split_keeps_22_bits():
    """hi + lo is x to 2^-22 of |x|; hi alone to 2^-11."""
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(100000), dtype=torch.float32)
    hi, lo = split(x)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11
    err = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -22


def _mma(a_regs, b_regs):
    """mma.sync m16n8k8 (TF32) from its fragments: a_regs[lane] = (a0..a3)
    with a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b_regs
    [lane] = (b0, b1) with b0 (k t, n g), b1 (k t + 4, n g); returns the 16 x 8
    product."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_regs[lane]
        B[t, g], B[t + 4, g] = b_regs[lane]
    return A @ B


def _acc(C):
    """C (16 x 8) as accumulator registers: c0 (g, 2t), c1 (g, 2t + 1),
    c2 (g + 8, 2t), c3 (g + 8, 2t + 1)."""
    return [(C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1])
            for g, t in ((lane >> 2, lane & 3) for lane in range(32))]


def test_accumulator_is_the_next_a_operand():
    """acc_as_a: registers (c0, c2, c1, c3) taken as (a0, a1, a2, a3), with the
    second product's B rows read as the kernels read them (row 2 t as k index
    t, 2 t + 1 as t + 4), give C @ W: P and dS need no shuffle."""
    rng = np.random.default_rng(8)
    C = rng.integers(-9, 10, (16, 8)).astype(float)       # an accumulator tile (16 rows x 8 keys)
    W = rng.integers(-9, 10, (8, 8)).astype(float)        # K, V, dO or Q: 8 keys x 8 of Hd
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in _acc(C)]
    b = [(W[2 * t, g], W[2 * t + 1, g]) for g, t in ((lane >> 2, lane & 3) for lane in range(32))]
    np.testing.assert_array_equal(_mma(a, b), C @ W)
    # read in the natural order instead, the product is wrong
    natural = [(W[t, g], W[t + 4, g]) for g, t in ((lane >> 2, lane & 3) for lane in range(32))]
    assert not np.array_equal(_mma(a, natural), C @ W)


def _blocks(Tq, Tk, rows):
    """(block, word) of each score (row, key): block row * Tk4 / 4 + key / 4."""
    tk4 = -(-Tk // 4) * 4
    return {(r, key): (r * tk4 // 4 + key // 4, key % 4) for r in rows for key in range(Tk)}


def test_dq_kernel_lanes_draw_each_score_s_block():
    """keep4_rows in the dQ kernel: lane (g, t) holds (row g + 8 (i / 2), key
    kb + 2 t + i % 2); the even lane of a pair draws row g's block, the odd
    lane row g + 8's, each at mblk + kb / 4, and they trade two words."""
    Tq, Tk = 32, 70
    want = _blocks(Tq, Tk, range(Tq))
    seen = {}
    for row0 in (0, 16):
        for kb in range(0, Tk - 8 + 1, 8):
            drawn = {}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                row = row0 + g + (8 if t & 1 else 0)
                drawn[lane] = (row * (-(-Tk // 4)) + (t >> 1) + kb // 4)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                odd = t & 1
                # keep4_rows: w0, w1 of row g; w2, w3 of row g + 8
                own, other = drawn[lane], drawn[lane ^ 1]
                # words: the even lane keeps x, y of its block (row g) and sends z, w;
                # the odd lane keeps z, w of its block (row g + 8) and sends x, y
                regs = [(other, 2) if odd else (own, 0), (other, 3) if odd else (own, 1),
                        (own, 2) if odd else (other, 0), (own, 3) if odd else (other, 1)]
                for i, got in enumerate(regs):
                    row, key = row0 + g + 8 * (i >> 1), kb + 2 * t + (i & 1)
                    seen[row, key] = got
    for pos, got in seen.items():
        assert got == want[pos], pos
    assert len(seen) == Tq * (Tk // 8 * 8)


def test_dkv_kernel_lanes_draw_each_score_s_block():
    """keep4_cols in the dK/dV kernel: lane (g = 4 u + c, t) holds (query qb + 2
    t + i % 2, key key0 + g + 8 (i / 2)); it draws the block of query qb + 2 t
    + c % 2 at kblk = (key0 + 8 (c / 2)) / 4 + u, and in round x keeps, as
    register c ^ x, word c of lane c ^ x's block: one block per four scores."""
    Tq, Tk = 40, 64
    want = _blocks(Tq, Tk, range(Tq))
    tk4 = -(-Tk // 4) * 4
    seen = {}
    for key0 in range(0, Tk, 16):
        for qb in range(0, Tq, 8):
            drawn = {}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c, u = g & 3, g >> 2
                kblk = (key0 + 8 * (c >> 1)) // 4 + u
                drawn[lane] = (qb + 2 * t + (c & 1)) * tk4 // 4 + kblk
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c = g & 3
                regs = {}
                for x in range(4):
                    src = lane ^ (x << 2)            # __shfl_xor_sync(.., x << 2)
                    src_c = (src >> 2) & 3
                    regs[c ^ x] = (drawn[src], src_c ^ x)   # the sender's word c_src ^ x
                for i in range(4):
                    query, key = qb + 2 * t + (i & 1), key0 + g + 8 * (i >> 1)
                    seen[query, key] = regs[i]
    for pos, got in seen.items():
        assert got == want[pos], pos
    assert len(seen) == Tq * Tk


def test_one_hot_rows_cancel_with_their_own_delta():
    """Logits in the hundreds make softmax one-hot, and the exact dS of a row's
    winning key is 0.  With delta = rowsum(P dP) from the kernel's own 3xTF32
    dP (what the dQ kernel's pass 0 takes) the winning key's dS is 0 to the
    bit; with delta = rowsum(dO O), O rounded along the forward's f32 path,
    it is not (the cancellation keeps the difference of two roundings)."""
    rng = np.random.default_rng(11)
    T, Hd = 64, 30
    q = torch.as_tensor(rng.standard_normal((T, Hd)) * 20, dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((T, Hd)) * 20, dtype=torch.float32)
    v, d_out = (torch.as_tensor(rng.standard_normal((T, Hd)), dtype=torch.float32)
                for _ in range(2))
    s = (q @ k.T) / math.sqrt(Hd)
    assert float(s.abs().max()) > 300
    p = torch.softmax(s, dim=-1)
    rows = (p > 0).sum(dim=-1) == 1                             # the one-hot rows
    assert int(rows.sum()) > T // 4
    p, d_out = p[rows], d_out[rows]
    dp = mm_tf32(d_out, v.T, 3)
    own = (p * dp).sum(dim=-1, keepdim=True)
    fwd = (d_out * (p @ v)).sum(dim=-1, keepdim=True)
    win = p.argmax(dim=-1, keepdim=True)
    ds_own, ds_fwd = (p * (dp - own)).gather(1, win), (p * (dp - fwd)).gather(1, win)
    assert bool((ds_own == 0).all())
    assert int((ds_fwd != 0).sum()) > 0
