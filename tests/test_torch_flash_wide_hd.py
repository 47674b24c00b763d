"""The flash kernels at head dims 33 to 128 (``icek_torch/csrc/
flash_attention.cu``, padded head dim HDP 64 or 128), and the int8 max
pool's strip tiling (``csrc/int8_conv.cu``, ``maxpool_strip_kernel``),
emulated in torch on the CPU.

The kernels run only on the card (tests/test_torch_gpu.py); here their
walks are held against the plain versions and the JAX package:

* the bf16 tensor-core kernels' tile walk (``test_torch_flash_tiles.py``'s
  emulation, which is written for any head dim: the head dim only pads the
  k-steps of each product) at head dims 40, 64, 75, 96 and 128, against
  ``reference_mha`` and its autograd under an explicit mask, and against the
  JAX package's Pallas kernel in interpret mode at rate 0;
* the TF32 forward's walk (``test_torch_flash_tf32_fwd.py``'s emulation)
  with the key tile the kernel takes at each padded head dim (32 rows above
  HDP 32), against float64 and Pallas; and its scores, to the bit, the dQ
  kernel's S and the dK/dV kernel's S^T at head dims 64 and 128;
* the shared memory each kernel asks for at each padded head dim, against
  what a block may have on an H100;
* the strip pool: R output rows and WC output columns a block, its 2 R + 1
  input rows staged as segments of columns, against JAX's ``reduce_window``
  (the reference's pool).
"""


import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import flash_attention as tfa
from icek_torch.kernels import int8_conv as k8
from icek_tpu.kernels import flash_attention as jfa
from test_torch_flash_tf32_fwd import _dkv_scores, _dq_scores, tf32_forward
from test_torch_flash_tiles import _keep, _plain, tiled_attention


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small torch ops: one thread each (see the tiles files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hd_pad(hd):
    """The kernels' padded head dim (``hd_pad`` in the source)."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def ftile(hd, bwd=False):
    """The TF32 kernels' key (query) tile (``ftile_of``): the forward's 32
    above a padded head dim of 32, the backward's above 64."""
    return 32 if hd_pad(hd) > (64 if bwd else 32) else 64


def _inputs(seed, tq, tk, hd, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, hd)).astype(np.float32) for t in (tq, tk, tk, tq)]


# (tq, tk, kv_len, causal): the 512x8 geo model's three sites at a short
# length, and ragged ones around the 16-row, 32-key and 64-key tile edges
WIDE_SHAPES = [(40, 40, 40, False), (32, 32, 32, True), (32, 70, 70, False),
               (15, 17, 17, False), (65, 129, 100, True)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [40, 64, 75, 96, 128])
@pytest.mark.parametrize("tq,tk,kv_len,causal", WIDE_SHAPES)
def test_tiled_flash_wide_heads_match_plain(tq, tk, kv_len, causal, hd, rate):
    """The bf16 kernels' walk in f32 at wide head dims: output, dq, dk, dv
    within 1e-5 of the plain version and its autograd under the same mask;
    keys at or beyond kv_len get exactly zero gradients."""
    q, k, v, g = map(torch.as_tensor, _inputs(tq * 100 + hd, tq, tk, hd))
    keep = _keep(tq + tk + hd, rate, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    got = tiled_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=name)
    assert not got[2][:, kv_len:].any() and not got[3][:, kv_len:].any()


@pytest.mark.parametrize("hd", [64, 128])
def test_tiled_flash_wide_heads_bf16_within_card_tolerances(hd):
    """bf16 inputs at head dims 64 and 128, P and dS rounded to bf16 before
    their second products: within the card's tolerances (3e-2 forward, 4e-2
    backward of the largest value) of the plain version, at rate 0.2."""
    tq, tk, kv_len, causal = 65, 129, 100, True
    q, k, v, g = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(hd, tq, tk, hd))
    keep = _keep(hd, 0.2, 2, 2, tq, tk)
    kw = dict(kv_len=kv_len, causal=causal, rate=0.2, keep=keep)
    got = tiled_attention(q, k, v, g, **kw)
    want = _plain(q, k, v, g, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        tol = (3e-2 if i == 0 else 4e-2) * max(1.0, float(b.float().abs().max()))
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=tol)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("tq,tk,causal", [(32, 32, True), (15, 40, False)])
def test_tiled_flash_wide_heads_match_pallas(tq, tk, causal, hd):
    """The walk against the JAX package's Pallas kernel in interpret mode
    (its head slot 64 or 128) and its vjp, rate 0, atol 2e-5."""
    q, k, v, g = _inputs(3 * tq + hd, tq, tk, hd)
    want_out, vjp = jax.vjp(lambda a, b, c: jfa.flash_mha(a, b, c, causal=causal),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (want_out,) + tuple(vjp(jnp.asarray(g)))
    got = tiled_attention(*map(torch.as_tensor, (q, k, v, g)), kv_len=tk, causal=causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


@pytest.mark.parametrize("hd", [40, 64, 75, 128])
def test_tf32_forward_wide_heads_within_1e_5_of_f64(hd):
    """The TF32 forward's walk (three TF32 terms a product, the key tile of
    its padded head dim, blocks of 64 rows) against the attention in
    float64: within 1e-5 of the largest value, at rate 0 and 0.2 under one
    mask, where the card holds the kernel to 1e-4."""
    tq, tk, kv_len, causal = 65, 129, 100, True
    q, k, v, _ = map(torch.as_tensor, _inputs(hd + 1, tq, tk, hd))
    for rate in (0.0, 0.2):
        keep = _keep(hd, rate, 2, 2, tq, tk)
        got, _ = tf32_forward(q, k, v, kv_len=kv_len, causal=causal, rate=rate, keep=keep,
                              tile=ftile(hd), block=64)
        want = tfa.reference_mha(q.double(), k.double(), v.double(), kv_len=kv_len,
                                 causal=causal, dropout_rate=rate, keep=keep)
        err = float((got.double() - want).abs().max()) / max(1.0, float(want.abs().max()))
        assert err < 1e-5, (rate, err)


@pytest.mark.parametrize("hd", [64, 128])
def test_tf32_forward_wide_heads_match_pallas(hd):
    """Against the JAX package's Pallas forward in interpret mode, rate 0,
    within 1e-4 (the card's f32 tolerance)."""
    tq, tk, causal = 40, 70, True
    q, k, v, _ = _inputs(5 * hd, tq, tk, hd)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got, _ = tf32_forward(*map(torch.as_tensor, (q, k, v)), kv_len=tk, causal=causal,
                          tile=ftile(hd), block=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("hd", [64, 128])
def test_tf32_forward_scores_are_the_backward_s_to_the_bit_wide(hd):
    """At head dims 64 and 128 every visited tile's x in the forward walk
    (its 32-key tiles) equals, bit for bit, the dQ kernel's x (Q as A)
    and the transpose of the dK/dV kernel's (K as A): first_product sums
    its d-steps in one order whichever operand is A and wherever SplitRows
    keeps it, and all three round x = S c alike."""
    tq = tk = 130
    q, k, v, _ = map(torch.as_tensor, _inputs(31 + hd, tq, tk, hd))
    seen = {}
    tf32_forward(q, k, v, kv_len=120, causal=True, scores=seen, tile=ftile(hd), block=64)
    qf, kf = (t.permute(0, 2, 1, 3) for t in (q, k))
    dq = _dq_scores(qf, kf, hd)
    dkv = _dkv_scores(qf, kf, hd).transpose(-1, -2)
    assert torch.equal(dq.view(torch.int32), dkv.view(torch.int32))
    for (row0, k0), x in seen.items():
        rows, cols = slice(row0, row0 + x.shape[2]), slice(k0, k0 + x.shape[3])
        assert torch.equal(x.view(torch.int32), dq[:, :, rows, cols].contiguous().view(torch.int32))
    tile = ftile(hd)
    # the warps of the three 64-row blocks visit the tiles up to their diagonal
    want = sum(-(-min(120, row0 + 16) // tile) for row0 in range(0, tq, 16))
    assert len(seen) == want


# --------------------------------------------------------------------------
# shared memory a launch asks for
# --------------------------------------------------------------------------

SMEM_LIMIT = 232448       # a block's shared memory on an H100 (sm_90)


def _mma_bytes(hdp, dkv):
    tiles = 2 * 2 * 64 * (hdp + 8) * 2
    if not dkv:
        return tiles
    assert hdp <= 64            # the mma.sync dK/dV kernel's limit (the wgmma pair above)
    return tiles + 2 * 2 * 64 * 4


def _tf32_bytes(pieces, hdp, warps, ops, rows, bwd):
    tk = 32 if hdp > (64 if bwd else 32) else 64
    split = (hdp // 8) * pieces * 32 * 16 if hdp > (64 if bwd else 32) else 0
    return 2 * 2 * tk * (hdp + 4) * 4 + (2 * 2 * tk * 4 if rows else 0) + warps * ops * split


def test_source_smem_formulas():
    """The formulas above are the source's (mma_tiles_bytes, dkv_mma_bytes,
    tf32_bytes, split_rows_bytes, split_smem, fpitch_of / ftile_of), read
    from its text."""
    import os

    from icek_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    for text in ("__host__ __device__ constexpr int mma_tiles_bytes() { return 2 * 2 * TILE * pitch_of<HDP>() * 2; }",
                 "return mma_tiles_bytes<HDP>() + 2 * 2 * TILE * 4;",
                 'static_assert(HDP <= 64, "K and V fragments in registers");',
                 "template <int HDP> __host__ __device__ constexpr int pitch_of() { return HDP + 8; }",
                 "template <int HDP> __host__ __device__ constexpr int fpitch_of() { return HDP + 4; }",
                 "constexpr int ftile_of() { return HDP > (BWD ? 64 : 32) ? 32 : 64; }",
                 "constexpr bool split_smem() { return HDP > (BWD ? 64 : 32); }",
                 "constexpr int split_rows_bytes() { return SMEM ? (HDP / 8) * P * 32 * 16 : 0; }",
                 "return 2 * 2 * TK * fpitch_of<HDP>() * 4 + (ROWS ? 2 * 2 * TK * 4 : 0) +\n"
                 "         NW * NOPS * split_rows_bytes<P, HDP, split_smem<HDP, BWD>()>();"):
        assert text in src, text


@pytest.mark.parametrize("hdp", [32, 64, 128])
def test_every_launch_fits_a_block_s_shared_memory(hdp):
    """Every instantiation's dynamic shared memory fits what an H100 block
    may have (the launch would be refused otherwise): the bf16 mma.sync
    kernels at most 68 KB (the forward at HDP 128; the mma.sync backward
    pair runs at HDP 32, and at 64 in a `_variants` cut), the TF32 kernels
    at most 195 KB (dQ and
    dK/dV in f32 at HDP 128, four warps each with two split operands)."""
    for dkv in (False, True) if hdp <= 64 else (False,):
        assert _mma_bytes(hdp, dkv) <= SMEM_LIMIT
    warps = (2, 4) if hdp == 32 else (4,)
    for pieces in (1, 2):
        for nw in warps:
            for ops, rows, bwd in ((1, False, False), (2, False, True), (2, True, True)):
                assert _tf32_bytes(pieces, hdp, nw, ops, rows, bwd) <= SMEM_LIMIT
    assert max(_mma_bytes(64, True), _mma_bytes(128, False)) == 69632
    assert _tf32_bytes(2, 128, 4, 2, True, True) == 199168


# --------------------------------------------------------------------------
# the strip max pool
# --------------------------------------------------------------------------

def _pool_constants():
    """POOL_SMEM and POOL_MAX_C as ``csrc/int8_conv.cu`` states them."""
    import os
    import re

    from icek_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "int8_conv.cu")) as f:
        src = f.read()
    smem = eval(re.search(r"constexpr int POOL_SMEM = ([0-9 *]+);", src).group(1))
    max_c = re.search(r"constexpr int POOL_MAX_C = \(POOL_SMEM / 3 / 3\) / 4 \* 4;", src)
    assert max_c, "POOL_MAX_C's formula changed: change the emulation with it"
    return smem, smem // 3 // 3 // 4 * 4


POOL_SMEM, POOL_MAX_C = _pool_constants()


def strip_plan(W, C):
    """(R, WC, chunks) of ``int8_maxpool``: WC output columns a block (the
    whole row where three staged rows fit POOL_SMEM), R output rows."""
    Wo = (W - 1) // 2 + 1
    WC = Wo if 3 * (2 * Wo + 1) * C <= POOL_SMEM else (POOL_SMEM // (3 * C) - 1) // 2
    R = 8
    while R > 1 and (2 * R + 1) * (2 * WC + 1) * C > POOL_SMEM:
        R -= 1
    return R, WC, -(-Wo // WC)


def strip_max_pool(x):
    """The strip kernel's walk over (B, H, W, C) int8, block by block: a
    block of R output rows and WC output columns stages, for each input row
    2 oh0 - 1 .. 2 (oh0 + nr) - 1 inside the image, the columns [cw0, cw1]
    its outputs see into a segment of pitch (2 WC + 1) C bytes at (cw0 -
    iw0) C (iw0 = 2 ow0 - 1); each output piece starts at -128 and takes the
    max over the staged bytes at (2 owl + dw) C of rows 2 r + dh, padding
    rows and columns skipped.  Unwritten segment bytes hold 99 (never read)."""
    B, H, W, C = x.shape
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    R, WC, chunks = strip_plan(W, C)
    R = min(R, Ho)
    segb = (2 * WC + 1) * C
    assert (2 * R + 1) * segb <= POOL_SMEM
    flat = x.reshape(B, H, W * C)
    out = torch.empty((B, Ho, Wo, C), dtype=torch.int8)
    for oh0 in range(0, Ho, R):
        for ch in range(chunks):
            ow0 = ch * WC
            nr, nc = min(R, Ho - oh0), min(WC, Wo - ow0)
            ih0, iw0 = 2 * oh0 - 1, 2 * ow0 - 1
            cw0, cw1 = max(iw0, 0), min(2 * (ow0 + nc) - 1, W - 1)
            off = (cw0 - iw0) * C
            seg = torch.full((B, 2 * nr + 1, segb), 99, dtype=torch.int8)
            for r in range(2 * nr + 1):
                if 0 <= ih0 + r < H:
                    seg[:, r, off:off + (cw1 - cw0 + 1) * C] = \
                        flat[:, ih0 + r, cw0 * C:(cw1 + 1) * C]
            owl = torch.arange(nc)
            for r in range(nr):
                m = torch.full((B, nc, C), -128, dtype=torch.int8)
                for dh in range(3):
                    if not 0 <= ih0 + 2 * r + dh < H:
                        continue
                    for dw in range(3):
                        iw = 2 * (ow0 + owl) - 1 + dw
                        ok = (iw >= 0) & (iw < W)
                        at = ((2 * owl + dw) * C)[ok]
                        idx = at[:, None] + torch.arange(C)[None, :]
                        win = torch.full((B, nc, C), -128, dtype=torch.int8)
                        win[:, ok] = seg[:, 2 * r + dh][:, idx]
                        m = torch.maximum(m, win)
                out[:, oh0 + r, ow0:ow0 + nc] = m
    return out


# (shape, the walk's (R, WC, chunks))
POOL_CASES = [((2, 128, 128, 64), (5, 64, 1)), ((2, 17, 13, 64), (8, 7, 1)),
              ((3, 9, 31, 16), (8, 16, 1)), ((2, 7, 5, 12), (8, 3, 1)),
              ((1, 1, 1, 64), (8, 1, 1)), ((1, 40, 600, 64), (1, 255, 2)),
              ((1, 40, 400, 64), (1, 200, 1)), ((1, 5, 1600, 64), (1, 255, 4)),
              ((1, 6, 9000, 12), (1, 1364, 4)),
              ((1, 5, 7, 10920), (1, 1, 4))]


@pytest.mark.parametrize("shape,plan", POOL_CASES)
def test_strip_pool_matches_reduce_window(shape, plan):
    """The strip walk against JAX's reduce_window (3x3, stride 2, padding
    1, -128 as the init), bit for bit, at the encode's 128x128x64 (strips of
    5 whole rows), odd heights and widths, 12 and 16 channels (4- and
    16-byte pieces), rows too wide for more than a one-row strip, rows too
    wide for three in shared memory (segments of columns, the last one
    short) and the most channels the kernel takes."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-128, 128, shape).astype(np.int8)
    want = jax.lax.reduce_window(jnp.asarray(x), jnp.int8(-128), jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1),
                                 ((0, 0), (1, 1), (1, 1), (0, 0)))
    got = strip_max_pool(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(k8.reference_max_pool(torch.as_tensor(x)).numpy(),
                                  np.asarray(want))
    assert strip_plan(shape[2], shape[3]) == plan


def test_pool_channel_limit():
    """The wrapper's channel limit is the kernel's: three input pixels of
    POOL_MAX_C channels fill POOL_SMEM, one more word does not."""
    assert k8.POOL_MAX_C == POOL_MAX_C
    assert 9 * POOL_MAX_C <= POOL_SMEM < 9 * (POOL_MAX_C + 4)
    assert strip_plan(3, POOL_MAX_C)[1] == 1
