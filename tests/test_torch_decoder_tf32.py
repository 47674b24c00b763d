"""The decoder step's f32 tensor-core route and its wide-beam blocks
(``icek_torch/csrc/decoder_step.cu``, ``decoder_step_mma_kernel<float>`` and
S > 1), emulated in torch on the CPU with the tile emulation of
tests/test_torch_decoder_tiles.py.

What is emulated:

* the TF32 split of ``common.cuh::split_tf32_bits``: hi = cvt.rna(x)'s
  bits (to nearest, ties away from zero) by integer arithmetic, lo = x - hi,
  whose low 13 bits the tensor cores ignore (truncated);
* ``pack_tf32``: one f32 copy of the weights in mma.sync m16n8k8's
  B-fragment order (the kernel splits each value in registers), whose
  inverse gives the weights back;
* every product as the kernel forms it (``mma3``): the three TF32 products
  hi lo + lo hi + hi hi summed by the tensor cores over a short span (a
  linear's k-pair of 16, S's padded head dim, a stage's 16 keys of P V),
  rounded to f32 and added to the long sums in f32;
* the f32 ring: 16 memory rows a stage, three stages, the schedule running
  on across the layers;
* the rows of a block for beams wider than 16: S = ``image_parts`` parts
  of an image's hypotheses, each block streaming the image's memory.

Tolerances: h and the K/V rows are held to the plain f32 version, the JAX
Pallas kernel (interpret mode) and the JAX stock step at atol 1e-4, as the
f32 tile emulation is; a single TF32 product (hi hi) misses that at the
geo widths.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch import bridge
from icek_torch.kernels import decoder_step as tds
from icek_tpu.decode import beam as jbeam
from icek_tpu.kernels import decoder_step as jds
from test_torch_decoder_tiles import (SMALL, _emulated, _hold, _inputs, _plain, block_spans,
                                      ring_schedule, split_tf32, tf32_dot, tf32_rna,
                                      unpack_tf32)

XT32 = tds.CROSS_TILE[torch.float32]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small torch ops: one thread each (see the tiles file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tf32_rna_rounds_to_nearest_ties_away():
    """10 mantissa bits kept; an exact half of the last kept bit rounds away
    from zero, in both signs; values exact in TF32 stay."""
    one = 1.0
    cases = [(one + 2 ** -11, one + 2 ** -10), (-(one + 2 ** -11), -(one + 2 ** -10)),
             (one + 2 ** -12, one), (one + 3 * 2 ** -12, one + 2 ** -10),
             (1.5, 1.5), (-0.0, -0.0), (2 ** -20 * (1 + 2 ** -11), 2 ** -20 * (1 + 2 ** -10))]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(x).view(torch.int32) & 0x1FFF).any()


def test_split_keeps_21_bits():
    """hi + lo (lo as the tensor cores read it, truncated to TF32) gives x to
    2^-21 of |x| (hi hi + hi lo + lo hi then leaves the products' error near
    2^-20), where hi alone is off by up to 2^-11; hi is exact in TF32, and
    x - hi exact in f32."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(100000), dtype=torch.float32)
    hi, lo = split_tf32(x)
    err_two = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    err_one = (hi.double() - x.double()).abs() / x.double().abs()
    assert float(err_two.max()) <= 2 ** -21
    assert 2 ** -13 < float(err_one.max()) <= 2 ** -11
    assert torch.equal(tf32_rna(hi), hi) and torch.equal(tf32_rna(lo), lo)
    assert torch.equal((x - hi).double(), x.double() - hi.double())


@pytest.mark.parametrize("din,dout", [(40, 120), (300, 900), (512, 300), (16, 8), (8, 4)])
def test_pack_tf32_fragment_order(din, dout):
    """pack_tf32 puts w[k][n] where the kernel's lanes read B[k][n] (b0 = B[t][g],
    b1 = B[t + 4][g] of each k8 step, two steps a 16-byte word): depth
    padded to 16, width to 8, zeros in the pads, and nothing rounded."""
    w = torch.randn((2, din, dout))
    packed = tds.pack_tf32(w)
    kp, nt = -(-din // 16), -(-dout // 8)
    assert packed.shape == (2, nt, kp, 32, 4) and packed.dtype == torch.float32
    full = unpack_tf32(packed, 16 * kp, 8 * nt)
    assert torch.equal(full[:, :din, :dout], w)
    assert not full[:, din:].any() and not full[:, :, dout:].any()
    # lane 4 g + t, word 2 s + h of (tile 0, k-pair 0): B[8 s + 4 h + t][g]
    g, t = 3, 2
    assert [float(packed[0, 0, 0, 4 * g + t, j]) for j in range(4)] == [
        float(w[0, 8 * s + 4 * h + t, g]) if 8 * s + 4 * h + t < din and g < dout else 0.0
        for s in (0, 1) for h in (0, 1)]


def test_stack_packs_f32_weights():
    """stack_decoder_params packs f32 weights with pack_tf32 (the route's
    copy) and keeps the stacked ones (the CUDA-core route's)."""
    from icek_torch.models import transformer as tfm

    dec = tfm.init_decoder_stack(torch.Generator().manual_seed(0), 2, 40, 64)
    st = tds.stack_decoder_params(dec, torch.float32)
    assert st.mma is not None and st.mma.qkv.shape == (2, 15, 3, 32, 4)
    assert torch.equal(unpack_tf32(st.mma.f2, 64, 40), st.f2_w)


def test_f32_ring_schedule():
    """16 memory rows a stage at M 497: 32 tiles an image, the last of one
    row; every (layer, image, tile) once, layer by layer; the lookahead of
    two stages takes layer l + 1's first tiles during layer l's last."""
    nL, nimg, M = 3, 2, 497
    sched = ring_schedule(nL, nimg, M, XT32)
    nT = -(-M // XT32)
    assert XT32 == 16 and nT == 32 and M - (nT - 1) * XT32 == 1
    assert len(sched) == nL * nimg * nT == len(set(sched))
    assert [s[0] for s in sched] == sorted(s[0] for s in sched)
    last_of_0 = nimg * nT - 1
    loaded = [s + tds.CROSS_STAGES - 1 for s in range(last_of_0 - 1, last_of_0 + 1)]
    assert [sched[s] for s in loaded] == [(1, 0, 0), (1, 0, XT32)]


def test_f32_shared_memory_layout():
    """The f32 block at the presets' widths (D 300, H 10, F 512) fits the
    card with L 30 and 40: x is its own A operand (pitch 308 floats), the
    ring 3 stages of 16 rows; 32 rows a stage would not fit."""
    for L in (30, 40):
        assert tds.mma_smem_bytes(300, 10, 512, L, torch.float32) <= tds.MAX_SMEM
    ring = 4 * tds.CROSS_STAGES * 2 * XT32 * (10 * tds.HEAD_PAD + 4)
    assert tds.mma_smem_bytes(300, 10, 512, 30, torch.float32) - ring + 2 * ring > tds.MAX_SMEM
    # row pitches of 4 (mod 32) times an odd number of words: a fragment's
    # eight rows g at word t fall on 32 distinct banks
    for pitch in (300 + 8, 512 + 4, 10 * 32 + 4):
        banks = {(g * pitch + t) % 32 for g in range(8) for t in range(4)}
        assert len(banks) == 32, pitch


@pytest.mark.parametrize("B,K,parts", [(256, 17, 2), (256, 20, 2), (256, 32, 2), (256, 33, 3),
                                       (256, 48, 3), (32, 17, 3), (32, 20, 3), (32, 32, 4),
                                       (3, 20, 3), (3, 48, 6), (132, 20, 2)])
def test_wide_row_spans(B, K, parts):
    """A beam wider than 16 runs in image_parts blocks an image of at most 16
    rows, or of down to 8 while the grid is short of a wave of 132 blocks
    (geo beam 20 at 32 images: three of 7, 7, 6; at 256: two of 10), each
    row once, every block inside one image."""
    S = tds.image_parts(B, K, 132)
    assert S == parts
    assert B * S >= 132 or S == -(-K // 8)
    spans = block_spans(B, K, 1, S)
    assert len(spans) == B * S
    covered = [r for row0, R in spans for r in range(row0, row0 + R)]
    assert covered == list(range(B * K))
    for row0, R in spans:
        assert 1 <= R <= tds.ROWS and row0 // K == (row0 + R - 1) // K


@pytest.mark.parametrize("step", [0, 1, SMALL["L"] - 1])
@pytest.mark.parametrize("B,G", [(5, 2), (4, 5), (3, 1)])
def test_tf32_step_matches_plain(step, B, G):
    """The f32 route at small widths (2 layers, D 40, H 4, F 64), M 45 (two
    full 16-row tiles and a ragged one), G-image groups as in the tiles
    file, against the plain f32 version at 1e-4."""
    args = _inputs(10 * B + step + 1, B=B, i=step, **SMALL)
    layers, x, ck, cv, xk, xv, anc = args
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, SMALL["H"], G, "tf32")
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, step, SMALL["H"]), 1e-4)


@pytest.mark.parametrize("step", [0, 3])
def test_tf32_step_matches_jax(step):
    """The f32 route's emulation against the JAX package's Pallas kernel in
    interpret mode and its stock beam step, at a small shape."""
    B, K, L, M, D, H, F = 3, 3, 6, 37, 16, 2, 24
    layers, x, ck, cv, xk, xv, anc = _inputs(17 + step, B, K, L, M, D, H, F, step)
    nL = ck.shape[0]
    _, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, "tf32")
    jlayers = jax.tree.map(jnp.asarray, layers)
    jst = jds.stack_decoder_params(jlayers, H, K, L)
    cross = [{"k": jnp.asarray(xk[l]).reshape(B, M, H, D // H),
              "v": jnp.asarray(xv[l]).reshape(B, M, H, D // H)} for l in range(nL)]
    pk, pv, mem_len = jds.pad_cross_kv(cross, jnp.float32)
    sel = jax.nn.one_hot(jnp.asarray(anc), K, dtype=jnp.float32).reshape(B, K, L * K)
    want = jds.fused_beam_decoder_step(jst, jnp.asarray(x), sel, jnp.asarray(ck),
                                       jnp.asarray(cv), pk, pv, step, num_heads=H,
                                       head_dim=D // H, mem_len=mem_len)
    _hold(got, want, 1e-4)
    caches = [{"k": jnp.asarray(ck[l]), "v": jnp.asarray(cv[l])} for l in range(nL)]
    stock_h, stock_caches = jbeam._beam_decoder_step(
        jlayers, jnp.asarray(x), caches, jnp.asarray(anc), step, cross, H,
        jbeam._head_mask(H, D // H), jbeam._group_matrix(L, K), jnp.float32)
    _hold(got[:1], [stock_h], 1e-4)
    for l in range(nL):
        _hold([got[1][l], got[2][l]],
              [np.asarray(stock_caches[l]["k"])[:, step * K:(step + 1) * K],
               np.asarray(stock_caches[l]["v"])[:, step * K:(step + 1) * K]], 1e-4)


@pytest.fixture(scope="module")
def geo_case():
    """The geo preset's widths (3 layers, D 300, H 10 of 30 dims padded to 32,
    F 512, M 497: 31 full 16-row tiles and one of 1 row, L 30) at B 3, K 5,
    step 15, and the plain f32 version's outputs."""
    B, K, L, M, D, H, F, step = 3, 5, 30, 497, 300, 10, 512, 15
    args = _inputs(5, B, K, L, M, D, H, F, step, nL=3)
    layers, x, ck, cv, xk, xv, anc = args
    stacked = tds.stack_decoder_params(bridge.to_torch(layers))
    return args, H, step, _plain(stacked, x, ck, cv, xk, xv, anc, step, H)


def test_tf32_step_geo_widths(geo_case):
    """Three TF32 products a product at the geo widths hold the plain f32
    version at 1e-4."""
    (layers, x, ck, cv, xk, xv, anc), H, step, want = geo_case
    _, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, "tf32")
    _hold(got, want, 1e-4)


def test_one_tf32_pass_misses_the_f32_tolerance(geo_case):
    """One TF32 product (hi hi, as a plain TF32 matmul takes it) is off by more
    than 1e-4 at the same shape: why the route takes three."""
    (layers, x, ck, cv, xk, xv, anc), H, step, want = geo_case
    _, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, "tf32x1")
    worst = max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in zip(got, want))
    assert worst > 1e-4


@pytest.mark.parametrize("rounding", ["tf32", False])
@pytest.mark.parametrize("K", [17, 20])
def test_wide_beam_blocks_match_plain(K, rounding):
    """Beams of 17 and 20 at small widths in 2 and 3 blocks an image (rows 9 +
    8, 7 + 7 + 6), each streaming its image's memory and writing only its
    own rows: the f32 route's arithmetic and the bf16 route's tiling
    (rounding off) against the plain f32 version at 1e-4."""
    B, L, M, D, H, F, step = 2, 4, 45, 40, 4, 64, 2
    layers, x, ck, cv, xk, xv, anc = _inputs(K, B, K, L, M, D, H, F, step)
    S = 2 if K == 17 else 3
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 1, rounding, S=S)
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, step, H), 1e-4)


def test_tf32_dot_sums_k_steps_in_order():
    """tf32_dot adds its k-pairs' products in f32 one after another: equal to
    an explicit loop, and within 1e-6 relative of the float64 product."""
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.standard_normal((16, 300)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((300, 24)), dtype=torch.float32)
    got = tf32_dot("rk,kn->rn", a, w, 1, 0)
    (ah, al), (wh, wl) = split_tf32(a), split_tf32(w)
    want = torch.zeros((16, 24))
    for k0 in range(0, 300, 16):
        s = slice(k0, k0 + 16)
        d = lambda u, v: u[:, s].double() @ v[s].double()
        want = want + (d(al, wh) + d(ah, wl) + d(ah, wh)).float()
    assert torch.equal(got, want)
    exact = a.double() @ w.double()
    assert float(((got.double() - exact).abs() / exact.abs().max()).max()) < 1e-6
    assert math.isclose(float(tf32_dot("rk,kn->rn", a, w, 1, 0, terms=1)[0, 0]),
                        float(exact[0, 0]), rel_tol=1e-2)
