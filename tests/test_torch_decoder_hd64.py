"""The tensor-core decoder step at heads of 33 to 64 dims
(``icek_torch/csrc/decoder_step.cu``, ``decoder_step_mma_kernel<bf16, 64>``),
emulated in torch on the CPU with the tile emulation of
tests/test_torch_decoder_tiles.py, whose ``emulate`` follows the head dim.

What changes at pad 64 (the ``--geometry 512x8`` model's 8 heads of 64):

* the cross K/V are laid out head-major with each head padded to 64 dims
  (``pad_cross_heads``), so S = Q K^T takes four k16 steps and O is 16 x 64
  a warp;
* a cross ring stage holds 16 memory rows (three stages fit the card's
  shared memory beside the activations of D 512; 32-row stages would not);
* the self-attention keeps two threads a (row, head), 32 dims each.

The 300x10 layout (pad 32, 32-row stages) does not change.

Tolerances: with rounding off the emulation is held to the plain f32
version, to the JAX Pallas kernel (interpret mode) and to the JAX stock
step at atol 1e-4, as at pad 32; with rounding on to the plain bf16 version
at the card's 0.15.
"""

import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from icek_torch import bridge
from icek_torch.kernels import _build, decoder_step as tds
from icek_tpu.decode import beam as jbeam
from icek_tpu.kernels import decoder_step as jds
from test_torch_decoder_tiles import (_emulated, _hold, _inputs, _plain, _through_bf16,
                                      ring_schedule)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small torch ops: one thread each (see the tiles file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (D, H): heads of 64 dims (pad 64, all of it live) and of 40 (pad 64, 24 dims of zeros)
WIDTHS = {"hd64": (128, 2), "hd40": (80, 2)}


@pytest.mark.parametrize("step", [0, 4])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_hd64_step_matches_plain_f32(width, step):
    """Rounding off, 2 layers, F 96, M 45 (two full 16-row stages and a
    ragged one), B 3 in groups of 2 (the last ragged), K 3, L 6."""
    D, H = WIDTHS[width]
    args = _inputs(20 + step + D, B=3, K=3, L=6, M=45, D=D, H=H, F=96, i=step)
    layers, x, ck, cv, xk, xv, anc = args
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, False)
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, step, H), 1e-4)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_hd64_step_matches_jax(width):
    """The emulation (rounding off) against the JAX package's Pallas kernel
    in interpret mode and its stock beam step, at step 3."""
    D, H = WIDTHS[width]
    B, K, L, M, F, step = 3, 3, 6, 37, 64, 3
    layers, x, ck, cv, xk, xv, anc = _inputs(31 + D, B, K, L, M, D, H, F, step)
    nL = ck.shape[0]
    _, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, False)
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


def test_hd64_step_bf16_rounding():
    """Rounding on (bf16 weights and inputs, bf16 at the product inputs, P
    rounded for P V) at D 128, H 2 of 64, 3 layers, F 128, M 70, B 3, K 5,
    step 6 of 10, G 2: the plain bf16 version at the card's 0.15."""
    B, K, L, M, D, H, F, step = 3, 5, 10, 70, 128, 2, 128, 6
    args = _through_bf16(_inputs(9, B, K, L, M, D, H, F, step, nL=3))
    layers, x, ck, cv, xk, xv, anc = args
    _, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, True)
    b16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    st16 = tds.stack_decoder_params(
        {"layers": [jax.tree.map(b16, lay) for lay in layers["layers"]]}, torch.bfloat16)
    want = tds.reference_decoder_step(st16, b16(x), torch.as_tensor(anc), b16(ck), b16(cv),
                                      b16(xk), b16(xv), step, num_heads=H)
    _hold(got, [w.float() for w in want], 0.15)


@pytest.mark.parametrize("Hd", [40, 64])
def test_pad_cross_heads_pad64(Hd):
    """Head h's dims at [64 h, 64 h + Hd) of a 16-byte aligned row of H * 64
    values, zeros after; given only these, the CPU wrapper undoes the pad
    and runs the plain version on the unpadded values."""
    B, M, H = 2, 7, 3
    cross = [{"k": torch.randn((B, M, H, Hd)), "v": torch.randn((B, M, H, Hd))}
             for _ in range(2)]
    k, v = tds.pad_cross_heads(cross, torch.bfloat16)
    assert tds.head_pad(Hd) == 64
    assert k.shape == v.shape == (2, B, M, H * 64) and k.dtype == torch.bfloat16
    kh = k.view(2, B, M, H, 64)
    assert torch.equal(kh[..., :Hd].float(), torch.stack([c["k"] for c in cross]).bfloat16().float())
    assert not kh[..., Hd:].any()

    layers, x, ck, cv, xk, xv, anc = _inputs(3, 2, 3, 6, 11, H * Hd, H, 24, 2)
    nL = ck.shape[0]
    stacked = tds.stack_decoder_params(bridge.to_torch(layers))
    t = torch.as_tensor
    heads = tds.pad_cross_heads([{"k": t(xk[l]).view(2, 11, H, Hd), "v": t(xv[l]).view(2, 11, H, Hd)}
                                 for l in range(nL)], torch.float32)
    got = tds.fused_beam_decoder_step(stacked, t(x), t(anc), t(ck), t(cv), None, None, 2,
                                      num_heads=H, cross_heads=heads)
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, 2, H), 0)


def _case(K=5, D=512, H=8, F=512, L=30, dtype=torch.bfloat16):
    layer = {"self_attn": {"qkv_w": torch.zeros((D, 3 * D)), "qkv_b": torch.zeros(3 * D),
                           "out": {"w": torch.zeros((D, D)), "b": torch.zeros(D)}},
             "ffn": {"lin1": {"w": torch.zeros((D, F)), "b": torch.zeros(F)},
                     "lin2": {"w": torch.zeros((F, D)), "b": torch.zeros(D)}}}
    layer["cross_attn"] = layer["self_attn"]
    for n in (1, 2, 3):
        layer[f"norm{n}"] = {"scale": torch.ones(D), "bias": torch.zeros(D)}
    st = tds.stack_decoder_params({"layers": [layer]}, dtype)
    return tds.uses_tensor_cores(st, torch.zeros((1, 2, L * K, D), dtype=dtype), K, H)


def test_shared_memory_and_route_at_512x8():
    """bf16 at 512x8 (D 512, 8 heads of 64, F 512, L 30) takes the tensor-core
    route in 216,960 bytes (117,120 of activations, a ring of three 16-row
    stages); f32 at 512x8 too, in 200,064 (q alone in the projection
    buffer, a ring of three 8-row stages), where the bf16 layout's 3D-wide
    buffer and 16-row stages would need 364,416.  The 300x10 layout (pad 32,
    32-row bf16 / 16-row f32 stages) is unchanged; heads above 64 dims, odd
    ones and more than 10 are refused."""
    assert tds.mma_smem_bytes(512, 8, 512, 30) == 216960 <= tds.MAX_SMEM
    assert tds.mma_smem_bytes(512, 8, 512, 30, torch.float32) == 200064 <= tds.MAX_SMEM
    # f32 rows of x, the attention output and q (pitch 516), the ancestry,
    # three stages of 8 K and V rows; the bf16 layout in f32: a 1536-wide
    # projection buffer and three stages of 16 rows
    assert 4 * 16 * 3 * 516 + 4 * 16 * 30 + 4 * 3 * 2 * 8 * 516 == 200064
    assert 4 * 16 * (2 * 516 + 1536) + 4 * 16 * 30 + 4 * 3 * 2 * 16 * 516 == 364416 > tds.MAX_SMEM
    assert tds.mma_smem_bytes(300, 10, 512, 30) == 196992
    assert tds.mma_smem_bytes(300, 10, 512, 30, torch.float32) == 223616
    assert (tds.head_pad(30), tds.head_pad(32), tds.head_pad(33), tds.head_pad(64)) == (32, 32, 64, 64)
    assert tds.cross_tile(torch.bfloat16, 30) == 32 and tds.cross_tile(torch.float32, 30) == 16
    assert tds.cross_tile(torch.bfloat16, 64) == 16 and tds.cross_tile(torch.float32, 64) == 8
    assert _case() and _case(K=1) and _case(K=16) and _case(K=20)
    assert _case(D=320, H=8)                                # Hd 40
    assert not _case(D=640, H=10)                           # 10 heads of 64: past the card
    assert not _case(D=640, H=10, dtype=torch.float32)
    assert _case(dtype=torch.float32) and _case(K=1, dtype=torch.float32)
    assert _case(K=20, dtype=torch.float32) and _case(D=320, H=8, dtype=torch.float32)
    assert not _case(D=528, H=8)                            # Hd 66
    assert not _case(D=520, H=8)                            # Hd 65, odd
    assert not _case(D=704, H=11)                           # 11 heads
    assert _case(D=300, H=10) and _case(D=300, H=10, dtype=torch.float32)


def test_ring_at_pad64_runs_on_across_layers():
    """16 memory rows a stage: M 497 takes 32 stages an image, every (layer,
    image, tile) once, layer by layer, the lookahead of two stages taking
    layer l + 1's first two tiles under layer l's last two."""
    nL, nimg, M, XT = 3, 2, 497, 16
    sched = ring_schedule(nL, nimg, M, XT)
    assert len(sched) == nL * nimg * 32 == len(set(sched))
    last = nimg * 32 - 1
    assert [sched[s + 2] for s in (last - 1, last)] == [(1, 0, 0), (1, 0, XT)]


def test_kernel_source_agrees():
    """The constants the wrapper mirrors are the kernel's: the pad 64 from 33
    dims, 16-row bf16 stages there (8-row f32 ones), in both dtypes."""
    with open(os.path.join(_build.CSRC, "decoder_step.cu")) as f:
        src = f.read()
    assert "constexpr int head_pad(int Hd) { return Hd <= 32 ? 32 : 64; }" in src
    assert "return HP == 32 ? Tc<T>::XT : sizeof(T) == 2 ? 16 : 8;" in src
    assert "Hd > 64 || a.F % 2 != 0" in src and "hd_max" not in src
    assert "if (head_pad(Hd) == 64) return launch_mma<T, 64>(a, stream);" in src
    assert (tds.HEAD_PAD, tds.WIDE_HEAD_PAD) == (32, 64)
    assert tds.WIDE_CROSS_TILE == {torch.bfloat16: 16, torch.float32: 8}
