"""The decoder step's f32 tensor-core route at heads of 33 to 64 dims
(``icek_torch/csrc/decoder_step.cu``, ``decoder_step_mma_kernel<float, 64>``),
emulated in torch on the CPU with the tile emulation of
tests/test_torch_decoder_tiles.py, whose ``emulate`` takes the pad and the
stage depth from the head dim and the dtype.

What changes from the f32 route at pad 32 (the ``--geometry 512x8`` model's
8 heads of 64 in f32):

* the cross heads are padded to 64 dims, so S = Q K^T takes eight k8 steps
  of three TF32 products in one tensor-core sum, and O is 16 x 64 a warp;
* a cross ring stage holds 8 memory rows (one k8 step of P V), three
  stages deep: the bf16 layout's 3D-wide projection buffer beside 16-row f32
  stages would need 364,416 bytes at D 512, so the f32 block keeps q alone
  there and reads the step's own K/V rows back from k_new / v_new
  (``kv_out``), 200,064 bytes;
* the self-attention keeps two threads a (row, head), 32 dims each, and
  fetches a row's K and V after the previous row's math.

Tolerances: as the f32 route at pad 32 (tests/test_torch_decoder_tf32.py),
h and the K/V rows at atol 1e-4 against the plain f32 version, the JAX
Pallas kernel (interpret mode) and the JAX stock step.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import _build, decoder_step as tds
from icek_tpu.decode import beam as jbeam
from icek_tpu.kernels import decoder_step as jds
from test_torch_decoder_tiles import _emulated, _hold, _inputs, _plain, ring_schedule

XT = tds.cross_tile(torch.float32, 64)
# (D, H): heads of 64 dims (pad 64, all of it live) and of 40 (24 dims of zeros)
WIDTHS = {"hd64": (128, 2), "hd40": (80, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small torch ops: one thread each (see the tiles file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_f32_pad64_takes_8_row_stages():
    """The emulation's stage depth and pad are the wrapper's: 8 f32 rows a
    stage at pad 64 (16 at pad 32), and only f32 at pad 64 reads its K/V
    rows back from k_new / v_new."""
    assert XT == 8 and tds.cross_tile(torch.float32, 40) == 8
    assert tds.cross_tile(torch.float32, 32) == 16 and tds.cross_tile(torch.bfloat16, 64) == 16
    assert tds.head_pad(40) == tds.head_pad(64) == 64
    assert tds.kv_out(torch.float32, 64) and tds.kv_out(torch.float32, 33)
    assert not tds.kv_out(torch.float32, 32) and not tds.kv_out(torch.bfloat16, 64)


@pytest.mark.parametrize("step", [0, 4])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_tf32_hd64_step_matches_plain(width, step):
    """2 layers, F 96, M 45 (five full 8-row stages and a ragged one of 5),
    B 3 in groups of 2 (the last ragged), K 3, L 6: three TF32 products a
    product against the plain f32 version at 1e-4."""
    D, H = WIDTHS[width]
    layers, x, ck, cv, xk, xv, anc = _inputs(40 + step + D, B=3, K=3, L=6, M=45, D=D, H=H,
                                             F=96, i=step)
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, "tf32")
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, step, H), 1e-4)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_tf32_hd64_step_matches_jax(width):
    """The emulation against the JAX package's Pallas kernel in interpret
    mode and its stock beam step, at step 3 and M 37 (four full stages and
    a ragged one of 5)."""
    D, H = WIDTHS[width]
    B, K, L, M, F, step = 3, 3, 6, 37, 64, 3
    layers, x, ck, cv, xk, xv, anc = _inputs(51 + D, B, K, L, M, D, H, F, step)
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


@pytest.mark.parametrize("M", [1, 7, 8, 9])
def test_tf32_hd64_memory_edges(M):
    """Memories of one row, a stage less a row, one whole stage and a stage
    and a row (D 128, 2 heads of 64, step 2): the masked keys of a ragged
    stage take no weight."""
    D, H = WIDTHS["hd64"]
    layers, x, ck, cv, xk, xv, anc = _inputs(60 + M, B=2, K=3, L=4, M=M, D=D, H=H, F=64, i=2)
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, 2, H, 2, "tf32")
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, 2, H), 1e-4)


@pytest.mark.parametrize("K,S", [(17, 2), (20, 3)])
def test_tf32_hd64_wide_beam_blocks(K, S):
    """Beams of 17 and 20 at heads of 40 in 2 and 3 blocks an image (rows 9 +
    8, 7 + 7 + 6), each streaming its image's memory 8 rows a stage and
    writing only its own rows, against the plain f32 version at 1e-4."""
    D, H = WIDTHS["hd40"]
    layers, x, ck, cv, xk, xv, anc = _inputs(70 + K, B=2, K=K, L=4, M=21, D=D, H=H, F=64, i=2)
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, 2, H, 1, "tf32", S=S)
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, 2, H), 1e-4)


def test_f32_ring_at_pad64_runs_on_across_layers():
    """8 memory rows a stage: M 497 takes 63 stages an image, the last of one
    row; every (layer, image, tile) once, layer by layer, the lookahead of
    two stages taking layer l + 1's first two tiles under layer l's last
    two (they load during layer l's FFN and layer l + 1's projections)."""
    nL, nimg, M = 3, 2, 497
    sched = ring_schedule(nL, nimg, M, XT)
    nT = -(-M // XT)
    assert nT == 63 and M - (nT - 1) * XT == 1
    assert len(sched) == nL * nimg * nT == len(set(sched))
    assert [s[0] for s in sched] == sorted(s[0] for s in sched)
    last = nimg * nT - 1
    loaded = [s + tds.CROSS_STAGES - 1 for s in (last - 1, last)]
    assert [sched[s] for s in loaded] == [(1, 0, 0), (1, 0, XT)]


def test_f32_pad64_shared_memory():
    """The f32 block at 512x8 (D 512, H 8, F 512) fits at L 30 and 40 with
    three 8-row stages; with 16-row stages it would not, nor at 10 heads of
    64; row pitches of 516 floats put a fragment's eight rows g at word t on
    32 distinct banks."""
    for L in (30, 40):
        assert tds.mma_smem_bytes(512, 8, 512, L, torch.float32) <= tds.MAX_SMEM
    ring = 4 * tds.CROSS_STAGES * 2 * XT * (8 * 64 + 4)
    assert tds.mma_smem_bytes(512, 8, 512, 30, torch.float32) + ring > tds.MAX_SMEM
    assert tds.mma_smem_bytes(640, 10, 512, 30, torch.float32) > tds.MAX_SMEM
    banks = {(g * 516 + t) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32


def test_kernel_source_agrees_at_f32_pad64():
    """The layout the wrapper mirrors is the kernel's: 8-row f32 stages at pad
    64, three of them, q alone in the projection buffer there, Q's fragments
    read from shared memory and split each tile (the emulation's S takes the
    same split values), and the self-attention fetching a row after the last
    where a thread's K and V take 128 bytes."""
    with open(os.path.join(_build.CSRC, "decoder_step.cu")) as f:
        src = f.read()
    assert "return HP == 32 ? Tc<T>::XT : sizeof(T) == 2 ? 16 : 8;" in src
    assert "constexpr int XSTAGES = 3;" in src and tds.CROSS_STAGES == 3
    assert "  return sizeof(T) == 4 && HP == 64;\n" in src
    assert "s.pb = max(max(round_up(kv_out<T, HP>() ? D : 3 * D, 8), s.pq), s.pf);" in src
    assert "constexpr bool AHEAD = SW * sizeof(Word) <= 64;" in src
    assert "cross_tile_f32<HP, XT>(qsrc, kt, vt, PQ, acc, mrow, lrow, m0, M, c);" in src
    assert "      ldsm_x4(q4, qt + 8 * ds);\n" in src          # Q read and split each tile
