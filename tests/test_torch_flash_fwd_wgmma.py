"""The bf16 flash forward on wgmma at padded head dims 64 and 128
(``icek_torch/csrc/flash_attention.cu``, ``flash_fwd_wgmma_kernel``),
emulated in torch on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py).  What it does
block by block is written out here:

* a warpgroup of four warps owns 64 query rows (warp w rows 16 w ..) and
  walks 64-key tiles up to the block's causal end, every row of the block
  through every tile (no warp skips one), the straddling tile masked by
  element;
* S = Q K^T over the padded head dim, the online softmax in the log2
  domain (one scale a score), P rounded to the working dtype and O += P V
  one 16-key k-step at a time, k-steps whose keys all lie past the block's
  end skipped; the saved logsumexp is (m + log2 l) ln 2;
* the staged tiles are 64 rows of 128 bytes in the 128-byte swizzle, one
  tile a 64-dim half of the head at HDP 128: K read K-major (16 dims a
  k-step, the second half from k-step 4 on), V MN-major through the
  transpose bit (16 keys a k-step, each half one m64n64 product);
* the keep flags go to the cells of 16 rows x 64 keys the mma.sync forward
  wrote, lane by lane and bit by bit, so the backward (the wgmma pair at
  HDP 64, mma.sync at 128) reads the same words.

Held against ``reference_mha`` and the JAX package's Pallas forward
(``_flash_fwd`` in interpret mode) at head dims 40, 64, 100 and 128,
causal and not, kv_len < T, rate 0 and an explicit mask at rate 0.2.
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
from test_torch_flash_bwd_hd64 import (_desc_fields, _read_b, _stage, _sw128_desc_of)
from test_torch_flash_tiles import _keep, _rounded

TILE, WARP, KSTEP = 64, 16, 16
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


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


def wgmma_forward(q, k, v, *, kv_len, causal, rate=0.0, keep=None):
    """(out (B, Tq, H, Hd) in q's dtype, lse (B, H, Tq) f32) of
    flash_fwd_wgmma_kernel's walk: blocks of one warpgroup of 64 query rows,
    key tiles up to the block's causal end."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    qf, kf, vf = map(_hf, (q, k, v))
    c = LOG2E / math.sqrt(Hd)
    out = torch.zeros((B, H, Tq, Hd))
    lse = torch.zeros((B, H, Tq))
    for blk0 in range(0, Tq, TILE):
        blk_end = min(kv_len, blk0 + TILE) if causal else kv_len
        rows = torch.arange(blk0, min(blk0 + TILE, Tq))
        m = torch.full((B, H, len(rows)), -math.inf)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), Hd))
        for k0 in range(0, blk_end, TILE):
            keys = torch.arange(k0, min(k0 + TILE, Tk))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            hidden = keys[None, :] >= _row_end(rows, kv_len, causal)[:, None]
            s = s.masked_fill(hidden, -math.inf)
            m_new = torch.maximum(m, s.amax(-1) * c)
            assert torch.isfinite(m_new).all()      # key 0 is visible to every row
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * c - m_new[..., None])
            l = l * alpha + p.sum(-1)               # the sum takes every key
            if keep is not None:
                p = torch.where(keep[:, :, rows][..., keys], p, 0.0)
            p = _rounded(p, q.dtype)
            acc = acc * alpha[..., None]
            nk = min(4, (blk_end - k0 + 15) // 16)  # k-steps past the end skipped
            for kk in range(nk):
                sl = slice(KSTEP * kk, KSTEP * kk + KSTEP)
                acc = acc + p[..., sl] @ vf[:, :, keys[sl]]
            m = m_new
        out[:, :, rows] = acc * (1.0 / (1.0 - rate) / l)[..., None]
        lse[:, :, rows] = (m + torch.log2(l)) * LN2
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _inputs(seed, tq, tk, hd, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, hd)).astype(np.float32) for t in (tq, tk, tk)]


# the 512x8 encoder's length, ragged edges around the 16- and 64-row tiles,
# a site of 33 query rows, and the 512x8 decoder's causal self site (32 rows:
# half of one 64-row block)
SHAPES = [(130, 130, 130, False), (70, 70, 50, True), (33, 100, 100, False),
          (65, 129, 100, True), (64, 64, 64, True), (32, 32, 32, True)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd", [40, 64, 100, 128])
@pytest.mark.parametrize("tq,tk,kv_len,causal", SHAPES)
def test_wgmma_forward_matches_plain(tq, tk, kv_len, causal, hd, rate):
    """The walk in f32: out within 1e-5 of the plain version's under the
    same explicit mask, and the saved logsumexp that of the visible scaled
    scores."""
    q, k, v = map(torch.as_tensor, _inputs(tq + tk + hd, tq, tk, hd))
    keep = _keep(tq * hd, rate, 2, 2, tq, tk)
    got, lse = wgmma_forward(q, k, v, kv_len=kv_len, causal=causal, rate=rate, keep=keep)
    want = tfa.reference_mha(q, k, v, kv_len=kv_len, causal=causal, dropout_rate=rate,
                             keep=keep)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    j = torch.arange(tk)
    hidden = (j[None, :] >= kv_len) | ((j[None, :] > torch.arange(tq)[:, None]) & causal)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s.masked_fill(hidden, -math.inf),
                                                            -1).numpy(), atol=1e-5)


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_forward_bf16_within_card_tolerance(hd):
    """bf16 inputs, P rounded to bf16 before P V: within the card's 3e-2 of
    the largest expected value of the plain bf16 version, at rate 0.2."""
    tq, tk, kv_len, causal = 130, 130, 120, True
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(hd, tq, tk, hd))
    keep = _keep(hd, 0.2, 2, 2, tq, tk)
    got, _ = wgmma_forward(q, k, v, kv_len=kv_len, causal=causal, rate=0.2, keep=keep)
    want = tfa.reference_mha(q, k, v, kv_len=kv_len, causal=causal, dropout_rate=0.2, keep=keep)
    assert got.dtype == torch.bfloat16
    tol = 3e-2 * max(1.0, float(want.float().abs().max()))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol)


@pytest.mark.parametrize("hd", [40, 64, 100, 128])
@pytest.mark.parametrize("tq,tk,causal", [(70, 70, True), (40, 100, False)])
def test_wgmma_forward_matches_pallas(tq, tk, causal, hd):
    """Against the JAX package's Pallas forward (``_flash_fwd`` in interpret
    mode, its head slot padding Hd), rate 0, atol 2e-5."""
    q, k, v = _inputs(5 * tq + hd, tq, tk, hd)
    want = jfa.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got, _ = wgmma_forward(*map(torch.as_tensor, (q, k, v)), kv_len=tk, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# --------------------------------------------------------------------------
# the swizzled tiles at HDP 64 and 128, read through the source's descriptor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("hdp", [64, 128])
def test_tiles_read_as_k_and_v(src, hdp, vec):
    """A 64-key tile of K (or V) at head dim HDP is staged as HDP / 64
    swizzled tiles of 128-byte rows, half x holding dims 64 x .. 64 x + 63.
    Through the source's descriptor, S's k-step ks reads half ks / 4 at 32
    bytes a step (K-major: keys x 16 dims), and P V's k-step kk reads each
    half at 2048 bytes a step (MN-major: 16 keys x 64 dims)."""
    full = np.arange(TILE * hdp, dtype=np.int64).reshape(TILE, hdp)
    halves = [_stage(full[:, 64 * x:64 * x + 64], vec) for x in range(hdp // 64)]
    desc_of = _sw128_desc_of(src)
    for ks in range(hdp // 16):                      # S = Q K^T
        f = _desc_fields(desc_of(32 * (ks & 3)))
        got = _read_b(halves[ks >> 2], f["start"], f["sbo"], True)
        np.testing.assert_array_equal(got.T, full[:, 16 * ks:16 * ks + 16])
    for kk in range(4):                              # O += P V, every half
        f = _desc_fields(desc_of(2048 * kk))
        got = np.concatenate([_read_b(hf, f["start"], f["sbo"], False) for hf in halves], axis=1)
        np.testing.assert_array_equal(got, full[16 * kk:16 * kk + 16])
    body = _kernel(src)
    assert "sw128_desc(ktile(buf, ks >> 2) + 32 * (ks & 3))" in body
    assert "sw128_desc(vtile(buf, x) + 2048 * kk)" in body
    assert "kp + 64 * x, a.k_st, it * TILE, blk_end, hw - 32 * x," in body
    assert "vp + 64 * x, a.v_st, it * TILE, blk_end, hw - 32 * x," in body


def _kernel(src):
    start = src.index("flash_fwd_wgmma_kernel(")
    return src[start:src.index("\n}\n", start)]


# --------------------------------------------------------------------------
# the keep flags: the mma.sync forward's words
# --------------------------------------------------------------------------

def _owner(row0s, Tk):
    """(query, key) -> (cell, lane, bit) for warps whose first rows are
    `row0s`, as both forwards store them: cell (row0 / 16, key tile), lane
    4 g + t, bit 4 j + i of register i of 8-key tile j."""
    out = {}
    for row0 in row0s:
        for tile in range(-(-Tk // 64)):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for j in range(8):
                    for i in range(4):
                        query = row0 + g + 8 * (i >> 1)
                        key = 64 * tile + 8 * j + 2 * t + (i & 1)
                        out[query, key] = ((row0 >> 4, tile), lane, 4 * j + i)
    return out


def test_keep_words_are_the_mma_sync_forwards(src):
    """Both forwards' warp w of block x owns rows x * 64 + 16 w (the mma.sync
    forward's four warps a block above 32 rows, the wgmma forward's
    warpgroup) and stores lane l's flags of tile `it` at keep_cell(row0 /
    16, it) + l from the same keep4_rows blocks, so every (query, key) lands
    on the same word and bit, inside the cells the buffer holds (4 ceil(Tq /
    64) a head)."""
    Tq, Tk = 301, 130
    rows = [x * 64 + 16 * w for x in range(-(-Tq // 64)) for w in range(4)]
    owner = _owner(rows, Tk)
    assert max(rows) >> 4 < 4 * -(-Tq // 64)
    assert {(qr, kc) for qr in range(Tq) for kc in range(Tk)} <= set(owner)
    body = _kernel(src)
    fwd = src[src.index("flash_fwd_mma_kernel("):src.index("flash_bwd_dq_mma_kernel(")]
    for text in ("keep_words[keep_cell(a, b, h, row0 >> 4, it) + lane] = word;",
                 "keep = keep4_rows(a, mblk + ((k0 + 8 * j) >> 2), t);",
                 "word |= keep << (4 * j);",
                 "DROP ? mask_row_block(a, b, h, row0 + g + ((t & 1) ? 8 : 0)) + (t >> 1) : 0ull;"):
        assert text in body and text in fwd, text
    assert "const int row0 = blockIdx.x * TILE + warp * 16;" in body
    assert "const int row0 = blockIdx.x * BQ + warp * 16;" in fwd
    assert "constexpr int BQ = NW * 16," in fwd


def test_routes_in_the_source_and_the_wrapper(src):
    """Each bf16 forward design has an entry of its own: flash_fwd_bf16_mma
    runs the mma.sync forward at every head dim (HDP 32 unchanged),
    flash_fwd_bf16_wgmma the wgmma forward at HDP 64 and 128 and nothing
    else; the wrapper alone picks between them, by head dim at any number
    of query rows (the 512x8 decoder's 32-row sites included)."""
    mma = src[src.index("ICEK_EXPORT int flash_fwd_bf16_mma("):
              src.index("ICEK_EXPORT int flash_fwd_bf16_wgmma(")]
    wg = src[src.index("ICEK_EXPORT int flash_fwd_bf16_wgmma("):src.index("int backward_mma(")]
    assert "? launch_fwd_mma<32, 4>" in mma and ": launch_fwd_mma<32, 2>" in mma
    assert "launch_fwd_mma<64, 4>" in mma and "launch_fwd_mma<128, 4>" in mma
    assert "wgmma" not in mma
    assert "case 64: return launch_fwd_wgmma<64>" in wg
    assert "case 128: return launch_fwd_wgmma<128>" in wg
    assert "default: return static_cast<int>(cudaErrorInvalidValue);" in wg
    assert "launch_fwd_mma" not in wg
    assert "Tq" not in mma.replace("a.Tq > 32 ?", "") and "Tq" not in wg
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)
    assert tfa.uses_wgmma_forward(bf(2, 301, 8, 64), bf(2, 301, 8, 64), bf(2, 301, 8, 64))
    assert tfa.uses_wgmma_forward(bf(2, 33, 4, 128), bf(2, 9, 4, 128), bf(2, 9, 4, 128))
    assert tfa.uses_wgmma_forward(bf(2, 40, 4, 40), bf(2, 40, 4, 40), bf(2, 40, 4, 40))
    assert tfa.uses_wgmma_forward(bf(2, 32, 8, 64), bf(2, 497, 8, 64), bf(2, 497, 8, 64))
    assert tfa.uses_wgmma_forward(bf(2, 32, 4, 128), bf(2, 32, 4, 128), bf(2, 32, 4, 128))
    assert not tfa.uses_wgmma_forward(bf(2, 301, 10, 30), bf(2, 301, 10, 30), bf(2, 301, 10, 30))
    f32 = lambda *s: torch.zeros(s)
    assert not tfa.uses_wgmma_forward(f32(2, 301, 8, 64), f32(2, 301, 8, 64), f32(2, 301, 8, 64))


def test_wgmma_forward_shared_memory(src):
    """Two buffers of K and V, a swizzled tile per 64-dim half, and 1024
    bytes of alignment: 33 KB at HDP 64 (six blocks an SM), 65 KB at 128
    (above the default 48 KB: the launch opts in)."""
    body = src[src.index("constexpr int wg_fwd_bytes()"):]
    assert "return 4 * (HDP / 64) * SW_TILE + 1024;" in body[:200]
    sizes = {hdp: 4 * (hdp // 64) * 64 * 128 + 1024 for hdp in (64, 128)}
    assert sizes == {64: 33792, 128: 66560}
    assert 233472 // sizes[64] >= 6 and sizes[128] <= 232448
    assert "if (const int err = allow_smem(kernel, smem)) return err;" in \
        src[src.index("int launch_fwd_wgmma("):src.index("int launch_dq_wgmma(")]


@pytest.mark.parametrize("tq,tk,kv_len,causal", [(301, 301, 301, False), (130, 130, 100, True),
                                                 (33, 200, 150, True), (70, 40, 40, False)])
def test_keep_cells_written_are_the_walks_tiles(tq, tk, kv_len, causal):
    """``keep_cells_written`` marks exactly the (16-row, 64-key) cells whose
    tiles the forward's walk visits: every row16 of a 64-row block, each key
    tile below the block's causal end and kv_len.  The card tests compare
    two designs' keep words on these cells only (the rest of the buffer is
    never written)."""
    got = tfa.keep_cells_written(tq, tk, kv_len, causal)
    assert got.shape == (4 * -(-tq // 64), -(-tk // 64))
    for rows16 in range(got.shape[0]):
        blk0 = (rows16 // 4) * TILE
        blk_end = min(kv_len, blk0 + TILE) if causal else kv_len
        visited = set(range(0, -(-blk_end // TILE)))
        assert {t for t in range(got.shape[1]) if got[rows16, t]} == visited
