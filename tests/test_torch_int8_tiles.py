"""The wgmma int8 convolution (``icek_torch/csrc/int8_conv.cu``,
``int8_conv_wgmma_kernel``), emulated in torch on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py phase 9); what it does tile by tile is written out here with
the source's own constants (read from the source) and held against
icek_tpu's ``_qconv`` / ``_site_out`` / ``_requant_relu``:

* the persistent walk: block i takes tiles i, i + grid, ... (grid = one
  block an SM), a tile's (m, n) with n fastest; the consumers' store phase
  (each warp's 16 rows as 16-byte segments, 64-column chunks of 4-byte
  outputs) writes every output element once, at every distinct site shape
  of an encode, also where M is ragged;
* the A tiles: the producer's tap walk (one row a thread, its (kh, kw, ci)
  counters, zeros in the padding), TMA's box of rows of a 1x1 / 1 site's
  (M, C) matrix, or TMA's 4D box of a tile of whole output rows or images
  (the tap's offset, traversal stride = the site's stride, zeros outside
  the tensor), written at the 128- or 64-byte swizzle's chunk positions;
  the consumers read them back as the wgmma descriptors address them; B
  likewise; the int32 sums of those tiles equal ``_qconv`` exactly;
* the stem: the tile's 7-row patch quantized from the planar float view
  through its strides, each A row's kernel rows copied as 32 bytes from
  6 x its column (the funnel shift of an odd half-word offset), against
  ``stem_weight``'s k layout;
* the epilogues: the fused site ``q(site(conv3) + site(down))`` and the
  int8 shortcut read through its swizzled tile, code for code against JAX;
* the ring: the producer's and consumers' mbarrier protocol (full / empty
  parities, the gathered stages announced one stage late) driven to its
  end over a fused site's mixed stages, each stage read only after it
  landed.
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import _build
from icek_torch.kernels import int8_conv as k8
from icek_torch.models import resnet_int8 as tq
from icek_tpu.models import resnet_int8 as jq

with open(f"{_build.CSRC}/int8_conv.cu") as _f:
    SRC = _f.read()
_HOP = SRC[SRC.index("namespace hop {"):SRC.index("}  // namespace hop")]


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _HOP).group(1))


BM, SPITCH, STEM_PITCH, STEM_COLS = (_const(n) for n in
                                     ("BM", "SPITCH", "STEM_PITCH", "STEM_COLS"))
SMEM_LIMIT, MAX_STAGES = _const("SMEM_LIMIT"), _const("MAX_STAGES")
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bk_of(*channels):
    """k bytes a stage: 128 where every GEMM's C is a multiple of 128."""
    return 64 if any(c % 128 for c in channels) else 128


def bn_of(N):
    """``hop::pick_bn``."""
    return 64 if N == 64 else 128


def swizzle_chunk(sw, r, j):
    """Where chunk j of row r of a tile of sw-byte rows lies (TMA's 128- /
    64-byte swizzle on a 1024 / 512-aligned base, ``swizzle_chunk``)."""
    return j ^ (r & 7) if sw == 128 else j ^ ((r >> 1) & 3)


def test_source_constants_and_layouts():
    """The emulation's rules are the source's: its swizzle, its pick_bn, its
    box tiles, and its shared-memory layout, whose ring fits three to six
    stages at every instantiation the entry points launch beside two sets of
    epilogue inputs (shortcut tile, es and b)."""
    assert "return SW == 128 ? (j ^ (r & 7)) : (j ^ ((r >> 1) & 3));" in _HOP
    assert "int pick_bn(int N) { return N == 64 ? 64 : 128; }" in _HOP
    assert "const int BK = C % 128 ? 64 : 128;" in SRC
    assert "if (P % BM == 0 && BM % Wo == 0) {" in _HOP and "} else if (BM % P == 0) {" in _HOP
    raw_half = _const("RAW_HALF")
    launched = {(64, 64, False), (64, 128, False), (128, 64, False), (128, 128, False),
                (64, 128, True)}
    for bn, bk, stem in launched:
        stage = BM * bk + bn * bk
        rest = 8 * 16 * SPITCH + 2 * 4 * bn * 4 + 256 + (
            7 * STEM_PITCH + 2 * 2 * raw_half * 4 if stem else 0)
        sc = 0 if stem else 2 * BM * bn
        stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - rest - sc) // stage)
        assert 3 <= stages and stages * stage + sc + rest + 1024 <= SMEM_LIMIT
        assert (2 * stages + 4) * 8 <= 256
    assert STEM_PITCH >= 6 * (BM - 1) + 36 and STEM_COLS == 2 * (BM - 1) + 7
    assert raw_half % 32 == 0 and raw_half >= 21 * _const("RAW_BOX")
    assert 2 * _const("RAW_BOX") >= STEM_COLS + 1


# ---------------------------------------------------------------------------
# the persistent tile walk and the store phase

def _walk_counts(M, N, bn, four_byte):
    """Times each output element is stored by the walk of an (M, N) site."""
    tiles_n = -(-N // bn)
    tiles = -(-M // BM) * tiles_n
    grid = min(tiles, SMS)
    count = np.zeros((M, N), np.int32)
    seen = np.zeros(tiles, np.int32)
    for block in range(grid):
        for tile in range(block, tiles, grid):
            seen[tile] += 1
            m0, n0 = (tile // tiles_n) * BM, (tile % tiles_n) * bn
            mlim = min(BM, M - m0)
            for rt in range(0, BM, 16):                 # a warp's 16 rows
                chunks = range(0, bn, 64) if four_byte else (0,)
                for c0 in chunks:
                    width, seg_w = (64, 4) if four_byte else (bn, 16)
                    segs = width // seg_w
                    i = np.arange(16 * segs)           # lanes x their iterations
                    r, seg = i // segs, i % segs
                    gc = n0 + c0 + seg * seg_w
                    ok = (rt + r < mlim) & (gc < N)
                    for rr, cc in zip(m0 + rt + r[ok], gc[ok]):
                        count[rr, cc:cc + seg_w] += 1
    assert (seen == 1).all()
    return count


def _site_mn(key, batch, img):
    """(M, N) of an encode site key at another batch and image size."""
    kind = key[0]
    scale = img / 256
    if kind == "stem":
        ho = k8.out_hw(img, 7, 2)
        return batch * ho * ho, 64
    if kind == "fused":
        _, side, _, _, cout, s = key
        side = round(side * scale)
        ho = k8.out_hw(side, 1, s)
        return batch * ho * ho, cout
    _, side, _, cout, k, s, _ = key
    ho = k8.out_hw(round(side * scale), k, s)
    return batch * ho * ho, cout


SITES = sorted(tq.encode_sites(256), key=str)


def test_encode_has_24_distinct_sites_and_100_launches():
    sites = tq.encode_sites(256)
    assert len(sites) == 24 and sum(sites.values()) == 100


@pytest.mark.parametrize("key", [k for k in SITES if k[0] != "stem"], ids=str)
def test_tile_walk_stores_every_output_once(key):
    """Batch 3 at 256x256 (the encode's sides) and at 200x200 (every M
    ragged but layer 1's); int8 codes, and the 4-byte outputs of qconv."""
    for img in (256, 200):
        M, N = _site_mn(key, 3, img)
        bn = 128 if key[0] == "fused" else bn_of(N)
        assert (_walk_counts(M, N, bn, four_byte=False) == 1).all()
        if img == 200 and key[0] == "conv":
            assert (_walk_counts(M, N, bn, four_byte=True) == 1).all()


def test_stem_tile_walk_covers_every_pixel_once():
    """The stem's tiles are (image, output row, block of 128 columns)."""
    for B, H, W in ((3, 256, 256), (2, 12, 262), (2, 9, 40)):
        Ho, Wo = k8.out_hw(H, 7, 2), k8.out_hw(W, 7, 2)
        owb_n = -(-Wo // BM)
        count = np.zeros(B * Ho * Wo, np.int32)
        for tile in range(B * Ho * owb_n):
            t2, owb = divmod(tile, owb_n)
            m0, mlim = t2 * Wo + owb * BM, min(BM, Wo - owb * BM)
            count[m0:m0 + mlim] += 1
        assert (count == 1).all()


# ---------------------------------------------------------------------------
# the A and B tiles through the swizzle, and the products

def _swizzled(rows, bk):
    """A (R, bk) byte tile as it lies in shared memory (the producer's
    cp.async targets or TMA's swizzle)."""
    R = rows.shape[0]
    smem = np.zeros(R * bk, np.int8)
    r = np.arange(R)
    for j in range(bk // 16):
        dst = r * bk + swizzle_chunk(bk, r, j) * 16
        smem[dst[:, None] + np.arange(16)] = rows[:, 16 * j:16 * j + 16]
    return smem


def _descriptor_read(smem, R, bk):
    """The (R, bk) operand as the wgmma descriptors address it: k32 steps
    at +32 bytes, the swizzle applied to each 16-byte chunk's address."""
    out = np.zeros((R, bk), np.int8)
    r = np.arange(R)
    for kk in range(bk // 32):
        for j in (2 * kk, 2 * kk + 1):
            src = r * bk + swizzle_chunk(bk, r, j) * 16
            out[:, 16 * j:16 * j + 16] = smem[src[:, None] + np.arange(16)]
    return out


def _gather_rows(x, geom, m0, kt, bk, state):
    """One k-stage of the producer's gather: row pt is output pixel m0 +
    pt; (ci, kw, kh) advance by bk as in the kernel."""
    B, H, W, C = x.shape
    Ho, Wo, KW, s, pad = geom
    ci, kw, kh = state
    m = m0 + np.arange(BM)
    mv = m < B * Ho * Wo
    mm = np.where(mv, m, 0)
    b, rem = mm // (Ho * Wo), mm % (Ho * Wo)
    oh, ow = rem // Wo, rem % Wo
    ih, iw = oh * s - pad + kh, ow * s - pad + kw
    ok = mv & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
    rows = np.zeros((BM, bk), np.int8)
    rows[ok] = x[b[ok], ih[ok], iw[ok], ci:ci + bk]
    ci += bk
    if ci == C:
        ci = 0
        kw += 1
        if kw == KW:
            kw, kh = 0, kh + 1
    return rows, (ci, kw, kh)


def _box_rows(x, geom, m0, bk, state):
    """One k-stage of a 4D box load: the tile's pixels as (images, output
    rows, columns) from its origin, each at (ci, s ow + kw - pad, s (oh0 +
    oh) + kh - pad, b0 + b), zeros outside the tensor; (ci, kw, kh) as the
    producer advances them."""
    B, H, W, C = x.shape
    Ho, Wo, KW, s, pad = geom
    bh, bb = k8.box_tile(Ho, Wo)
    ci, kw, kh = state
    b0, oh0 = m0 // (Ho * Wo), (m0 % (Ho * Wo)) // Wo
    b, oh, ow = np.meshgrid(np.arange(bb), np.arange(bh), np.arange(Wo), indexing="ij")
    b, ih, iw = (b0 + b).ravel(), (s * (oh0 + oh) + kh - pad).ravel(), (s * ow + kw - pad).ravel()
    ok = (b < B) & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
    rows = np.zeros((BM, bk), np.int8)
    rows[ok] = x[b[ok], ih[ok], iw[ok], ci:ci + bk]
    ci += bk
    if ci == C:
        ci = 0
        kw += 1
        if kw == KW:
            kw, kh = 0, kh + 1
    return rows, (ci, kw, kh)


def _tma_rows(mat, r0, c0, nrows, bk):
    """A TMA box: rows r0.., bytes c0.. of a 2D matrix, zeros past it."""
    box = np.zeros((nrows, bk), np.int8)
    part = mat[r0:r0 + nrows, c0:c0 + bk]
    box[:part.shape[0], :part.shape[1]] = part
    return box


def emulate_gemm(x, w_nk, k, stride, bk, bn, load):
    """int32 sums of a site, tile by tile: A by `load` ("gather", "tma" or
    "tma_box"), B by TMA, both through shared memory's swizzle; (B, Ho, Wo,
    N)."""
    B, H, W, C = x.shape
    N, K = w_nk.shape
    pad = (k - 1) // 2
    Ho, Wo = k8.out_hw(H, k, stride), k8.out_hw(W, k, stride)
    M = B * Ho * Wo
    out = np.zeros((M, N), np.int64)
    tiles_n = -(-N // bn)
    x2d = x.reshape(-1, C)
    for tile in range(-(-M // BM) * tiles_n):
        m0, n0 = (tile // tiles_n) * BM, (tile % tiles_n) * bn
        acc = np.zeros((BM, bn), np.int64)
        state = (0, 0, 0)
        for kt in range(K // bk):
            if load == "tma":
                rows = _tma_rows(x2d, m0, kt * bk, BM, bk)
            elif load == "tma_box":
                rows, state = _box_rows(x, (Ho, Wo, k, stride, pad), m0, bk, state)
            else:
                rows, state = _gather_rows(x, (Ho, Wo, k, stride, pad), m0, kt, bk, state)
            a = _descriptor_read(_swizzled(rows, bk), BM, bk)
            bt = _descriptor_read(_swizzled(_tma_rows(w_nk, n0, kt * bk, bn, bk), bk), bn, bk)
            acc += a.astype(np.int64) @ bt.astype(np.int64).T
        mlim, nlim = min(BM, M - m0), min(bn, N - n0)
        out[m0:m0 + mlim, n0:n0 + nlim] = acc[:mlim, :nlim]
    return out.reshape(B, Ho, Wo, N)


# (side, Cin, Cout, kernel, stride, route): the site kinds; C = 64 takes
# 64-byte stages; sides 16 and 8 make box tiles (2 or 8 output rows, or 2
# images of 8 x 8), the others gathered ones
GATHER_CASES = {"1x1_s1_tma": (9, 128, 128, 1, 1, "tma"),
                "1x1_s1_tma_bk64": (9, 64, 64, 1, 1, "tma"),
                "1x1_s2": (9, 256, 128, 1, 2, "gather"), "3x3_s1": (7, 128, 64, 3, 1, "gather"),
                "3x3_s1_bk64": (7, 64, 128, 3, 1, "gather"),
                "3x3_s2": (8, 128, 128, 3, 2, "tma_box"),
                "3x3_s2_gather": (10, 128, 128, 3, 2, "gather"),
                "1x1_s2_box": (16, 256, 128, 1, 2, "tma_box"),
                "3x3_s1_box": (16, 128, 64, 3, 1, "tma_box"),
                "3x3_s1_box_bk64": (8, 64, 128, 3, 1, "tma_box")}


@pytest.mark.parametrize("kind", sorted(GATHER_CASES))
def test_tiles_rebuild_qconv_exactly(kind):
    side, cin, cout, k, s, load = GATHER_CASES[kind]
    rng = np.random.default_rng(sorted(GATHER_CASES).index(kind))
    x = rng.integers(0, 128, (3, side, side, cin)).astype(np.int8)    # ragged M
    w = rng.integers(-127, 128, (cout, k, k, cin)).astype(np.int8)
    assert k8.route(cin, cout, k, s, side, side) == load
    got = emulate_gemm(x, w.reshape(cout, -1), k, s, bk_of(cin), bn_of(cout), load)
    want = np.asarray(jq._qconv(jnp.asarray(x), jnp.asarray(w.transpose(1, 2, 3, 0)), s))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the stem

def stem_raw(flat, strides, H, W, b, oh, owb, raw_tma):
    """The tile's raw float rows as the producer fetches them, indexed by
    (7 ci + kh, r): float r at input column 2 BM owb - 4 + r, in two halves
    of RAW_BOX floats; by two TMA boxes of the (W, H, C, B) image map
    (zeros outside the tensor; raw_tma: planar images, W % 4 == 0), or float
    by float at r = 1 .. 261."""
    sb, sh, sw, sc = strides
    box = _const("RAW_BOX")
    raw = np.zeros((21, 2 * box), np.float32)
    ih0, iw0 = 2 * oh - 3, 2 * BM * owb - 3
    row = np.arange(21)[:, None]
    ci, kh = row // 7, row % 7
    ih = ih0 + kh
    if raw_tma:
        r = np.arange(2 * box)[None, :]               # both boxes side by side
        iw = iw0 - 1 + r
    else:
        r = np.arange(1, 1 + STEM_COLS)[None, :]
        iw = iw0 + r - 1
    ok = (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
    src = b * sb + ih * sh + iw * sw + ci * sc
    raw[:, r[0]] = np.where(ok, flat[np.where(ok, src, 0)], 0)
    return raw


def stem_patch(flat, strides, H, W, b, oh, owb, inv_img, rows16):
    """The tile's quantized 7-row patch, as the producer fills it from its
    raw rows: raw float r is patch column r - 1, (column, channel)
    interleaved."""
    raw = stem_raw(flat, strides, H, W, b, oh, owb, rows16)
    patch = np.zeros(7 * STEM_PITCH, np.int8)
    # clamp, then round by the magic number (the kernel's order)
    t = np.clip(raw * np.float32(inv_img), np.float32(-127), np.float32(127))
    q = ((t + np.float32(12582912.0)).view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    for row in range(21):
        ci, kh = divmod(row, 7)
        c = np.arange(STEM_COLS)
        patch[kh * STEM_PITCH + 3 * c + ci] = q[row, c + 1]
    return patch


def stem_rows(patch, st):
    """Stage st's A rows: kernel rows 4 st .. 4 st + 3 as 32 bytes each from
    6 x the row's column, read as 32-bit words (two half-words shifted
    where the offset is 2 mod 4); kernel row 7 is zeros."""
    words = patch.view(np.uint32)
    rows = np.zeros((BM, 128), np.uint8)
    for pt in range(BM):
        for q in range(4):
            kh = 4 * st + q
            if kh >= 7:
                continue
            off = kh * STEM_PITCH + 6 * pt
            src = words[(off & ~3) // 4:(off & ~3) // 4 + 9].astype(np.uint64)
            v = ((src[:8] >> 16) | (src[1:9] << 16)) & 0xFFFFFFFF if off & 3 else src[:8]
            rows[pt, 32 * q:32 * q + 32] = v.astype(np.uint32).view(np.uint8)
    return rows.view(np.int8)


def emulate_stem(images, wq, inv_img):
    """int32 sums of the stem from float images (B, H, W, 3) at any strides
    (the 16-byte raw fetch where the source's int8_stem takes it)."""
    B, H, W, _ = images.shape
    Ho, Wo = k8.out_hw(H, 7, 2), k8.out_hw(W, 7, 2)
    flat = images.as_strided((images.untyped_storage().nbytes() // 4,), (1,),
                             0).numpy()
    strides = images.stride()
    sb, sh, sw, sc = strides
    rows16 = sw == 1 and W % 4 == 0 and sh == W and sc == H * W and sb == 3 * H * W
    w = k8.stem_weight(torch.from_numpy(wq)).numpy()                    # (64, 256)
    out = np.zeros((B * Ho * Wo, 64), np.int64)
    owb_n = -(-Wo // BM)
    for tile in range(B * Ho * owb_n):
        t2, owb = divmod(tile, owb_n)
        b, oh = divmod(t2, Ho)
        patch = stem_patch(flat, strides, H, W, b, oh, owb, inv_img, rows16)
        acc = np.zeros((BM, 64), np.int64)
        for st in range(2):
            a = _descriptor_read(_swizzled(stem_rows(patch, st), 128), BM, 128)
            bt = _descriptor_read(_swizzled(_tma_rows(w, 0, 128 * st, 64, 128), 128), 64, 128)
            acc += a.astype(np.int64) @ bt.astype(np.int64).T
        m0, mlim = t2 * Wo + owb * BM, min(BM, Wo - owb * BM)
        out[m0:m0 + mlim] = acc[:mlim]
    return out.reshape(B, Ho, Wo, 64)


@pytest.mark.parametrize("layout,W", [("planar", 262), ("planar", 264), ("nhwc", 262)])
def test_stem_from_float_images_equals_jax(layout, W):
    """The raw rows, the patch and its 32-byte rows rebuild JAX's quantize +
    7x7 / 2 conv exactly (sums), and the codes equal JAX's stem site; W 262
    and 264 give two column blocks, the second ragged, fetched float by
    float and (planar, W % 4 == 0) by 16-byte chunks."""
    assert "h.raw_tma = sw == 1 && W % 4 == 0 && sh == W && sc == static_cast<long long>(H) * W &&" in SRC
    rng = np.random.default_rng(7)
    B, H = 2, 12
    nchw = torch.from_numpy((rng.standard_normal((B, 3, H, W)) * 2).astype(np.float32))
    images = nchw.permute(0, 2, 3, 1)
    if layout == "nhwc":
        images = images.contiguous()
    wq = rng.integers(-127, 128, (64, 7, 7, 3)).astype(np.int8)
    inv_img = np.float32(127 / 5.0)
    got = emulate_stem(images, wq, inv_img)
    xj = jnp.clip(jnp.round(jnp.asarray(images.numpy()) * inv_img), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(got, np.asarray(jq._qconv(xj, jnp.asarray(
        wq.transpose(1, 2, 3, 0)), 2)))
    site = {"wq": jnp.asarray(wq.transpose(1, 2, 3, 0)),
            "es": jnp.asarray((rng.random(64) + 0.5).astype(np.float32) / 2e5),
            "b": jnp.asarray((rng.standard_normal(64) * 0.1).astype(np.float32))}
    inv = np.float32(127 / 3.0)
    want = np.asarray(jax.jit(jq._requant_relu)(jax.jit(jq._site_out, static_argnums=2)(
        site, xj, 2), inv))
    codes = _epilogue(got, np.asarray(site["es"]), np.asarray(site["b"]), inv)
    assert int(np.sum(codes != want)) == 0
    # the wrapper's plain version on this view agrees too
    tsite = {"wq": torch.from_numpy(wq), "es": torch.tensor(np.asarray(site["es"])),
             "b": torch.tensor(np.asarray(site["b"]))}
    np.testing.assert_array_equal(k8.stem_site(images, tsite, torch.tensor(inv_img),
                                               torch.tensor(inv)).numpy(), want)


# ---------------------------------------------------------------------------
# the epilogues

def _dequant(acc, es, b):
    return acc.astype(np.float32) * es + b


def _epilogue(acc, es, b, inv, add=None):
    """The kernel's per-element epilogue in numpy float32 (each op rounded)."""
    y = _dequant(acc, es, b)
    if add is not None:
        y = y + add
    return np.clip(np.round(np.maximum(y, np.float32(0)) * inv), 0, 127).astype(np.int8)


def _jax_site_fns():
    return jax.jit(jq._site_out, static_argnums=2), jax.jit(jq._requant_relu)


def _site(rng, cin, cout):
    wq = rng.integers(-127, 128, (cout, 1, 1, cin)).astype(np.int8)
    es = ((rng.random(cout) + 0.5) / (127.0 * 64 * cin ** 0.5)).astype(np.float32)
    return wq, es, (rng.standard_normal(cout) * 0.1).astype(np.float32)


@pytest.mark.parametrize("side,cin,cmid,cout,stride", [(9, 64, 64, 256, 1), (10, 256, 128, 512, 2),
                                                      (16, 256, 128, 512, 2)])
def test_fused_site_codes_equal_jax(side, cin, cmid, cout, stride):
    """Two GEMMs on each tile (the down convolution's stages, then conv3's,
    into two accumulator sets) and q((acc3 es3 + b3) + (accd esd + bd)):
    every code equals JAX's _requant_relu(_site_out(conv3) + _site_out(down))."""
    rng = np.random.default_rng(side + cin)
    ho = k8.out_hw(side, 1, stride)
    xq = rng.integers(0, 128, (3, side, side, cin)).astype(np.int8)
    out = rng.integers(0, 128, (3, ho, ho, cmid)).astype(np.int8)
    (w3, es3, b3), (wd, esd, bd) = _site(rng, cmid, cout), _site(rng, cin, cout)
    bk = bk_of(cin, cmid)
    accd = emulate_gemm(xq, wd.reshape(cout, -1), 1, stride, bk, 128,
                        k8.a_load(1, stride, ho, ho))
    acc3 = emulate_gemm(out, w3.reshape(cout, -1), 1, 1, bk, 128, "tma")
    inv = np.float32(127 / 3.0)
    got = _epilogue(acc3, es3, b3, inv, add=_dequant(accd, esd, bd))
    site, requant = _jax_site_fns()
    hwio = lambda w: jnp.asarray(w.transpose(1, 2, 3, 0))
    j3 = {"wq": hwio(w3), "es": jnp.asarray(es3), "b": jnp.asarray(b3)}
    jd = {"wq": hwio(wd), "es": jnp.asarray(esd), "b": jnp.asarray(bd)}
    want = np.asarray(requant(site(j3, jnp.asarray(out), 1) + site(jd, jnp.asarray(xq), stride),
                              inv))
    assert int(np.sum(got != want)) == 0
    tsite = lambda w, e, b: {"wq": torch.from_numpy(w), "es": torch.from_numpy(e),
                             "b": torch.from_numpy(b)}
    np.testing.assert_array_equal(k8.fused_site(torch.from_numpy(out), torch.from_numpy(xq),
                                                tsite(w3, es3, b3), tsite(wd, esd, bd), stride,
                                                torch.tensor(inv)).numpy(), want)


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_int8_shortcut_through_its_swizzled_tile(bn):
    """The identity shortcut's tile as TMA lays it out (boxes of min(BN,
    128) bytes, swizzled by their width) and read back at each lane's
    (row, column pair): the epilogue's codes equal JAX's
    _requant_relu(_site_out(conv3) + xq * a_x)."""
    rng = np.random.default_rng(bn)
    cin, cout, side = 64, 2 * bn, 6
    out = rng.integers(0, 128, (3, side, side, cin)).astype(np.int8)
    sc = rng.integers(0, 128, (3, side, side, cout)).astype(np.int8)
    w3, es3, b3 = _site(rng, cin, cout)
    acc = emulate_gemm(out, w3.reshape(cout, -1), 1, 1, 64, bn, "tma").reshape(-1, cout)
    sb = min(bn, 128)
    sc2d = sc.reshape(-1, cout)
    M = sc2d.shape[0]
    read = np.zeros_like(sc2d)
    for m0 in range(0, M, BM):
        for n0 in range(0, cout, bn):
            tile = np.concatenate([_swizzled(_tma_rows(sc2d, m0, n0 + i * sb, BM, sb), sb)
                                   for i in range(bn // sb)])
            tr = np.arange(BM)[:, None]
            col = np.arange(0, bn, 2)[None, :]
            cb = col % sb
            off = (col // sb) * BM * sb + tr * sb + ((swizzle_chunk(sb, tr, cb >> 4) << 4)
                                                     | (cb & 15))
            pair = np.stack([tile[off], tile[off + 1]], -1).reshape(BM, bn)
            rows = min(BM, M - m0)
            read[m0:m0 + rows, n0:n0 + bn] = pair[:rows]
    assert (read == sc2d).all()
    a_x, inv = np.float32(1 / 127.0), np.float32(127 / 3.0)
    got = _epilogue(acc, es3, b3, inv, add=read.astype(np.float32) * a_x)
    site, requant = _jax_site_fns()
    j3 = {"wq": jnp.asarray(w3.transpose(1, 2, 3, 0)), "es": jnp.asarray(es3),
          "b": jnp.asarray(b3)}
    want = requant(site(j3, jnp.asarray(out), 1) + jnp.asarray(sc).astype(jnp.float32) * a_x,
                   inv)
    assert int(np.sum(got.reshape(want.shape) != np.asarray(want))) == 0


# ---------------------------------------------------------------------------
# the ring's mbarrier protocol

def run_ring(kinds, stages, seed, consumers=2):
    """Drive the producer (one actor for its 128 threads) and the consumer
    warpgroups through one block's stage sequence `kinds` ("tma": A and B
    by TMA; "gather": B by TMA, A by the threads' cp.async) under random
    completion times; returns the stages each consumer read, in order.
    Raises on a deadlock or on a stage read before its data landed."""
    rng = np.random.default_rng(seed)
    n = len(kinds)
    full = [dict(phase=0, pending=129, tx=0) for _ in range(stages)]
    empty = [dict(phase=0, pending=consumers) for _ in range(stages)]
    landed, inflight = set(), []                 # ("tx" | "cp", stage) copies

    def complete(bar, count):
        if bar["pending"] == 0 and bar.get("tx", 0) == 0:
            bar["phase"] ^= 1
            bar["pending"] = count

    def arrive(bar, count, times=1):
        bar["pending"] -= times
        complete(bar, count)

    def land(copy):
        inflight.remove(copy)
        landed.add(copy)
        if copy[0] == "tx":                      # TMA's complete_tx
            full[copy[1] % stages]["tx"] -= 1
            complete(full[copy[1] % stages], 129)

    def announce(i):                             # cp.async.wait_group, fence, arrive
        if ("cp", i) in inflight:
            land(("cp", i))
        arrive(full[i % stages], 129, 128)

    def done(bar, parity):                       # mbarrier.try_wait.parity
        return bar["phase"] != parity

    prod = dict(i=0, pending=None)
    cons = [dict(i=0, prev=None, read=[]) for _ in range(consumers)]
    for _ in range(200 * n + 1000):
        progressed = False
        if inflight and rng.random() < 0.5:
            land(inflight[int(rng.integers(len(inflight)))])
            progressed = True
        p = prod
        if p["i"] < n:
            i, s = p["i"], p["i"] % stages
            if done(empty[s], ((i // stages) & 1) ^ 1):
                full[s]["tx"] += 1               # arrive.expect_tx, then the TMA
                arrive(full[s], 129)
                inflight.append(("tx", i))
                if kinds[i] == "tma":
                    if p["pending"] is not None:
                        announce(p["pending"])
                        p["pending"] = None
                    arrive(full[s], 129, 128)
                else:
                    inflight.append(("cp", i))
                    if p["pending"] is not None:
                        announce(p["pending"])
                    p["pending"] = i
                p["i"] += 1
                progressed = True
        elif p["pending"] is not None:
            announce(p["pending"])
            p["pending"] = None
            progressed = True
        for c in cons:
            if c["i"] < n:
                i, s = c["i"], c["i"] % stages
                if done(full[s], (i // stages) & 1):
                    if ("tx", i) not in landed or (kinds[i] == "gather" and
                                                   ("cp", i) not in landed):
                        raise AssertionError(f"stage {i} read before it landed")
                    c["read"].append(i)
                    if c["prev"] is not None:    # wgmma.wait_group 1: the previous stage
                        arrive(empty[c["prev"] % stages], consumers)
                    c["prev"] = i
                    c["i"] += 1
                    progressed = True
            elif c["prev"] is not None:
                arrive(empty[c["prev"] % stages], consumers)
                c["prev"] = None
                progressed = True
        if prod["i"] == n and prod["pending"] is None and \
                all(c["i"] == n and c["prev"] is None for c in cons):
            return [c["read"] for c in cons]
        if not progressed and not inflight:
            raise AssertionError(f"deadlock: producer at {prod['i']}, consumers at "
                                 f"{[c['i'] for c in cons]}")
    raise AssertionError("no end")


@pytest.mark.parametrize("kinds", [
    ["tma"] * 23,                                   # a 1x1 / 1 site, several tiles
    ["gather"] * 19,                                # a 3x3 site
    (["gather"] * 4 + ["tma"] * 2) * 5,             # fused, stride 2: down gathered, conv3 TMA
    ["gather", "tma"] * 9], ids=["tma", "gather", "fused", "alternating"])
def test_ring_protocol_ends_and_reads_landed_stages(kinds):
    """Three to six stages (every instantiation has at least three: the
    source's static_assert); two deadlock once stages are gathered."""
    assert "static_assert(STAGES >= 3" in _HOP
    for stages in (3, 4, 5, 6):
        for seed in range(3):
            reads = run_ring(list(kinds), stages, seed)
            assert all(r == list(range(len(kinds))) for r in reads)
    if "gather" in kinds:
        with pytest.raises(AssertionError, match="deadlock"):
            run_ring(list(kinds), 2, 0)


def test_site_routes_sum_to_the_encode_launches():
    """``site_routes`` (from a tree's shapes) and ``encode_sites`` (from the
    geometry) agree: 100 site launches, none on the mma.sync kernel, none
    gathered at 256x256 (at 200x200 the 3x3 and strided sites are)."""
    qtree = {f"layer{s}": [] for s in range(1, 5)}
    cin = 64
    for stage, (count, width) in enumerate(zip((3, 4, 23, 3), (64, 128, 256, 512)), 1):
        for b in range(count):
            w = lambda n, k, c: {"wq": torch.zeros((n, k, k, c), dtype=torch.int8)}
            qb = {"conv1": w(width, 1, cin), "conv2": w(width, 3, width),
                  "conv3": w(4 * width, 1, width)}
            if b == 0:
                qb["down_conv"] = w(4 * width, 1, cin)
            qtree[f"layer{stage}"].append(qb)
            cin = 4 * width
    routes = tq.site_routes(qtree, 256)
    assert routes == {"tma": 62, "tma_box": 33, "gather": 0, "fused": 4, "stem": 1,
                      "mma_sync": 0}
    assert sum(routes.values()) == sum(tq.encode_sites(256).values()) == 100
    assert tq.site_routes(qtree, 200)["gather"] > 0


def test_variants_match_the_source():
    """Every text replacement of ``_variants``' int8_conv variants matches
    csrc/int8_conv.cu (a variant that no longer applies raises)."""
    from icek_torch.kernels import _variants

    for name in _variants.VARIANTS["int8_conv"]:
        assert _variants.variant_source("int8_conv", name, SRC) != SRC or name == "base"


def test_magic_number_conversions_are_exact():
    """The epilogue's conversions by 1.5 * 2^23 (``code_to_float``,
    ``requant_byte``): every int8 code becomes its float exactly, and every
    float32 product in [0, 127] (the .5 ties included) rounds to rint's
    integer, in float32 arithmetic as the card does it."""
    assert "constexpr float MAGIC = 12582912.0f;" in _HOP
    magic = np.float32(12582912.0)
    codes = np.arange(-128, 128, dtype=np.int32)
    as_float = (np.int32(0x4B400000) + codes).view(np.float32) - magic
    np.testing.assert_array_equal(as_float, codes.astype(np.float32))
    rng = np.random.default_rng(3)
    t = np.concatenate([np.arange(0, 255, dtype=np.float32) / 2,          # the ties
                        rng.random(20000, dtype=np.float32) * 140,
                        np.nextafter(np.arange(1, 128, dtype=np.float32) - 0.5, 0),
                        np.array([0.0, 126.5, 127.0, 127.49, 1e9], np.float32)])
    byte = (np.minimum(t, np.float32(127)) + magic).view(np.uint32) & 0xFF
    want = np.clip(np.rint(t), 0, 127).astype(np.uint32)
    np.testing.assert_array_equal(byte, want)
