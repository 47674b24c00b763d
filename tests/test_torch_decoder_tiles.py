"""The tensor-core decoder step (``icek_torch/csrc/decoder_step.cu``,
``decoder_step_mma_kernel``), emulated in torch on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_gpu.py); what it does
block by block is written out here and held against the plain version and
the JAX package (its f32 route, three TF32 products a product, in
tests/test_torch_decoder_tf32.py, on this file's ``emulate``):

* a block takes the G * K hypothesis rows of G images (the last group
  ragged), or one part of a wider image's rows (``block_spans``), padded
  with zero rows to one 16-row tile;
* the six linears multiply the rows, rounded to bf16, by weights read in
  ``pack_mma``'s B-fragment order (each lane's two k-steps of an n8 tile);
  biases, residual sums and LayerNorm stay in f32;
* self-attention: per (row, head) an online softmax over the history rows
  the ancestry selects, then the current step's own K/V;
* cross-attention: the memory in ``pad_cross_heads``'s head-major layout
  (Hd padded to 32), walked in the ring's stage order, 32 rows a tile with
  the ragged last tile masked, an online softmax in the log2 domain whose
  P is rounded to bf16 for the product and summed unrounded.

Tolerances: with rounding off and f32 inputs only the summation order and
exp2 against exp differ from the plain version, so h and the K/V rows are
held to it, to the JAX Pallas kernel (interpret mode) and to the JAX stock
step at atol 1e-4.  With rounding on the emulation is held to the plain
bf16 version at the card's tolerance, atol 0.15 (tests/test_torch_gpu.py,
chip_smoke.py phase 3).
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

ROWS, XSTAGES, HDP = tds.ROWS, tds.CROSS_STAGES, tds.HEAD_PAD
XT = tds.CROSS_TILE[torch.bfloat16]
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small torch ops; with the suite's other
    workers on the same cores, torch's thread pool waits at every op's
    barrier for threads that are not running.  One thread each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def unpack_fragments(packed, din, dout):
    """The (din, dout) weights the kernel's lanes see: register 2 s + h of lane
    4 g + t, half e, of (n8 tile nt, k-pair kp) is B[32 kp + 16 s + 8 h + 2 t
    + e][8 nt + g], b0 / b1 of the pair's even k-step then of its odd one."""
    nL, nt, kp = packed.shape[:3]
    w = torch.zeros((nL, 32 * kp, 8 * nt), dtype=packed.dtype)
    n_i, k_i, lane, el = torch.meshgrid(torch.arange(nt), torch.arange(kp),
                                        torch.arange(32), torch.arange(8), indexing="ij")
    g, t = lane // 4, lane % 4
    s, h, e = el // 4, el // 2 % 2, el % 2
    w[:, 32 * k_i + 16 * s + 8 * h + 2 * t + e, 8 * n_i + g] = packed[:, n_i, k_i, lane, el]
    return w[:, :din, :dout]


def ring_schedule(nL, nimg, M, XT=XT):
    """(layer, image, first memory row) of each cross stage, in the order the
    kernel's load_stage(s) loads them (XT memory rows a stage)."""
    nT = -(-M // XT)
    per_layer = nimg * nT
    out = []
    for s in range(nL * per_layer):
        l, rem = divmod(s, per_layer)
        gi, mt = divmod(rem, nT)
        out.append((l, gi, mt * XT))
    return out


def block_spans(B, K, G, S=1):
    """(first row, rows) of each block of the kernel over the B K hypothesis
    rows: G whole images a block (S = 1, the last group ragged), or S parts
    of ceil(K / S) rows an image, the last ragged."""
    if S == 1:
        return [(b0 * K, min(G, B - b0) * K) for b0 in range(0, B, G)]
    per = -(-K // S)
    return [(b * K + p * per, min(per, K - p * per)) for b in range(B) for p in range(S)]


def tf32_rna(x):
    """x (float32) rounded to TF32, to nearest, ties away from zero: the
    bits of cvt.rna.tf32.f32, by bit arithmetic."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-0x80000000, dtype=torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return (sign | (mag & ~0x1FFF)).view(torch.float32)


def split_tf32(x):
    """hi, lo as the f32 route's mma3 reads them (common.cuh::split_tf32_bits):
    hi = rna(x), lo = x - hi with its low 13 bits ignored by the tensor
    cores (truncated)."""
    hi = tf32_rna(x)
    lo = (x - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def tf32_dot(eq, a, b, k_axis_a, k_axis_b, terms=3, step=16):
    """torch.einsum(eq, a, b) as the f32 route takes it: the contraction in
    steps of `step` (a linear's k-pair of 16, S's whole head dim, a P V
    tile's keys), each step's hi lo + lo hi + hi hi (hi hi alone with terms
    1) summed exactly (float64: the tensor cores' short sums), rounded to
    f32 and added to the sum in f32, step by step."""
    (ah, al), (bh, bl) = split_tf32(a.float()), split_tf32(b.float())
    out = None
    for k0 in range(0, a.shape[k_axis_a], step):
        sa = lambda t: t.narrow(k_axis_a, k0, min(step, a.shape[k_axis_a] - k0)).double()
        sb = lambda t: t.narrow(k_axis_b, k0, min(step, b.shape[k_axis_b] - k0)).double()
        part = torch.einsum(eq, sa(ah), sb(bh))
        if terms == 3:
            part = torch.einsum(eq, sa(al), sb(bh)) + torch.einsum(eq, sa(ah), sb(bl)) + part
        out = part.float() if out is None else out + part.float()
    return out


def unpack_tf32(packed, din, dout):
    """The (din, dout) f32 weights the kernel's lanes see in ``pack_tf32``'s
    order: register 2 s + h of lane 4 g + t of (n8 tile nt, k-pair kp) is
    B[16 kp + 8 s + 4 h + t][8 nt + g] (b0 / b1 of the pair's even k8
    step, then of its odd one)."""
    nL, nt, kp = packed.shape[:3]
    w = torch.zeros((nL, 16 * kp, 8 * nt), dtype=packed.dtype)
    n_i, k_i, lane, el = torch.meshgrid(torch.arange(nt), torch.arange(kp),
                                        torch.arange(32), torch.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    s, h = el // 2, el % 2
    w[:, 16 * k_i + 8 * s + 4 * h + t, 8 * n_i + g] = packed[:, n_i, k_i, lane, el]
    return w[:, :din, :dout]


def emulate(stacked, x, anc, ck, cv, cross_heads, i, H, G, rounding, eps=1e-5, S=1):
    """The tensor-core kernel's arithmetic on f32 tensors: (h, k_new, v_new).
    `rounding`: False (f32 throughout, the bf16 route's tiling) or True (the
    bf16 route), "tf32" (the f32 route: three TF32 products a product, 16
    memory rows a cross stage) or "tf32x1" (one TF32 product, hi hi).  The
    cross layout's head pad and a stage's memory rows follow the head dim as
    the kernel's do (``head_pad``, ``cross_tile``: heads of 33 to 64 dims
    padded to 64, 16 rows a stage)."""
    tc = rounding in ("tf32", "tf32x1")
    r = _bf16 if rounding is True else (lambda t: t)
    terms = 1 if rounding == "tf32x1" else 3
    nL, B, LK, D = ck.shape
    K = x.shape[1]
    L = LK // K
    M = cross_heads[0].shape[2]
    Hd = D // H
    HDP = tds.head_pad(Hd)
    XT = tds.cross_tile(torch.float32 if tc else torch.bfloat16, Hd)
    F = stacked.f1_w.shape[-1]
    pack, unpack = (tds.pack_tf32, unpack_tf32) if tc else (tds.pack_mma, unpack_fragments)
    mma = tds.PackedLinears(*(pack(w.float()) for w in (
        stacked.qkv_w, stacked.so_w, stacked.cq_w, stacked.co_w, stacked.f1_w, stacked.f2_w)))
    dims = [(D, 3 * D), (D, D), (D, D), (D, D), (D, F), (F, D)]
    W = [r(unpack(p, *dd)) for p, dd in zip(mma, dims)]
    if tc:
        prod = lambda a, w: tf32_dot("rk,kn->rn", a, w, 1, 0, terms)
    else:
        prod = lambda a, w: r(a) @ w
    bias = [stacked.qkv_b, stacked.so_b, stacked.cq_b, stacked.co_b, stacked.f1_b, stacked.f2_b]
    xk = cross_heads[0].float().view(nL, B, M, H, HDP)
    xv = cross_heads[1].float().view(nL, B, M, H, HDP)
    scale = 1 / math.sqrt(Hd)
    h_out = torch.zeros((B, K, D))
    k_new = torch.zeros((nL, B, K, D))
    v_new = torch.zeros((nL, B, K, D))

    def norm(xs, l, n, R):
        mu = xs[:R].mean(dim=1, keepdim=True)
        var = (xs[:R] - mu).square().mean(dim=1, keepdim=True)
        xs[:R] = (xs[:R] - mu) * torch.rsqrt(var + eps) * stacked.ln_s[l, n] + stacked.ln_b[l, n]

    for row0, R in block_spans(B, K, G, S):
        rows = slice(row0, row0 + R)
        img0 = row0 // K
        nimg = (row0 + R - 1) // K - img0 + 1
        xs = torch.zeros((ROWS, D))
        xs[:R] = r(x.reshape(B * K, D)[rows].float())
        rows_anc = anc.reshape(B * K, L)[rows].long()
        schedule = iter(ring_schedule(nL, nimg, M, XT))
        for l in range(nL):
            lin = lambda j, a: prod(a, W[j][l])
            proj = r(lin(0, xs) + bias[0][l])                      # (16, 3D), bf16 in smem
            q, kc, vc = proj[:, :D], proj[:, D:2 * D], proj[:, 2 * D:]
            k_new[l].view(B * K, D)[rows] = kc[:R]
            v_new[l].view(B * K, D)[rows] = vc[:R]

            # self-attention, (row, head) pairs vectorised, t walked in order
            img = (row0 + torch.arange(R)) // K
            qh = q[:R].view(R, H, Hd)
            m = torch.full((R, H), -math.inf)
            s = torch.zeros((R, H))
            o = torch.zeros((R, H, Hd))
            for t in range(i + 1):
                if t < i:
                    row = t * K + rows_anc[:, t]
                    kt = ck[l, img, row].float().view(R, H, Hd)
                    vt = cv[l, img, row].float().view(R, H, Hd)
                else:
                    kt, vt = kc[:R].view(R, H, Hd), vc[:R].view(R, H, Hd)
                sv = (qh * kt).sum(dim=-1) * scale
                m_new = torch.maximum(m, sv)
                alpha, p = torch.exp(m - m_new), torch.exp(sv - m_new)
                s = s * alpha + p
                o = o * alpha[..., None] + p[..., None] * vt
                m = m_new
            ab = torch.zeros((ROWS, D))
            ab[:R] = r((o / s[..., None]).reshape(R, D))
            xs[:R] += lin(1, ab)[:R] + bias[1][l]
            norm(xs, l, 0, R)

            # cross-attention over the ring's stages of this layer
            qc = r(lin(2, xs) + bias[2][l]).view(ROWS, H, Hd)
            qp = torch.nn.functional.pad(qc, (0, HDP - Hd))           # (16, H, HDP)
            c = scale * LOG2E
            ab = torch.zeros((ROWS, D))
            for _ in range(nimg * -(-M // XT)):
                sl, gi, m0 = next(schedule)
                assert sl == l
                if m0 == 0:
                    mrow = torch.full((ROWS, H), -math.inf)
                    lrow = torch.zeros((ROWS, H))
                    acc = torch.zeros((ROWS, H, HDP))
                kt = torch.zeros((XT, H, HDP))
                vt = torch.zeros((XT, H, HDP))
                live = min(XT, M - m0)
                kt[:live] = xk[l, img0 + gi, m0:m0 + live]
                vt[:live] = xv[l, img0 + gi, m0:m0 + live]
                if tc:      # the padded head dim in one tensor-core sum
                    sc = tf32_dot("rhd,mhd->rhm", qp, kt, 2, 2, terms, step=HDP)
                else:
                    sc = torch.einsum("rhd,mhd->rhm", qp, kt)
                sc[..., live:] = -math.inf
                m_new = torch.maximum(mrow, sc.amax(dim=-1) * c)
                alpha = torch.exp2(mrow - m_new)
                p = torch.exp2(sc * c - m_new[..., None])
                lrow = lrow * alpha + p.sum(dim=-1)
                if tc:      # the tile's keys in one tensor-core sum, added to the rescaled O
                    acc = acc * alpha[..., None] + tf32_dot("rhm,mhd->rhd", p, vt, 2, 0, terms,
                                                            step=XT)
                else:
                    acc = acc * alpha[..., None] + torch.einsum("rhm,mhd->rhd", r(p), vt)
                mrow = m_new
                if m0 + XT >= M:                                    # the image's rows out
                    lo = (img0 + gi) * K - row0
                    out = slice(max(lo, 0), min(lo + K, R))
                    ab[out] = r((acc[out, :, :Hd] / lrow[out, :, None]).reshape(-1, D))
            xs[:R] += lin(3, ab)[:R] + bias[3][l]
            norm(xs, l, 1, R)

            hid = r(torch.relu(lin(4, xs) + bias[4][l]))
            xs[:R] += lin(5, hid)[:R] + bias[5][l]
            norm(xs, l, 2, R)
        assert next(schedule, None) is None
        h_out.view(B * K, D)[rows] = xs[:R]
    return h_out, k_new, v_new


def _inputs(seed, B, K, L, M, D, H, F, i, nL=2):
    """JAX-initialised layers with non-zero biases and norms, caches filled
    below step i, an ancestry that is each hypothesis's own slot from i on."""
    from icek_tpu.models import transformer as jtf

    rng = np.random.default_rng(seed)
    layers = jax.tree.map(np.asarray, jtf.init_decoder_stack(jax.random.PRNGKey(seed), nL, D, F))
    for lay in layers["layers"]:
        for mha in (lay["self_attn"], lay["cross_attn"]):
            mha["qkv_b"] = (rng.standard_normal(3 * D) * 0.1).astype(np.float32)
        for n in (1, 2, 3):
            lay[f"norm{n}"]["scale"] = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
            lay[f"norm{n}"]["bias"] = (0.1 * rng.standard_normal(D)).astype(np.float32)
    x = rng.standard_normal((B, K, D)).astype(np.float32)
    ck = np.zeros((nL, B, L * K, D), np.float32)
    cv = np.zeros((nL, B, L * K, D), np.float32)
    ck[:, :, :i * K] = rng.standard_normal((nL, B, i * K, D))
    cv[:, :, :i * K] = rng.standard_normal((nL, B, i * K, D))
    xk = rng.standard_normal((nL, B, M, D)).astype(np.float32)
    xv = rng.standard_normal((nL, B, M, D)).astype(np.float32)
    anc = rng.integers(0, K, (B, K, L)).astype(np.int32)
    anc[:, :, i:] = np.arange(K)[None, :, None]
    return layers, x, ck, cv, xk, xv, anc


def _emulated(layers, x, ck, cv, xk, xv, anc, i, H, G, rounding, S=1):
    nL, B, M, D = xk.shape
    stacked = tds.stack_decoder_params(bridge.to_torch(layers))
    cross = [{"k": torch.as_tensor(xk[l]).view(B, M, H, D // H),
              "v": torch.as_tensor(xv[l]).view(B, M, H, D // H)} for l in range(nL)]
    heads = tds.pad_cross_heads(cross, torch.float32)
    t = torch.as_tensor
    return stacked, emulate(stacked, t(x), t(anc), t(ck), t(cv), heads, i, H, G, rounding, S=S)


def _plain(stacked, x, ck, cv, xk, xv, anc, i, H):
    t = torch.as_tensor
    return tds.reference_decoder_step(stacked, t(x), t(anc), t(ck), t(cv), t(xk), t(xv), i,
                                      num_heads=H)


def _hold(got, want, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   atol=atol, rtol=0)


SMALL = dict(K=3, L=6, M=45, D=40, H=4, F=64)


@pytest.mark.parametrize("step", [0, 1, SMALL["L"] - 1])
@pytest.mark.parametrize("B,G", [(5, 2), (4, 5), (3, 1)])
def test_tiled_step_matches_plain_f32(step, B, G):
    """Small widths (2 layers, D 40, H 4, F 64), M 45 (a full and a ragged
    tile), G-image groups with a ragged last one (5 images in groups of 2),
    one group of fewer images than G holds (4 of 5), one image a block."""
    args = _inputs(10 * B + step, B=B, i=step, **{k: v for k, v in SMALL.items()})
    layers, x, ck, cv, xk, xv, anc = args
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, SMALL["H"], G, False)
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, step, SMALL["H"]), 1e-4)


@pytest.mark.parametrize("step", [0, 3])
def test_tiled_step_matches_jax(step):
    """The emulation (rounding off) against the JAX package's Pallas kernel
    in interpret mode and its stock beam step, at a small shape."""
    B, K, L, M, D, H, F = 3, 3, 6, 37, 16, 2, 24
    layers, x, ck, cv, xk, xv, anc = _inputs(7 + step, B, K, L, M, D, H, F, step)
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


def _through_bf16(tree):
    """The values a bf16 caller holds, as f32 numpy arrays (ints untouched)."""
    return jax.tree.map(lambda a: a if a.dtype.kind == "i" else
                        torch.tensor(a).to(torch.bfloat16).float().numpy(), tree)


@pytest.mark.parametrize("rounding", [False, True])
def test_tiled_step_geo_widths(rounding):
    """The geo preset's widths (3 layers, D 300, H 10 of 30 dims padded to 32,
    F 512, M 497: 15 full tiles and one of 17 rows, L 30) at B 3, K 5, step
    15, G 2.  Rounding off: f32 plain version at 1e-4.  Rounding on (bf16
    weights and inputs, bf16 at the product inputs): the plain bf16 version
    at the card's 0.15."""
    B, K, L, M, D, H, F, step = 3, 5, 30, 497, 300, 10, 512, 15
    args = _inputs(5, B, K, L, M, D, H, F, step, nL=3)
    if rounding:
        args = _through_bf16(args)
    layers, x, ck, cv, xk, xv, anc = args
    stacked, got = _emulated(layers, x, ck, cv, xk, xv, anc, step, H, 2, rounding)
    if not rounding:
        _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, step, H), 1e-4)
        return
    b16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    st16 = tds.stack_decoder_params(
        {"layers": [jax.tree.map(b16, lay) for lay in layers["layers"]]}, torch.bfloat16)
    want = tds.reference_decoder_step(st16, b16(x), torch.as_tensor(anc), b16(ck), b16(cv),
                                      b16(xk), b16(xv), step, num_heads=H)
    _hold(got, [w.float() for w in want], 0.15)


@pytest.mark.parametrize("din,dout", [(40, 120), (300, 900), (512, 300), (16, 8)])
def test_pack_mma_fragment_order(din, dout):
    """pack_mma puts w[k][n] where the kernel's lanes read B[k][n]: depth
    padded to 32, width to 8, zeros in the pads."""
    w = torch.randn((2, din, dout))
    packed = tds.pack_mma(w)
    kp, nt = -(-din // 32), -(-dout // 8)
    assert packed.shape == (2, nt, kp, 32, 8)
    full = unpack_fragments(packed, 32 * kp, 8 * nt)
    assert torch.equal(full[:, :din, :dout], w)
    assert not full[:, din:].any() and not full[:, :, dout:].any()


def test_pad_cross_heads_layout():
    """Head h's dims at [32 h, 32 h + Hd) of a 16-byte aligned row of H * 32
    bf16 values, zeros after; the wrapper undoes it for the other routes."""
    B, M, H, Hd = 2, 7, 10, 30
    cross = [{"k": torch.randn((B, M, H, Hd)), "v": torch.randn((B, M, H, Hd))}
             for _ in range(3)]
    k, v = tds.pad_cross_heads(cross, torch.bfloat16)
    assert k.shape == (3, B, M, H * HDP) and k.dtype == torch.bfloat16
    assert (H * HDP * 2) % 16 == 0
    kh = k.view(3, B, M, H, HDP)
    want = torch.stack([c["k"] for c in cross]).bfloat16().float()
    assert torch.equal(kh[..., :Hd].float(), want)
    assert not kh[..., Hd:].any()


def test_padded_cross_through_the_wrapper_on_cpu():
    """The wrapper given only the padded cross K/V (as the beam loop passes
    them) runs the plain version on the unpadded values."""
    layers, x, ck, cv, xk, xv, anc = _inputs(3, 2, 3, 6, 11, 16, 2, 24, 2)
    nL, B, M, D = xk.shape
    stacked = tds.stack_decoder_params(bridge.to_torch(layers))
    cross = [{"k": torch.as_tensor(xk[l]).view(B, M, 2, 8),
              "v": torch.as_tensor(xv[l]).view(B, M, 2, 8)} for l in range(nL)]
    heads = tds.pad_cross_heads(cross, torch.float32)
    t = torch.as_tensor
    got = tds.fused_beam_decoder_step(stacked, t(x), t(anc), t(ck), t(cv), None, None, 2,
                                      num_heads=2, cross_heads=heads)
    _hold(got, _plain(stacked, x, ck, cv, xk, xv, anc, 2, 2), 0)


def test_route_predicate_and_groups():
    """bf16 and f32 at the geo beam shape take the tensor-core route, which
    fits the card's shared memory in both, and so do beams wider than 16,
    and heads of 33 to 64 dims (pad 64, bf16 and f32); more heads than
    warps, an odd head dim, a head dim above 64 and unpacked weights do not
    (they take the CUDA-core kernel).  G images a block: one
    wave on 132 SMs."""
    geo = dict(D=300, H=10, F=512, L=30)
    assert tds.mma_smem_bytes(**geo) == 196992 <= tds.MAX_SMEM
    assert tds.mma_smem_bytes(**geo, dtype=torch.float32) == 223616 <= tds.MAX_SMEM

    def case(K=5, D=300, H=10, F=512, L=30, dtype=torch.bfloat16, packed=True):
        layer = {"self_attn": {"qkv_w": torch.zeros((D, 3 * D)), "qkv_b": torch.zeros(3 * D),
                               "out": {"w": torch.zeros((D, D)), "b": torch.zeros(D)}},
                 "ffn": {"lin1": {"w": torch.zeros((D, F)), "b": torch.zeros(F)},
                         "lin2": {"w": torch.zeros((F, D)), "b": torch.zeros(D)}}}
        layer["cross_attn"] = layer["self_attn"]
        for n in (1, 2, 3):
            layer[f"norm{n}"] = {"scale": torch.ones(D), "bias": torch.zeros(D)}
        st = tds.stack_decoder_params({"layers": [layer]}, dtype)
        if not packed:
            st = st._replace(mma=None)
        caches = torch.zeros((1, 2, L * K, D), dtype=dtype)
        return tds.uses_tensor_cores(st, caches, K, H)

    assert case()
    assert case(K=1) and case(K=8) and case(K=16)
    assert case(dtype=torch.float32) and case(K=20, dtype=torch.float32)
    assert case(K=17) and case(K=32)
    assert not case(D=360, H=12)               # more heads than warps
    assert not case(D=360, H=12, dtype=torch.float32)
    assert not case(D=330, H=10)               # head dim 33
    assert case(D=400, H=10)                   # head dim 40: bf16 at pad 64
    assert case(D=400, H=10, dtype=torch.float32)       # f32 at pad 64 too
    assert not case(D=660, H=10, dtype=torch.float32)   # head dim 66
    assert not case(packed=False)
    assert not case(packed=False, dtype=torch.float32)
    assert tds.images_per_block(256, 5, 132) == 2
    assert tds.images_per_block(257, 5, 132) == 2      # 129 blocks, the last one image
    assert tds.images_per_block(3, 5, 132) == 1
    assert tds.images_per_block(4096, 8, 132) == 2
    assert tds.images_per_block(4096, 16, 132) == 1
    assert tds.images_per_block(4096, 1, 132) == 16


def test_ring_schedule_runs_on_across_layers():
    """Every (layer, image, tile) once, layer by layer; the ring's lookahead
    of two stages takes layer l + 1's first two tiles while layer l's last
    two are consumed, so they load during the FFN and the next projections."""
    nL, nimg, M = 3, 2, 497
    sched = ring_schedule(nL, nimg, M)
    nT = -(-M // XT)
    assert nT == 16 and len(sched) == nL * nimg * nT == len(set(sched))
    assert [s[0] for s in sched] == sorted(s[0] for s in sched)
    last_of_0 = nimg * nT - 1
    loaded = [s + XSTAGES - 1 for s in range(last_of_0 - 1, last_of_0 + 1)]
    assert [sched[s] for s in loaded] == [(1, 0, 0), (1, 0, XT)]


def test_ablation_variants_match_the_kernel_source():
    """``python -m icek_torch.kernels._variants decoder_step`` (the card's
    breakdown of the kernel's time) cuts parts out by text replacement: every
    replacement still finds its text in csrc/decoder_step.cu and changes it."""
    import os

    from icek_torch.kernels import _build, _variants

    with open(os.path.join(_build.CSRC, "decoder_step.cu")) as f:
        src = f.read()
    for name, pairs in _variants.VARIANTS["decoder_step"].items():
        out = _variants.variant_source("decoder_step", name, src)
        assert (out != src) == bool(pairs), name
        G = _variants.TWEAKS.get(name, {}).get("images")
        assert G is None or 1 <= G * 5 <= ROWS
        assert bool(pairs) or name in _variants.TWEAKS or name == "base", name
    assert _variants.CUTS["decoder_step"] <= set(_variants.VARIANTS["decoder_step"])
