"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device, which
skips when there is none, so every worker collects the same tests.  On a
machine with the card (JAX not needed):

    ICEK_TPU_TESTS=1 python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 kernels against f32 plain versions to 1e-4 (same math,
other summation order, fast exp); bf16 to the looser bounds stated per
test (the plain versions round intermediates to bf16 where the kernels
keep f32).  Top-k indices must be identical in both.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from icek_torch.kernels import copy_scores as tcs
from icek_torch.kernels import decoder_step as tds
from icek_torch.kernels import flash_attention as tfa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,h,hd,kv_len", [
    (17, 17, 3, 30, 17), (13, 37, 3, 30, 30), (301, 301, 10, 30, 301),
    (40, 70, 2, 64, 70), (9, 20, 2, 100, 11),
    # the edges of the 16-row, 8-key and 64-key tiles of the tensor-core path
    (1, 1, 2, 30, 1), (15, 17, 3, 30, 17), (16, 16, 2, 30, 16), (65, 129, 3, 30, 129),
    (301, 497, 2, 30, 497), (65, 129, 2, 30, 100), (33, 200, 2, 30, 65),
    (40, 70, 3, 8, 70), (40, 70, 3, 16, 50), (40, 70, 3, 32, 70)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, causal, tq, tk, h, hd, kv_len):
    g = _gen(0)
    qkv = torch.randn((2, tk, 3 * h * hd), generator=g).to(cuda, dtype)
    q = torch.randn((2, tq, h, hd), generator=g).to(cuda, dtype)
    k = qkv[..., h * hd:2 * h * hd].view(2, tk, h, hd)   # strided views
    v = qkv[..., 2 * h * hd:].view(2, tk, h, hd)
    # bf16 (even head dims, aligned rows) on its tensor-core kernels, f32 on
    # the TF32 ones, at every head dim up to 128
    want_route = "mma" if dtype == torch.bfloat16 and hd % 2 == 0 else "tf32"
    assert tfa.route(q, k, v) == want_route
    before, routes = tfa.flash_mha.launches, dict(tfa.flash_mha.routes)
    got = tfa.flash_mha(q, k, v, kv_len=kv_len, causal=causal)
    torch.cuda.synchronize()
    assert tfa.flash_mha.launches == before + 1
    assert tfa.flash_mha.routes[want_route] == routes[want_route] + 1
    want = tfa.reference_mha(q, k, v, kv_len=kv_len, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v,t,k", [(16, 1000, 37, 2), (16, 1537, 37, 5),
                                     (1280, 10000, 301, 5), (256, 10000, 301, 2),
                                     # knowledge and news: tails [E | F] of 352 and 402
                                     (1280, 10000, 352, 5), (256, 10000, 352, 2),
                                     (1280, 10000, 402, 5), (256, 10000, 402, 2)])
def test_score_kernel_matches_plain(cuda, dtype, n, v, t, k):
    g = _gen(1)
    h = torch.randn((n, 300), generator=g).to(cuda, dtype)
    wv = ((torch.rand((300, v), generator=g) * 2 - 1) * 0.1).to(cuda, dtype)
    bv = (torch.randn((v,), generator=g) * 0.01).to(cuda)
    tail = torch.randn((n, t), generator=g).to(cuda)
    got = tcs.fused_score_topk(h, wv, bv, tail, k=k)
    want = tcs.reference_score_topk(h, wv, bv, tail, k=k)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)


def test_score_kernel_ties_and_tail(cuda):
    n, d, v, t = 4, 8, 520, 16
    bv = torch.zeros(v)
    bv[3] = bv[400] = 2.0
    tail = torch.zeros((n, t))
    tail[:, 2] = 2.0
    args = [x.to(cuda) for x in (torch.zeros((n, d)), torch.zeros((d, v)), bv, tail)]
    _, idx, _ = tcs.fused_score_topk(*args, k=5)
    assert idx.cpu()[0].tolist() == [3, 400, v + 2, 0, 1]
    tail = torch.full((n, t), -1.0)
    tail[:, 7] = 5.0
    args[3] = tail.to(cuda)
    vals, idx, _ = tcs.fused_score_topk(*args, k=2)
    assert (idx[:, 0] == v + 7).all() and (vals[:, 0] == 5.0).all()


def _score_inputs(cuda, dtype, n, v, t, seed=9):
    g = _gen(seed)
    h = torch.randn((n, 300), generator=g).to(cuda, dtype)
    wv = ((torch.rand((300, v), generator=g) * 2 - 1) * 0.1).to(cuda, dtype)
    bv = (torch.randn((v,), generator=g) * 0.01).to(cuda)
    tail = torch.randn((n, t), generator=g).to(cuda)
    return h, wv, bv, tail


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 301])
@pytest.mark.parametrize("v", [64, 520, 10000, 10001])
@pytest.mark.parametrize("n", [1, 63, 65, 1280])
def test_score_kernel_edges(cuda, dtype, n, v, t):
    """Rows on both sides of the 64-row tile, a vocab of one tile, a ragged
    last tile, one that misses the tensor-core alignment (V = 10001), and
    tails of 1 and 301: indices identical, values and lse within 1e-4.  Both
    dtypes take the tensor cores where V allows 16-byte copies of Wv's rows
    (bf16 V % 8, f32 V % 4: every V here but 10001)."""
    h, wv, bv, tail = _score_inputs(cuda, dtype, n, v, t)
    assert tcs.uses_tensor_cores(h, wv) == (v % (8 if dtype == torch.bfloat16 else 4) == 0)
    before = tcs.fused_score_topk.launches
    got = tcs.fused_score_topk(h, wv, bv, tail, k=5)
    torch.cuda.synchronize()
    assert tcs.fused_score_topk.launches == before + 1
    want = tcs.reference_score_topk(h, wv, bv, tail, k=5)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)


def _hold_wide(got, want, h, wv, bv, tail, n, k):
    """The k > 16 contract: values and lse within 1e-4 of the plain version;
    each returned index distinct and its plain score its value within 1e-4,
    so where an index differs from the plain version's the two entries tie
    within 1e-4 (the kernel's and torch's summation orders may swap such
    near-ties: a few in 65536 entries)."""
    vals, idx, lse = got
    torch.testing.assert_close(vals, want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want[2], rtol=0, atol=1e-4)
    scores = torch.cat([h.float() @ wv.float() + bv, tail], dim=1)
    torch.testing.assert_close(torch.gather(scores, 1, idx.long()), vals, rtol=0, atol=1e-4)
    assert (idx.sort(dim=1).values.diff(dim=1) != 0).all()
    differ = idx != want[1]
    assert int(differ.sum()) <= 4 * n * k // 65536 + 2, int(differ.sum())


@pytest.mark.parametrize("k", [1, 2, 5, 8, 10, 16, 17, 20, 64])
def test_score_kernel_bf16_offset_h_takes_cuda_core_path(cuda, k):
    """A bf16 h that starts one element into its buffer cannot be staged 8
    bytes a copy: it runs a CUDA-core first pass (above k 16 the wide one)
    and agrees with the aligned call's tensor-core first pass and with the
    plain version: indices identical up to k 16, the wide contract above."""
    h, wv, bv, tail = _score_inputs(cuda, torch.bfloat16, 1280, 10000, 301)
    buf = torch.empty(h.numel() + 1, dtype=h.dtype, device=cuda)
    buf[1:].copy_(h.reshape(-1))
    shifted = buf[1:].view(h.shape)
    assert tcs.uses_tensor_cores(h, wv) and not tcs.uses_tensor_cores(shifted, wv)
    want = tcs.reference_score_topk(h, wv, bv, tail, k=k)
    for hh in (h, shifted):
        got = tcs.fused_score_topk(hh, wv, bv, tail, k=k)
        if k > tcs.REGISTER_K:
            _hold_wide(got, want, h, wv, bv, tail, 1280, k)
            continue
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,t,k", [(1, 37, 9), (65, 301, 10), (320, 301, 10), (2560, 301, 10),
                                   (2560, 402, 10), (77, 352, 13), (130, 301, 14),
                                   (4096, 301, 16), (256, 1, 16),
                                   # above 16: lists in shared memory, both dtypes
                                   (640, 301, 17), (1, 37, 17), (320, 402, 32),
                                   (130, 1, 64), (63, 301, 100), (640, 301, 20)])
def test_score_kernel_wide_k(cuda, dtype, n, t, k):
    """Top-k of 9 to 100 (beams wider than 8): the tensor-core kernel's
    lists at K 13 and 14 (where they outgrow its ring at the chunk's end)
    and 16, in both dtypes (f32: three TF32 products a product); above 16
    the wide first pass in both dtypes (bf16 on the tensor cores, f32 on the
    CUDA cores; lists of 64 and 100 entries: one tile and more than one); a
    tail of 1 and k > t.  Values and lse
    within 1e-4 of the plain version; each returned index is distinct and
    its plain score is its value within 1e-4, so where an index differs
    from the plain version's, the two entries tie within 1e-4 (at 4096 rows
    x 16 the kernel's and torch's summation orders swap such near-ties:
    2 of 65536 entries on the card)."""
    h, wv, bv, tail = _score_inputs(cuda, dtype, n, 10000, t, seed=k)
    assert tcs.uses_tensor_cores(h, wv, k) == (dtype == torch.bfloat16 or k <= tcs.REGISTER_K)
    before = tcs.fused_score_topk.launches
    got = tcs.fused_score_topk(h, wv, bv, tail, k=k)
    torch.cuda.synchronize()
    assert tcs.fused_score_topk.launches == before + 1
    _hold_wide(got, tcs.reference_score_topk(h, wv, bv, tail, k=k), h, wv, bv, tail, n, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,t,k", [(10000, 301, 17), (10000, 301, 20), (10000, 301, 32),
                                   (10000, 301, 64), (10000, 301, 100), (10000, 301, 129),
                                   (520, 37, 557), (1000, 301, 1301)])
def test_score_kernel_wide_k_exact_ties(cuda, dtype, v, t, k):
    """The wide first passes on exact ties: every Wv column duplicated once
    further on (columns c and c + V / 2 score the same), and each tail entry
    equal to a vocab score of its row.  Values, indices and lse held exactly
    to the plain version's order: the lower index first, so vocab before
    the tail; k from 17 up to all of [V | tail] (V + T)."""
    n = 70
    g = _gen(k)
    h = (torch.randint(-4, 5, (n, 300), generator=g) / 8).to(cuda, dtype)
    half = (torch.randint(-4, 5, (300, v // 2), generator=g) / 64).to(cuda, dtype)
    wv = torch.cat([half, half], dim=1)
    bv = torch.zeros(v, device=cuda)
    scores = h.float() @ wv.float()
    tail = scores[:, torch.randint(0, v, (t,), generator=g).to(cuda)].contiguous()
    # above k 16: bf16's wide tensor-core pass, f32's wide CUDA-core pass
    assert tcs.uses_tensor_cores(h, wv, k) == (dtype == torch.bfloat16)
    vals, idx, lse = tcs.fused_score_topk(h, wv, bv, tail, k=k)
    want = tcs.reference_score_topk(h, wv, bv, tail, k=k)
    torch.cuda.synchronize()
    assert torch.equal(idx, want[1])
    assert torch.equal(vals, want[0])
    torch.testing.assert_close(lse, want[2], rtol=0, atol=1e-4)


def _decoder_inputs(cuda, dtype, B=4, K=5, L=8, M=37, D=60, H=6, F=48, i=5):
    from icek_torch.models import transformer as tfm

    g = _gen(2)
    layers = tfm.init_decoder_stack(g, 3, D, F)
    for lay in layers["layers"]:   # non-trivial biases and norms
        for mha in (lay["self_attn"], lay["cross_attn"]):
            mha["qkv_b"] = torch.randn(3 * D, generator=g) * 0.1
        for n in (1, 2, 3):
            lay[f"norm{n}"]["scale"] = 1 + 0.1 * torch.randn(D, generator=g)
            lay[f"norm{n}"]["bias"] = 0.1 * torch.randn(D, generator=g)
    layers = {"layers": [{k: _tree_to(v, cuda, dtype) for k, v in lay.items()}
                         for lay in layers["layers"]]}
    stacked = tds.stack_decoder_params(layers, dtype)
    x = torch.randn((B, K, D), generator=g).to(cuda)
    ck = torch.zeros((3, B, L * K, D))
    cv = torch.zeros((3, B, L * K, D))
    ck[:, :, :i * K] = torch.randn((3, B, i * K, D), generator=g)
    cv[:, :, :i * K] = torch.randn((3, B, i * K, D), generator=g)
    xk = torch.randn((3, B, M, D), generator=g)
    xv = torch.randn((3, B, M, D), generator=g)
    anc = torch.randint(0, K, (B, K, L), generator=g, dtype=torch.int32)
    anc[:, :, i:] = torch.arange(K, dtype=torch.int32)[None, :, None]
    to = lambda t: t.to(cuda, dtype).contiguous()
    return stacked, x, anc.to(cuda), to(ck), to(cv), to(xk), to(xv), i, H


def _tree_to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.15)])
@pytest.mark.parametrize("step", [0, 5, 7])
def test_decoder_step_kernel_matches_plain(cuda, dtype, tol, step):
    stacked, x, anc, ck, cv, xk, xv, _, H = _decoder_inputs(cuda, dtype, i=step)
    got = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)


def _route_launches():
    return {r: c.launches for r, c in tds.fused_beam_decoder_step.routes.items()}


def _ran(before):
    """The routes that launched since `before` (_route_launches), with counts."""
    return {r: n - before[r] for r, n in _route_launches().items() if n != before[r]}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.15)])
@pytest.mark.parametrize("K", [9, 10, 16, 17, 23])
def test_decoder_step_wide_beams(cuda, dtype, tol, K):
    """Beams up to 16 in G-image blocks, wider ones on the wide tensor-core
    route: three blocks an image at B 3 (K 17: 6 + 6 + 5 rows, K 23: 8 + 8 +
    7), each with its own ancestry rows into caches of the beam's full
    width; and the same beams through the CUDA-core kernel (weights without
    the packed copy: two or three blocks of up to 8 rows an image)."""
    stacked, x, anc, ck, cv, xk, xv, step, H = _decoder_inputs(cuda, dtype, B=3, K=K, i=4)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    for st in (stacked, stacked._replace(mma=None)):
        tc = st.mma is not None
        assert tds.uses_tensor_cores(st, ck, K, H) == tc and tds.supports(st, ck, K, H)
        before = _route_launches()
        got = tds.fused_beam_decoder_step(st, x, anc, ck, cv, xk, xv, step, num_heads=H)
        torch.cuda.synchronize()
        assert _ran(before) == {tds.route(dtype, K, tc): 1}
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 0.15)])
@pytest.mark.parametrize("M", [1, 16, 17, 497])
@pytest.mark.parametrize("B,K", [(257, 5), (3, 5), (3, 17), (5, 20), (2, 32)])
def test_decoder_step_f32_and_wide_routes_match_plain(cuda, dtype, tol, B, K, M):
    """The f32 route (three TF32 products a product, 16 memory rows a stage)
    and the wide route (K > 16: parts of an image) at the geo widths,
    step 15: G-image blocks with a ragged last group (B 257), beams of 5,
    17, 20, 32, memories of one row, one f32 stage, one row past it and the
    geo 497; against the plain version at the card's tolerances (f32 1e-3,
    bf16 0.15), the route's counter held, two launches bit-identical."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, B, K, 15, M=M, dtype=dtype)
    before = _route_launches()
    runs = [tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None, 15, num_heads=H,
                                        cross_heads=_padded(xk, xv, H)) for _ in range(2)]
    torch.cuda.synchronize()
    assert _ran(before) == {tds.route(dtype, K, True): 2}
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, 15, num_heads=H)
    for a, b, c in zip(*runs, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=tol)


def test_decoder_step_f32_route_holds_1e4_at_geo_widths(cuda):
    """At the geo beam shape's widths (B 8, K 5, M 497, step 15) the f32
    route stays within 1e-4 of the plain f32 version, as the CUDA-core
    kernel did (one TF32 pass would miss by about 2e-3:
    tests/test_torch_decoder_tf32.py)."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 8, 5, 15, dtype=torch.float32)
    got = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, 15, num_heads=H)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, 15, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _geo_step_inputs(cuda, B, K, step, M=497, L=30, seed=4, dtype=torch.bfloat16, D=300, H=10,
                     F=512):
    """The geo decoder's widths (3 layers, D 300, H 10, F 512; or D, H, F
    given, such as --geometry 512x8's 512, 8, 512) in `dtype`."""
    from icek_torch.models import transformer as tfm

    g = _gen(seed)
    layers = tfm.init_decoder_stack(g, 3, D, F)
    for lay in layers["layers"]:
        for mha in (lay["self_attn"], lay["cross_attn"]):
            mha["qkv_b"] = torch.randn(3 * D, generator=g) * 0.1
        for n in (1, 2, 3):
            lay[f"norm{n}"]["scale"] = 1 + 0.1 * torch.randn(D, generator=g)
            lay[f"norm{n}"]["bias"] = 0.1 * torch.randn(D, generator=g)
    layers = {"layers": [_tree_to(lay, cuda, dtype) for lay in layers["layers"]]}
    stacked = tds.stack_decoder_params(layers, dtype)
    x = torch.randn((B, K, D), generator=g).to(cuda)
    caches = torch.zeros((2, 3, B, L * K, D))
    caches[:, :, :, :step * K] = torch.randn((2, 3, B, step * K, D), generator=g)
    ck, cv = (c.to(cuda, dtype).contiguous() for c in caches)
    xk, xv = (torch.randn((3, B, M, D), generator=g).to(cuda, dtype) for _ in range(2))
    anc = torch.randint(0, K, (B, K, L), generator=g, dtype=torch.int32)
    anc[:, :, step:] = torch.arange(K, dtype=torch.int32)[None, :, None]
    return stacked, x, anc.to(cuda), ck, cv, xk, xv, H


def _padded(xk, xv, H):
    nL, B, M, D = xk.shape
    return tds.pad_cross_heads([{"k": xk[l].view(B, M, H, D // H), "v": xv[l].view(B, M, H, D // H)}
                                for l in range(nL)], xk.dtype)


@pytest.mark.parametrize("step", [0, 15, 29])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("B", [1, 3, 257])
def test_decoder_step_tensor_cores_match_plain(cuda, B, K, step):
    """The tensor-core route at the geo widths and M 497 (15 full memory
    tiles and a ragged one): G-image blocks with a ragged last group (B 257),
    one image (B 1), beam widths 1, 5, 8, the first, a middle and the last
    step; bf16 against the plain version at 0.15, with the cross K/V padded
    by the caller (as the beam loop does) and by the wrapper alike."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, B, K, step)
    assert tds.uses_tensor_cores(stacked, ck, K, H)
    before = dict((k, r.launches) for k, r in tds.fused_beam_decoder_step.routes.items())
    got = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None, step, num_heads=H,
                                      cross_heads=_padded(xk, xv, H))
    again = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    torch.cuda.synchronize()
    routes = tds.fused_beam_decoder_step.routes
    assert routes["tensor_cores"].launches == before["tensor_cores"] + 2
    assert routes["cuda_cores"].launches == before["cuda_cores"]
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=0.15)


@pytest.mark.parametrize("D,H,B,M,step", [(512, 8, 256, 497, 15), (512, 8, 3, 17, 29),
                                           (320, 8, 5, 497, 15), (128, 2, 3, 33, 0)])
def test_decoder_step_wide_heads_on_tensor_cores(cuda, D, H, B, M, step):
    """bf16 heads of 33 to 64 dims on the tensor-core route, the cross heads
    padded to 64 and streamed 16 memory rows a stage: --geometry 512x8 at
    the beam shape (B 256, K 5, M 497, step 15) and at a memory of one full
    stage and a row, Hd 40 (D 320), two heads of 64 (D 128) at step 0 and
    M 33; against the plain version at 0.15, two launches bit-identical,
    the CUDA-core kernel not launched."""
    stacked, x, anc, ck, cv, xk, xv, _ = _geo_step_inputs(cuda, B, 5, step, M=M, D=D, H=H)
    assert tds.uses_tensor_cores(stacked, ck, 5, H)
    heads = _padded(xk, xv, H)
    assert heads[0].shape[-1] == 64 * H
    before = _route_launches()
    runs = [tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None, step, num_heads=H,
                                        cross_heads=heads) for _ in range(2)]
    torch.cuda.synchronize()
    assert _ran(before) == {"tensor_cores": 2}
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    for a, b, c in zip(*runs, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=0, atol=0.15)


@pytest.mark.parametrize("B,K,M,step", [(256, 5, 497, 15), (3, 5, 1, 15), (3, 5, 7, 15),
                                         (3, 5, 8, 15), (3, 5, 9, 29), (3, 5, 497, 0),
                                         (5, 20, 497, 15), (4, 1, 497, 15), (3, 1, 9, 29)])
def test_decoder_step_f32_512x8_on_tensor_cores(cuda, B, K, M, step):
    """f32 at --geometry 512x8 on the tensor-core route
    (decoder_step_mma_kernel<float, 64>: the cross heads padded to 64, three
    8-row ring stages, the step's own K/V read back from k_new / v_new): the
    beam shape (B 256, K 5, M 497, step 15), memories of one row, a stage
    less a row, one stage and a stage and a row, the first and the last
    step, K 20 on the wide route (wide_tensor_cores_f32) and K 1; within
    1e-3 of the plain f32 version, two launches bit-identical, the CUDA-core
    kernel not launched."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, B, K, step, M=M,
                                                          dtype=torch.float32, D=512, H=8)
    assert tds.uses_tensor_cores(stacked, ck, K, H)
    assert tds.mma_smem_bytes(512, 8, 512, 30, torch.float32) == 200064
    heads = _padded(xk, xv, H)
    assert heads[0].shape[-1] == 64 * H
    before = _route_launches()
    runs = [tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, None, None, step, num_heads=H,
                                        cross_heads=heads) for _ in range(2)]
    torch.cuda.synchronize()
    assert _ran(before) == {tds.route(torch.float32, K, True): 2}
    assert tds.route(torch.float32, K, True) == ("wide_tensor_cores_f32" if K > 16
                                                 else "tensor_cores_f32")
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    for a, b, c in zip(*runs, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=0, atol=1e-3)


@pytest.mark.parametrize("M", [1, 31, 32, 33, 64, 200])
def test_decoder_step_tensor_cores_memory_lengths(cuda, M):
    """Memories of one row, of one tile less a row, of whole tiles and of a
    ragged tile after whole ones, at B 3, K 5, step 15."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 3, 5, 15, M=M)
    got = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, 15, num_heads=H)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, 15, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=0.15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_step_is_bit_identical_between_launches(cuda, dtype):
    """Both routes at the beam shape (B 256, K 5, step 15): no atomics, so two
    launches give the same bits."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 256, 5, 15)
    if dtype == torch.float32:
        f32 = lambda t: t.float().contiguous()
        stacked = tds.stack_decoder_params({"layers": [_tree_to(lay, cuda, torch.float32)
                                                       for lay in stacked.layers]})
        ck, cv, xk, xv = map(f32, (ck, cv, xk, xv))
    runs = [tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, 15, num_heads=H)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_decoder_step_route_predicate(cuda):
    """The wrapper's shared-memory layout is the kernel's, in both dtypes;
    bf16 at the beam shape takes the tensor-core route, f32 its f32 twin;
    bf16 the tensor-core route refuses (weights without the packed copy, 12
    heads) takes the CUDA-core route, still within 0.15 of the plain
    version; K = 17, wider than the tensor-core tile, the wide route;
    float16 caches raise."""
    import ctypes

    from icek_torch.kernels import _build

    smem = _build.bind("decoder_step", "decoder_step_mma_smem", [ctypes.c_int] * 5)
    for dims in ((300, 10, 512, 30), (300, 10, 512, 40), (60, 6, 48, 8), (40, 4, 64, 6),
                 (512, 8, 512, 30), (320, 8, 512, 30), (128, 2, 96, 6)):
        for f32, dt in ((0, torch.bfloat16), (1, torch.float32)):
            assert smem(*dims, f32) == tds.mma_smem_bytes(*dims, dt)   # the predicate's copy
    routes = tds.fused_beam_decoder_step.routes

    def launches():
        return routes["tensor_cores"].launches, routes["cuda_cores"].launches

    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 4, 5, 3)
    n = launches()
    tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, 3, num_heads=H)
    assert launches() == (n[0] + 1, n[1])
    refused = stacked._replace(mma=None)
    assert not tds.uses_tensor_cores(refused, ck, 5, H)
    n = launches()
    got = tds.fused_beam_decoder_step(refused, x, anc, ck, cv, xk, xv, 3, num_heads=H)
    assert launches() == (n[0], n[1] + 1)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, 3, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=0.15)
    assert not tds.uses_tensor_cores(stacked, ck, 5, 12)
    n = launches()
    got = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, 3, num_heads=12)
    assert launches() == (n[0], n[1] + 1)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, 3, num_heads=12)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=0.15)
    f32 = [_tree_to(lay, cuda, torch.float32) for lay in stacked.layers]
    st32 = tds.stack_decoder_params({"layers": f32})
    args = [t.float().contiguous() for t in (ck, cv, xk, xv)]
    before = _route_launches()
    tds.fused_beam_decoder_step(st32, x, anc, *args, 3, num_heads=H)
    assert _ran(before) == {"tensor_cores_f32": 1}
    big = _geo_step_inputs(cuda, 1, 17, 3, L=4)
    assert tds.uses_tensor_cores(big[0], big[3], 17, H)
    before = _route_launches()
    got = tds.fused_beam_decoder_step(big[0], *big[1:7], 3, num_heads=H)
    assert _ran(before) == {"wide_tensor_cores": 1}
    want = tds.reference_decoder_step(big[0], *big[1:7], 3, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=0.15)
    half = [t.half() for t in big[3:7]]
    with pytest.raises(ValueError):
        tds.fused_beam_decoder_step(big[0], *big[1:3], *half, 3, num_heads=H)


def test_beam_decode_bf16_takes_the_tensor_core_route(cuda):
    """A bf16 beam-5 decode on the card launches the tensor-core decoder step
    once a step: max_len times (<end> is kept out of reach, so no batch ends
    early)."""
    from icek_torch.core import config as cfgs
    from icek_torch.decode import beam, greedy
    from icek_torch.models import captioner

    base = cfgs.georic().model
    cfg = dataclasses.replace(base, emb_dim=40, num_heads=4, decoder_ffn_dim=64,
                              encoder_ffn_dim=64, num_layers=2, type_vocab=20)
    V, E, B, max_len = 60, 9, 3, 10
    g = _gen(5)
    params = captioner.init_captioner_params(g, cfg, V)
    params["fc_vocab"]["b"][V - 1] = -1e4
    params = _tree_to(params, cuda, torch.float32)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    tokens = torch.randn((B, 12, 40), generator=g)
    ctx = greedy.prepare_decode_context(params, cfg, tokens.to(cuda), ents.to(cuda),
                                        compute_dtype=torch.bfloat16)
    routes = tds.fused_beam_decoder_step.routes
    before = (routes["tensor_cores"].launches, routes["cuda_cores"].launches)
    out, _ = beam.beam_decode(params, cfg, V, E, V - 2, V - 1, 0, ctx, max_len, beam_size=5,
                              compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert out.shape == (B, max_len)
    assert routes["tensor_cores"].launches == before[0] + max_len
    assert routes["cuda_cores"].launches == before[1]


def test_beam_decode_kernels_match_stock_on_card(cuda):
    """Small f32 beam decode on the card: the kernel paths give the stock
    path's tokens, and every kernel launched."""
    from icek_torch.core import config as cfgs
    from icek_torch.decode import beam, greedy
    from icek_torch.models import captioner

    base = cfgs.georic().model
    cfg = dataclasses.replace(base, emb_dim=40, num_heads=4, decoder_ffn_dim=64,
                              encoder_ffn_dim=64, num_layers=2, type_vocab=20)
    V, E, B = 60, 9, 3
    g = _gen(3)
    params = _tree_to(captioner.init_captioner_params(g, cfg, V), cuda, torch.float32)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    tokens = torch.randn((B, 12, 40), generator=g)
    counts = (tfa.flash_mha.launches, tcs.fused_score_topk.launches,
              tds.fused_beam_decoder_step.launches)
    ctx = greedy.prepare_decode_context(params, cfg, tokens.to(cuda), ents.to(cuda))
    args = (params, cfg, V, E, V - 2, V - 1, 0, ctx, 10)
    got = beam.beam_decode(*args, beam_size=5)
    want = beam.beam_decode(*args, beam_size=5, use_megakernel=False,
                            use_fused_scores=False)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)
    after = (tfa.flash_mha.launches, tcs.fused_score_topk.launches,
             tds.fused_beam_decoder_step.launches)
    assert after[0] == counts[0] + cfg.num_layers   # the context encoder
    assert after[1] > counts[1] and after[2] > counts[2]


# ---------------------------------------------------------------------------
# training kernels: each against its plain version under the kernel's own mask
# ---------------------------------------------------------------------------

def _philox4x32_10(counter, key):
    """Philox-4x32-10 on Python ints (Salmon et al., SC'11)."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return c


def test_philox_known_answers(cuda):
    """The host model reproduces Random123's published vectors, and the
    device function equals the host model word for word."""
    from icek_torch.kernels import fused_norm as tfn

    assert _philox4x32_10([0, 0, 0, 0], [0, 0]) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox4x32_10([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    for seed, stream in ((0, 0), (12345, 2), (2 ** 31 - 2, 1)):
        got = tfn.philox_bits(64, seed=seed, stream_id=stream, device=cuda).cpu().tolist()
        want = [w for blk in range(16)
                for w in _philox4x32_10([blk, 0, 0, 0], [seed, stream])]
        assert got == want


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_keep_masks_rate_and_seed(cuda, rate):
    from icek_torch.kernels import fused_norm as tfn

    m = tfn.keep_mask(2000, 300, rate=rate, seed=3, device=cuda)
    assert abs(float(m.float().mean()) - (1 - rate)) < 0.005
    assert torch.equal(m, tfn.keep_mask(2000, 300, rate=rate, seed=3, device=cuda))
    assert not torch.equal(m, tfn.keep_mask(2000, 300, rate=rate, seed=4, device=cuda))
    # a row's mask does not depend on how many rows there are
    assert torch.equal(m[:7], tfn.keep_mask(7, 300, rate=rate, seed=3, device=cuda))
    f = tfa.keep_mask(4, 10, 64, 301, rate=rate, seed=3, device=cuda)
    assert abs(float(f.float().mean()) - (1 - rate)) < 0.005
    # a score's mask does not depend on the batch size
    assert torch.equal(f[:2], tfa.keep_mask(2, 10, 64, 301, rate=rate, seed=3,
                                            device=cuda))
    assert tfn.keep_mask(5, 30, rate=0.0, seed=1, device=cuda).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n,d", [(530, 36), (64, 300), (77, 511), (9, 1024),
                                 (26112, 300), (13312, 300),    # knowledge / news B x T
                                 (8192, 300), (13056, 300),     # geo decoder, knowledge facts
                                 (1031, 300), (130, 301), (13, 512),
                                 (25857, 300)])                 # odd, on the span kernel
def test_dropout_add_ln_kernel_matches_plain(cuda, dtype, tol, rate, n, d):
    """Forward and all four gradients against the plain version under the
    kernel's own mask.  f32: 1e-4 on values of order 1 (dscale / dbias: 1e-4
    x sqrt(rows), sums over the rows in another order); bf16: one bf16 ulp of
    the outputs, 3e-2."""
    from icek_torch.kernels import fused_norm as tfn

    g = _gen(4)
    x, h, gy = (torch.randn((n, d), generator=g).to(cuda, dtype) for _ in range(3))
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(cuda)
    bias = (0.1 * torch.randn(d, generator=g)).to(cuda)
    keep = tfn.keep_mask(n, d, rate=rate, seed=21, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, h, scale, bias)]
    before = (tfn.dropout_add_ln.launches, tfn.dropout_add_ln_bwd.launches)
    got = tfn.dropout_add_ln(*leaves, rate=rate, seed=21)
    ggrads = torch.autograd.grad(got, leaves, gy)
    torch.cuda.synchronize()
    assert (tfn.dropout_add_ln.launches, tfn.dropout_add_ln_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = [t.clone().requires_grad_(True) for t in (x, h, scale, bias)]
    want = tfn.reference_dropout_add_ln(*ref, rate=rate, keep=keep)
    wgrads = torch.autograd.grad(want, ref, gy)
    assert got.dtype == dtype and ggrads[2].shape == (d,)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    for i, (a, b) in enumerate(zip(ggrads, wgrads)):
        atol = tol * (4 if i < 2 else max(1.0, n ** 0.5))
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=atol)
    if rate:
        assert not ggrads[1][~keep].any()       # dh is zero exactly where h dropped


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,d", [(9001, 300), (1, 300), (9001, 36), (3, 36)])
def test_dropout_add_ln_backward_odd_rows_matches_plain(cuda, dtype, tol, n, d):
    """An odd row count leaves the last row's half-warp team (bf16, D <= 320)
    without a partner row: the same checks as the test above, rate 0.2."""
    test_dropout_add_ln_kernel_matches_plain(cuda, dtype, tol, 0.2, n, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(9000, 36), (9000, 300), (5000, 511), (3000, 1024),
                                 (9000, 302), (9001, 300), (1, 300), (9001, 36)])
def test_dropout_add_ln_backward_is_bit_identical_between_launches(cuda, dtype, n, d):
    """No atomics: two backward launches on the same inputs give the same
    bits in dx, dh, dscale and dbias, with more rows than the persistent
    grid has teams (D = 302 takes the unvectorised loads; odd row counts
    leave a half-warp team without a partner row)."""
    from icek_torch.kernels import fused_norm as tfn

    g = _gen(14)
    x, h, gy = (torch.randn((n, d), generator=g).to(cuda, dtype) for _ in range(3))
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(cuda)
    bias = (0.1 * torch.randn(d, generator=g)).to(cuda)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (x, h, scale, bias)]
        out = tfn.dropout_add_ln(*leaves, rate=0.2, seed=17)
        runs.append(torch.autograd.grad(out, leaves, gy))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(300, 512), (33, 37), (5, 2050), (26112, 512),
                                 (13312, 512), (8192, 512), (13056, 512), (1031, 300),
                                 (13, 300), (130, 301)])
def test_hw_dropout_kernel_matches_plain(cuda, dtype, n, d):
    from icek_torch.kernels import fused_norm as tfn

    g = _gen(5)
    h = torch.randn((n, d), generator=g).to(cuda, dtype).requires_grad_(True)
    gy = torch.randn((n, d), generator=g).to(cuda, dtype)
    keep = tfn.keep_mask(n, d, rate=0.2, seed=8, device=cuda)
    before = tfn.hw_dropout.launches
    y = tfn.hw_dropout(h, rate=0.2, seed=8)
    (dh,) = torch.autograd.grad(y, h, gy)
    torch.cuda.synchronize()
    assert tfn.hw_dropout.launches == before + 2       # forward and backward
    tol = 0 if dtype == torch.float32 else 2e-2        # x / 0.8 against x * 1.25, rounded
    torch.testing.assert_close(y.float(), tfn.reference_hw_dropout(
        h.detach(), rate=0.2, keep=keep).float(), rtol=1e-6, atol=tol)
    torch.testing.assert_close(dh.float(), tfn.reference_hw_dropout(
        gy, rate=0.2, keep=keep).float(), rtol=1e-6, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8192, 13056, 13312, 13313, 25856, 25857])
def test_norm_kernels_masks_at_train_step_rows(cuda, dtype, n):
    """At the train steps' row counts (and odd ones; on the H100 bf16 takes
    the row forward up to 13313 rows and the span forward from 25856): the LayerNorm
    forward drops h exactly where its backward's dh is zero and where
    keep_mask drops; the dropout's forward and backward zero exactly the
    keep_mask's drops; each keep rate within 0.005 of 0.8."""
    from icek_torch.kernels import fused_norm as tfn

    g = _gen(31)
    x, h, gy = (torch.randn((n, 300), generator=g).to(cuda, dtype) for _ in range(3))
    x, h = (torch.where(t == 0, torch.ones_like(t), t) for t in (x, h))
    scale = (1 + 0.1 * torch.randn(300, generator=g)).to(cuda)
    bias = (0.1 * torch.randn(300, generator=g)).to(cuda)
    keep = tfn.keep_mask(n, 300, rate=0.2, seed=41, device=cuda)
    assert abs(float(keep.float().mean()) - 0.8) <= 0.005
    leaves = [t.clone().requires_grad_(True) for t in (x, h, scale, bias)]
    y = tfn.dropout_add_ln(*leaves, rate=0.2, seed=41)
    dh = torch.autograd.grad(y, leaves[1], gy)[0]
    # y with h's dropped entries set to anything is the same y
    h2 = torch.where(keep, h, torch.full_like(h, 7.0))
    y2 = tfn.dropout_add_ln(x, h2, scale, bias, rate=0.2, seed=41)
    torch.cuda.synchronize()
    assert torch.equal(y.detach(), y2)
    assert torch.equal(dh != 0, keep)
    # randn draws an exact 0 about once in 2^24 values: none here, so an
    # output is 0 exactly where the mask drops
    nonzero = lambda t: torch.where(t == 0, torch.ones_like(t), t)
    hf = nonzero(torch.randn((n, 512), generator=g)).to(cuda, dtype).requires_grad_(True)
    gf = nonzero(torch.randn((n, 512), generator=g)).to(cuda, dtype)
    kf = tfn.keep_mask(n, 512, rate=0.2, seed=42, device=cuda)
    out = tfn.hw_dropout(hf, rate=0.2, seed=42)
    (dhf,) = torch.autograd.grad(out, hf, gf)
    torch.cuda.synchronize()
    assert torch.equal(out != 0, kf) and torch.equal(dhf != 0, kf)
    assert abs(float(kf.float().mean()) - 0.8) <= 0.005


def test_wrappers_launch_on_the_current_stream(cuda):
    """_build.stream_of reads the current stream's handle, on the default
    stream and inside a side stream, as torch.cuda.current_stream does; a
    kernel launched there is ordered with that stream's work."""
    from icek_torch.kernels import _build
    from icek_torch.kernels import fused_norm as tfn

    t = torch.zeros(4, device=cuda)
    assert _build.stream_of(t) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    h = torch.randn((4096, 512), device=cuda)
    with torch.cuda.stream(side):
        assert _build.stream_of(t) == side.cuda_stream
        h2 = h * 2                                   # queued on the side stream
        out = tfn.hw_dropout(h2, rate=0.2, seed=5)
    side.synchronize()
    keep = tfn.keep_mask(4096, 512, rate=0.2, seed=5, device=cuda)
    torch.testing.assert_close(out, tfn.reference_hw_dropout(h * 2, rate=0.2, keep=keep),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_kernels_take_misaligned_rows(cuda, dtype):
    """x, h and the dropout's input as views one row of 300 values into their
    buffers (bf16: 600 bytes, so 8- but not 16-byte aligned; they take the
    row kernels): the same results as aligned copies, under one mask."""
    from icek_torch.kernels import fused_norm as tfn

    n, d = 4097, 300
    g = _gen(32)
    bufs = [torch.randn((n + 1, d), generator=g).to(cuda, dtype) for _ in range(2)]
    x, h = (b[1:] for b in bufs)
    assert x.data_ptr() % 16 == (8 if dtype == torch.bfloat16 else 0)
    scale = (1 + 0.1 * torch.randn(d, generator=g)).to(cuda)
    bias = (0.1 * torch.randn(d, generator=g)).to(cuda)
    keep = tfn.keep_mask(n, d, rate=0.2, seed=43, device=cuda)
    want = tfn.reference_dropout_add_ln(x, h, scale, bias, rate=0.2, keep=keep)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in ((x, h), (x.clone(), h.clone())):
        got = tfn.dropout_add_ln(a, b, scale, bias, rate=0.2, seed=43)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    for hh in (h, h.clone()):
        got = tfn.hw_dropout(hh, rate=0.2, seed=43)
        torch.testing.assert_close(got.float(), tfn.reference_hw_dropout(
            h, rate=0.2, keep=keep).float(), rtol=1e-6, atol=0 if tol == 1e-4 else 2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal,tq,tk,h,kv_len,hd", [
    (False, 17, 17, 3, 17, 30), (True, 32, 32, 10, 32, 30), (False, 32, 497, 10, 497, 30),
    (False, 13, 37, 3, 30, 30), (True, 70, 70, 2, 70, 30), (False, 301, 301, 2, 301, 30),
    # the edges of the 16-row, 8-key and 64-row tiles of the tensor-core path
    (False, 1, 1, 2, 1, 30), (False, 15, 17, 3, 17, 30), (True, 16, 16, 2, 16, 30),
    (False, 65, 129, 3, 129, 30), (True, 65, 129, 3, 100, 30), (False, 301, 497, 2, 497, 30),
    (False, 33, 200, 2, 65, 30), (True, 129, 65, 2, 40, 30),
    (False, 40, 70, 3, 70, 8), (True, 40, 70, 3, 50, 16), (False, 40, 70, 3, 70, 32),
    # the knowledge / news sites: fact encoders (51 is less than one 64-row
    # tile), entity encoder 101, decoder self 102 / 52 causal, cross 548 / 598
    (False, 51, 51, 10, 51, 30), (False, 101, 101, 10, 101, 30),
    (True, 102, 102, 10, 102, 30), (False, 102, 548, 10, 548, 30),
    (True, 52, 52, 10, 52, 30), (False, 52, 598, 10, 598, 30),
    # padded head dim 64 (bf16 on the wgmma pair): its tile edges, and head
    # dims whose rows are staged 4 bytes a copy (34, 62: not 16-byte rows)
    (False, 1, 1, 2, 1, 64), (True, 129, 65, 2, 40, 64), (False, 65, 129, 3, 129, 34),
    (True, 70, 70, 2, 70, 62), (False, 301, 497, 2, 497, 48)])
def test_flash_backward_kernel_matches_plain(cuda, dtype, tol, rate, causal, tq, tk,
                                             h, kv_len, hd):
    """Forward with dropout and dq / dk / dv against the plain version under
    the kernel's own mask, on strided views of one fused projection and a
    non-contiguous d_out.  f32 1e-4, bf16 4e-2 (sums of bf16-rounded
    products), both times the largest expected value where that exceeds 1.  Keys at or beyond kv_len get exactly 0."""
    B = 2
    g = _gen(6)
    qkv = torch.randn((B, tk, 3 * h * hd), generator=g).to(cuda, dtype).requires_grad_(True)
    q0 = torch.randn((B, tq, h * hd), generator=g).to(cuda, dtype).requires_grad_(True)
    d_out = torch.randn((B, h, tq, hd), generator=g).to(cuda, dtype).transpose(1, 2)

    def run(fn, **kw):
        q = q0.view(B, tq, h, hd)
        k = qkv[..., h * hd:2 * h * hd].view(B, tk, h, hd)
        v = qkv[..., 2 * h * hd:].view(B, tk, h, hd)
        out = fn(q, k, v, kv_len=kv_len, causal=causal, dropout_rate=rate, **kw)
        return (out,) + torch.autograd.grad(out, (q0, qkv), d_out)

    before = (tfa.flash_mha.launches, tfa.flash_mha_bwd.launches)
    got = run(tfa.flash_mha, seed=31)
    torch.cuda.synchronize()
    assert (tfa.flash_mha.launches, tfa.flash_mha_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    keep = tfa.keep_mask(B, h, tq, tk, rate=rate, seed=31, device=cuda)
    want = run(tfa.reference_mha, keep=keep)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * max(1.0, float(b.detach().abs().max())))
    dkv = got[2].view(B, tk, 3, h * hd)
    assert not dkv[:, kv_len:, 1:].any() and not dkv[:, :, 0].any()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [8, 16, 30, 32])
def test_flash_f32_backward_tf32_route(cuda, hd, causal, rate):
    """The f32 backward's 3xTF32 kernels at every head dim they take a step
    of 8 of (8, 16, 30 with its pad, 32), causal or not, keys past kv_len,
    rate 0 and 0.2, on strided views of one fused QKV projection: dq, dk, dv
    within 1e-4 of the plain version under the kernel's own mask (one TF32
    pass is off by 3e-4 to 8e-4 at such sites), padded keys exactly 0."""
    B, tq, tk, h, kv_len = 2, 70, 129, 3, 100
    g = _gen(hd)
    qkv = torch.randn((B, tk, 3 * h * hd), generator=g).to(cuda).requires_grad_(True)
    q0 = torch.randn((B, tq, h * hd), generator=g).to(cuda).requires_grad_(True)
    d_out = torch.randn((B, tq, h, hd), generator=g).to(cuda)

    def run(fn, **kw):
        k = qkv[..., h * hd:2 * h * hd].view(B, tk, h, hd)
        v = qkv[..., 2 * h * hd:].view(B, tk, h, hd)
        out = fn(q0.view(B, tq, h, hd), k, v, kv_len=kv_len, causal=causal, dropout_rate=rate,
                 **kw)
        return torch.autograd.grad(out, (q0, qkv), d_out)

    before = tfa.flash_mha_bwd.launches
    got = run(tfa.flash_mha, seed=3)
    torch.cuda.synchronize()
    assert tfa.flash_mha_bwd.launches == before + 1
    want = run(tfa.reference_mha, keep=tfa.keep_mask(B, h, tq, tk, rate=rate, seed=3,
                                                     device=cuda))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, float(b.abs().max())))
    dkv = got[1].view(B, tk, 3, h * hd)
    assert not dkv[:, kv_len:, 1:].any()


# the attention sites of the geo, knowledge and news paths: (Tq, Tk, causal)
FLASH_PATH_SITES = [(301, 301, False), (32, 32, True), (32, 497, False),       # geo
                    (51, 51, False), (102, 102, True), (102, 548, False),      # knowledge
                    (101, 101, False), (52, 52, True), (52, 598, False)]       # news


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("tq,tk,causal", FLASH_PATH_SITES)
def test_flash_f32_forward_tf32_route(cuda, tq, tk, causal, rate):
    """The TF32 forward at every attention site of the three presets (B 4,
    10 heads of 30, q, k, v strided views of fused projections): within 1e-4
    of the plain version (of the largest value where that exceeds 1) at
    rate 0 and at rate 0.2 under the mask keep_mask exports, on the tf32
    route; the CUDA-core forward it replaced (reached through its entry)
    agrees too."""
    B, H, Hd = 4, 10, 30
    g = _gen(tq + tk)
    if tq == tk:
        q, k, v = (t.view(B, tk, H, Hd) for t in
                   torch.randn((B, tk, 3 * H * Hd), generator=g).to(cuda).split(H * Hd, dim=-1))
    else:
        q = torch.randn((B, tq, H, Hd), generator=g).to(cuda)
        k, v = (t.view(B, tk, H, Hd) for t in
                torch.randn((B, tk, 2 * H * Hd), generator=g).to(cuda).split(H * Hd, dim=-1))
    assert tfa.route(q, k, v) == "tf32"
    keep = tfa.keep_mask(B, H, tq, tk, rate=rate, seed=9, device=cuda) if rate else None
    want = tfa.reference_mha(q, k, v, causal=causal, dropout_rate=rate, keep=keep)
    before = tfa.flash_mha.routes["tf32"]
    got = tfa.flash_mha(q, k, v, causal=causal, dropout_rate=rate, seed=9)
    cores = tfa._forward(q, k, v, tk, causal, rate, 9, via="cuda_cores")[0]
    torch.cuda.synchronize()
    assert tfa.flash_mha.routes["tf32"] == before + 1
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(cores, want, rtol=0, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,hd", [(17, 17, 30), (65, 129, 30), (301, 301, 30), (40, 70, 31),
                                      (33, 200, 8)])
def test_flash_bf16_tf32_forward_matches_plain(cuda, causal, tq, tk, hd):
    """Misaligned (or odd-Hd) bf16 on the TF32 forward: one exact TF32 pass,
    within the bf16 tolerance (3e-2) of the plain version."""
    g = _gen(tq * tk + hd)
    q, k, v = (_odd_offset_view(torch.randn((2, t, 3, hd), generator=g).to(cuda, torch.bfloat16))
               for t in (tq, tk, tk))
    assert tfa.route(q, k, v) == "tf32"
    got = tfa.flash_mha(q, k, v, causal=causal)
    want = tfa.reference_mha(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)


def test_flash_tf32_one_hot_rows(cuda):
    """Logits in the hundreds (a decoder's first self-attention at init):
    softmax is one-hot, the TF32 forward returns the winning key's V row to
    2^-21 and the backward's dQ of those rows is 0 to the plain version's
    1e-4 (its P, from the same scores, is the forward's)."""
    B, T, H, Hd = 2, 64, 2, 30
    g = _gen(77)
    q = (torch.randn((B, T, H, Hd), generator=g) * 20).to(cuda).requires_grad_(True)
    k = (torch.randn((B, T, H, Hd), generator=g) * 20).to(cuda).requires_grad_(True)
    v = torch.randn((B, T, H, Hd), generator=g).to(cuda).requires_grad_(True)
    gy = torch.randn((B, T, H, Hd), generator=g).to(cuda)
    outs = []
    for fn in (tfa.flash_mha, tfa.reference_mha):
        out = fn(q, k, v)
        outs.append((out,) + torch.autograd.grad(out, (q, k, v), gy))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("k", [1, 2, 5, 10, 16])
@pytest.mark.parametrize("n,t,p", [(1280, 301, 0), (256, 301, 0), (1280, 352, 3000),
                                   (256, 402, 3500)])
def test_score_kernel_f32_tensor_core_route(cuda, n, t, p, k):
    """The f32 tensor-core first pass (three TF32 products a product) at the
    geo beam and greedy shapes and the fact presets' tails (h modulated by
    the predicate projection), k 1 to 16, on the tensor_cores route; an h
    that starts 4 bytes into its buffer misses the 16-byte alignment and
    takes the CUDA-core pass.  Values and lse within 1e-4 of the plain
    version; indices identical to it except where two entries tie closer
    than f32 arithmetic can order them: there the two entries' exact
    (float64) scores agree within 1e-5.  On an H100 the plain version's
    values lie up to 4e-6 from float64's and the 3xTF32 pass's up to 2e-6,
    so pairs closer than about 6e-6 may come out in either order.  Seed
    1285 plants one: row 871's best two, columns 7071 and 3862, 1.18e-6
    apart, which the plain version (and the CUDA-core pass, whose sums
    are the plain version's) ranks the wrong way round and the 3xTF32 pass
    the right way; seed 1290 another, 3.8e-6 apart."""
    h, wv, bv, tail = _score_inputs(cuda, torch.float32, n, 10000, t, seed=n + k)
    if p:
        g = _gen(p)
        ind = (torch.rand((n, p), generator=g) < 0.01).float()
        w = (torch.rand((p, 300), generator=g) * 2 - 1) * 0.1
        h = h * (ind @ w + torch.randn((300,), generator=g)).to(cuda)
    want = tcs.reference_score_topk(h, wv, bv, tail, k=k)
    exact = _exact_scores(h, wv, bv, tail)
    for hh, route in ((h, "tensor_cores"), (_odd_offset_view(h), "cuda_cores")):
        assert tcs.route(hh.dtype, k, tcs.aligned(hh, wv)) == route
        before = tcs.fused_score_topk.routes[route]
        got = tcs.fused_score_topk(hh, wv, bv, tail, k=k)
        torch.cuda.synchronize()
        assert tcs.fused_score_topk.routes[route] == before + 1
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)
        _hold_near_ties(got[1], want[1], exact)


def _exact_scores(h, wv, bv, tail):
    """[h Wv + bv | tail] in float64."""
    return torch.cat([h.double() @ wv.double() + bv.double(), tail.double()], dim=1)


def _hold_near_ties(idx, want_idx, exact, tie=1e-5):
    """Indices equal, or where they differ, their exact scores within `tie`
    of each other (rank by rank), each row's indices distinct."""
    differ = idx != want_idx
    gap = (exact.gather(1, idx.long()) - exact.gather(1, want_idx.long())).abs()
    assert float(gap.max()) <= tie, [(r, c, int(idx[r, c]), int(want_idx[r, c]), float(gap[r, c]))
                                     for r, c in differ.nonzero().tolist()]
    assert (idx.sort(dim=1).values.diff(dim=1) != 0).all()
    assert int(differ.sum()) <= 2 + idx.numel() // 2000, int(differ.sum())


def test_score_kernel_f32_tensor_core_exact_ties(cuda):
    """Exact ties through the f32 tensor-core pass (values exact in TF32, so
    three TF32 products are exact): the lower index first, vocab before the
    tail, at k 16."""
    n, v, t, k = 70, 10000, 301, 16
    g = _gen(5)
    h = (torch.randint(-4, 5, (n, 300), generator=g) / 8).to(cuda)
    half = (torch.randint(-4, 5, (300, v // 2), generator=g) / 64).to(cuda)
    wv = torch.cat([half, half], dim=1)
    bv = torch.zeros(v, device=cuda)
    scores = h @ wv
    tail = scores[:, torch.randint(0, v, (t,), generator=g).to(cuda)].contiguous()
    assert tcs.uses_tensor_cores(h, wv, k)
    vals, idx, lse = tcs.fused_score_topk(h, wv, bv, tail, k=k)
    want = tcs.reference_score_topk(h, wv, bv, tail, k=k)
    torch.cuda.synchronize()
    assert torch.equal(idx, want[1]) and torch.equal(vals, want[0])
    torch.testing.assert_close(lse, want[2], rtol=0, atol=1e-4)


def _odd_offset_view(t):
    """The same values in a buffer that starts one element later."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_bf16_odd_offset_takes_cuda_core_path(cuda, rate):
    """bf16 inputs whose head rows start mid-word cannot be moved as 32-bit
    words: they run the TF32 forward and backward (one pass: bf16 is exact
    in TF32) and agree with the aligned call's tensor-core kernels (forward
    3e-2, backward 4e-2 of the largest value) under the same mask."""
    B, Tq, Tk, H, Hd = 2, 40, 70, 3, 30
    g = _gen(11)
    q, k, v, gy = (torch.randn((B, t, H, Hd), generator=g).to(cuda, torch.bfloat16)
                   for t in (Tq, Tk, Tk, Tq))
    res = []
    for shift in (False, True):
        leaves = [(_odd_offset_view(t) if shift else t.clone()).requires_grad_(True)
                  for t in (q, k, v)]
        assert tfa.route(*leaves) == ("tf32" if shift else "mma")
        assert (leaves[0].data_ptr() % 4 == 2) == shift
        out = tfa.flash_mha(*leaves, dropout_rate=rate, seed=5)
        res.append((out,) + torch.autograd.grad(out, leaves, gy))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*res)):
        a, b = a.detach().float(), b.detach().float()
        tol = (3e-2 if i == 0 else 4e-2) * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("hd,H", [(30, 10), (40, 8), (64, 8), (96, 4), (128, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,tk", [(False, 301, 301), (True, 32, 32), (False, 32, 497)])
def test_flash_backward_is_bit_identical_between_launches(cuda, dtype, causal, tq, tk, hd, H):
    """No atomics: two backward launches on the same inputs give the same
    bits in dq, dk and dv, and so do two forward launches in the output; at
    head dims 40 to 128 too (HDP 64 and 128: the wgmma pair in bf16, the
    TF32 pair split by integer rounding in f32)."""
    B, Hd = 4, hd
    g = _gen(12)
    q, k, v, gy = (torch.randn((B, t, H, Hd), generator=g).to(cuda, dtype)
                   for t in (tq, tk, tk, tq))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tfa.flash_mha(*leaves, causal=causal, dropout_rate=0.2, seed=13)
        runs.append((out,) + torch.autograd.grad(out, leaves, gy))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_dropout_forward_and_backward_see_one_mask(cuda):
    """The output is linear in v for a fixed mask, so <f(v), g> == <v, df/dv(g)>
    holds iff the forward and the dK/dV kernel saw the same mask; and the
    dropped share of the weights is the rate."""
    B, Tq, Tk, H, Hd, rate = 2, 32, 301, 10, 30, 0.3
    g = _gen(7)
    q, k, v, gy = (torch.randn((B, t, H, Hd), generator=g).to(cuda)
                   for t in (Tq, Tk, Tk, Tq))
    v.requires_grad_(True)
    out = tfa.flash_mha(q, k, v, dropout_rate=rate, seed=7)
    (dv,) = torch.autograd.grad(out, v, gy)
    torch.testing.assert_close((out * gy).sum(), (v * dv).sum(), rtol=1e-4, atol=1e-3)
    # the weights of one head, read through a (120 x 120) basis as v, 30 columns a call
    Tk = 120
    basis = torch.eye(Tk, device=cuda)[None, :, None, :].expand(B, Tk, 1, Tk)
    p = torch.cat([tfa.flash_mha(q[:, :, :1], k[:, :Tk, :1], basis[..., c:c + 30].contiguous(),
                                 dropout_rate=rate, seed=7) for c in range(0, Tk, 30)], -1)
    assert abs(float((p == 0).float().mean()) - rate) < 0.01


def test_flash_refuses_wide_heads_with_dropout_or_backward(cuda):
    """Head dims up to 128 run forward and backward with dropout (fault
    F4: 64 used to raise with dropout and in the backward); above 128, as
    the JAX package's head_slot, it raises."""
    q = torch.randn((1, 8, 2, 64), device=cuda, requires_grad=True)
    out = tfa.flash_mha(q, q, q, dropout_rate=0.1, seed=1)
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert torch.isfinite(dq).all()
    wide = torch.randn((1, 8, 2, 129), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head dim 129"):
        tfa.flash_mha(wide, wide, wide, dropout_rate=0.1, seed=1)
    with pytest.raises(ValueError, match="head dim 129"):
        tfa.flash_mha(wide, wide, wide)


# fault F4: head dims in (32, 128] used to raise on the card with dropout and
# in the backward; (Hd, dtype, misaligned rows, Tq, Tk) -> route; at head
# dims 40 and 64 (HDP 64's redesigned backward) also the 512x8 model's three
# sites, T 301, 32 and 32 x 497
_WIDE_DTYPES = ((torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True))
WIDE_HD_CASES = ([(hd, dt, shift, 70, 129) for hd in (40, 64, 75, 96, 128)
                  for dt, shift in _WIDE_DTYPES]
                 + [(hd, dt, shift, tq, tk) for hd in (40, 64) for dt, shift in _WIDE_DTYPES
                    for tq, tk in ((301, 301), (32, 32), (32, 497))])


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd,dtype,shift,tq,tk", WIDE_HD_CASES)
def test_flash_wide_heads_forward_backward_with_dropout(cuda, hd, dtype, shift, tq, tk, causal,
                                                        rate):
    """Head dims 40, 64, 75, 96 and 128 (padded to 64 or 128), forward and
    backward at rate 0 and 0.2 under the kernel's own mask, on strided views
    of fused projections, keys past kv_len (where Tk exceeds 100): f32
    within 1e-4, bf16 3e-2 forward and 4e-2 backward of the largest
    expected value; even-Hd aligned bf16 on the mma route (the wgmma
    backward at HDP 64), the rest (f32, odd Hd, rows that start mid-word)
    on tf32; padded keys' gradients exactly 0."""
    B, h, kv_len = 2, 3, min(tk, 100)
    g = _gen(hd + 7 * shift)
    qkv = torch.randn((B, tk, 3 * h * hd), generator=g).to(cuda, dtype)
    q0 = torch.randn((B, tq, h * hd), generator=g).to(cuda, dtype)
    if shift:
        qkv, q0 = _odd_offset_view(qkv), _odd_offset_view(q0)
    qkv.requires_grad_(True)
    q0.requires_grad_(True)
    d_out = torch.randn((B, tq, h, hd), generator=g).to(cuda, dtype)

    def run(fn, **kw):
        k = qkv[..., h * hd:2 * h * hd].view(B, tk, h, hd)
        v = qkv[..., 2 * h * hd:].view(B, tk, h, hd)
        out = fn(q0.view(B, tq, h, hd), k, v, kv_len=kv_len, causal=causal, dropout_rate=rate,
                 **kw)
        return (out,) + torch.autograd.grad(out, (q0, qkv), d_out)

    want_route = "mma" if dtype == torch.bfloat16 and hd % 2 == 0 and not shift else "tf32"
    assert tfa.route(q0.view(B, tq, h, hd), qkv[..., :h * hd].view(B, tk, h, hd),
                     qkv[..., :h * hd].view(B, tk, h, hd)) == want_route
    before = (dict(tfa.flash_mha.routes), tfa.flash_mha_bwd.launches)
    got = run(tfa.flash_mha, seed=17)
    torch.cuda.synchronize()
    assert tfa.flash_mha.routes[want_route] == before[0][want_route] + 1
    assert tfa.flash_mha.routes["cuda_cores"] == before[0]["cuda_cores"]
    assert tfa.flash_mha_bwd.launches == before[1] + 1
    want = run(tfa.reference_mha, keep=tfa.keep_mask(B, h, tq, tk, rate=rate, seed=17,
                                                     device=cuda))
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 if dtype == torch.float32 else (3e-2 if i == 0 else 4e-2)
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * max(1.0, float(b.detach().float().abs().max())))
    dkv = got[2].view(B, tk, 3, h * hd)
    assert not dkv[:, kv_len:, 1:].any()


@pytest.mark.parametrize("hd", [40, 64, 128])
def test_flash_tf32_one_hot_rows_wide_heads(cuda, hd):
    """The one-hot rows at head dims 40, 64 and 128: the TF32 forward's P and
    its backward's P come from bit-equal scores (first_product over the
    d-steps of SplitRows), so dQ of the one-hot rows is 0 and the output is
    the winning V row, within 1e-4 of the plain version in float64.  (The
    plain version in f32 is itself 1.1e-4 off at one element here at Hd 64:
    its softmax backward's row sum is rounded along another path than its
    dP.)"""
    B, T, H = 2, 64, 2
    g = _gen(78 + hd)
    q = (torch.randn((B, T, H, hd), generator=g) * 20).to(cuda).requires_grad_(True)
    k = (torch.randn((B, T, H, hd), generator=g) * 20).to(cuda).requires_grad_(True)
    v = torch.randn((B, T, H, hd), generator=g).to(cuda).requires_grad_(True)
    gy = torch.randn((B, T, H, hd), generator=g).to(cuda)
    out = tfa.flash_mha(q, k, v)
    got = (out,) + torch.autograd.grad(out, (q, k, v), gy)
    leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    ref = tfa.reference_mha(*leaves)
    want = (ref,) + torch.autograd.grad(ref, leaves, gy.double())
    for a, b in zip(got, want):
        b = b.detach().float()
        torch.testing.assert_close(a.detach(), b, rtol=0,
                                   atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_by_head_dim(cuda, dtype):
    """The backward's kernels, by name in a profiler trace: at head dim 30
    (HDP 32, the presets' path) the unchanged instantiations (bf16: the
    mma.sync pair at <32, ...>; f32: the TF32 pair at <float, 32, ...>), at
    head dim 64 the wgmma pair at <64, ...> (f32: the TF32 pair at <float,
    64, ...>), at 96 the wgmma pair at <128, ...> (f32: <float, 128, ...>),
    not the mma.sync pair it replaced there."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for hd in (30, 64, 96):
        g = _gen(hd)
        q, k, v, gy = (torch.randn((2, 70, 2, hd), generator=g).to(cuda, dtype) for _ in range(4))
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        out = tfa.flash_mha(*leaves, dropout_rate=0.2, seed=3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, leaves, gy)
            torch.cuda.synchronize()
        names[hd] = {e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "flash_bwd" in e.name}
    pad = {30: "32", 64: "64", 96: "128"}
    for hd, got in names.items():
        assert len(got) == 2, (hd, got)
        for part in ("dq", "dkv"):
            if dtype == torch.float32:
                want = rf"flash_bwd_{part}_tf32_kernel<float, {pad[hd]}, 4, true>"
            elif hd > 32:
                want = rf"flash_bwd_{part}_wgmma_kernel<{pad[hd]}, true>"
            else:
                want = rf"flash_bwd_{part}_mma_kernel<{pad[hd]}, [24], true>"
            assert any(re.search(want, n) for n in got), (hd, part, got)


# the backward at a padded head dim of 128: (Hd, heads, Tq, Tk, kv_len, causal),
# the 512x4 encoder site at B 4 among them
HD128_BWD_CASES = [(128, 4, 301, 301, 301, False), (128, 2, 70, 129, 100, True),
                   (96, 3, 65, 129, 129, False), (75, 2, 33, 70, 70, True),
                   (128, 4, 32, 497, 497, False), (100, 2, 15, 17, 17, False)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,h,tq,tk,kv_len,causal", HD128_BWD_CASES)
def test_flash_hd128_backward_pairs_match_plain(cuda, hd, h, tq, tk, kv_len, causal, dtype,
                                                rate):
    """The HDP-128 backward pairs (bf16 at an even head dim: the wgmma pair;
    f32, and bf16 at the odd Hd 75: the TF32 pair) against the plain
    version's autograd under the kernel's own mask, f32 within 1e-4 and
    bf16 within 4e-2 of the largest expected value; each call counted on its
    pair in flash_mha_bwd.kernels and none on another; padded keys'
    gradients exactly 0."""
    B = 4 if tq == 301 else 2
    g = _gen(hd + tq + int(rate * 10))
    q, k, v, gy = (torch.randn((B, t, h, hd), generator=g).to(cuda, dtype)
                   for t in (tq, tk, tk, tq))
    pair = ("wgmma128" if dtype == torch.bfloat16 and hd % 2 == 0 else "tf32_128")
    assert tfa.bwd_kernels(q, k, v) == pair
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = dict(tfa.flash_mha_bwd.kernels)
    out = tfa.flash_mha(*leaves, kv_len=kv_len, causal=causal, dropout_rate=rate, seed=21)
    got = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    counts = {n: tfa.flash_mha_bwd.kernels[n] - before[n] for n in tfa.BWD_KERNELS}
    assert counts == {n: int(n == pair) for n in tfa.BWD_KERNELS}
    keep = tfa.keep_mask(B, h, tq, tk, rate=rate, seed=21, device=cuda) if rate else None
    ref = tfa.reference_mha(*leaves, kv_len=kv_len, causal=causal, dropout_rate=rate, keep=keep)
    want = torch.autograd.grad(ref, leaves, gy)
    tol = 1e-4 if dtype == torch.float32 else 4e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=tol * max(1.0, float(b.float().abs().max())))
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("hd,h,tq,tk,kv_len,causal", [
    (64, 8, 301, 301, 301, False), (128, 4, 301, 301, 301, False), (64, 2, 33, 70, 70, True),
    (64, 3, 130, 130, 100, True), (40, 3, 65, 129, 129, False), (100, 2, 70, 129, 90, True),
    (64, 8, 32, 32, 32, True), (128, 4, 32, 497, 497, False), (64, 2, 7, 40, 33, False)])
def test_flash_wgmma_forward(cuda, hd, h, tq, tk, kv_len, causal, rate):
    """The bf16 forward on wgmma (head dims above 32, any number of query
    rows: the --geometry 512x8 encoder site at B 8, its decoder's 32-row
    self and cross sites, Hd 128, ragged and causal shapes, keys past
    kv_len) against the plain version under the kernel's
    own mask at 3e-2 of the largest expected value, counted in
    flash_mha.wgmma; its lse equal to the mma.sync forward's (the design it
    replaced, through its entry) within 1e-5 and its keep words equal on
    every cell the backward reads; the backward on its output against the
    plain version's autograd at 4e-2."""
    B = 8 if tq == 301 else 2
    g = _gen(hd + tq)
    qkv = torch.randn((B, tk, 3 * h * hd), generator=g).to(cuda, torch.bfloat16)
    q0 = torch.randn((B, tq, h * hd), generator=g).to(cuda, torch.bfloat16)
    q = q0.view(B, tq, h, hd)
    k, v = (qkv[..., i * h * hd:(i + 1) * h * hd].view(B, tk, h, hd) for i in (1, 2))
    assert tfa.uses_wgmma_forward(q, k, v)
    keep = tfa.keep_mask(B, h, tq, tk, rate=rate, seed=5, device=cuda) if rate else None
    before = tfa.flash_mha.wgmma
    out, lse, words = tfa._forward(q, k, v, kv_len, causal, rate, 5)
    torch.cuda.synchronize()
    assert tfa.flash_mha.wgmma == before + 1
    want = tfa.reference_mha(q, k, v, kv_len=kv_len, causal=causal, dropout_rate=rate, keep=keep)
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=3e-2 * max(1.0, float(want.float().abs().max())))
    _, lse_sync, words_sync = tfa._forward(q, k, v, kv_len, causal, rate, 5, via="mma_sync")
    assert tfa.flash_mha.wgmma == before + 1
    torch.testing.assert_close(lse, lse_sync, rtol=0, atol=1e-5)
    if rate:
        cells = tfa.keep_cells_written(tq, tk, kv_len, causal).to(cuda)[None, None, :, :, None]
        assert torch.equal(torch.where(cells, words, 0), torch.where(cells, words_sync, 0))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    d_out = torch.randn((B, tq, h, hd), generator=g).to(cuda, torch.bfloat16)
    run = lambda fn, **kw: fn(*leaves, kv_len=kv_len, causal=causal, dropout_rate=rate, **kw)
    got = torch.autograd.grad(run(tfa.flash_mha, seed=5), leaves, d_out)
    ref = torch.autograd.grad(run(tfa.reference_mha, keep=keep), leaves, d_out)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=4e-2 * max(1.0, float(b.float().abs().max())))


def test_flash_forward_kernels_by_head_dim(cuda):
    """The bf16 forward's kernel, by name in a profiler trace: at head dim 30
    (HDP 32) the unchanged mma.sync forward, at 64 and 128 the wgmma forward
    at any number of query rows (32: the 512x8 decoder's sites)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want = {(30, 70): "flash_fwd_mma_kernel<32, 4", (64, 70): "flash_fwd_wgmma_kernel<64,",
            (128, 33): "flash_fwd_wgmma_kernel<128,", (64, 32): "flash_fwd_wgmma_kernel<64,",
            (30, 32): "flash_fwd_mma_kernel<32, 2"}
    for (hd, tq), name in want.items():
        g = _gen(hd + tq)
        q, k, v = (torch.randn((2, tq, 2, hd), generator=g).to(cuda, torch.bfloat16)
                   for _ in range(3))
        tfa.flash_mha(q, k, v)
        torch.cuda.synchronize()
        # three calls a session: once in six runs the trace of a single
        # few-microsecond launch came back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                tfa.flash_mha(q, k, v)
            torch.cuda.synchronize()
        got = {e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and "flash_fwd" in e.name}
        assert len(got) == 1 and name in next(iter(got)).replace(" ", "").replace(",", ", "), \
            (hd, tq, got)


def test_geometry_512x8_bf16_step_feeds_the_backward_from_wgmma(cuda):
    """A bf16 geo train step at --geometry 512x8 with the preset's dropout
    and 40 entity rows: the entity encoder's forwards (L of them) and the
    decoder's (2 L, 7 query rows) run on the wgmma forward, and every
    backward (the wgmma pair at HDP 64) reads their lse and keep words;
    the losses are finite and the deterministic eval loss falls over three
    steps on one batch."""
    import copy

    from icek_torch import bridge
    from icek_torch.core import config as cfgs
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    geo = cfgs.apply_geometry(cfgs.georic(), "512x8")
    V, E, B, T, L = 60, 40, 4, 7, 2
    g = _gen(65)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    caps = torch.randint(1, V + E, (B, T), generator=g)
    batch = {"caption_ids": caps, "caption_mask": (caps >= V).long(),
             "lengths": torch.tensor([7, 5, 3, 6]), "entity_features": ents,
             "image_tokens": torch.randn((B, 12, 512), generator=g)}
    batch = {k: t.to(cuda) for k, t in batch.items()}
    cfg = geo.replace(model=dataclasses.replace(geo.model, num_layers=L, type_vocab=20))
    params = captioner.init_captioner_params(g, cfg.model, V)
    p = bridge.trainable(copy.deepcopy(params), cuda)
    opt = tstep.make_optimizer(1e-3)
    state = opt.init(p)
    train, evaluate = tstep.make_train_step(cfg, V, 0, opt, encode_images=False, device=cuda,
                                            compute_dtype=torch.bfloat16)
    eval_before = float(evaluate(p, None, batch)[0])
    before = (tfa.flash_mha.wgmma, dict(tfa.flash_mha.routes), dict(tfa.flash_mha_bwd.routes))
    losses = []
    for i in range(3):
        _, _, loss, _ = train(p, state, None, batch, torch.Generator().manual_seed(i))
        losses.append(float(loss))
    torch.cuda.synchronize()
    assert tfa.flash_mha.wgmma - before[0] == 3 * 3 * L
    assert tfa.flash_mha.routes["mma"] - before[1]["mma"] == 3 * 3 * L
    assert tfa.flash_mha_bwd.routes["mma"] - before[2]["mma"] == 3 * 3 * L
    assert all(torch.isfinite(torch.tensor(losses)))
    assert float(evaluate(p, None, batch)[0]) < eval_before


def test_geometry_512x4_bf16_train_step_on_card(cuda):
    """A bf16 geo train step at --geometry 512x4 (4 heads of 128) with the
    preset's dropout and 40 entity rows: every flash forward on the wgmma
    forward and every backward on the HDP-128 wgmma pair, none on the
    mma.sync pair it replaced; the losses finite and the deterministic eval
    loss falling over three steps on one batch."""
    import copy

    from icek_torch import bridge
    from icek_torch.core import config as cfgs
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    geo = cfgs.apply_geometry(cfgs.georic(), "512x4")
    assert geo.model.emb_dim // geo.model.num_heads == 128
    V, E, B, T, L = 60, 40, 4, 7, 2
    g = _gen(66)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    caps = torch.randint(1, V + E, (B, T), generator=g)
    batch = {"caption_ids": caps, "caption_mask": (caps >= V).long(),
             "lengths": torch.tensor([7, 5, 3, 6]), "entity_features": ents,
             "image_tokens": torch.randn((B, 12, 512), generator=g)}
    batch = {k: t.to(cuda) for k, t in batch.items()}
    cfg = geo.replace(model=dataclasses.replace(geo.model, num_layers=L, type_vocab=20))
    params = captioner.init_captioner_params(g, cfg.model, V)
    p = bridge.trainable(copy.deepcopy(params), cuda)
    opt = tstep.make_optimizer(1e-3)
    state = opt.init(p)
    train, evaluate = tstep.make_train_step(cfg, V, 0, opt, encode_images=False, device=cuda,
                                            compute_dtype=torch.bfloat16)
    eval_before = float(evaluate(p, None, batch)[0])
    before = (tfa.flash_mha.wgmma, dict(tfa.flash_mha_bwd.kernels))
    losses = []
    for i in range(3):
        _, _, loss, _ = train(p, state, None, batch, torch.Generator().manual_seed(i))
        losses.append(float(loss))
    torch.cuda.synchronize()
    assert tfa.flash_mha.wgmma - before[0] == 3 * 3 * L
    pairs = {n: tfa.flash_mha_bwd.kernels[n] - before[1][n] for n in tfa.BWD_KERNELS}
    assert pairs == {n: 3 * 3 * L if n == "wgmma128" else 0 for n in tfa.BWD_KERNELS}
    assert all(torch.isfinite(torch.tensor(losses)))
    assert float(evaluate(p, None, batch)[0]) < eval_before


def test_geometry_512x8_train_step_on_card(cuda):
    """One geo train step at --geometry 512x8 (head dim 64) on the card, f32
    at dropout 0 against the same step on the CPU (loss 1e-4, Adam's first
    moments 1e-4 of the largest value), then a bf16 step with the preset's
    dropout: finite loss, every flash forward on the mma route and one
    backward launch for each."""
    import copy

    from icek_torch import bridge
    from icek_torch.core import config as cfgs
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    geo = cfgs.apply_geometry(cfgs.georic(), "512x8")
    V, E, B, T, L = 60, 9, 4, 7, 2
    g = _gen(64)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    caps = torch.randint(1, V + E, (B, T), generator=g)
    batch = {"caption_ids": caps, "caption_mask": (caps >= V).long(),
             "lengths": torch.tensor([7, 5, 3, 6]), "entity_features": ents,
             "image_tokens": torch.randn((B, 12, 512), generator=g)}
    quiet = geo.replace(model=dataclasses.replace(
        geo.model, num_layers=L, type_vocab=20, dropout_enc=0.0, dropout_dec=0.0,
        dropout_pos=0.0))
    params = captioner.init_captioner_params(g, quiet.model, V)
    res = {}
    for dev in ("cpu", cuda):
        p = bridge.trainable(copy.deepcopy(params), dev)
        opt = tstep.make_optimizer(1e-3)
        state = opt.init(p)
        train, _ = tstep.make_train_step(quiet, V, 0, opt, encode_images=False, device=dev)
        _, _, loss, _ = train(p, state, None, batch, torch.Generator().manual_seed(0))
        mu, _ = state.moments(p)
        res[str(dev)] = (float(loss), [m.cpu() for m in tstep.tree_leaves(mu)])
    (l0, m0), (l1, m1) = res["cpu"], res[str(cuda)]
    assert abs(l0 - l1) <= 1e-4 * abs(l0)
    for a, b in zip(m0, m1):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-3)
    cfg = geo.replace(model=dataclasses.replace(geo.model, num_layers=L, type_vocab=20))
    p = bridge.trainable(copy.deepcopy(params), cuda)
    opt = tstep.make_optimizer(1e-3)
    state = opt.init(p)
    train, _ = tstep.make_train_step(cfg, V, 0, opt, encode_images=False, device=cuda,
                                     compute_dtype=torch.bfloat16)
    before = (dict(tfa.flash_mha.routes), tfa.flash_mha_bwd.launches)
    _, _, loss, _ = train(p, state, None, batch, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    fwd = tfa.flash_mha.routes["mma"] - before[0]["mma"]
    assert torch.isfinite(torch.as_tensor(float(loss)))
    assert fwd == 3 * L and tfa.flash_mha_bwd.launches - before[1] == fwd
    assert tfa.flash_mha.routes["cuda_cores"] == before[0]["cuda_cores"]


def test_train_step_on_card_matches_cpu(cuda):
    """A small f32 step with dropout 0 on the card (every kernel on) against
    the same step on the CPU: loss and Adam's first moments (0.1 x the
    clipped gradients) within 1e-4 relative to the largest value."""
    import copy

    from icek_torch import bridge
    from icek_torch.core import config as cfgs
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    base = cfgs.georic()
    cfg = base.replace(model=dataclasses.replace(
        base.model, emb_dim=40, num_heads=4, decoder_ffn_dim=64, encoder_ffn_dim=64,
        num_layers=2, type_vocab=20, dropout_enc=0.0, dropout_dec=0.0, dropout_pos=0.0))
    V, E, B, T = 60, 9, 4, 7
    g = _gen(8)
    params = captioner.init_captioner_params(g, cfg.model, V)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    caps = torch.randint(1, V + E, (B, T), generator=g)
    batch = {"caption_ids": caps, "caption_mask": (caps >= V).long(),
             "lengths": torch.tensor([7, 5, 3, 6]), "entity_features": ents,
             "image_tokens": torch.randn((B, 12, 40), generator=g)}
    res = {}
    for dev in ("cpu", cuda):
        p = bridge.trainable(copy.deepcopy(params), dev)
        opt = tstep.make_optimizer(1e-3)
        state = opt.init(p)
        train, _ = tstep.make_train_step(cfg, V, 0, opt, encode_images=False, device=dev)
        _, _, loss, count = train(p, state, None, batch, torch.Generator().manual_seed(0))
        mu, _ = state.moments(p)
        res[str(dev)] = (float(loss), int(count),
                         [m.cpu() for m in tstep.tree_leaves(mu)])
    (l0, n0, m0), (l1, n1, m1) = res["cpu"], res[str(cuda)]
    assert n0 == n1 and abs(l0 - l1) <= 1e-4 * abs(l0)
    for a, b in zip(m0, m1):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-3)
    # dropout 0 routes around the dropout kernels, not around flash
    assert tfa.flash_mha_bwd.launches > 0


def test_train_step_with_dropout_launches_every_kernel(cuda):
    """One small bf16 step with the preset's dropout on the card: finite
    loss, and per step 3 flash launches per layer pair forward and as many
    backward, 5 LayerNorm launches per layer pair each way, 2 dropout
    launches per layer each way."""
    from icek_torch import bridge
    from icek_torch.core import config as cfgs
    from icek_torch.kernels import fused_norm as tfn
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    base = cfgs.georic()
    L = 2
    cfg = base.replace(model=dataclasses.replace(
        base.model, emb_dim=60, num_heads=2, decoder_ffn_dim=64, encoder_ffn_dim=64,
        num_layers=L, type_vocab=20))
    V, E, B, T = 60, 9, 4, 7
    g = _gen(9)
    params = bridge.trainable(captioner.init_captioner_params(g, cfg.model, V), cuda)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    caps = torch.randint(1, V, (B, T), generator=g)
    batch = {"caption_ids": caps, "caption_mask": torch.zeros_like(caps),
             "lengths": torch.full((B,), T), "entity_features": ents,
             "image_tokens": torch.randn((B, 12, 60), generator=g)}
    opt = tstep.make_optimizer(1e-3)
    state = opt.init(params)
    train, evaluate = tstep.make_train_step(cfg, V, 0, opt, torch.bfloat16,
                                            encode_images=False, device=cuda)
    fns = (tfa.flash_mha, tfa.flash_mha_bwd, tfn.dropout_add_ln,
           tfn.dropout_add_ln_bwd, tfn.hw_dropout)
    before = [f.launches for f in fns]
    _, _, loss, _ = train(params, state, None, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert [f.launches - b for f, b in zip(fns, before)] == [
        3 * L, 3 * L, 5 * L, 5 * L, 4 * L]
    assert torch.isfinite(evaluate(params, None, batch)[0])


# ---------------------------------------------------------------------------
# the knowledge and news presets, and beam widths above 8
# ---------------------------------------------------------------------------

def test_score_kernel_with_predicate_modulated_h(cuda):
    """The fact presets' vocab input: h times a per-row projection of a sparse
    0/1 predicate indicator (P 3000), tail 352, at the beam shape."""
    g = _gen(12)
    ind = (torch.rand((1280, 3000), generator=g) < 0.01).float()
    proj = ind @ ((torch.rand((3000, 300), generator=g) * 2 - 1) * 0.1) + torch.randn(300,
                                                                                    generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        h, wv, bv, tail = _score_inputs(cuda, dtype, 1280, 10000, 352)
        h = (h.float() * proj.to(cuda)).to(dtype)
        got = tcs.fused_score_topk(h, wv, bv, tail, k=5)
        want = tcs.reference_score_topk(h, wv, bv, tail, k=5)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)


def test_decoder_step_tensor_cores_hold_40_steps(cuda):
    """The fact presets decode 40 steps: the tensor-core block's shared memory
    grows by 4 * 16 * L bytes and must stay within the card's at the preset
    widths (D 300, H 10, F 512)."""
    assert tds.mma_smem_bytes(300, 10, 512, 40) <= tds.MAX_SMEM
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 2, 5, 0, M=548, L=40)
    assert tds.uses_tensor_cores(stacked, ck, 5, H) and tds.supports(stacked, ck, 5, H)


@pytest.mark.parametrize("K", [8, 10])
@pytest.mark.parametrize("M", [497, 548, 598])
def test_decoder_step_cuda_cores_fit_large_memories(cuda, M, K):
    """The CUDA-core kernel in f32 (weights without the packed copy) at the
    presets' widths, L 40: at M 598 eight hypotheses of an image outgrow a
    block's shared memory, so a block takes fewer (7) and an image spreads
    over two blocks; against the plain version at 1e-4."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 2, K, 20, M=M, L=40)
    f32 = lambda t: t.float().contiguous()
    st32 = tds.stack_decoder_params({"layers": [_tree_to(lay, cuda, torch.float32)
                                                for lay in stacked.layers]})._replace(mma=None)
    args = [f32(t) for t in (ck, cv, xk, xv)]
    got = tds.fused_beam_decoder_step(st32, x, anc, *args, 20, num_heads=H)
    want = tds.reference_decoder_step(st32, x, anc, *args, 20, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("step", [0, 20, 39])
@pytest.mark.parametrize("M", [548, 598])
def test_decoder_step_at_fact_preset_shapes(cuda, M, step):
    """L 40 with memories of 548 (knowledge) and 598 (news) rows, neither a
    multiple of the 32-row (bf16) or 16-row (f32) cross tile: the bf16
    tensor-core route at 0.15 and the f32 one at 1e-4 against the plain
    version, ancestry rows of 40, first, middle and last step."""
    stacked, x, anc, ck, cv, xk, xv, H = _geo_step_inputs(cuda, 3, 5, step, M=M, L=40)
    assert tds.uses_tensor_cores(stacked, ck, 5, H)
    got = tds.fused_beam_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    want = tds.reference_decoder_step(stacked, x, anc, ck, cv, xk, xv, step, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=0.15)
    f32 = lambda t: t.float().contiguous()
    st32 = tds.stack_decoder_params({"layers": [_tree_to(lay, cuda, torch.float32)
                                                for lay in stacked.layers]})
    args = [f32(t) for t in (ck, cv, xk, xv)]
    before = _route_launches()
    got = tds.fused_beam_decoder_step(st32, x, anc, *args, step, num_heads=H)
    assert _ran(before) == {"tensor_cores_f32": 1}
    want = tds.reference_decoder_step(st32, x, anc, *args, step, num_heads=H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-4)


def _small_model(cuda, preset, seed, **model_kw):
    """(cfg, params on the card, entity rows, fact rows or None, image
    tokens) of a small model of `preset` (d 40, 4 heads, 2 layers, V 60,
    E 9, F 7, P 12)."""
    from icek_torch.core import config as cfgs
    from icek_torch.models import captioner

    base = cfgs.get_config(preset)
    cfg = base.replace(model=dataclasses.replace(
        base.model, emb_dim=40, num_heads=4, decoder_ffn_dim=64, encoder_ffn_dim=64,
        num_layers=2, type_vocab=20, num_predicates=12 if base.model.has_facts else 0,
        **model_kw))
    V, E, F, B = 60, 9, 7, 3
    g = _gen(seed)
    params = captioner.init_captioner_params(g, cfg.model, V)
    if cfg.model.has_facts:
        params["fc_predicate"]["b"] = torch.randn(40, generator=g)
    cols = 10 if preset == "nytimes800k" else 5
    ents = torch.zeros((B, E, cols))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    if cols == 10:
        ents[:, :, 5:] = torch.randint(0, V, (B, E, 5), generator=g)
    facts = None
    if cfg.model.has_facts:
        facts = torch.zeros((B, F, 3))
        facts[:, :, 0] = torch.arange(F)
        facts[:, :, 1] = torch.randint(0, E - 1, (B, F), generator=g)
        facts[:, :, 2] = torch.randint(0, 12, (B, F), generator=g)
        facts[:, -2:, 1], facts[:, -2:, 2] = E - 1, 0
        facts = facts.to(cuda)
    tokens = torch.randn((B, 12, 40), generator=g).to(cuda)
    return cfg, _tree_to(params, cuda, torch.float32), ents.to(cuda), facts, tokens


@pytest.mark.parametrize("preset", ["k_georic", "nytimes800k"])
def test_beam_decode_with_facts_kernels_match_stock_on_card(cuda, preset):
    """Small f32 knowledge / news beam-5 and greedy decodes on the card: the
    kernel paths (the [entity | fact] tail and the predicate-modulated vocab
    input into the score head, the decoder step) give the stock path's
    tokens, and every kernel launched."""
    from icek_torch.decode import beam, greedy

    cfg, params, ents, facts, tokens = _small_model(cuda, preset, 13)
    V, E = 60, ents.shape[1]
    counts = (tfa.flash_mha.launches, tcs.fused_score_topk.launches,
              tds.fused_beam_decoder_step.launches)
    ctx = greedy.prepare_decode_context(params, cfg.model, tokens, ents, facts)
    args = (params, cfg.model, V, E, V - 2, V - 1, 0, ctx, 10)
    got = beam.beam_decode(*args, beam_size=5)
    want = beam.beam_decode(*args, beam_size=5, use_megakernel=False, use_fused_scores=False)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)
    got = greedy.greedy_decode(*args)
    want = greedy.greedy_decode(*args, use_fused_scores=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    after = (tfa.flash_mha.launches, tcs.fused_score_topk.launches,
             tds.fused_beam_decoder_step.launches)
    assert after[0] == counts[0] + 2 * cfg.model.num_layers   # entity and fact encoders
    assert after[1] > counts[1] and after[2] > counts[2]


def _beam_against_plain(cuda, dtype, K):
    """Beam K with the kernel switches on (the defaults) against both off: the
    score head runs every step, the decoder step on its tensor-core route
    for the dtype and K (f32 or bf16; wide above K 16), never the CUDA-core
    kernel.  f32 tokens equal the plain path's; bf16 best-hypothesis scores
    within 5e-2."""
    from icek_torch.decode import beam, greedy

    cfg, params, ents, _, tokens = _small_model(cuda, "georic", 14)
    V, E, L = 60, ents.shape[1], 10
    params["fc_vocab"]["b"][V - 1] = -1e4        # no <end>: every step runs
    ctx = greedy.prepare_decode_context(params, cfg.model, tokens, ents, compute_dtype=dtype)
    args = (params, cfg.model, V, E, V - 2, V - 1, 0, ctx, L)
    before, scores = _route_launches(), tcs.fused_score_topk.launches
    got = beam.beam_decode(*args, beam_size=K, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert _ran(before) == {tds.route(dtype, K, True): L}
    assert tcs.fused_score_topk.launches - scores == L
    want = beam.beam_decode(*args, beam_size=K, compute_dtype=dtype, use_megakernel=False,
                            use_fused_scores=False)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=5e-2)
    else:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_width_10_against_the_plain_path_on_card(cuda, dtype):
    """Beam 10: the score head at k 10, the decoder step on its tensor-core
    routes (bf16, f32; G images a block), against the plain path."""
    _beam_against_plain(cuda, dtype, 10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_width_20_against_the_plain_path_on_card(cuda, dtype):
    """Beam 20: the score head's wide first pass (lists in shared memory)
    and the decoder step's wide tensor-core route (parts of an image) in
    both dtypes, against the plain path."""
    _beam_against_plain(cuda, dtype, 20)


@pytest.mark.parametrize("preset", ["k_georic", "nytimes800k"])
def test_train_step_with_facts_on_card_matches_cpu(cuda, preset):
    """A small f32 knowledge / news step with dropout 0 on the card (every
    kernel on) against the same step on the CPU: loss and Adam's first
    moments within 1e-4 relative to the largest value; then one bf16 step
    with dropout launches 3 + 3 encoder and 2 x 2 decoder attentions each
    way."""
    import copy

    from icek_torch import bridge
    from icek_torch.kernels import fused_norm as tfn
    from icek_torch.train import step as tstep

    cfg, params, ents, facts, tokens = _small_model(
        cuda, preset, 15, dropout_enc=0.0, dropout_dec=0.0, dropout_pos=0.0)
    V, E, F, T = 60, ents.shape[1], facts.shape[1], 7
    g = _gen(16)
    caps = torch.randint(1, V + E + F, (3, T), generator=g)
    mask = torch.where(caps >= V + E, 2, (caps >= V).long())
    batch = {"caption_ids": caps, "caption_mask": mask, "lengths": torch.tensor([7, 5, 3]),
             "entity_features": ents.cpu(), "fact_features": facts.cpu(),
             "image_tokens": tokens.cpu()}
    res = {}
    for dev in ("cpu", cuda):
        p = bridge.trainable(copy.deepcopy(_tree_to(params, "cpu", torch.float32)), dev)
        opt = tstep.make_optimizer(1e-3)
        state = opt.init(p)
        train, _ = tstep.make_train_step(cfg, V, 0, opt, encode_images=False, device=dev)
        _, _, loss, count = train(p, state, None, batch, torch.Generator().manual_seed(0))
        mu, _ = state.moments(p)
        res[str(dev)] = (float(loss), int(count), [m.cpu() for m in tstep.tree_leaves(mu)])
    (l0, n0, m0), (l1, n1, m1) = res["cpu"], res[str(cuda)]
    assert n0 == n1 and abs(l0 - l1) <= 1e-4 * abs(l0)
    for a, b in zip(m0, m1):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(a.abs().max()), 1e-3)

    drop = cfg.replace(model=dataclasses.replace(cfg.model, dropout_enc=0.2, dropout_dec=0.2,
                                                 dropout_pos=0.1))
    p = bridge.trainable(copy.deepcopy(_tree_to(params, "cpu", torch.float32)), cuda)
    opt = tstep.make_optimizer(1e-3)
    train, _ = tstep.make_train_step(drop, V, 0, opt, torch.bfloat16, encode_images=False,
                                     device=cuda)
    fns = (tfa.flash_mha, tfa.flash_mha_bwd, tfn.dropout_add_ln, tfn.dropout_add_ln_bwd,
           tfn.hw_dropout)
    before = [f.launches for f in fns]
    _, _, loss, _ = train(p, opt.init(p), None, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    L = cfg.model.num_layers
    assert [f.launches - b for f, b in zip(fns, before)] == [4 * L, 4 * L, 7 * L, 7 * L, 6 * L]


# ---------------------------------------------------------------------------
# the eval run, the serving engine and the int8 KV options on the card
# ---------------------------------------------------------------------------

def _memory_split(images, ents, names):
    """An in-memory TEST split for the port's eval run (the card's machine
    reads no HDF5): a CaptionDataset subclass over numpy arrays."""
    import numpy as np

    from icek_torch.data import dataset as tdata

    class Split(tdata.CaptionDataset):
        def __init__(self):
            n = len(images)
            a = tdata.CaptionArrays.__new__(tdata.CaptionArrays)
            a.caption_ids = np.zeros((n, 2), np.int32)
            a.lengths = np.ones((n,), np.int32)
            a.caption_mask = np.zeros((n, 2), np.int32)
            a.entity_features, a.entity_names = ents, names
            a.fact_features = a.fact_names = None
            a.size = n
            self.split, self.arrays, self._images, self.image_tokens = "TEST", a, images, None

    return Split()


def _small_eval(cuda, dtype, n=5, batch_size=2, seed=21, **decode_kw):
    """A small geo Evaluator on the card (d 40, 4 heads, 2 layers, V 60,
    E 9, ResNet-101 over 32x32 images into 16 tokens) and an n-row split."""
    import numpy as np

    from icek_torch import eval_driver as tev
    from icek_torch.core import config as cfgs
    from icek_torch.data.codec import Wordmap, encode_name
    from icek_torch.models import captioner, resnet

    base = cfgs.georic()
    cfg = base.replace(
        model=dataclasses.replace(base.model, emb_dim=40, num_heads=4, decoder_ffn_dim=64,
                                  encoder_ffn_dim=64, num_layers=2, type_vocab=20,
                                  encoded_image_size=4),
        data=dataclasses.replace(base.data, img_size=32, entity_context_size=8),
        decode=dataclasses.replace(base.decode, max_caption_len=10, **decode_kw))
    wm = Wordmap.from_words([f"w{i}" for i in range(55)] + ["."])
    g = _gen(seed)
    params = captioner.init_captioner_params(g, cfg.model, len(wm))
    params["fc_entity"]["w"] = params["fc_entity"]["w"] * 4.0
    enc = resnet.init_resnet101(g, 40)
    enc["proj"]["w"] = enc["proj"]["w"] * 3e-4
    ev = tev.Evaluator(cfg, wm, params, enc, batch_size=batch_size, beam_size=5,
                       compute_dtype=dtype, device=cuda)
    rng = np.random.default_rng(seed)
    E = 9
    ents = np.zeros((n, E, 5), np.float32)
    ents[:, :, 0] = np.arange(E)
    ents[:, :, 1:4] = rng.random((n, E, 3))
    ents[:, :, 4] = rng.integers(0, 20, (n, E))
    names = np.array([[[0, len(f"p{e}")] + encode_name(f"p{e}") for e in range(E)]] * n,
                     np.int32)
    images = rng.random((n, 3, 32, 32), dtype=np.float32).astype(np.float16)
    return ev, _memory_split(images, ents, names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_groups_equal_offline_decode_at_equal_buckets(cuda, dtype):
    """A group the engine serves at bucket b gives the captions of
    decode_batch on the same rows padded the engine's way (row 0 repeated)
    to b: same shapes, so the same kernels and library calls."""
    import numpy as np

    from icek_torch.decode import detok
    from icek_torch.serve.engine import ServingEngine

    ev, data = _small_eval(cuda, dtype)

    def sample(i):
        return {"raw_images": data._images[i], "entity_features": data.arrays.entity_features[i],
                "entity_names": data.arrays.entity_names[i]}

    def offline(rows, bucket):
        rows = list(rows) + [rows[0]] * (bucket - len(rows))
        ids = ev.decode_batch({"raw_images": data._images[rows],
                               "entity_features": data.arrays.entity_features[rows]})
        return [detok.caption_text(ids[j], ev.wordmap, data.arrays.entity_names[r])[0]
                for j, r in enumerate(rows)]

    with ServingEngine(ev.cfg, ev.wordmap, ev.params, ev.encoder_params, beam_size=5,
                       compute_dtype=dtype, max_batch=4, max_wait_ms=5000.0,
                       device=cuda) as engine:
        engine.warmup(sample(0))
        futures = [engine.submit(sample(i)) for i in range(4)]     # one bucket-4 group
        got = [f.result(timeout=300)["caption"] for f in futures]
        stats = engine.stats()
    assert stats.bucket_runs == {4: 1} and stats.errors == 0
    assert got == offline([0, 1, 2, 3], 4)
    with ServingEngine(ev.cfg, ev.wordmap, ev.params, ev.encoder_params, beam_size=5,
                       compute_dtype=dtype, max_batch=4, max_wait_ms=0.0,
                       device=cuda) as engine:
        lone = engine.caption(sample(3), timeout=300)["caption"]   # bucket 1
    assert lone == offline([3], 1)[0]


@pytest.mark.parametrize("kv_dtype", ["int8", "int8_cross"])
def test_int8_kv_runs_the_plain_step_and_the_score_head(cuda, kv_dtype):
    """int8 and int8_cross: no decoder-step launch, the score head on every
    step, and decoder-step True refused; f32 tokens equal the plain path's."""
    from icek_torch.decode import beam, greedy

    cfg, params, ents, _, tokens = _small_model(cuda, "georic", 22)
    V, E, L = 60, ents.shape[1], 10
    params["fc_vocab"]["b"][V - 1] = -1e4        # no <end>: every step runs
    for dtype in (torch.bfloat16, torch.float32):
        ctx = greedy.prepare_decode_context(params, cfg.model, tokens, ents,
                                            compute_dtype=dtype)
        args = (params, cfg.model, V, E, V - 2, V - 1, 0, ctx, L)
        before = (tds.fused_beam_decoder_step.launches, tcs.fused_score_topk.launches)
        got = beam.beam_decode(*args, beam_size=5, compute_dtype=dtype, kv_dtype=kv_dtype)
        torch.cuda.synchronize()
        assert tds.fused_beam_decoder_step.launches == before[0]
        assert tcs.fused_score_topk.launches - before[1] == L
        with pytest.raises(ValueError, match="megakernel"):
            beam.beam_decode(*args, beam_size=5, compute_dtype=dtype, kv_dtype=kv_dtype,
                             use_megakernel=True)
        if dtype == torch.float32:
            want = beam.beam_decode(*args, beam_size=5, kv_dtype=kv_dtype,
                                    use_fused_scores=False)
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


def test_decode_batch_async_from_another_thread(cuda):
    """decode_batch_async enters inference mode itself, so a worker thread
    (the engine's batcher) gets the ids of decode_batch on the main thread."""
    import threading

    import numpy as np

    ev, data = _small_eval(cuda, torch.bfloat16)
    batch = data.batch(np.array([0, 1]), raw_images=True)
    want = ev.decode_batch(batch)
    out = {}
    worker = threading.Thread(target=lambda: out.update(ids=ev.decode_batch_async(batch)))
    worker.start()
    worker.join()
    assert out["ids"].device.type == "cuda"
    np.testing.assert_array_equal(out["ids"].cpu().numpy(), want)


def test_bf16_run_over_full_and_partial_batches(cuda, tmp_path):
    """Evaluator.run in bf16 over 5 rows at batch 2 (two full batches and one
    padded with its last row), the uploads staged on the prefetch thread's
    stream: the CSV holds 5 captions, each the detok of decode_batch on the
    same padded batch."""
    import csv

    import numpy as np

    from icek_torch import eval_driver as tev
    from icek_torch.decode import detok

    ev, data = _small_eval(cuda, torch.bfloat16)
    res = ev.run(data, output_csv=str(tmp_path / "gen.csv"), log=lambda line: None)
    want = []
    for start in (0, 2, 4):
        idx = tev._pad_batch(np.arange(start, min(start + 2, 5)), 2)
        ids = ev.decode_batch(data.batch(idx, raw_images=True))
        want += [detok.caption_text(ids[j], ev.wordmap, data.arrays.entity_names[i])[0]
                 for j, i in enumerate(idx[:min(2, 5 - start)])]
    assert res["captions"] == want
    with open(tmp_path / "gen.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["generated_caption"] and [r[0] for r in rows[1:]] == want


# ---------------------------------------------------------------------------
# the training run: the epoch loop with a mid-epoch resume, the
# image-carrying steps, the device token cache
# ---------------------------------------------------------------------------

def _small_train_cfg(**train_kw):
    from icek_torch.core import config as cfgs

    base = cfgs.georic()
    return base.replace(
        model=dataclasses.replace(base.model, emb_dim=40, num_heads=4, decoder_ffn_dim=64,
                                  encoder_ffn_dim=64, num_layers=2, type_vocab=20,
                                  encoded_image_size=4),
        data=dataclasses.replace(base.data, img_size=32, entity_context_size=8),
        train=dataclasses.replace(base.train, print_freq=1, **train_kw))


def _train_split_opener(V, E=9, T=8, rows=(12, 4), size=32, seed=31):
    """CaptionDataset's stand-in for the loop: in-memory TRAIN and VAL splits
    (no HDF5 reader needed), built afresh on every open from the
    same seeded arrays."""
    import numpy as np

    from icek_torch.data import dataset as tdata

    rng = np.random.default_rng(seed)
    arrays = {}
    for split, n in zip(("TRAIN", "VAL"), rows):
        caps = rng.integers(1, V - 2, (n, T)).astype(np.int32)
        ent = rng.random((n, T)) < 0.15
        caps[ent] = V + rng.integers(0, E, int(ent.sum()))
        caps[:, 0] = V - 2
        lengths = rng.integers(3, T + 1, (n,)).astype(np.int32)
        for b in range(n):
            caps[b, lengths[b] - 1] = V - 1
            caps[b, lengths[b]:] = 0
        ents = np.zeros((n, E, 5), np.float32)
        ents[:, :, 0] = np.arange(E)
        ents[:, :, 1:4] = rng.random((n, E, 3))
        ents[:, :, 4] = rng.integers(0, 20, (n, E))
        arrays[split] = (caps, lengths, (caps >= V).astype(np.int32), ents,
                         rng.random((n, 3, size, size), dtype=np.float32).astype(np.float16))

    class Split(tdata.CaptionDataset):
        def __init__(self, data_dir, base_name, split, has_facts=False):
            caps, lengths, mask, ents, images = arrays[split]
            a = tdata.CaptionArrays.__new__(tdata.CaptionArrays)
            a.caption_ids, a.lengths, a.caption_mask = caps, lengths, mask
            a.entity_features = ents
            a.entity_names = np.zeros((len(caps), E, 52), np.int32)
            a.fact_features = a.fact_names = None
            a.size = len(caps)
            self.split, self.arrays, self._images, self.image_tokens = split, a, images, None

    return Split


def test_loop_resumes_mid_epoch_bit_identical_on_card(cuda, tmp_path, monkeypatch):
    """Two epochs at small width on the card (bf16, dropout on, the split's
    tokens in the device token cache), once straight through and once
    stopped by SIGTERM after batch 0 of epoch 1 and resumed from its STEP
    file: the epoch-1 checkpoints are equal bit for bit (params, encoder,
    Adam's step and moments, meta)."""
    import os
    import signal

    from icek_torch.data import dataset as tdata
    from icek_torch.train import checkpoint as tckpt
    from icek_torch.train import loop as tloop

    V = 60
    cfg = _small_train_cfg(batch_size=4)
    monkeypatch.setattr(tdata, "CaptionDataset", _train_split_opener(V))
    base = cfg.data.base_name
    lines = []
    tloop.train(cfg, "in-memory", V, 0, checkpoint_dir=str(tmp_path / "a"), max_epochs=2,
                log=lines.append)
    assert any(s.startswith("device token cache:") for s in lines)
    fired = []

    def killing_log(msg):
        if msg.startswith("Epoch: [1][0/") and not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    result = tloop.train(cfg, "in-memory", V, 0, checkpoint_dir=str(tmp_path / "b"),
                         max_epochs=2, log=killing_log)
    step_file = tmp_path / "b" / f"checkpoint_STEP_{base}.pt"
    assert result.preempted and step_file.exists()
    assert tckpt.read_meta(str(step_file))["epoch"] == 1
    tloop.train(cfg, "in-memory", V, 0, checkpoint_dir=str(tmp_path / "b"), max_epochs=2,
                resume_from=str(step_file), log=lambda s: None)
    assert not step_file.exists()
    a = torch.load(tmp_path / "a" / f"checkpoint_{base}.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / f"checkpoint_{base}.pt", weights_only=True)
    assert a["meta"] == b["meta"] and '"epoch": 1' in a["meta"]
    assert a["opt"]["step"] == b["opt"]["step"] == 6
    pairs = [(a[g], b[g]) for g in ("params", "encoder_params")]
    pairs += [(a["opt"][k], b["opt"][k]) for k in ("mu", "nu")]
    from icek_torch.train.step import tree_leaves

    for x, y in pairs:
        for u, v in zip(tree_leaves(x), tree_leaves(y), strict=True):
            assert torch.equal(u, v)


def _conditioned_encoder(g, emb):
    """A seeded ResNet-101 whose batch norms are not the identity and whose
    blocks end in small gains (0.1-0.3, as trained ResNets' do), so that the
    101 layers do not amplify float32 rounding between devices."""
    from icek_torch.models import resnet

    enc = resnet.init_resnet101(g, emb)
    enc["proj"]["w"] = enc["proj"]["w"] * 1e-2

    def bn(tree, last):
        c = tree["mean"].shape[0]
        tree["mean"] = torch.randn(c, generator=g) * 0.1
        tree["var"] = torch.rand(c, generator=g) * 1.5 + 0.5
        lo, hi = (0.1, 0.3) if last else (0.5, 1.5)
        tree["scale"] = torch.rand(c, generator=g) * (hi - lo) + lo

    bn(enc["bn1"], False)
    for stage in range(1, 5):
        for block in enc[f"layer{stage}"]:
            for name in ("bn1", "bn2", "bn3", "down_bn"):
                if name in block:
                    bn(block[name], name == "bn3")
    return enc


def _running_stats(tree):
    """The batch norms' running mean and var leaves of an encoder tree."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in ([v] if k in ("mean", "var") else _running_stats(v))]
    if isinstance(tree, list):
        return [t for v in tree for t in _running_stats(v)]
    return []


def _leaf_close(a, b, floor=0.0):
    """a (CPU) against b (card): within 1e-4 of the leaf's largest value (or
    `floor`, whichever is larger)."""
    b = b.cpu()
    tol = max(1e-4 * float(a.abs().max()), floor)
    assert float((a - b).abs().max()) <= tol, (float((a - b).abs().max()), tol)


@pytest.mark.parametrize("mode", ["finetune", "bn"])
def test_image_steps_on_card_match_cpu(cuda, mode):
    """Two f32 steps with the ResNet inside (fine-tuning, or train-mode batch
    norm), dropout 0, on the card against the same steps on the CPU: the
    loss 1e-4 relative; Adam's first moments and the running statistics
    within 1e-4 of each leaf's largest value (the encoder's moments at least
    1e-5: the noise floor of a gradient through 100 float32 convolution
    layers, tests/test_torch_train_options.py)."""
    import copy

    import numpy as np

    from icek_torch import bridge
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    base = _small_train_cfg(grad_accum_steps=1)
    cfg = base.replace(model=dataclasses.replace(
        base.model, encoded_image_size=2, dropout_enc=0.0, dropout_dec=0.0, dropout_pos=0.0))
    V, E, B, T = 60, 9, 2, 7
    g = _gen(41)
    params = captioner.init_captioner_params(g, cfg.model, V)
    enc = _conditioned_encoder(g, 40)
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    ents[:, :, 4] = torch.randint(0, 20, (B, E), generator=g)
    caps = torch.randint(1, V + E, (B, T), generator=g)
    batch = {"caption_ids": caps, "caption_mask": (caps >= V).long(),
             "lengths": torch.tensor([7, 5]), "entity_features": ents,
             "images": torch.randn((B, 64, 64, 3), generator=g)}
    res = {}
    for dev in ("cpu", cuda):
        p = bridge.trainable(copy.deepcopy(params), dev)
        e = bridge.to_device(copy.deepcopy(enc), dev)
        opt = tstep.make_optimizer(1e-3)
        state = opt.init(p)
        if mode == "finetune":
            eopt = tstep.make_encoder_optimizer(e, 1e-4)
            estate = eopt.init(e)
            train, _ = tstep.make_train_step(cfg, V, 0, opt, encoder_optimizer=eopt,
                                             device=dev)
            losses = [float(train(p, state, e, estate, batch, _gen(s))[4]) for s in (0, 1)]
            enc_part = list(tstep.tree_leaves(estate.moments(e)[0]))
        else:
            train, _ = tstep.make_train_step(cfg, V, 0, opt, bn_train_mode=True, device=dev)
            losses = [float(train(p, state, e, batch, _gen(s))[3]) for s in (0, 1)]
            enc_part = _running_stats(e)
        res[str(dev)] = (losses, list(tstep.tree_leaves(state.moments(p)[0])), enc_part,
                         list(tstep.tree_leaves(e)))
    (l0, m0, e0, t0), (l1, m1, e1, t1) = res["cpu"], res[str(cuda)]
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    for a, b in zip(m0, m1, strict=True):
        _leaf_close(a, b)
    for a, b in zip(e0, e1, strict=True):
        _leaf_close(a, b, floor=1e-5 if mode == "finetune" else 0.0)
    moved = sum(not torch.equal(a, b.cpu()) for a, b in zip(tstep.tree_leaves(enc), t1))
    assert moved > 0


def test_device_token_cache_step_equals_image_token_step_on_card(cuda):
    """bf16, dropout on: batches of row ids into the device token cache (the
    split's f16 tokens lifted to bf16) train bit for bit as batches carrying
    the f16 tokens."""
    import copy

    from icek_torch import bridge
    from icek_torch.models import captioner
    from icek_torch.train import step as tstep

    cfg = _small_train_cfg(grad_accum_steps=1)
    V, E, B, T = 60, 9, 4, 7
    g = _gen(43)
    params = captioner.init_captioner_params(g, cfg.model, V)
    tokens = torch.randn((10, 16, 40), generator=g).half()
    rows = torch.tensor([7, 1, 3, 3])
    ents = torch.zeros((B, E, 5))
    ents[:, :, 0] = torch.arange(E)
    ents[:, :, 1:4] = torch.rand((B, E, 3), generator=g)
    caps = torch.randint(1, V + E, (B, T), generator=g)
    base = {"caption_ids": caps, "caption_mask": (caps >= V).long(),
            "lengths": torch.tensor([7, 5, 3, 6]), "entity_features": ents}
    out = []
    for use_cache in (False, True):
        p = bridge.trainable(copy.deepcopy(params), cuda)
        opt = tstep.make_optimizer(1e-3)
        state = opt.init(p)
        cache = tokens.to(cuda).to(torch.bfloat16) if use_cache else None
        train, _ = tstep.make_train_step(cfg, V, 0, opt, compute_dtype=torch.bfloat16,
                                         encode_images=False, token_cache=cache, device=cuda)
        batch = dict(base, **({"token_rows": rows} if use_cache
                              else {"image_tokens": tokens[rows]}))
        losses = [float(train(p, state, None, batch, _gen(s))[2]) for s in (5, 6)]
        out.append((losses, [t.detach().cpu() for t in tstep.tree_leaves(p)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_loop_on_card_trains_in_the_configured_compute_dtype(cuda, tmp_path, monkeypatch,
                                                             name, dtype):
    """cfg.train.compute_dtype reaches the card: the loop's train step and its
    device token cache take that dtype, and one epoch gives a finite loss."""
    import math

    from icek_torch.data import dataset as tdata
    from icek_torch.train import loop as tloop

    V = 60
    cfg = _small_train_cfg(batch_size=4, compute_dtype=name)
    monkeypatch.setattr(tdata, "CaptionDataset", _train_split_opener(V))
    seen = {}
    make = tloop.step_lib.make_train_step

    def capture(*args, **kw):
        seen.update(kw)
        return make(*args, **kw)

    monkeypatch.setattr(tloop.step_lib, "make_train_step", capture)
    result = tloop.train(cfg, "in-memory", V, 0, checkpoint_dir=str(tmp_path), max_epochs=1,
                         log=lambda s: None)
    assert seen["compute_dtype"] == dtype
    assert seen["token_cache"] is not None and seen["token_cache"].dtype == dtype
    assert math.isfinite(result.best_loss)


# ---------------------------------------------------------------------------
# the int8 convolution (csrc/int8_conv.cu): int32 accumulators and int8 codes
# bit-equal to the plain version (float64 convolution, float32 epilogue)


@pytest.mark.parametrize("k,cin,cout,stride,side,mode", [
    (7, 3, 64, 2, 37, "q8"), (1, 64, 64, 1, 9, "q8"), (1, 128, 256, 2, 9, "f32"),
    (3, 64, 64, 1, 7, "q8"), (3, 128, 128, 2, 9, "q8"), (1, 64, 256, 1, 5, "q8_q8sc"),
    (1, 128, 512, 1, 5, "q8_f32sc"), (3, 192, 72, 1, 5, "q8"), (5, 4, 8, 1, 6, "q8")])
def test_int8_conv_kernel_matches_plain(cuda, k, cin, cout, stride, side, mode):
    from icek_torch.kernels import int8_conv as k8

    g = _gen(k * 100 + cin)
    lo = -127 if cin < 64 else 0
    x = torch.randint(lo, 128, (3, side, side, cin), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (cout, k, k, cin), generator=g, dtype=torch.int8).to(cuda)
    K = k * k * cin
    site = {"wq": w, "es": ((torch.rand(cout, generator=g) + 0.5) / (127.0 * 64 * K ** 0.5)
                            ).to(cuda),
            "b": (torch.randn(cout, generator=g) * 0.1).to(cuda)}
    ho = k8.out_hw(side, k, stride)
    shortcut = None
    if mode == "q8_f32sc":
        shortcut = torch.randn((3, ho, ho, cout), generator=g).to(cuda)
    elif mode == "q8_q8sc":
        shortcut = torch.randint(0, 128, (3, ho, ho, cout), generator=g,
                                 dtype=torch.int8).to(cuda)
    kw = dict(inv=None if mode == "f32" else torch.tensor(127 / 3.0), shortcut=shortcut,
              a_x=torch.tensor(1 / 127.0) if mode == "q8_q8sc" else None)
    before = k8.conv_site.launches
    route = k8.route(cin, cout, k, stride, side, side)
    on_route = _int8_routes()[route]
    acc = k8.qconv(x, w, stride)
    got = k8.conv_site(x, site, stride, **kw)
    torch.cuda.synchronize()
    assert k8.conv_site.launches == before + 2
    assert _int8_routes()[route] == on_route + 2
    assert _native_route(cin, cout, k, stride, side, side) == route
    assert torch.equal(acc, k8.reference_qconv(x, w, stride))
    want = k8.reference_site(x, site, stride, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_max_pool_kernel_matches_plain(cuda):
    from icek_torch.kernels import int8_conv as k8

    for side in (8, 9, 128):
        x = torch.randint(-128, 128, (2, side, side, 64), generator=_gen(side),
                          dtype=torch.int8).to(cuda)
        before = k8.max_pool.launches
        got = k8.max_pool(x)
        torch.cuda.synchronize()
        assert k8.max_pool.launches == before + 1
        assert torch.equal(got, k8.reference_max_pool(x))


@pytest.mark.parametrize("shape", [(256, 128, 128, 64), (3, 17, 13, 64), (2, 9, 31, 16),
                                   (2, 7, 5, 12), (1, 1, 1, 64), (2, 3, 400, 64),
                                   (2, 3, 600, 64), (2, 5, 1600, 64), (1, 6, 9000, 12),
                                   (1, 5, 7, 10920), (5, 2, 2, 4)])
def test_int8_max_pool_strip_kernel_shapes(cuda, shape):
    """The strip kernel (16-byte pieces where C % 16 == 0, else 4),
    bit-equal to the plain version at the encode's shape, odd heights and
    widths, rows too wide for more than a one-row strip, rows too wide for
    three in shared memory (segments of columns), the most channels it
    takes and single pixels; one launch a call."""
    from icek_torch.kernels import int8_conv as k8

    x = torch.randint(-128, 128, shape, generator=_gen(sum(shape)), dtype=torch.int8).to(cuda)
    before = k8.max_pool.launches
    got = k8.max_pool(x)
    torch.cuda.synchronize()
    assert k8.max_pool.launches == before + 1
    assert torch.equal(got, k8.reference_max_pool(x))


def test_int8_max_pool_refuses_too_many_channels(cuda):
    """Above POOL_MAX_C channels three input pixels overflow the strip
    kernel's shared memory: the wrapper raises before a launch."""
    from icek_torch.kernels import int8_conv as k8

    x = torch.zeros((1, 3, 3, k8.POOL_MAX_C + 4), dtype=torch.int8, device=cuda)
    before = k8.max_pool.launches
    with pytest.raises(ValueError, match="channels"):
        k8.max_pool(x)
    assert k8.max_pool.launches == before


def _int8_routes():
    from icek_torch.kernels import int8_conv as k8

    return {r: n.launches for r, n in k8.conv_site.routes.items()}


def _native_route(C, N, KH, stride, H, W):
    """The route the built library's ``int8_conv_route`` names, which
    ``int8_conv.route`` must predict."""
    import ctypes

    from icek_torch.kernels import _build

    fn = _build.bind("int8_conv", "int8_conv_route", [ctypes.c_int] * 7)
    return {0: "mma_sync", 1: "tma", 2: "gather", 3: "tma_box"}[fn(C, N, KH, KH, stride, H, W)]


def _int8_site(g, cuda, cin, cout, k):
    K = k * k * cin
    return {"wq": torch.randint(-127, 128, (cout, k, k, cin), generator=g,
                                dtype=torch.int8).to(cuda),
            "es": ((torch.rand(cout, generator=g) + 0.5) / (127.0 * 64 * K ** 0.5)).to(cuda),
            "b": (torch.randn(cout, generator=g) * 0.1).to(cuda)}


def _encode_site_keys():
    from icek_torch.models import resnet_int8

    return sorted(resnet_int8.encode_sites(256), key=str)


@pytest.mark.parametrize("key", _encode_site_keys(), ids=str)
def test_int8_encode_site_shapes_on_their_routes(cuda, key):
    """Every distinct site of an encode of 256x256 images at batch 3 (M
    ragged at 8x8): int32 sums (qconv, the stem's acc) and codes bit-equal to
    the plain versions, one launch on the route the code predicts."""
    from icek_torch.kernels import int8_conv as k8

    import zlib

    g = _gen(zlib.crc32(repr(key).encode()))
    inv, a_x = torch.tensor(127 / 3.0), torch.tensor(1 / 127.0)
    before = _int8_routes()
    if key[0] == "stem":
        images = torch.randn((3, 3, key[1], key[1]), generator=g).to(cuda).permute(0, 2, 3, 1)
        site, inv_img = _int8_site(g, cuda, 3, 64, 7), torch.tensor(127 / 4.0)
        got = k8.stem_site(images, site, inv_img, inv)
        acc = k8.stem_site(images, site, inv_img, acc=True)
        torch.cuda.synchronize()
        assert torch.equal(acc, k8.reference_stem_site(images, site, inv_img, acc=True))
        assert torch.equal(got, k8.reference_stem_site(images, site, inv_img, inv))
        want = {"stem": 2}
    elif key[0] == "fused":
        _, side, cin, cmid, cout, s = key
        ho = k8.out_hw(side, 1, s)
        xq = torch.randint(0, 128, (3, side, side, cin), generator=g, dtype=torch.int8).to(cuda)
        out = torch.randint(0, 128, (3, ho, ho, cmid), generator=g, dtype=torch.int8).to(cuda)
        c3, dn = _int8_site(g, cuda, cmid, cout, 1), _int8_site(g, cuda, cin, cout, 1)
        got = k8.fused_site(out, xq, c3, dn, s, inv)
        torch.cuda.synchronize()
        assert torch.equal(got, k8.reference_fused_site(out, xq, c3, dn, s, inv))
        want = {"fused": 1}
    else:
        _, side, cin, cout, k, s, mode = key
        ho = k8.out_hw(side, k, s)
        x = torch.randint(0, 128, (3, side, side, cin), generator=g, dtype=torch.int8).to(cuda)
        site = _int8_site(g, cuda, cin, cout, k)
        kw = dict(inv=inv)
        if mode == "q8_q8sc":
            kw.update(shortcut=torch.randint(0, 128, (3, ho, ho, cout), generator=g,
                                             dtype=torch.int8).to(cuda), a_x=a_x)
        acc = k8.qconv(x, site["wq"], s)
        got = k8.conv_site(x, site, s, **kw)
        torch.cuda.synchronize()
        assert torch.equal(acc, k8.reference_qconv(x, site["wq"], s))
        assert torch.equal(got, k8.reference_site(x, site, s, **kw))
        route = k8.route(cin, cout, k, s, side, side)
        assert route == _native_route(cin, cout, k, s, side, side) != "mma_sync"
        want = {route: 2}
    ran = {r: n - before[r] for r, n in _int8_routes().items() if n != before[r]}
    assert ran == want


@pytest.mark.parametrize("B,H,W,layout", [(3, 37, 37, "planar"), (2, 20, 262, "planar"),
                                          (2, 64, 64, "nhwc"), (1, 9, 300, "nhwc")])
def test_int8_stem_reads_float_images_bit_equal(cuda, B, H, W, layout):
    """The stem from the float images through their strides (the planar
    view of normalize_in_graph, or NHWC), widths of one, two and three
    column blocks: sums and codes equal the plain version's."""
    from icek_torch.kernels import int8_conv as k8

    g = _gen(H * W)
    nchw = (torch.randn((B, 3, H, W), generator=g) * 2).to(cuda)
    images = nchw.permute(0, 2, 3, 1)
    if layout == "nhwc":
        images = images.contiguous()
    site, inv_img, inv = _int8_site(g, cuda, 3, 64, 7), torch.tensor(127 / 5.0), torch.tensor(9.0)
    assert torch.equal(k8.stem_site(images, site, inv_img, acc=True),
                       k8.reference_stem_site(images, site, inv_img, acc=True))
    assert torch.equal(k8.stem_site(images, site, inv_img, inv),
                       k8.reference_stem_site(images, site, inv_img, inv))


@pytest.mark.parametrize("side,cin,cmid,cout,stride", [
    (9, 64, 64, 256, 1), (10, 256, 128, 512, 2), (16, 256, 128, 512, 2), (5, 1024, 512, 2048, 2),
    (8, 128, 64, 192, 1)])
def test_int8_fused_site_bit_equal(cuda, side, cin, cmid, cout, stride):
    """conv3 and the down convolution in one launch (the down one's A tiles
    by TMA rows, TMA boxes or gathered; Cout not a multiple of 128) equal
    the two plain sites in turn, code for code."""
    from icek_torch.kernels import int8_conv as k8

    g = _gen(side * cin + cout)
    ho = k8.out_hw(side, 1, stride)
    xq = torch.randint(0, 128, (3, side, side, cin), generator=g, dtype=torch.int8).to(cuda)
    out = torch.randint(0, 128, (3, ho, ho, cmid), generator=g, dtype=torch.int8).to(cuda)
    c3, dn = _int8_site(g, cuda, cmid, cout, 1), _int8_site(g, cuda, cin, cout, 1)
    inv = torch.tensor(127 / 3.0)
    before = _int8_routes()["fused"]
    got = k8.fused_site(out, xq, c3, dn, stride, inv)
    torch.cuda.synchronize()
    assert _int8_routes()["fused"] == before + 1
    assert torch.equal(got, k8.reference_fused_site(out, xq, c3, dn, stride, inv))
    assert torch.equal(got, k8.conv_site(out, c3, 1, inv=inv, shortcut=k8.conv_site(xq, dn, stride)))


def test_int8_routes_agree_with_the_library():
    """``route`` (Python) and ``int8_conv_route`` (the source) name the same
    route over a grid of shapes, the ones only the mma.sync kernel takes
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from icek_torch.kernels import int8_conv as k8

    for C in (3, 4, 64, 128, 192, 256):
        for N in (8, 64, 72, 128, 256):
            for k in (1, 3, 5, 7):
                for stride in (1, 2):
                    for side in (5, 8, 9, 16, 37, 64, 256):
                        assert _native_route(C, N, k, stride, side, side) == \
                            k8.route(C, N, k, stride, side, side)
    assert k8.route(3, 64, 7, 2, 256, 256) == k8.route(4, 8, 5, 1, 6, 6) == \
        k8.route(192, 72, 3, 1, 5, 5) == "mma_sync"


def test_int8_encode_on_card_runs_its_site_routes_and_matches_plain(cuda):
    """The whole int8 encode at 64x64: as many launches on each route as
    ``site_routes`` derives from the tree (100 sites) and one of the pool;
    every code (hence the tokens in f32) equals the CPU's plain version."""
    import numpy as np

    from icek_torch.kernels import int8_conv as k8
    from icek_torch.models import resnet, resnet_int8

    g = torch.Generator().manual_seed(0)
    folded = resnet.fold_bn_params(resnet.init_resnet101(g, 24))
    images = torch.randn((2, 64, 64, 3), generator=g)
    qtree = resnet_int8.calibrate_and_quantize(folded, [images], torch.float32)
    want = resnet_int8.resnet_encode_int8(qtree, images, 2, torch.float32)
    before = (k8.conv_site.launches, k8.max_pool.launches)
    routes = _int8_routes()
    got = resnet_int8.resnet_encode_int8(resnet_int8.to_device(qtree, cuda),
                                         images.to(cuda), 2, torch.float32)
    torch.cuda.synchronize()
    want_routes = resnet_int8.site_routes(qtree, 64)
    assert {r: n - routes[r] for r, n in _int8_routes().items()} == want_routes
    assert (k8.conv_site.launches - before[0], k8.max_pool.launches - before[1]) == \
        (sum(want_routes.values()), 1)
    assert sum(want_routes.values()) == sum(resnet_int8.encode_sites(64).values()) == 100
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernels_key_masks_by_global_row(cuda, dtype):
    """A data-parallel rank's call on rows b0.. of a batch of B (rows=(b0, B))
    draws those rows of the whole batch's masks: forward and backward of the
    LayerNorm and FFN dropouts and of flash attention equal the whole call's
    rows bit for bit, and both keep_masks give the rows of the whole mask."""
    from icek_torch.kernels import fused_norm as tfn

    g = _gen(7)
    B, b0, b, T, D, F, H, Hd = 12, 5, 4, 7, 300, 512, 10, 30
    assert torch.equal(tfn.keep_mask(b * T, D, rate=0.2, seed=9, device=cuda, first_row=b0 * T),
                       tfn.keep_mask(B * T, D, rate=0.2, seed=9, device=cuda)[b0 * T:(b0 + b) * T])
    assert torch.equal(tfa.keep_mask(b, H, T, 33, rate=0.2, seed=9, device=cuda, first=b0),
                       tfa.keep_mask(B, H, T, 33, rate=0.2, seed=9, device=cuda)[b0:b0 + b])
    x, h = (torch.randn((B, T, D), generator=g).to(cuda, dtype) for _ in range(2))
    f = torch.randn((B, T, F), generator=g).to(cuda, dtype)
    q, k, v = (torch.randn((B, T, H, Hd), generator=g).to(cuda, dtype) for _ in range(3))
    scale, bias = torch.ones(D, device=cuda), torch.zeros(D, device=cuda)
    sites = (
        (lambda t, r: tfn.dropout_add_ln(t[0], t[1], scale, bias, rate=0.2, seed=3, rows=r),
         (x, h)),
        (lambda t, r: tfn.hw_dropout(t[0], rate=0.2, seed=4, rows=r), (f,)),
        (lambda t, r: tfa.flash_mha(t[0], t[1], t[2], causal=True, dropout_rate=0.2,
                                    seed=5, rows=r), (q, k, v)),
    )
    for fn, inputs in sites:
        whole = [t.clone().requires_grad_(True) for t in inputs]
        part = [t[b0:b0 + b].clone().requires_grad_(True) for t in inputs]
        out_whole, out_part = fn(whole, None), fn(part, (b0, B))
        gy = torch.randn(out_whole.shape, generator=g).to(cuda, dtype)
        out_whole.backward(gy)
        out_part.backward(gy[b0:b0 + b])
        assert torch.equal(out_part, out_whole[b0:b0 + b])
        for p, w in zip(part, whole):
            assert torch.equal(p.grad, w.grad[b0:b0 + b])
