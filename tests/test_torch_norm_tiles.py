"""The LayerNorm backward of ``icek_torch/csrc/fused_norm.cu`` (``ln_bwd_kernel``
then ``ln_bwd_reduce_kernel``), emulated in torch on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what they do
is written out here with the same teams, lanes and sums:

* a team of LPR lanes (16 for bf16 rows of up to 320 columns, else 32) owns a
  row; lane l holds the groups of four columns l, l + LPR, ...; a block of
  128 threads holds 128 / LPR teams, and the persistent grid walks the rows
  with a stride of (blocks x teams);
* the row statistics: each lane's (count, mean, M2), combined over the team
  by Chan's rule with the lower lane on the left, so every lane gets the
  same bits; then the pair (sum g s zhat, sum g s);
* dscale / dbias: each lane sums g zhat and g over its rows in walk order,
  the two teams of a warp are added, the block's warps are folded in warp
  order into one partial row, and the reduce kernel adds the partial rows
  (warp w takes rows w, w + 16, ..., then the 16 warp sums in order).

The mask is an explicit ``keep`` tensor.  f32 results are held against the
plain version's autograd (dx / dh atol 1e-5; dscale / dbias atol 1e-4 x
sqrt(rows), sums in another order) and, at rate 0, against ``jax.grad`` of
the JAX package's stock ``layer_norm(x + h)`` with the bounds of
tests/test_torch_norm.py (atol 3e-4, rtol 1e-4); bf16 to the card's
tolerances (dx / dh 4 x 3e-2, dscale / dbias 3e-2 of their largest value).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from icek_torch.kernels import fused_norm as tfn
from icek_tpu.models import transformer as jtf


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small torch ops; with the suite's other
    workers on the same cores, torch's thread pool waits at every op's
    barrier for threads that are not running.  One thread each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


THREADS, RED_WARPS, EPS = 128, 16, 1e-5


def team_shape(d, dtype):
    """(LPR, NG) of the kernel instance for rows of d columns."""
    groups = -(-d // 4)
    if dtype == torch.bfloat16 and groups <= 16 * 5:
        return 16, 5
    for ng in (3, 4, 8):
        if groups <= 32 * ng:
            return 32, ng
    raise ValueError(d)


def _chan(n, mean, m2, lpr):
    """Chan's rule over a team's lanes (the last axis), butterfly order."""
    lane = torch.arange(lpr)
    o = lpr // 2
    while o:
        partner = lane ^ o
        low = (lane & o) == 0
        on, om, oq = n[:, partner], mean[:, partner], m2[:, partner]
        na, nb = torch.where(low, n, on), torch.where(low, on, n)
        ma, mb = torch.where(low, mean, om), torch.where(low, om, mean)
        qa, qb = torch.where(low, m2, oq), torch.where(low, oq, m2)
        nt = na + nb
        f = torch.where(nt > 0, nb / torch.clamp(nt, min=1), 0.0)
        d = mb - ma
        mean, m2, n = ma + d * f, qa + qb + d * d * na * f, nt
        o //= 2
    return mean, m2


def tiled_ln_bwd(x, h, scale, gy, keep, rate, nblocks):
    """(dx, dh in x's dtype, dscale, dbias f32, rows visited per row)."""
    N, D = x.shape
    lpr, ng = team_shape(D, x.dtype)
    assert lpr * ng * 4 >= D
    inv = 1.0 / (1.0 - rate)
    z = x.float() + torch.where(keep, h.float() * inv, 0.0)
    lane_of = (torch.arange(D) // 4) % lpr
    onehot = (lane_of[None, :] == torch.arange(lpr)[:, None]).float()   # (lpr, D)
    cnt = onehot.sum(dim=1).expand(N, lpr)
    lmean = torch.where(cnt > 0, (z @ onehot.T) / torch.clamp(cnt, min=1), 0.0)
    m2 = ((z[:, None, :] - lmean[:, :, None]) ** 2 * onehot).sum(dim=2)
    mean, m2 = _chan(cnt, lmean, m2, lpr)
    assert torch.equal(mean, mean[:, :1].expand_as(mean))      # one value a team
    rstd = torch.rsqrt(m2[:, :1] / D + EPS)
    zhat = (z - mean[:, :1]) * rstd
    g = gy.float()
    gs = g * scale
    c1 = (gs * zhat).sum(dim=1, keepdim=True) / D
    c2 = gs.sum(dim=1, keepdim=True) / D
    dz = (gs - c2 - zhat * c1) * rstd
    dx, dh = dz.to(x.dtype), torch.where(keep, dz * inv, 0.0).to(x.dtype)

    # dscale / dbias: lanes over their rows, teams of a warp, warps, blocks
    teams = THREADS // lpr
    blocks = min(nblocks, -(-N // teams))
    slots = blocks * teams
    contrib = torch.stack([g * zhat, g], dim=1)                      # (N, 2, D)
    acc = torch.zeros((slots, 2, D))
    visits = torch.zeros(N, dtype=torch.int64)
    for j in range(-(-N // slots)):
        rows = torch.arange(slots) + j * slots
        live = rows < N
        acc[live] = acc[live] + contrib[rows[live]]
        visits[rows[live]] += 1
    acc = acc.view(blocks, THREADS // 32, 32 // lpr, 2, D)
    warps = acc[:, :, 0] + acc[:, :, 1] if lpr == 16 else acc[:, :, 0]
    partial = torch.zeros((blocks, 2, D)) + warps[:, 0]
    for w in range(1, THREADS // 32):
        partial = partial + warps[:, w]
    sums = []
    for w in range(RED_WARPS):
        s = torch.zeros((2, D))
        for b in range(w, blocks, RED_WARPS):
            s = s + partial[b]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return dx, dh, total[0], total[1], visits


def _inputs(seed, n, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x, h, gy = (torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
                for _ in range(3))
    scale = torch.as_tensor((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    bias = torch.as_tensor((0.1 * rng.standard_normal(d)).astype(np.float32))
    return x, h, gy, scale, bias


def _plain_grads(x, h, gy, scale, bias, keep, rate):
    leaves = [t.clone().requires_grad_(True) for t in (x, h, scale, bias)]
    y = tfn.reference_dropout_add_ln(*leaves, rate=rate, keep=keep)
    return torch.autograd.grad(y, leaves, gy)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("n,d,nblocks", [(530, 36, 528), (1000, 300, 7), (77, 511, 3),
                                         (9, 1024, 528), (300, 300, 1)])
def test_tiled_ln_bwd_matches_plain_f32(n, d, nblocks, rate):
    x, h, gy, scale, bias = _inputs(n + d, n, d)
    keep = torch.as_tensor(np.random.default_rng(n).random((n, d)) < 1 - rate)
    got = tiled_ln_bwd(x, h, scale, gy, keep, rate, nblocks)
    assert torch.equal(got[4], torch.ones(n, dtype=torch.int64))   # each row once
    want = _plain_grads(x, h, gy, scale, bias, keep, rate)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for a, b in zip(got[2:4], want[2:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * max(1.0, n ** 0.5))
    if rate:
        assert not got[1][~keep].any()


@pytest.mark.parametrize("n,d", [(1000, 300), (64, 36), (1001, 300), (1, 300), (65, 36)])
def test_tiled_ln_bwd_bf16_half_warp_teams(n, d):
    """bf16 rows of up to 320 columns take teams of 16 lanes; the result in
    bf16 is held to the card's tolerances against the plain version (odd N:
    the last row's team has no partner row)."""
    assert team_shape(d, torch.bfloat16) == (16, 5)
    assert team_shape(d, torch.float32)[0] == 32
    x, h, gy, scale, bias = _inputs(5, n, d, torch.bfloat16)
    keep = torch.as_tensor(np.random.default_rng(6).random((n, d)) < 0.8)
    got = tiled_ln_bwd(x, h, scale, gy, keep, 0.2, 528)
    want = _plain_grads(x, h, gy, scale, bias, keep, 0.2)
    assert got[0].dtype == torch.bfloat16
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=4 * 3e-2)
    for a, b in zip(got[2:4], want[2:]):
        torch.testing.assert_close(a, b.float(), rtol=0, atol=3e-2 * float(b.abs().max()))


@pytest.mark.parametrize("n,d,nblocks", [(530, 36, 528), (530, 300, 9)])
def test_tiled_ln_bwd_rate0_matches_jax_stock_layer_norm(n, d, nblocks):
    """All four gradients of sum(sin(y)) against jax.grad of the JAX
    package's stock layer_norm(x + h) (not the Pallas backward, whose
    interpret mode fails against stock in tests/test_kernels.py)."""
    x, h, _, scale, bias = _inputs(11, n, d)

    def loss(x_, h_, s_, b_):
        return jnp.sum(jnp.sin(jtf.layer_norm({"scale": s_, "bias": b_}, x_ + h_)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in (x, h, scale, bias)))
    y = tfn.reference_dropout_add_ln(x, h, scale, bias, rate=0.0)
    keep = torch.ones((n, d), dtype=torch.bool)
    got = tiled_ln_bwd(x, h, scale, torch.cos(y), keep, 0.0, nblocks)
    for a, b in zip(got[:4], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4, rtol=1e-4)


def test_tiled_ln_bwd_sums_depend_on_the_grid_only():
    """The sums depend on the grid only: the same grid gives the same bits,
    another grid the same values to rounding."""
    x, h, gy, scale, _ = _inputs(2, 700, 300)
    keep = torch.ones((700, 300), dtype=torch.bool)
    a = tiled_ln_bwd(x, h, scale, gy, keep, 0.0, 528)
    b = tiled_ln_bwd(x, h, scale, gy, keep, 0.0, 528)
    c = tiled_ln_bwd(x, h, scale, gy, keep, 0.0, 5)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    torch.testing.assert_close(a[2], c[2], rtol=0, atol=1e-4)
    torch.testing.assert_close(a[3], c[3], rtol=0, atol=1e-4)
