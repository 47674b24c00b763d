"""The LayerNorm forward and the dropout kernel of ``icek_torch/csrc/fused_norm.cu``
(``ln_fwd_span_kernel`` / ``ln_fwd_kernel``, ``dropout_flat_kernel`` /
``dropout_kernel``), emulated in torch on the CPU.

The CUDA kernels run only on the card (tests/test_torch_gpu.py); what they do
is written out here with the same walks, chunks and Philox numbering:

* the span forward (bf16, D % 4 == 0, 16-byte-aligned rows, and enough of
  them for FWD_SPAN_MIN_SETS spans a team of its one-wave grid; walked here
  at small N and small grids too, which the walk's rules do not tell
  apart): a team of LPR
  lanes (16 when a span has at most 80 chunks, D <= 320, else 32) owns a
  span of two rows that lies in memory as one run; lane l holds 16-byte
  chunks l, l + LPR, ... of 8 elements; chunk c holds groups 2 c and 2 c + 1
  of four columns, group q of the span in row q // G (G = D / 4 groups a
  row), so at D % 8 == 4 one chunk holds the last group of one row and the
  first of the next; the group's Philox
  block is its element offset / 4; a chunk that the tensor's end cuts loads
  8 bytes and zeros, and stores 8 bytes.  Persistent blocks of four warps
  walk the spans with a fixed stride, a warp's teams taking consecutive
  spans (a set); a warp copies its next set into the other stage of a
  two-stage ring while it reduces the current one;
* the row forward (f32, and bf16 at other shapes): a warp a row, lane l holding groups l,
  l + 32, ... of G4 = ceil(D / 4) groups, block row G4 + group;
* the flat dropout (D % 4 == 0, aligned): the tensor as one run of 16-byte
  chunks; thread t of a grid of T threads takes chunks t + u T (u < 2), then
  the next 2 T, each chunk's groups numbered by element offset / 4;
* the row dropout (other shapes): group t of the (N, G4) groups is block t.

Each emulation draws its own keep bits through its walk's index arithmetic
from a host model of Philox-4x32-10 (checked against Random123's published
vectors); the plain versions get the mask built from the numbering
keep(row, col) = bits(row G4 + col // 4)[col % 4] (the backward's).  Values
are held against the plain versions under that mask (f32 atol 1e-5, bf16
3e-2), the masks exactly, and at rate 0 against the JAX package's stock
``layer_norm(x + h)`` with tests/test_torch_norm.py's bound (atol 2e-5, on
the span walk's float32 result before its store rounds it to bf16).
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
    """The emulation is many small torch ops; with the suite's other workers
    on the same cores, torch's thread pool waits at every op's barrier for
    threads that are not running.  One thread each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M32 = 0xFFFFFFFF
STREAM_NORM, EPS, UNROLL, DROP_THREADS = 2, 1e-5, 2, 256


def philox(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on numpy uint64 arrays of 32-bit words."""
    c = [np.asarray(w, np.uint64) for w in (c0, c1, c2, c3)]
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0, p1 = np.uint64(0xD2511F53) * c[0], np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & np.uint64(M32),
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & np.uint64(M32)]
        k0, k1 = (k0 + np.uint64(0x9E3779B9)) & np.uint64(M32), \
            (k1 + np.uint64(0xBB67AE85)) & np.uint64(M32)
    return c


def keep4(blocks, rate, seed):
    """(..., 4) keep flags of Philox blocks `blocks` (int64 tensor) under the
    kernels' rule: the top 24 bits below int((1 - rate) 2^24)."""
    thresh = tfn.keep_threshold(rate)
    if thresh >= 1 << 24:
        return torch.ones(blocks.shape + (4,), dtype=torch.bool)
    b = blocks.numpy().astype(np.uint64)
    words = philox(b & np.uint64(M32), b >> np.uint64(32), 0, 0, seed, STREAM_NORM)
    bits = np.stack(words, axis=-1)
    return torch.as_tensor((bits >> np.uint64(8)) < np.uint64(thresh))


def numbering_mask(n, d, rate, seed):
    """keep(row, col) = bits(row G4 + col // 4)[col % 4]: the numbering the
    backward regenerates."""
    g4 = -(-d // 4)
    row, col = torch.arange(n)[:, None], torch.arange(d)[None, :]
    flags = keep4(row * g4 + col // 4, rate, seed)
    return torch.gather(flags, -1, (col % 4).expand(n, d)[..., None])[..., 0]


def test_host_philox_known_answers():
    """Random123's published Philox-4x32-10 vectors."""
    assert [int(w) for w in philox(0, 0, 0, 0, 0, 0)] == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert [int(w) for w in philox(M32, M32, M32, M32, M32, M32)] == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def team_shape(groups):
    """(LPR, NC) of the span kernel instance for spans of `groups` chunks
    (ln_fwd_pick)."""
    if groups <= 16 * 5:
        return 16, 5
    for nc in (3, 4, 8):
        if groups <= 32 * nc:
            return 32, nc
    raise ValueError(groups)


STAGES = 2


def ring_schedule(spans, warps, teams):
    """Each warp's ring: (the most span sets it has in flight at once,
    whether a stage was ever refilled before its set was read).  The
    prologue issues iteration 0 into stage 0; iteration j waits for its set,
    refills stage (j - 1) % 2 with iteration j + 1's set and reads stage
    j % 2."""
    most, clobbered = 0, False
    for w in range(warps):
        mine = list(range(w * teams, spans, warps * teams))
        stage_of, read = {}, set()
        for j in range(min(STAGES - 1, len(mine))):
            stage_of[j] = j % STAGES
        for j in range(len(mine)):
            nxt = j + STAGES - 1
            if nxt < len(mine):
                # the stage refilled must hold a span already read
                held = [i for i, st in stage_of.items() if st == (j - 1) % STAGES]
                clobbered |= any(i not in read for i in held)
                stage_of = {i: st for i, st in stage_of.items() if i not in held}
                stage_of[nxt] = (j - 1) % STAGES
            most = max(most, len([i for i in stage_of if i not in read]))
            assert stage_of[j] == j % STAGES
            read.add(j)
    return most, clobbered


def span_forward(x, h, scale, bias, rate, seed, nblocks, rounded=True):
    """ln_fwd_span_kernel on bf16 rows: (y in bf16, or in float32 before the
    store rounds it when not `rounded`, keep mask, visits per row, the most
    span sets a warp has in flight)."""
    N, D = x.shape
    assert D % 4 == 0 and x.dtype == torch.bfloat16
    S, CE, CG, G = 2, 8, 2, D // 4
    LPR, NC = team_shape(G)
    total = N * D
    fx, fh = x.reshape(-1).float(), h.reshape(-1).float()
    y = torch.full((total,), float("nan"))
    kept = torch.zeros(total, dtype=torch.bool)
    writes = torch.zeros(total, dtype=torch.int64)
    spans = -(-N // S)
    teams_a_block = 4 * (32 // LPR)
    blocks = min(nblocks, -(-spans // teams_a_block))
    warps, teams = 4 * blocks, blocks * teams_a_block
    lane_chunk = (torch.arange(LPR)[:, None] + LPR * torch.arange(NC)[None, :]).reshape(-1)
    c = lane_chunk[lane_chunk < G]                           # the span's chunks
    q = CG * c[:, None] + torch.arange(CG)[None, :]          # (chunks, CG) groups
    r = (q >= G).long()                                      # row within the span
    in_flight, clobbered = ring_schedule(spans, warps, 32 // LPR)
    assert not clobbered
    for it in range(-(-spans // teams)):
        sp = torch.arange(teams) + it * teams
        sp = sp[sp < spans]
        base = sp * S * D                                    # (W,)
        e = (base[:, None, None, None] + (c * CE)[None, :, None, None]
             + 4 * torch.arange(CG)[None, None, :, None] + torch.arange(4))  # (W, C, CG, 4)
        valid = e < total                                    # load_chunk / store_chunk
        ei = torch.where(valid, e, 0)
        xv = torch.where(valid, fx[ei], 0.0)
        hv = torch.where(valid, fh[ei], 0.0)
        keep = keep4((base >> 2)[:, None, None] + q[None], rate, seed)   # (W, C, CG, 4)
        z = xv + torch.where(keep, hv / (1.0 - rate), 0.0)
        rows = r[None, :, :, None].expand_as(z)
        sums = torch.stack([(z * (rows == k)).sum(dim=(1, 2, 3)) for k in range(S)], 1)
        mean = torch.gather(sums / D, 1, rows.reshape(len(sp), -1)).view_as(z)
        d = z - mean
        sq = torch.stack([(d * d * (rows == k)).sum(dim=(1, 2, 3)) for k in range(S)], 1)
        rstd = torch.gather(torch.rsqrt(sq / D + EPS), 1, rows.reshape(len(sp), -1)).view_as(z)
        col = (e - base[:, None, None, None]) - rows * D
        out = d * rstd * scale[col] + bias[col]
        y[e[valid]] = out[valid]
        kept[e[valid]] = keep[valid]
        writes[e[valid]] += 1
    visits = writes.view(N, D).min(dim=1).values
    assert int(writes.max()) == 1
    return (y.view(N, D).to(x.dtype) if rounded else y.view(N, D)), kept.view(N, D), visits, \
        in_flight


def row_forward(x, h, scale, bias, rate, seed):
    """ln_fwd_kernel (any D): a warp a row, lane l groups l, l + 32, ...;
    block row G4 + group."""
    N, D = x.shape
    g4 = -(-D // 4)
    col = torch.arange(D)
    g = col // 4
    lane = g % 32
    keep = torch.gather(keep4(torch.arange(N)[:, None] * g4 + g[None, :], rate, seed), -1,
                        (col % 4).expand(N, D)[..., None])[..., 0]
    z = x.float() + torch.where(keep, h.float() / (1.0 - rate), 0.0)
    lane_sums = torch.zeros((N, 32)).index_add_(1, lane, z)  # each lane's part
    mean = lane_sums.sum(dim=1, keepdim=True) / D
    c = z - mean
    rstd = torch.rsqrt((c * c).sum(dim=1, keepdim=True) / D + EPS)
    return (c * rstd * scale + bias).to(x.dtype), keep


def flat_dropout(h, rate, seed, nblocks):
    """dropout_flat_kernel: (out in h's dtype, keep mask, threads' chunk
    counts)."""
    N, D = h.shape
    assert D % 4 == 0
    CE = 8 if h.dtype == torch.bfloat16 else 4
    CG = CE // 4
    total = N * D
    chunks = -(-total // CE)
    per_block = DROP_THREADS * UNROLL
    threads = min(nblocks, -(-chunks // per_block)) * DROP_THREADS
    fh = h.reshape(-1).float()
    out = torch.full((total,), float("nan"))
    kept = torch.zeros(total, dtype=torch.bool)
    writes = torch.zeros(total, dtype=torch.int64)
    per_thread = torch.zeros(threads, dtype=torch.int64)
    t = torch.arange(threads)
    for c0 in range(0, chunks, UNROLL * threads):
        c = c0 + t[:, None] + threads * torch.arange(UNROLL)[None, :]    # (T, U)
        live = c < chunks
        per_thread += live.sum(dim=1)
        c = c[live]
        e = (c * CE)[:, None, None] + 4 * torch.arange(CG)[None, :, None] + torch.arange(4)
        valid = e < total
        keep = keep4(c[:, None] * CG + torch.arange(CG)[None, :], rate, seed)
        v = torch.where(valid, fh[torch.where(valid, e, 0)], 0.0)
        res = torch.where(keep, v * (1.0 / (1.0 - rate)), 0.0)
        out[e[valid]] = res[valid]
        kept[e[valid]] = keep[valid]
        writes[e[valid]] += 1
    assert torch.equal(writes, torch.ones(total, dtype=torch.int64))
    return out.view(N, D).to(h.dtype), kept.view(N, D), per_thread


def row_dropout(h, rate, seed):
    """dropout_kernel (any D): group t of the (N, G4) groups is block t."""
    N, D = h.shape
    keep = numbering_mask(N, D, rate, seed)
    return torch.where(keep, h.float() * (1.0 / (1.0 - rate)), 0.0).to(h.dtype), keep


def _inputs(seed, n, d, dtype):
    rng = np.random.default_rng(seed)
    x, h = (torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
            for _ in range(2))
    scale = torch.as_tensor((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    bias = torch.as_tensor((0.1 * rng.standard_normal(d)).astype(np.float32))
    return x, h, scale, bias


TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
SHAPES = [(n, d) for n in (13, 130, 1031) for d in (300, 512, 301)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_forward_walks_match_plain(n, d, dtype):
    """The forward's walk (the span kernel in bf16 where D % 4 == 0, with a
    persistent grid of 3 blocks, so warps take many spans and the last wave
    is ragged, and of 528 blocks; the row kernel in f32 and at D 301)
    against the plain version
    under the numbering mask: the same mask bit for bit, every element
    written once, every row visited."""
    x, h, scale, bias = _inputs(n * d, n, d, dtype)
    rate, seed = 0.2, 1234 + n
    keep = numbering_mask(n, d, rate, seed)
    want = tfn.reference_dropout_add_ln(x, h, scale, bias, rate=rate, keep=keep)
    if d % 4 or dtype == torch.float32:
        got, kept = row_forward(x, h, scale, bias, rate, seed)
        runs = [(got, kept)]
    else:
        runs = []
        for nblocks in (3, 528):
            got, kept, visits, in_flight = span_forward(x, h, scale, bias, rate, seed,
                                                        nblocks)
            assert torch.equal(visits, torch.ones(n, dtype=torch.int64))
            # a warp with two or more span sets has two in flight at once
            spans = -(-n // 2)
            lpr, _ = team_shape(d // 4)
            teams = min(nblocks, -(-spans // (4 * 32 // lpr))) * 4 * 32 // lpr
            sets = -(-spans // teams)
            assert in_flight == min(STAGES, sets)
            runs.append((got, kept))
    for got, kept in runs:
        assert got.dtype == dtype
        assert torch.equal(kept, keep)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_dropout_walks_match_plain(n, d, dtype):
    """The dropout's walk (flat chunks, two a thread in flight, where D % 4
    == 0: grids of 1 and 528 blocks; the row kernel at D 301) against the
    plain version under the numbering mask; every element written once and
    the threads' loads spread evenly."""
    _, h, _, _ = _inputs(n + d, n, d, dtype)
    rate, seed = 0.2, 99 + d
    keep = numbering_mask(n, d, rate, seed)
    want = tfn.reference_hw_dropout(h, rate=rate, keep=keep)
    if d % 4:
        runs = [row_dropout(h, rate, seed)]
    else:
        runs = []
        for nblocks in (1, 528):
            got, kept, per_thread = flat_dropout(h, rate, seed, nblocks)
            assert int(per_thread.max() - per_thread.min()) <= UNROLL
            runs.append((got, kept))
    for got, kept in runs:
        assert torch.equal(kept, keep)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


def test_bf16_chunks_straddle_rows_and_the_tensor_end():
    """bf16 at D 300 (G = 75 groups a row, odd): chunk 37 of a span holds the
    last group of its first row and the first of its second; with an odd N
    the last span has one row and its chunk 37 is cut to 8 bytes at the
    tensor's end, so the second row's first group is never read or written;
    the flat dropout's last chunk of 13 x 300 bf16 values is cut likewise."""
    n, d = 13, 300
    x, h, scale, bias = _inputs(5, n, d, torch.bfloat16)
    assert (n * d) % 8 == 4 and (d // 4) % 2 == 1
    keep = numbering_mask(n, d, 0.2, 7)
    got, kept, visits, _ = span_forward(x, h, scale, bias, 0.2, 7, 528)
    assert torch.equal(kept, keep) and int(visits.min()) == 1
    want = tfn.reference_dropout_add_ln(x, h, scale, bias, rate=0.2, keep=keep)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)
    # the straddling chunk's two groups are rows 2j and 2j + 1
    e = 37 * 8
    assert e // d == 0 and (e + 4) // d == 1
    out, kept, _ = flat_dropout(h, 0.2, 7, 528)
    assert torch.equal(kept, keep)


@pytest.mark.parametrize("n,d", [(130, 300), (1031, 512), (13, 300)])
def test_span_forward_rate0_matches_jax_stock_layer_norm(n, d):
    """At rate 0 (no Philox: every element kept) the span walk on bf16
    rows, its float32 result before the store's rounding, against the JAX
    package's stock layer_norm(x + h) of the same values; rounded, it is
    that result in bf16."""
    x, h, scale, bias = _inputs(n + 7 * d, n, d, torch.bfloat16)
    want = jtf.layer_norm({"scale": jnp.asarray(scale.numpy()), "bias": jnp.asarray(bias.numpy())},
                          jnp.asarray((x.float() + h.float()).numpy()))
    got, kept, _, _ = span_forward(x, h, scale, bias, 0.0, 0, 3, rounded=False)
    assert bool(kept.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    stored, _, _, _ = span_forward(x, h, scale, bias, 0.0, 0, 3)
    assert torch.equal(stored, got.to(torch.bfloat16))


def test_timing_variants_match_the_kernel_source():
    """``python -m icek_torch.kernels._variants fused_norm`` (the card's
    breakdown of the forward's and the dropout's time) edits
    csrc/fused_norm.cu by text replacement: every variant's replacements
    still find their text and change it, and the braces of the result still
    balance."""
    import os

    from icek_torch.kernels import _build, _variants

    with open(os.path.join(_build.CSRC, "fused_norm.cu")) as f:
        src = f.read()
    variants = _variants.VARIANTS["fused_norm"]
    assert _variants.CUTS["fused_norm"] <= set(variants)
    for name in variants:
        out = _variants.variant_source("fused_norm", name, src)
        assert (out != src) == (name != "base"), name
        assert out.count("{") - out.count("}") == src.count("{") - src.count("}"), name
