"""The tiling of the tensor-core score head (``icek_torch/csrc/score_topk.cu``,
``score_partial_mma_kernel`` then ``score_merge_kernel``), emulated in torch
on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_gpu.py); what it does
tile by tile is written out here with the same chunk split
(``copy_scores._chunking``), the same zero pad of D to a multiple of 16
(300 -> 304), the same lanes and walk order, and held against the plain
version and the JAX package:

* a block takes 64 rows and a chunk of 64-column tiles; in a tile, lane t of
  a row's quad holds columns 8 n + 2 t + e (n < 8, e < 2), walked in that
  order, tile after tile;
* each lane keeps an online (max, sum 2^x) in the log2 domain and a sorted
  top-k list (value descending, ties to the lower index) that a score
  enters, through the kernel's insertion network, only if it beats the
  row's threshold: the best k-th entry of the quad's four lists, shared at
  each tile's end, or the lane's own k-th entry since;
* at the chunk's end the quad's (max, sum) pairs are combined and its four
  lists merged; the merge kernel then takes the chunks' lists and the tail
  row, and the lse from the chunks' pairs and the tail.

Above k 16 the wide first passes (tensor-core and CUDA-core) keep one
sorted list of kc = min(k, chunk columns) entries per row in shared
memory; a tile's scores that beat the list's last entry at the tile's start
are compacted in lane order (columns lane, then lane + 32), sorted by the
kernel's bitonic network (32 lanes, or 64 as two a lane) and merged into
the list in one step: an entry's new slot is its rank in the list plus its
rank among the survivors, found by the kernel's binary searches, and
entries move top segment first; up to FEW survivors are ranked by counting
instead (``wide_partials``).  The merge's round j
takes the best candidate that ranks after round j - 1's pick
(``threshold_merge``).

The f32 tensor-core first pass (``score_partial_mma_kernel<float, K>``)
walks the same tiles over three TF32 products a product: each 32-deep ring
stage's hi lo + lo hi + hi hi (each operand split into hi = rna(x) and lo =
x - hi, truncated to TF32 by the tensor cores) summed by the tensor cores,
exactly here, then added to the running sum in f32
(``tf32_stage_product``); two blocks an SM share the card, so the vocab
splits into other chunks.

Tolerances: values and lse atol 1e-4 with IDENTICAL indices, as
tests/test_torch_kernels.py holds the plain version (f32 inputs; the
emulation's scores come from one f32 product, so only the tiling differs,
or from the 3xTF32 stage walk).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icek_torch.kernels import copy_scores as tcs
from icek_tpu.kernels import copy_scores as jcs
from test_torch_decoder_tiles import split_tf32
from test_torch_tf32_split import split

ROWS, TILE, KMAX = 64, 64, 16
FEW = 8                 # the wide pass merges at most this many survivors by counting
LOG2E = 1.4426950408889634
INT_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation is thousands of small torch ops; with the suite's other
    workers on the same cores, torch's thread pool waits at every op's
    barrier for threads that are not running.  One thread each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _better(av, ai, bv, bi):
    return (av > bv) | ((av == bv) & (ai < bi))


def _insert(lv, li, k, v, i, take):
    """The kernel's insertion network on (KMAX, M) sorted lists (slot-major),
    for the lanes where `take` holds: slot j < k takes the candidate or its
    upper neighbour."""
    nv, ni = lv.clone(), li.clone()
    for j in range(min(k, KMAX) - 1, -1, -1):
        here = take & _better(v, i, lv[j], li[j])
        p = max(j - 1, 0)
        up = here & _better(v, i, lv[p], li[p]) if j else torch.zeros_like(here)
        nv[j] = torch.where(here, torch.where(up, lv[p], v), lv[j])
        ni[j] = torch.where(here, torch.where(up, li[p], i), li[j])
    return nv, ni


def _topk_sorted(v, i, k):
    """The first k of (v, i) pairs in (value desc, index asc) order, per row."""
    order = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, order), i.gather(1, order)
    order = torch.argsort(-v, dim=1, stable=True)[:, :k]
    return v.gather(1, order), i.gather(1, order)


# the tensor-core first pass's resident blocks on an H100 at D = 300: three
# blocks of 66 KB of shared memory on each of 132 SMs in bf16, two of 104
# KB in f32 (the wrapper asks the card's occupancy API for this number)
RESIDENT = 3 * 132
RESIDENT_F32 = 2 * 132
STAGE_F32 = 32          # depth of an f32 ring stage


def _chunks(n, v, resident=RESIDENT):
    return tcs._chunking(n, v, resident)


def padded_depth(d, step=16):
    """D padded to the mma's depth: 16 in bf16, 8 in f32."""
    return -(-d // step) * step


def tf32_stage_product(hp, wp):
    """hp wp as the f32 tensor-core first pass forms it: each operand split
    by integer rounding (hi = rna(x), lo = x - hi truncated to TF32 by the
    tensor cores), each ring stage's (32 deep) three TF32 terms, hi lo + lo
    hi + hi hi, summed by the tensor cores (exactly here), then added to the
    running sum by an f32 add."""
    acc = torch.zeros((hp.shape[0], wp.shape[1]))
    for d0 in range(0, hp.shape[1], STAGE_F32):
        (ah, al), (bh, bl) = (split_tf32(hp[:, d0:d0 + STAGE_F32]),
                              split_tf32(wp[d0:d0 + STAGE_F32]))
        ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
        acc = acc + (ah @ bl + al @ bh + ah @ bh).float()
    return acc


def tiled_partials(h, wv, bv, k, tf32=False):
    """The first pass: per (row, chunk) the chunk's top-k (value, index) and
    its (max, sum exp), as the kernel writes them; also the number of list
    insertions per (row, chunk, lane).  `tf32`: the f32 kernel's products
    (tf32_stage_product) and chunks, else one f32 product."""
    N, D = h.shape
    V = wv.shape[1]
    dpad = padded_depth(D, 8 if tf32 else 16)
    chunk_cols, n_chunks = _chunks(N, V, RESIDENT_F32 if tf32 else RESIDENT)
    n_pad = -(-N // ROWS) * ROWS
    hp = torch.zeros((n_pad, dpad))
    hp[:N, :D] = h
    wp = torch.zeros((dpad, n_chunks * chunk_cols))
    wp[:D, :V] = wv
    product = tf32_stage_product(hp, wp) if tf32 else hp @ wp
    scores = product + torch.nn.functional.pad(bv, (0, n_chunks * chunk_cols - V))
    col = torch.arange(n_chunks * chunk_cols)
    chunk_of = col // chunk_cols
    c_end = torch.clamp((chunk_of + 1) * chunk_cols, max=V)
    scores = torch.where(col < c_end, scores, -math.inf)[:N]

    # walk position p of lane t in chunk c: tile p // 16, n = p % 16 // 2, e = p % 2
    walk = chunk_cols // 4
    p = torch.arange(walk)
    t = torch.arange(4)
    cols = (torch.arange(n_chunks)[:, None, None] * chunk_cols + TILE * (p // 16)[None, None]
            + 8 * (p % 16 // 2)[None, None] + 2 * t[None, :, None] + (p % 2)[None, None])
    lane_scores = scores[:, cols]                       # (N, chunks, 4, walk)
    M = N * n_chunks * 4
    flat = lane_scores.reshape(M, walk)
    flat_cols = cols.expand(N, -1, -1, -1).reshape(M, walk)

    # per-lane online (max, sum 2^x), one 16-score tile at a time
    m = torch.full((M,), -math.inf)
    s = torch.zeros((M,))
    for t0 in range(0, walk, 16):
        tile = flat[:, t0:t0 + 16]
        m_new = torch.maximum(m, tile.max(dim=1).values)
        live = m_new != -math.inf
        mL = torch.where(live, m_new, 0.0) * LOG2E
        part = torch.exp2(tile * LOG2E - mL[:, None]).sum(dim=1)
        s = torch.where(live, s * torch.exp2(m * LOG2E - mL) + part, s)
        m = m_new

    # per-lane top-k by threshold: a score enters the lane's list only if it
    # beats (tv, ti), the best k-th entry of the quad's lists at the last
    # tile's end or the lane's own k-th entry since, whichever is better
    # tiles (16 steps) at once: a score that does not beat the lane's
    # threshold at the tile's start never takes the path, since the
    # threshold only rises; the steps then walk the remaining lanes only
    lv = torch.full((M, KMAX), -math.inf)
    li = torch.full((M, KMAX), INT_MAX, dtype=torch.int64)
    tv = torch.full((M,), -math.inf)
    ti = torch.full((M,), INT_MAX, dtype=torch.int64)
    inserts = torch.zeros((M,), dtype=torch.int64)
    for t0 in range(0, walk, 16):
        tile_v, tile_i = flat[:, t0:t0 + 16], flat_cols[:, t0:t0 + 16]
        live = ((tile_v != -math.inf)
                & _better(tile_v, tile_i, tv[:, None], ti[:, None])).any(dim=1)
        rows = live.nonzero()[:, 0]
        rv, ri = tile_v[rows].T.contiguous(), tile_i[rows].T.contiguous()
        lvr, lir = lv[rows].T.contiguous(), li[rows].T.contiguous()
        tvr, tir = tv[rows], ti[rows]
        ins = torch.zeros_like(tir)
        for q in range(rv.shape[0]):
            v, i = rv[q], ri[q]
            take = (v != -math.inf) & _better(v, i, tvr, tir)
            ins += take
            lvr, lir = _insert(lvr, lir, k, v, i, take)
            up = take & _better(lvr[k - 1], lir[k - 1], tvr, tir)
            tvr = torch.where(up, lvr[k - 1], tvr)
            tir = torch.where(up, lir[k - 1], tir)
        lv[rows], li[rows], tv[rows], ti[rows] = lvr.T, lir.T, tvr, tir
        inserts[rows] += ins
        qv, qi = _topk_sorted(tv.view(-1, 4), ti.view(-1, 4), 1)  # the tile's end:
        tv, ti = qv.expand(-1, 4).reshape(M), qi.expand(-1, 4).reshape(M)  # quad_best

    # the quad: (max, sum) combined, four lists merged
    m4, s4 = m.view(N, n_chunks, 4), s.view(N, n_chunks, 4)
    qm = m4.max(dim=2).values
    qs = torch.where(m4 == -math.inf, 0.0,
                     s4 * torch.exp2((m4 - qm[..., None]) * LOG2E)).sum(dim=2)
    lv = lv[:, :k].reshape(N * n_chunks, 4 * k)
    li = li[:, :k].reshape(N * n_chunks, 4 * k)
    pv, pi = _topk_sorted(lv, li, k)
    return (pv.view(N, n_chunks, k), pi.view(N, n_chunks, k), qm, qs,
            inserts.view(N, n_chunks, 4))


def tiled_score_topk(h, wv, bv, tail, k, tf32=False):
    """Both passes: (vals (N, k) f32, idx (N, k) int32, lse (N,) f32)."""
    N, V = h.shape[0], wv.shape[1]
    pv, pi, pm, ps, _ = tiled_partials(h, wv, bv, k, tf32)
    T = tail.shape[1]
    cand_v = torch.cat([pv.reshape(N, -1), tail], dim=1)
    cand_i = torch.cat([pi.reshape(N, -1), V + torch.arange(T).expand(N, T)], dim=1)
    used = cand_i == INT_MAX                            # padding never wins
    vals, idx = _topk_sorted(torch.where(used, -math.inf, cand_v),
                             torch.where(used, INT_MAX, cand_i), k)
    m = torch.maximum(pm.max(dim=1).values, tail.max(dim=1).values)
    s = (ps * torch.exp(pm - m[:, None])).sum(dim=1) + torch.exp(tail - m[:, None]).sum(dim=1)
    return vals, idx.to(torch.int32), m + torch.log(s)


PAD = (-math.inf, INT_MAX)


def _exchange(cs, stride, keeps_better):
    """The kernel's exchange on 32 lanes' candidates: lane l takes lane l ^
    stride's where that is the better one and l keeps the better, or the
    worse one and l keeps the worse."""
    out = list(cs)
    for lane, c in enumerate(cs):
        o = cs[lane ^ stride]
        if _better(*o, *c) if keeps_better(lane) else _better(*c, *o):
            out[lane] = o
    return out


def _sort32(cs):
    """sort32: the bitonic network over 32 lanes, best first."""
    for size in (2, 4, 8, 16, 32):
        stride = size >> 1
        while stride:
            cs = _exchange(cs, stride, lambda l, z=size, d=stride: ((l & z) == 0) == ((l & d) == 0))
            stride >>= 1
    return cs


def _sort64(a, b):
    """sort64: element e in lane e % 32 (a below 32, b above), best first."""
    for size in (2, 4, 8, 16, 32, 64):
        stride = size >> 1
        while stride:
            if stride == 32:
                for lane in range(32):
                    if _better(*b[lane], *a[lane]):
                        a[lane], b[lane] = b[lane], a[lane]
            else:
                a = _exchange(a, stride, lambda l, z=size, d=stride: ((l & z) == 0) == ((l & d) == 0))
                b = _exchange(b, stride,
                              lambda l, z=size, d=stride: (((l + 32) & z) == 0) == ((l & d) == 0))
            stride >>= 1
    return a, b


def _rank_in(entries, c):
    """rank_in: the entries of a sorted list that rank before c (binary search)."""
    lo, hi = 0, len(entries)
    while lo < hi:
        mid = (lo + hi) >> 1
        if _better(*entries[mid], *c):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _list_tile(lst, tile):
    """The kernel's list_tile on one row: `lst` the sorted list of kc
    (value, index) entries, `tile` the 64 columns' candidates (None past
    c_end).  Returns the number of survivors."""
    kc = len(lst)
    tv = lst[-1]
    live = [[c for c in half if c is not None and _better(*c, *tv)]
            for half in (tile[:32], tile[32:])]             # ballot, popc: lane order
    surv = live[0] + live[1]
    cnt = len(surv)
    if not cnt:
        return 0
    if cnt <= FEW:                      # few_merge: counted, not sorted
        slots, up = [0] * cnt, [0] * kc
        for x, c in enumerate(surv):
            for s, other in enumerate(surv):
                slots[s] += _better(*c, *other)
            for j, e in enumerate(lst):
                up[j] += _better(*c, *e)
            slots[x] += sum(_better(*e, *c) for e in lst)     # the ballot
        old = list(lst)                                     # every lane reads, then writes
        for j, e in enumerate(old):
            if up[j] and j + up[j] < kc:
                lst[j + up[j]] = e
        for to, c in zip(slots, surv):
            if to < kc:
                lst[to] = c
        return cnt
    s0 = [surv[lane] if lane < cnt else PAD for lane in range(32)]
    s1 = [surv[lane + 32] if lane + 32 < cnt else PAD for lane in range(32)]
    if cnt > 32:
        s0, s1 = _sort64(s0, s1)
    elif cnt > 1:
        s0 = _sort32(s0)
    buf = (s0 + s1)[:cnt]
    slots = [s + _rank_in(lst, c) for s, c in enumerate(buf)]   # from the list as it stands
    first = slots[0]
    for seg in range((kc - 1) >> 5, (first >> 5) - 1, -1):      # top segment first
        moved = [(j + _rank_in(buf, lst[j]), lst[j]) for j in range(32 * seg, 32 * seg + 32)
                 if first <= j < kc]                            # every lane reads, then writes
        for to, e in moved:
            if to < kc:
                lst[to] = e
    for to, c in zip(slots, buf):
        if to < kc:
            lst[to] = c
    return cnt


def wide_partials(scores, k, chunk_cols):
    """The wide first pass on (N, V) f32 scores: per (row, chunk) the list of
    kc entries as the kernel writes it, walking the chunk's 64-column tiles
    through list_tile; and the number of survivors (scores that beat the
    list's last entry at their tile's start) and of tiles that had any."""
    N, V = scores.shape
    kc = min(k, chunk_cols)
    n_chunks = -(-V // chunk_cols)
    pv = torch.full((N, n_chunks, kc), -math.inf)
    pi = torch.full((N, n_chunks, kc), INT_MAX, dtype=torch.int64)
    survivors = merges = 0
    for n in range(N):
        row = scores[n].tolist()
        for c in range(n_chunks):
            lst = [PAD] * kc
            c_end = min(V, (c + 1) * chunk_cols)
            for col0 in range(c * chunk_cols, c_end, TILE):
                tile = [(row[col], col) if col < c_end else None
                        for col in range(col0, col0 + TILE)]
                got = _list_tile(lst, tile)
                survivors += got
                merges += got > 0
            pv[n, c] = torch.tensor([v for v, _ in lst])
            pi[n, c] = torch.tensor([i for _, i in lst])
    return pv, pi, (survivors, merges)


def threshold_merge(cand_v, cand_i, k):
    """The merge kernel's rounds on (N, P + T) candidates: round j takes the
    best candidate ranking after round j - 1's pick; padding never counts."""
    N = cand_v.shape[0]
    prev_v = torch.full((N,), math.inf)
    prev_i = torch.full((N,), -1, dtype=torch.int64)
    vals, idx = [], []
    for _ in range(k):
        live = (cand_i != INT_MAX) & _better(prev_v[:, None], prev_i[:, None], cand_v, cand_i)
        v, i = _topk_sorted(torch.where(live, cand_v, -math.inf),
                            torch.where(live, cand_i, INT_MAX), 1)
        prev_v, prev_i = v[:, 0], i[:, 0]
        vals.append(prev_v)
        idx.append(prev_i)
    return torch.stack(vals, dim=1), torch.stack(idx, dim=1)


def wide_score_topk(h, wv, bv, tail, k, chunk_cols):
    """Both passes of the k > 16 route at this chunk split."""
    N, V = h.shape[0], wv.shape[1]
    scores = h @ wv + bv
    pv, pi, _ = wide_partials(scores, k, chunk_cols)
    T = tail.shape[1]
    cand_v = torch.cat([pv.reshape(N, -1), tail], dim=1)
    cand_i = torch.cat([pi.reshape(N, -1), V + torch.arange(T).expand(N, T)], dim=1)
    vals, idx = threshold_merge(cand_v, cand_i, k)
    full = torch.cat([scores, tail], dim=1)
    return vals, idx.to(torch.int32), torch.logsumexp(full, dim=1)


@pytest.mark.parametrize("k,chunk_cols", [(17, 128), (40, 64), (64, 192), (100, 128),
                                          (200, 128), (330, 64)])
def test_wide_lists_match_plain_and_jax(k, chunk_cols):
    """k 17 to 330 against the plain version and JAX: lists shorter than a
    tile, of one tile, longer than a tile (k 100 over 128-column chunks) and
    holding their whole chunk (k 200 over 128 columns: kc = 128); the ragged
    last chunk of V = 300 pads its list; k 330 reaches into the tail."""
    args = _inputs(k + chunk_cols, 3, 300, d=12, t=37)
    got = wide_score_topk(*(torch.as_tensor(a) for a in args), k, chunk_cols)
    _hold(got, args, k)


def test_wide_lists_ties_and_insertions():
    """Exact ties planted across tiles and chunks enter the list in index
    order whatever the walk order; a row merges once a tile at most, and
    about 64 + k (1 + ln(tiles - 1)) of a chunk's scores enter its merges
    (its first tile's 64 and about k / (t - 1) of tile t's), a seventh of
    them here."""
    n, v, k, chunk_cols = 2, 640, 20, 320
    bv = np.zeros(v, np.float32)
    bv[[5, 70, 100, 319, 320, 639]] = 3.0
    args = (np.zeros((n, 4), np.float32), np.zeros((4, v), np.float32), bv,
            np.full((n, 5), 3.0, np.float32))
    got = wide_score_topk(*(torch.as_tensor(a) for a in args), k, chunk_cols)
    assert got[1][0, :8].tolist() == [5, 70, 100, 319, 320, 639, v, v + 1]
    _hold(got, args, k)
    rand = _inputs(5, 4, 2048, d=16, t=1)
    scores = torch.as_tensor(rand[0]) @ torch.as_tensor(rand[1]) + torch.as_tensor(rand[2])
    _, _, (survivors, merges) = wide_partials(scores, 24, 1024)
    tiles = 1024 // TILE
    assert merges <= 4 * 2 * tiles
    assert survivors < 1.25 * 4 * 2 * (TILE + 24 * (1 + math.log(tiles - 1)))
    assert survivors < scores.numel() / 6


def _inputs(seed, n, v, d=300, t=301):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            ((rng.random((d, v)) * 2 - 1) * 0.1).astype(np.float32),
            (rng.standard_normal(v) * 0.01).astype(np.float32),
            rng.standard_normal((n, t)).astype(np.float32))


def _hold(got, args, k, jax_ref=True):
    want = tcs.reference_score_topk(*(torch.as_tensor(a) for a in args), k=k)
    wants = [want]
    if jax_ref:
        wants.append(jcs.reference_score_topk(*(jnp.asarray(a) for a in args), k=k))
    for w in wants:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(w[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(w[0]), atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(w[2]), atol=1e-4)


@pytest.mark.parametrize("n,v,k", [(1280, 10000, 5), (256, 10000, 2), (70, 10001, 5),
                                   (65, 10000, 1), (1, 520, 8)])
def test_tiled_scores_match_plain_and_jax(n, v, k):
    args = _inputs(n + v + k, n, v)
    got = tiled_score_topk(*(torch.as_tensor(a) for a in args), k)
    _hold(got, args, k)


@pytest.mark.parametrize("k", range(1, 9))
def test_tiled_scores_every_k(k):
    """k = 1 ... 8 on rows that are not a multiple of the 64-row tile."""
    args = _inputs(40 + k, 67, 1000, d=36, t=17)
    _hold(tiled_score_topk(*(torch.as_tensor(a) for a in args), k), args, k)


def test_tiled_scores_match_pallas_interpret():
    """A small case against the JAX package's Pallas kernel in interpret
    mode, as tests/test_torch_kernels.py runs it."""
    args = _inputs(7, 16, 1000, d=32, t=37)
    got = tiled_score_topk(*(torch.as_tensor(a) for a in args), 5)
    with pltpu.force_tpu_interpret_mode():
        want = jcs.fused_score_topk(*(jnp.asarray(a) for a in args), k=5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)


def _ties(k, v, tf32=False):
    n, d, t = 700, 8, 16
    chunk_cols, n_chunks = _chunks(n, v, RESIDENT_F32 if tf32 else RESIDENT)
    assert n_chunks > 3 and chunk_cols > TILE and chunk_cols % TILE == 0
    bv = np.zeros(v, np.float32)
    planted = [63, 64, 3 * chunk_cols - 1, 3 * chunk_cols, v - 2, v - 1]
    bv[planted] = 3.0
    bv[[10, 11, 3 * chunk_cols + 1]] = 2.0
    tail = np.zeros((n, t), np.float32)
    tail[:, 4] = 3.0
    args = (np.zeros((n, d), np.float32), np.zeros((d, v), np.float32), bv, tail)
    got = tiled_score_topk(*(torch.as_tensor(a) for a in args), k, tf32)
    want = planted + [v + 4, 10, 11, 3 * chunk_cols + 1]
    assert got[1].numpy()[0].tolist()[:len(want)] == want[:k]
    _hold(got, args, k)


@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("v", [10000, 10001])
def test_tiled_scores_ties_across_tiles_chunks_and_tail(k, v):
    """Exact ties planted on both sides of a tile boundary, a chunk boundary,
    the ragged last tile and the tail: the lower index wins, vocab beats the
    tail, and equal scores seen in one lane, in two lanes of a quad or in
    two chunks all come out in index order."""
    _ties(k, v)


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_tiled_tf32_scores_ties_across_tiles_chunks_and_tail(k):
    """The same planted ties through the f32 tensor-core pass's 3xTF32
    products and its chunks (two blocks an SM): the lower index wins."""
    _ties(k, 10000, tf32=True)


@pytest.mark.parametrize("n,v,k", [(256, 10000, 2), (320, 10000, 5), (65, 10000, 1),
                                   (130, 2000, 16), (1, 520, 8)])
def test_tiled_tf32_scores_match_plain_and_jax(n, v, k):
    """The f32 tensor-core first pass (three TF32 products a product, each
    stage's sum added in f32) at the greedy and beam shapes and k 1 to 16:
    indices identical to the plain version's and the JAX package's, values
    and lse within 1e-4."""
    args = _inputs(2 * n + v + k, n, v)
    _hold(tiled_score_topk(*(torch.as_tensor(a) for a in args), k, tf32=True), args, k)


def test_tiled_tf32_scores_match_pallas_interpret():
    """The f32 tensor-core pass's tile walk against the JAX package's Pallas
    kernel in interpret mode."""
    args = _inputs(8, 16, 1000, d=32, t=37)
    got = tiled_score_topk(*(torch.as_tensor(a) for a in args), 5, tf32=True)
    with pltpu.force_tpu_interpret_mode():
        want = jcs.fused_score_topk(*(jnp.asarray(a) for a in args), k=5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)


def test_one_tf32_pass_would_miss_the_f32_tolerance():
    """Why three terms: the beam shape's scores through one TF32 pass (hi hi)
    are off by more than 1e-4 (the card's f32 tolerance on values and lse),
    through the stage walk's three within 1e-5 of float64."""
    h, wv, _, _ = (torch.as_tensor(a) for a in _inputs(9, 128, 2000))
    want = h.double() @ wv.double()
    one = (split(h)[0].double() @ split(wv)[0].double())
    three = tf32_stage_product(torch.nn.functional.pad(h, (0, 4)),
                               torch.nn.functional.pad(wv, (0, 0, 0, 4)))
    assert float((one - want).abs().max()) > 1e-4
    assert float((three.double() - want).abs().max()) < 1e-5


def test_tiled_first_pass_pads_and_inserts():
    """At the beam shape: D 300 pads to 304; the chunk split covers V once
    with no more blocks than three an SM; for the n scores of a row in a
    chunk the row's quad inserts fewer times than four lanes with lists of
    their own would, 4 k (1 + ln(n / 4k)) (each lane fills its list in the
    chunk's first tile, before the quad shares a threshold), so fewer than
    one score in seven takes the insertion path, where the CUDA-core kernel
    runs k warp-wide arg-max rounds on every tile."""
    n, v, k = 1280, 10000, 5
    args = [torch.as_tensor(a) for a in _inputs(3, n, v, d=32)]
    assert padded_depth(300) == 304 and padded_depth(304) == 304
    chunk_cols, n_chunks = _chunks(n, v)
    assert (n_chunks - 1) * chunk_cols < v <= n_chunks * chunk_cols
    assert n_chunks * -(-n // ROWS) <= RESIDENT
    _, _, _, _, inserts = tiled_partials(*args[:3], k)
    per_row = inserts.sum(dim=2).float()                # the quad's, per chunk
    assert float(per_row.mean()) < 4 * k * (1 + math.log(chunk_cols / (4 * k)))
    assert int(inserts.sum()) < n * v / 7


def test_tensor_core_dispatch():
    """The first pass by (dtype, k, alignment), case by case: bf16 with D %
    4 == 0, V % 8 == 0 and aligned operands takes the tensor-core kernel at
    every k; f32 with V % 4 == 0 and h on a 16-byte boundary takes it up to
    k 16 and the wide CUDA-core pass above; V = 10001, an h that starts
    mid-word and D above 512 take the CUDA-core passes."""
    h = torch.zeros((4, 300), dtype=torch.bfloat16)
    wv = torch.zeros((300, 10000), dtype=torch.bfloat16)
    assert tcs.uses_tensor_cores(h, wv)
    assert tcs.uses_tensor_cores(h.float(), wv.float())
    assert not tcs.uses_tensor_cores(h.float(), wv.float(), k=17)
    assert tcs.uses_tensor_cores(h, wv, k=17)
    assert not tcs.uses_tensor_cores(h, torch.zeros((300, 10001), dtype=torch.bfloat16))
    buf = torch.zeros(4 * 300 + 1, dtype=torch.bfloat16)
    assert not tcs.uses_tensor_cores(buf[1:].view(4, 300), wv)
    assert not tcs.uses_tensor_cores(torch.zeros((4, 600), dtype=torch.bfloat16),
                                     torch.zeros((600, 64), dtype=torch.bfloat16))
    # f32: V a multiple of 4 suffices, h needs 16 bytes
    assert tcs.aligned(h.float(), torch.zeros((300, 10004)))
    assert not tcs.aligned(h, torch.zeros((300, 10004), dtype=torch.bfloat16))
    buf32 = torch.zeros(4 * 300 + 2)
    assert not tcs.aligned(buf32[2:].view(4, 300), wv.float())     # 8-byte aligned only
    cases = [(torch.bfloat16, 5, True, "tensor_cores"), (torch.bfloat16, 20, True, "wide_tensor_cores"),
             (torch.float32, 5, True, "tensor_cores"), (torch.float32, 16, True, "tensor_cores"),
             (torch.float32, 17, True, "wide_cuda_cores"), (torch.float32, 5, False, "cuda_cores"),
             (torch.bfloat16, 5, False, "cuda_cores"), (torch.bfloat16, 20, False, "wide_cuda_cores")]
    for dtype, k, is_aligned, want in cases:
        assert tcs.route(dtype, k, is_aligned) == want, (dtype, k, is_aligned)
    assert set(tcs.fused_score_topk.routes) == set(tcs.ROUTES)


def test_timing_variants_match_the_kernel_source():
    """``python -m icek_torch.kernels._variants score_topk`` (the card's
    breakdown of the wide first pass) edits csrc/score_topk.cu by text
    replacement: every variant's replacements still find their text and
    change it, and the braces of the result still balance."""
    import os

    from icek_torch.kernels import _build, _variants

    with open(os.path.join(_build.CSRC, "score_topk.cu")) as f:
        src = f.read()
    variants = _variants.VARIANTS["score_topk"]
    assert _variants.CUTS["score_topk"] <= set(variants)
    for name in variants:
        out = _variants.variant_source("score_topk", name, src)
        assert (out != src) == (name != "base"), name
        assert out.count("{") - out.count("}") == src.count("{") - src.count("}"), name
