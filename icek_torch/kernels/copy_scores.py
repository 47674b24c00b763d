"""Fused copy-score head (port of ``icek_tpu/kernels/copy_scores.py``).

The decode loops only consume the top-k entries of the [vocab | tail]
logits (argmax + runner-up for greedy, top-K for beam) and the row
logsumexp.  ``fused_score_topk`` runs ``csrc/score_topk.cu`` for CUDA
tensors, which never writes the (N, V) scores to device memory, and its
plain PyTorch version ``reference_score_topk`` for CPU tensors.  Which
first pass a CUDA call runs is decided by dtype, k and alignment
(``route``; ``aligned`` says whether h's rows allow copies of 4 elements
and Wv's of 16 bytes):

* ``tensor_cores``: k <= 16, aligned bfloat16 (mma.sync m16n8k16) or float32
  (three TF32 m16n8k8 products a product, each operand split into a TF32
  high part and its residual, which the tensor cores truncate to TF32:
  about 2^-21 of relative error a term, where one TF32 pass would break the
  1e-4 checks; it ranks near-ties as float64 does where the plain f32
  product cannot);
* ``cuda_cores``: k <= 16, either dtype when it misses the alignment (an
  f32 FMA product);
* ``wide_tensor_cores``: k > 16, aligned bfloat16;
* ``wide_cuda_cores``: k > 16, float32, and bfloat16 that misses the
  alignment (a register-tiled FMA product).

Up to k 16 each row's top-k lists live in registers; above k 16 (beams
wider than 16) each row keeps one sorted list in shared memory, into which
a tile's scores that beat its last entry are sorted and merged at once.
``fused_score_topk.routes`` counts the launches of each route.  None gives
way to another or to the plain version.  k runs from 1 to the width of
[V | tail], as ``lax.top_k``'s does.  Ties go to the lower index of
[V | tail] (the lax.top_k contract), so vocab entries win ties against
the tail.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icek_torch.decode import topk
from icek_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 7 + [_P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_TILE = 64          # vocab columns per tile in the kernels
_ROWS = 64          # rows per block in the kernels
_TC_MAX_D = 512     # widest h the tensor-core kernel holds in shared memory


def reference_score_topk(h, wv, bv, tail, k: int = 5):
    """Plain version with identical semantics."""
    scores = torch.cat(
        [h.to(torch.float32) @ wv.to(torch.float32) + bv.to(torch.float32),
         tail.to(torch.float32)],
        dim=1,
    )
    vals, idx = topk.top_k(scores, k)
    return vals, idx.to(torch.int32), torch.logsumexp(scores, dim=1)


REGISTER_K = 16     # widest top-k whose lists the kernels keep in registers
LIST_MAX = 128      # longest list of a row in the wide first pass (chunks keep to it)


def supports(k: int, width: int) -> bool:
    """Whether ``fused_score_topk`` takes a top-k of width `k` over rows of
    `width` = V + T extended-vocabulary entries: 1 to `width`.  A call
    outside it raises, on the CPU too."""
    return 1 <= k <= width


def aligned(h, wv) -> bool:
    """Whether contiguous (h, wv) allow the tensor-core first passes' copies:
    D a multiple of 4 and at most 512, h on a boundary of 4 elements (the
    kernels stage h's rows 4 elements a copy: 8 bytes of bfloat16, 16 of
    float32), Wv's rows in 16-byte copies (V a multiple of 8 in bfloat16, of
    4 in float32) and wv on a 16-byte boundary."""
    D, V = wv.shape
    size = h.element_size()
    return (D % 4 == 0 and D <= _TC_MAX_D and V % (16 // size) == 0
            and h.data_ptr() % (4 * size) == 0 and wv.data_ptr() % 16 == 0)


def route(dtype, k: int, is_aligned: bool = True) -> str:
    """The first pass a call takes: tensor_cores / cuda_cores up to k 16,
    wide_tensor_cores / wide_cuda_cores above (the wide tensor-core pass is
    bfloat16's only)."""
    if k > REGISTER_K:
        wide_tc = is_aligned and dtype == torch.bfloat16
        return "wide_tensor_cores" if wide_tc else "wide_cuda_cores"
    return "tensor_cores" if is_aligned else "cuda_cores"


def uses_tensor_cores(h, wv, k: int = 1) -> bool:
    """Whether contiguous (h, wv) go to a tensor-core first pass at top-k `k`."""
    return route(h.dtype, k, aligned(h, wv)).endswith("tensor_cores")


@functools.lru_cache(maxsize=None)
def _first_pass_grid(device_index: int, dtype, tc: bool, kc: int, d: int):
    """(blocks resident on the card at once, rows a block) of the first pass
    a call with this dtype, dispatch, list length and width runs.  Asked
    once per (device, dtype, dispatch, list length, width)."""
    blocks, rows = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        fn = _build.bind("score_topk", "score_topk_grid",
                         [_I] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2)
        _build.check(fn(int(dtype == torch.bfloat16), int(tc), kc, d, ctypes.byref(blocks),
                        ctypes.byref(rows)), "score_topk", "fused_score_topk grid")
    return blocks.value, rows.value


def _chunking(n_rows: int, vocab: int, target: int, rows: int = _ROWS,
              max_tiles: int = None):
    """(chunk_cols, n_chunks): split the vocab so the first pass (`rows` rows
    a block) has about `target` blocks, and no more, whatever the row count;
    a chunk takes at most `max_tiles` tiles when given."""
    n_tiles = -(-vocab // _TILE)
    row_blocks = -(-n_rows // rows)
    chunks = min(n_tiles, max(1, target // row_blocks))
    tiles_per_chunk = -(-n_tiles // chunks)
    if max_tiles is not None:
        tiles_per_chunk = min(tiles_per_chunk, max_tiles)
    return tiles_per_chunk * _TILE, -(-n_tiles // tiles_per_chunk)


def _max_tiles(k: int):
    """The most tiles a chunk takes at top-k `k`: a chunk's list holds min(k,
    chunk columns) entries, so above LIST_MAX the chunk shrinks to LIST_MAX
    columns.  Below it the wide first pass splits the vocab as the others
    do, about one block for each the card holds at once (longer chunks,
    with fewer first tiles to merge, were tried and were no faster)."""
    return LIST_MAX // _TILE if k > LIST_MAX else None


def fused_score_topk(h, wv, bv, tail, k: int = 5):
    """h: (N, D); wv: (D, V); bv: (V,); tail: (N, T) pointer logits.

    Returns (top_vals (N, k) f32, top_idx (N, k) int32 over [V | tail],
    lse (N,) f32).
    """
    N, D = h.shape
    V = wv.shape[1]
    if wv.shape[0] != D or bv.shape != (V,) or tail.shape[0] != N:
        raise ValueError(f"fused_score_topk: h {tuple(h.shape)} wv "
                         f"{tuple(wv.shape)} bv {tuple(bv.shape)} tail "
                         f"{tuple(tail.shape)} do not agree")
    if not supports(k, V + tail.shape[1]):
        raise ValueError(f"fused_score_topk: k={k} outside [1, {V + tail.shape[1]}]")
    if h.device.type == "cpu":
        return reference_score_topk(h, wv, bv, tail, k)
    _build.require_cuda("fused_score_topk", h, wv, dtype=h.dtype)
    _build.require_cuda("fused_score_topk", h, bv, tail)
    if h.dtype not in _SUFFIX:
        raise TypeError(f"fused_score_topk: unsupported dtype {h.dtype}")
    h, wv = h.contiguous(), wv.contiguous()
    bv = bv.to(torch.float32).contiguous()
    tail = tail.to(torch.float32).contiguous()
    T = tail.shape[1]
    name = route(h.dtype, k, aligned(h, wv))
    tc = name.endswith("tensor_cores")
    blocks, rows = _first_pass_grid(h.device.index, h.dtype, tc,
                                    min(k, LIST_MAX) if k > REGISTER_K else k, D)
    chunk_cols, n_chunks = _chunking(N, V, blocks, rows, _max_tiles(k))
    kc = min(k, chunk_cols)
    f32 = dict(dtype=torch.float32, device=h.device)
    i32 = dict(dtype=torch.int32, device=h.device)
    part_v = torch.empty((N, n_chunks, kc), **f32)
    part_i = torch.empty((N, n_chunks, kc), **i32)
    part_m = torch.empty((N, n_chunks), **f32)
    part_s = torch.empty((N, n_chunks), **f32)
    vals = torch.empty((N, k), **f32)
    idx = torch.empty((N, k), **i32)
    lse = torch.empty((N,), **f32)
    entry = _SUFFIX[h.dtype] + ("_mma" if tc else "")
    fn = _build.bind("score_topk", "score_topk_" + entry, _ARGTYPES)
    err = fn(h.data_ptr(), wv.data_ptr(), bv.data_ptr(), tail.data_ptr(),
             part_v.data_ptr(), part_i.data_ptr(), part_m.data_ptr(),
             part_s.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(),
             N, D, V, T, k, chunk_cols, n_chunks, _build.stream_of(h))
    _build.check(err, "score_topk", "fused_score_topk")
    fused_score_topk.launches += 1
    fused_score_topk.routes[name] += 1
    return vals, idx, lse


ROUTES = ("tensor_cores", "cuda_cores", "wide_tensor_cores", "wide_cuda_cores")
fused_score_topk.launches = 0
fused_score_topk.routes = dict.fromkeys(ROUTES, 0)    # launches by first pass (route)
