"""Flash attention, forward and backward (port of
``icek_tpu/kernels/flash_attention.py``).

``flash_mha`` runs ``csrc/flash_attention.cu`` for CUDA tensors and its
plain PyTorch version ``reference_mha`` for CPU tensors:
    dropout(softmax(Q K^T / sqrt(Hd), keys >= kv_len masked, optional causal)) @ V
with a float32 softmax and attention-weight dropout.  It is differentiable:
on CUDA tensors the backward is the kernel pair of the same source (dQ,
then dK/dV), which reads the forward's per-row logsumexp and takes the
forward's dropout mask either from the bits the tensor-core forward saved
(one a score) or, in the TF32 backward, anew from the seed; on CPU tensors
autograd differentiates the plain version.  Q/K/V come in the (B, T, H, Hd)
layout with the head dim contiguous; the TPU head-slot packing is not part
of the port.

Which kernels a CUDA call runs is decided by dtype, shape and alignment
alone (``route``), and the forward and the backward of one call run one
family:

* ``mma``: bfloat16 with an even head dim of at most 128 and 4-byte aligned
  head rows (even strides, a ``data_ptr()`` that is a multiple of 4: every
  view of a fused projection with an even head dim; ``uses_tensor_cores``)
  runs the bf16 tensor-core kernels;
* ``tf32``: every other head dim up to 128, float32 and bfloat16 that
  misses the alignment or has an odd head dim, runs the TF32 tensor-core
  kernels: float32 as three TF32 products a product (each operand split
  into a TF32 high part and the TF32 of its residual: about 2^-21 of
  relative error a term, where one TF32 pass gives 2^-11 and breaks the
  1e-4 checks), bfloat16 as one (bf16 values are exact in TF32).  Its
  products are bounded by the tensor cores' TF32 rate and, in the end, by
  the instructions that split operands and stage f32 rows;
* ``cuda_cores``: the first design's forward (one thread a query row, f32
  FMAs), which no call is routed to; ``_forward(..., via="cuda_cores")``
  reaches it to be timed beside the kernels that replaced it.

Both families pad the head dim to 32, 64 or 128; a head dim above 128
raises, as the JAX package's ``head_slot`` does.  At 64 and 128 the ``mma``
forward runs on wgmma (``flash_fwd_wgmma_kernel``: one warpgroup a block of
64 query rows, ``uses_wgmma_forward``), and so does the ``mma`` backward
(the wgmma pair; at 128 both of its first products read their operands from
shared memory), and the ``tf32`` kernels split every operand by integer
rounding (see the source; at 128 the backward forms several steps' first
products at once).  ``flash_mha.routes`` counts the forward's launches by route (and
``flash_mha.wgmma`` those of the wgmma forward among ``mma``'s),
``flash_mha_bwd.routes`` the backward's, and ``flash_mha_bwd.kernels`` the
backward's by kernel pair (``bwd_kernels``).  No route gives way to another or
to the plain version: a kernel that fails to build or launch raises.

Dropout: an element keeps iff the top 24 of its random bits lie below
``int((1 - rate) * 2**24)``.  The kernels draw the bits from a Philox
counter keyed by ``seed`` and the score's absolute position (``keep_mask``
returns that mask); the plain version takes an explicit ``keep`` mask or
draws one from a ``torch.Generator``.  The two streams differ, as the TPU
kernel's differs from ``jax.random``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from icek_torch.kernels import _build

NEG = -1e30
_P, _I, _LL, _F, _U, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_float, ctypes.c_uint, ctypes.c_ulonglong)
_SHAPE = [_I] * 5 + [_LL] * 6 + [_I, _I, _F, _F, _U, _U, _ULL, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def keep_threshold(rate: float) -> int:
    """The integer the top 24 random bits are compared with."""
    return int((1.0 - rate) * (1 << 24))


def reference_mha(q, k, v, *, kv_len=None, causal=False, dropout_rate=0.0,
                  keep=None, gen=None):
    """Plain version: (B, Tq, H, Hd) x (B, Tk, H, Hd) -> (B, Tq, H, Hd).

    With `dropout_rate` > 0 the softmax weights are masked by `keep`
    ((B, H, Tq, Tk) bool) and scaled by 1 / (1 - rate); without `keep` the
    mask is drawn from `gen`."""
    Hd = q.shape[-1]
    Tq, Tk = q.shape[1], k.shape[1]
    kv_len = Tk if kv_len is None else kv_len
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Hd)).to(torch.float32)
    j = torch.arange(Tk, device=q.device)[None, :]
    valid = j < kv_len
    if causal:
        valid = valid & (j <= torch.arange(Tq, device=q.device)[:, None])
    logits = logits.masked_fill(~valid, NEG)
    weights = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        if keep is None:
            keep = torch.rand(weights.shape, generator=gen,
                              device=weights.device) < 1.0 - dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


MAX_HEAD_DIM = 128


def uses_tensor_cores(q, k, v) -> bool:
    """Whether (q, k, v) go to the bf16 tensor-core kernels: bfloat16, an
    even head dim <= 128, and every head row on a 4-byte boundary (the
    kernels move bf16 pairs as 32-bit words)."""
    Hd = q.shape[-1]
    if q.dtype != torch.bfloat16 or Hd > MAX_HEAD_DIM or Hd % 2:
        return False
    return all(t.data_ptr() % 4 == 0 and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0
               for t in (q, k, v))


ROUTES = ("mma", "tf32", "cuda_cores")
_FWD_ENTRY = {"mma": "_mma", "tf32": "_tf32", "cuda_cores": "", "mma_sync": "_mma"}


def route(q, k, v) -> str:
    """The kernel family (q, k, v) go to: mma or tf32; a head dim above
    128 raises."""
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_mha: head dim {q.shape[-1]} > {MAX_HEAD_DIM} "
                         "is unsupported")
    return "mma" if uses_tensor_cores(q, k, v) else "tf32"


def uses_wgmma_forward(q, k, v) -> bool:
    """Whether the mma route's forward of (q, k, v) runs on wgmma: a head
    dim above 32 (padded to 64 or 128), at any number of query rows; at 32
    the mma.sync forward."""
    return route(q, k, v) == "mma" and q.shape[-1] > 32


def _ptr(t):
    return None if t is None else t.data_ptr()


# the backward's kernel pairs, by design and padded head dim
BWD_KERNELS = ("mma_sync32", "wgmma64", "wgmma128", "tf32_32", "tf32_64", "tf32_128")


def head_pad(Hd: int) -> int:
    """The kernels' padded head dim: 32, 64 or 128 (``hd_pad`` in the source)."""
    return 32 if Hd <= 32 else 64 if Hd <= 64 else 128


def bwd_kernels(q, k, v) -> str:
    """The backward kernel pair a call launches (a key of BWD_KERNELS): on
    the mma route the mma.sync pair at a padded head dim of 32 and the wgmma
    pair at 64 and 128; on tf32 the TF32 pair."""
    hdp = head_pad(q.shape[-1])
    if route(q, k, v) == "mma":
        return f"mma_sync{hdp}" if hdp == 32 else f"wgmma{hdp}"
    return f"tf32_{hdp}"


def block0(first: int, H: int, Tq: int, Tk: int) -> int:
    """The Philox block of score (first, 0, 0, 0) of a (B, H, Tq, Tk) mask:
    what the kernels add for a call whose batch rows start at row `first`
    of a larger batch."""
    return first * H * Tq * ((Tk + 3) // 4)


def _shape_args(q, k, v, kv_len, causal, rate, seed, blk0):
    B, Tq, H, Hd = q.shape
    return (B, Tq, k.shape[1], H, Hd, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), kv_len, int(causal),
            1.0 / math.sqrt(Hd), 1.0 / (1.0 - rate), keep_threshold(rate),
            seed, blk0, _build.stream_of(q))


def _forward(q, k, v, kv_len, causal, rate, seed, blk0=0, via=None):
    """Launch the forward kernel of route `via` (default: ``route``'s);
    returns (out, lse (B, H, Tq) f32, keep_words).  `keep_words` is the
    bf16 tensor-core forward's dropout mask for its backward, one bit a
    score in cells of 16 rows x 64 keys of 32 words each (``keep_cell`` in
    the source), and None at rate 0 and on the other routes.  `via`
    "cuda_cores" reaches the CUDA-core kernel at any head dim up to 128 (up
    to 32 with dropout), for timing it beside the kernel that replaced it;
    "mma_sync" the bf16 mma.sync forward at every head dim (the design the
    wgmma forward replaced at 64 and 128: its keep words are the same)."""
    B, Tq, H, Hd = q.shape
    via = via or route(q, k, v)
    out = torch.empty((B, Tq, H, Hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    keep_words = None
    if rate > 0.0 and via in ("mma", "mma_sync"):
        keep_words = torch.empty((B, H, 4 * (-(-Tq // 64)), -(-k.shape[1] // 64), 32),
                                 dtype=torch.int32, device=q.device)
    # the one place the mma route picks its forward's design
    entry = "_wgmma" if via == "mma" and uses_wgmma_forward(q, k, v) else _FWD_ENTRY[via]
    fn = _build.bind("flash_attention", "flash_fwd_" + _SUFFIX[q.dtype] + entry,
                     [_P] * 6 + _SHAPE)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _ptr(keep_words),
             *_shape_args(q, k, v, kv_len, causal, rate, seed, blk0))
    _build.check(err, "flash_attention", "flash_mha")
    flash_mha.launches += 1
    if via in flash_mha.routes:
        flash_mha.routes[via] += 1
    if entry == "_wgmma":
        flash_mha.wgmma += 1
    return out, lse, keep_words


def flash_mha_bwd(q, k, v, out, lse, keep_words, d_out, kv_len, causal, rate, seed,
                  blk0=0):
    """Launch the backward kernels (dQ, then dK/dV) on the forward's saved
    tensors; returns contiguous (dq, dk, dv) in the inputs' dtype.  `d_out`
    is made contiguous first (autograd may hand over a strided view).
    `keep_words` is what the forward returned with these inputs, `blk0` the
    forward's Philox block offset."""
    d_out = d_out.contiguous()
    if d_out.data_ptr() % 4:        # a contiguous view that starts mid-word
        d_out = d_out.clone()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    # each row's delta (and, for the TF32 kernels, its log2-domain logsumexp)
    delta = torch.empty((2,) + tuple(lse.shape), dtype=torch.float32, device=q.device)
    via = route(q, k, v)
    fn = _build.bind("flash_attention", "flash_bwd_" + _SUFFIX[q.dtype]
                     + ("_mma" if via == "mma" else ""), [_P] * 11 + _SHAPE)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             d_out.data_ptr(), lse.data_ptr(), _ptr(keep_words), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_shape_args(q, k, v, kv_len, causal, rate, seed, blk0))
    _build.check(err, "flash_attention", "flash_mha backward")
    flash_mha_bwd.launches += 1
    flash_mha_bwd.routes[via] += 1
    flash_mha_bwd.kernels[bwd_kernels(q, k, v)] += 1
    return dq, dk, dv


class _FlashMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, rate, seed, blk0):
        out, lse, keep_words = _forward(q, k, v, kv_len, causal, rate, seed, blk0)
        ctx.save_for_backward(q, k, v, out, lse, keep_words)
        ctx.static = (kv_len, causal, rate, seed, blk0)
        return out

    @staticmethod
    def backward(ctx, d_out):
        dq, dk, dv = flash_mha_bwd(*ctx.saved_tensors, d_out, *ctx.static)
        return dq, dk, dv, None, None, None, None, None


def flash_mha(q, k, v, *, kv_len=None, causal=False, dropout_rate=0.0, seed=None,
              rows=None):
    """Fused attention; returns a contiguous (B, Tq, H, Hd) tensor in q's
    dtype.  Key columns at or beyond `kv_len` are masked.  `seed` (an int in
    [0, 2**31)) is required when `dropout_rate` > 0.  `rows` (first, total):
    the batch holds rows ``first ..`` of a batch of `total` rows, whose
    dropout mask is then drawn (a data-parallel rank's share)."""
    B, Tq, H, Hd = q.shape
    Tk = k.shape[1]
    kv_len = Tk if kv_len is None else int(kv_len)
    if k.shape != (B, Tk, H, Hd) or v.shape != k.shape:
        raise ValueError(f"flash_mha: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if not 0 < kv_len <= Tk:
        raise ValueError(f"flash_mha: kv_len {kv_len} outside (0, {Tk}]")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash_mha: dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash_mha: seed is required when dropout_rate > 0")
    seed = 0 if seed is None else int(seed)
    if q.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed) if dropout_rate > 0.0 else None
        keep = None
        if rows is not None and dropout_rate > 0.0:
            first, total = rows
            full = torch.rand((total, H, Tq, Tk), generator=gen)
            keep = full[first:first + B] < 1.0 - dropout_rate
        return reference_mha(q, k, v, kv_len=kv_len, causal=causal,
                             dropout_rate=dropout_rate, keep=keep, gen=gen)
    _build.require_cuda("flash_mha", q, k, v, dtype=q.dtype)
    if q.dtype not in _SUFFIX:
        raise TypeError(f"flash_mha: unsupported dtype {q.dtype}")
    if Hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_mha: head dim {Hd} > {MAX_HEAD_DIM} is unsupported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != Hd:
            raise ValueError(f"flash_mha: {name} needs a contiguous (H, Hd) "
                             f"tail, got strides {t.stride()}")
    blk0 = block0(rows[0], H, Tq, Tk) if rows is not None else 0
    return _FlashMHA.apply(q, k, v, kv_len, causal, float(dropout_rate), seed, blk0)


def keep_mask(B, H, Tq, Tk, *, rate, seed, device, first=0):
    """The (B, H, Tq, Tk) bool mask the kernels use for (rate, seed), written
    by the same device function; for holding a kernel against its plain
    version.  `first` gives batch rows ``first ..`` of a larger batch's mask."""
    out = torch.empty((B, H, Tq, Tk), dtype=torch.bool, device=device)
    _build.require_cuda("flash keep_mask", out)
    fn = _build.bind("flash_attention", "flash_keep_mask",
                     [_P, _I, _I, _I, _I, _U, _U, _ULL, _P])
    err = fn(out.data_ptr(), B, H, Tq, Tk, keep_threshold(rate), int(seed),
             block0(first, H, Tq, Tk), _build.stream_of(out))
    _build.check(err, "flash_attention", "flash keep_mask")
    return out


def keep_cells_written(Tq: int, Tk: int, kv_len: int, causal: bool):
    """(4 ceil(Tq / 64), ceil(Tk / 64)) bool: the cells of 16 query rows x 64
    keys whose keep words the bf16 forward (either design) writes, and the
    backward reads: each 64-row block's key tiles up to its causal end and
    kv_len.  The other words of the buffer are never written.  Like
    ``keep_mask``, for comparisons only (two designs' keep words, cell by
    cell): no path of the port calls it."""
    rows16, tiles = 4 * -(-Tq // 64), -(-Tk // 64)
    blk = torch.arange(rows16) // 4
    end = torch.clamp((blk + 1) * 64, max=kv_len) if causal else torch.full_like(blk, kv_len)
    return torch.arange(tiles)[None, :] * 64 < end[:, None]


flash_mha.launches = 0
flash_mha.routes = dict.fromkeys(ROUTES, 0)      # the forward's launches by route
flash_mha.wgmma = 0         # of routes["mma"], the launches of the wgmma forward
flash_mha_bwd.launches = 0
flash_mha_bwd.routes = dict.fromkeys(ROUTES[:2], 0)   # the backward's launches by route
flash_mha_bwd.kernels = dict.fromkeys(BWD_KERNELS, 0)  # ... by kernel pair
