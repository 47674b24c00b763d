"""Fused residual-dropout-LayerNorm and plain dropout (port of
``icek_tpu/kernels/fused_norm.py``).

  dropout_add_ln   y = LayerNorm(x + dropout(h, rate)) over the last axis in
                   one pass, row statistics in float32, y in x's dtype.  Its
                   backward regenerates the mask from the seed, recomputes
                   the row statistics from x and h and emits dx, dh, dscale
                   and dbias in one pass (plus a small deterministic
                   reduction for the two parameter gradients).
  hw_dropout       where(keep, h / (1 - rate), 0); the backward is the same
                   kernel on the incoming gradient and saves only the seed.

Both run ``csrc/fused_norm.cu`` for CUDA tensors and their plain PyTorch
versions (``reference_dropout_add_ln``, ``reference_hw_dropout``,
differentiated by autograd) for CPU tensors.  An element keeps iff the top
24 of its random bits lie below ``int((1 - rate) * 2**24)``; the kernels
draw the bits from a Philox counter keyed by ``seed`` and the element's
(row, column) (``keep_mask`` returns that mask), the plain versions take an
explicit ``keep`` mask or draw one from a ``torch.Generator``.  With
``rows=(first, total)`` the tensor holds leading rows ``first ..`` of a
tensor of ``total`` leading rows (a data-parallel rank's share of a global
batch) and both draw that tensor's mask (``global_keep``, ``block0``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icek_torch.kernels import _build
from icek_torch.kernels.flash_attention import keep_threshold

_P, _I, _LL, _F, _U, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_float, ctypes.c_uint, ctypes.c_ulonglong)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_FWD_ENTRY = {dt: "ln_fwd_" + sfx for dt, sfx in _SUFFIX.items()}
_DROP_ENTRY = {dt: "dropout_" + sfx for dt, sfx in _SUFFIX.items()}
MAX_D = 1024          # widest row the LayerNorm kernels hold in registers


def _drop(h, rate, keep, gen):
    if rate <= 0.0:
        return h
    if keep is None:
        keep = torch.rand(h.shape, generator=gen, device=h.device) < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), 0.0).to(h.dtype)


def global_keep(shape, rate, gen, rows, device=None):
    """The keep mask of leading rows ``rows[0] ..`` of a tensor of
    ``rows[1]`` leading rows (trailing dims `shape[1:]`), drawn from `gen` as
    the whole tensor's mask would be: a data-parallel rank's rows of the
    global batch's mask."""
    first, total = rows
    full = torch.rand((total,) + tuple(shape[1:]), generator=gen, device=device)
    return full[first:first + shape[0]] < 1.0 - rate


def block0(x, rows) -> int:
    """The Philox block the kernels add for `x` (..., D) holding leading rows
    ``rows[0] ..`` of a larger tensor: its first flat row times D4 / 4."""
    if rows is None:
        return 0
    per_lead = x.numel() // (x.shape[0] * x.shape[-1])      # flat rows a leading row
    return rows[0] * per_lead * ((x.shape[-1] + 3) // 4)


def reference_hw_dropout(h, *, rate, keep=None, gen=None):
    """Plain version of ``hw_dropout``; `keep` (bool, h's shape) or a mask
    drawn from `gen`."""
    return _drop(h, rate, keep, gen)


def reference_dropout_add_ln(x, h, scale, bias, *, rate, keep=None, gen=None,
                             eps=1e-5):
    """Plain version of ``dropout_add_ln``: float32 statistics, x's dtype out."""
    z = x.to(torch.float32) + _drop(h.to(torch.float32), rate, keep, gen)
    mu = z.mean(dim=-1, keepdim=True)
    c = z - mu
    var = c.square().mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


def _rows(t):
    return t.reshape(-1, t.shape[-1]).contiguous()


def _param(p):
    """A LayerNorm parameter as the kernels read it: float32, 16-byte aligned
    (itself when it already is)."""
    if p.dtype == torch.float32 and p.is_contiguous() and p.data_ptr() % 16 == 0:
        return p
    p = p.detach().to(torch.float32).contiguous()
    return p if p.data_ptr() % 16 == 0 else p.clone()


def _check(what, x, *same):
    _build.require_cuda(what, x, *same, dtype=x.dtype)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input")


@functools.lru_cache(maxsize=None)
def _grid(entry: str, device_index: int, dtype, d: int) -> int:
    """Blocks of a persistent kernel resident on the card at once (its grid;
    for the backward also the rows of its partial sums), from the C entry
    point `entry` (ln_fwd_grid, ln_bwd_grid: width and dtype; dropout_grid:
    dtype).  Asked once per (entry, device, dtype, width)."""
    out = ctypes.c_int(0)
    bf16 = int(dtype == torch.bfloat16)
    with torch.cuda.device(device_index):
        if entry == "dropout_grid":
            fn = _build.bind("fused_norm", entry, [_I, ctypes.POINTER(ctypes.c_int)])
            err = fn(bf16, ctypes.byref(out))
        else:
            fn = _build.bind("fused_norm", entry, [_I, _I, ctypes.POINTER(ctypes.c_int)])
            err = fn(d, bf16, ctypes.byref(out))
        _build.check(err, "fused_norm", f"fused_norm {entry}")
    return out.value


_FWD_ARGS = [_P] * 5 + [_LL, _I, _F, _F, _U, _U, _ULL, _I, _P]


def _ln_forward(x2, h2, scale, bias, rate, seed, eps, blk0=0):
    y = torch.empty_like(x2)
    N, D = x2.shape
    fn = _build.bind("fused_norm", _FWD_ENTRY[x2.dtype], _FWD_ARGS)
    err = fn(x2.data_ptr(), h2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             y.data_ptr(), N, D, eps, 1.0 / (1.0 - rate), keep_threshold(rate), seed,
             blk0, _grid("ln_fwd_grid", x2.get_device(), x2.dtype, D),
             _build.stream_of(x2))
    if err:
        _build.check(err, "fused_norm", "dropout_add_ln")
    dropout_add_ln.launches += 1
    return y


def dropout_add_ln_bwd(x2, h2, scale, g2, rate, seed, eps, blk0=0):
    """Launch the backward kernel on (N, D) rows; returns (dx, dh, dscale,
    dbias) with dx, dh in x's dtype and (D,) float32 parameter gradients.
    `blk0` is the forward's Philox block offset."""
    N, D = x2.shape
    dx, dh = torch.empty_like(x2), torch.empty_like(x2)
    nblocks = _grid("ln_bwd_grid", x2.get_device(), x2.dtype, D)
    f32 = dict(dtype=torch.float32, device=x2.device)
    partial = torch.empty((nblocks, 2, D), **f32)
    dscale, dbias = torch.empty((D,), **f32), torch.empty((D,), **f32)
    fn = _build.bind("fused_norm", "ln_bwd_" + _SUFFIX[x2.dtype],
                     [_P] * 9 + [_LL, _I, _F, _F, _U, _U, _ULL, _I, _P])
    err = fn(x2.data_ptr(), h2.data_ptr(), scale.data_ptr(), g2.data_ptr(),
             dx.data_ptr(), dh.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
             dbias.data_ptr(), N, D, eps, 1.0 / (1.0 - rate), keep_threshold(rate),
             seed, blk0, nblocks, _build.stream_of(x2))
    _build.check(err, "fused_norm", "dropout_add_ln backward")
    dropout_add_ln_bwd.launches += 1
    return dx, dh, dscale, dbias


class _DropoutAddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, scale, bias, rate, seed, eps, blk0):
        x2, h2, s32 = _rows(x), _rows(h), _param(scale)
        y = _ln_forward(x2, h2, s32, _param(bias), rate, seed, eps, blk0)
        ctx.save_for_backward(x2, h2, s32)
        ctx.static = (rate, seed, eps, blk0, x.shape, scale.dtype, bias.dtype)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x2, h2, s32 = ctx.saved_tensors
        rate, seed, eps, blk0, shape, s_dtype, b_dtype = ctx.static
        dx, dh, dscale, dbias = dropout_add_ln_bwd(x2, h2, s32, _rows(g), rate,
                                                   seed, eps, blk0)
        return (dx.view(shape), dh.view(shape), dscale.to(s_dtype),
                dbias.to(b_dtype), None, None, None, None)


def dropout_add_ln(x, h, scale, bias, *, rate, seed=None, eps=1e-5, rows=None):
    """LayerNorm(x + dropout(h, rate)) fused over the last axis.

    x, h: (..., D) of one shape and dtype (the compute dtype); scale, bias:
    (D,) LayerNorm parameters; seed: an int in [0, 2**31), required when
    rate > 0; rows: (first, total) when x holds leading rows ``first ..`` of
    a tensor of `total` leading rows, whose mask is then drawn.  The output
    has x's dtype."""
    if x.shape != h.shape or x.dtype != h.dtype:
        raise ValueError(f"dropout_add_ln: x {tuple(x.shape)} {x.dtype} and "
                         f"h {tuple(h.shape)} {h.dtype} do not agree")
    D = x.shape[-1]
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"dropout_add_ln: scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} are not ({D},)")
    seed = _seed("dropout_add_ln", rate, seed)
    if x.device.type == "cpu":
        gen = _cpu_gen(rate, seed)
        keep = (global_keep(h.shape, rate, gen, rows)
                if rows is not None and rate > 0.0 else None)
        return reference_dropout_add_ln(x, h, scale, bias, rate=rate, eps=eps,
                                        keep=keep, gen=gen)
    _check("dropout_add_ln", x, h)
    _build.require_cuda("dropout_add_ln", x, scale, bias)
    if D > MAX_D:
        raise ValueError(f"dropout_add_ln: row width {D} > {MAX_D} is unsupported")
    return _DropoutAddLN.apply(x, h, scale, bias, float(rate), seed, float(eps),
                               block0(x, rows))


_DROP_ARGS = [_P, _P, _LL, _I, _F, _U, _U, _ULL, _I, _P]


def _dropout_launch(h2, rate, seed, blk0=0):
    out = torch.empty_like(h2)
    fn = _build.bind("fused_norm", _DROP_ENTRY[h2.dtype], _DROP_ARGS)
    err = fn(h2.data_ptr(), out.data_ptr(), h2.shape[0], h2.shape[1],
             1.0 / (1.0 - rate), keep_threshold(rate), seed, blk0,
             _grid("dropout_grid", h2.get_device(), h2.dtype, 0), _build.stream_of(h2))
    if err:
        _build.check(err, "fused_norm", "hw_dropout")
    hw_dropout.launches += 1
    return out


class _HwDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, rate, seed, blk0):
        ctx.static = (rate, seed, blk0)
        return _dropout_launch(_rows(h), rate, seed, blk0).view(h.shape)

    @staticmethod
    def backward(ctx, g):
        return _dropout_launch(_rows(g), *ctx.static).view(g.shape), None, None, None


def hw_dropout(h, *, rate, seed=None, rows=None):
    """Dropout whose mask is regenerated, never stored, in the backward:
    where(keep, h / (1 - rate), 0).  h: (..., D); seed: an int in [0, 2**31);
    rows: as for ``dropout_add_ln``."""
    if rate <= 0.0:
        return h
    seed = _seed("hw_dropout", rate, seed)
    if h.device.type == "cpu":
        gen = _cpu_gen(rate, seed)
        keep = global_keep(h.shape, rate, gen, rows) if rows is not None else None
        return reference_hw_dropout(h, rate=rate, keep=keep, gen=gen)
    _check("hw_dropout", h)
    return _HwDropout.apply(h, float(rate), seed, block0(h, rows))


def _seed(what, rate, seed):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{what}: rate {rate} outside [0, 1)")
    if rate > 0.0 and seed is None:
        raise ValueError(f"{what}: seed is required when rate > 0")
    return 0 if seed is None else int(seed)


def _cpu_gen(rate, seed):
    return torch.Generator().manual_seed(seed) if rate > 0.0 else None


def keep_mask(n_rows, d, *, rate, seed, device, first_row=0):
    """The (n_rows, d) bool mask the kernels use for (rate, seed), written by
    the same device function; for holding a kernel against its plain version.
    `first_row` gives rows ``first_row ..`` of a larger tensor's mask."""
    out = torch.empty((n_rows, d), dtype=torch.bool, device=device)
    _build.require_cuda("fused_norm keep_mask", out)
    fn = _build.bind("fused_norm", "norm_keep_mask", [_P, _LL, _I, _U, _U, _ULL, _P])
    err = fn(out.data_ptr(), n_rows, d, keep_threshold(rate), int(seed),
             first_row * ((d + 3) // 4), _build.stream_of(out))
    _build.check(err, "fused_norm", "fused_norm keep_mask")
    return out


def philox_bits(n, *, seed, stream_id, device):
    """random_bits(seed, stream_id, 0 .. n-1) of ``csrc/common.cuh`` as an
    int64 tensor, for known-answer tests of the generator."""
    out = torch.empty((n,), dtype=torch.int32, device=device)
    _build.require_cuda("philox_bits", out)
    fn = _build.bind("fused_norm", "philox_random_bits", [_P, _LL, _U, _U, _P])
    err = fn(out.data_ptr(), n, int(seed), int(stream_id), _build.stream_of(out))
    _build.check(err, "fused_norm", "philox_bits")
    return out.to(torch.int64) & 0xFFFFFFFF


dropout_add_ln.launches = 0
dropout_add_ln_bwd.launches = 0
hw_dropout.launches = 0
