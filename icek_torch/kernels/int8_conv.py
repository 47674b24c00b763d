"""int8 convolution sites of the int8 encoder and its int8 max pool (port
of what XLA compiled for ``icek_tpu/models/resnet_int8.py``: ``_qconv``
with the epilogue fused into it, and the stem's ``reduce_window``).

``conv_site`` runs ``csrc/int8_conv.cu`` for CUDA tensors and its plain
PyTorch version for CPU tensors.  One call is one site of the encoder: an
int8 NHWC activation times a site's int8 OHWI weight into int32, then, in
the same kernel, ``acc * es + b`` and:

  * without ``inv``: that float32 output (the down convolution);
  * with ``inv``: ReLU and requantization to int8 in [0, 127] at ``inv``,
    after adding a float32 ``shortcut`` (the down convolution's output) or
    an int8 one times ``a_x`` (the block's input) when given;
  * with ``acc``: the int32 accumulators alone (``qconv``, the
    counterpart of ``_qconv``).

The plain version computes the convolution in float64 on the integer
values, which is exact (|acc| <= 127 * 127 * 4608, far below 2**53; float32
is not, above 2**24) and the epilogue in float32 in JAX's order, so the
kernel's int32 and int8 outputs equal it bit for bit.  Shapes: x (B, H, W,
C) int8, weight (N, KH, KW, C) int8 with KH == KW odd and padding
(KH - 1) // 2; N a multiple of 8.  C a multiple of 64 takes the kernel's
16-byte loader; any other C (the stem's 3) is padded with zero channels to
a multiple of 4 and takes its 4-byte loader.  A CUDA call launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from icek_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CONV_ARGTYPES = [_P] * 6 + [_F, _F] + [_I] * 11 + [_P]
_POOL_ARGTYPES = [_P, _P] + [_I] * 4 + [_P]
_MODES = {"f32": 0, "q8": 1, "q8_f32sc": 2, "q8_q8sc": 3, "acc": 4}
_BK = 64            # k bytes a stage in the kernel: Kpad's multiple


def out_hw(h: int, kh: int, stride: int) -> int:
    pad = (kh - 1) // 2
    return (h + 2 * pad - kh) // stride + 1


def reference_qconv(xq, wq, stride: int = 1):
    """Plain int8 x int8 -> int32 convolution, NHWC x OHWI -> NHWC."""
    pad = (wq.shape[1] - 1) // 2
    y = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64),
                 wq.permute(0, 3, 1, 2).to(torch.float64), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def requant_relu(y, inv):
    """ReLU and requantization to the non-negative int8 range (round half
    to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(torch.relu(y) * inv), 0, 127).to(torch.int8)


def reference_site(xq, site, stride: int = 1, inv=None, shortcut=None, a_x=None):
    """Plain version of ``conv_site`` (same arguments)."""
    acc = reference_qconv(xq, site["wq"], stride)
    y = acc.to(torch.float32) * site["es"] + site["b"]
    if inv is None:
        return y
    if shortcut is not None:
        y = y + (shortcut if shortcut.dtype == torch.float32
                 else shortcut.to(torch.float32) * a_x)
    return requant_relu(y, inv)


def reference_max_pool(xq):
    """Plain 3x3 / 2 max pool with padding 1 over int8 NHWC, -128 outside
    the image (the int8 identity of JAX's reduce_window)."""
    B, H, W, C = xq.shape
    xp = F.pad(xq.permute(0, 3, 1, 2), (1, 1, 1, 1), value=-128)
    Ho, Wo = out_hw(H, 3, 2), out_hw(W, 3, 2)
    out = None
    for dh in range(3):
        for dw in range(3):
            win = xp[:, :, dh:dh + 2 * Ho - 1:2, dw:dw + 2 * Wo - 1:2]
            out = win if out is None else torch.maximum(out, win)
    return out.permute(0, 2, 3, 1).contiguous()


def _gemm_operands(xq, wq):
    """(x, (N, Kpad) weight) as the kernel takes them: C padded with zero
    channels to a multiple of 4 where it is not a multiple of 64 (the stem),
    K = KH * KW * C padded with zeros to a multiple of 64."""
    C = xq.shape[3]
    if C % 64:
        cp = -C % 4
        if cp:
            xq, wq = F.pad(xq, (0, cp)), F.pad(wq, (0, cp))
    N = wq.shape[0]
    w = wq.reshape(N, -1)
    kp = -w.shape[1] % _BK
    if kp:
        w = F.pad(w, (0, kp))
    return xq.contiguous(), w.contiguous()


def conv_site(xq, site, stride: int = 1, inv=None, shortcut=None, a_x=None,
              acc: bool = False):
    """One int8 site: x (B, H, W, C) int8, ``site`` {"wq" (N, KH, KW, C)
    int8, "es" (N,) f32, "b" (N,) f32}.  ``inv`` None -> float32 (B, Ho,
    Wo, N); else int8 codes, after adding `shortcut` ((B, Ho, Wo, N) f32,
    or int8 times `a_x`) when given.  ``acc`` returns the int32
    accumulators instead (``qconv``).  `inv` and `a_x` are Python floats or
    0-dim tensors on the CPU (a CUDA scalar would cost a sync)."""
    wq = site["wq"]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_site: int8 operands expected, got {xq.dtype}, {wq.dtype}")
    N, KH, KW, C = wq.shape
    if xq.dim() != 4 or xq.shape[3] != C or KH != KW or KH % 2 == 0 or N % 8:
        raise ValueError(f"conv_site: x {tuple(xq.shape)} and weight {tuple(wq.shape)} "
                         f"do not agree (square odd kernel, N % 8 == 0)")
    mode = "acc" if acc else "f32" if inv is None else (
        "q8" if shortcut is None else
        "q8_f32sc" if shortcut.dtype == torch.float32 else "q8_q8sc")
    B, H, W, _ = xq.shape
    Ho, Wo = out_hw(H, KH, stride), out_hw(W, KW, stride)
    if shortcut is not None and (tuple(shortcut.shape) != (B, Ho, Wo, N)
                                 or shortcut.dtype not in (torch.float32, torch.int8)):
        raise ValueError(f"conv_site: shortcut {tuple(shortcut.shape)} {shortcut.dtype}, "
                         f"expected {(B, Ho, Wo, N)} float32 or int8")
    if mode == "q8_q8sc" and a_x is None:
        raise ValueError("conv_site: an int8 shortcut needs a_x")
    if xq.device.type == "cpu":
        if mode == "acc":
            return reference_qconv(xq, wq, stride)
        return reference_site(xq, site, stride, inv, shortcut, a_x)
    es, bias = site["es"], site["b"]
    _build.require_cuda("conv_site", xq, wq, es, bias)
    if es.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("conv_site: es and b must be float32")
    if shortcut is not None:
        _build.require_cuda("conv_site", xq, shortcut)
        shortcut = shortcut.contiguous()
    x, w = _gemm_operands(xq, wq)
    out_dtype = {"f32": torch.float32, "acc": torch.int32}.get(mode, torch.int8)
    out = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=xq.device)
    fn = _build.bind("int8_conv", "int8_conv", _CONV_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), es.contiguous().data_ptr(),
             bias.contiguous().data_ptr(),
             shortcut.data_ptr() if shortcut is not None else None, out.data_ptr(),
             float(a_x) if a_x is not None else 0.0, float(inv) if inv is not None else 0.0,
             B, H, W, x.shape[3], N, KH, KW, stride, (KH - 1) // 2, w.shape[1],
             _MODES[mode], _build.stream_of(xq))
    _build.check(err, "int8_conv", "conv_site")
    conv_site.launches += 1
    return out


conv_site.launches = 0


def qconv(xq, wq, stride: int = 1):
    """int8 x int8 -> int32 convolution (``_qconv``): NHWC x OHWI -> NHWC.
    On CUDA, the site kernel with no epilogue (counted in
    ``conv_site.launches``)."""
    N = wq.shape[0]
    dummy = torch.zeros(N, dtype=torch.float32, device=xq.device)
    return conv_site(xq, {"wq": wq, "es": dummy, "b": dummy}, stride, acc=True)


def max_pool(xq):
    """3x3 / 2 max pool, padding 1, of int8 NHWC (B, H, W, C) -> (B, Ho,
    Wo, C), -128 outside the image."""
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise TypeError(f"max_pool: int8 NHWC expected, got {xq.dtype} {tuple(xq.shape)}")
    if xq.device.type == "cpu":
        return reference_max_pool(xq)
    _build.require_cuda("max_pool", xq)
    B, H, W, C = xq.shape
    if C % 4:
        raise ValueError(f"max_pool: {C} channels (a multiple of 4)")
    xq = xq.contiguous()
    out = torch.empty((B, out_hw(H, 3, 2), out_hw(W, 3, 2), C), dtype=torch.int8,
                      device=xq.device)
    fn = _build.bind("int8_conv", "int8_maxpool", _POOL_ARGTYPES)
    _build.check(fn(xq.data_ptr(), out.data_ptr(), B, H, W, C, _build.stream_of(xq)),
                 "int8_conv", "max_pool")
    max_pool.launches += 1
    return out


max_pool.launches = 0
