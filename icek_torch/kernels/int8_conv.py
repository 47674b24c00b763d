"""int8 convolution sites of the int8 encoder and its int8 max pool (port
of what XLA compiled for ``icek_tpu/models/resnet_int8.py``: ``_qconv``
with the epilogue fused into it, the input quantization before the stem,
and the stem's ``reduce_window``).

``conv_site``, ``fused_site`` and ``stem_site`` run ``csrc/int8_conv.cu``
for CUDA tensors and their plain PyTorch versions for CPU tensors.  One
``conv_site`` call is one site of the encoder: an int8 NHWC activation
times a site's int8 OHWI weight into int32, then, in the same kernel,
``acc * es + b`` and:

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
(KH - 1) // 2; N a multiple of 8.

``fused_site`` is a bottleneck's block 0 in one launch: conv3 over the
block's mid activation and the down convolution over its input, requantized
as ``q(site(conv3) + site(down))`` without the float32 shortcut in device
memory.  ``stem_site`` is the stem from the normalized float32 images: it
quantizes them itself (``quantize_images``) and reads them through their
strides.

Routes (``route``; each launch counts under its name in
``conv_site.routes``, and every launch in ``conv_site.launches``): C and N
multiples of 64 take the wgmma kernel, its A tiles by TMA as rows of a
matrix at a 1x1 / 1 site ("tma"), by TMA as 4D boxes where a 128-row tile
is whole output rows of one image or whole images ("tma_box": the
encode's 3x3 and strided sites), or gathered by its producer ("gather");
``fused_site`` is "fused", ``stem_site`` "stem"; any other shape (C not a
multiple of 64, such as the int8 stem through ``conv_site``, padded to 4
channels; N not a multiple of 64) takes the mma.sync kernel
("mma_sync").  A CUDA call launches its route's kernel or raises.
"""

from __future__ import annotations

import ctypes
import types

import torch
import torch.nn.functional as F

from icek_torch.kernels import _build

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_CONV_ARGTYPES = [_P] * 6 + [_F, _F] + [_I] * 11 + [_P]
_FUSED_ARGTYPES = [_P] * 9 + [_F] + [_I] * 7 + [_P]
_STEM_ARGTYPES = [_P] + [_L] * 4 + [_P] * 4 + [_F, _F] + [_I] * 5 + [_P]
_POOL_ARGTYPES = [_P, _P] + [_I] * 4 + [_P]
_MODES = {"f32": 0, "q8": 1, "q8_f32sc": 2, "q8_q8sc": 3, "acc": 4}
_BK = 64            # k bytes a stage in the mma.sync kernel: Kpad's multiple
ROUTES = ("tma", "tma_box", "gather", "fused", "stem", "mma_sync")
TILE_ROWS = 128     # output pixels a tile of the wgmma kernel
STEM_K = 256        # the stem's k: 7 kernel rows of 32 bytes (21 used), then zeros


def box_tile(Ho: int, Wo: int):
    """A tile of 128 output pixels as (output rows, images) of a box: whole
    rows of one image or whole images; None where it is neither."""
    P = Ho * Wo
    if P % TILE_ROWS == 0 and TILE_ROWS % Wo == 0:
        return TILE_ROWS // Wo, 1
    if TILE_ROWS % P == 0:
        return Ho, TILE_ROWS // P
    return None


def a_load(KH: int, stride: int, Ho: int, Wo: int) -> str:
    """How the wgmma kernel's A tiles arrive (``hop::a_load``)."""
    if KH == 1 and stride == 1:
        return "tma"
    box = box_tile(Ho, Wo)
    if box is not None and stride * Wo <= 256 and stride * box[0] <= 256:
        return "tma_box"
    return "gather"


def route(C: int, N: int, KH: int, stride: int, H: int, W: int) -> str:
    """The route ``conv_site`` takes on CUDA for an H x W input
    (``int8_conv_route`` in the source decides the same)."""
    if C % 64 or N % 64:
        return "mma_sync"
    return a_load(KH, stride, out_hw(H, KH, stride), out_hw(W, KH, stride))


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


def quantize_images(images, inv_img):
    """Normalized float images -> int8 codes in [-127, 127] (round half to
    even), as the encoder's input."""
    return torch.clamp(torch.round(images.to(torch.float32) * inv_img), -127, 127
                       ).to(torch.int8)


def reference_fused_site(out, xq, conv3, down, stride: int, inv):
    """Plain version of ``fused_site``: the down site, then conv3's with it
    as the float32 shortcut."""
    return reference_site(out, conv3, 1, inv, shortcut=reference_site(xq, down, stride))


def reference_stem_site(images, site, inv_img, inv=None, acc: bool = False):
    """Plain version of ``stem_site``: the quantization, then the stem site
    (7x7 / 2)."""
    xq = quantize_images(images, inv_img)
    if acc:
        return reference_qconv(xq, site["wq"], 2)
    return reference_site(xq, site, 2, inv)


def stem_weight(wq):
    """(N, 7, 7, 3) int8 -> (N, 256): k = 32 kh + 3 kw + ci, zeros elsewhere
    (kernel row kh's 21 taps x channels in a 32-byte block)."""
    N = wq.shape[0]
    w = torch.zeros((N, 8, 32), dtype=torch.int8, device=wq.device)
    w[:, :7, :21] = wq.reshape(N, 7, 21)
    return w.reshape(N, STEM_K)


def _aligned(what: str, *tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned (TMA, cp.async)")


def _param(t):
    """es or b as the kernel bulk-copies it: contiguous, 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(name: str) -> None:
    conv_site.routes[name].launches += 1
    conv_site.launches += 1


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
    name = route(C, N, KH, stride, H, W)
    if name != "mma_sync":
        _aligned("conv_site", x, w, *([shortcut] if shortcut is not None else []))
    out_dtype = {"f32": torch.float32, "acc": torch.int32}.get(mode, torch.int8)
    out = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=xq.device)
    es, bias = _param(es), _param(bias)
    fn = _build.bind("int8_conv", "int8_conv", _CONV_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), es.data_ptr(), bias.data_ptr(),
             shortcut.data_ptr() if shortcut is not None else None, out.data_ptr(),
             float(a_x) if a_x is not None else 0.0, float(inv) if inv is not None else 0.0,
             B, H, W, x.shape[3], N, KH, KW, stride, (KH - 1) // 2, w.shape[1],
             _MODES[mode], _build.stream_of(xq))
    _build.check(err, "int8_conv", "conv_site")
    _count(name)
    return out


conv_site.launches = 0
conv_site.routes = {r: types.SimpleNamespace(launches=0) for r in ROUTES}


def _site_params(what: str, site, cin: int, N: int):
    wq = site["wq"]
    if wq.dtype != torch.int8 or tuple(wq.shape[1:]) != (1, 1, cin) or wq.shape[0] != N:
        raise ValueError(f"{what}: 1x1 weight ({N}, 1, 1, {cin}) int8 expected, "
                         f"got {tuple(wq.shape)} {wq.dtype}")
    if site["es"].dtype != torch.float32 or site["b"].dtype != torch.float32:
        raise TypeError(f"{what}: es and b must be float32")
    return wq.reshape(N, cin).contiguous(), _param(site["es"]), _param(site["b"])


def fused_site(out, xq, conv3, down, stride: int, inv):
    """A bottleneck's block 0: ``q(site(conv3)(out) + site(down)(xq))`` in
    one launch, equal code for code to ``conv_site(out, conv3, 1, inv=inv,
    shortcut=conv_site(xq, down, stride))``.  out (B, Ho, Wo, Cmid) and xq
    (B, H, W, Cin) int8, Ho = (H - 1) // stride + 1; conv3 and down 1x1
    sites with Cin, Cmid and N multiples of 64 on CUDA."""
    if out.dtype != torch.int8 or xq.dtype != torch.int8 or out.dim() != 4 or xq.dim() != 4:
        raise TypeError("fused_site: int8 NHWC activations expected")
    B, H, W, cin = xq.shape
    Ho, Wo, cmid = out_hw(H, 1, stride), out_hw(W, 1, stride), out.shape[3]
    N = conv3["wq"].shape[0]
    if tuple(out.shape[:3]) != (B, Ho, Wo):
        raise ValueError(f"fused_site: out {tuple(out.shape)} is not the down site's "
                         f"{(B, Ho, Wo)} at stride {stride}")
    w3, es3, b3 = _site_params("fused_site conv3", conv3, cmid, N)
    wd, esd, bd = _site_params("fused_site down", down, cin, N)
    if xq.device.type == "cpu":
        return reference_fused_site(out, xq, conv3, down, stride, inv)
    _build.require_cuda("fused_site", out, xq, w3, wd, es3, b3, esd, bd)
    if cin % 64 or cmid % 64 or N % 64:
        raise ValueError(f"fused_site: Cin {cin}, Cmid {cmid}, N {N} must be multiples of 64")
    x, y = xq.contiguous(), out.contiguous()
    _aligned("fused_site", x, y, w3, wd)
    res = torch.empty((B, Ho, Wo, N), dtype=torch.int8, device=xq.device)
    fn = _build.bind("int8_conv", "int8_conv_fused", _FUSED_ARGTYPES)
    err = fn(x.data_ptr(), wd.data_ptr(), esd.data_ptr(), bd.data_ptr(), y.data_ptr(),
             w3.data_ptr(), es3.data_ptr(), b3.data_ptr(), res.data_ptr(), float(inv),
             B, H, W, cin, cmid, N, stride, _build.stream_of(xq))
    _build.check(err, "int8_conv", "fused_site")
    _count("fused")
    return res


def stem_site(images, site, inv_img, inv=None, acc: bool = False):
    """The stem from normalized float images (B, H, W, 3), any strides
    (``normalize_in_graph``'s planar view included): quantized at
    ``inv_img`` and convolved 7x7 / 2 with ``site``'s (64, 7, 7, 3) weight,
    requantized at ``inv`` (int8 codes), or the int32 sums with ``acc``.
    Equal to ``conv_site(quantize_images(images, inv_img), site, 2, inv=inv)``."""
    wq = site["wq"]
    if images.dim() != 4 or images.shape[3] != 3 or wq.dtype != torch.int8 or \
            tuple(wq.shape[1:]) != (7, 7, 3):
        raise ValueError(f"stem_site: images {tuple(images.shape)} and weight "
                         f"{tuple(wq.shape)} {wq.dtype}: (B, H, W, 3) and (N, 7, 7, 3) int8")
    if not acc and inv is None:
        raise ValueError("stem_site: inv (or acc=True) is needed")
    if images.device.type == "cpu":
        return reference_stem_site(images, site, inv_img, inv, acc)
    es, bias = site["es"], site["b"]
    _build.require_cuda("stem_site", images, wq, es, bias)
    N = wq.shape[0]
    if N != 64 or es.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError(f"stem_site: {N} output channels (64) and float32 es, b expected")
    x = images if images.dtype == torch.float32 else images.to(torch.float32)
    w = stem_weight(wq)
    B, H, W, _ = x.shape
    out = torch.empty((B, out_hw(H, 7, 2), out_hw(W, 7, 2), N),
                      dtype=torch.int32 if acc else torch.int8, device=x.device)
    fn = _build.bind("int8_conv", "int8_stem", _STEM_ARGTYPES)
    err = fn(x.data_ptr(), *x.stride(), w.data_ptr(), _param(es).data_ptr(),
             _param(bias).data_ptr(), out.data_ptr(), float(inv_img),
             float(inv) if inv is not None else 0.0, B, H, W, N, _MODES["acc" if acc else "q8"],
             _build.stream_of(x))
    _build.check(err, "int8_conv", "stem_site")
    _count("stem")
    return out


def qconv(xq, wq, stride: int = 1):
    """int8 x int8 -> int32 convolution (``_qconv``): NHWC x OHWI -> NHWC.
    On CUDA, the site kernel with no epilogue (counted in
    ``conv_site.launches``)."""
    N = wq.shape[0]
    dummy = torch.zeros(N, dtype=torch.float32, device=xq.device)
    return conv_site(xq, {"wq": wq, "es": dummy, "b": dummy}, stride, acc=True)


# the most channels the strip kernel takes: three input pixels of one output
# pixel fill its shared memory (POOL_MAX_C in csrc/int8_conv.cu)
POOL_MAX_C = 10920


def max_pool(xq):
    """3x3 / 2 max pool, padding 1, of int8 NHWC (B, H, W, C) -> (B, Ho,
    Wo, C), -128 outside the image.  On CUDA the strip kernel
    (``maxpool_strip_kernel``: a block stages the input rows of a strip of
    output rows in shared memory, whole rows where three fit in its 96 KB,
    else segments of columns), any H and W, C a multiple of 4 up to
    ``POOL_MAX_C``, B up to 65535."""
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise TypeError(f"max_pool: int8 NHWC expected, got {xq.dtype} {tuple(xq.shape)}")
    if xq.device.type == "cpu":
        return reference_max_pool(xq)
    _build.require_cuda("max_pool", xq)
    B, H, W, C = xq.shape
    if C % 4 or C > POOL_MAX_C or B > 65535:
        raise ValueError(f"max_pool: {C} channels (a multiple of 4, at most {POOL_MAX_C}) "
                         f"and batch {B} (at most 65535)")
    xq = xq.contiguous()
    if xq.data_ptr() % 16:          # the strip kernel stages 16-byte aligned rows
        xq = xq.clone()
    out = torch.empty((B, out_hw(H, 3, 2), out_hw(W, 3, 2), C), dtype=torch.int8,
                      device=xq.device)
    fn = _build.bind("int8_conv", "int8_maxpool", _POOL_ARGTYPES)
    _build.check(fn(xq.data_ptr(), out.data_ptr(), B, H, W, C, _build.stream_of(xq)),
                 "int8_conv", "max_pool")
    max_pool.launches += 1
    return out


max_pool.launches = 0
