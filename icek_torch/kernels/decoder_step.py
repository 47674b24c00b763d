"""Decoder-step megakernel (port of ``icek_tpu/kernels/decoder_step.py``).

``fused_beam_decoder_step`` runs one whole decoder-stack step for every
(image, hypothesis) of a beam batch: ``csrc/decoder_step.cu`` for CUDA
tensors, and for CPU tensors its plain version, which is the stock beam
step ``decode/beam.py::_beam_decoder_step`` itself.

Semantics are those of the stock step given the beam loop's invariant
that ``ancestry[:, :, i]`` is each hypothesis's own slot: the kernel
attends to the current step's K/V directly and returns them; the caller
writes them at cache rows ``i*K .. i*K+K-1``.  The ancestry goes in as
int32 (B, K, L) indices (the JAX kernel takes a one-hot selector), and
the cross K/V as (nL, B, M, D) with M the true memory length (no lane
padding), or head-major with the head dim padded to 32, or to 64 for
heads of 33 to 64 dims (``pad_cross_heads``, laid out once per decode
batch).

A CUDA call takes one of two kernels, by ``uses_tensor_cores`` alone:
bfloat16 and float32 at widths the tensor-core kernel holds (10 heads of at
most 64 dims, such as the presets' 10 heads of 30 and ``--geometry
512x8``'s 8 heads of 64; shared memory within the card's, weights stacked
with their packed copy) run ``decoder_step_mma_kernel<T, HP>`` (the linears
and the cross attention on the tensor cores: bf16 products, or three TF32
products each in f32; the weights packed by ``pack_mma`` / ``pack_tf32``;
HP the head pad, whose cross ring stages 16 bf16 or 8 f32 memory rows at
64), G images a block up to 16 hypotheses an image and ``image_parts``
blocks an image above; the rest (more than 10 heads, heads wider than 64
or odd, weights without the packed copy) run the CUDA-core
``decoder_step_kernel``.  Neither gives way to the other or to the plain
version.  Each route counts its launches
in ``fused_beam_decoder_step.routes`` (``route``: tensor_cores,
tensor_cores_f32, wide_tensor_cores, wide_tensor_cores_f32, cuda_cores);
``fused_beam_decoder_step.launches`` counts them all.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import List, NamedTuple, Optional

import torch

from icek_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 23 + [_I] * 9 + [_F, _P]
_MMA_ARGTYPES = [_P] * 23 + [_I] * 11 + [_F, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the tensor-core kernel (csrc/decoder_step.cu, route 1)
ROWS = 16           # hypothesis rows of a block (one m16 tile)
WARPS = 10          # warps of a block; warp h takes head h of the cross attention
HEAD_PAD = 32       # head dim of the padded cross layout, heads of at most 32 dims
WIDE_HEAD_PAD = 64  # ... heads of 33 to 64 dims
CROSS_TILE = {torch.bfloat16: 32, torch.float32: 16}   # memory rows of a cross ring stage
WIDE_CROSS_TILE = {torch.bfloat16: 16, torch.float32: 8}   # ... at the wide head pad
KPAIR = {torch.bfloat16: 32, torch.float32: 16}        # depth of a lane's 16-byte weight load
CROSS_STAGES = 3
MAX_SMEM = 232448   # shared memory a block may use on sm_90
ROUTES = ("tensor_cores", "tensor_cores_f32", "wide_tensor_cores", "wide_tensor_cores_f32",
          "cuda_cores")


class PackedLinears(NamedTuple):
    """The six linears of every layer in B-fragment order (``pack_mma`` for
    bf16, ``pack_tf32`` for f32)."""
    qkv: torch.Tensor
    so: torch.Tensor
    cq: torch.Tensor
    co: torch.Tensor
    f1: torch.Tensor
    f2: torch.Tensor


class StackedDecoder(NamedTuple):
    """Decoder weights restacked with a leading layer axis for the kernel
    (weights in the compute dtype, biases and norms f32), plus the
    per-layer dicts the plain version runs on."""
    qkv_w: torch.Tensor   # (nL, D, 3D)
    qkv_b: torch.Tensor   # (nL, 3D)
    so_w: torch.Tensor    # (nL, D, D) self-attention out projection
    so_b: torch.Tensor
    cq_w: torch.Tensor    # (nL, D, D) cross-attention query projection
    cq_b: torch.Tensor
    co_w: torch.Tensor    # (nL, D, D) cross-attention out projection
    co_b: torch.Tensor
    f1_w: torch.Tensor    # (nL, D, F)
    f1_b: torch.Tensor
    f2_w: torch.Tensor    # (nL, F, D)
    f2_b: torch.Tensor
    ln_s: torch.Tensor    # (nL, 3, D)
    ln_b: torch.Tensor
    layers: List[dict]
    mma: Optional[PackedLinears] = None   # the tensor-core route's weights


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_mma(w):
    """(nL, din, dout) weights -> (nL, dout/8, din/32, 32, 8): for each n8
    tile and each pair of k16 steps, lane l = 4 g + t's two B fragments of
    mma.sync m16n8k16 (b0, b1 of the even step, then of the odd one), B[k][n]
    = w[k0 + k][n0 + n], so a lane loads both steps with one 16-byte load.
    Register j = 2 s + h of a lane holds w[32 kp + 16 s + 8 h + 2 t + e][8 nt +
    g] at half e.  din is zero-padded to a multiple of 32, dout of 8."""
    nL, din, dout = w.shape
    dk, dn = _round_up(din, 32), _round_up(dout, 8)
    wp = torch.zeros((nL, dk, dn), dtype=w.dtype, device=w.device)
    wp[:, :din, :dout] = w
    # k = 32 kp + 16 s + 8 h + 2 t + e, n = 8 nt + g
    v = wp.view(nL, dk // 32, 2, 2, 4, 2, dn // 8, 8)        # l kp s h t e nt g
    return v.permute(0, 6, 1, 7, 4, 2, 3, 5).reshape(nL, dn // 8, dk // 32, 32, 8).contiguous()


def pack_tf32(w):
    """(nL, din, dout) f32 weights -> (nL, dout/8, din/16, 32, 4): for each n8
    tile and each pair of k8 steps, lane l = 4 g + t's B fragments of
    mma.sync m16n8k8 (b0 = B[t][g], b1 = B[t + 4][g] of the even step, then
    of the odd one), so a lane loads both steps with one 16-byte load; the
    kernel splits each value into TF32 hi and lo.  Register j = 2 s + h of a
    lane holds w[16 kp + 8 s + 4 h + t][8 nt + g].  din is zero-padded to a
    multiple of 16, dout of 8."""
    nL, din, dout = w.shape
    dk, dn = _round_up(din, 16), _round_up(dout, 8)
    wp = torch.zeros((nL, dk, dn), dtype=w.dtype, device=w.device)
    wp[:, :din, :dout] = w
    # k = 16 kp + 8 s + 4 h + t, n = 8 nt + g
    v = wp.view(nL, dk // 16, 2, 2, 4, dn // 8, 8)           # l kp s h t nt g
    return v.permute(0, 5, 1, 6, 4, 2, 3).reshape(nL, dn // 8, dk // 16, 32, 4).contiguous()


def stack_decoder_params(decoder_params, dtype=torch.float32) -> StackedDecoder:
    """Restack the per-layer param dicts (a layout transform done once per
    decode batch, outside the step loop)."""
    layers = decoder_params["layers"]
    D = layers[0]["self_attn"]["qkv_w"].shape[0]

    def stack(get, dt=dtype):
        return torch.stack([get(lay).to(dt) for lay in layers]).contiguous()

    def stack_b(get):
        return stack(get, torch.float32)

    st = StackedDecoder(
        qkv_w=stack(lambda l: l["self_attn"]["qkv_w"]),
        qkv_b=stack_b(lambda l: l["self_attn"]["qkv_b"]),
        so_w=stack(lambda l: l["self_attn"]["out"]["w"]),
        so_b=stack_b(lambda l: l["self_attn"]["out"]["b"]),
        cq_w=stack(lambda l: l["cross_attn"]["qkv_w"][:, :D]),
        cq_b=stack_b(lambda l: l["cross_attn"]["qkv_b"][:D]),
        co_w=stack(lambda l: l["cross_attn"]["out"]["w"]),
        co_b=stack_b(lambda l: l["cross_attn"]["out"]["b"]),
        f1_w=stack(lambda l: l["ffn"]["lin1"]["w"]),
        f1_b=stack_b(lambda l: l["ffn"]["lin1"]["b"]),
        f2_w=stack(lambda l: l["ffn"]["lin2"]["w"]),
        f2_b=stack_b(lambda l: l["ffn"]["lin2"]["b"]),
        ln_s=stack_b(lambda l: torch.stack([l[f"norm{n}"]["scale"] for n in (1, 2, 3)])),
        ln_b=stack_b(lambda l: torch.stack([l[f"norm{n}"]["bias"] for n in (1, 2, 3)])),
        layers=layers,
    )
    pack = {torch.bfloat16: pack_mma, torch.float32: pack_tf32}.get(dtype)
    if pack is None:
        return st
    return st._replace(mma=PackedLinears(*(pack(w) for w in (
        st.qkv_w, st.so_w, st.cq_w, st.co_w, st.f1_w, st.f2_w))))


def stack_cross_kv(cross_kvs, dtype):
    """[{'k','v'} of (B, M, H, Hd)] per layer -> (nL, B, M, D) K and V."""
    def stack(key):
        return torch.stack(
            [c[key].reshape(c[key].shape[0], c[key].shape[1], -1) for c in cross_kvs]
        ).to(dtype).contiguous()

    return stack("k"), stack("v")


def head_pad(head_dim: int) -> int:
    """The head dim of the padded cross layout (csrc/decoder_step.cu::head_pad):
    32 for heads of at most 32 dims, 64 above."""
    return HEAD_PAD if head_dim <= HEAD_PAD else WIDE_HEAD_PAD


def cross_tile(dtype, head_dim: int) -> int:
    """Memory rows of a cross ring stage (csrc/decoder_step.cu::xt_of): 32
    bf16 or 16 f32 rows at pad 32, 16 bf16 or 8 f32 rows at pad 64."""
    return (CROSS_TILE if head_pad(head_dim) == HEAD_PAD else WIDE_CROSS_TILE)[dtype]


def kv_out(dtype, head_dim: int) -> bool:
    """Whether the kernel's block keeps q alone in its projection buffer and
    reads the step's own K/V rows back from k_new / v_new
    (csrc/decoder_step.cu::kv_out): f32 at pad 64."""
    return dtype == torch.float32 and head_pad(head_dim) == WIDE_HEAD_PAD


def pad_cross_heads(cross_kvs, dtype):
    """[{'k','v'} of (B, M, H, Hd)] per layer -> (nL, B, M, H * P) K and V,
    head-major with each head's dims zero-padded to P = ``head_pad(Hd)`` (32,
    or 64 above 32 dims): the tensor-core route's layout (16-byte aligned
    rows and heads)."""
    pad = head_pad(cross_kvs[0]["k"].shape[-1])

    def stack(key):
        return torch.stack([torch.nn.functional.pad(c[key], (0, pad - c[key].shape[-1]))
                            .reshape(c[key].shape[0], c[key].shape[1], -1)
                            for c in cross_kvs]).to(dtype).contiguous()

    return stack("k"), stack("v")


def mma_smem_bytes(D: int, H: int, F: int, L: int, dtype=torch.bfloat16) -> int:
    """Shared memory of a tensor-core block (csrc/decoder_step.cu::mma_smem)
    at the head pad of D / H: row pitches padded by 16 bytes past whole
    k-pairs; bf16 keeps x in f32 beside its bf16 copy, f32's x is its own A
    operand; the projection buffer 3D wide, or D (``kv_out``); a three-stage
    ring of ``cross_tile`` memory rows."""
    e, kp = dtype.itemsize, KPAIR[dtype]
    pad = 16 // e
    pa, pf = _round_up(D, kp) + pad, _round_up(F, kp) + pad
    pq = H * head_pad(D // H) + pad
    pb = max(_round_up(D if kv_out(dtype, D // H) else 3 * D, 8), pq, pf)
    xa = _round_up(4 * ROWS * D, 16) if e == 2 else 0
    ring = _round_up(xa + e * ROWS * (2 * pa + pb) + 4 * ROWS * L, 16)
    return ring + e * CROSS_STAGES * 2 * cross_tile(dtype, D // H) * pq


def uses_tensor_cores(stacked: StackedDecoder, caches_k, K: int, num_heads: int) -> bool:
    """Whether a CUDA call with these weights, caches and beam width takes the
    tensor-core kernel: bfloat16 or float32 with packed weights, any K >= 1
    (G images a block up to 16, ``image_parts`` blocks an image above), at
    most 10 heads of an even head dim <= 64 (pad 64 from 33 dims on), an
    even FFN width, and a block's shared memory within the card's (f32 at
    512x8: 200,064 bytes with 8-row stages and ``kv_out``)."""
    nL, B, LK, D = caches_k.shape
    H, F = num_heads, stacked.f1_w.shape[-1]
    dt = caches_k.dtype
    if dt not in CROSS_TILE or stacked.mma is None or K < 1:
        return False
    if H > WARPS or D % H or (D // H) % 2 or D // H > WIDE_HEAD_PAD or F % 2:
        return False
    return mma_smem_bytes(D, H, F, LK // K, dt) <= MAX_SMEM


def route(dtype, K: int, tensor_cores: bool) -> str:
    """The name a call counts its launch under in ``fused_beam_decoder_step.routes``."""
    if not tensor_cores:
        return "cuda_cores"
    return ("wide_" if K > ROWS else "") + "tensor_cores" + ("_f32" if dtype == torch.float32 else "")


def supports(stacked: StackedDecoder, caches_k, K: int, num_heads: int) -> bool:
    """Whether a CUDA call with these weights, caches and beam width is
    accepted: the tensor-core route (``uses_tensor_cores``), or float32 /
    bfloat16 of any width on the CUDA-core route (the shapes the tensor-core
    kernel refuses), whose blocks take up to 8 hypotheses of an image each.
    A call outside it raises."""
    return caches_k.dtype in _SUFFIX and K >= 1


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def images_per_block(B: int, K: int, sms: int) -> int:
    """G of the tensor-core kernel: as many images a block as its 16 rows
    hold, but no more than a wave of `sms` blocks needs (G = 2 at B = 256,
    K = 5 on 132 SMs: 128 blocks)."""
    return max(1, min(ROWS // K, -(-B // sms)))


def image_parts(B: int, K: int, sms: int) -> int:
    """S of the tensor-core kernel: the blocks an image's K hypotheses are
    split over, each block streaming the image's memory.  1 up to ROWS;
    above, as few as 16 rows a block allow, but parts of down to 8 rows
    while the grid is short of a wave of `sms` blocks (geo beam 20 at 32
    images on 132 SMs: 3 blocks of 7, 7, 6 rows; at 256 images: 2 of 10)."""
    if K <= ROWS:
        return 1
    return max(-(-K // ROWS), min(-(-K // 8), -(-sms // B)))


def reference_decoder_step(stacked: StackedDecoder, x, ancestry, caches_k,
                           caches_v, cross_k, cross_v, i: int, *, num_heads: int):
    """Plain version: the stock beam step on copies of the caches."""
    from icek_torch.decode import beam

    nL, B, LK, D = caches_k.shape
    K = x.shape[1]
    M = cross_k.shape[2]
    Hd = D // num_heads
    dt = caches_k.dtype
    ck, cv = caches_k.clone(), caches_v.clone()
    cross = [{"k": cross_k[l].view(B, M, num_heads, Hd),
              "v": cross_v[l].view(B, M, num_heads, Hd)} for l in range(nL)]
    h = beam._beam_decoder_step(stacked.layers, x.to(dt), (ck, cv), ancestry, i,
                                cross, num_heads, dt)
    rows = slice(i * K, (i + 1) * K)
    return h.to(torch.float32), ck[:, :, rows].contiguous(), cv[:, :, rows].contiguous()


def fused_beam_decoder_step(stacked: StackedDecoder, x, ancestry, caches_k,
                            caches_v, cross_k, cross_v, i: int, *,
                            num_heads: int, eps: float = 1e-5, cross_heads=None):
    """One decoder-stack step for every (image, hypothesis).

    x (B, K, D); ancestry int32 (B, K, L); caches (nL, B, L*K, D); cross
    K/V (nL, B, M, D), or None when ``cross_heads`` holds them as
    ``pad_cross_heads`` lays them out ((nL, B, M, H * head_pad(Hd)) K and V,
    which the tensor-core kernel reads; the other routes undo the padding); i
    the step index.  Returns (h (B, K, D) f32, k_new, v_new (nL, B, K, D)
    in the caches' dtype).
    """
    nL, B, LK, D = caches_k.shape
    K = x.shape[1]
    L = LK // K
    H = num_heads
    if cross_k is None or cross_v is None:
        if cross_heads is None:
            raise ValueError("fused_beam_decoder_step: no cross K/V given")
        M = cross_heads[0].shape[2]
    else:
        M = cross_k.shape[2]
    pad = head_pad(D // H) if H > 0 and D % H == 0 else 0
    heads_ok = cross_heads is None or all(
        c.shape == (nL, B, M, H * pad) for c in cross_heads)
    if (x.shape != (B, K, D) or ancestry.shape != (B, K, L)
            or caches_v.shape != caches_k.shape or D % H or not heads_ok
            or (cross_k is not None and (cross_k.shape != (nL, B, M, D)
                                         or cross_v.shape != cross_k.shape))
            or not 0 <= i < L):
        raise ValueError(
            f"fused_beam_decoder_step: x {tuple(x.shape)} ancestry "
            f"{tuple(ancestry.shape)} caches {tuple(caches_k.shape)} cross "
            f"{None if cross_k is None else tuple(cross_k.shape)} step {i} "
            f"heads {H} do not agree")

    def unpadded():   # pad_cross_heads undone
        return [c.view(nL, B, M, H, pad)[..., :D // H].reshape(nL, B, M, D)
                for c in cross_heads]

    if x.device.type == "cpu":
        if cross_k is None:
            cross_k, cross_v = unpadded()
        return reference_decoder_step(stacked, x, ancestry, caches_k, caches_v,
                                      cross_k, cross_v, i, num_heads=H)
    dt = caches_k.dtype
    if not supports(stacked, caches_k, K, H):
        raise ValueError(f"fused_beam_decoder_step: dtype {dt}, K={K} unsupported")
    tc = uses_tensor_cores(stacked, caches_k, K, H)
    if tc:
        if cross_heads is None:
            cross_heads = pad_cross_heads(
                [{"k": cross_k[l].view(B, M, H, D // H), "v": cross_v[l].view(B, M, H, D // H)}
                 for l in range(nL)], dt)
        xk, xv = cross_heads
        weights = list(stacked.mma)
    else:
        xk, xv = (cross_k, cross_v) if cross_k is not None else unpadded()
        weights = [stacked.qkv_w, stacked.so_w, stacked.cq_w, stacked.co_w,
                   stacked.f1_w, stacked.f2_w]
    floats = [stacked.qkv_b, stacked.so_b, stacked.cq_b, stacked.co_b,
              stacked.f1_b, stacked.f2_b, stacked.ln_s, stacked.ln_b]
    _build.require_cuda("fused_beam_decoder_step", caches_k, caches_v, xk, xv, *weights,
                        dtype=dt)
    _build.require_cuda("fused_beam_decoder_step", *floats, dtype=torch.float32)
    _build.require_cuda("fused_beam_decoder_step", caches_k, floats[0], x, ancestry)
    tensors = [caches_k, caches_v, xk, xv, *weights, *floats]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_beam_decoder_step: inputs must be contiguous")
    F = stacked.f1_w.shape[-1]
    x = x.to(dt).contiguous()
    anc = ancestry.to(torch.int32).contiguous()
    h = torch.empty((B, K, D), dtype=torch.float32, device=x.device)
    k_new = torch.empty((nL, B, K, D), dtype=dt, device=x.device)
    v_new = torch.empty_like(k_new)
    b = floats
    ptrs = [x.data_ptr(), anc.data_ptr(), caches_k.data_ptr(), caches_v.data_ptr(),
            xk.data_ptr(), xv.data_ptr(),
            weights[0].data_ptr(), b[0].data_ptr(), weights[1].data_ptr(), b[1].data_ptr(),
            weights[2].data_ptr(), b[2].data_ptr(), weights[3].data_ptr(), b[3].data_ptr(),
            weights[4].data_ptr(), b[4].data_ptr(), weights[5].data_ptr(), b[5].data_ptr(),
            b[6].data_ptr(), b[7].data_ptr(), h.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), B, K, L, D, H, F, nL, M, i]
    if tc:
        sms = _sm_count(x.device.index)
        S = image_parts(B, K, sms)
        G = images_per_block(B, K, sms) if S == 1 else 1
        fn = _build.bind("decoder_step", f"decoder_step_{_SUFFIX[dt]}_mma", _MMA_ARGTYPES)
        err = fn(*ptrs, G, S, eps, _build.stream_of(x))
    else:
        fn = _build.bind("decoder_step", "decoder_step_" + _SUFFIX[dt], _ARGTYPES)
        err = fn(*ptrs, eps, _build.stream_of(x))
    _build.check(err, "decoder_step", "fused_beam_decoder_step")
    fused_beam_decoder_step.routes[route(dt, K, tc)].launches += 1
    fused_beam_decoder_step.launches += 1
    return h, k_new, v_new


fused_beam_decoder_step.launches = 0
fused_beam_decoder_step.routes = {r: types.SimpleNamespace(launches=0) for r in ROUTES}
