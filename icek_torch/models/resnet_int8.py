"""Post-training int8 quantization of the folded ResNet-101 encoder (port of
``icek_tpu/models/resnet_int8.py``).

Scheme (standard symmetric PTQ, as in JAX):

- Weights: per-output-channel symmetric int8, ``wq[c] = round(w[c] / s[c])``
  with ``s[c] = max|w[c]| / 127``; the folded bias stays float32.
- Activations: static per-tensor scales from a calibration pass
  (:func:`calibrate`, running max or a percentile of per-image maxima) at
  every requantization point.  Post-ReLU tensors live in [0, 127]; the
  network input uses the symmetric [-127, 127].
- Each site is one launch of ``kernels/int8_conv.py`` on the card: int8 x
  int8 -> int32 and its epilogue (``acc * es + b``, the residual add, ReLU,
  requantize) in the same kernel, so activations between sites are int8.
  The stem quantizes the float images itself (``stem_site``), and a
  bottleneck's block 0 runs conv3 and the down convolution in one launch
  (``fused_site``): an encode makes 100 site launches (the stem, 33
  bottlenecks of three, ``site_routes``) and one int8 max pool.
- The adaptive-average-pool and 1x1 projection tail runs in
  ``compute_dtype`` on the library's kernels, as in JAX.

The port's qtree has JAX's keys; its weights ``wq`` are int8 OHWI
(Cout, KH, KW, Cin), the kernel's k-contiguous layout (JAX's are HWIO),
and ``proj["w"]`` is OIHW as in the port's float tree.  Scalars (``inv_*``,
``a_*``) are 0-dim float32 tensors kept on the CPU (``to_device``), so a
site's launch reads them without a device sync.  ``save_qtree`` writes the
interchange layout (JAX's, as the port's checkpoints do) with
``torch.save``; ``load_qtree`` reads that and JAX's ``.msgpack`` trees
(``bridge.from_jax_qtree``).  ``_fingerprint`` binds a tree to the raw
encoder weights it came from and equals JAX's for the same weights, so a
JAX-made tree verifies against the same checkpoint here.

This path changes arithmetic: captions are not guaranteed identical to the
bf16 pipeline.  It is opt-in (``Evaluator(encoder_qtree=...)``).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List

import numpy as np
import torch

from icek_torch.kernels import int8_conv
from icek_torch.models import resnet


def _weight_scales(w):
    """Per-output-channel symmetric scales of an OIHW weight."""
    absmax = torch.amax(torch.abs(w), dim=(1, 2, 3))
    return torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax)).to(torch.float32)


def _quantize_weight(w):
    """OIHW float weight -> (int8 OHWI weight, (Cout,) f32 scales)."""
    w = w.to(torch.float32)
    s = _weight_scales(w)
    wq = torch.clamp(torch.round(w / s.view(-1, 1, 1, 1)), -127, 127).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), s


def _requant_relu(y, inv_a):
    """ReLU + symmetric requantization to the non-negative int8 range."""
    return int8_conv.requant_relu(y, inv_a)


def _qconv(xq, wq, stride: int = 1):
    """int8 x int8 -> int32 convolution, NHWC x OHWI -> NHWC, torch-style
    padding (the kernel on CUDA, its exact plain version on the CPU)."""
    return int8_conv.qconv(xq, wq, stride)


def _scale(x):
    """max -> scale, guarding all-zero calibration tensors."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    return torch.where(x > 0, x / 127.0, torch.ones_like(x))


# --------------------------------------------------------------------------
# Calibration
# --------------------------------------------------------------------------

def observe(folded, images, compute_dtype=torch.bfloat16, per_image: bool = False) -> Dict:
    """One folded forward pass recording the max at every requantization
    point: {"a_img", "a_stem", "layer{1..4}": [{"a1", "a2", "a_out"}]} of
    float32 scalars, or of (B,) per-image maxima with ``per_image``.
    `images` are normalized NHWC float; `folded` is
    ``resnet.fold_bn_params``'s tree."""
    def mx(t):
        if per_image:
            return torch.amax(t, dim=(1, 2, 3)).to(torch.float32)
        return torch.amax(t).to(torch.float32)

    def cb(block, name, y, s=1):
        return resnet.conv(y, block[name], s, compute_dtype) + block[
            name.replace("conv", "b")].to(compute_dtype).view(1, -1, 1, 1)

    with torch.no_grad():
        obs: Dict = {"a_img": mx(torch.abs(images))}
        x = resnet.conv(resnet._to_nchw(images), folded["conv1"], 2, compute_dtype) + \
            folded["b1"].to(compute_dtype).view(1, -1, 1, 1)
        x = torch.relu(x)
        obs["a_stem"] = mx(x)
        x = resnet.max_pool_3x3_s2(x)
        for stage in range(1, 5):
            stage_obs: List[Dict] = []
            for b, block in enumerate(folded[f"layer{stage}"]):
                stride = resnet._stride(stage, b)
                o: Dict = {}
                out = torch.relu(cb(block, "conv1", x))
                o["a1"] = mx(out)
                out = torch.relu(cb(block, "conv2", out, stride))
                o["a2"] = mx(out)
                out = cb(block, "conv3", out)
                if "down_conv" in block:
                    shortcut = cb(block, "down_conv", x, stride)
                else:
                    shortcut = x.to(out.dtype)
                x = torch.relu(out + shortcut)
                o["a_out"] = mx(x)
                stage_obs.append(o)
            obs[f"layer{stage}"] = stage_obs
    return obs


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def calibrate(folded, batches: Iterable, compute_dtype=torch.bfloat16,
              mode: str = "max", percentile: float = 99.5) -> Dict:
    """Activation-scale observations over calibration batches (normalized
    NHWC float images), as CPU float32 tensors.

    mode="max": running elementwise max of :func:`observe`.  One extreme
    activation anywhere in the stream inflates that tensor's scale for
    good: calibrate on several representative batches (not on the split
    whose metrics you report) and check the cosine against the float
    encoder before deploying a tree.

    mode="percentile": per site, ``percentile`` of the per-image maxima
    over all calibration images, so one anomalous image is outvoted (with
    fewer than about 100 / (100 - percentile) images it is the max)."""
    if mode not in ("max", "percentile"):
        raise ValueError(f"mode must be 'max'/'percentile', got {mode!r}")
    per_image = mode == "percentile"
    collected = []
    acc = None
    for images in batches:
        o = _tree_map(lambda t: t.cpu(), observe(folded, images, compute_dtype, per_image))
        if per_image:
            collected.append(o)
        else:
            acc = o if acc is None else _tree_map(torch.maximum, acc, o)
    if acc is None and not collected:
        raise ValueError("calibrate() needs at least one batch")
    if not per_image:
        return acc
    return _tree_map(
        lambda *xs: torch.tensor(np.float32(np.percentile(
            np.concatenate([np.atleast_1d(x.numpy()) for x in xs]), percentile))),
        *collected)


# --------------------------------------------------------------------------
# Quantized tree
# --------------------------------------------------------------------------

def quantize(folded, obs: Dict, source_params=None) -> Dict:
    """Folded tree + calibration observations -> the int8 inference tree.

    Per site: {"wq" int8 OHWI, "es" f32 (Cout,) = a_in * s_w (the
    epilogue's dequant scale), "b" f32 bias}; per requantization point the
    reciprocal scale "inv_*"; "proj" passes through in float.
    ``source_params`` (the raw, unfolded encoder tree `folded` came from)
    records its fingerprint, which :func:`verify_qtree` checks."""
    def site(w, bias, a_in):
        wq, sw = _quantize_weight(w.detach().cpu())
        return {"wq": wq, "es": (a_in.to(torch.float32) * sw).to(torch.float32),
                "b": bias.detach().cpu().to(torch.float32)}

    a_img = _scale(obs["a_img"])
    a_stem = _scale(obs["a_stem"])
    out: Dict = {
        "inv_img": 1.0 / a_img,
        "conv1": site(folded["conv1"], folded["b1"], a_img),
        "inv_stem": 1.0 / a_stem,
    }
    a_x = a_stem
    for stage in range(1, 5):
        blocks = []
        for block, o in zip(folded[f"layer{stage}"], obs[f"layer{stage}"]):
            a1, a2 = _scale(o["a1"]), _scale(o["a2"])
            a_out = _scale(o["a_out"])
            qb = {
                "conv1": site(block["conv1"], block["b1"], a_x),
                "inv_a1": 1.0 / a1,
                "conv2": site(block["conv2"], block["b2"], a1),
                "inv_a2": 1.0 / a2,
                "conv3": site(block["conv3"], block["b3"], a2),
                "a_x": a_x,
                "inv_out": 1.0 / a_out,
            }
            if "down_conv" in block:
                qb["down_conv"] = site(block["down_conv"], block["down_b"], a_x)
            blocks.append(qb)
            a_x = a_out
        out[f"layer{stage}"] = blocks
    out["a_final"] = a_x
    out["proj"] = {k: v.detach().cpu() for k, v in folded["proj"].items()}
    if source_params is not None:
        out["_fingerprint"] = encoder_fingerprint(source_params)
    return out


def encoder_fingerprint(encoder_params) -> torch.Tensor:
    """Content hash of the raw (unfolded) encoder tree as a uint8 tensor,
    the same bytes as JAX's for the same weights (the tree is hashed in
    JAX's HWIO layout)."""
    from icek_torch import bridge
    from icek_torch.utils.fingerprint import tree_fingerprint

    fp = tree_fingerprint(bridge.to_numpy(encoder_params, resnet=True),
                          extra=("resnet101-raw",))
    return torch.from_numpy(np.frombuffer(fp.encode(), dtype=np.uint8).copy())


def verify_qtree(qtree: Dict, encoder_params, context: str = "encoder qtree") -> None:
    """Raise if ``qtree`` was quantized from other weights than the
    checkpoint's raw encoder tree.  Trees without a fingerprint pass with a
    warning: they cannot be verified."""
    recorded = qtree.get("_fingerprint")
    if recorded is None:
        print(f"WARNING: {context} predates fingerprint recording — "
              f"cannot verify it matches the checkpoint's encoder "
              f"(re-quantize with `python -m icek_torch.apps quantize` to bind it)",
              file=sys.stderr)
        return
    want = encoder_fingerprint(encoder_params)
    if not torch.equal(torch.as_tensor(np.asarray(recorded)).to(torch.uint8).cpu(), want):
        raise ValueError(
            f"{context} was quantized from DIFFERENT encoder weights than "
            f"this checkpoint (fingerprint mismatch) — its baked-in int8 "
            f"weights would silently serve another model's encodings. "
            f"Re-quantize with `python -m icek_torch.apps quantize`.")


def calibrate_and_quantize(folded, batches: Iterable, compute_dtype=torch.bfloat16,
                           source_params=None, mode: str = "max",
                           percentile: float = 99.5) -> Dict:
    return quantize(folded, calibrate(folded, batches, compute_dtype, mode=mode,
                                      percentile=percentile),
                    source_params=source_params)


def save_qtree(qtree: Dict, path: str) -> None:
    """Persist a quantized tree in the interchange layout (JAX's: HWIO
    weights) with ``torch.save``; ship it with the checkpoint."""
    from icek_torch import bridge

    tmp = path + ".tmp"
    torch.save(bridge.to_torch(bridge.to_jax_qtree(qtree)), tmp)
    os.replace(tmp, path)


def load_qtree(path: str) -> Dict:
    """A tree saved by :func:`save_qtree`, or a JAX ``.msgpack`` tree, in
    the port's layout (on the CPU)."""
    from icek_torch import bridge

    if path.endswith(".msgpack"):
        from icek_torch.train import msgpack

        raw = msgpack.read(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    return bridge.from_jax_qtree(raw)


def to_device(qtree: Dict, device) -> Dict:
    """The tree's arrays on `device`; 0-dim scalars stay on the CPU, where a
    site's launch reads them without a sync."""
    def move(t):
        return t if t.dim() == 0 else t.to(device)

    return _tree_map(move, qtree)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def site_routes(qtree, img: int) -> Dict[str, int]:
    """{route: launches} of one ``resnet_encode_int8`` of img x img images
    on CUDA, from the tree's shapes (``int8_conv.route``): its sum is the
    encode's site launches (``conv_site.launches``)."""
    routes = dict.fromkeys(int8_conv.ROUTES, 0)
    routes["stem"] = 1
    side = int8_conv.out_hw(int8_conv.out_hw(img, 7, 2), 3, 2)
    for stage in range(1, 5):
        for b, qb in enumerate(qtree[f"layer{stage}"]):
            stride = resnet._stride(stage, b)
            out = int8_conv.out_hw(side, 3, stride)
            for name, s, h in (("conv1", 1, side), ("conv2", stride, side)) + (
                    () if "down_conv" in qb else (("conv3", 1, out),)):
                N, KH, _, C = qb[name]["wq"].shape
                routes[int8_conv.route(C, N, KH, s, h, h)] += 1
            routes["fused"] += "down_conv" in qb
            side = out
    return routes


def encode_sites(img: int = 256) -> Dict[tuple, int]:
    """{site: launches} of one ``resnet_encode_int8`` of img x img images,
    by distinct shape: ("stem", side, 3, 64, 7, 2), ("conv", side, Cin,
    Cout, kernel, stride, epilogue) and ("fused", side, Cin, Cmid, Cout,
    stride), side the site's input side.  The launches sum to
    ``site_routes``'."""
    sites: Dict[tuple, int] = {("stem", img, 3, 64, 7, 2): 1}

    def add(key):
        sites[key] = sites.get(key, 0) + 1

    side, cin = int8_conv.out_hw(int8_conv.out_hw(img, 7, 2), 3, 2), 64
    for stage, (count, width) in enumerate(zip((3, 4, 23, 3), (64, 128, 256, 512)), 1):
        for b in range(count):
            s = resnet._stride(stage, b)
            out = int8_conv.out_hw(side, 3, s)
            add(("conv", side, cin, width, 1, 1, "q8"))
            add(("conv", side, width, width, 3, s, "q8"))
            if b == 0:
                add(("fused", side, cin, width, 4 * width, s))
            else:
                add(("conv", out, width, 4 * width, 1, 1, "q8_q8sc"))
            side, cin = out, 4 * width
    return sites


def resnet_encode_int8(qtree, images, encoded_size: int = 14,
                       compute_dtype=torch.bfloat16):
    """int8 ``resnet_encode_folded``: (B, H, W, 3) normalized NHWC images ->
    (B, encoded_size**2, D) tokens, h-major.  On CUDA every site is an int8
    kernel (``site_routes``: 100 launches) and the pool its int8 kernel;
    either raises if it cannot build or launch."""
    xq = int8_conv.stem_site(images, qtree["conv1"], qtree["inv_img"], qtree["inv_stem"])
    # requantization is monotonic, so pooling the codes equals quantizing
    # the pooled tensor; the pool's identity is -128
    xq = int8_conv.max_pool(xq)
    for stage in range(1, 5):
        for b, qb in enumerate(qtree[f"layer{stage}"]):
            stride = resnet._stride(stage, b)
            out = int8_conv.conv_site(xq, qb["conv1"], 1, inv=qb["inv_a1"])
            out = int8_conv.conv_site(out, qb["conv2"], stride, inv=qb["inv_a2"])
            if "down_conv" in qb:
                xq = int8_conv.fused_site(out, xq, qb["conv3"], qb["down_conv"], stride,
                                          qb["inv_out"])
            else:
                xq = int8_conv.conv_site(out, qb["conv3"], 1, inv=qb["inv_out"],
                                         shortcut=xq, a_x=qb["a_x"])
    x = xq.to(compute_dtype) * qtree["a_final"].to(compute_dtype)
    x = resnet.adaptive_avg_pool(resnet._to_nchw(x), (encoded_size, encoded_size))
    x = resnet.conv(x, qtree["proj"]["w"], 1, compute_dtype) + \
        qtree["proj"]["b"].to(compute_dtype).view(1, -1, 1, 1)
    return resnet._tokens(x)
