"""ResNet-101 image encoder (port of ``icek_tpu/models/resnet.py``).

ResNet-101 minus fc/avgpool, adaptive-average-pool to 14x14, then a 1x1
conv 2048 -> emb_dim, yielding 196 image tokens per image (reference:
geo-aware/models.py:9-60).  Built on ``torch.nn.functional``: the
convolutions and the pool were XLA ops in the JAX package, outside any
Pallas kernel.  Batch norm runs in inference mode (running stats), the
frozen-encoder case, or in train mode (batch statistics, momentum update
of the running buffers: ``resnet_encode(train=True, return_stats=True)``).

Layouts: conv weights are OIHW (``bridge.from_jax_resnet`` converts the
JAX HWIO trees); activations run NCHW in channels-last memory.  The public
encoders keep the JAX shapes: NHWC images in, (B, 196, D) tokens out in
h-major order.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

BLOCK_COUNTS = (3, 4, 23, 3)          # resnet101
STAGE_WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


def conv(x, w, stride=1, compute_dtype=torch.float32, bias=None):
    """NCHW conv with OIHW weights and torch-style symmetric padding."""
    pad = (w.shape[2] - 1) // 2
    if bias is not None:
        bias = bias.to(compute_dtype)
    return F.conv2d(x.to(compute_dtype), w.to(compute_dtype), bias,
                    stride=stride, padding=pad)


# the data-axis group whose global batch the train-mode statistics cover
_SYNC_GROUP: contextvars.ContextVar = contextvars.ContextVar("bn_sync", default=None)


@contextlib.contextmanager
def sync_batch_stats(group):
    """Train-mode batch norm in the block takes its statistics over the
    global batch of the ranks of `group` (a data-parallel mesh axis)."""
    token = _SYNC_GROUP.set(group)
    try:
        yield
    finally:
        _SYNC_GROUP.reset(token)


def batch_norm(params, x, train: bool = False, momentum: float = 0.1,
               eps: float = 1e-5):
    """Batch norm over NCHW activations; returns (y, new running stats or
    None).  In train mode it normalizes by the batch's mean and biased
    variance (float32) and moves the running mean and the unbiased running
    variance by `momentum`, as torch's BatchNorm2d does; the new stats carry
    no gradient."""
    group = _SYNC_GROUP.get()
    if train and group is not None:
        # statistics of the global batch, in two all-reduces over the data
        # axis: the mean, then the squared deviations from it
        import torch.distributed.nn.functional as dist_nn

        xf = x.to(torch.float32)
        n = x.shape[0] * x.shape[2] * x.shape[3] * torch.distributed.get_world_size(group)
        mean = dist_nn.all_reduce(xf.sum(dim=(0, 2, 3)), group=group) / n
        dev = xf - mean.view(1, -1, 1, 1)
        var = dist_nn.all_reduce(dev.square().sum(dim=(0, 2, 3)), group=group) / n
    elif train:
        var, mean = torch.var_mean(x.to(torch.float32), dim=(0, 2, 3), correction=0)
        n = x.shape[0] * x.shape[2] * x.shape[3]
    if train:
        with torch.no_grad():
            new_stats = {
                "mean": (1 - momentum) * params["mean"] + momentum * mean,
                "var": (1 - momentum) * params["var"]
                + momentum * (var * n / max(n - 1, 1)),
            }
    else:
        mean, var, new_stats = params["mean"], params["var"], None
    scale = params["scale"] * torch.rsqrt(var + eps)
    bias = params["bias"] - mean * scale
    y = x * scale.to(x.dtype).view(1, -1, 1, 1) + bias.to(x.dtype).view(1, -1, 1, 1)
    return y, new_stats


def max_pool_3x3_s2(x):
    """torch MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)


def adaptive_avg_pool(x, out_hw):
    """Exact AdaptiveAvgPool2d bins (also when upsampling, e.g. 8 -> 14)."""
    return F.adaptive_avg_pool2d(x, out_hw)


def init_bn(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def init_conv(gen, kh, kw, cin, cout):
    """Kaiming-normal (relu gain) OIHW conv weights."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    return torch.randn((cout, cin, kh, kw), generator=gen) * std


def init_bottleneck(gen, cin, width, with_downsample):
    block = {
        "conv1": init_conv(gen, 1, 1, cin, width),
        "bn1": init_bn(width),
        "conv2": init_conv(gen, 3, 3, width, width),
        "bn2": init_bn(width),
        "conv3": init_conv(gen, 1, 1, width, width * EXPANSION),
        "bn3": init_bn(width * EXPANSION),
    }
    if with_downsample:
        block["down_conv"] = init_conv(gen, 1, 1, cin, width * EXPANSION)
        block["down_bn"] = init_bn(width * EXPANSION)
    return block


def init_proj(gen: torch.Generator, emb_dim: int):
    """A fresh 1x1 projection 2048 -> emb_dim (the reference builds this
    conv anew on top of the pretrained body, geo-aware/models.py:32)."""
    fan_in = STAGE_WIDTHS[-1] * EXPANSION
    bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
    return {
        "w": (torch.rand((emb_dim, fan_in, 1, 1), generator=gen) * 2 - 1) * bound,
        "b": torch.zeros(emb_dim),
    }


def init_resnet101(gen: torch.Generator, emb_dim: int = 300):
    """Seeded random encoder params in the port's layout."""
    params = {"conv1": init_conv(gen, 7, 7, 3, 64), "bn1": init_bn(64)}
    cin = 64
    for stage, (count, width) in enumerate(zip(BLOCK_COUNTS, STAGE_WIDTHS), start=1):
        blocks = []
        for b in range(count):
            blocks.append(init_bottleneck(gen, cin, width, b == 0))
            cin = width * EXPANSION
        params[f"layer{stage}"] = blocks
    params["proj"] = init_proj(gen, emb_dim)
    return params


def _stride(stage: int, b: int) -> int:
    return 2 if (stage > 1 and b == 0) else 1


def bottleneck(block, x, stride=1, compute_dtype=torch.float32, train=False,
               stats_out=None):
    def bn(name, y):
        out, new = batch_norm(block[name], y, train)
        if stats_out is not None and new is not None:
            stats_out[name] = new
        return out

    out = torch.relu(bn("bn1", conv(x, block["conv1"], 1, compute_dtype)))
    out = torch.relu(bn("bn2", conv(out, block["conv2"], stride, compute_dtype)))
    out = bn("bn3", conv(out, block["conv3"], 1, compute_dtype))
    if "down_conv" in block:
        shortcut = bn("down_bn", conv(x, block["down_conv"], stride, compute_dtype))
    else:
        shortcut = x.to(out.dtype)
    return torch.relu(out + shortcut)


def _to_nchw(images):
    """NHWC images -> NCHW view in channels-last memory (no copy when the
    input is already a permuted NCHW tensor)."""
    return images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _tokens(x):
    """(B, D, h, w) -> (B, h*w, D), h-major (the reference's view(B, D, -1))."""
    B, D, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, D)


def resnet_encode(params, images, encoded_size: int = 14,
                  compute_dtype=torch.float32, train: bool = False,
                  return_stats: bool = False):
    """(B, H, W, 3) normalized NHWC images -> (B, encoded_size**2, emb_dim).

    With ``train=True`` batch norm normalizes by batch statistics (the
    reference's encoder.train(), geo-aware/train.py:245); with
    ``return_stats=True`` the encoder tree with the momentum-updated running
    statistics merged in comes back beside the tokens."""
    stats = {} if (return_stats and train) else None
    x = conv(_to_nchw(images), params["conv1"], 2, compute_dtype)
    x, new = batch_norm(params["bn1"], x, train)
    if stats is not None:
        stats["bn1"] = new
    x = max_pool_3x3_s2(torch.relu(x))
    for stage in range(1, 5):
        stage_stats = [] if stats is not None else None
        for b, block in enumerate(params[f"layer{stage}"]):
            block_stats = {} if stats is not None else None
            x = bottleneck(block, x, _stride(stage, b), compute_dtype, train, block_stats)
            if stage_stats is not None:
                stage_stats.append(block_stats)
        if stats is not None:
            stats[f"layer{stage}"] = stage_stats
    x = adaptive_avg_pool(x, (encoded_size, encoded_size))
    x = conv(x, params["proj"]["w"], 1, compute_dtype, bias=params["proj"]["b"])
    if return_stats:
        return _tokens(x), merge_bn_stats(params, stats or {})
    return _tokens(x)


def merge_bn_stats(params, stats):
    """The encoder tree with the new running statistics of `stats` (from
    ``resnet_encode``'s train mode) over the old ones; weights untouched."""
    out = dict(params)
    if "bn1" in stats:
        out["bn1"] = {**params["bn1"], **stats["bn1"]}
    for stage in range(1, 5):
        name = f"layer{stage}"
        if name not in stats:
            continue
        blocks = []
        for block, block_stats in zip(params[name], stats[name]):
            nb = dict(block)
            for bn_name, new in block_stats.items():
                nb[bn_name] = {**block[bn_name], **new}
            blocks.append(nb)
        out[name] = blocks
    return out


def fold_bn_params(params, eps: float = 1e-5):
    """Fold each inference-mode batch-norm affine into its preceding conv:
    s = scale*rsqrt(var+eps) scales the conv's output channels and
    t = bias - mean*s becomes its bias (float32).

    Returns {"conv1", "b1", "layer{1..4}": [{"conv1","b1",...,"down_conv",
    "down_b"}], "proj"} for ``resnet_encode_folded``.
    """

    def fold(w, bn):
        s = bn["scale"] * torch.rsqrt(bn["var"] + eps)
        return (w * s.to(w.dtype).view(-1, 1, 1, 1),     # OIHW: out chan = first
                (bn["bias"] - bn["mean"] * s).to(torch.float32))

    out = {}
    out["conv1"], out["b1"] = fold(params["conv1"], params["bn1"])
    for stage in range(1, 5):
        blocks = []
        for block in params[f"layer{stage}"]:
            fb = {}
            for i in (1, 2, 3):
                fb[f"conv{i}"], fb[f"b{i}"] = fold(block[f"conv{i}"], block[f"bn{i}"])
            if "down_conv" in block:
                fb["down_conv"], fb["down_b"] = fold(block["down_conv"], block["down_bn"])
            blocks.append(fb)
        out[f"layer{stage}"] = blocks
    out["proj"] = params["proj"]
    return out


def _bottleneck_folded(block, x, stride=1, compute_dtype=torch.float32):
    out = torch.relu(conv(x, block["conv1"], 1, compute_dtype, bias=block["b1"]))
    out = torch.relu(conv(out, block["conv2"], stride, compute_dtype, bias=block["b2"]))
    out = conv(out, block["conv3"], 1, compute_dtype, bias=block["b3"])
    if "down_conv" in block:
        shortcut = conv(x, block["down_conv"], stride, compute_dtype, bias=block["down_b"])
    else:
        shortcut = x.to(out.dtype)
    return torch.relu(out + shortcut)


def resnet_encode_folded(folded, images, encoded_size: int = 14,
                         compute_dtype=torch.float32):
    """``resnet_encode`` over a ``fold_bn_params`` tree (inference only)."""
    x = conv(_to_nchw(images), folded["conv1"], 2, compute_dtype, bias=folded["b1"])
    x = max_pool_3x3_s2(torch.relu(x))
    for stage in range(1, 5):
        for b, block in enumerate(folded[f"layer{stage}"]):
            x = _bottleneck_folded(block, x, _stride(stage, b), compute_dtype)
    x = adaptive_avg_pool(x, (encoded_size, encoded_size))
    x = conv(x, folded["proj"]["w"], 1, compute_dtype, bias=folded["proj"]["b"])
    return _tokens(x)
