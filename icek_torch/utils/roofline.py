"""Analytic FLOPs / bytes model and card peaks -> MFU and bandwidth
utilization (port of ``icek_tpu/utils/roofline.py``; the FLOP and byte
models are the JAX package's, unchanged).

  * model FLOPs from the architecture (ResNet-101 convs, transformer
    GEMMs / attention, copy-score heads);
  * card peaks from ``torch.cuda.get_device_name()`` (public spec sheets);
  * ``mfu_pct`` = model FLOPs / wall time / peak FLOPs;
    ``hbm_util_pct`` = modeled HBM traffic / wall time / peak bandwidth.

MFU counts only the model's useful matmul / conv FLOPs, so bandwidth-bound
phases (beam decode: KV and memory reads) report low MFU.
``hbm_util_pct`` prices the floor bytes only (KV / cross reads once per
image, encode activations written and read once); the real traffic (score
tensors, softmax / top-k passes, layout copies) is left out, so values well
under 100% are expected: the figure says how far above the unavoidable-bytes
floor the measured time sits.
"""

from __future__ import annotations

from typing import Optional, Tuple

# (peak dense bf16 FLOP/s, peak HBM bytes/s) per card, public spec sheets.
# Matched by device-name prefix (longest match wins).
CHIP_PEAKS = {
    "NVIDIA H100": (989e12, 3.35e12),     # SXM5: 989 TF/s bf16 dense, 3.35 TB/s
}


def device_name(device=None) -> str:
    """The card's name, "" without one."""
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device)


def chip_peaks(device=None) -> Optional[Tuple[float, float]]:
    """(peak_flops, peak_hbm_bytes_per_sec) for the given / current card;
    None when the card is unknown (the CPU, other cards)."""
    kind = device_name(device)
    best = None
    for prefix, peaks in CHIP_PEAKS.items():
        if kind.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), peaks)
    return best[1] if best else None


# ---------------------------------------------------------------------------
# ResNet-101 encoder (models/resnet.py; torchvision v1.5 layout: the stride-2
# sits on the 3x3 conv of each stage's first bottleneck)


def resnet101_encode_flops(image_size: int = 256, emb_dim: int = 300,
                           tokens: int = 196) -> int:
    """Conv + projection FLOPs (2*MACs) for one image through the frozen
    encoder (stem, 4 stages of bottlenecks, 1x1 projection to emb_dim
    after the adaptive pool).  BN/relu/pool elementwise excluded (MFU
    counts useful matmul/conv work)."""
    f = 0
    s = image_size // 2
    f += 2 * s * s * 64 * 3 * 49                  # stem 7x7/2 on RGB
    s //= 2                                       # maxpool 3x3/2
    in_c = 64
    for blocks, mid, out_c, stride in (
        (3, 64, 256, 1), (4, 128, 512, 2), (23, 256, 1024, 2),
        (3, 512, 2048, 2),
    ):
        s_out = s // stride
        # first block (conv1 at input spatial, strided 3x3, + downsample)
        f += 2 * s * s * in_c * mid
        f += 2 * s_out * s_out * mid * mid * 9
        f += 2 * s_out * s_out * mid * out_c
        f += 2 * s_out * s_out * in_c * out_c     # 1x1 shortcut projection
        for _ in range(blocks - 1):
            f += 2 * s_out * s_out * out_c * mid
            f += 2 * s_out * s_out * mid * mid * 9
            f += 2 * s_out * s_out * mid * out_c
        in_c, s = out_c, s_out
    f += 2 * tokens * 2048 * emb_dim              # 1x1 projection
    return f


def resnet101_encode_bytes(image_size: int = 256, dtype_bytes: int = 2) -> int:
    """Minimal HBM activation traffic per image: every conv output written
    once and read once (BN / relu / residual fused into the conv epilogues).
    Weights (~170 MB bf16) amortize over the batch and are excluded, as are
    cache-resident reuse effects: the roofline floor."""
    b = 0
    s = image_size // 2
    b += s * s * 64                               # stem out
    s //= 2
    for blocks, mid, out_c, stride in (
        (3, 64, 256, 1), (4, 128, 512, 2), (23, 256, 1024, 2),
        (3, 512, 2048, 2),
    ):
        s_out = s // stride
        # conv1/conv2/conv3 outputs per bottleneck; the downsample branch
        # output fuses into the residual add (no separate materialization)
        b += s * s * mid + s_out * s_out * (mid + out_c)      # first block
        b += (blocks - 1) * s_out * s_out * (2 * mid + out_c)
        s = s_out
    return 2 * b * dtype_bytes                    # write + read


# ---------------------------------------------------------------------------
# Transformer terms (models/transformer.py: d_model d, per-layer self-attn
# QKVO + optional cross-attn + 2-linear FFN; FLOPs = 2*MACs)


def encoder_layer_flops(S: int, d: int, ffn: int) -> int:
    return 8 * S * d * d + 4 * S * S * d + 4 * S * d * ffn


def decoder_layer_flops(T: int, M: int, d: int, ffn: int) -> int:
    self_attn = 8 * T * d * d + 4 * T * T * d
    cross = 4 * T * d * d + 4 * M * d * d + 4 * T * M * d
    return self_attn + cross + 4 * T * d * ffn


def copy_scores_flops(T: int, d: int, vocab: int, E_rows: int,
                      F_rows: int, num_predicates: int) -> int:
    f = 2 * T * d * vocab                        # vocab head
    f += 2 * T * E_rows * d                      # entity score einsum
    if F_rows:
        f += 2 * T * F_rows * d                  # fact score contraction
        f += 2 * T * num_predicates * d          # predicate projection
    return f


def _memory_len(E_rows: int, F_rows: int, image_tokens: int = 196) -> int:
    return image_tokens + E_rows + F_rows


def captioner_forward_flops(cfg, vocab: int, E_rows: int, F_rows: int,
                            T: int, image_tokens: int = 196) -> int:
    """Teacher-forced forward FLOPs per sample (captioner_forward: context
    encoders + decoder stack + copy-score heads; the frozen image encoder
    is counted separately — training consumes cached tokens)."""
    d, L = cfg.emb_dim, cfg.num_layers
    f = L * encoder_layer_flops(E_rows, d, cfg.encoder_ffn_dim)
    if F_rows:
        f += L * encoder_layer_flops(F_rows, d, cfg.encoder_ffn_dim)
    M = _memory_len(E_rows, F_rows, image_tokens)
    f += L * decoder_layer_flops(T, M, d, cfg.decoder_ffn_dim)
    f += copy_scores_flops(T, d, vocab, E_rows, F_rows, cfg.num_predicates)
    return f


def train_step_flops(cfg, vocab: int, E_rows: int, F_rows: int,
                     T: int) -> int:
    """Forward + backward FLOPs per sample: the standard 3x-forward matmul
    accounting (each forward GEMM induces two backward GEMMs of equal
    cost).  Optimizer elementwise excluded (not matrix-unit work)."""
    return 3 * captioner_forward_flops(cfg, vocab, E_rows, F_rows, T)


def decode_step_flops(cfg, vocab: int, E_rows: int, F_rows: int,
                      t: int, image_tokens: int = 196) -> int:
    """One incremental decode step for ONE sequence at current length t:
    QKVO projections, KV-cache attention reads (self over t, cross over
    M), FFN, and the copy-score head (decode/greedy.py, decode/beam.py)."""
    d, L = cfg.emb_dim, cfg.num_layers
    M = _memory_len(E_rows, F_rows, image_tokens)
    per_layer = (
        8 * d * d + 4 * t * d            # self-attn (incremental)
        + 4 * d * d + 4 * M * d          # cross-attn (K/V precomputed)
        + 4 * d * cfg.decoder_ffn_dim
    )
    return L * per_layer + copy_scores_flops(
        1, d, vocab, E_rows, F_rows, cfg.num_predicates
    )


def decode_step_bytes(cfg, E_rows: int, F_rows: int, t: int,
                      beam: int = 1, image_tokens: int = 196,
                      dtype_bytes: int = 2) -> int:
    """Dominant HBM reads of one decode step for one IMAGE: the
    precomputed cross K/V (2*M*d per layer, read ONCE per image — the
    flat beam GEMM in decode/beam.py shares the (B, M, D) cross cache
    across all hypotheses' queries) plus each hypothesis's own self KV
    cache (2*t*d per layer, per beam).  Weights amortize over B*beam
    sequences (excluded).  Pricing the cross reads per-beam would
    overstate the fact presets' traffic ~beam-fold."""
    d, L = cfg.emb_dim, cfg.num_layers
    M = _memory_len(E_rows, F_rows, image_tokens)
    return L * 2 * (M + beam * t) * d * dtype_bytes


def eval_pipeline_costs(cfg, vocab: int, E_rows: int, F_rows: int,
                        beam: int, max_len: int, image_size: int = 256):
    """(flops, hbm_bytes) per IMAGE for the fused eval pipeline: ResNet
    encode + context encode + cross-K/V precompute + beam decode to
    max_len.  Decode FLOPs scale by beam (every hypothesis's queries
    attend over the full memory); decode BYTES price the shared cross
    K/V once per image and only the self caches per beam
    (decode_step_bytes).  Steps run to max_len (the decode loop exits
    early only when every beam ended: this is the full-length worst
    case)."""
    d, L = cfg.emb_dim, cfg.num_layers
    flops = resnet101_encode_flops(image_size, d)
    flops += L * encoder_layer_flops(E_rows, d, cfg.encoder_ffn_dim)
    if F_rows:
        flops += L * encoder_layer_flops(F_rows, d, cfg.encoder_ffn_dim)
    M = _memory_len(E_rows, F_rows)
    flops += L * 4 * M * d * d                   # cross K/V precompute
    step_f = sum(
        decode_step_flops(cfg, vocab, E_rows, F_rows, t)
        for t in range(1, max_len + 1)
    )
    flops += beam * step_f
    hbm = resnet101_encode_bytes(image_size)
    hbm += sum(
        decode_step_bytes(cfg, E_rows, F_rows, t, beam=beam)
        for t in range(1, max_len + 1)
    )
    return flops, hbm


def utilization(flops: float, seconds: float, hbm_bytes: float = 0.0,
                device=None) -> dict:
    """{"mfu_pct", "hbm_util_pct", "chip"} for work of the given modeled
    cost over the measured wall time; {} when the card is unknown (callers
    then omit the fields rather than print junk)."""
    peaks = chip_peaks(device)
    if not peaks or seconds <= 0:
        return {}
    peak_flops, peak_bw = peaks
    out = {
        "chip": device_name(device),
        "mfu_pct": round(100.0 * flops / seconds / peak_flops, 2),
    }
    if hbm_bytes:
        out["hbm_util_pct"] = round(
            100.0 * hbm_bytes / seconds / peak_bw, 2
        )
    return out
