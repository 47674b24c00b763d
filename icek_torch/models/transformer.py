"""Transformer encoder/decoder stack (port of ``icek_tpu/models/transformer.py``).

Post-layer-norm, ReLU FFN, torch ``nn.Transformer*`` semantics, written as
plain functions over a params dict with the JAX package's layout:
  * linear weights are stored (in_features, out_features);
  * MHA keeps the fused ``qkv_w`` (D, 3D) / ``qkv_b`` and an ``out`` linear;
  * batch-first (B, T, D) activations;
  * attention runs in ``compute_dtype`` with float32 softmax.

Dropout draws from an explicit host ``torch.Generator`` (`gen`) that the
caller threads through the stacks where JAX threads a key; each dropout
site advances it.  On dropout-active passes with `flash` set, the attention
weights, the residual + LayerNorm chains and the FFN-internal dropout run
through the kernels (``kernels/flash_attention.py``,
``kernels/fused_norm.py``), each seeded with an integer drawn from `gen`;
otherwise the stock dropout below runs.
Inside ``batch_rows(first, total)`` (a data-parallel rank's share of a
global batch, ``train/step.py`` under a mesh) every site draws the mask the
global batch's rows get and keeps its own rows, so a sharded step drops
what the single-device step drops.
The self-attention KV cache of the single-step decode path is updated in
place (the JAX version returns a new buffer); the returned cache is the
same dict.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import numpy as np
import torch

from icek_torch.kernels import flash_attention as fa
from icek_torch.kernels import fused_norm


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_linear(gen: torch.Generator, d_in, d_out, include_bias=True):
    """torch nn.Linear default init: kaiming-uniform weights, fan-in bias."""
    params = {"w": _uniform(gen, (d_in, d_out), math.sqrt(1.0 / d_in) * math.sqrt(3.0))}
    if include_bias:
        params["b"] = _uniform(gen, (d_out,), math.sqrt(1.0 / d_in))
    return params


def linear(params, x, compute_dtype=None):
    w = params["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def init_layer_norm(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def layer_norm(params, x, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def init_mha(gen: torch.Generator, d_model):
    """torch nn.MultiheadAttention layout: fused qkv projection + out proj."""
    return {
        "qkv_w": _uniform(gen, (d_model, 3 * d_model), math.sqrt(6.0 / (4 * d_model))),
        "qkv_b": torch.zeros(3 * d_model),
        "out": init_linear(gen, d_model, d_model) | {"b": torch.zeros(d_model)},
    }


# (first row, rows) of the global batch this process's activations hold
_BATCH_ROWS: contextvars.ContextVar = contextvars.ContextVar("batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(first: int, total: int):
    """Key every dropout mask drawn in the block by global batch row: the
    activations' leading dim holds rows ``first ..`` of a batch of `total`."""
    token = _BATCH_ROWS.set((int(first), int(total)))
    try:
        yield
    finally:
        _BATCH_ROWS.reset(token)


def _kernel_seed(gen: torch.Generator) -> int:
    """A fresh seed in [0, 2**31) for one dropout kernel launch, drawn on
    the host (`gen` is a CPU generator, so nothing waits for the device)."""
    if gen is None:
        raise ValueError("an active dropout needs a torch.Generator")
    if gen.device.type != "cpu":
        raise ValueError("the dropout generator must be a CPU torch.Generator")
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen))


def dropout(x, rate, gen, deterministic):
    """Stock dropout: a Bernoulli(1 - rate) keep mask, survivors scaled by
    1 / (1 - rate).  The mask comes from `gen` for CPU tensors and from a
    device generator seeded from `gen` otherwise."""
    if deterministic or rate == 0.0:
        return x
    if x.device.type == "cpu" and gen is not None:
        mask_gen = gen
    else:
        mask_gen = torch.Generator(device=x.device).manual_seed(_kernel_seed(gen))
    rows = _BATCH_ROWS.get()
    if rows is None:
        keep = torch.rand(x.shape, generator=mask_gen, device=x.device) < 1.0 - rate
    else:
        keep = fused_norm.global_keep(x.shape, rate, mask_gen, rows, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _active(rate, deterministic) -> bool:
    return rate > 0.0 and not deterministic


def residual_norm(norm, x, h, rate, gen, deterministic, fused=False,
                  compute_dtype=torch.float32):
    """``layer_norm(norm, x + dropout(h))``.

    On dropout-active `fused` passes the chain is one kernel
    (``fused_norm.dropout_add_ln``): x and h go in in the compute dtype, the
    mask is regenerated in the backward and the result comes out in the
    compute dtype.  Otherwise the stock chain runs and returns float32."""
    if fused and _active(rate, deterministic):
        return fused_norm.dropout_add_ln(
            x.to(compute_dtype), h.to(compute_dtype), norm["scale"], norm["bias"],
            rate=rate, seed=_kernel_seed(gen), rows=_BATCH_ROWS.get())
    return layer_norm(norm, x + dropout(h, rate, gen, deterministic))


def multi_head_attention(
    params,
    q_in: torch.Tensor,            # (B, Tq, D)
    kv_in: Optional[torch.Tensor],  # (B, Tk, D)
    num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,   # (Tq, Tk) additive, -inf masked
    dropout_rate: float = 0.0,
    gen: Optional[torch.Generator] = None,
    deterministic: bool = True,
    compute_dtype=torch.float32,
    kv_cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    precomputed_kv: Optional[dict] = None,
    flash: bool = False,
    causal: bool = False,
):
    """Fused-projection MHA matching torch semantics.

    With `kv_cache` ({"k","v"} of (B, Tmax, H, Hd)) and `cache_index`, this
    step's K/V rows are written at `cache_index` (in place) and attention
    runs over the cache prefix.  With `precomputed_kv` ({"k","v"} of
    (B, Tk, H, Hd)) the static memory's projections are reused; a KV batch
    smaller than the query batch is shared by beam groups.  With `flash`
    (full-sequence passes only) the attention core runs through the
    flash-attention kernel wrapper, attention-weight dropout included (its
    seed drawn from `gen`); `causal` then replaces `attn_mask`.
    Returns (output, updated_cache_or_None).
    """
    B, Tq, D = q_in.shape
    H = num_heads
    Hd = D // H
    dt = compute_dtype
    w = params["qkv_w"].to(dt)
    b = params["qkv_b"].to(dt)
    rate = dropout_rate if _active(dropout_rate, deterministic) else 0.0

    if flash and kv_cache is None and precomputed_kv is None:
        if attn_mask is not None and not causal:
            raise ValueError(
                "the flash path only supports causal masking via `causal`; "
                "an explicit attn_mask would be silently dropped"
            )
        if kv_in is q_in:
            qkv = q_in.to(dt) @ w + b
            q, k, v = qkv.split(D, dim=-1)
        else:
            q = q_in.to(dt) @ w[:, :D] + b[:D]
            k, v = (kv_in.to(dt) @ w[:, D:] + b[D:]).split(D, dim=-1)
        Tk = k.shape[1]
        out = fa.flash_mha(
            q.view(B, Tq, H, Hd), k.view(B, Tk, H, Hd), v.view(B, Tk, H, Hd),
            causal=causal, dropout_rate=rate,
            seed=_kernel_seed(gen) if rate > 0.0 else None, rows=_BATCH_ROWS.get(),
        )
        return linear(params["out"], out.reshape(B, Tq, D), dt), None

    q = (q_in.to(dt) @ w[:, :D] + b[:D]).view(B, Tq, H, Hd)
    if precomputed_kv is not None:
        k = precomputed_kv["k"].to(dt)
        v = precomputed_kv["v"].to(dt)
        if k.shape[0] != B:
            # KV shared across beam groups: fold the beam factor into the
            # query-position axis so the KV tensors are read once per step.
            G = B // k.shape[0]
            qg = q.reshape(k.shape[0], G * Tq, H, Hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", qg, k) / math.sqrt(Hd)
            weights = torch.softmax(logits.to(torch.float32), dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dt), v)
            return linear(params["out"], out.reshape(B, Tq, D), dt), None
    else:
        k, v = (kv_in.to(dt) @ w[:, D:] + b[D:]).split(D, dim=-1)
        k = k.reshape(B, -1, H, Hd)
        v = v.reshape(B, -1, H, Hd)

    new_cache = None
    if kv_cache is not None:
        # Write this step's K/V at cache_index (in place), attend over the
        # whole buffer.
        kc, vc = kv_cache["k"], kv_cache["v"]
        kc[:, cache_index:cache_index + Tq] = k.to(kc.dtype)
        vc[:, cache_index:cache_index + Tq] = v.to(vc.dtype)
        new_cache = kv_cache
        k, v = kc.to(dt), vc.to(dt)

    scale = 1.0 / math.sqrt(Hd)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).to(torch.float32)
    if attn_mask is not None:
        logits = logits + attn_mask
    if kv_cache is not None:
        # Mask out cache rows past the current step.
        Tk = kv_cache["k"].shape[1]
        valid = torch.arange(Tk, device=logits.device) <= cache_index
        logits = logits.masked_fill(~valid, float("-inf"))
    weights = torch.softmax(logits, dim=-1)
    weights = dropout(weights, dropout_rate, gen, deterministic)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(dt), v)
    out = linear(params["out"], out.reshape(B, Tq, D), dt)
    return out, new_cache


def init_encoder_layer(gen, d_model, ffn_dim):
    return {
        "self_attn": init_mha(gen, d_model),
        "ffn": {
            "lin1": init_linear(gen, d_model, ffn_dim),
            "lin2": init_linear(gen, ffn_dim, d_model),
        },
        "norm1": init_layer_norm(d_model),
        "norm2": init_layer_norm(d_model),
    }


def _ffn(params, x, rate, gen, deterministic, compute_dtype, fused=False):
    h = torch.relu(linear(params["lin1"], x, compute_dtype))
    if fused and _active(rate, deterministic):
        h = fused_norm.hw_dropout(h, rate=rate, seed=_kernel_seed(gen),
                                  rows=_BATCH_ROWS.get())
    else:
        h = dropout(h, rate, gen, deterministic)
    return linear(params["lin2"], h, compute_dtype)


def encoder_layer(params, x, num_heads, rate=0.0, gen=None, deterministic=True,
                  compute_dtype=torch.float32, flash=False):
    """Post-LN transformer encoder layer (self-attn + FFN)."""
    attn, _ = multi_head_attention(
        params["self_attn"], x, x, num_heads, dropout_rate=rate, gen=gen,
        deterministic=deterministic, compute_dtype=compute_dtype, flash=flash,
    )
    x = residual_norm(params["norm1"], x, attn, rate, gen, deterministic, flash,
                      compute_dtype)
    ff = _ffn(params["ffn"], x, rate, gen, deterministic, compute_dtype, fused=flash)
    return residual_norm(params["norm2"], x, ff, rate, gen, deterministic, flash,
                         compute_dtype)


def init_decoder_layer(gen, d_model, ffn_dim):
    return {
        "self_attn": init_mha(gen, d_model),
        "cross_attn": init_mha(gen, d_model),
        "ffn": {
            "lin1": init_linear(gen, d_model, ffn_dim),
            "lin2": init_linear(gen, ffn_dim, d_model),
        },
        "norm1": init_layer_norm(d_model),
        "norm2": init_layer_norm(d_model),
        "norm3": init_layer_norm(d_model),
    }


def decoder_layer(params, x, memory, num_heads, causal_mask=None, rate=0.0,
                  gen=None, deterministic=True, compute_dtype=torch.float32,
                  kv_cache=None, cache_index=None, cross_kv=None, flash=False):
    """Post-LN transformer decoder layer (masked self-attn, cross-attn, FFN).

    With `kv_cache` = {"self": {k, v}} the layer runs one decode step;
    `cross_kv` supplies the precomputed memory projections.
    Returns (output, new_self_cache_or_None).
    """
    self_cache = kv_cache["self"] if kv_cache is not None else None
    attn, new_self_cache = multi_head_attention(
        params["self_attn"], x, x, num_heads, attn_mask=causal_mask,
        dropout_rate=rate, gen=gen, deterministic=deterministic,
        compute_dtype=compute_dtype, kv_cache=self_cache,
        cache_index=cache_index, flash=flash, causal=causal_mask is not None,
    )
    x = residual_norm(params["norm1"], x, attn, rate, gen, deterministic, flash,
                      compute_dtype)
    cross, _ = multi_head_attention(
        params["cross_attn"], x, memory, num_heads, dropout_rate=rate, gen=gen,
        deterministic=deterministic, compute_dtype=compute_dtype,
        precomputed_kv=cross_kv, flash=flash,
    )
    x = residual_norm(params["norm2"], x, cross, rate, gen, deterministic, flash,
                      compute_dtype)
    ff = _ffn(params["ffn"], x, rate, gen, deterministic, compute_dtype, fused=flash)
    x = residual_norm(params["norm3"], x, ff, rate, gen, deterministic, flash,
                      compute_dtype)
    return x, new_self_cache


def init_encoder_stack(gen, num_layers, d_model, ffn_dim):
    return {"layers": [init_encoder_layer(gen, d_model, ffn_dim)
                       for _ in range(num_layers)]}


def encoder_stack(params, x, num_heads, rate=0.0, gen=None, deterministic=True,
                  compute_dtype=torch.float32, flash=False):
    for layer in params["layers"]:
        x = encoder_layer(layer, x, num_heads, rate, gen, deterministic,
                          compute_dtype, flash=flash)
    return x


def init_decoder_stack(gen, num_layers, d_model, ffn_dim):
    return {"layers": [init_decoder_layer(gen, d_model, ffn_dim)
                       for _ in range(num_layers)]}


def decoder_stack(params, x, memory, num_heads, causal_mask=None, rate=0.0,
                  gen=None, deterministic=True, compute_dtype=torch.float32,
                  kv_caches=None, cache_index=None, cross_kvs=None, flash=False):
    """Run the decoder layers; returns (output, new_kv_caches_or_None)."""
    new_caches = [] if kv_caches is not None else None
    for i, layer in enumerate(params["layers"]):
        cache = kv_caches[i] if kv_caches is not None else None
        cross = cross_kvs[i] if cross_kvs is not None else None
        x, new_self = decoder_layer(
            layer, x, memory, num_heads, causal_mask, rate, gen, deterministic,
            compute_dtype, kv_cache=cache, cache_index=cache_index,
            cross_kv=cross, flash=flash,
        )
        if new_caches is not None:
            new_caches.append({"self": new_self})
    return x, new_caches


def precompute_cross_kv(params, memory, num_heads, compute_dtype=torch.float32):
    """Project a static memory through every decoder layer's cross-attention
    K/V once; returns [{"k","v"} of (B, M, H, Hd)] per layer."""
    B, M, D = memory.shape
    H = num_heads
    out = []
    for layer in params["layers"]:
        w = layer["cross_attn"]["qkv_w"].to(compute_dtype)
        b = layer["cross_attn"]["qkv_b"].to(compute_dtype)
        k, v = (memory.to(compute_dtype) @ w[:, D:] + b[D:]).split(D, dim=-1)
        out.append({"k": k.reshape(B, M, H, D // H), "v": v.reshape(B, M, H, D // H)})
    return out


def init_self_kv_cache(num_layers, batch, max_len, num_heads, head_dim,
                       dtype=torch.float32, device=None):
    """Zeroed per-layer self-attention KV buffers for the decode loop."""
    shape = (batch, max_len, num_heads, head_dim)
    return [
        {"self": {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}}
        for _ in range(num_layers)
    ]


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(T, T) additive mask: 0 on/below the diagonal, -inf above."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    return torch.where(j <= i, 0.0, float("-inf")).to(torch.float32)


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Standard sin/cos table (reference: geo-aware/models.py:184-209)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(position * div)
    table[:, 1::2] = np.cos(position * div[: table[:, 1::2].shape[1]])
    return table
