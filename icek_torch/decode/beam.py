"""Batched beam search over the extended [V | E | F] vocabulary (port of
``icek_tpu/decode/beam.py``, with its int8 KV options).

Design kept from the JAX package:
  * hypotheses live on an explicit beam axis K; per-hypothesis state is
    (B, K, ...);
  * the cross-attention K/V of the memory and the entity and fact tables
    stay at batch B and are shared by the K hypotheses of an image; the
    seen-entity mask and predicate indicator are per hypothesis and follow
    the parent like the tokens;
  * self-attention caches are never reordered by parent: each hypothesis
    writes its step-i K/V into its own slot (cache row i*K + k) and an
    (B, K, L) ancestry index records which slot holds each history
    position; attention gathers through the ancestry;
  * finished hypotheses propagate with exactly one forced <pad>
    continuation; the best hypothesis is chosen length-normalized.
The caches are one (nL, B, L*K, D) tensor per K and V, written in place.
Kernel switches: ``use_megakernel`` (kernels/decoder_step.py) and
``use_fused_scores`` (kernels/copy_scores.py); None = on for CUDA tensors.
``kv_dtype`` "int8" keeps the self caches and the cross K/V as per-row int8
with f32 scales, "int8_cross" only the cross K/V; both run the plain decoder
step (the decoder-step kernel reads float K/V), as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from icek_torch.core.config import ModelConfig
from icek_torch.decode import topk
from icek_torch.decode.greedy import (DecodeContext, _token_kind, emit_entities,
                                      pointer_tail, resolve_switch, vocab_input)
from icek_torch.kernels import copy_scores as cs
from icek_torch.kernels import decoder_step as dsk
from icek_torch.models import captioner as cap
from icek_torch.models import transformer as tfm

NEG_INF = -1e30


def _cast_float_params(params, compute_dtype):
    """Cast float weights to the compute dtype once, before the loop."""
    if compute_dtype == torch.float32:
        return params
    if isinstance(params, dict):
        return {k: _cast_float_params(v, compute_dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_cast_float_params(v, compute_dtype) for v in params)
    if torch.is_tensor(params) and params.is_floating_point():
        return params.to(compute_dtype)
    return params


def _beam_self_attention(mha, x, k_cache, v_cache, anc, i, num_heads,
                         compute_dtype):
    """Cached self-attention for one beam step through the ancestry.

    x: (B, K, D); k_cache/v_cache: (B, L*K, D), row t*K + m holds slot m's
    step-t K/V (this step's rows are written here, in place); anc: (B, K, L)
    ancestry.  Hypothesis k attends over history rows t*K + anc[b, k, t]
    for t <= i.
    """
    B, K, D = x.shape
    H = num_heads
    Hd = D // H
    dt = compute_dtype
    proj = x.to(dt) @ mha["qkv_w"].to(dt) + mha["qkv_b"].to(dt)
    q, k_new, v_new = proj.split(D, dim=-1)
    k_cache[:, i * K:(i + 1) * K] = k_new.to(k_cache.dtype)
    v_cache[:, i * K:(i + 1) * K] = v_new.to(v_cache.dtype)
    n = i + 1
    rows = (torch.arange(n, device=x.device) * K)[None, None, :] + anc[:, :, :n]
    rows = rows.reshape(B, K * n, 1).expand(-1, -1, D)
    kh = torch.gather(k_cache, 1, rows).view(B, K, n, H, Hd).to(dt)
    vh = torch.gather(v_cache, 1, rows).view(B, K, n, H, Hd).to(dt)
    logits = torch.einsum("bkhd,bkthd->bkht", q.view(B, K, H, Hd), kh) / math.sqrt(Hd)
    weights = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.einsum("bkht,bkthd->bkhd", weights.to(dt), vh).reshape(B, K, D)
    return tfm.linear(mha["out"], out, dt)


def _quantize_rows(x, dim=-1):
    """Symmetric int8 quantization along `dim`: (q int8, scale f32) with
    x ~= q * scale.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=dim, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_cross_kvs(cross_kvs):
    """[{'k','v'}: (B, M, H, Hd)] -> int8 payloads and scales: K per row
    (b, m, h), its scale laid out (B, 1, H, M) over the logits; V along the
    memory axis (per (b, h, d)), its scale (B, 1, H, Hd) over the output."""
    out = []
    for c in cross_kvs:
        kq, ks = _quantize_rows(c["k"])           # scale (B, M, H, 1)
        vq, vs = _quantize_rows(c["v"], dim=1)    # scale (B, 1, H, Hd)
        out.append({"kq": kq, "vq": vq, "ks": ks[..., 0].transpose(1, 2)[:, None],
                    "vs": vs})
    return out


def _beam_self_attention_int8(mha, x, cache, anc, i, num_heads, compute_dtype):
    """``_beam_self_attention`` over an int8 cache (kq, vq, ks, vs): this
    step's K/V rows are quantized per row where they are written; the
    history's int8 rows and their scales are gathered through the ancestry,
    the K scales multiply the logits and the V scales the softmax weights
    after the int8 contractions."""
    kq_cache, vq_cache, ks_cache, vs_cache = cache
    B, K, D = x.shape
    H = num_heads
    Hd = D // H
    dt = compute_dtype
    proj = x.to(dt) @ mha["qkv_w"].to(dt) + mha["qkv_b"].to(dt)
    q, k_new, v_new = proj.split(D, dim=-1)
    kq_new, ks_new = _quantize_rows(k_new)
    vq_new, vs_new = _quantize_rows(v_new)
    kq_cache[:, i * K:(i + 1) * K] = kq_new
    vq_cache[:, i * K:(i + 1) * K] = vq_new
    ks_cache[:, i * K:(i + 1) * K] = ks_new[..., 0]
    vs_cache[:, i * K:(i + 1) * K] = vs_new[..., 0]
    n = i + 1
    rows = ((torch.arange(n, device=x.device) * K)[None, None, :] + anc[:, :, :n]
            ).reshape(B, K * n)
    wide = rows[:, :, None].expand(-1, -1, D)
    kh = torch.gather(kq_cache, 1, wide).view(B, K, n, H, Hd).to(dt)
    vh = torch.gather(vq_cache, 1, wide).view(B, K, n, H, Hd).to(dt)
    ks = torch.gather(ks_cache, 1, rows).view(B, K, 1, n)
    vs = torch.gather(vs_cache, 1, rows).view(B, K, 1, n)
    logits = (torch.einsum("bkhd,bkthd->bkht", q.view(B, K, H, Hd), kh).to(torch.float32)
              * ks / math.sqrt(Hd))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkht,bkthd->bkhd", (weights * vs).to(dt), vh).reshape(B, K, D)
    return tfm.linear(mha["out"], out, dt)


def _beam_cross_attention_int8(mha, x, cross, num_heads, compute_dtype):
    """Cross-attention over the int8 shared K/V of ``quantize_cross_kvs``."""
    B, K, D = x.shape
    H = num_heads
    Hd = D // H
    dt = compute_dtype
    w = mha["qkv_w"].to(dt)
    b = mha["qkv_b"].to(dt)
    q = (x.to(dt) @ w[:, :D] + b[:D]).view(B, K, H, Hd)
    logits = (torch.einsum("bkhd,bmhd->bkhm", q, cross["kq"].to(dt)).to(torch.float32)
              * cross["ks"] / math.sqrt(Hd))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkhm,bmhd->bkhd", weights.to(dt), cross["vq"].to(dt)) * cross["vs"]
    return tfm.linear(mha["out"], out.to(dt).reshape(B, K, D), dt)


def _beam_cross_attention(mha, x, cross_kv, num_heads, compute_dtype):
    """Cross-attention of (B, K, D) queries over shared (B, M, H, Hd) KV."""
    B, K, D = x.shape
    H = num_heads
    Hd = D // H
    dt = compute_dtype
    w = mha["qkv_w"].to(dt)
    b = mha["qkv_b"].to(dt)
    q = (x.to(dt) @ w[:, :D] + b[:D]).view(B, K, H, Hd)
    logits = torch.einsum("bkhd,bmhd->bkhm", q, cross_kv["k"].to(dt)) / math.sqrt(Hd)
    weights = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.einsum("bkhm,bmhd->bkhd", weights.to(dt), cross_kv["v"].to(dt))
    return tfm.linear(mha["out"], out.reshape(B, K, D), dt)


def _beam_decoder_step(layers, x, caches, anc, i, cross_kvs, num_heads,
                       compute_dtype, kv_int8=False, cross_int8=False):
    """All decoder layers for one beam step; x: (B, K, D); `caches` is
    (caches_k, caches_v) of (nL, B, L*K, D), or with `kv_int8` (kq, vq, ks,
    vs) of ``beam_decode``'s int8 layout; each gets this step's rows in
    place.  `cross_int8`: `cross_kvs` are ``quantize_cross_kvs``'s.
    Returns h."""
    for l, layer in enumerate(layers):
        if kv_int8:
            attn = _beam_self_attention_int8(layer["self_attn"], x,
                                             [c[l] for c in caches], anc, i,
                                             num_heads, compute_dtype)
        else:
            attn = _beam_self_attention(layer["self_attn"], x, caches[0][l],
                                        caches[1][l], anc, i, num_heads,
                                        compute_dtype)
        x = tfm.layer_norm(layer["norm1"], x + attn)
        cross_fn = _beam_cross_attention_int8 if cross_int8 else _beam_cross_attention
        cross = cross_fn(layer["cross_attn"], x, cross_kvs[l], num_heads,
                         compute_dtype)
        x = tfm.layer_norm(layer["norm2"], x + cross)
        ff = tfm.linear(
            layer["ffn"]["lin2"],
            torch.relu(tfm.linear(layer["ffn"]["lin1"], x, compute_dtype)),
            compute_dtype,
        )
        x = tfm.layer_norm(layer["norm3"], x + ff)
    return x


def resolve_kv_dtype(kv_dtype, cfg: ModelConfig):
    """``kv_dtype="auto"`` resolves to None (the float caches) on every
    device: the JAX package picks int8 only on a TPU backend, and no H100
    measurement calls for it.  Explicit values pass through unchanged."""
    del cfg
    return None if kv_dtype == "auto" else kv_dtype


def beam_decode(params, cfg: ModelConfig, vocab_size: int, num_entity_rows: int,
                start_id: int, end_id: int, pad_id: int, ctx: DecodeContext,
                max_len: int, beam_size: int = 5, compute_dtype=torch.float32,
                length_normalize: bool = True,
                use_fused_scores: Optional[bool] = None,
                use_megakernel: Optional[bool] = None,
                kv_dtype: Optional[str] = None):
    """Returns (tokens (B, max_len) int64, scores (B,) f32) for the best
    hypothesis of each image.

    A kernel whose switch is on runs every step, or the call raises before
    the first one: the score head takes any K up to the width of the
    extended vocabulary (``copy_scores.supports``: lists in registers up to
    K = 16, in shared memory above), the decoder step any K
    (``decoder_step.supports``: the tensor-core route in bf16 and f32, G
    images a block up to K = 16 and parts of an image above; the CUDA-core
    route for the widths it refuses).  Nothing gives way to the plain step or
    scores; those run only with the switch off.

    ``kv_dtype`` "int8" / "int8_cross" (see the module's docstring) run the
    plain decoder step: `use_megakernel` None resolves to off there, and an
    explicit True raises, as in the JAX package.  The score head still runs
    as its kernel.  "auto" resolves through ``resolve_kv_dtype``.
    """
    kv_dtype = resolve_kv_dtype(kv_dtype, cfg)
    if kv_dtype not in (None, "int8", "int8_cross"):
        raise ValueError(
            f"kv_dtype must be None/'auto'/'int8'/'int8_cross', got {kv_dtype!r}")
    kv_int8 = kv_dtype == "int8"
    cross_int8 = kv_dtype is not None
    if cross_int8 and use_megakernel:
        raise ValueError(f"kv_dtype={kv_dtype!r} is not supported with the megakernel")
    ents, facts = ctx.entities_encoded, ctx.facts_encoded
    dev = ents.device
    use_fused_scores = resolve_switch(use_fused_scores, dev)
    use_megakernel = resolve_switch(False if cross_int8 else use_megakernel, dev)
    params = _cast_float_params(params, compute_dtype)
    B = ents.shape[0]
    K = beam_size
    D = cfg.emb_dim
    H = cfg.num_heads
    S = vocab_size + num_entity_rows + (facts.shape[1] if facts is not None else 0)
    pos_table = torch.as_tensor(tfm.sinusoidal_positions(max_len, D), device=dev)
    sqrt_d = math.sqrt(D)
    long = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    tokens = torch.full((B, K, max_len), pad_id, **long)
    prev_token = torch.full((B, K), start_id, **long)
    prev_kind = torch.zeros((B, K), **long)
    seen = pred_ind = None
    if cfg.has_facts:
        seen = torch.zeros((B, K, num_entity_rows), **f32)
        pred_ind = torch.zeros((B, K, cfg.num_predicates), **f32)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), **long)
    # Only beam 0 is alive at step 0 (all beams start identical).
    log_probs = torch.where(torch.arange(K, device=dev)[None, :] == 0, 0.0,
                            NEG_INF).expand(B, K).to(torch.float32)
    cache_shape = (cfg.num_layers, B, max_len * K, D)
    if kv_int8:
        caches = (torch.zeros(cache_shape, dtype=torch.int8, device=dev),
                  torch.zeros(cache_shape, dtype=torch.int8, device=dev),
                  torch.zeros(cache_shape[:-1], **f32),
                  torch.zeros(cache_shape[:-1], **f32))
    else:
        caches = (torch.zeros(cache_shape, dtype=compute_dtype, device=dev),
                  torch.zeros(cache_shape, dtype=compute_dtype, device=dev))
    caches_k, caches_v = caches[:2]
    cross_for_step = quantize_cross_kvs(ctx.cross_kvs) if cross_int8 else ctx.cross_kvs
    if use_fused_scores and not cs.supports(K, S):
        raise ValueError(f"beam_decode: the fused score head takes beams of 1 to "
                         f"{S}, not {K}")
    if use_megakernel:
        stacked = dsk.stack_decoder_params(params["decoder"], compute_dtype)
        if not dsk.supports(stacked, caches_k, K, H):
            raise ValueError(f"beam_decode: the decoder-step kernel does not take "
                             f"{compute_dtype} at beam {K}")
        # layouts for the kernel, once per batch: the tensor-core route reads
        # packed weights and head-padded cross K/V, the CUDA-core route the
        # stacked ones
        cross_k = cross_v = cross_heads = None
        if dsk.uses_tensor_cores(stacked, caches_k, K, H):
            cross_heads = dsk.pad_cross_heads(ctx.cross_kvs, compute_dtype)
        else:
            cross_k, cross_v = dsk.stack_cross_kv(ctx.cross_kvs, compute_dtype)
    own_slot = torch.arange(K, **long)[None, :].expand(B, K)
    ancestry = own_slot[:, :, None].expand(B, K, max_len).contiguous()
    pad_only = torch.full((K, S), NEG_INF, device=dev)
    pad_only[:, pad_id] = 0.0
    first = torch.arange(K, device=dev) == 0
    batch = torch.arange(B, device=dev)[:, None]

    for i in range(max_len):
        # this step's K/V land in the hypothesis's own slot
        ancestry[:, :, i] = own_slot
        emb = cap.embed_captions(params, vocab_size, pad_id, prev_token, prev_kind, ents,
                                 facts)
        x = emb * sqrt_d + pos_table[i]
        if use_megakernel:
            h, k_new, v_new = dsk.fused_beam_decoder_step(
                stacked, x, ancestry, caches_k, caches_v, cross_k, cross_v, i,
                num_heads=H, cross_heads=cross_heads,
            )
            h = h.to(compute_dtype)
            caches_k[:, :, i * K:(i + 1) * K] = k_new
            caches_v[:, :, i * K:(i + 1) * K] = v_new
        else:
            h = _beam_decoder_step(params["decoder"]["layers"], x, caches,
                                   ancestry, i, cross_for_step, H, compute_dtype,
                                   kv_int8=kv_int8, cross_int8=cross_int8)
        fact_before = cap.facts_seen(seen, ctx.fact_features) if cfg.has_facts else None
        if use_fused_scores:
            # fused vocab product + per-hypothesis top-K + logsumexp; the
            # global top-K is then exact over the K*K finalists
            tail = pointer_tail(params, cfg, h, ents, facts, fact_before, compute_dtype)
            vals, idx, lse = cs.fused_score_topk(
                vocab_input(params, cfg, h, pred_ind, compute_dtype).reshape(B * K, D),
                params["fc_vocab"]["w"],
                params["fc_vocab"]["b"].to(torch.float32),
                tail.reshape(B * K, -1), k=K,
            )
            cand_logp = (vals - lse[:, None]).reshape(B, K, K)
            cand_token = idx.reshape(B, K, K).long()
            # Finished parents contribute exactly one <pad> continuation.
            cand_logp = torch.where(
                finished[:, :, None],
                torch.where(first[None, None, :], 0.0, NEG_INF),
                cand_logp,
            )
            cand_token = torch.where(finished[:, :, None], pad_id, cand_token)
            total = log_probs[:, :, None] + cand_logp                # (B, K, K)
            top_vals, pos = topk.top_k(total.reshape(B, K * K), K)
            parent = pos // K
            token = torch.gather(cand_token.reshape(B, K * K), -1, pos)
        else:
            scores = cap.copy_scores(params, cfg, h, ents, facts, fact_before, pred_ind,
                                     compute_dtype=compute_dtype)
            step_logp = torch.log_softmax(scores.to(torch.float32), dim=-1)
            # Finished hypotheses contribute exactly one continuation (<pad>, +0).
            step_logp = torch.where(finished[:, :, None], pad_only[None], step_logp)
            total = log_probs[:, :, None] + step_logp               # (B, K, S)
            top_vals, top_idx = topk.top_k_two_stage(total, K)      # (B, K)
            parent = top_idx // S
            token = top_idx % S

        # Reorder the small per-hypothesis state by parent beam; the KV
        # caches stay in place, only the ancestry rows are gathered.
        tokens = tokens[batch, parent]
        fin_parent = finished[batch, parent]
        len_parent = lengths[batch, parent]
        ancestry = ancestry[batch, parent]

        emit = ~fin_parent
        tokens[:, :, i] = torch.where(emit, token, pad_id)
        lengths = torch.where(emit, len_parent + 1, len_parent)
        finished = fin_parent | (token == end_id)
        if cfg.has_facts:
            seen, pred_ind = emit_entities(seen[batch, parent], pred_ind[batch, parent],
                                           token, emit, vocab_size, ctx)
        prev_token = torch.where(emit, token, pad_id)
        prev_kind = torch.where(
            emit, _token_kind(token, vocab_size, num_entity_rows, cfg.has_facts), 0)
        log_probs = top_vals
        if bool(finished.all()):
            break

    rank = log_probs / lengths.clamp(min=1) if length_normalize else log_probs
    best = torch.argmax(rank, dim=1, keepdim=True)
    best_tokens = tokens[torch.arange(B, device=dev), best[:, 0]]
    return best_tokens, torch.gather(rank, 1, best)[:, 0]
