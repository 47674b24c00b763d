"""The knowledge-aware captioner, geo variant (port of
``icek_tpu/models/captioner.py``): entity encoder, caption embedder,
copy/pointer scoring head and the cross-attention memory.

The fact path (knowledge / news presets) and the news entity-name
embedding are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from icek_torch.core.config import ModelConfig
from icek_torch.models import transformer as tfm


def _no_facts(cfg: ModelConfig, what: str) -> None:
    if cfg.has_facts or cfg.variant != "geo":
        raise NotImplementedError(
            f"{what}: only the geo variant is ported (variant {cfg.variant!r})"
        )
    if cfg.entity_name_embedding:
        raise NotImplementedError(f"{what}: entity_name_embedding is not ported")


def init_captioner_params(gen: torch.Generator, cfg: ModelConfig, vocab_size: int):
    """Seeded random params in the JAX package's layout and distributions."""
    _no_facts(cfg, "init_captioner_params")
    D = cfg.emb_dim
    return {
        "word_embedding": torch.randn((vocab_size, D), generator=gen),
        "type_embedding": torch.randn((cfg.type_vocab, cfg.type_emb_dim), generator=gen),
        "ctx_encoder_entities": tfm.init_encoder_stack(
            gen, cfg.num_layers, D, cfg.encoder_ffn_dim),
        "decoder": tfm.init_decoder_stack(gen, cfg.num_layers, D, cfg.decoder_ffn_dim),
        # init_weights: U(-0.1, 0.1) weights, zero bias (geo models.py:264-272)
        "fc_vocab": {"w": (torch.rand((D, vocab_size), generator=gen) * 2 - 1) * 0.1,
                     "b": torch.zeros(vocab_size)},
        "fc_entity": {"w": (torch.rand((D, 1), generator=gen) * 2 - 1) * 0.1,
                      "b": torch.zeros(1)},
    }


def _azimuth_to_north(az):
    return az.abs() / 180.0


def _azimuth_to_east(az):
    return torch.where(az >= -90.0, (90.0 - az).abs(), 90.0 + (az + 180.0).abs()) / 180.0


def encode_entities(params, cfg: ModelConfig, entity_features: torch.Tensor):
    """(B, E, C) packed rows [row_idx, dist, azimuth, size, type] -> the
    per-entity vectors [dist, az_north, az_east, size, type_emb...]
    (geo models.py:82-104)."""
    _no_facts(cfg, "encode_entities")
    type_emb = params["type_embedding"][entity_features[:, :, 4].long()]
    cols = [
        entity_features[:, :, 1],
        _azimuth_to_north(entity_features[:, :, 2]),
        _azimuth_to_east(entity_features[:, :, 2]),
        entity_features[:, :, 3],
    ]
    return torch.cat(
        [torch.stack(cols, dim=-1).to(torch.float32), type_emb.to(torch.float32)], dim=-1
    )


def embed_captions(params, vocab_size: int, pad_id: int, caption_ids,
                   caption_mask, entities_encoded):
    """Mixed word/entity token embedding (geo models.py:125-181)."""
    E = entities_encoded.shape[1]
    word_ids = torch.where(caption_ids >= vocab_size, pad_id, caption_ids)
    word_emb = params["word_embedding"][word_ids]
    ent_ids = caption_ids - vocab_size
    ent_ids = torch.where((ent_ids < 0) | (ent_ids >= E), E - 1, ent_ids)
    ent_emb = torch.gather(
        entities_encoded, 1,
        ent_ids[:, :, None].expand(-1, -1, entities_encoded.shape[-1]),
    )
    out_dtype = torch.promote_types(word_emb.dtype, ent_emb.dtype)
    return torch.where((caption_mask == 1)[:, :, None], ent_emb.to(out_dtype),
                       word_emb.to(out_dtype))


def copy_scores(params, cfg: ModelConfig, h, entities_encoded,
                compute_dtype=torch.float32, out_dtype=torch.float32):
    """Concatenated logits over [V | E] (geo models.py:291-313):
    logit[b,t,e] = sum_d h*ent*w + b, never materializing (B,T,E,D)."""
    _no_facts(cfg, "copy_scores")
    hc = h.to(compute_dtype)
    preds_vocab = tfm.linear(params["fc_vocab"], hc, compute_dtype)
    w_ent = params["fc_entity"]["w"][:, 0].to(compute_dtype)
    preds_ent = (
        torch.einsum("btd,bed->bte", hc * w_ent, entities_encoded.to(compute_dtype))
        + params["fc_entity"]["b"][0]
    )
    return torch.cat([preds_vocab.to(out_dtype), preds_ent.to(out_dtype)], dim=-1)


def resolve_flash(cfg: ModelConfig, device: torch.device) -> bool:
    """Whether the context encoder runs through the flash-attention kernel:
    the config flag, or (None = auto) on for CUDA tensors."""
    if cfg.use_flash_attention is not None:
        return cfg.use_flash_attention
    return torch.device(device).type == "cuda"


def encode_memory(params, cfg: ModelConfig, image_tokens, entity_features,
                  gen: Optional[torch.Generator] = None,
                  deterministic: bool = True, compute_dtype=torch.float32):
    """Encode the entity context and assemble the cross-attention memory.

    `gen` feeds the context encoder's dropout on non-deterministic passes.
    Returns (memory (B, 196+E, D), entities_encoded).
    """
    _no_facts(cfg, "encode_memory")
    ents = encode_entities(params, cfg, entity_features)
    ent_ctx = tfm.encoder_stack(
        params["ctx_encoder_entities"], ents, cfg.num_heads, cfg.dropout_enc,
        gen, deterministic, compute_dtype, flash=resolve_flash(cfg, ents.device),
    )
    dt = torch.promote_types(image_tokens.dtype, ent_ctx.dtype)
    return torch.cat([image_tokens.to(dt), ent_ctx.to(dt)], dim=1), ents


def captioner_forward(params, cfg: ModelConfig, vocab_size: int, pad_id: int,
                      caption_ids, caption_mask, image_tokens, entity_features,
                      gen: Optional[torch.Generator] = None,
                      deterministic: bool = True, compute_dtype=torch.float32,
                      pos_table: Optional[torch.Tensor] = None,
                      score_dtype=torch.float32):
    """Teacher-forced pass returning (B, T, V+E) logits in `score_dtype`.

    caption_ids, caption_mask: (B, T) int64; image_tokens: (B, 196, D).
    There is no length sort or packing: the loss masks the padding.  `gen`
    feeds every dropout site of a non-deterministic pass, in the order
    context encoder, positional dropout, decoder.
    """
    _no_facts(cfg, "captioner_forward")
    T = caption_ids.shape[1]
    memory, ents = encode_memory(params, cfg, image_tokens, entity_features,
                                 gen, deterministic, compute_dtype)
    emb = embed_captions(params, vocab_size, pad_id, caption_ids, caption_mask, ents)
    if pos_table is None:
        pos_table = torch.as_tensor(tfm.sinusoidal_positions(T, cfg.emb_dim),
                                    device=emb.device)
    emb = emb * math.sqrt(cfg.emb_dim) + pos_table[:T]
    emb = tfm.dropout(emb, cfg.dropout_pos, gen, deterministic)
    h, _ = tfm.decoder_stack(
        params["decoder"], emb, memory, cfg.num_heads,
        causal_mask=tfm.causal_mask(T, device=emb.device), rate=cfg.dropout_dec,
        gen=gen, deterministic=deterministic, compute_dtype=compute_dtype,
        flash=resolve_flash(cfg, emb.device),
    )
    return copy_scores(params, cfg, h, ents, compute_dtype=compute_dtype,
                       out_dtype=score_dtype)
