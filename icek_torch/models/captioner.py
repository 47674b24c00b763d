"""The knowledge-aware captioner (port of ``icek_tpu/models/captioner.py``):
entity and fact encoders, caption embedder, copy/pointer scoring head and
the cross-attention memory, for the three variants (geo, knowledge, news).

Where the JAX package contracts one-hots on the MXU (the subject one-hot
of ``context_indicators``, the fact histogram of ``count_subject_facts``),
the port gathers and scatters: the same 0/1 values and integer counts,
without the (B, F, E) or (B, F, P) one-hot.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from icek_torch.core.config import ModelConfig
from icek_torch.models import transformer as tfm


def _uniform01(gen, shape):
    """U(-0.1, 0.1): init_weights of the reference (geo models.py:264-272)."""
    return (torch.rand(shape, generator=gen) * 2 - 1) * 0.1


def init_captioner_params(gen: torch.Generator, cfg: ModelConfig, vocab_size: int):
    """Seeded random params in the JAX package's layout and distributions."""
    D = cfg.emb_dim
    params = {
        "word_embedding": torch.randn((vocab_size, D), generator=gen),
        "type_embedding": torch.randn((cfg.type_vocab, cfg.type_emb_dim), generator=gen),
        "ctx_encoder_entities": tfm.init_encoder_stack(
            gen, cfg.num_layers, D, cfg.encoder_ffn_dim),
        "decoder": tfm.init_decoder_stack(gen, cfg.num_layers, D, cfg.decoder_ffn_dim),
        "fc_vocab": {"w": _uniform01(gen, (D, vocab_size)), "b": torch.zeros(vocab_size)},
        "fc_entity": {"w": _uniform01(gen, (D, 1)), "b": torch.zeros(1)},
    }
    if cfg.has_facts:
        P = cfg.num_predicates
        params.update({
            "predicate_embedding": torch.randn((P, D), generator=gen),
            "ctx_encoder_facts": tfm.init_encoder_stack(
                gen, cfg.num_layers, D, cfg.encoder_ffn_dim),
            "fc_fact": {"w": _uniform01(gen, (D, 1)), "b": torch.zeros(1)},
            "fc_predicate": {"w": _uniform01(gen, (P, D)), "b": torch.zeros(D)},
        })
    return params


# --------------------------------------------------------------------------
# entity / fact encoders
# --------------------------------------------------------------------------

def _azimuth_to_north(az):
    return az.abs() / 180.0


def _azimuth_to_east(az):
    return torch.where(az >= -90.0, (90.0 - az).abs(), 90.0 + (az + 180.0).abs()) / 180.0


def _in_range(idx, n):
    """(idx clamped into [0, n), idx in range): a one-hot of an index outside
    [0, n) is all zeros, so such rows take the clamped index times 0."""
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def count_subject_facts(fact_subjects, num_entity_rows: int):
    """(counts (B, E), indicator (B, E)) f32: how many facts have each entity
    row as subject.  The last row (the <unk_ent> dummy that padding facts
    point at) is forced to 0 (knowledge models.py:108-117)."""
    idx, ok = _in_range(fact_subjects.long(), num_entity_rows)
    counts = torch.zeros((idx.shape[0], num_entity_rows), dtype=torch.float32,
                         device=idx.device).scatter_add_(1, idx, ok.to(torch.float32))
    counts[:, -1] = 0.0
    return counts, (counts > 0).to(torch.float32)


def encode_entities(params, cfg: ModelConfig, entity_features, fact_features=None):
    """(B, E, C) packed rows [row_idx, *feats] -> per-entity D vectors.

    geo       (geo models.py:82-104):  [dist, az_north, az_east, size, type_emb...]
    knowledge (knowledge models.py:82-133): + [fact_count, fact_indicator] before type
    news      (news models.py:79-134): [count, headline, first_par, fact_count,
                                        fact_indicator, type_emb...] * mean name emb
    """
    f = entity_features
    type_emb = params["type_embedding"][f[:, :, 4].long()]
    if cfg.variant == "geo":
        cols = [f[:, :, 1], _azimuth_to_north(f[:, :, 2]), _azimuth_to_east(f[:, :, 2]),
                f[:, :, 3]]
    elif cfg.variant in ("knowledge", "news"):
        if fact_features is None:
            raise ValueError(f"the {cfg.variant} variant needs fact_features (B, F, 3)")
        counts, indicator = count_subject_facts(fact_features[:, :, 1], f.shape[1])
        if cfg.variant == "knowledge":
            cols = [f[:, :, 1], _azimuth_to_north(f[:, :, 2]), _azimuth_to_east(f[:, :, 2]),
                    f[:, :, 3], counts, indicator]
        else:
            cols = [f[:, :, 1], f[:, :, 2], f[:, :, 3], counts, indicator]
    else:
        raise ValueError(cfg.variant)
    encoded = torch.cat(
        [torch.stack(cols, dim=-1).to(torch.float32), type_emb.to(torch.float32)], dim=-1)
    if cfg.entity_name_embedding:
        # feature columns 5.. carry wordmap ids of the entity-name words
        name_emb = params["word_embedding"][f[:, :, 5:].long()].mean(dim=-2)
        encoded = encoded * name_emb
    return encoded


def encode_facts(params, fact_features, entities_encoded):
    """fact vector = encoded subject entity + predicate embedding
    (knowledge models.py:154-188); fact_features (B, F, 3) rows
    [row_idx, subject row, predicate]; subject rows are clamped into the
    entity table, as JAX's gather clamps them."""
    subj = fact_features[:, :, 1].long().clamp(0, entities_encoded.shape[1] - 1)
    return (_take_rows(entities_encoded, subj)
            + params["predicate_embedding"][fact_features[:, :, 2].long()])


# --------------------------------------------------------------------------
# caption embedding
# --------------------------------------------------------------------------

def _take_rows(table, ids):
    """table (B, N, D) at row ids (B, T) in [0, N) -> (B, T, D).  A table
    that takes a gradient is indexed, not gathered: on CUDA a gather's
    backward adds the gradients of repeated ids with atomics, in no fixed
    order, where indexing's backward sorts them, so a train step is
    bit-reproducible (the loop's resume contract).  Without one (decoding,
    validation) a single gather does it in fewer launches."""
    if not table.requires_grad:
        return torch.gather(table, 1, ids[..., None].expand(*ids.shape, table.shape[-1]))
    B, N, D = table.shape
    rows = torch.arange(B, device=ids.device).view(-1, *([1] * (ids.dim() - 1)))
    return table.reshape(B * N, D)[ids + N * rows]


def _rows(table, ids):
    """table (B, N, D) gathered at ids (B, T), ids outside [0, N) -> row N - 1."""
    N = table.shape[1]
    return _take_rows(table, torch.where((ids < 0) | (ids >= N), N - 1, ids))


def embed_captions(params, vocab_size: int, pad_id: int, caption_ids, caption_mask,
                   entities_encoded, facts_encoded=None):
    """Mixed word / entity / fact token embedding (geo models.py:125-181,
    knowledge :191-259); caption_mask 0 word, 1 entity, 2 fact.  Also takes
    (B, K) token grids (the beam loop's)."""
    word_emb = params["word_embedding"][torch.where(caption_ids >= vocab_size, pad_id,
                                                    caption_ids)]
    ent_emb = _rows(entities_encoded, caption_ids - vocab_size)
    dt = torch.promote_types(word_emb.dtype, ent_emb.dtype)
    out = torch.where((caption_mask == 1)[..., None], ent_emb.to(dt), word_emb.to(dt))
    if facts_encoded is not None:
        fact_emb = _rows(facts_encoded, caption_ids - vocab_size - entities_encoded.shape[1])
        dt = torch.promote_types(dt, fact_emb.dtype)
        out = torch.where((caption_mask == 2)[..., None], fact_emb.to(dt), out.to(dt))
    return out


# --------------------------------------------------------------------------
# context indicators (knowledge / news)
# --------------------------------------------------------------------------

def seen_entity_mask(caption_ids, vocab_size: int, num_entity_rows: int):
    """(B, T, E) f32: entity e appeared at a position strictly before t
    (knowledge models.py:395-417)."""
    idx, ok = _in_range(caption_ids - vocab_size, num_entity_rows)
    one_hot = torch.nn.functional.one_hot(idx, num_entity_rows).to(torch.float32)
    one_hot = one_hot * ok[..., None]
    exclusive = one_hot.cumsum(dim=1) - one_hot
    return (exclusive > 0).to(torch.float32)


def facts_seen(seen, fact_features):
    """(..., F) f32: fact f is active once its subject entity was seen; seen
    (..., E) 0/1 with the batch leading.  ``subject_onehot``'s contraction
    in the JAX package is this gather (a subject outside [0, E) is never
    seen)."""
    B, E = seen.shape[0], seen.shape[-1]
    subj, ok = _in_range(fact_features[:, :, 1].long(), E)
    view = (B,) + (1,) * (seen.dim() - 2) + (subj.shape[1],)
    idx = subj.view(view).expand(*seen.shape[:-1], subj.shape[1])
    return torch.gather(seen, -1, idx) * ok.view(view)


def indicators_from_seen(seen, fact_features, num_predicates: int):
    """(fact_before (..., F), predicate_indicator (..., P)) f32 from a seen
    mask (..., E): a predicate is active once one of its facts is.  The
    JAX package's (F, P) one-hot product is this scatter."""
    fact_before = facts_seen(seen, fact_features)
    pred, ok = _in_range(fact_features[:, :, 2].long(), num_predicates)
    view = (pred.shape[0],) + (1,) * (seen.dim() - 2) + (pred.shape[1],)
    pred_ind = torch.zeros(seen.shape[:-1] + (num_predicates,), dtype=torch.float32,
                           device=seen.device)
    pred_ind.scatter_add_(-1, pred.view(view).expand(fact_before.shape),
                          fact_before.to(torch.float32) * ok.view(view))
    return fact_before, (pred_ind > 0).to(torch.float32)


def context_indicators(caption_ids, fact_features, vocab_size: int,
                       num_entity_rows: int, num_predicates: int):
    """Returns (fact_before (B, T, F), predicate_indicator (B, T, P)) f32."""
    seen = seen_entity_mask(caption_ids, vocab_size, num_entity_rows)
    return indicators_from_seen(seen, fact_features, num_predicates)


# --------------------------------------------------------------------------
# scoring head (copy / pointer over [vocab | entities | facts])
# --------------------------------------------------------------------------

def pointer_logits(hc, table, w, compute_dtype):
    """sum_d h * w * table rows, without the bias: (B, ..., D) x (B, N, D) ->
    (B, ..., N) in the compute dtype (w: the (D, 1) head weight)."""
    return torch.einsum("b...d,bed->b...e", hc * w[:, 0].to(compute_dtype),
                        table.to(compute_dtype))


def copy_scores(params, cfg: ModelConfig, h, entities_encoded, facts_encoded=None,
                fact_before=None, predicate_indicator=None,
                compute_dtype=torch.float32, out_dtype=torch.float32):
    """Concatenated logits over [V | E | F] (geo models.py:291-313, knowledge
    models.py:420-455): logit[b,t,e] = sum_d h*ent*w + b, never
    materializing (B, T, E, D).  With facts the vocab input is h times the
    active-predicate projection, and the fact indicator gates the fact
    contraction but not its bias."""
    hc = h.to(compute_dtype)
    vocab_in = hc
    if cfg.has_facts:
        pred_proj = tfm.linear(params["fc_predicate"], predicate_indicator, compute_dtype)
        vocab_in = hc * pred_proj.to(compute_dtype)
    pieces = [tfm.linear(params["fc_vocab"], vocab_in, compute_dtype),
              pointer_logits(hc, entities_encoded, params["fc_entity"]["w"], compute_dtype)
              + params["fc_entity"]["b"][0]]
    if cfg.has_facts:
        contracted = pointer_logits(hc, facts_encoded, params["fc_fact"]["w"], compute_dtype)
        pieces.append(contracted * fact_before + params["fc_fact"]["b"][0])
    return torch.cat([p.to(out_dtype) for p in pieces], dim=-1)


# --------------------------------------------------------------------------
# memory and the teacher-forced forward
# --------------------------------------------------------------------------

def resolve_flash(cfg: ModelConfig, device: torch.device) -> bool:
    """Whether the context encoders run through the flash-attention kernel:
    the config flag, or (None = auto) on for CUDA tensors."""
    if cfg.use_flash_attention is not None:
        return cfg.use_flash_attention
    return torch.device(device).type == "cuda"


def encode_memory(params, cfg: ModelConfig, image_tokens, entity_features,
                  fact_features=None, gen: Optional[torch.Generator] = None,
                  deterministic: bool = True, compute_dtype=torch.float32):
    """Encode the contexts and assemble the cross-attention memory, ordered
    [image | entity context | fact context].

    `gen` feeds the encoders' dropout on non-deterministic passes, entity
    encoder first.  Returns (memory (B, 196+E[+F], D), entities_encoded,
    facts_encoded or None).
    """
    ents = encode_entities(params, cfg, entity_features, fact_features)
    flash = resolve_flash(cfg, ents.device)
    parts = [tfm.encoder_stack(
        params["ctx_encoder_entities"], ents, cfg.num_heads, cfg.dropout_enc,
        gen, deterministic, compute_dtype, flash=flash)]
    facts = None
    if cfg.has_facts:
        facts = encode_facts(params, fact_features, ents)
        parts.append(tfm.encoder_stack(
            params["ctx_encoder_facts"], facts, cfg.num_heads, cfg.dropout_enc,
            gen, deterministic, compute_dtype, flash=flash))
    dt = torch.promote_types(image_tokens.dtype, parts[0].dtype)
    return torch.cat([image_tokens.to(dt)] + [p.to(dt) for p in parts], dim=1), ents, facts


def captioner_forward(params, cfg: ModelConfig, vocab_size: int, pad_id: int,
                      caption_ids, caption_mask, image_tokens, entity_features,
                      fact_features=None, gen: Optional[torch.Generator] = None,
                      deterministic: bool = True, compute_dtype=torch.float32,
                      pos_table: Optional[torch.Tensor] = None,
                      score_dtype=torch.float32):
    """Teacher-forced pass returning (B, T, V+E[+F]) logits in `score_dtype`.

    caption_ids, caption_mask: (B, T) int64; image_tokens: (B, 196, D);
    fact_features (B, F, 3) for the knowledge and news variants.  There is
    no length sort or packing: the loss masks the padding.  `gen` feeds
    every dropout site of a non-deterministic pass, in the order entity
    encoder, fact encoder, positional dropout, decoder.
    """
    T = caption_ids.shape[1]
    memory, ents, facts = encode_memory(params, cfg, image_tokens, entity_features,
                                        fact_features, gen, deterministic, compute_dtype)
    emb = embed_captions(params, vocab_size, pad_id, caption_ids, caption_mask, ents, facts)
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
    fact_before = pred_ind = None
    if cfg.has_facts:
        fact_before, pred_ind = context_indicators(
            caption_ids, fact_features, vocab_size, entity_features.shape[1],
            cfg.num_predicates)
    return copy_scores(params, cfg, h, ents, facts, fact_before, pred_ind,
                       compute_dtype=compute_dtype, out_dtype=score_dtype)
