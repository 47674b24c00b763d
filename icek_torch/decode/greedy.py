"""Batched greedy decoding with per-layer KV caches (port of
``icek_tpu/decode/greedy.py``).

Semantics preserved:
  * argmax over the [V | E | F] copy scores;
  * generation stops at <end> (later positions stay <pad>);
  * the n-gram repetition cleanup: immediate repeats of unit length 1/2/3
    rewrite the repeated span with each step's recorded second-best token
    (geo models.py:417-435), unit 1 first, then 2, then 3;
  * the caption fed back to the model is append-only (cleanup rewrites the
    output buffer only), which is what makes KV caching valid;
  * emitted entity / fact ids update the caption-type mask, and emitted
    entities the seen-entity mask and predicate indicator (knowledge and
    news variants).
The JAX while-loop becomes a Python loop that stops when every caption
has finished (one host read of the finished flags per step).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from icek_torch.core.config import ModelConfig
from icek_torch.decode import topk
from icek_torch.kernels import copy_scores as cs
from icek_torch.models import captioner as cap
from icek_torch.models import transformer as tfm


class DecodeContext(NamedTuple):
    """Static per-batch tensors prepared once before the decode loop."""

    entities_encoded: torch.Tensor            # (B, E, D)
    cross_kvs: tuple                          # per-layer {"k","v"} (B, M, H, Hd)
    facts_encoded: Optional[torch.Tensor] = None   # (B, F, D)
    fact_features: Optional[torch.Tensor] = None   # (B, F, 3)
    ent_pred: Optional[torch.Tensor] = None        # (B, E, P) bool per-entity predicates


def entity_predicates(fact_features, num_entity_rows: int, num_predicates: int):
    """(B, E, P) bool: some fact with subject e has predicate p.  A scatter
    of the (subject, predicate) pairs where the JAX package contracts two
    one-hots (the (B, F, P) one is 1.08 GB in f32 at the news shapes).
    Every subject row counts, the <unk_ent> dummy's too, as there; pairs
    with an index out of range set nothing."""
    B = fact_features.shape[0]
    E, P = num_entity_rows, num_predicates
    subj = fact_features[:, :, 1].long()
    pred = fact_features[:, :, 2].long()
    ok = (subj >= 0) & (subj < E) & (pred >= 0) & (pred < P)
    flat = torch.where(ok, subj * P + pred, E * P)       # the spare slot E * P
    out = torch.zeros((B, E * P + 1), dtype=torch.bool, device=flat.device)
    return out.scatter_(1, flat, True)[:, :E * P].view(B, E, P)


def prepare_decode_context(params, cfg: ModelConfig, image_tokens, entity_features,
                           fact_features=None, compute_dtype=torch.float32) -> DecodeContext:
    memory, ents, facts = cap.encode_memory(
        params, cfg, image_tokens, entity_features, fact_features,
        deterministic=True, compute_dtype=compute_dtype,
    )
    cross_kvs = tfm.precompute_cross_kv(
        params["decoder"], memory, cfg.num_heads, compute_dtype
    )
    if not cfg.has_facts:
        return DecodeContext(ents, tuple(cross_kvs))
    ent_pred = entity_predicates(fact_features, entity_features.shape[1], cfg.num_predicates)
    return DecodeContext(ents, tuple(cross_kvs), facts, fact_features, ent_pred)


def resolve_switch(flag: Optional[bool], device) -> bool:
    """A kernel switch: explicit True/False, or None = on for CUDA."""
    if flag is not None:
        return bool(flag)
    return torch.device(device).type == "cuda"


def _token_kind(token, vocab_size, num_entity_rows, has_facts):
    """0=word, 1=entity, 2=fact (knowledge models.py:600-608)."""
    kind = (token >= vocab_size).to(torch.int64)
    if has_facts:
        kind = torch.where(token >= vocab_size + num_entity_rows, 2, kind)
    return kind


def emit_entities(seen, pred_ind, token, gate, vocab_size, ctx: DecodeContext):
    """The seen-entity mask and the predicate indicator after emitting
    `token` where `gate` (entity ids only): seen (..., E), pred_ind (..., P)
    f32, token and gate (...) with the batch leading.  The emitted entity's
    predicate row comes from ``ctx.ent_pred``."""
    E = seen.shape[-1]
    gate = gate & (token >= vocab_size) & (token < vocab_size + E)
    idx = (token - vocab_size).clamp(0, E - 1)
    hit = torch.nn.functional.one_hot(idx, E).to(torch.bool) & gate[..., None]
    seen = torch.where(hit, 1.0, seen)
    if ctx.ent_pred is not None:
        B, P = ctx.ent_pred.shape[0], ctx.ent_pred.shape[-1]
        rows = torch.gather(ctx.ent_pred, 1, idx.reshape(B, -1, 1).expand(-1, -1, P))
        pred_ind = torch.where(rows.view(pred_ind.shape) & gate[..., None], 1.0, pred_ind)
    return seen, pred_ind


def _repetition_cleanup(output, second, i: int, apply):
    """Rewrite immediate n-gram repeats with recorded second-best tokens
    (in place).  output, second: (B, L); apply: (B,) bool.  Mirrors geo
    models.py:417-435 (unit 1 rewrites 1 token, unit 2 rewrites 2, unit 3
    rewrites 4; first matching unit wins)."""
    o = [output[:, max(i - k, 0)] for k in range(6)]
    s = [second[:, max(i - k, 0)] for k in range(4)]
    unit1 = (o[0] == o[1]) & (i > 0)
    unit2 = (o[0] == o[2]) & (o[1] == o[3]) & (i > 2)
    unit3 = (o[0] == o[3]) & (o[1] == o[4]) & (o[2] == o[5]) & (i > 4)
    hit1 = apply & unit1
    hit2 = apply & ~unit1 & unit2
    hit3 = apply & ~unit1 & ~unit2 & unit3
    count = torch.where(hit1, 1, torch.where(hit2, 2, torch.where(hit3, 4, 0)))
    for r in range(4):
        pos = max(i - r, 0)
        output[:, pos] = torch.where(count > r, s[r], output[:, pos])
    return output


def pointer_tail(params, cfg: ModelConfig, hc, ents, facts=None, fact_before=None,
                 compute_dtype=torch.float32):
    """Entity [+ fact] pointer logits for one decode step, the "tail" of the
    extended vocabulary, in f32.  hc: (B, D) or (B, K, D) with per-image
    shared tables; returns (B, E[+F]) or (B, K, E[+F])."""
    hc = hc.to(compute_dtype)

    def contract(table, fc):
        return cap.pointer_logits(hc, table, fc["w"], compute_dtype).to(torch.float32)

    bias = lambda fc: fc["b"][0].to(torch.float32)
    tail = contract(ents, params["fc_entity"]) + bias(params["fc_entity"])
    if not cfg.has_facts:
        return tail
    tail_fact = contract(facts, params["fc_fact"]) * fact_before + bias(params["fc_fact"])
    return torch.cat([tail, tail_fact], dim=-1)


def vocab_input(params, cfg: ModelConfig, hc, pred_ind=None, compute_dtype=torch.float32):
    """Decoder state feeding the vocab projection: with facts, modulated by
    the active-predicate projection."""
    hc = hc.to(compute_dtype)
    if not cfg.has_facts:
        return hc
    return hc * tfm.linear(params["fc_predicate"], pred_ind, compute_dtype).to(compute_dtype)


def greedy_decode(params, cfg: ModelConfig, vocab_size: int, num_entity_rows: int,
                  start_id: int, end_id: int, pad_id: int, ctx: DecodeContext,
                  max_len: int, compute_dtype=torch.float32,
                  use_fused_scores: Optional[bool] = None):
    """Returns (B, max_len) int64 extended-vocab token ids.

    `use_fused_scores` routes the scoring head through the fused
    score/top-k kernel (kernels/copy_scores.py); None = on for CUDA.  With
    facts the state also carries the seen-entity mask and the predicate
    indicator, updated from each emitted entity.
    """
    from icek_torch.decode.beam import _cast_float_params

    dev = ctx.entities_encoded.device
    use_fused_scores = resolve_switch(use_fused_scores, dev)
    params = _cast_float_params(params, compute_dtype)
    B = ctx.entities_encoded.shape[0]
    D = cfg.emb_dim
    H = cfg.num_heads
    pos_table = torch.as_tensor(tfm.sinusoidal_positions(max_len, D), device=dev)
    sqrt_d = math.sqrt(D)
    long = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    captions = torch.full((B, max_len + 1), start_id, **long)
    masks = torch.zeros((B, max_len + 1), **long)
    output = torch.full((B, max_len), pad_id, **long)
    second = torch.zeros((B, max_len), **long)
    seen = pred_ind = None
    if cfg.has_facts:
        seen = torch.zeros((B, num_entity_rows), **f32)
        pred_ind = torch.zeros((B, cfg.num_predicates), **f32)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    caches = tfm.init_self_kv_cache(cfg.num_layers, B, max_len, H, D // H,
                                    compute_dtype, device=dev)

    for i in range(max_len):
        emb = cap.embed_captions(params, vocab_size, pad_id, captions[:, i:i + 1],
                                 masks[:, i:i + 1], ctx.entities_encoded, ctx.facts_encoded)
        x = emb * sqrt_d + pos_table[i]
        h, caches = tfm.decoder_stack(
            params["decoder"], x, None, H, deterministic=True,
            compute_dtype=compute_dtype, kv_caches=caches, cache_index=i,
            cross_kvs=ctx.cross_kvs,
        )
        fact_before = cap.facts_seen(seen, ctx.fact_features) if cfg.has_facts else None
        if use_fused_scores:
            hc = h[:, 0]
            tail = pointer_tail(params, cfg, hc, ctx.entities_encoded, ctx.facts_encoded,
                                fact_before, compute_dtype)
            _, top2_idx, _ = cs.fused_score_topk(
                vocab_input(params, cfg, hc, pred_ind, compute_dtype),
                params["fc_vocab"]["w"], params["fc_vocab"]["b"].to(torch.float32), tail,
                k=2,
            )
        else:
            one_pos = (lambda t: None if t is None else t[:, None])
            scores = cap.copy_scores(params, cfg, h, ctx.entities_encoded, ctx.facts_encoded,
                                     one_pos(fact_before), one_pos(pred_ind),
                                     compute_dtype=compute_dtype)[:, 0]
            _, top2_idx = topk.top_k(scores, 2)
        out_raw = top2_idx[:, 0].long()
        runner_up = top2_idx[:, 1].long()

        active = ~finished
        output[:, i] = torch.where(active, out_raw, output[:, i])
        second[:, i] = torch.where(active, runner_up, second[:, i])
        end_hit = out_raw == end_id
        _repetition_cleanup(output, second, i, active & ~end_hit)
        out = output[:, i]

        next_token = torch.where(active & ~end_hit, out, pad_id)
        captions[:, i + 1] = next_token
        masks[:, i + 1] = _token_kind(next_token, vocab_size, num_entity_rows, cfg.has_facts)
        if cfg.has_facts:
            seen, pred_ind = emit_entities(seen, pred_ind, out, active & ~end_hit,
                                           vocab_size, ctx)
        finished = finished | (active & end_hit)
        if bool(finished.all()):
            break
    return output
