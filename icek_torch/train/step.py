"""Train / eval steps (port of ``icek_tpu/train/step.py``): masked-CE loss,
Adam with the reference's per-element gradient clamp, plateau LR decay.

Loss semantics match the reference (geo-aware/train.py:274-284): scores at
position t predict caption token t+1, restricted to positions t < length-1
(through <end>) and non-<pad> targets, averaged over all contributing
tokens.  A mask replaces the reference's sort + pack_padded_sequence.

Ported: the frozen-encoder step on cached image tokens
(``encode_images=False``), with gradient accumulation.  Where JAX returns
new trees, the port updates `params` and the optimizer state in place and
returns the same objects; where JAX threads a PRNG key, the step takes a
CPU ``torch.Generator``.  Loss and token count come back as 0-d tensors on
the step's device (reading them is the caller's synchronisation).
"""

from __future__ import annotations

from typing import Dict

import torch

from icek_torch.core.config import Config
from icek_torch.models import captioner as cap


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

class _TokenNLL(torch.autograd.Function):
    """Per-token negative log-likelihood with a hand-written backward: the
    forward reduces the native-dtype logits with float32 accumulation, the
    backward emits d_logits = (softmax - onehot) * d_nll in the logits'
    dtype."""

    @staticmethod
    def forward(ctx, logits, targets, valid):
        m = logits.max(dim=-1).values.to(torch.float32)
        shifted = logits.to(torch.float32) - m[..., None]
        lse = m + torch.log(torch.exp(shifted).sum(dim=-1))
        picked = torch.gather(logits, -1, targets[..., None])[..., 0]
        ctx.save_for_backward(logits, targets, valid, lse)
        return (lse - picked.to(torch.float32)) * valid

    @staticmethod
    def backward(ctx, g):
        logits, targets, valid, lse = ctx.saved_tensors
        scale = (g * valid).to(torch.float32)[..., None]
        d = torch.exp(logits.to(torch.float32) - lse[..., None])
        d.scatter_add_(-1, targets[..., None], torch.full_like(d[..., :1], -1.0))
        return (d * scale).to(logits.dtype), None, None


def _token_nll(logits, targets, valid):
    return _TokenNLL.apply(logits, targets, valid)


def caption_loss_total(scores, caption_ids, caption_lengths, pad_id):
    """Summed masked NLL and its token count: the linear form whose
    per-microbatch gradients add, used by gradient accumulation."""
    targets = caption_ids[:, 1:].long()                    # predict next token
    logits = scores[:, : targets.shape[1]]
    T = targets.shape[1]
    valid = (torch.arange(T, device=targets.device)[None, :]
             < (caption_lengths[:, None] - 1))
    valid = valid & (targets != pad_id)
    nll = _token_nll(logits, targets, valid)
    return nll.sum(), valid.sum()


def caption_loss(scores, caption_ids, caption_lengths, pad_id):
    """Masked mean cross-entropy over teacher-forced positions; returns
    (loss, token count)."""
    total, count = caption_loss_total(scores, caption_ids, caption_lengths, pad_id)
    return total / count.clamp(min=1), count


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def resolve_grad_accum(steps, variant=None, batch_size=None) -> int:
    """Ints pass through (None / 0 mean 1).  ``"auto"`` resolves to 1: no
    accumulation table has been measured on the H100 yet."""
    if steps != "auto":
        return int(steps or 1)
    return 1


def tree_leaves(tree):
    """The leaves of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


class OptState:
    """Adam's state over one param tree: the ``torch.optim.Adam`` holding
    the moments, and the injected hyperparameters."""

    def __init__(self, adam: torch.optim.Adam, learning_rate: float):
        self.adam = adam
        self.hyperparams = {"learning_rate": learning_rate}

    def moments(self, params):
        """(mu, nu) trees shaped like `params` (zeros before the first step)."""
        def pick(key):
            def leaf(p):
                st = self.adam.state.get(p)
                return st[key] if st else torch.zeros_like(p)
            return _map(params, leaf)
        return pick("exp_avg"), pick("exp_avg_sq")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


class Optimizer:
    """clip-by-value then Adam: the reference's clamp_(-c, c) on every
    gradient element (geo-aware/utils.py:75-85) followed by Adam.step, with
    b1 0.9, b2 0.999, eps 1e-8."""

    def __init__(self, learning_rate: float, grad_clip: float = 5.0):
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip

    def init(self, params) -> OptState:
        """State for `params`, whose floating leaves become autograd leaves
        in place (no copy)."""
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)
                  if p.is_floating_point()]
        adam = torch.optim.Adam(leaves, lr=self.learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
        return OptState(adam, self.learning_rate)

    def update(self, opt_state: OptState) -> None:
        """Clamp every gradient element to +-grad_clip, take one Adam step
        (in place) and clear the gradients."""
        adam = opt_state.adam
        leaves = [p for group in adam.param_groups for p in group["params"]]
        torch.nn.utils.clip_grad_value_(leaves, self.grad_clip)
        adam.step()
        adam.zero_grad(set_to_none=True)


def make_optimizer(learning_rate: float, grad_clip: float = 5.0) -> Optimizer:
    return Optimizer(learning_rate, grad_clip)


def decay_learning_rate(opt_state: OptState, factor: float) -> OptState:
    lr = opt_state.hyperparams["learning_rate"] * factor
    opt_state.hyperparams["learning_rate"] = lr
    for group in opt_state.adam.param_groups:
        group["lr"] = lr
    return opt_state


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

_INDEX_KEYS = ("caption_ids", "caption_mask", "lengths")


def _to_device(batch: Dict, device) -> Dict:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.long() if k in _INDEX_KEYS else t
    return out


def make_train_step(
    cfg: Config,
    vocab_size: int,
    pad_id: int,
    optimizer: Optimizer,
    compute_dtype=torch.float32,
    encode_images: bool = True,
    encoder_optimizer=None,
    bn_train_mode: bool = False,
    token_cache=None,
    token_cache_mesh=None,
    device="cuda",
):
    """Build (train_step, eval_step) for the frozen-encoder token path.

    The batch carries precomputed image tokens (B, 196, D) under
    "image_tokens" (``encode_images=False``), "caption_ids" / "caption_mask"
    (B, T), "lengths" (B,), "entity_features" and, for the knowledge and
    news presets, "fact_features" (B, F, 3); numpy arrays or tensors,
    moved to `device` by the step.  `params` must already live there (see
    ``bridge.trainable``).

        params, opt_state, loss, count = train_step(
            params, opt_state, encoder_params, batch, gen)
        loss, count = eval_step(params, encoder_params, batch)

    `gen` is a CPU ``torch.Generator`` feeding every dropout site.  With
    ``cfg.train.grad_accum_steps`` = N > 1 the batch is zero-padded to a
    multiple of N and split into N microbatches; gradients of the summed
    NLL add across them and are scaled once by 1 / total_tokens, which
    equals the full-batch mean-loss gradient up to float associativity
    while peak activation memory is one microbatch's.

    Running the ResNet inside the step (``encode_images=True``), encoder
    fine-tuning, train-mode batch norm and the device token cache are not
    ported yet.
    """
    unported = {
        "encode_images=True": encode_images,
        "encoder_optimizer (fine-tuning)": encoder_optimizer is not None,
        "bn_train_mode": bn_train_mode,
        "token_cache": token_cache is not None,
        "token_cache_mesh": token_cache_mesh is not None,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"make_train_step: {what} is not ported yet")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step: device 'cuda' requested but no CUDA "
                           "device is available; pass device='cpu' to run there")
    mcfg = cfg.model
    accum = resolve_grad_accum(getattr(cfg.train, "grad_accum_steps", 1),
                               mcfg.variant, cfg.train.batch_size)

    def forward_total(params, batch, gen, deterministic):
        """(summed NLL, token count) for one batch or microbatch."""
        scores = cap.captioner_forward(
            params, mcfg, vocab_size, pad_id, batch["caption_ids"],
            batch["caption_mask"], batch["image_tokens"].to(compute_dtype),
            batch["entity_features"], batch.get("fact_features"), gen=gen,
            deterministic=deterministic,
            compute_dtype=compute_dtype,
            # the (B, T, V+E) scores stay in the compute dtype through the
            # loss; _token_nll reads and writes them with f32 accumulation
            score_dtype=compute_dtype,
        )
        return caption_loss_total(scores, batch["caption_ids"], batch["lengths"],
                                  pad_id)

    def microbatches(batch):
        B = next(iter(batch.values())).shape[0]
        pad = (-B) % accum
        size = (B + pad) // accum
        for i in range(accum):
            micro = {}
            for k, v in batch.items():
                if pad:   # padded rows carry zero valid tokens
                    v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                micro[k] = v[i * size:(i + 1) * size]
            yield micro

    def train_step(params, opt_state, encoder_params, batch, gen):
        batch = _to_device(batch, device)
        if accum == 1:
            total, count = forward_total(params, batch, gen, False)
            loss = total / count.clamp(min=1)
            loss.backward()
        else:
            total = torch.zeros((), dtype=torch.float32, device=device)
            count = torch.zeros((), dtype=torch.int64, device=device)
            for micro in microbatches(batch):
                tot, cnt = forward_total(params, micro, gen, False)
                tot.backward()                     # .grad sums the microbatches
                total += tot.detach()
                count += cnt
            inv = 1.0 / count.clamp(min=1).to(torch.float32)
            for p in tree_leaves(params):
                if p.grad is not None:
                    p.grad.mul_(inv.to(p.grad.dtype))
            loss = total * inv
        optimizer.update(opt_state)
        return params, opt_state, loss.detach(), count

    def eval_step(params, encoder_params, batch):
        with torch.no_grad():
            total, count = forward_total(params, _to_device(batch, device), None, True)
            return total / count.clamp(min=1), count

    return train_step, eval_step
