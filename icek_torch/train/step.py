"""Train / eval steps (port of ``icek_tpu/train/step.py``): masked-CE loss,
Adam with the reference's per-element gradient clamp, plateau LR decay.

Loss semantics match the reference (geo-aware/train.py:274-284): scores at
position t predict caption token t+1, restricted to positions t < length-1
(through <end>) and non-<pad> targets, averaged over all contributing
tokens.  A mask replaces the reference's sort + pack_padded_sequence.

Steps on cached image tokens (from the batch or gathered from a device
token cache), or with the ResNet inside the step: frozen, fine-tuned
(masked Adam over layers 2-4 and the projection) or with train-mode batch
norm; gradient accumulation.  Where JAX returns new trees, the port updates
the trees and the optimizer states in place and returns the same objects;
where JAX threads a PRNG key, the step takes a CPU ``torch.Generator``.
Loss and token count come back as 0-d tensors on the step's device (reading
them is the caller's synchronisation).

Under a (data, model) mesh (``parallel/mesh.py``) every rank steps on its
local rows: the model-sharded tables are all-gathered for the forward, the
token count and the gradients of the summed NLL are all-reduced over the
data axis, and each rank keeps its slice of the tables' gradients, so
Adam's moments of the tables live sharded.  Dropout masks are keyed by
global batch row (``transformer.batch_rows``), as JAX's are under its mesh.
A row-sharded token cache (``token_cache_mesh``) is read with
``mesh.sharded_row_gather``.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.distributed as dist

from icek_torch.core.config import Config
from icek_torch.data import images as image_ops
from icek_torch.models import captioner as cap
from icek_torch.models import resnet
from icek_torch.models import transformer as tfm


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


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(tree, path)


class OptState:
    """Adam's state over one param tree: the ``torch.optim.Adam`` holding
    the moments, and the injected hyperparameters."""

    def __init__(self, adam: torch.optim.Adam, learning_rate: float):
        self.adam = adam
        self.hyperparams = {"learning_rate": learning_rate}

    def moments(self, params):
        """(mu, nu) trees shaped like `params` (zeros before the first step,
        and for leaves the optimizer does not train)."""
        def pick(key):
            def leaf(p, _path):
                st = self.adam.state.get(p)
                return st[key] if st else torch.zeros_like(p)
            return _map(params, leaf)
        return pick("exp_avg"), pick("exp_avg_sq")

    def step_count(self) -> int:
        for st in self.adam.state.values():
            return int(st["step"])
        return 0

    def export(self, params, gather=None) -> Dict:
        """The state as CPU tensors keyed by param path: {"step",
        "learning_rate", "mu", "nu"}, the moment trees shaped like
        `params` (what a checkpoint stores).  `gather` maps each moment tree
        first (under a mesh: to full size, ``mesh.gather_for_host``)."""
        mu, nu = self.moments(params)
        if gather is not None:
            mu, nu = gather(mu), gather(nu)
        cpu = lambda t, _path: t.detach().to("cpu", copy=True)  # noqa: E731
        return {"step": self.step_count(),
                "learning_rate": float(self.hyperparams["learning_rate"]),
                "mu": _map(mu, cpu), "nu": _map(nu, cpu)}

    def restore(self, params, state: Dict) -> "OptState":
        """Load an ``export`` dict (or ``bridge.from_jax_opt_leaves``'s) for
        the trained leaves of `params`: the moments by path, every leaf at
        the stored step count, the group's learning rate."""
        trained = {id(p) for group in self.adam.param_groups for p in group["params"]}
        lr = float(state["learning_rate"])
        self.hyperparams["learning_rate"] = lr
        for group in self.adam.param_groups:
            group["lr"] = lr
        if not state["step"]:
            return self

        def load(p, path):
            if id(p) not in trained:
                return
            mu, nu = _get(state["mu"], path), _get(state["nu"], path)
            if tuple(mu.shape) != tuple(p.shape) or tuple(nu.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state at {path}: moments {tuple(mu.shape)} / "
                                 f"{tuple(nu.shape)} for a param of {tuple(p.shape)}")
            self.adam.state[p] = {
                "step": torch.tensor(float(state["step"]), dtype=torch.float32),
                "exp_avg": mu.to(p.device, p.dtype, copy=True),
                "exp_avg_sq": nu.to(p.device, p.dtype, copy=True)}

        _map(params, load)
        return self


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class Optimizer:
    """clip-by-value then Adam: the reference's clamp_(-c, c) on every
    gradient element (geo-aware/utils.py:75-85) followed by Adam.step, with
    b1 0.9, b2 0.999, eps 1e-8.  With `mask` (a tree of bools shaped like the
    params) only the leaves it marks train; the others get no gradient and
    never move."""

    def __init__(self, learning_rate: float, grad_clip: float = 5.0, mask=None):
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.mask = mask

    def init(self, params) -> OptState:
        """State for `params`, whose trained floating leaves become autograd
        leaves in place (no copy); leaves the mask freezes stop asking for
        gradients."""
        mask = list(tree_leaves(self.mask)) if self.mask is not None else None
        leaves = []
        for i, p in enumerate(tree_leaves(params)):
            if not p.is_floating_point():
                continue
            if mask is None or mask[i]:
                leaves.append(p.requires_grad_(True))
            else:
                p.requires_grad_(False)
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


_BN_STATS = ("mean", "var")


def encoder_trainable_mask(encoder_params):
    """The reference's fine-tune policy (geo models.py:49-60, train.py:92-100):
    ResNet blocks 2-4 and the 1x1 projection train; the stem, layer1 and
    every batch-norm running statistic stay frozen."""
    def stage(name, sub):
        trainable = name in ("layer2", "layer3", "layer4", "proj")
        return _map(sub, lambda _t, path: trainable and not any(
            k in _BN_STATS for k in path))
    return {name: stage(name, sub) for name, sub in encoder_params.items()}


def make_encoder_optimizer(encoder_params, learning_rate: float,
                           grad_clip: float = 5.0) -> Optimizer:
    """Clip + Adam over the fine-tunable encoder subset; frozen leaves never
    move."""
    return Optimizer(learning_rate, grad_clip, mask=encoder_trainable_mask(encoder_params))


def decay_learning_rate(opt_state: OptState, factor: float) -> OptState:
    lr = opt_state.hyperparams["learning_rate"] * factor
    opt_state.hyperparams["learning_rate"] = lr
    for group in opt_state.adam.param_groups:
        group["lr"] = lr
    return opt_state


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

_INDEX_KEYS = ("caption_ids", "caption_mask", "lengths", "token_rows")


def _to_device(batch: Dict, device) -> Dict:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.long() if k in _INDEX_KEYS else t
    return out


def _batch_images(batch):
    """Model-ready NHWC images from either batch form: "raw_images" (stored
    f16 CHW rows, normalized on the device) or "images" (host-normalized)."""
    if "raw_images" in batch:
        return image_ops.normalize_in_graph(batch["raw_images"])
    return batch["images"]


def _merge_stats(encoder_params, new_enc) -> None:
    """Copy the train-mode running statistics of `new_enc` into the batch-norm
    mean / var leaves of `encoder_params`, in place."""
    def leaf(t, path):
        if path[-1] in _BN_STATS:
            with torch.no_grad():
                t.copy_(_get(new_enc, path))
    _map(encoder_params, leaf)


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
    mesh=None,
    param_specs=None,
):
    """Build (train_step, eval_step).

    The batch carries "caption_ids" / "caption_mask" (B, T), "lengths" (B,),
    "entity_features" and, for the knowledge and news presets,
    "fact_features" (B, F, 3); numpy arrays or tensors, moved to `device` by
    the step.  Its image input: with ``encode_images=False`` precomputed
    tokens (B, 196, D) under "image_tokens", or "token_rows" (B,) into
    `token_cache`, one device tensor of the split's tokens (this rank's block
    of a row-sharded cache when `token_cache_mesh` is given); otherwise
    "raw_images" (stored f16 CHW rows) or "images" (normalized NHWC), and the
    ResNet runs inside the step with no gradient into it, unless
    `encoder_optimizer` (``make_encoder_optimizer``) fine-tunes it.
    `params` (and, to fine-tune, `encoder_params`) must already live on
    `device` (see ``bridge.trainable``).

        params, opt_state, loss, count = train_step(
            params, opt_state, encoder_params, batch, gen)
        # fine-tuning
        params, opt_state, encoder_params, enc_opt_state, loss, count = \
            train_step(params, opt_state, encoder_params, enc_opt_state, batch, gen)
        # bn_train_mode (frozen encoder)
        params, opt_state, encoder_params, loss, count = train_step(
            params, opt_state, encoder_params, batch, gen)
        loss, count = eval_step(params, encoder_params, batch)

    `gen` is a CPU ``torch.Generator`` feeding every dropout site.  With
    `bn_train_mode` the encoder's batch norms run in train mode and their
    running statistics in `encoder_params` move (in place); validation
    always reads the running statistics.  With
    ``cfg.train.grad_accum_steps`` = N > 1 the batch is zero-padded to a
    multiple of N and split into N microbatches; gradients of the summed
    NLL add across them and are scaled once by 1 / total_tokens, which
    equals the full-batch mean-loss gradient up to float associativity
    while peak activation memory is one microbatch's.

    With `mesh` (``parallel/mesh.py::make_mesh``) the batch holds this
    rank's rows of the global batch (``mesh.shard_batch``, or the loaders'
    process slice), `params` are this rank's and `param_specs` their specs
    (both from ``mesh.shard_params``), `gen` is seeded alike on every rank,
    and the step runs on the mesh's device.  An axis of size 1 calls no
    collective.  Loss and token count are the
    global batch's.  Under ``grad_accum_steps`` > 1 each rank splits its own
    rows, so with dropout on the masks follow the mesh's microbatches, not
    the single-device ones.
    """
    from icek_torch.parallel import mesh as mesh_lib

    for name, m in (("mesh", mesh), ("token_cache_mesh", token_cache_mesh)):
        if m is not None and not mesh_lib.is_mesh(m):
            raise TypeError(f"make_train_step: {name} must be a (data, model) "
                            f"DeviceMesh (parallel/mesh.py::make_mesh), got {type(m)}")
    if token_cache_mesh is not None and token_cache is None:
        raise ValueError("make_train_step: token_cache_mesh without a token_cache")
    mesh = mesh if mesh is not None else token_cache_mesh
    if bn_train_mode and not encode_images:
        raise ValueError("bn_train_mode requires encode_images=True")
    device = torch.device(device) if mesh is None else mesh_lib.mesh_device(mesh)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step: device 'cuda' requested but no CUDA "
                           "device is available; pass device='cpu' to run there")
    mcfg = cfg.model
    fine_tune = encoder_optimizer is not None
    accum_steps = getattr(cfg.train, "grad_accum_steps", 1)
    if bn_train_mode and accum_steps == "auto":
        accum_steps = 1     # batch statistics are defined over the full batch
    accum = resolve_grad_accum(accum_steps, mcfg.variant, cfg.train.batch_size)
    if accum > 1 and bn_train_mode:
        raise ValueError("grad_accum_steps > 1 is incompatible with bn_train_mode: "
                         "batch-norm batch statistics are defined over the full batch")
    S = M = 1
    if mesh is not None:
        S = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
        M = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
        d_index = mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS)
        data_group = mesh_lib.axis_group(mesh, mesh_lib.DATA_AXIS)
        if M > 1 and param_specs is None:
            raise ValueError("make_train_step: a mesh with a model axis needs the "
                             "param_specs that mesh.shard_params returned")

    def all_sum(t):
        """`t` summed over the data axis (itself on one data shard)."""
        if S > 1:
            dist.all_reduce(t, group=data_group)
        return t

    def rows(b_local):
        """Dropout masks keyed by global batch row, BN statistics over the
        global batch (a mesh with more than one data shard)."""
        if mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(tfm.batch_rows(d_index * b_local, S * b_local))
        if bn_train_mode and S > 1:
            stack.enter_context(resnet.sync_batch_stats(data_group))
        return stack

    def image_tokens(encoder_params, batch, train):
        """(tokens in the compute dtype, the encoder tree with train-mode
        statistics or None).  ``train=False`` (validation) reads the running
        statistics whatever bn_train_mode says (the reference's validate()
        calls encoder.eval()) and takes no gradient."""
        if not encode_images:
            if token_cache is not None and "token_rows" in batch:
                if token_cache_mesh is not None:
                    toks = mesh_lib.sharded_row_gather(token_cache, batch["token_rows"],
                                                       token_cache_mesh)
                else:
                    toks = token_cache.index_select(0, batch["token_rows"])
            else:
                toks = batch["image_tokens"]
            return toks.to(compute_dtype), None
        bn_train = train and bn_train_mode
        with torch.enable_grad() if train and fine_tune else torch.no_grad():
            out = resnet.resnet_encode(
                encoder_params, _batch_images(batch), mcfg.encoded_image_size,
                compute_dtype=compute_dtype, train=bn_train, return_stats=bn_train)
        return out if bn_train else (out, None)

    def forward_total(params, encoder_params, batch, gen, deterministic, train=True):
        """(summed NLL, token count, the encoder tree with train-mode
        statistics or None) for one batch or microbatch."""
        with rows(batch["caption_ids"].shape[0]):
            tokens, new_enc = image_tokens(encoder_params, batch, train)
            scores = cap.captioner_forward(
                params, mcfg, vocab_size, pad_id, batch["caption_ids"],
                batch["caption_mask"], tokens, batch["entity_features"],
                batch.get("fact_features"), gen=gen, deterministic=deterministic,
                compute_dtype=compute_dtype,
                # the (B, T, V+E) scores stay in the compute dtype through the
                # loss; _token_nll reads and writes them with f32 accumulation
                score_dtype=compute_dtype,
            )
        total, count = caption_loss_total(scores, batch["caption_ids"],
                                          batch["lengths"], pad_id)
        return total, count, new_enc

    def microbatches(batch):
        B = next(iter(batch.values())).shape[0]
        pad = (-B) % accum
        size = (B + pad) // accum
        if token_cache_mesh is not None:
            # the single-device step's microbatch over the global batch
            mesh_lib.check_gather_rows(-(-B * S // accum), token_cache_mesh)
        for i in range(accum):
            micro = {}
            for k, v in batch.items():
                if pad:   # padded rows carry zero valid tokens
                    v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                micro[k] = v[i * size:(i + 1) * size]
            yield micro

    # (local leaf, the all-gathered leaf its forward reads) of the sharded tables
    gathered = []

    def forward_params(params):
        """The param tree the forward reads: the model-sharded tables
        all-gathered to full size, as new autograd leaves (on a model axis
        of size 1 the params themselves)."""
        gathered.clear()
        if M == 1:
            return params

        def leaf(p, spec):
            if mesh_lib.sharded_dim(spec) is None:
                return p
            full = mesh_lib.gather_table(p, spec, mesh).requires_grad_(p.requires_grad)
            gathered.append((p, full, spec))
            return full

        return mesh_lib.map_specs(params, param_specs, leaf)

    def reduce_grads(trees):
        """Every gradient summed over the data axis in one flat all-reduce a
        dtype (none on one data shard), then each gathered table keeps its
        slice."""
        if S > 1:
            held = {id(p) for p, _, _ in gathered}
            grads = [full.grad for _, full, _ in gathered if full.grad is not None]
            grads += [p.grad for tree in trees for p in tree_leaves(tree)
                      if id(p) not in held and p.grad is not None]
            for dtype in sorted({g.dtype for g in grads}, key=str):
                group = [g for g in grads if g.dtype == dtype]
                flat = torch._utils._flatten_dense_tensors(group)
                dist.all_reduce(flat, group=data_group)
                for g, r in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
                    g.copy_(r)
        for p, full, spec in gathered:
            if full.grad is not None:
                p.grad = mesh_lib.local_slice(full.grad, spec, mesh).contiguous()

    def grads(params, encoder_params, batch, gen):
        """Gradients into .grad; returns (loss, count, new_enc)."""
        trees = (params, encoder_params) if fine_tune else (params,)
        fwd = forward_params(params)
        if accum == 1:
            total, count, new_enc = forward_total(fwd, encoder_params, batch, gen,
                                                  False)
            # under a mesh the global token count scales every rank's backward
            loss = total / all_sum(count).clamp(min=1)
            loss.backward()
            reduce_grads(trees)
            return all_sum(loss.detach()), count, new_enc
        total = torch.zeros((), dtype=torch.float32, device=device)
        count = torch.zeros((), dtype=torch.int64, device=device)
        for micro in microbatches(batch):
            tot, cnt, _ = forward_total(fwd, encoder_params, micro, gen, False)
            tot.backward()                     # .grad sums the microbatches
            total += tot.detach()
            count += cnt
        reduce_grads(trees)
        all_sum(total)
        all_sum(count)
        inv = 1.0 / count.clamp(min=1).to(torch.float32)
        for tree in trees:
            for p in tree_leaves(tree):
                if p.grad is not None:
                    p.grad.mul_(inv.to(p.grad.dtype))
        return total * inv, count, None

    if fine_tune:
        def train_step(params, opt_state, encoder_params, enc_opt_state, batch, gen):
            loss, count, new_enc = grads(params, encoder_params,
                                         _to_device(batch, device), gen)
            optimizer.update(opt_state)
            encoder_optimizer.update(enc_opt_state)
            if new_enc is not None:
                _merge_stats(encoder_params, new_enc)
            return params, opt_state, encoder_params, enc_opt_state, loss, count
    elif bn_train_mode:
        def train_step(params, opt_state, encoder_params, batch, gen):
            loss, count, new_enc = grads(params, encoder_params,
                                         _to_device(batch, device), gen)
            optimizer.update(opt_state)
            _merge_stats(encoder_params, new_enc)
            return params, opt_state, encoder_params, loss, count
    else:
        def train_step(params, opt_state, encoder_params, batch, gen):
            loss, count, _ = grads(params, encoder_params, _to_device(batch, device), gen)
            optimizer.update(opt_state)
            return params, opt_state, loss, count

    def eval_step(params, encoder_params, batch):
        with torch.no_grad():
            total, count, _ = forward_total(forward_params(params), encoder_params,
                                            _to_device(batch, device), None, True,
                                            train=False)
            if S > 1:
                total, count = all_sum(total.clone()), all_sum(count.clone())
        return total / count.clamp(min=1), count

    return train_step, eval_step
