"""Param trees between the JAX package's layout and the port's tensors.

The interchange format is the JAX param pytree turned into numpy
(``jax.tree.map(np.asarray, params)``, done by the caller): nested dicts
and lists, linear weights (in, out), MHA with a fused ``qkv_w``.  The
captioner tree keeps that layout as torch tensors.  The ResNet tree's
convolution weights change from HWIO to torch's OIHW; batch-norm stats
stay as they are (``resnet.fold_bn_params`` folds them in the port).
``to_numpy`` goes back, so a round trip is bit-exact.
``from_jax_qtree`` turns an int8 encoder tree of ``icek_tpu``'s layout
(HWIO int8 ``wq``) into the port's (OHWI ``wq``, OIHW ``proj``), and
``to_jax_qtree`` goes back.  ``from_jax_opt_leaves`` turns a JAX checkpoint's optax Adam state into the
port's optimizer state.
"""

from __future__ import annotations

import numpy as np
import torch

from icek_torch.core.config import ModelConfig

_CONV_KEYS = ("conv1", "conv2", "conv3", "down_conv")


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(tree, path)


def _tensor(x, _path=()):
    if torch.is_tensor(x):            # bfloat16 leaves of the msgpack reader
        return x.detach().clone()
    return torch.from_numpy(np.array(x, copy=True))


def to_torch(tree):
    """Any numpy tree -> the same tree of (copied) torch tensors."""
    return _map(tree, _tensor)


def from_jax_params(tree, cfg: ModelConfig, vocab: int):
    """Captioner params (numpy tree) -> torch tensors of the same layout.
    The shapes of the embeddings and heads (with facts: the predicate
    embedding, the fact and predicate heads and the fact encoder's layers)
    are checked against `cfg` and `vocab`."""
    D = cfg.emb_dim
    want = {
        "word_embedding": (vocab, D),
        "type_embedding": (cfg.type_vocab, cfg.type_emb_dim),
        "fc_vocab": {"w": (D, vocab), "b": (vocab,)},
    }
    if cfg.has_facts:
        P = cfg.num_predicates
        want.update({
            "predicate_embedding": (P, D),
            "fc_fact": {"w": (D, 1), "b": (1,)},
            "fc_predicate": {"w": (P, D), "b": (D,)},
        })
        layers = tree["ctx_encoder_facts"]["layers"]
        if len(layers) != cfg.num_layers or any(
                np.shape(lay["self_attn"]["qkv_w"]) != (D, 3 * D) for lay in layers):
            raise ValueError(f"ctx_encoder_facts: expected {cfg.num_layers} layers of "
                             f"width {D}")
    for key, shape in want.items():
        got = tree[key]
        pairs = ((got[k], s) for k, s in shape.items()) if isinstance(shape, dict) \
            else ((got, shape),)
        for arr, s in pairs:
            if tuple(np.shape(arr)) != s:
                raise ValueError(f"{key}: shape {np.shape(arr)} != expected {s}")
    return to_torch(tree)


def _is_conv(path) -> bool:
    return path[-1] in _CONV_KEYS or path[-2:] == ("proj", "w")


def from_jax_resnet(tree):
    """ResNet params (numpy tree, HWIO convs) -> torch tensors, OIHW convs."""
    def convert(x, path):
        t = _tensor(x)
        return t.permute(3, 2, 0, 1).contiguous() if _is_conv(path) else t

    return _map(tree, convert)


def from_jax_qtree(tree):
    """An int8 encoder tree in JAX's layout (numpy or tensors: HWIO int8
    ``wq``, float32 ``es`` / ``b``, the ``inv_*`` / ``a_*`` scalars, float
    ``proj``, uint8 ``_fingerprint``) -> the port's: ``wq`` int8 OHWI,
    ``proj["w"]`` OIHW, scalars as 0-dim float32 tensors."""
    def convert(x, path):
        t = _tensor(x)
        if path[-1] == "wq":
            return t.permute(3, 0, 1, 2).contiguous()
        if path[-2:] == ("proj", "w"):
            return t.permute(3, 2, 0, 1).contiguous()
        if t.dim() == 0:
            return t.to(torch.float32)
        return t

    return _map(tree, convert)


def to_jax_qtree(tree):
    """The inverse of ``from_jax_qtree``, as a numpy tree."""
    def convert(t, path):
        x = torch.as_tensor(t).detach().cpu()
        if path[-1] == "wq":
            x = x.permute(1, 2, 3, 0)
        elif path[-2:] == ("proj", "w"):
            x = x.permute(2, 3, 1, 0)
        return x.contiguous().numpy().copy()

    return _map(tree, convert)


def to_numpy(tree, resnet: bool = False):
    """The inverse of ``from_jax_params`` (or ``from_jax_resnet`` when
    `resnet`): torch tensors -> a numpy tree in the JAX layout."""
    def convert(t, path):
        x = t.detach().cpu()
        if resnet and _is_conv(path):
            x = x.permute(2, 3, 1, 0)
        return x.contiguous().numpy().copy()      # 0-dim leaves stay 0-dim

    return _map(tree, convert)


def trainable(tree, device=None):
    """The tree moved to `device` (no copy for leaves already there) with
    every floating leaf marked as an autograd leaf, in place: what
    ``train.step`` takes as `params`.  The serving path reads the same
    tensors under ``torch.inference_mode``, where the mark costs nothing."""
    def convert(t, _path):
        t = t if device is None else t.to(device)
        return t.requires_grad_(True) if t.is_floating_point() else t

    return _map(tree, convert)


def to_device(tree, device):
    """The tree with every leaf on `device` (no copy for leaves already
    there), autograd marks untouched."""
    return _map(tree, lambda t, _path: t.to(device))


def grads_to_numpy(tree):
    """The gradients of a param tree as a numpy tree of the same layout
    (zeros where a leaf has none), for comparing gradient trees leaf by leaf."""
    def convert(t, _path):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        return np.ascontiguousarray(g.detach().cpu().numpy())

    return _map(tree, convert)


def _jax_order(tree, path=()):
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_order(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_order(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def from_jax_opt_leaves(opt_leaves, jax_params_tree):
    """A JAX checkpoint's ``opt_leaves`` -> the port's optimizer state.

    ``icek_tpu.train.step.make_optimizer``'s state flattens to [the injected
    count, the learning rate, Adam's count, Adam's mu leaves, Adam's nu
    leaves], the moments in the params' flattening order (sorted keys).
    optax's count, mu and nu become torch Adam's step, exp_avg and
    exp_avg_sq, the learning rate the group's lr.  Returns the dict
    ``train.step.OptState.restore`` takes: {"step", "learning_rate", "mu",
    "nu"}, the moments as trees of tensors shaped like `jax_params_tree`.
    Any other leaf count, or a moment whose shape is not its param's,
    raises ``ValueError``."""
    paths = list(_jax_order(jax_params_tree))
    n = len(paths)
    if len(opt_leaves) != 3 + 2 * n:
        raise ValueError(f"opt_leaves: {len(opt_leaves)} leaves, expected {3 + 2 * n} "
                         f"(count, learning rate, Adam count, mu and nu of {n} params)")
    scalars = [np.asarray(x) for x in opt_leaves[:3]]
    if any(x.shape != () for x in scalars):
        raise ValueError(f"opt_leaves: the first three leaves must be scalars, got "
                         f"shapes {[x.shape for x in scalars]}")
    mu, nu = _map(jax_params_tree, lambda x, _p: None), _map(jax_params_tree,
                                                             lambda x, _p: None)
    for (path, param), m, v in zip(paths, opt_leaves[3:3 + n], opt_leaves[3 + n:]):
        for what, leaf in (("mu", m), ("nu", v)):
            if tuple(np.shape(leaf)) != tuple(np.shape(param)):
                raise ValueError(f"opt_leaves: {what} at {path} has shape "
                                 f"{tuple(np.shape(leaf))}, its param {tuple(np.shape(param))}")
        _set(mu, path, _tensor(m))
        _set(nu, path, _tensor(v))
    return {"step": int(scalars[2]), "learning_rate": float(scalars[1]), "mu": mu, "nu": nu}
