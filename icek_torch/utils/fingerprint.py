"""Deterministic content fingerprints for the port's param trees (port of
``icek_tpu/utils/fingerprint.py`` over nested dicts / lists of tensors).

Binds derived artifacts to the exact weights that produced them: the eval
token cache (``eval_driver.Evaluator.cache_split_tokens``) stores the
encoder's fingerprint with the cached tokens, and an int8 encoder tree
(``models/resnet_int8.py``) records the raw encoder's fingerprint, which
its loader verifies.

The hash is JAX's: sha256 over the caller's context strings, the tree's
structure as ``repr`` of JAX's ``PyTreeDef`` (dict keys sorted), then each
leaf's numpy dtype name, shape and raw bytes in JAX's flattening order.  A
bfloat16 leaf hashes as JAX's does: dtype "bfloat16" and its raw bytes.  So
one tree of numpy arrays in JAX's layout hashes to the same string in both
packages, which the int8 tree's fingerprint needs.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def _structure(tree) -> str:
    """``repr`` of the tree's ``jax.tree_util`` treedef, without the
    ``PyTreeDef(...)`` around it."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_structure(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "None" if tree is None else "*"


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _dtype_shape_bytes(leaf):
    if torch.is_tensor(leaf):
        t = leaf.detach().contiguous().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, arr.tobytes()


def tree_fingerprint(tree, extra=()) -> str:
    """Hex sha256 of every leaf's contents + ``extra`` context."""
    h = hashlib.sha256()
    for item in extra:
        h.update(repr(item).encode())
        h.update(b"\x00")
    h.update(f"PyTreeDef({_structure(tree)})".encode())
    for leaf in _leaves(tree):
        name, shape, data = _dtype_shape_bytes(leaf)
        h.update(name.encode())
        h.update(repr(shape).encode())
        h.update(data)
    return h.hexdigest()
