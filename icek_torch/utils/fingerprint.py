"""Deterministic content fingerprints for the port's param trees (port of
``icek_tpu/utils/fingerprint.py`` over nested dicts / lists of tensors).

Binds derived artifacts to the exact weights that produced them: the eval
token cache (``eval_driver.Evaluator.cache_split_tokens``) stores the
encoder's fingerprint with the cached tokens, so a cache built under one
checkpoint, encoder variant or compute dtype is never served under another.

The hash is sha256 over the tree's structure (dict keys walked in sorted
order) and each leaf's dtype, shape and raw bytes, plus caller-supplied
context strings.  A bfloat16 leaf hashes its raw bytes through an int16
view (numpy has no bf16).  The caches of the two packages are not shared,
so the hash need not equal the JAX package's.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def _walk(tree, h):
    if isinstance(tree, dict):
        h.update(b"{")
        for k in sorted(tree):
            h.update(repr(k).encode() + b":")
            _walk(tree[k], h)
        h.update(b"}")
    elif isinstance(tree, (list, tuple)):
        h.update(b"[%d" % len(tree))
        for v in tree:
            _walk(v, h)
        h.update(b"]")
    else:
        t = tree.detach() if torch.is_tensor(tree) else torch.as_tensor(np.asarray(tree))
        h.update(str(t.dtype).encode())
        h.update(repr(tuple(t.shape)).encode())
        t = t.contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())


def tree_fingerprint(tree, extra=()) -> str:
    """Hex sha256 of every leaf's contents + ``extra`` context."""
    h = hashlib.sha256()
    for item in extra:
        h.update(repr(item).encode())
        h.update(b"\x00")
    _walk(tree, h)
    return h.hexdigest()
