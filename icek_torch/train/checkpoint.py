"""Checkpoint save / restore with the reference's filename and rotation
protocol (port of ``icek_tpu/train/checkpoint.py``).

Every epoch saves ``checkpoint_{base}.pt`` (odd epochs, rolling) or
``checkpoint_{epoch}_{base}.pt`` (even epochs, kept); the best (by
validation loss) also gets a ``BEST_`` copy; a mid-epoch checkpoint is the
rolling ``checkpoint_STEP_{base}.pt`` (reference: geo-aware/utils.py:8-49;
JAX writes the same names with ``.msgpack``).  A file is
``torch.save({"meta": json str, "params", "opt", "encoder_params"})``:

  * params in the interchange layout of ``bridge.py`` as CPU tensors (the
    captioner tree as the port holds it, ResNet convolutions HWIO), so
    ``torch.load(..., weights_only=True)`` reads it;
  * "opt": Adam's step count, learning rate and moment trees keyed by param
    path (``train.step.OptState.export``), or None.

Every reader takes the port's ``.pt`` files and JAX's ``.msgpack`` files
alike (``train/msgpack.py``; optax's state through
``bridge.from_jax_opt_leaves``) and returns the port's trees.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from icek_torch import bridge
from icek_torch.train import msgpack


def _interchange(tree, resnet: bool = False):
    """A port tree -> the interchange layout as CPU tensors."""
    return bridge.to_torch(bridge.to_numpy(tree, resnet=resnet))


def _write(path: str, payload: Dict) -> None:
    # write-then-rename: a preemption mid-write must not corrupt the rolling
    # file a later auto-resume would pick up
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(
    directory: str,
    base_name: str,
    epoch: int,
    epochs_since_improvement: int,
    loss: float,
    params: Any,
    opt_state: Any,
    encoder_params: Any = None,
    is_best: bool = False,
    step: Optional[int] = None,
    extra_meta: Optional[Dict] = None,
) -> str:
    """``step`` marks a mid-epoch checkpoint: meta records the next batch of
    ``epoch`` to run and resume re-enters the epoch there.  `opt_state` is
    the port's ``OptState`` (or None)."""
    os.makedirs(directory, exist_ok=True)
    meta = {"epoch": epoch, "epochs_since_improvement": epochs_since_improvement,
            "loss": float(loss)}
    if step is not None:
        meta["step"] = int(step)
    if extra_meta:
        meta.update(extra_meta)
    payload = {
        "meta": json.dumps(meta),
        "params": _interchange(params),
        "opt": opt_state.export(params) if opt_state is not None else None,
        "encoder_params": (_interchange(encoder_params, resnet=True)
                           if encoder_params is not None else {}),
    }
    if step is not None:
        filename = f"checkpoint_STEP_{base_name}.pt"
    elif epoch % 2 == 0:
        filename = f"checkpoint_{epoch}_{base_name}.pt"
    else:
        filename = f"checkpoint_{base_name}.pt"
    path = os.path.join(directory, filename)
    _write(path, payload)
    if is_best:
        shutil.copyfile(path, os.path.join(directory, "BEST_" + filename))
    return path


def _read(path: str, mmap: bool = False) -> Dict:
    if path.endswith(".msgpack"):
        return msgpack.read(path)
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def load_checkpoint(path: str) -> Tuple[Any, Optional[Dict], Any, Dict]:
    """(params, opt, encoder_params, meta) of a ``.pt`` or JAX ``.msgpack``
    checkpoint: the port's trees on the CPU, the optimizer state as
    ``OptState.restore`` takes it (None when the file has none), and the
    encoder tree (None when the file has none)."""
    payload = _read(path)
    meta = json.loads(payload["meta"])
    params = bridge.to_torch(payload["params"])
    enc = payload.get("encoder_params") or None
    if path.endswith(".msgpack"):
        leaves = payload.get("opt_leaves", [])
        opt = bridge.from_jax_opt_leaves(leaves, payload["params"]) if len(leaves) else None
    else:
        opt = payload.get("opt")
    return params, opt, (bridge.from_jax_resnet(enc) if enc else None), meta


def read_meta(path: str) -> Dict:
    """The meta dict of a checkpoint (for pre-flight checks such as the
    resume-side geometry)."""
    return json.loads(_read(path, mmap=True)["meta"])


def save_encoder_tree(path: str, encoder_params: Any, meta: Optional[Dict] = None) -> str:
    """A standalone encoder-weights file, ``{meta, encoder_params}`` only, for
    ``train --encoder-weights``."""
    _write(path, {"meta": json.dumps(meta or {}),
                  "encoder_params": _interchange(encoder_params, resnet=True)})
    return path


def load_encoder_tree(path: str) -> Tuple[Any, Dict]:
    """(encoder_params, meta) from a ``save_encoder_tree`` file or a full
    training checkpoint (its encoder_params are taken), ``.pt`` or JAX
    ``.msgpack``."""
    payload = _read(path)
    if not payload.get("encoder_params"):
        raise ValueError(f"{path} carries no encoder_params")
    meta = json.loads(payload.get("meta", "{}"))
    return bridge.from_jax_resnet(payload["encoder_params"]), meta


def _resume_key(meta: Dict):
    if "step" in meta:
        return meta["epoch"], meta["step"]
    return meta["epoch"] + 1, 0


def latest_checkpoint(directory: str, base_name: str) -> Optional[str]:
    """The checkpoint an auto-resume takes, ``.pt`` or ``.msgpack``: ranked
    by where training resumes, an epoch-E checkpoint at (E + 1, batch 0), a
    STEP checkpoint at (E, batch s), so a STEP file of a preempted epoch E
    outranks epoch E - 1's file and loses to epoch E's."""
    if not os.path.isdir(directory):
        return None
    best_path, best_key = None, (-1, -1)
    for name in sorted(os.listdir(directory)):
        if name.startswith("BEST_") or not (
                name.endswith(f"{base_name}.pt") or name.endswith(f"{base_name}.msgpack")):
            continue
        path = os.path.join(directory, name)
        try:
            key = _resume_key(read_meta(path))
        except Exception:  # noqa: BLE001 - an unreadable file is not a candidate
            continue
        if key > best_key:
            best_key, best_path = key, path
    return best_path

