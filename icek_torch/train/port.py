"""Import reference PyTorch checkpoints into the port's parameter trees
(port of ``icek_tpu/train/port.py``).

The reference saves whole pickled nn.Modules (geo-aware/utils.py:32-49):
``{epoch, epochs_since_improvement, loss, encoder, decoder, *_optimizer}``.
This module maps their state_dicts onto the port's trees: the captioner in
the interchange layout (linear weights (in, out), MHA with a fused
``qkv_w``), the ResNet with torch's own OIHW convolutions.  It works from a
plain ``{name: tensor or array}`` dict, so a ``state_dict()`` feeds it
directly.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from icek_torch.core.config import ModelConfig
from icek_torch.models import resnet


def _t(x) -> torch.Tensor:
    """A copy as a CPU tensor (never an alias of a live module's buffer)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x, copy=True))


def _linear(state, prefix):
    return {"w": _t(state[prefix + ".weight"]).T.contiguous(),
            "b": _t(state[prefix + ".bias"])}


def _norm(state, prefix):
    return {"scale": _t(state[prefix + ".weight"]), "bias": _t(state[prefix + ".bias"])}


def _mha(state, prefix):
    return {"qkv_w": _t(state[prefix + ".in_proj_weight"]).T.contiguous(),
            "qkv_b": _t(state[prefix + ".in_proj_bias"]),
            "out": _linear(state, prefix + ".out_proj")}


def _ffn(state, p):
    return {"lin1": _linear(state, p + ".linear1"), "lin2": _linear(state, p + ".linear2")}


def _encoder_stack(state, prefix, num_layers):
    layers = []
    for i in range(num_layers):
        p = f"{prefix}.layers.{i}"
        layers.append({"self_attn": _mha(state, p + ".self_attn"), "ffn": _ffn(state, p),
                       "norm1": _norm(state, p + ".norm1"),
                       "norm2": _norm(state, p + ".norm2")})
    return {"layers": layers}


def _decoder_stack(state, prefix, num_layers):
    layers = []
    for i in range(num_layers):
        p = f"{prefix}.layers.{i}"
        layers.append({"self_attn": _mha(state, p + ".self_attn"),
                       "cross_attn": _mha(state, p + ".multihead_attn"),
                       "ffn": _ffn(state, p),
                       "norm1": _norm(state, p + ".norm1"),
                       "norm2": _norm(state, p + ".norm2"),
                       "norm3": _norm(state, p + ".norm3")})
    return {"layers": layers}


def import_captioner_state(state: Dict, cfg: ModelConfig):
    """Map a reference DecoderTransformer state_dict onto the port's tree."""
    params = {
        "word_embedding": _t(state["word_embedding.weight"]),
        "type_embedding": _t(state["entity_encoder.type_embedding.weight"]),
        "ctx_encoder_entities": _encoder_stack(state, "transformer_encoder_entities",
                                               cfg.num_layers),
        "decoder": _decoder_stack(state, "transformer_decoder", cfg.num_layers),
        "fc_vocab": _linear(state, "fc_vocab"),
        "fc_entity": _linear(state, "fc_entity"),
    }
    if cfg.has_facts:
        params.update({
            "predicate_embedding": _t(state["predicate_embedding.weight"]),
            "ctx_encoder_facts": _encoder_stack(state, "transformer_encoder_facts",
                                                cfg.num_layers),
            "fc_fact": _linear(state, "fc_fact"),
            "fc_predicate": _linear(state, "fc_predicate"),
        })
    return params


def import_torch_state(state: Dict, emb_dim: int = 300):
    """A torchvision resnet101 state_dict (raw names ``layer1.0.conv1.weight``
    or the reference Encoder's ``resnet.<idx>...`` names, with its 1x1
    ``conv1`` projection) -> the port's encoder tree.  Without a projection
    in the state, ``proj`` is zeros (``load_torchvision_encoder`` draws a
    fresh one)."""
    def bn(prefix):
        return {"scale": _t(state[prefix + ".weight"]), "bias": _t(state[prefix + ".bias"]),
                "mean": _t(state[prefix + ".running_mean"]),
                "var": _t(state[prefix + ".running_var"])}

    if any(k.startswith("resnet.0") for k in state):
        alias = {"conv1": "resnet.0", "bn1": "resnet.1", "layer1": "resnet.4",
                 "layer2": "resnet.5", "layer3": "resnet.6", "layer4": "resnet.7"}
    else:
        alias = {k: k for k in ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")}
    params = {"conv1": _t(state[alias["conv1"] + ".weight"]), "bn1": bn(alias["bn1"])}
    for stage, count in enumerate(resnet.BLOCK_COUNTS, start=1):
        blocks = []
        for b in range(count):
            p = f"{alias[f'layer{stage}']}.{b}"
            block = {"conv1": _t(state[p + ".conv1.weight"]), "bn1": bn(p + ".bn1"),
                     "conv2": _t(state[p + ".conv2.weight"]), "bn2": bn(p + ".bn2"),
                     "conv3": _t(state[p + ".conv3.weight"]), "bn3": bn(p + ".bn3")}
            if p + ".downsample.0.weight" in state:
                block["down_conv"] = _t(state[p + ".downsample.0.weight"])
                block["down_bn"] = bn(p + ".downsample.1")
            blocks.append(block)
        params[f"layer{stage}"] = blocks
    if "conv1.weight" in state and "conv1.bias" in state and alias["conv1"] != "conv1":
        # the reference Encoder's own 1x1 projection is named conv1.*
        params["proj"] = {"w": _t(state["conv1.weight"]), "b": _t(state["conv1.bias"])}
    elif "proj.weight" in state:
        params["proj"] = {"w": _t(state["proj.weight"]), "b": _t(state["proj.bias"])}
    else:
        width = resnet.STAGE_WIDTHS[-1] * resnet.EXPANSION
        params["proj"] = {"w": torch.zeros((emb_dim, width, 1, 1)),
                          "b": torch.zeros(emb_dim)}
    return params


def import_encoder_state(state: Dict, emb_dim: int = 300):
    """Map a reference Encoder (resnet + 1x1 conv) state_dict onto the port's
    encoder tree."""
    return import_torch_state(state, emb_dim)


def _check_width(params, emb_dim: int):
    got = params["proj"]["w"].shape[0]
    if got != emb_dim:
        raise ValueError(f"encoder weights project to emb_dim={got}, model wants {emb_dim}")


def load_torchvision_encoder(state_or_path, emb_dim: int = 300, seed: int = 0):
    """ImageNet-pretrained torchvision ``resnet101`` weights -> encoder tree.

    The reference builds its Encoder from the pretrained body plus a fresh
    1x1 projection (geo-aware/models.py:14-32).  Here the body imports
    through ``import_torch_state``; when the file carries no projection,
    ``proj`` is drawn from ``torch.Generator().manual_seed(seed)`` as
    ``resnet.init_proj`` draws it.  Takes a path to a torch file (a raw
    state_dict, a ``{"state_dict": ...}`` wrapper or a pickled module) or an
    in-memory mapping."""
    if isinstance(state_or_path, (str, os.PathLike)):
        obj = torch.load(state_or_path, map_location="cpu", weights_only=False)
    else:
        obj = state_or_path
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj and hasattr(obj["state_dict"], "items"):
        obj = obj["state_dict"]
    state = dict(obj)
    params = import_torch_state(state, emb_dim)
    has_ref_proj = any(k.startswith("resnet.0") for k in state) and "conv1.bias" in state
    if "proj.weight" not in state and not has_ref_proj:
        params["proj"] = resnet.init_proj(torch.Generator().manual_seed(seed), emb_dim)
    _check_width(params, emb_dim)
    return params


def resolve_encoder_weights(path: str, emb_dim: int = 300, seed: int = 0):
    """``--encoder-weights FILE``: an encoder tree or a full checkpoint, the
    port's ``.pt`` or JAX's ``.msgpack`` (its encoder_params are taken), or a
    torch ``.pth`` state_dict (converted on the fly)."""
    if path.endswith((".msgpack", ".pt")):
        from icek_torch.train import checkpoint as ckpt

        tree, _ = ckpt.load_encoder_tree(path)
        _check_width(tree, emb_dim)
        return tree
    return load_torchvision_encoder(path, emb_dim, seed)


def load_reference_checkpoint(path: str, cfg: ModelConfig):
    """Load a reference ``.pth.tar`` (whole pickled modules) and return
    ``(captioner_params, encoder_params, meta)``.  The pickled module classes
    must be importable (the reference subproject on ``sys.path``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta = {"epoch": ckpt.get("epoch"),
            "epochs_since_improvement": ckpt.get("epochs_since_improvement"),
            "loss": ckpt.get("loss")}
    return (import_captioner_state(ckpt["decoder"].state_dict(), cfg),
            import_encoder_state(ckpt["encoder"].state_dict(), cfg.emb_dim),
            meta)
