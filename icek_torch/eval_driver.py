"""Batched evaluation driver (port of ``icek_tpu/eval_driver.py``, the
serving entry point ``Evaluator.decode_batch``).

Images are encoded and decoded in large static batches on the device
(greedy or beam); only detokenization stays on the host.  One batch runs
the slice's whole path: normalize the raw f16 CHW rows, ResNet-101 (BN
folded when the compute dtype is not f32), the entity (and, for the
knowledge and news presets, fact) context encoders, the precomputed cross
K/V, then beam or greedy decode.

Not ported yet: ``Evaluator.run`` (CSV + metrics), the token cache, the
int8 encoder and meshes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from icek_torch.core.config import Config
from icek_torch.data import images as image_ops
from icek_torch.data.codec import Wordmap
from icek_torch.decode import beam as beam_lib
from icek_torch.decode import greedy as greedy_lib
from icek_torch.models import resnet

_MODES = (("raw", "raw_images"), ("images", "images"))


def resolve_eval_batch_size(batch_size: Optional[int], cfg: Config,
                            device="cuda") -> int:
    """Explicit arg > preset value > default by device (256 on CUDA, the
    benchmarked configuration; 64 on CPU)."""
    if batch_size is not None:
        return batch_size
    if cfg.decode.batch_size is not None:
        return cfg.decode.batch_size
    return 64 if torch.device(device).type == "cpu" else 256


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


class Evaluator:
    def __init__(self, cfg: Config, wordmap: Wordmap, params, encoder_params,
                 batch_size: Optional[int] = None,
                 beam_size: Optional[int] = None, compute_dtype=None,
                 device="cuda", mesh=None):
        """`params` / `encoder_params` are the port's param trees (see
        ``bridge.py``); they are moved to `device` ("cuda" unless the caller
        asks for the CPU).  Compute dtype defaults to bf16 on CUDA and f32
        on CPU."""
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet")
        if cfg.decode.kv_dtype not in (None, "auto"):
            raise NotImplementedError(f"kv_dtype={cfg.decode.kv_dtype!r} is not ported yet")
        self.cfg = cfg
        self.wordmap = wordmap
        self.device = torch.device(device)
        self.params = _to_device(params, self.device)
        self.encoder_params = _to_device(encoder_params, self.device)
        self.batch_size = resolve_eval_batch_size(batch_size, cfg, self.device)
        self.beam_size = beam_size if beam_size is not None else cfg.decode.beam_size
        if compute_dtype is None:
            compute_dtype = (torch.float32 if self.device.type == "cpu"
                             else torch.bfloat16)
        self.compute_dtype = compute_dtype
        # Frozen-encoder fast path for the bf16 mode: BN affines folded into
        # the conv weights.  The f32 mode keeps the exact unfolded path.
        self._encoder_folded = (
            resnet.fold_bn_params(self.encoder_params)
            if compute_dtype != torch.float32 else None
        )

    def _encode_tokens(self, images, mode: str):
        """Raw f16 CHW rows ("raw") or host-normalized NHWC images
        ("images") -> (B, 196, D) image tokens."""
        if mode == "raw":
            images = image_ops.normalize_in_graph(images)
        size = self.cfg.model.encoded_image_size
        if self._encoder_folded is not None:
            return resnet.resnet_encode_folded(self._encoder_folded, images, size,
                                               compute_dtype=self.compute_dtype)
        return resnet.resnet_encode(self.encoder_params, images, size,
                                    compute_dtype=self.compute_dtype)

    def decode_batch(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """One static-shape batch -> (B, max_len) extended-vocab ids.  The
        batch holds "raw_images" or "images", "entity_features" and, for the
        knowledge and news presets, "fact_features" (B, F, 3)."""
        mode, key = next(((m, k) for m, k in _MODES if k in batch), (None, None))
        if mode is None:
            raise NotImplementedError(
                f"batch keys {sorted(batch)}: only raw_images / images are ported")
        cfg, wm = self.cfg, self.wordmap
        with torch.inference_mode():
            inputs = torch.as_tensor(batch[key], device=self.device)
            ents = torch.as_tensor(batch["entity_features"], device=self.device)
            facts = batch.get("fact_features")
            if facts is not None:
                facts = torch.as_tensor(facts, device=self.device)
            num_entity_rows = ents.shape[1]
            tokens = self._encode_tokens(inputs, mode)
            ctx = greedy_lib.prepare_decode_context(
                self.params, cfg.model, tokens, ents, facts,
                compute_dtype=self.compute_dtype)
            if self.beam_size <= 1:
                out = greedy_lib.greedy_decode(
                    self.params, cfg.model, len(wm), num_entity_rows,
                    wm.start_id, wm.end_id, wm.pad_id, ctx,
                    cfg.decode.max_caption_len, compute_dtype=self.compute_dtype,
                    use_fused_scores=cfg.decode.use_fused_scores,
                )
            else:
                out, _ = beam_lib.beam_decode(
                    self.params, cfg.model, len(wm), num_entity_rows,
                    wm.start_id, wm.end_id, wm.pad_id, ctx,
                    cfg.decode.max_caption_len, beam_size=self.beam_size,
                    compute_dtype=self.compute_dtype,
                    use_fused_scores=cfg.decode.use_fused_scores,
                    use_megakernel=cfg.decode.use_megakernel,
                )
        return out.cpu().numpy()
