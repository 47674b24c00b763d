"""Image normalization (port of ``icek_tpu/data/images.py``): on the
device, and on the host for loaders that hand the model normalized images.

The stored rows are the reference's HDF5 float16 CHW images in [0, 1];
loading divides by 255 AGAIN (a reference quirk kept for checkpoint
parity, geo-aware/datasets.py:44) and applies ImageNet mean/std.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_for_model(stored: np.ndarray) -> np.ndarray:
    """Stored float16 CHW [0, 1] rows -> model-ready NHWC float32 on the host
    (the double /255, then ImageNet mean/std)."""
    x = stored.astype(np.float32) / 255.0
    x = x.transpose(1, 2, 0) if x.ndim == 3 else x.transpose(0, 2, 3, 1)
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def normalize_in_graph(stored: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) stored f16 rows -> (B, H, W, 3) normalized f32.

    Returns the NHWC shape of the JAX function as a permuted view of the
    NCHW result, so the encoder's ``permute(0, 3, 1, 2)`` gets back a
    channels-last NCHW tensor with no copy.
    """
    x = stored.to(torch.float32) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return ((x - mean) / std).permute(0, 2, 3, 1)
