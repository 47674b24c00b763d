"""Image reading, resizing and normalization (port of
``icek_tpu/data/images.py``).

  * prep (the host): read -> gray->RGB -> skimage-style anti-aliased
    bilinear resize to 256x256 float in [0, 1] -> CHW float16 rows for the
    HDF5 store (geo-aware/create_input_files.py:321-338).
    ``resize_like_reference`` reproduces skimage.transform.resize's
    defaults with scipy.ndimage (img_as_float, a Gaussian prefilter of
    sigma max(0, (f - 1) / 2) on downscaled axes, order-1 zoom on the
    pixel-area grid, mode 'mirror', clipped to the input range); the C++
    resizer of ``native`` gives the same bits; PIL bilinear where scipy is
    missing.  PIL and scipy are imported where used.
  * load: the stored rows divided by 255 AGAIN (a reference quirk kept for
    checkpoint parity, geo-aware/datasets.py:44) and ImageNet mean/std, on
    the device (``normalize_in_graph``) or on the host.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _have_scipy() -> bool:
    try:
        import scipy.ndimage  # noqa: F401

        return True
    except ImportError:  # pragma: no cover - scipy is in the image
        return False


def resize_like_reference(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """skimage.transform.resize(img, (out_h, out_w)) with default args,
    reproduced with scipy.ndimage (geo-aware/create_input_files.py:332).

    `img` is HWC (or HW) uint8 or float; returns float64 in the input's
    value range scaled by img_as_float semantics (uint8 -> /255).
    """
    import scipy.ndimage as ndi

    x = img.astype(np.float64)
    if img.dtype == np.uint8:
        x = x / 255.0
    factors = [x.shape[0] / out_h, x.shape[1] / out_w] + [1.0] * (x.ndim - 2)
    # anti_aliasing defaults to True iff any axis is downscaled
    if any(f > 1 for f in factors):
        sigma = [max(0.0, (f - 1) / 2) for f in factors]
        filtered = ndi.gaussian_filter(x, sigma, mode="mirror")
    else:
        filtered = x
    out = ndi.zoom(
        filtered, [1.0 / f for f in factors], order=1, mode="mirror",
        grid_mode=True,
    )
    # resize(clip=True): clamp to the input's own value range
    return np.clip(out, x.min(), x.max())


def _resize_pil(img: np.ndarray, size: int) -> np.ndarray:
    """Fallback (round-1 path): PIL bilinear with built-in antialias."""
    from PIL import Image

    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    with Image.fromarray(img) as im:
        im = im.convert("RGB")
        im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.float32) / 255.0


def _use_native_resize() -> bool:
    import os

    if os.environ.get("ICEK_NATIVE_RESIZE", "1") == "0":
        return False
    from icek_torch import native

    return native.resize_available()


def _prepare(img: np.ndarray, size: int) -> np.ndarray:
    """HWC array -> (3, size, size) float16 in [0, 1], the reference's
    stored-HDF5 numeric contract."""
    if img.ndim == 2:
        # gray -> RGB by channel stacking (create_input_files.py:329-333)
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:  # RGBA: drop alpha (reference would assert-fail)
        img = img[..., :3]
    if img.dtype == np.uint8 and img.shape[0] >= 2 and img.shape[1] >= 2 \
            and _use_native_resize():
        # C++ fused /255 -> resize -> clip -> CHW -> f16 (native/resize.cpp),
        # bit-identical to the scipy path below (tests/test_torch_prep.py).
        from icek_torch import native

        return native.resize_chw_f16(img, size, size)
    if _have_scipy():
        arr = resize_like_reference(img, size, size)
    else:  # pragma: no cover - scipy is in the image
        arr = _resize_pil(img, size)
    return arr.transpose(2, 0, 1).astype(np.float16)


def read_and_resize(path: str, size: int = 256) -> np.ndarray:
    """Read an image file -> (3, size, size) float16 in [0, 1] (CHW)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode not in ("RGB", "L"):
            im = im.convert("RGB")
        arr = np.asarray(im)
    return _prepare(arr, size)


def prepare_array(img: np.ndarray, size: int = 256) -> np.ndarray:
    """Same as read_and_resize but from an in-memory HWC uint8/float array."""
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return _prepare(img, size)



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
