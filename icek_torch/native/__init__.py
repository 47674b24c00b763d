"""Native (C++) helpers for the host-side data pipeline (port of
``icek_tpu/native``, with its own copies of the two sources).

Builds ``fuzzy_match.cpp`` / ``resize.cpp`` into shared libraries under
``icek_torch/_build/`` on first use (g++ -O3) and exposes them through
ctypes.  Where no compiler is available the callers take the pure-Python
implementations, as in JAX: the native paths are host throughput
optimizations with the same results (tests/test_torch_prep.py holds them
to the Python paths), not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_D = ctypes.POINTER(ctypes.c_double)


def _compile(src: str, lib: str, extra: Sequence[str] = ()) -> Optional[str]:
    # compile to a per-pid temp path then atomically rename: concurrent
    # builders (e.g. forked prep workers racing on a cold cache) each get a
    # complete library instead of a torn write.
    tmp = f"{lib}.{os.getpid()}.tmp"
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *extra, src,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib)
        return lib
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None


def _fresh(lib: str, src: str) -> bool:
    """lib exists and is newer than its source."""
    try:
        return os.path.getmtime(lib) >= os.path.getmtime(src)
    except OSError:
        return False


class _Loader:
    """Memoized build-or-load singleton for one shared library.

    ``flag_sets`` are tried in order (e.g. with and without -march=native);
    ``bind`` declares the ctypes signatures once the library is open.
    """

    def __init__(self, src: str, lib: str, flag_sets: Sequence[Sequence[str]],
                 bind: Callable[[ctypes.CDLL], None]):
        self._src = os.path.join(_HERE, src)
        self._lib_path = os.path.join(_BUILD, lib)
        self._flag_sets = flag_sets
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False

    def load(self) -> Optional[ctypes.CDLL]:
        if self._lib is not None or self._failed:
            return self._lib
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            path = self._lib_path if _fresh(self._lib_path, self._src) else None
            for flags in self._flag_sets if path is None else ():
                path = _compile(self._src, self._lib_path, flags)
                if path is not None:
                    break
            if path is None:
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(path)
                self._bind(lib)
            except OSError:
                self._failed = True
                return None
            self._lib = lib
            return self._lib


def _bind_fuzzy(lib: ctypes.CDLL) -> None:
    lib.icek_fuzzy_lookup.restype = ctypes.c_int64
    lib.icek_fuzzy_lookup.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.icek_fuzzy_lookup_batch.restype = None
    lib.icek_fuzzy_lookup_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]


def _bind_resize(lib: ctypes.CDLL) -> None:
    lib.icek_resize_chw_f16.restype = ctypes.c_int
    lib.icek_resize_chw_f16.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _D, ctypes.c_int64,
        _D, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint16),
    ]


_fuzzy_loader = _Loader("fuzzy_match.cpp", "_fuzzy_match.so",
                        [()], _bind_fuzzy)
# -ffp-contract=off: FMA contraction would change the float64 bits vs
# scipy.  -march=native only vectorizes ACROSS output elements (each lane
# keeps the scalar op order), so it is bit-safe — and tests/test_torch_prep.py
# would catch any drift.  Falls back to plain -ffp-contract=off where
# -march=native is unsupported.
_resize_loader = _Loader(
    "resize.cpp", "_resize.so",
    [["-ffp-contract=off", "-march=native"], ["-ffp-contract=off"]],
    _bind_resize,
)


def load() -> Optional[ctypes.CDLL]:
    """The fuzzy-match shared library, building it if needed; None if
    unavailable."""
    return _fuzzy_loader.load()


def load_resize() -> Optional[ctypes.CDLL]:
    """The resize shared library, building it if needed; None if unavailable."""
    return _resize_loader.load()


def available() -> bool:
    return load() is not None


def resize_available() -> bool:
    return load_resize() is not None


def fuzzy_lookup(
    query: Sequence[int],
    keys: np.ndarray,                      # (n_keys, 50) int32
    allowed: Optional[np.ndarray] = None,  # (n_keys,) uint8
    pad: int = 124,
) -> int:
    """Longest fuzzy match row or -1 (native path)."""
    lib = load()
    if lib is None:
        raise RuntimeError(
            "native fuzzy-match library unavailable (no g++?); check "
            "available() and use the pure-Python path instead"
        )
    q = np.ascontiguousarray(query, dtype=np.int32)
    k = np.ascontiguousarray(keys, dtype=np.int32)
    a_ptr = None
    if allowed is not None:
        allowed = np.ascontiguousarray(allowed, dtype=np.uint8)
        a_ptr = allowed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return int(
        lib.icek_fuzzy_lookup(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            a_ptr,
            len(k),
            pad,
        )
    )


# ---------------------------------------------------------------------------
# Native skimage-parity resize (resize.cpp) — the prep pipeline's hot host
# stage.  Bit-identical float16 output vs the scipy path in data/images.py
# (tests/test_torch_prep.py); kernels precomputed by the caller with numpy so
# numpy's pairwise-sum normalization is reproduced by construction.


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """scipy.ndimage's _gaussian_kernel1d (order 0): radius
    int(4*sigma + 0.5), normalized with numpy's own sum so the weights are
    bit-identical to what gaussian_filter uses."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return phi / phi.sum()


def resize_chw_f16(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (C, out_h, out_w) float16, the fused
    /255 -> skimage-parity resize -> clip -> CHW -> f16 prep chain.

    Bit-identical to images.resize_like_reference + transpose + astype
    (enforced by tests/test_torch_prep.py).  Caller must ensure the library is
    available (resize_available()).
    """
    lib = load_resize()
    if lib is None:
        raise RuntimeError(
            "native resize library unavailable (no g++?); check "
            "resize_available() and use images.resize_like_reference instead"
        )
    if img.dtype != np.uint8 or img.ndim != 3:
        # a real check, not an assert: the C side reads the buffer as raw
        # uint8 bytes — a float input would silently produce garbage f16s
        raise TypeError(
            f"resize_chw_f16 wants (H, W, C) uint8; got {img.dtype} "
            f"{img.shape}"
        )
    img = np.ascontiguousarray(img)
    h, w, ch = img.shape
    # anti_aliasing iff any axis downscales; then sigma per axis, and axes
    # with sigma <= 1e-15 are skipped (gaussian_filter's own skip rule).
    fy, fx = h / out_h, w / out_w
    kernels = []
    for f in (fy, fx):
        sigma = max(0.0, (f - 1) / 2) if (fy > 1 or fx > 1) else 0.0
        kernels.append(_gaussian_kernel(sigma) if sigma > 1e-15 else None)
    ky, kx = kernels
    lo = float(img.min()) / 255.0
    hi = float(img.max()) / 255.0
    out = np.empty((ch, out_h, out_w), dtype=np.float16)

    def _kp(k):
        if k is None:
            return None, None, -1
        k = np.ascontiguousarray(k, dtype=np.float64)
        # keep the array alive alongside the raw pointer
        return k, k.ctypes.data_as(_D), len(k) // 2

    ky_arr, kyp, ry = _kp(ky)
    kx_arr, kxp, rx = _kp(kx)
    rc = lib.icek_resize_chw_f16(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, ch, kyp, ry, kxp, rx, out_h, out_w, lo, hi,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    if rc != 0:
        raise RuntimeError(f"icek_resize_chw_f16 failed with code {rc}")
    return out
