"""Build the CUDA kernels under ``icek_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with nvcc
into its own shared library, loaded with ctypes.  Nothing here runs at
import: the first wrapper call that needs a library builds it (or
``build_all`` builds every source at once, one nvcc process per source,
all started together).  Libraries are keyed by a hash of their source and
flags, written to ``icek_torch/_build/`` (git-ignored) under a temporary
name and renamed into place, so a concurrent build never sees a partial
file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_attention", "score_topk", "decoder_step", "fused_norm", "int8_conv")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# (library, entry point) -> the bound function, read without the lock (a
# dict lookup is atomic under the GIL): a wrapper's call costs one lookup
_bound: Dict[tuple, "ctypes._CFuncPtr"] = {}
# the current stream's handle without building a torch.cuda.Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# nvcc's -Xptxas -v report per library (registers, shared memory, spills)
ptxas_reports: Dict[str, str] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    common = os.path.join(CSRC, "common.cuh")
    if os.path.exists(common):
        with open(common, "rb") as f:
            src += f.read()
    digest = hashlib.sha256(
        src + " ".join(ARCH_FLAGS + FLAGS).encode()
    ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, *FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp: Optional[str], proc) -> None:
    if proc is None:
        ptxas_reports.setdefault(name, "(cached build)")
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    ptxas_reports[name] = log


def build_all(names: List[str] = SOURCES) -> Dict[str, str]:
    """Compile every kernel source in parallel; returns the ptxas reports."""
    with _lock:
        started = {n: _start(n) for n in names}
        failures = []
        for n, (out, tmp, proc) in started.items():
            try:
                _finish(n, out, tmp, proc)
            except RuntimeError as e:   # wait for every nvcc, then report all
                failures.append(str(e))
        if failures:
            raise RuntimeError("\n".join(failures))
    return {n: ptxas_reports.get(n, "") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, tmp, proc = _start(name)
            _finish(name, out, tmp, proc)
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, argtypes) -> "ctypes._CFuncPtr":
    """C entry point ``fn`` of library ``name`` with its argtypes set
    (pointers and the stream as c_void_p, so none is cut to 32 bits),
    resolved once and then taken from a cache."""
    f = _bound.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _bound[(name, fn)] = f
    return f


def use_variant(name: str, path: str) -> None:
    """Serve library ``name`` from the variant build at ``path`` for the rest
    of this process.  One build of a source a process: with two loaded,
    launches ran the last-loaded build's kernels whichever was asked."""
    with _lock:
        if name in _libs:
            raise RuntimeError(f"{name} is already loaded in this process")
        _libs[name] = ctypes.CDLL(path)


def check(err: int, name: str, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        f = load(name).icek_error_string
        f.argtypes, f.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({f(err).decode()})")


def stream_of(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors, dtype=None) -> None:
    """Checks shared by the wrappers: every tensor on one CUDA device, of
    ``dtype`` when given."""
    dev = tensors[0].get_device()        # -1 on the CPU
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{what}: all tensors must be on one CUDA device")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
