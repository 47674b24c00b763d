"""A reader of flax's msgpack checkpoints, in plain Python (``struct``).

JAX checkpoints (``icek_tpu/train/checkpoint.py``) are
``flax.serialization.msgpack_serialize`` payloads.  This module decodes them
into what ``flax.serialization.msgpack_restore`` returns, without msgpack or
flax:

  * maps, arrays (as lists), str, bin, ints, floats, bool and nil;
  * flax's ext type 1 (an ndarray: a packed ``(shape, dtype name, bytes)``)
    as a numpy array, and ext type 3 (a numpy scalar) as a numpy scalar;
    ``bfloat16`` leaves, which numpy has no type for, as ``torch.bfloat16``
    tensors (the bytes read through an int16 view);
  * flax's chunked form of arrays over ``MAX_CHUNK_SIZE``
    (``{"__msgpack_chunked_array__": True, "shape", "chunks"}``), joined
    back into one array.

Anything else (another ext type, a non-string map key, trailing bytes)
raises ``ValueError``.  There is no writer: the port writes its own format
(``train/checkpoint.py``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw          # str as bytes (flax's nested ndarray tuples)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: map key of type {type(key).__name__}")
            out[key] = self.value()
        return out

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        handler = _TAGGED.get(b)
        if handler is None:
            raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")
        return handler(self)


_TAGGED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_(r.unpack(">B")),
    0xDA: lambda r: r.str_(r.unpack(">H")),
    0xDB: lambda r: r.str_(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def _ndarray(data):
    """flax's ndarray ext payload: msgpack of (shape, dtype name, C bytes)."""
    r = _Reader(data, raw=True)
    tpl = r.value()
    if r.pos != len(r.buf) or not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("msgpack: malformed ndarray payload")
    shape, name, buffer = tpl
    shape = tuple(int(d) for d in shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name.decode("ascii"))
    except TypeError as exc:
        raise ValueError(f"msgpack: unknown dtype {name!r}") from exc
    if dtype.hasobject:
        raise ValueError(f"msgpack: object dtype {name!r}")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _unchunk(d):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and torch.is_tensor(chunks[0]):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts anywhere under
    dicts become arrays again."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def restore(data: bytes):
    """Decode a flax ``msgpack_serialize`` payload (see the module doc)."""
    r = _Reader(data, raw=False)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return _unchunk_leaves(out)


def read(path: str):
    with open(path, "rb") as f:
        return restore(f.read())
