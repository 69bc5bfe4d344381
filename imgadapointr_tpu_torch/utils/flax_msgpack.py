"""A reader of the msgpack payload that ``flax.serialization.to_bytes`` writes.

The JAX package saves a train state as one such payload (a ``.ckpt`` file,
``imgadapointr_tpu/utils/checkpoint.py``). This module decodes it with the
standard library and numpy, so the port reads JAX checkpoints on a machine
without ``msgpack`` or ``flax``. It decodes the subset of msgpack that
flax writes:

- nil, bool, int, float, str, bin, array (as a list) and map (as a dict);
- ext type 1, an ndarray: an inner msgpack ``(shape, dtype name, C-order
  bytes)``. A ``bfloat16`` array, which numpy cannot name, is widened to
  float32, which is exact (its bits are the upper half of the float32's);
- ext type 3, a numpy scalar, written as a 0-d ndarray;
- flax's chunked arrays (a map with ``__msgpack_chunked_array__``, which
  flax writes for an array over its ``MAX_CHUNK_SIZE`` bytes), joined back.

Ext type 2 (a native complex number) and any other type raise. The result
is what ``flax.serialization.msgpack_restore`` returns: nested dicts of
numpy arrays, with tuples and lists as flax's ``to_state_dict`` writes them
(keys ``"0"``, ``"1"``, ...).
"""

from __future__ import annotations

import struct

import numpy as np

CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def _bfloat16_as_float32(buf) -> np.ndarray:
    bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32)


class _Decoder:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack payload ends inside a value")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

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
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                  0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}.get(b)
        if scalar:
            return self.unpack(scalar)
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one flax writes")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == EXT_COMPLEX:
            raise ValueError("a native complex number (msgpack ext type 2) is not read here")
        raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _ndarray(data) -> np.ndarray:
    """An ndarray from flax's inner ``(shape, dtype name, C-order bytes)``."""
    inner = _Decoder(data)
    shape, name, buf = inner.value()
    if inner.pos != len(data):
        raise ValueError("trailing bytes after an ndarray")
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = _bfloat16_as_float32(buf)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    return arr.reshape(shape)


def _unchunk(tree):
    """Join flax's chunked arrays back (``flax.serialization._unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED_KEY in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = tree["chunks"]
        return np.concatenate([chunks[str(i)] for i in range(len(chunks))]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree of a flax msgpack payload, as ``flax.serialization.msgpack_restore`` gives it."""
    dec = _Decoder(data)
    tree = dec.value()
    if dec.pos != len(dec.buf):
        raise ValueError(f"{len(dec.buf) - dec.pos} trailing bytes after the msgpack payload")
    return _unchunk(tree)


def read(path: str):
    """:func:`msgpack_restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
