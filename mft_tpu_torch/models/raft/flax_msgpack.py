"""Read the weights files that ``flax.serialization.to_bytes`` writes.

A pure-Python reader (numpy only, no ``msgpack``) for the subset of
msgpack that flax's serializer produces for a variables tree:

- maps with str keys, nested (``{'params': {...}, 'batch_stats': {...}}``);
- ext type 1, an ndarray, whose payload is itself msgpack: the triple
  (shape, dtype name, C-order bytes) (flax ``_ndarray_to_bytes``);
- the msgpack scalar (nil, bool, int, float), str, bin and array forms.

Anything else raises ``ValueError``: another ext code (flax's complex or
numpy-scalar leaves), a map key that is not a str, a reserved byte, a
truncated stream, trailing bytes, and flax's chunked-array dict (arrays
over 2**30 bytes, which no RAFT weight reaches).

``read_variables(path)`` returns the tree as nested dicts of numpy arrays,
the input of :func:`mft_tpu_torch.models.raft.convert.params_from_flax`.
"""

import struct
from pathlib import Path

import numpy as np

EXT_NDARRAY = 1
CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    """Cursor over one msgpack byte string."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack stream: need {n} bytes at offset "
                             f"{self.pos}, {len(self.data) - self.pos} left")
        out = self.data[self.pos:end]
        self.pos = end
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
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:                                  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:                                  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:                                  # fixext 1..16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:                                  # str 8/16/32
            return self.str(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):                                  # array 16/32
            return self.array(self.unpack(sizes[b - 0xDC + 1]))
        if b in (0xDE, 0xDF):                                  # map 16/32
            return self.map(self.unpack(sizes[b - 0xDE + 1]))
        raise ValueError(f"msgpack byte 0x{b:02x} at offset {self.pos - 1} is reserved")

    def str(self, n: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str is not UTF-8: {e}") from None

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, str):
                raise ValueError(f"msgpack map key {key!r} is not a str")
            out[key] = self.value()
        if CHUNKED_KEY in out:
            raise ValueError("flax chunked arrays (leaves over 2**30 bytes) are not read")
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext code {code} is not read (only {EXT_NDARRAY}, "
                             "an ndarray)")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> np.ndarray:
    """flax ``_ndarray_from_bytes``: the msgpack triple (shape, dtype name,
    C-order bytes) -> a read-only numpy array."""
    triple = loads(payload)
    if not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError("ndarray ext payload is not a (shape, dtype, bytes) triple")
    shape, name, buf = triple
    if (not isinstance(shape, list) or not all(isinstance(s, int) and s >= 0 for s in shape)
            or not isinstance(name, str) or not isinstance(buf, bytes)):
        raise ValueError(f"malformed ndarray ext payload: shape {shape!r}, dtype {name!r}")
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"ndarray dtype {name!r} is not a numpy dtype") from None
    if dtype.hasobject or len(buf) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise ValueError(f"ndarray of shape {shape} and dtype {name} does not match its "
                         f"{len(buf)} bytes")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def loads(data: bytes):
    """One msgpack object from ``data``, which must hold exactly it."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the "
                         "msgpack object")
    return out


def read_variables(path) -> dict:
    """The variables tree of a flax msgpack file: nested dicts of numpy
    arrays. Raises ValueError if the file does not decode to a map."""
    tree = loads(Path(path).read_bytes())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: the top-level msgpack object is not a map")
    return tree
