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
``dumps`` and ``write_variables`` write that subset: maps with str keys,
str, int, float, bool, None, bytes, lists and ndarrays as ext type 1, as
``flax.serialization.to_bytes`` does, so that flax's ``msgpack_restore`` and
the reader here read them.
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


def _pack_len(out: bytearray, n: int, fix: int, fixmax: int, codes):
    """A length header: the fix form up to ``fixmax``, else 8/16/32-bit."""
    if fix is not None and n <= fixmax:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries is too large")


def _pack(out: bytearray, v):
    if v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, (int, np.integer)):
        # the smallest form, as the msgpack package writes an int
        v = int(v)
        if 0 <= v <= 0x7F or -32 <= v < 0:
            out += struct.pack(">b" if v < 0 else ">B", v)
        elif 0 <= v < 1 << 64:
            for code, fmt, top in ((0xCC, ">B", 8), (0xCD, ">H", 16), (0xCE, ">I", 32),
                                   (0xCF, ">Q", 64)):
                if v < 1 << top:
                    out += bytes([code]) + struct.pack(fmt, v)
                    break
        elif -(1 << 63) <= v < 0:
            for code, fmt, top in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31),
                                   (0xD3, ">q", 63)):
                if v >= -(1 << top):
                    out += bytes([code]) + struct.pack(fmt, v)
                    break
        else:
            raise ValueError(f"integer {v} does not fit msgpack")
    elif isinstance(v, (float, np.floating)):
        out += b"\xcb" + struct.pack(">d", float(v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _pack_len(out, len(b), None, -1, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in v.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject or v.nbytes >= 1 << 30:
            raise ValueError(f"ndarray of dtype {v.dtype} and {v.nbytes} bytes is not written")
        payload = dumps([list(v.shape), v.dtype.name, np.ascontiguousarray(v).tobytes()])
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out += bytes([0xD4 + n.bit_length() - 1, EXT_NDARRAY])
        else:
            _pack_len(out, n, None, -1, (0xC7, 0xC8, 0xC9))
            out.append(EXT_NDARRAY)
        out += payload
    else:
        raise ValueError(f"{type(v).__name__} is not written as msgpack")


def dumps(obj) -> bytes:
    """msgpack bytes of ``obj`` (the subset of the module docstring)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def write_variables(path, tree):
    """Write a variables tree (nested dicts of numpy arrays) as flax's
    ``to_bytes`` does."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(dumps(tree))
