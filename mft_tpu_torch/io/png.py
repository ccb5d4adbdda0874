"""PNG encode/decode in numpy, ``zlib`` and ``struct``: the part of
``cv2.imencode``/``cv2.imdecode`` that the flowou codecs use, for a machine
without OpenCV.

Arrays follow OpenCV's convention, so a file written here decodes through
cv2 to the same array and the reverse:

- (H, W) or (H, W, 1) is grey, (H, W, 3) BGR and (H, W, 4) BGRA: the file
  stores the samples as RGB(A), channels 2, 1, 0 (, 3) of the array;
- uint8 gives 8-bit samples, uint16 16-bit ones (big-endian in the file).

:func:`encode_png` writes one IDAT chunk, every row with the Up filter,
and optional ``tEXt`` chunks after IHDR. :func:`decode_png` reads every
kind of PNG that libpng expands for OpenCV: grey at 1, 2, 4, 8 and 16 bits
(1-, 2- and 4-bit samples scaled to 0..255, as
``png_set_expand_gray_1_2_4_to_8``), RGB, RGBA and grey+alpha at 8 and 16
bits, palettes at 1, 2, 4 and 8 bits (PLTE, with tRNS giving an alpha
channel, as ``cv2.imdecode(..., IMREAD_UNCHANGED)`` returns it; so does a
tRNS colour of an RGB file), non-interlaced or Adam7-interlaced (each pass
unfiltered on its own); all five row filters (None, Sub, Up, Average,
Paeth; rows with Average or Paeth are undone along anti-diagonals, whose
pixels do not depend on each other), any number of IDAT chunks; it checks
every chunk's CRC and raises ``ValueError`` for a file it cannot decode. :func:`read_text` returns the ``tEXt`` chunks.
:func:`to_bgr` gives what ``cv2.imread(path)`` (``IMREAD_COLOR``) gives of
a decoded PNG; :func:`imread` reads any image file through
:mod:`mft_tpu_torch.io.image`.
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}          # channels -> PNG colour type
_BGR = {1: [0], 3: [2, 1, 0], 4: [2, 1, 0, 3]}   # array <-> file channel order


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, texts: dict = None, level: int = 1) -> bytes:
    """PNG bytes of a uint8/uint16 (H, W), (H, W, 1), (H, W, 3) BGR or
    (H, W, 4) BGRA array; ``texts`` {keyword: value} become ``tEXt`` chunks
    (latin-1); ``level`` is zlib's (1, OpenCV's default: the fastest)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples must be uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPES or 0 in img.shape[:2]:
        raise ValueError(f"cannot write a {img.shape} array as PNG")
    H, W, C = img.shape
    samples = img[..., _BGR[C]]
    if img.dtype == np.uint16:
        samples = samples.astype(">u2")
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(H, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]                    # the Up filter, modulo 256
    raw = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    depth = 16 if img.dtype == np.uint16 else 8
    out = [SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, _COLOR_TYPES[C], 0, 0, 0))]
    for key, value in (texts or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\x00"
                          + str(value).encode("latin-1")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _chunks(buf: bytes):
    """(kind, data) of every chunk up to IEND, CRCs checked."""
    buf = bytes(buf)
    if buf[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(buf):
            raise ValueError("truncated PNG file")
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(buf):
            raise ValueError("truncated PNG file")
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length


def read_text(buf: bytes) -> dict:
    """{keyword: text} of the file's ``tEXt`` chunks (latin-1)."""
    texts = {}
    for kind, data in _chunks(buf):
        if kind == b"tEXt":
            key, _, value = data.partition(b"\x00")
            texts[key.decode("latin-1")] = value.decode("latin-1")
    return texts


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt, raw, H, W, bpp):
    """(H, W*bpp) uint8 reconstructed bytes from filtered rows ``raw``
    (H, W*bpp) with filter types ``filt`` (H,)."""
    if np.any(filt > 4):
        raise ValueError(f"unknown PNG row filter {int(filt.max())}")
    raw = raw.reshape(H, W, bpp)
    if not np.any(filt >= 3):
        # None, Sub and Up only: a row at a time, each vectorised
        out = np.zeros((H, W, bpp), np.uint8)
        prev = np.zeros((W, bpp), np.uint8)
        for y in range(H):
            row = raw[y]
            if filt[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif filt[y] == 2:
                row = row + prev
            out[y] = prev = row
        return out.reshape(H, W * bpp)
    # Average or Paeth rows: byte (y, x) depends on (y, x-1), (y-1, x) and
    # (y-1, x-1), so each anti-diagonal y + x = d is one vectorised step
    out = np.zeros((H + 1, W + 1, bpp), np.int32)   # a zero row and column before
    raw = raw.astype(np.int32)
    filt = filt.astype(np.int32)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        f = filt[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[y + 1, x + 1] = (raw[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(H, W * bpp)


# colour type -> samples a pixel and the bit depths the PNG spec allows
_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack(rows, depth, n):
    """(h, rowbytes) unfiltered uint8 rows -> (h, n) samples: uint16 for
    16-bit depth, else uint8 (1/2/4-bit samples unpacked most significant
    first, unscaled)."""
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16)
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(rows.shape[0], -1)[:, :n].astype(np.uint8)


def decode_png(buf) -> np.ndarray:
    """The array of PNG bytes ``buf``, as ``cv2.imdecode(buf,
    IMREAD_UNCHANGED)`` gives it: (H, W) grey, (H, W, 3) BGR or (H, W, 4)
    BGRA (RGBA and grey+alpha files, and palette or RGB files with a tRNS
    chunk), uint8 or uint16 (16-bit files)."""
    header, idat, plte, trns = None, [], None, None
    for kind, data in _chunks(np.asarray(buf, np.uint8).tobytes()
                              if isinstance(buf, np.ndarray) else buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"PLTE":
            plte = data
        elif kind == b"tRNS":
            trns = data
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    W, H, depth, ctype, comp, filt_method, interlace = header
    if (ctype not in _KINDS or depth not in _KINDS[ctype][1] or comp or filt_method
            or interlace > 1 or W == 0 or H == 0):
        raise ValueError(f"unsupported PNG: colour type {ctype}, depth {depth}, "
                         f"interlace {interlace}")
    if ctype == 3 and (plte is None or not plte or len(plte) % 3 or len(plte) > 768):
        raise ValueError("corrupt PNG: a palette file without a valid PLTE chunk")
    spp = _KINDS[ctype][0]
    bits = spp * depth
    bpp = max(1, bits // 8)
    try:
        data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((H, W, spp), dtype)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                       # an empty pass holds no bytes
        rowbytes = -(-pw * bits // 8)
        size = ph * (1 + rowbytes)
        if pos + size > data.size:
            raise ValueError(f"PNG image data holds {data.size} bytes, fewer than "
                             "its size needs")
        rows = data[pos:pos + size].reshape(ph, 1 + rowbytes)
        pos += size
        raw = _unfilter(rows[:, 0], rows[:, 1:], ph, rowbytes // bpp, bpp)
        img[y0::dy, x0::dx] = _unpack(raw, depth, pw * spp).reshape(ph, pw, spp)
    if pos != data.size:
        raise ValueError(f"PNG image data holds {data.size} bytes, expected {pos}")
    if ctype == 0:
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(img[..., 0])
    if ctype == 4:                         # grey + alpha -> BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)  # indices past the palette: black
        pal[:, 3] = 255
        pal[:len(plte) // 3, :3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if trns:
            pal[:len(trns), 3] = np.frombuffer(trns[:256], np.uint8)
        out = pal[img[..., 0]]
        return np.ascontiguousarray(out[..., [2, 1, 0, 3]] if trns else out[..., [2, 1, 0]])
    img = img[..., _BGR[spp]]
    if ctype == 2 and trns is not None and len(trns) == 6:
        key = np.array(struct.unpack(">HHH", trns), np.int64)[[2, 1, 0]]
        opaque = np.any(img.astype(np.int64) != key, axis=-1)
        alpha = np.where(opaque, np.iinfo(dtype).max, 0).astype(dtype)
        img = np.concatenate([img, alpha[..., None]], axis=-1)
    return np.ascontiguousarray(img)


def to_bgr(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR of a decoded array, as ``cv2.imread(path,
    IMREAD_COLOR)`` converts it: grey replicated, alpha dropped, 16-bit
    samples >> 8."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread(path, device="cuda"):
    """(H, W, 3) uint8 BGR of an image file, as ``cv2.imread(path)`` reads
    it: :func:`mft_tpu_torch.io.image.imread` (PNG, JPEG, PPM; ``device``
    decodes a JPEG)."""
    from mft_tpu_torch.io.image import imread as _imread
    return _imread(path, device)
