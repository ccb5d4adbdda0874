"""ISO-BMFF (MP4/QuickTime) files: the first video track's samples and one
``mp4v`` track written.

The JAX package opens video files with ``cv2.VideoCapture`` and writes them
with ``cv2.VideoWriter`` (fourcc ``mp4v``, ``mft_tpu/io/video.py``), i.e.
libavformat's demuxer and muxer. This module is the port's own:

- :func:`read_mp4` walks the boxes (``moov`` before or after ``mdat``),
  takes the first track whose handler is ``vide`` and builds its sample
  table from ``stsd``/``stts``/``stss``/``stsc``/``stsz``/``stco``/``co64``:
  (offset, size, sync) per sample, the frame rate from ``mdhd`` and
  ``stts``. Samples before an edit list's media time are dropped from the
  output, as libavformat drops them. The codec comes from the sample entry
  and, for ``mp4v``, from its ``esds`` objectTypeIndication as libavformat
  reads it: 0x20 is MPEG-4 Part 2 (the decoder-specific info holds the
  VOS/VOL), 0x6C is JPEG (cv2 writes Motion JPEG into ``.mp4`` so);
  ``jpeg`` and ``mjpa`` (QuickTime Motion-JPEG A) entries are Motion JPEG.
  Another sample entry or object type (``avc1``, ``mjpb``, ...) raises
  ``NotImplementedError`` naming its ROADMAP item.
- :class:`Mp4Writer` writes ``ftyp``, ``mdat``, then ``moov`` with one
  ``mp4v`` track, a sync-sample table of its I-VOPs, and ``co64`` chunk
  offsets once an offset passes 2**32; the ``ftyp`` brands and, for
  ``.mov``, the QuickTime boxes and fields are those libavformat writes for
  the path's suffix (:data:`BRANDS`).
"""

import struct
from fractions import Fraction
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.container import (MJPEG, MPEG4, ROADMAP_CODECS, ROADMAP_H264,
                                        VideoTrack, unsupported_codec)

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}
CODEC_ITEMS = {"avc1": ROADMAP_H264, "avc3": ROADMAP_H264}
MJPEG_ENTRIES = {"jpeg", "mjpa"}
OBJECT_TYPES = {0x20: MPEG4, 0x6C: MJPEG}       # esds objectTypeIndication
# ftyp (major brand, minor version, compatible brands) by suffix, as
# libavformat's mov muxer writes them
BRANDS = {".mp4": (b"isom", 512, b"isomiso2mp41"), ".m4v": (b"M4V ", 512, b"M4V isomiso2"),
          ".3gp": (b"3gp4", 512, b"3gp4isomiso2"), ".mov": (b"qt  ", 512, b"qt  ")}


def _boxes(f, start, end):
    """(type, payload offset, payload end) of the boxes in [start, end)."""
    off = start
    while off + 8 <= end:
        f.seek(off)
        size, typ = struct.unpack(">I4s", f.read(8))
        head = 8
        if size == 1:
            size = struct.unpack(">Q", f.read(8))[0]
            head = 16
        elif size == 0:
            size = end - off
        if size < head:
            raise ValueError(f"corrupt MP4: box {typ!r} of {size} bytes at {off}")
        yield typ, off + head, min(off + size, end)
        off += size


def _descriptor(buf, pos):
    """(tag, payload start, payload end) of an MPEG-4 descriptor at ``pos``."""
    tag = buf[pos]
    pos += 1
    n = 0
    for _ in range(4):
        b = buf[pos]
        pos += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + n


def _esds_config(esds: bytes):
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` payload
    (after version/flags)."""
    tag, p, end = _descriptor(esds, 4)
    if tag != 3:
        raise ValueError("corrupt MP4: esds without an ES descriptor")
    flags = esds[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + esds[p]
    if flags & 0x20:
        p += 2
    tag, p, end = _descriptor(esds, p)
    if tag != 4:
        raise ValueError("corrupt MP4: esds without a decoder config")
    oti = esds[p]
    p += 13
    while p < end:
        tag, q, qend = _descriptor(esds, p)
        if tag == 5:
            return oti, bytes(esds[q:qend])
        p = qend
    return oti, b""


class Mp4Video(VideoTrack):
    """The first video track of an MP4 file: its frame rate from the track's
    time scale and most common sample duration, and its edit list's media
    time."""

    def __init__(self, path, codec, fourcc, width, height, timescale, samples, config, deltas,
                 media_time):
        super().__init__(path, codec, fourcc, width, height, samples, config)
        self.timescale = timescale
        self.deltas = deltas              # (n,) int64 sample durations
        self.media_time = media_time
        if len(deltas):
            vals, counts = np.unique(deltas, return_counts=True)
            self.rate = Fraction(timescale, int(vals[np.argmax(counts)]))

    def shown(self) -> np.ndarray:
        """Whether each decoded sample is output (the edit list's media time)."""
        start = np.concatenate([[0], np.cumsum(self.deltas)[:-1]])
        return start + self.deltas > self.media_time if self.media_time > 0 else \
            np.ones(len(self.deltas), bool)


def read_mp4(path) -> Mp4Video:
    """Parse an MP4 file's boxes; see the module docstring."""
    path = Path(path)
    with open(path, "rb") as f:
        f.seek(0, 2)
        end = f.tell()
        moov = [(s, e) for typ, s, e in _boxes(f, 0, end) if typ == b"moov"]
        if not moov:
            raise ValueError(f"{path}: no moov box (not an MP4 file, or truncated)")
        for typ, s, e in _boxes(f, *moov[0]):
            if typ != b"trak":
                continue
            track = _track(f, s, e)
            if track is not None:
                return Mp4Video(path, *track)
    raise ValueError(f"{path}: no video track")


def _track(f, s, e):
    """A ``trak``'s fields if its handler is ``vide``, else None."""
    boxes = {}

    def walk(s, e):
        for typ, ps, pe in _boxes(f, s, e):
            if typ in CONTAINERS:
                walk(ps, pe)
            elif typ not in boxes:
                f.seek(ps)
                boxes[typ] = f.read(pe - ps)

    walk(s, e)
    hdlr = boxes.get(b"hdlr")
    if hdlr is None or hdlr[8:12] != b"vide":
        return None
    mdhd = boxes[b"mdhd"]
    timescale = struct.unpack(">I", mdhd[20:24] if mdhd[0] == 1 else mdhd[12:16])[0]
    stsd = boxes[b"stsd"]
    fourcc = stsd[12:16].decode("latin-1")
    if fourcc not in MJPEG_ENTRIES and fourcc != "mp4v":
        raise unsupported_codec(f"'{fourcc}' in MP4", CODEC_ITEMS.get(fourcc, ROADMAP_CODECS))
    codec = MJPEG if fourcc in MJPEG_ENTRIES else MPEG4
    entry = stsd[16:]
    width, height = struct.unpack(">HH", entry[24:28])
    config = b""
    p = 78
    while p + 8 <= len(entry):
        size, typ = struct.unpack(">I4s", entry[p:p + 8])
        if typ == b"esds" and fourcc == "mp4v":
            oti, config = _esds_config(entry[p + 8:p + size])
            if oti not in OBJECT_TYPES:
                raise unsupported_codec(f"'mp4v' of object type 0x{oti:02X} in MP4")
            codec = OBJECT_TYPES[oti]
        if size < 8:
            break
        p += size
    # decode times
    stts = boxes[b"stts"]
    deltas = []
    for i in range(struct.unpack(">I", stts[4:8])[0]):
        count, delta = struct.unpack(">II", stts[8 + 8 * i:16 + 8 * i])
        deltas += [delta] * count
    # sizes
    stsz = boxes[b"stsz"]
    fixed, n = struct.unpack(">II", stsz[4:12])
    sizes = np.full(n, fixed, np.int64) if fixed else \
        np.frombuffer(stsz[12:12 + 4 * n], ">u4").astype(np.int64)
    # chunks
    if b"co64" in boxes:
        co = boxes[b"co64"]
        chunks = np.frombuffer(co[8:8 + 8 * struct.unpack(">I", co[4:8])[0]], ">u8")
    else:
        co = boxes[b"stco"]
        chunks = np.frombuffer(co[8:8 + 4 * struct.unpack(">I", co[4:8])[0]], ">u4")
    chunks = chunks.astype(np.int64)
    stsc = boxes[b"stsc"]
    runs = [struct.unpack(">III", stsc[8 + 12 * i:20 + 12 * i])
            for i in range(struct.unpack(">I", stsc[4:8])[0])]
    offsets = np.zeros(n, np.int64)
    k = 0
    for r, (first, per_chunk, _) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(chunks)
        for c in range(first - 1, last):
            off = chunks[c]
            for _ in range(per_chunk):
                if k >= n:
                    break
                offsets[k] = off
                off += sizes[k]
                k += 1
    if k != n:
        raise ValueError("corrupt MP4: the chunk table does not cover every sample")
    sync = np.ones(n, np.int64)
    if b"stss" in boxes:
        stss = boxes[b"stss"]
        sync[:] = 0
        idx = np.frombuffer(stss[8:8 + 4 * struct.unpack(">I", stss[4:8])[0]], ">u4")
        sync[idx.astype(np.int64) - 1] = 1
    media_time = 0
    if b"elst" in boxes:
        elst = boxes[b"elst"]
        v1 = elst[0] == 1
        for i in range(struct.unpack(">I", elst[4:8])[0]):
            rec = elst[8 + (20 if v1 else 12) * i:]
            mt = struct.unpack(">q" if v1 else ">i", rec[8:16] if v1 else rec[4:8])[0]
            if mt >= 0:
                media_time = mt
                break
    deltas = np.array(deltas[:n] + [deltas[-1] if deltas else 1] * (n - len(deltas)),
                      np.int64)
    return (codec, fourcc, width, height, timescale, np.stack([offsets, sizes, sync], 1),
            config, deltas, media_time)


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #
def _box(typ: bytes, *parts) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _full(typ, version, flags, *parts):
    return _box(typ, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag, body):
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


def frame_rate(fps: float):
    """(time scale, ticks a frame) of ``fps``, as a fraction of small terms."""
    fr = Fraction(fps).limit_denominator(1001)
    if fr <= 0 or fr.numerator > 65535:
        raise ValueError(f"frame rate {fps} cannot be written")
    return fr.numerator, fr.denominator


class Mp4Writer:
    """One ``mp4v`` track; samples are written to ``mdat`` as they come. The
    path's suffix (one of :data:`BRANDS`) picks the brands."""

    def __init__(self, path, fps, width, height, config: bytes):
        self.path = Path(path)
        self.timescale, self.delta = frame_rate(fps)
        self.width, self.height, self.config = width, height, config
        major, minor, compatible = BRANDS[self.path.suffix.lower()]
        self.qt = major == b"qt  "          # QuickTime's boxes and fields (.mov)
        self.f = open(self.path, "wb")
        self.f.write(_box(b"ftyp", major, struct.pack(">I", minor), compatible))
        if self.qt:
            self.f.write(_box(b"wide"))
        self.mdat = self.f.tell()
        self.f.write(struct.pack(">I4sQ", 1, b"mdat", 0))   # 64-bit size, patched
        self.offsets, self.sizes, self.sync = [], [], []

    def add(self, data: bytes, sync: bool):
        self.offsets.append(self.f.tell())
        self.sizes.append(len(data))
        self.sync.append(bool(sync))
        self.f.write(data)

    def close(self):
        if self.f is None:
            return
        end = self.f.tell()
        self.f.seek(self.mdat + 8)
        self.f.write(struct.pack(">Q", end - self.mdat))
        self.f.seek(end)
        self.f.write(self._moov())
        self.f.close()
        self.f = None

    def _moov(self) -> bytes:
        n = len(self.sizes)
        duration = n * self.delta
        movie = duration * 1000 // self.timescale
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, movie),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), matrix, bytes(24),
                     struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie), bytes(8),
                     struct.pack(">HHHH", 0, 0, 0, 0), matrix,
                     struct.pack(">II", self.width << 16, self.height << 16))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.timescale, duration),
                     struct.pack(">HH", 0x7FFF if self.qt else 0x55C4, 0))
        if self.qt:
            hdlr = _full(b"hdlr", 0, 0, b"mhlr", b"vide", bytes(12), b"\x0cVideoHandler")
            dhlr = _full(b"hdlr", 0, 0, b"dhlr", b"url ", bytes(12), b"\x0bDataHandler")
        else:
            hdlr = _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0")
            dhlr = b""
        vmhd = _full(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        dec = _desc(4, bytes([0x20, 0x11]) + bytes(3) + struct.pack(">II", 0, 0)
                    + _desc(5, self.config))
        esds = _full(b"esds", 0, 0, _desc(3, struct.pack(">HB", 1, 0) + dec + _desc(6, b"\x02")))
        vendor = b"FFMP" + struct.pack(">II", 512, 512) if self.qt else bytes(12)
        mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(4), vendor,
                    struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1),
                    bytes(32), struct.pack(">Hh", 24, -1), esds)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), mp4v)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta))
        keys = [i + 1 for i, s in enumerate(self.sync) if s]
        stss = _full(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys), *keys))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self.sizes))
        if self.offsets and max(self.offsets) >= 1 << 32:
            stco = _full(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *self.offsets))
        else:
            stco = _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *self.offsets))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dhlr, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
