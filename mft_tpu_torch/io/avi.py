"""RIFF/AVI files: the first video stream's samples read, one stream written.

The JAX package reads and writes ``.avi`` through ``cv2.VideoCapture`` /
``cv2.VideoWriter`` (libavformat's AVI demuxer and muxer). This module is
the port's own.

- :func:`read_avi` reads the ``RIFF AVI `` list and any OpenDML ``RIFF
  AVIX`` continuations: ``hdrl`` (``avih``; the first video stream's
  ``strh`` with ``dwRate/dwScale``, its ``strf`` BITMAPINFOHEADER with the
  codec tag, size and extradata, and its OpenDML super index ``indx``) and
  the ``movi`` lists (``##dc``/``##db`` chunks, also inside ``rec `` lists,
  ``JUNK`` and odd-size padding skipped). The samples come from the
  OpenDML ``ix##`` indexes, else from ``idx1`` (offsets from the ``movi``
  list or from the file's start, as libavformat guesses), else, where an
  index is missing or points at no chunk of the stream, from a walk of the
  ``movi`` lists, as libavformat falls back to one. An empty chunk (a
  dropped frame) is a sample of size 0, which gives no frame, as in cv2.
- Codec tags: MPEG-4 Part 2 (:data:`MPEG4_TAGS`) and the tags that
  libavformat maps to Motion JPEG (:data:`MJPEG_TAGS`), matched without
  regard to case as libavformat matches them; others raise
  ``NotImplementedError`` naming "A11, other codecs".
- :class:`AviWriter` writes one video stream as libavformat's muxer does:
  ``hdrl`` with room for an OpenDML super index and ``dmlh``, ``movi``,
  ``idx1`` for the first RIFF; past ``RIFF_LIMIT`` (libavformat's 1 GiB) it
  closes the RIFF with an ``ix00`` standard index and goes on in a ``RIFF
  AVIX``, then writes the super index and the total frame count.
"""

import struct
from fractions import Fraction
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.container import MJPEG, MPEG4, VideoTrack, unsupported_codec

MPEG4_TAGS = {b"MP4V", b"XVID", b"DIVX", b"FMP4", b"DX50", b"MP4S", b"M4S2"}
MJPEG_TAGS = {b"MJPG", b"AVRN", b"DMB1", b"AVDJ", b"MJPA", b"JPEG", b"JPGL", b"LJPG",
              b"SLMJ", b"CJPG", b"IJPG", b"ACDV", b"QIVG"}
RIFF_LIMIT = 1 << 30                    # libavformat's AVI_MAX_RIFF_SIZE
SUPER_INDEX_ENTRIES = 256               # libavformat's AVI_MASTER_INDEX_SIZE
AVIF_FLAGS = 0x910                      # HASINDEX | ISINTERLEAVED | TRUSTCKTYPE
KEYFRAME = 0x10                         # AVIIF_KEYFRAME


def codec_of(tag: bytes) -> str:
    """The codec of a BITMAPINFOHEADER compression tag."""
    up = tag.upper()
    if up in MPEG4_TAGS:
        return MPEG4
    if up in MJPEG_TAGS:
        return MJPEG
    raise unsupported_codec(f"'{tag.decode('latin-1')}' in AVI")


def _chunks(f, start, end):
    """(fourcc, payload offset, payload size, list type or None) of the
    chunks in [start, end); a chunk cut by the end keeps what is there."""
    off = start
    while off + 8 <= end:
        f.seek(off)
        head = f.read(12)
        tag, size = head[:4], struct.unpack("<I", head[4:8])[0]
        kind = head[8:12] if tag in (b"RIFF", b"LIST") else None
        yield tag, off + 8, min(size, end - off - 8), kind
        off += 8 + size + (size & 1)


class _Scan:
    """What one pass over the file's RIFF lists found."""

    def __init__(self):
        self.hdrl = False
        self.strh = self.strf = self.indx = None
        self.movi = []              # (payload offset, end) of each movi list
        self.idx1 = None
        self.walk = []              # (fourcc, payload offset, size) of movi's data chunks


def _walk_movi(f, s, e, out):
    for tag, ps, size, kind in _chunks(f, s, e):
        if kind == b"rec ":
            _walk_movi(f, ps + 4, ps + size, out)
        elif kind is None and tag[2:] in (b"dc", b"db") and tag[:2].isdigit():
            out.append((tag, ps, size))


def _scan(f, end) -> _Scan:
    sc = _Scan()
    for tag, ps, size, kind in _chunks(f, 0, end):
        if tag != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            if sc.movi:
                break               # trailing garbage after the last RIFF
            raise ValueError(f"not an AVI file (a {tag!r} chunk at the top level)")
        for t, cs, csize, k in _chunks(f, ps + 4, ps + size):
            if k == b"hdrl" and not sc.hdrl:
                sc.hdrl = True
                _read_hdrl(f, cs + 4, cs + csize, sc)
            elif k == b"movi":
                sc.movi.append((cs, cs + csize))
                _walk_movi(f, cs + 4, cs + csize, sc.walk)
            elif t == b"idx1" and sc.idx1 is None:
                f.seek(cs)
                sc.idx1 = f.read(csize)
    return sc


def _read_hdrl(f, s, e, sc):
    """The first video stream's strh, strf and indx, and its number."""
    stream = -1
    for _, ps, size, kind in _chunks(f, s, e):
        if kind == b"strl":
            stream += 1
            parts = {t: (cs, csize) for t, cs, csize, _ in _chunks(f, ps + 4, ps + size)}
            if b"strh" not in parts or b"strf" not in parts:
                continue
            f.seek(parts[b"strh"][0])
            strh = f.read(parts[b"strh"][1])
            if strh[:4] != b"vids" or sc.strh is not None:
                continue
            f.seek(parts[b"strf"][0])
            sc.strh, sc.strf, sc.stream = strh, f.read(parts[b"strf"][1]), stream
            if b"indx" in parts:
                f.seek(parts[b"indx"][0])
                sc.indx = f.read(parts[b"indx"][1])


def _valid(f, entries, ids, end) -> bool:
    """Whether every (offset of the payload, size) points at a chunk of the
    stream of that size."""
    for off, size in entries:
        if off < 8 or off + size > end:
            return False
        f.seek(off - 8)
        head = f.read(8)
        if head[:4] not in ids or struct.unpack("<I", head[4:])[0] != size:
            return False
    return bool(entries)


def _odml_entries(f, indx, end):
    """(payload offset, size, key) of an OpenDML super index's ix## chunks."""
    longs, sub, kind, n = struct.unpack("<HBBI", indx[:8])
    if kind != 0 or longs != 4:                     # AVI_INDEX_OF_INDEXES
        return []
    out = []
    for i in range(n):
        off, size, _ = struct.unpack("<QII", indx[24 + 16 * i:40 + 16 * i])
        if off + 8 + 24 > end:
            return []
        f.seek(off)
        head = f.read(8 + 24)
        ilongs, _, ikind, count, _, base = struct.unpack("<HBBI4sQ", head[8:28])
        if head[:2] != b"ix" or ikind != 1 or ilongs != 2:   # AVI_INDEX_OF_CHUNKS
            return []
        raw = f.read(8 * count)
        for k in range(count):
            o, s = struct.unpack("<II", raw[8 * k:8 * k + 8])
            out.append((base + o, s & 0x7FFFFFFF, not s & 0x80000000))
    return out


def _idx1_entries(idx1, ids, movi_start):
    """(payload offset, size, key) of idx1's entries of the stream, offsets
    from the movi list (libavformat's guess: the first entry's offset is
    below the list's) or from the file's start."""
    n = len(idx1) // 16
    rows = [struct.unpack("<4sIII", idx1[16 * i:16 * i + 16]) for i in range(n)]
    rows = [r for r in rows if r[0] in ids]
    if not rows:
        return []
    base = movi_start if rows[0][2] < movi_start else 0
    return [(base + off + 8, size, bool(flags & KEYFRAME)) for _, flags, off, size in rows]


def read_avi(path) -> VideoTrack:
    """The first video stream of an AVI file; see the module docstring."""
    path = Path(path)
    with open(path, "rb") as f:
        f.seek(0, 2)
        end = f.tell()
        sc = _scan(f, end)
        if sc.strh is None:
            raise ValueError(f"{path}: no video stream")
        if len(sc.strf) < 40:
            raise ValueError(f"corrupt AVI {path}: a short strf")
        _, width, height, _, _, tag = struct.unpack("<IiiHH4s", sc.strf[:20])
        codec = codec_of(tag)
        scale, rate = struct.unpack("<II", sc.strh[20:28])
        ids = {b"%02ddc" % sc.stream, b"%02ddb" % sc.stream}
        entries = []
        if sc.indx is not None:
            entries = _odml_entries(f, sc.indx, end)
        if not _valid(f, [e[:2] for e in entries], ids, end) and sc.idx1 and sc.movi:
            entries = _idx1_entries(sc.idx1, ids, sc.movi[0][0])
        if not _valid(f, [e[:2] for e in entries], ids, end):
            entries = [(ps, size, True) for t, ps, size in sc.walk if t in ids]
    samples = np.array([[o, s, k] for o, s, k in entries], np.int64).reshape(-1, 3)
    return VideoTrack(path, codec, tag.decode("latin-1"), width, height, samples,
                      sc.strf[40:], Fraction(rate, scale) if scale and rate else Fraction(0))


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #
def _chunk(tag: bytes, data: bytes) -> bytes:
    return tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) & 1 else b"")


class AviWriter:
    """One video stream (codec tag ``fourcc``); samples go to ``movi`` as
    they come. ``inband``: bytes written before every sync sample (an
    MPEG-4 VOS/VOL, as libavformat's writer stores ``mp4v`` without a
    global header)."""

    def __init__(self, path, fps, width, height, fourcc=b"mp4v", inband=b""):
        from mft_tpu_torch.io.mp4 import frame_rate
        self.path = Path(path)
        self.rate, self.scale = frame_rate(fps)
        self.width, self.height, self.fourcc = width, height, fourcc
        self.inband = inband
        self.f = open(self.path, "wb")
        # per RIFF: (its start, its movi fourcc's offset, [(payload offset, size, key)])
        self.riffs = []
        self.max_size = 0
        self._header()
        self._start_riff(b"AVI ")

    # layout: RIFF AVI [LIST hdrl [avih] [LIST strl [strh][strf][indx/JUNK]]
    # [LIST odml/JUNK [dmlh]]] [LIST INFO] [JUNK] [LIST movi ...] [idx1]
    def _header(self):
        self.f.write(b"RIFF\0\0\0\0AVI ")
        hdrl_start = self.f.tell()
        self.f.write(b"LIST\0\0\0\0hdrl")
        self.avih_at = self.f.tell() + 8
        self.f.write(_chunk(b"avih", bytes(56)))
        self.f.write(b"LIST" + struct.pack("<I", 4 + 64 + 48 + 24 + 16 * SUPER_INDEX_ENTRIES + 8)
                     + b"strl")
        self.strh_at = self.f.tell() + 8
        self.f.write(_chunk(b"strh", bytes(56)))
        self.f.write(_chunk(b"strf", struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1,
                                                 24, self.fourcc, self.width * self.height * 3,
                                                 0, 0, 0, 0)))
        self.indx_at = self.f.tell()
        self.f.write(_chunk(b"JUNK", bytes(24 + 16 * SUPER_INDEX_ENTRIES)))
        self.odml_at = self.f.tell()
        self.f.write(_chunk(b"JUNK", b"odml" + b"dmlh" + struct.pack("<I", 248) + bytes(248)))
        end = self.f.tell()
        self.f.seek(hdrl_start + 4)
        self.f.write(struct.pack("<I", end - hdrl_start - 8))
        self.f.seek(end)
        info = b"INFO" + _chunk(b"ISFT", b"mft_tpu\0")
        self.f.write(b"LIST" + struct.pack("<I", len(info)) + info)
        self.f.write(_chunk(b"JUNK", bytes(1016)))

    def _start_riff(self, kind: bytes):
        start = self.f.tell()
        if kind != b"AVI ":
            self.f.write(b"RIFF\0\0\0\0" + kind)
        self.f.write(b"LIST\0\0\0\0movi")
        self.riffs.append((0 if kind == b"AVI " else start, self.f.tell() - 4, []))

    def add(self, data: bytes, sync: bool):
        data = (self.inband + data) if sync and self.inband else data
        riff, _, rows = self.riffs[-1]
        if rows and self.f.tell() + 8 + len(data) - riff > RIFF_LIMIT:
            self._end_riff(odml=True)
            self._start_riff(b"AVIX")
            rows = self.riffs[-1][2]
        rows.append((self.f.tell() + 8, len(data), bool(sync)))
        self.max_size = max(self.max_size, len(data))
        self.f.write(_chunk(b"00dc", data))

    def _patch_size(self, at):
        end = self.f.tell()
        self.f.seek(at + 4)
        self.f.write(struct.pack("<I", end - at - 8))
        self.f.seek(end)

    def _end_riff(self, odml: bool):
        """End the current RIFF: its ix00 standard index (``odml``: the
        file has several RIFFs), the end of movi, idx1 in the first RIFF."""
        riff, movi, rows = self.riffs[-1][:3]
        ix = None
        if odml:
            body = struct.pack("<HBBI4sQI", 2, 0, 1, len(rows), b"00dc", movi, 0) + b"".join(
                struct.pack("<II", off - movi, size | (0 if key else 0x80000000))
                for off, size, key in rows)
            ix = (self.f.tell(), 8 + len(body))
            self.f.write(_chunk(b"ix00", body))
        self._patch_size(movi - 8)
        if len(self.riffs) == 1:
            self.f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", KEYFRAME if key else 0, off - 8 - movi, size)
                for off, size, key in rows)))
        self._patch_size(riff)
        self.riffs[-1] = (riff, movi, rows, ix)

    def close(self):
        if self.f is None:
            return
        odml = len(self.riffs) > 1
        self._end_riff(odml)
        end = self.f.tell()
        n = sum(len(r[2]) for r in self.riffs)
        usec = round(1e6 * self.scale / self.rate)
        self.f.seek(self.avih_at)
        self.f.write(struct.pack("<IIIIIIIIII", usec, 0, 0, AVIF_FLAGS, len(self.riffs[0][2]),
                                 0, 1, 1 << 20, self.width, self.height) + bytes(16))
        self.f.seek(self.strh_at)
        self.f.write(b"vids" + self.fourcc + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, self.scale, self.rate, 0, n, self.max_size,
            0xFFFFFFFF, 0, 0, 0, self.width, self.height))
        if odml:
            if len(self.riffs) > SUPER_INDEX_ENTRIES:
                raise ValueError(f"an AVI of more than {SUPER_INDEX_ENTRIES} RIFFs")
            entries = b"".join(struct.pack("<QII", at, size, len(rows))
                               for _, _, rows, (at, size) in self.riffs)
            head = struct.pack("<HBBI4sIII", 4, 0, 0, len(self.riffs), b"00dc", 0, 0, 0)
            self.f.seek(self.indx_at)
            self.f.write(_chunk(b"indx", head + entries.ljust(16 * SUPER_INDEX_ENTRIES, b"\0")))
            self.f.seek(self.odml_at)
            self.f.write(b"LIST")                   # the JUNK placeholder becomes odml
            self.f.seek(self.odml_at + 20)
            self.f.write(struct.pack("<I", n))      # dmlh dwTotalFrames
        self.f.seek(end)
        self.f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
