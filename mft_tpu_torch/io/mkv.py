"""Matroska (EBML) files: the first video track's frames read, one track written.

The JAX package reads and writes ``.mkv`` through ``cv2.VideoCapture`` /
``cv2.VideoWriter`` (libavformat's Matroska demuxer and muxer). This module
is the port's own.

- :func:`read_mkv` reads the EBML header (DocType ``matroska`` or
  ``webm``), a Segment of known or unknown size, ``Info``'s
  TimestampScale, the first video ``TrackEntry`` (CodecID, CodecPrivate,
  PixelWidth/PixelHeight, DefaultDuration; ContentEncodings raise) and the
  Clusters (known or unknown size; Timestamp, SimpleBlock and
  BlockGroup/Block, with no, Xiph, EBML or fixed-size lacing), and gives
  each frame of the track as a sample in file order.
- CodecIDs: ``V_MPEG4/ISO/SP|ASP|AP`` (CodecPrivate: the VOS/VOL),
  ``V_MS/VFW/FOURCC`` (CodecPrivate: a BITMAPINFOHEADER, its tag mapped as
  in AVI) and ``V_MJPEG``; others (WebM's VP8/VP9 ...) raise
  ``NotImplementedError`` naming "A11, other codecs".
- The frame rate is libavformat's: 10^9 / DefaultDuration reduced to terms
  of at most 30000; without a DefaultDuration, from the blocks' most common
  step.
- :class:`MkvWriter` writes libavformat's layout for one track: EBML
  header, Segment, Info (TimestampScale 1 ms, Duration), Tracks (CodecID,
  DefaultDuration, the size, CodecPrivate), then Clusters of SimpleBlocks
  with the keyframe flag, a new Cluster at each keyframe.
"""

import struct
from fractions import Fraction
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.container import MJPEG, MPEG4, VideoTrack, unsupported_codec

MPEG4_ASP = "V_MPEG4/ISO/ASP"
MPEG4_IDS = {"V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP"}
VFW = "V_MS/VFW/FOURCC"

EBML, DOCTYPE = 0x1A45DFA3, 0x4282
SEGMENT, CLUSTER, INFO, TRACKS = 0x18538067, 0x1F43B675, 0x1549A966, 0x1654AE6B
TIMESTAMP_SCALE, DURATION = 0x2AD7B1, 0x4489
TRACK_ENTRY, TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = 0xAE, 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION, VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT = 0x23E383, 0xE0, 0xB0, 0xBA
CONTENT_ENCODINGS = 0x6D80
TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, REFERENCE_BLOCK = 0xE7, 0xA3, 0xA0, 0xA1, 0xFB
# the Segment's children: an unknown-size Cluster ends where one begins
LEVEL1 = {CLUSTER, INFO, TRACKS, 0x114D9B74, 0x1C53BB6B, 0x1254C367, 0x1043A770, 0x1941A469}


def _vint(buf, pos):
    """(value, length, all value bits set) of the EBML variable-size integer
    at ``pos`` (the length marker removed)."""
    first = buf[pos]
    n = 1
    while n <= 8 and not first & (0x80 >> (n - 1)):
        n += 1
    if n > 8:
        raise ValueError("corrupt Matroska: a variable-size integer of more than 8 bytes")
    v = first & ((0x80 >> (n - 1)) - 1)
    for b in buf[pos + 1:pos + n]:
        v = (v << 8) | b
    return v, n, v == (1 << (7 * n)) - 1


def _id(buf, pos):
    n = _vint(buf, pos)[1]
    return int.from_bytes(buf[pos:pos + n], "big"), n


class _Reader:
    """Elements of a file read in windows (the payloads of blocks stay on disk)."""

    def __init__(self, f, end):
        self.f, self.end = f, end

    def head(self, pos):
        """(id, payload offset, payload size or None if unknown) at ``pos``."""
        self.f.seek(pos)
        buf = self.f.read(12)
        if len(buf) < 2:
            raise ValueError("corrupt Matroska: an element cut short")
        eid, n = _id(buf, 0)
        size, m, unknown = _vint(buf, n)
        return eid, pos + n + m, None if unknown else size

    def read(self, pos, size):
        self.f.seek(pos)
        return self.f.read(size)

    def children(self, start, end):
        """(id, payload offset, payload end) of the elements in [start, end);
        an element of unknown size runs to the next Segment child."""
        pos = start
        while pos < end:
            eid, ps, size = self.head(pos)
            pe = self._unknown_end(ps, end) if size is None else min(ps + size, end)
            yield eid, ps, pe
            pos = pe

    def _unknown_end(self, ps, end):
        pos = ps
        while pos < end:
            eid, cps, size = self.head(pos)
            if eid in LEVEL1:
                return pos
            pos = cps + size if size is not None else self._unknown_end(cps, end)
        return end


def _uint(b: bytes) -> int:
    return int.from_bytes(b, "big") if b else 0


def _lace_sizes(buf, pos, lacing, total):
    """(frame sizes, offset of the first frame) of a laced block's payload
    starting at ``pos`` (``total``: the payload's end)."""
    n = buf[pos] + 1
    pos += 1
    if lacing == 1:                                  # Xiph
        sizes = []
        for _ in range(n - 1):
            s = 0
            while True:
                b = buf[pos]
                pos += 1
                s += b
                if b != 255:
                    break
            sizes.append(s)
    elif lacing == 3:                                # EBML
        s, m, _ = _vint(buf, pos)
        pos += m
        sizes = [s]
        for _ in range(n - 2):
            d, m, _ = _vint(buf, pos)
            pos += m
            s += d - ((1 << (7 * m - 1)) - 1)
            sizes.append(s)
    else:                                            # fixed
        if (total - pos) % n:
            raise ValueError("corrupt Matroska: a fixed-size lace that does not divide")
        return [(total - pos) // n] * n, pos
    last = total - pos - sum(sizes)
    if last < 0 or any(s < 0 for s in sizes):
        raise ValueError("corrupt Matroska: lace sizes past the block's end")
    return sizes + [last], pos


def _bitmapinfo_codec(private: bytes):
    if len(private) < 40:
        raise ValueError("corrupt Matroska: V_MS/VFW/FOURCC without a BITMAPINFOHEADER")
    from mft_tpu_torch.io.avi import codec_of
    tag = private[16:20]
    return codec_of(tag), tag.decode("latin-1"), private[40:]


def read_mkv(path) -> VideoTrack:
    """The first video track of a Matroska (or WebM) file; see the module
    docstring."""
    path = Path(path)
    with open(path, "rb") as f:
        f.seek(0, 2)
        r = _Reader(f, f.tell())
        eid, ps, size = r.head(0)
        if eid != EBML or size is None:
            raise ValueError(f"{path}: not a Matroska file")
        doctype = b""
        for cid, cs, ce in r.children(ps, ps + size):
            if cid == DOCTYPE:
                doctype = r.read(cs, ce - cs).rstrip(b"\0")
        if doctype not in (b"matroska", b"webm"):
            raise ValueError(f"{path}: EBML DocType {doctype!r}, not Matroska")
        pos = ps + size
        eid, seg, size = r.head(pos)
        if eid != SEGMENT:
            raise ValueError(f"corrupt Matroska {path}: no Segment")
        seg_end = r.end if size is None else min(seg + size, r.end)
        scale, track, clusters = 1000000, None, []
        for cid, cs, ce in r.children(seg, seg_end):
            if cid == INFO:
                for k, ks, ke in r.children(cs, ce):
                    if k == TIMESTAMP_SCALE:
                        scale = _uint(r.read(ks, ke - ks))
            elif cid == TRACKS and track is None:
                track = _video_track(r, cs, ce)
            elif cid == CLUSTER:
                clusters.append((cs, ce))
        if track is None:
            raise ValueError(f"{path}: no video track")
        number, codec_id, private, width, height, default = track
        if codec_id in MPEG4_IDS:
            codec, fourcc, config = MPEG4, codec_id, private
        elif codec_id == "V_MJPEG":
            codec, fourcc, config = MJPEG, codec_id, b""
        elif codec_id == VFW:
            codec, fourcc, config = _bitmapinfo_codec(private)
        else:
            raise unsupported_codec(f"'{codec_id}' in Matroska")
        samples, times = [], []
        for cs, ce in clusters:
            _cluster_frames(r, cs, ce, number, samples, times)
    if default:
        rate = Fraction(10 ** 9, default).limit_denominator(30000)
    else:
        steps = np.diff(times)
        steps = steps[steps > 0]
        rate = Fraction(0)
        if len(steps):
            vals, counts = np.unique(steps, return_counts=True)
            rate = Fraction(10 ** 9, int(vals[np.argmax(counts)]) * scale).limit_denominator(
                30000)
    return VideoTrack(path, codec, fourcc, width, height, samples, config, rate)


def _video_track(r, s, e):
    """(number, CodecID, CodecPrivate, width, height, DefaultDuration) of
    the first video TrackEntry, None if there is none."""
    for eid, ts, te in r.children(s, e):
        if eid != TRACK_ENTRY:
            continue
        fields = {}
        for k, ks, ke in r.children(ts, te):
            if k == VIDEO:
                for v, vs, ve in r.children(ks, ke):
                    fields[v] = r.read(vs, ve - vs)
            else:
                fields[k] = r.read(ks, ke - ks)
        if _uint(fields.get(TRACK_TYPE, b"")) != 1:
            continue
        if CONTENT_ENCODINGS in fields:
            raise NotImplementedError("Matroska tracks with ContentEncodings (compression or "
                                      "encryption) are not supported (ROADMAP A11, other "
                                      "containers)")
        return (_uint(fields.get(TRACK_NUMBER, b"")),
                fields.get(CODEC_ID, b"").rstrip(b"\0").decode("latin-1"),
                fields.get(CODEC_PRIVATE, b""), _uint(fields.get(PIXEL_WIDTH, b"")),
                _uint(fields.get(PIXEL_HEIGHT, b"")), _uint(fields.get(DEFAULT_DURATION, b"")))
    return None


def _cluster_frames(r, s, e, number, samples, times):
    base = 0
    for eid, bs, be in r.children(s, e):
        if eid == TIMESTAMP:
            base = _uint(r.read(bs, be - bs))
        elif eid == SIMPLE_BLOCK:
            _block(r, bs, be, number, base, None, samples, times)
        elif eid == BLOCK_GROUP:
            kids = list(r.children(bs, be))
            key = not any(k == REFERENCE_BLOCK for k, _, _ in kids)
            for k, ks, ke in kids:
                if k == BLOCK:
                    _block(r, ks, ke, number, base, key, samples, times)


def _block(r, s, e, number, base, key, samples, times):
    """Append the frames of one (Simple)Block of track ``number``; ``key``
    None: the SimpleBlock's flag says."""
    head = r.read(s, min(e - s, 8 + 4 * 255))
    track, n, _ = _vint(head, 0)
    if track != number:
        return
    t = struct.unpack(">h", head[n:n + 2])[0]
    flags = head[n + 2]
    lacing = (flags >> 1) & 3
    key = bool(flags & 0x80) if key is None else key
    pos = n + 3
    if lacing:
        sizes, pos = _lace_sizes(r.read(s, e - s), pos, lacing, e - s)
    else:
        sizes = [e - s - pos]
    off = s + pos
    for size in sizes:
        samples.append((off, size, key))
        times.append(base + t)
        off += size


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #
def _ebml_id(eid: int) -> bytes:
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big")


def _size(n: int) -> bytes:
    for k in range(1, 8):
        if n < (1 << (7 * k)) - 1:
            return ((1 << (7 * k)) | n).to_bytes(k, "big")
    return (0x01 << 56 | n).to_bytes(8, "big")


def _el(eid: int, payload: bytes) -> bytes:
    return _ebml_id(eid) + _size(len(payload)) + payload


def _u(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


class MkvWriter:
    """One video track (``codec_id``, CodecPrivate ``private``); frames go to
    Clusters as they come."""

    def __init__(self, path, fps, width, height, codec_id=MPEG4_ASP, private=b""):
        from mft_tpu_torch.io.mp4 import frame_rate
        self.path = Path(path)
        self.rate, self.scale = frame_rate(fps)
        self.f = open(self.path, "wb")
        self.f.write(_el(EBML, _u(0x4286, 1) + _u(0x42F7, 1) + _u(0x42F2, 4) + _u(0x42F3, 8)
                         + _el(DOCTYPE, b"matroska") + _u(0x4287, 4) + _u(0x4285, 2)))
        self.f.write(_ebml_id(SEGMENT) + bytes([0x01]) + bytes(7))   # 8-byte size, patched
        self.segment = self.f.tell()
        app = b"mft_tpu"
        info = (_u(TIMESTAMP_SCALE, 1000000) + _el(0x4D80, app) + _el(0x5741, app))
        self.f.write(_ebml_id(INFO) + _size(len(info) + 11) + info)
        self.duration_at = self.f.tell() + 3
        self.f.write(_el(DURATION, struct.pack(">d", 0.0)))
        default = round(10 ** 9 * self.scale / self.rate)
        entry = (_u(TRACK_NUMBER, 1) + _u(0x73C5, 1) + _u(0x9C, 0) + _el(0x22B59C, b"und")
                 + _el(CODEC_ID, codec_id.encode()) + _u(TRACK_TYPE, 1)
                 + _u(DEFAULT_DURATION, default)
                 + _el(VIDEO, _u(PIXEL_WIDTH, width) + _u(PIXEL_HEIGHT, height))
                 + (_el(CODEC_PRIVATE, private) if private else b""))
        self.f.write(_el(TRACKS, _el(TRACK_ENTRY, entry)))
        self.cluster = None           # (offset of its size field, its timestamp)
        self.n = 0

    def _ms(self, n: int) -> int:
        return (2 * n * 1000 * self.scale + self.rate) // (2 * self.rate)   # rounded

    def _end_cluster(self):
        if self.cluster is not None:
            end = self.f.tell()
            self.f.seek(self.cluster[0])
            self.f.write((0x01 << 56 | (end - self.cluster[0] - 8)).to_bytes(8, "big"))
            self.f.seek(end)
            self.cluster = None

    def add(self, data: bytes, sync: bool):
        t = self._ms(self.n)
        if self.cluster is None or sync or t - self.cluster[1] > 32767:
            self._end_cluster()
            self.f.write(_ebml_id(CLUSTER))
            self.cluster = (self.f.tell(), t)
            self.f.write(bytes(8))
            self.f.write(_u(TIMESTAMP, t))
        block = bytes([0x81]) + struct.pack(">hB", t - self.cluster[1], 0x80 if sync else 0)
        self.f.write(_el(SIMPLE_BLOCK, block + data))
        self.n += 1

    def close(self):
        if self.f is None:
            return
        self._end_cluster()
        end = self.f.tell()
        last = self._ms(self.n - 1) + self._ms(1) if self.n else 0
        self.f.seek(self.duration_at)
        self.f.write(struct.pack(">d", float(last)))
        self.f.seek(self.segment - 8)
        self.f.write((0x01 << 56 | (end - self.segment)).to_bytes(8, "big"))
        self.f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
