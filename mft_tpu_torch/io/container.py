"""What the video containers share: a track's samples, the codec names, the
probe that picks a reader by a file's first bytes, and the writer that a
suffix picks.

The JAX package opens any file ``cv2.VideoCapture`` opens and writes
``mp4v`` into whatever container the path's suffix names
(``mft_tpu/io/video.py:30, 87-88``), through libavformat. The port reads
and writes three containers of its own: ISO-BMFF (:mod:`.mp4`: ``.mp4``,
``.mov``, ``.m4v``, ``.3gp``), RIFF/AVI (:mod:`.avi`) and Matroska
(:mod:`.mkv`). :func:`open_track` picks the reader as libavformat probes:
by content (an ``ftyp``/``moov``/``mdat`` box, ``RIFF....AVI ``, the EBML
magic ``1A 45 DF A3``), never by the suffix.
"""

from fractions import Fraction
from pathlib import Path

import numpy as np

MPEG4, MJPEG = "mpeg4", "mjpeg"           # the codecs the port decodes
ROADMAP_CODECS = "ROADMAP A11, other codecs"
ROADMAP_H264 = "ROADMAP A11, H.264"
ROADMAP_CONTAINERS = "ROADMAP A11, other containers"
# the suffixes the writer takes (cv2's mp4v writer opens them all); cv2
# also opens .mpg, .ts, .asf and .nut, which raise
WRITER_SUFFIXES = (".mp4", ".mov", ".m4v", ".3gp", ".avi", ".mkv")
MP4_BOX_TYPES = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot")


class VideoTrack:
    """The first video track of a file: ``codec`` (:data:`MPEG4` or
    :data:`MJPEG`), the container's ``fourcc`` or codec name, ``width`` x
    ``height``, ``samples`` ((n, 3) int64: file offset, size, sync flag, in
    decode order), the codec ``config`` (an MPEG-4 VOS/VOL, or b"") and the
    frame rate ``rate`` (a Fraction, 0 when the file gives none)."""

    def __init__(self, path, codec, fourcc, width, height, samples, config=b"",
                 rate=Fraction(0)):
        self.path = Path(path)
        self.codec, self.fourcc = codec, fourcc
        self.width, self.height = int(width), int(abs(height))
        self.samples = np.asarray(samples, np.int64).reshape(-1, 3)
        self.config = config
        self.rate = Fraction(rate)

    @property
    def fps(self) -> float:
        return float(self.rate)

    def shown(self) -> np.ndarray:
        """Whether each sample's frame is output (all, but for an MP4 edit list)."""
        return np.ones(len(self.samples), bool)

    def read_samples(self):
        """Generator of each sample's bytes, in decode order."""
        with open(self.path, "rb") as f:
            for off, size, _ in self.samples:
                f.seek(int(off))
                data = f.read(int(size))
                if len(data) != size:
                    raise ValueError(f"corrupt video file {self.path}: a sample past the "
                                     "file's end")
                yield data


def unsupported_codec(what: str, item: str = ROADMAP_CODECS) -> NotImplementedError:
    return NotImplementedError(f"video codec {what}: the port decodes MPEG-4 Part 2 and "
                               f"baseline Motion JPEG ({item})")


def probe(path) -> str:
    """The container of a file by its first bytes: 'mp4', 'avi' or 'mkv';
    ``NotImplementedError`` naming :data:`ROADMAP_CONTAINERS` otherwise."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] in (b"AVI ", b"AVIX"):
        return "avi"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "mkv"
    if head[4:8] in MP4_BOX_TYPES:
        return "mp4"
    raise NotImplementedError(
        f"video file {path}: the port reads MP4/QuickTime, AVI and Matroska files and image "
        f"directories ({ROADMAP_CONTAINERS})")


def open_track(path) -> VideoTrack:
    """The first video track of an MP4/QuickTime, AVI or Matroska file."""
    from mft_tpu_torch.io import avi, mkv, mp4
    reader = {"mp4": mp4.read_mp4, "avi": avi.read_avi, "mkv": mkv.read_mkv}[probe(path)]
    return reader(path)


def open_writer(path, fps, width, height, config: bytes):
    """The muxer of one ``mp4v`` track that ``path``'s suffix names (any
    case), laid out as cv2's FFmpeg writer lays it out: MP4/QuickTime with
    the VOL in ``esds``, AVI with the VOL before every I-VOP, Matroska with
    the VOL in CodecPrivate. Other suffixes raise naming
    :data:`ROADMAP_CONTAINERS`."""
    from mft_tpu_torch.io import avi, mkv, mp4
    suffix = Path(path).suffix.lower()
    if suffix == ".avi":
        return avi.AviWriter(path, fps, width, height, b"mp4v", inband=config)
    if suffix == ".mkv":
        return mkv.MkvWriter(path, fps, width, height, mkv.MPEG4_ASP, config)
    if suffix in mp4.BRANDS:
        return mp4.Mp4Writer(path, fps, width, height, config)
    raise NotImplementedError(
        f"video writer for {path}: the port writes {', '.join(WRITER_SUFFIXES)} files (mp4v) "
        f"and image directories ({ROADMAP_CONTAINERS})")
