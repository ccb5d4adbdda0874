"""The port's RIFF/AVI reader and writer, ``mft_tpu_torch/io/avi.py``, against
cv2 (libavformat's AVI demuxer and muxer) and the JAX package on the CPU.

- The committed ``mp4v`` fixtures (the JAX package's writer; cv2's with
  fourcc ``XVID``) and cv2-written files under every MPEG-4 tag that cv2's
  writer takes decode to cv2's frames; the samples equal cv2's raw packets.
- The reader's paths: ``idx1``, no index or an empty one (the ``movi``
  walk), chunks in ``rec `` lists with ``JUNK`` and odd-size padding,
  OpenDML files split at a small RIFF size (``indx`` and ``ix00``), each
  against cv2.
- The writer: cv2 reads the port's ``.avi`` with the JAX writer's frame
  count and fps, to the port's own frames, at a PSNR no lower than cv2's
  writer's; its layout (``hdrl``, ``movi``, ``idx1``, the VOL before every
  I-VOP) as libavformat's.
- Other codec tags raise naming "A11, other codecs".
"""

import struct
from fractions import Fraction
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io import video as jax_video
from mft_tpu_torch.io import avi, mpeg4, video
from mft_tpu_torch.io.container import open_track

DATA = Path(__file__).parent / "data" / "torch_fixtures"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def cv2_packets(path):
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            return out
        out.append(p.ravel().tobytes())


def assert_equal_cv2(path, n=None):
    want = cv2_frames(path)
    got = list(video.get_video_frames(path, device="cpu"))
    assert len(got) == len(want) > 0 and (n is None or len(got) == n)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert video.get_video_length(path, device="cpu") == len(want)


def pan(H, W, n=8, seed=0):
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8), (0, 0), 2)
    return [np.ascontiguousarray(big[2 * t:2 * t + H, 3 * t:3 * t + W]) for t in range(n)]


def jpegs(frames):
    return [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]


@pytest.mark.parametrize("name", ["mp4v.avi", "xvid.avi"])
def test_fixture_frames_equal_cv2(name):
    path = DATA / "video" / name
    assert_equal_cv2(path, 6)
    track = open_track(path)
    assert track.codec == "mpeg4" and track.fps == 25.0
    assert list(track.read_samples()) == cv2_packets(path)
    assert all(np.array_equal(a, b) for a, b in zip(
        video.get_video_frames(path, device="cpu"), jax_video.get_video_frames(path)))


@pytest.mark.parametrize("tag", ["mp4v", "XVID", "DIVX", "FMP4", "DX50"])
def test_mpeg4_tags_equal_cv2(tmp_path, tag):
    path = tmp_path / "t.avi"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*tag), 25.0, (64, 48))
    assert w.isOpened()
    for f in pan(48, 64, 14, seed=1):
        w.write(f)
    w.release()
    track = open_track(path)
    assert track.codec == "mpeg4" and track.fourcc.upper() == tag.upper()
    assert_equal_cv2(path, 14)


def test_other_tags_raise(tmp_path):
    path = tmp_path / "h.avi"
    with avi.AviWriter(path, 25.0, 48, 32, b"H264") as w:
        w.add(b"\x00\x00\x00\x01", True)
    with pytest.raises(NotImplementedError, match="'H264' in AVI.*A11, other codecs"):
        video.GeneralVideoCapture(path, device="cpu")


def _top(data):
    """(tag, list kind, offset, size) of the first RIFF's children."""
    out, off = [], 12
    while off + 8 <= len(data):
        tag, size = data[off:off + 4], struct.unpack("<I", data[off + 4:off + 8])[0]
        out.append((tag, data[off + 8:off + 12] if tag == b"LIST" else None, off, size))
        off += 8 + size + (size & 1)
    return out


def test_writer_layout_as_libavformat(tmp_path):
    """hdrl (avih, strl with strh/strf and room for indx), INFO, JUNK, movi
    of 00dc chunks, idx1; strh's rate and scale, an I-VOP every 12 frames
    with the VOL before it, and idx1's key flags on them."""
    frames = pan(32, 48, 14, seed=2)
    with video.VideoWriter(tmp_path / "w.avi", fps=29.97, device="cpu") as w:
        for f in frames:
            w.write(f)
    data = (tmp_path / "w.avi").read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    top = _top(data)
    assert [(t, k) for t, k, _, _ in top] == [(b"LIST", b"hdrl"), (b"LIST", b"INFO"),
                                              (b"JUNK", None), (b"LIST", b"movi"),
                                              (b"idx1", None)]
    strh = data[data.index(b"strh") + 8:]
    assert strh[:8] == b"vidsmp4v"
    assert struct.unpack("<II", strh[20:28]) == (100, 2997)       # as cv2 writes 29.97
    track = open_track(tmp_path / "w.avi")
    assert track.rate == Fraction(2997, 100) and (track.width, track.height) == (48, 32)
    samples = list(track.read_samples())
    config = mpeg4.write_config(mpeg4.Vol(48, 32, 2997))
    assert [s.startswith(config) for s in samples] == [k % 12 == 0 for k in range(14)]
    assert track.samples[:, 2].tolist() == [int(k % 12 == 0) for k in range(14)]
    assert samples == cv2_packets(tmp_path / "w.avi")


@pytest.mark.parametrize("fps", [25.0, 29.97, 10.0])
def test_writer_files_open_in_cv2(tmp_path, fps):
    frames = pan(48, 64, 14, seed=3)
    with video.VideoWriter(tmp_path / "port.avi", fps=fps, device="cpu") as w:
        for f in frames:
            w.write(f)
    with jax_video.VideoWriter(tmp_path / "cv2.avi", fps=fps) as w:
        for f in frames:
            w.write(f)
    mine, theirs = cv2.VideoCapture(str(tmp_path / "port.avi")), cv2.VideoCapture(
        str(tmp_path / "cv2.avi"))
    for prop in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_WIDTH,
                 cv2.CAP_PROP_FRAME_HEIGHT):
        assert mine.get(prop) == theirs.get(prop)
    got = list(video.get_video_frames(tmp_path / "port.avi", device="cpu"))
    assert_equal_cv2(tmp_path / "port.avi", len(frames))
    ref = cv2_frames(tmp_path / "cv2.avi")
    psnr = lambda a: 10 * np.log10(255.0 ** 2 / np.mean(  # noqa: E731
        [(x.astype(np.float64) - y) ** 2 for x, y in zip(frames, a)]))
    assert psnr(got) >= psnr(ref)


def test_opendml_split_reads_as_cv2(tmp_path, monkeypatch):
    """A RIFF limit of 12 kB splits 14 MJPEG frames over several RIFFs: the
    first with idx1, each with an ix00, the super index and dmlh's total;
    cv2 and the port read the same 14 frames, the port from indx."""
    frames = pan(48, 64, 14, seed=4)
    path = tmp_path / "odml.avi"
    monkeypatch.setattr(avi, "RIFF_LIMIT", 12000)
    with avi.AviWriter(path, 25.0, 64, 48, b"MJPG") as w:
        for data in jpegs(frames):
            w.add(data, True)
    data = path.read_bytes()
    riffs = [i for i in range(0, len(data) - 12) if data[i:i + 4] == b"RIFF"
             and data[i + 8:i + 12] in (b"AVI ", b"AVIX")]
    assert len(riffs) >= 3 and data.count(b"ix00") == len(riffs) and data.count(b"idx1") == 1
    assert b"indx" in data and b"odmldmlh" in data
    dmlh = data.index(b"dmlh")
    assert struct.unpack("<I", data[dmlh + 8:dmlh + 12])[0] == 14
    assert_equal_cv2(path, 14)
    sc = avi._scan(open(path, "rb"), len(data))
    assert len(avi._odml_entries(open(path, "rb"), sc.indx, len(data))) == 14


def test_opendml_mp4v_writer_reads_as_cv2(tmp_path, monkeypatch):
    """The writer's mp4v past a small RIFF limit: P-VOPs flagged not key in
    ix00, the VOL before each I-VOP in any RIFF; cv2 reads the port's frames."""
    monkeypatch.setattr(avi, "RIFF_LIMIT", 6000)
    frames = pan(48, 64, 13, seed=7) + pan(48, 64, 13, seed=8)[::-1]
    with video.VideoWriter(tmp_path / "long.avi", fps=25.0, device="cpu") as w:
        for f in frames:
            w.write(f)
    data = (tmp_path / "long.avi").read_bytes()
    assert data.count(b"AVIX") >= 2 and b"indx" in data
    track = open_track(tmp_path / "long.avi")
    assert track.samples[:, 2].tolist() == [int(k % 12 == 0) for k in range(26)]
    assert cv2.VideoCapture(str(tmp_path / "long.avi")).get(cv2.CAP_PROP_FRAME_COUNT) == 26
    assert_equal_cv2(tmp_path / "long.avi", 26)


def _broken(data, what):
    """The file with its idx1 renamed to JUNK, or emptied."""
    i = data.index(b"idx1")
    size = struct.unpack("<I", data[i + 4:i + 8])[0]
    if what == "none":
        return data[:i] + b"JUNK" + data[i + 4:]
    return data[:i + 4] + struct.pack("<I", 0) + data[i + 8 + size:]


@pytest.mark.parametrize("what", ["none", "empty"])
def test_missing_or_empty_index_walks_movi(tmp_path, what):
    with video.VideoWriter(tmp_path / "w.avi", fps=25.0, device="cpu") as w:
        for f in pan(32, 48, 14, seed=5):
            w.write(f)
    path = tmp_path / "b.avi"
    path.write_bytes(_broken((tmp_path / "w.avi").read_bytes(), what))
    assert_equal_cv2(path, 14)


def _chunk(tag, data):
    return tag + struct.pack("<I", len(data)) + data + (b"\0" if len(data) & 1 else b"")


def _list(kind, *parts):
    body = kind + b"".join(parts)
    return b"LIST" + struct.pack("<I", len(body)) + body


def test_rec_lists_junk_and_odd_chunks(tmp_path):
    """Frames in 'rec ' lists beside JUNK chunks and an audio stream's
    chunks, odd sizes padded, no index; the video stream is the second."""
    frames = pan(48, 64, 5, seed=6)
    data = jpegs(frames)
    data = [d + b"\0" if len(d) % 2 == 0 else d for d in data]      # odd sizes
    assert all(len(d) % 2 for d in data)
    W, H, n = 64, 48, len(data)
    avih = struct.pack("<10I", 40000, 0, 0, 0x10, n, 0, 2, 0, W, H) + bytes(16)
    auds = _list(b"strl", _chunk(b"strh", b"auds" + bytes(4) + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, 8000, 0, 800, 0, 0, 1, 0, 0, 0, 0)),
        _chunk(b"strf", struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)))
    vids = _list(b"strl", _chunk(b"strh", b"vidsMJPG" + struct.pack(
        "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, 25, 0, n, 0, 0, 0, 0, 0, W, H)),
        _chunk(b"strf", struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG", W * H * 3,
                                    0, 0, 0, 0)))
    recs = []
    for k, d in enumerate(data):
        recs.append(_list(b"rec ", _chunk(b"00wb", bytes(160)), _chunk(b"JUNK", bytes(k + 1)),
                          _chunk(b"01dc", d)))
    body = b"AVI " + _list(b"hdrl", _chunk(b"avih", avih), auds, vids) + _chunk(
        b"JUNK", bytes(33)) + _list(b"movi", *recs)
    path = tmp_path / "rec.avi"
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    track = open_track(path)
    assert track.codec == "mjpeg" and len(track.samples) == n
    assert_equal_cv2(path, n)


def test_misnamed_and_upper_case_files_read_by_content(tmp_path):
    src = DATA / "video" / "mp4v.avi"
    for name in ("clip.AVI", "clip.mp4", "clip"):
        (tmp_path / name).write_bytes(src.read_bytes())
        got = list(video.get_video_frames(tmp_path / name, device="cpu"))
        assert all(np.array_equal(a, b) for a, b in zip(got, cv2_frames(src)))
        assert len(got) == 6
