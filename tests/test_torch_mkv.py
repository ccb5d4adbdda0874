"""The port's Matroska reader and writer, ``mft_tpu_torch/io/mkv.py``, against
cv2 (libavformat's Matroska demuxer and muxer) and the JAX package on the
CPU.

- The committed fixtures (the JAX package's ``mp4v`` writer, cv2's
  ``MJPG``) decode to cv2's frames; their frames equal cv2's raw packets.
- Files built here: a Segment and Clusters of unknown size,
  BlockGroup/Block, Xiph, EBML and fixed-size lacing, ``V_MS/VFW/FOURCC``,
  another TimestampScale and no DefaultDuration (the frame rate from the
  blocks), each read as cv2 reads it.
- The writer: cv2 reads the port's ``.mkv`` with the JAX writer's frame
  count and fps, to the port's own frames, at a PSNR no lower than cv2's
  writer's; CodecID ``V_MPEG4/ISO/ASP`` with the VOL in CodecPrivate and
  SimpleBlocks with the keyframe flag, as libavformat writes.
- WebM's VP8 and ContentEncodings raise naming their ROADMAP items.
"""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io import video as jax_video
from mft_tpu_torch.io import mkv, mpeg4, video
from mft_tpu_torch.io.container import open_track
from mft_tpu_torch.io.mkv import _el, _ebml_id, _u

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


UNKNOWN = bytes([0x01, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF])


def build(blocks, W, H, codec_id="V_MJPEG", private=b"", default=40000000, scale=1000000,
          unknown=False, doctype=b"matroska", extra_track=b""):
    """A Matroska file of one video track; ``blocks``: per Cluster a list of
    (element id, block payload after the track number, timestamp and flags
    are written here: (relative ms, flags, data))."""
    head = _el(0x1A45DFA3, _u(0x4286, 1) + _el(0x4282, doctype))
    info = _el(mkv.INFO, _u(mkv.TIMESTAMP_SCALE, scale))
    entry = (_u(mkv.TRACK_NUMBER, 1) + _u(mkv.TRACK_TYPE, 1) + _el(mkv.CODEC_ID, codec_id.encode())
             + (_u(mkv.DEFAULT_DURATION, default) if default else b"")
             + _el(mkv.VIDEO, _u(mkv.PIXEL_WIDTH, W) + _u(mkv.PIXEL_HEIGHT, H))
             + (_el(mkv.CODEC_PRIVATE, private) if private else b"") + extra_track)
    body = info + _el(mkv.TRACKS, _el(mkv.TRACK_ENTRY, entry))
    for start, cluster in blocks:
        kids = _u(mkv.TIMESTAMP, start)
        for eid, (t, flags, data) in cluster:
            blk = bytes([0x81]) + struct.pack(">hB", t, flags) + data
            kids += _el(mkv.SIMPLE_BLOCK, blk) if eid == mkv.SIMPLE_BLOCK else \
                _el(mkv.BLOCK_GROUP, _el(mkv.BLOCK, blk))
        body += (_ebml_id(mkv.CLUSTER) + UNKNOWN + kids) if unknown else _el(mkv.CLUSTER, kids)
    if unknown:
        return head + _ebml_id(mkv.SEGMENT) + UNKNOWN + body
    return head + _el(mkv.SEGMENT, body)


@pytest.mark.parametrize("name", ["mp4v.mkv", "mjpg.mkv"])
def test_fixture_frames_equal_cv2(name):
    path = DATA / "video" / name
    assert_equal_cv2(path, 6)
    track = open_track(path)
    assert track.fps == 25.0 and list(track.read_samples()) == cv2_packets(path)
    assert all(np.array_equal(a, b) for a, b in zip(
        video.get_video_frames(path, device="cpu"), jax_video.get_video_frames(path)))


@pytest.mark.parametrize("unknown", [False, True])
@pytest.mark.parametrize("kind", ["simple", "group"])
def test_block_kinds_and_unknown_sizes(tmp_path, kind, unknown):
    data = jpegs(pan(32, 48, 6, seed=1))
    eid = mkv.SIMPLE_BLOCK if kind == "simple" else mkv.BLOCK_GROUP
    clusters = [(0, [(eid, (40 * k, 0x80, d)) for k, d in enumerate(data[:3])]),
                (120, [(eid, (40 * k, 0x80, d)) for k, d in enumerate(data[3:])])]
    path = tmp_path / "b.mkv"
    path.write_bytes(build(clusters, 48, 32, unknown=unknown))
    assert_equal_cv2(path, 6)


def _laced(frames, lacing):
    n = len(frames)
    if lacing == 1:
        head = b""
        for f in frames[:-1]:
            s = len(f)
            head += b"\xff" * (s // 255) + bytes([s % 255])
    elif lacing == 3:
        sizes = [len(f) for f in frames]
        head = (0x4000 | sizes[0]).to_bytes(2, "big")
        for a, b in zip(sizes[:-2], sizes[1:-1]):
            head += ((b - a) + 0x1FFF | 0x4000).to_bytes(2, "big")
    else:
        head = b""
    return bytes([n - 1]) + head + b"".join(frames)


@pytest.mark.parametrize("lacing", [1, 3, 2])
def test_lacing_equal_cv2(tmp_path, lacing):
    frames = pan(32, 48, 6, seed=2)
    data = jpegs(frames)
    if lacing == 2:                      # fixed: frames of one size
        data = [d + bytes(max(map(len, data)) - len(d)) for d in data]
    block = _laced(data[:4], lacing)
    clusters = [(0, [(mkv.SIMPLE_BLOCK, (0, 0x80 | lacing << 1, block)),
                     (mkv.SIMPLE_BLOCK, (160, 0x80, data[4])),
                     (mkv.SIMPLE_BLOCK, (200, 0x80, data[5]))])]
    path = tmp_path / "l.mkv"
    path.write_bytes(build(clusters, 48, 32))
    assert len(open_track(path).samples) == 6
    assert_equal_cv2(path, 6)


def test_vfw_fourcc_and_frame_rate_from_blocks(tmp_path):
    """V_MS/VFW/FOURCC with a BITMAPINFOHEADER of tag MJPG, a TimestampScale
    of 100 us and no DefaultDuration: blocks every 400 ticks, 25 fps."""
    data = jpegs(pan(32, 48, 5, seed=3))
    bih = struct.pack("<IiiHH4sIiiII", 40, 48, 32, 1, 24, b"MJPG", 48 * 32 * 3, 0, 0, 0, 0)
    clusters = [(0, [(mkv.SIMPLE_BLOCK, (400 * k, 0x80, d)) for k, d in enumerate(data)])]
    path = tmp_path / "v.mkv"
    path.write_bytes(build(clusters, 48, 32, codec_id="V_MS/VFW/FOURCC", private=bih,
                           default=0, scale=100000))
    track = open_track(path)
    assert (track.codec, track.fourcc, track.fps) == ("mjpeg", "MJPG", 25.0)
    assert track.fps == cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FPS)
    assert_equal_cv2(path, 5)


def test_writer_layout_as_libavformat(tmp_path):
    frames = pan(32, 48, 14, seed=4)
    with video.VideoWriter(tmp_path / "w.mkv", fps=25.0, device="cpu") as w:
        for f in frames:
            w.write(f)
    path = tmp_path / "w.mkv"
    data = path.read_bytes()
    assert data[:4] == b"\x1a\x45\xdf\xa3" and b"matroska" in data[:40]
    track = open_track(path)
    assert (track.codec, track.fourcc, track.fps) == ("mpeg4", "V_MPEG4/ISO/ASP", 25.0)
    assert track.config == mpeg4.write_config(mpeg4.Vol(48, 32, 25))
    assert track.samples[:, 2].tolist() == [int(k % 12 == 0) for k in range(14)]
    assert list(track.read_samples()) == cv2_packets(path)
    assert data.count(_ebml_id(mkv.CLUSTER)) == 2        # a Cluster at each keyframe


@pytest.mark.parametrize("fps", [25.0, 29.97, 10.0])
def test_writer_files_open_in_cv2(tmp_path, fps):
    frames = pan(48, 64, 14, seed=5)
    with video.VideoWriter(tmp_path / "port.mkv", fps=fps, device="cpu") as w:
        for f in frames:
            w.write(f)
    with jax_video.VideoWriter(tmp_path / "cv2.mkv", fps=fps) as w:
        for f in frames:
            w.write(f)
    mine, theirs = cv2.VideoCapture(str(tmp_path / "port.mkv")), cv2.VideoCapture(
        str(tmp_path / "cv2.mkv"))
    for prop in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_WIDTH,
                 cv2.CAP_PROP_FRAME_HEIGHT):
        assert mine.get(prop) == theirs.get(prop)
    got = list(video.get_video_frames(tmp_path / "port.mkv", device="cpu"))
    assert_equal_cv2(tmp_path / "port.mkv", len(frames))
    ref = cv2_frames(tmp_path / "cv2.mkv")
    psnr = lambda a: 10 * np.log10(255.0 ** 2 / np.mean(  # noqa: E731
        [(x.astype(np.float64) - y) ** 2 for x, y in zip(frames, a)]))
    assert psnr(got) >= psnr(ref)


def test_webm_vp8_and_content_encodings_raise(tmp_path):
    clusters = [(0, [(mkv.SIMPLE_BLOCK, (0, 0x80, b"\x00" * 16))])]
    (tmp_path / "v.webm").write_bytes(build(clusters, 48, 32, codec_id="V_VP8",
                                            doctype=b"webm"))
    with pytest.raises(NotImplementedError, match="'V_VP8' in Matroska.*A11, other codecs"):
        video.GeneralVideoCapture(tmp_path / "v.webm", device="cpu")
    enc = _el(mkv.CONTENT_ENCODINGS, _el(0x6240, _u(0x5031, 0)))
    (tmp_path / "c.mkv").write_bytes(build(clusters, 48, 32, extra_track=enc))
    with pytest.raises(NotImplementedError, match="ContentEncodings.*A11, other containers"):
        video.GeneralVideoCapture(tmp_path / "c.mkv", device="cpu")
