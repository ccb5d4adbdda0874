"""The port's MP4 (ISO-BMFF) reader and writer, ``mft_tpu_torch/io/mp4.py``,
and the video entry points over it, against cv2 and the JAX package.

- Each committed fixture's samples (JAX's ``VideoWriter``, cv2) equal
  cv2's raw packets (``CAP_PROP_FORMAT`` -1), with ``moov`` last as cv2
  writes it and moved first (offsets rewritten).
- ``get_video_frames`` / ``get_video_length`` give the JAX package's frame
  counts, and its frames on the CPU cv2's BGR frames.
- The port's writer: cv2 opens its files with the right frame count, fps
  and size, decodes them to the port's own frames, and their PSNR is no
  lower than cv2's writer's on the same frames; ``co64`` past 2**32.
- Other codecs and containers raise ``NotImplementedError`` naming their
  ROADMAP item.
"""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io import video as jax_video
from mft_tpu_torch.io import mp4, mpeg4, video

FIXTURES = Path(__file__).parent / "data" / "torch_fixtures" / "mp4v"
NAMES = ("pan", "noise", "still", "odd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _top_boxes(data):
    out, off = [], 0
    while off < len(data):
        size, typ = struct.unpack(">I4s", data[off:off + 8])
        if size == 1:
            size = struct.unpack(">Q", data[off + 8:off + 16])[0]
        out.append((typ, data[off:off + size]))
        off += size
    return out


def _shift_chunks(box, delta):
    """A box with every stco entry inside it moved by ``delta``."""
    out = bytearray(box)
    i = out.find(b"stco")
    while i >= 0:
        n = struct.unpack(">I", out[i + 8:i + 12])[0]
        for k in range(n):
            p = i + 12 + 4 * k
            out[p:p + 4] = struct.pack(">I", struct.unpack(">I", out[p:p + 4])[0] + delta)
        i = out.find(b"stco", i + 4)
    return bytes(out)


def moov_first(src, dst):
    """cv2's file rewritten with ``moov`` before ``mdat`` (a faststart file)."""
    boxes = _top_boxes(src.read_bytes())
    moov = [b for t, b in boxes if t == b"moov"][0]
    rest = [b for t, b in boxes if t != b"moov"]
    head = rest[0]
    dst.write_bytes(head + _shift_chunks(moov, len(moov)) + b"".join(rest[1:]))
    return dst


def cv2_packets(path):
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            return out
        out.append(p.ravel().tobytes())


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_samples_equal_cv2_packets(tmp_path, name, first):
    path = FIXTURES / f"{name}.mp4"
    if first:
        path = moov_first(path, tmp_path / "first.mp4")
        assert [t for t, _ in _top_boxes(path.read_bytes())][1] == b"moov"
    video_file = mp4.read_mp4(path)
    assert video_file.fourcc == "mp4v" and video_file.fps == 25.0
    samples = list(video_file.read_samples())
    assert samples == cv2_packets(path)
    vol = mpeg4.parse_config(video_file.config)
    assert (vol.width, vol.height) == (video_file.width, video_file.height)
    kinds = [mpeg4.BitReader(d, 8 * mpeg4.find_vop(d, vol)[0]).read(2) for d in samples]
    assert video_file.samples[:, 2].tolist() == [int(k == mpeg4.I_VOP) for k in kinds]


@pytest.mark.parametrize("name", NAMES)
def test_frames_and_length_match_jax(name):
    path = FIXTURES / f"{name}.mp4"
    got = list(video.get_video_frames(path, device="cpu"))
    want = list(jax_video.get_video_frames(path))
    assert len(got) == len(want) == 26
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert video.get_video_length(path, device="cpu") == jax_video.get_video_length(path) == 26
    cap = video.GeneralVideoCapture(path, device="cpu")
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == want[0].shape


@pytest.mark.parametrize("close", ["generator", "capture"])
def test_reader_stops_decoding_when_closed(monkeypatch, close):
    """A reader closed after one frame decodes no VOP after it: V1 ran once
    (the first VOP is a shown I-VOP), nothing is left running."""
    from mft_tpu_torch.ops import mpeg4 as OM
    calls = []

    def counted(data, vol):
        calls.append(len(data))
        return mpeg4.vlc_decode_ref(data, vol)

    monkeypatch.setattr(OM, "vlc_decode_ref", counted)
    path = FIXTURES / "pan.mp4"
    if close == "generator":
        frames = video.get_video_frames(path, device="cpu")
        first = next(frames)
        frames.close()
    else:
        cap = video.GeneralVideoCapture(path, device="cpu")
        first = cap.read()[1]
        cap.release()
        assert cap.read() == (False, None)
    assert first.shape == (64, 96, 3) and len(calls) == 1


def _scene(kind, H, W, n=14, seed=0):
    rng = np.random.default_rng(seed)
    tex = cv2.GaussianBlur((rng.random((H + 2 * n, W + 2 * n, 3)) * 255).astype(np.uint8),
                           (0, 0), 2.0)
    if kind == "pan":
        return [np.ascontiguousarray(tex[k:k + H, 2 * k:2 * k + W]) for k in range(n)]
    frames = []
    for k in range(n):
        f = np.ascontiguousarray(tex[:H, :W])
        f[4 + k:12 + k, 6 + k:14 + k] = 255 - f[4 + k:12 + k, 6 + k:14 + k]
        frames.append(f)
    return frames


def _psnr(frames, got):
    mse = np.mean([(a.astype(np.float64) - b) ** 2 for a, b in zip(frames, got)])
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("kind,H,W,fps", [("pan", 48, 64, 25.0), ("still", 40, 72, 29.97),
                                          ("pan", 64, 96, 10.0)])
def test_writer_files_open_in_cv2(tmp_path, kind, H, W, fps):
    """cv2 reads the port's file with its frame count, fps and size, to the
    port's own decode of it; its PSNR is no lower than cv2's writer's."""
    frames = _scene(kind, H, W)
    with video.VideoWriter(tmp_path / "port.mp4", fps=fps, device="cpu") as w:
        for f in frames:
            w.write(f)
    with jax_video.VideoWriter(tmp_path / "cv2.mp4", fps=fps) as w:
        for f in frames:
            w.write(f)
    cap = cv2.VideoCapture(str(tmp_path / "port.mp4"))
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == len(frames)
    assert abs(cap.get(cv2.CAP_PROP_FPS) - fps) < 1e-9
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (W, H)
    theirs = list(jax_video.get_video_frames(tmp_path / "port.mp4"))
    mine = list(video.get_video_frames(tmp_path / "port.mp4", device="cpu"))
    assert len(theirs) == len(mine) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(theirs, mine))
    ref = list(jax_video.get_video_frames(tmp_path / "cv2.mp4"))
    assert _psnr(frames, mine) >= _psnr(frames, ref)
    assert video.get_video_length(tmp_path / "port.mp4", device="cpu") == len(frames)


def test_chunk_offsets_past_4gb_use_co64(tmp_path):
    w = mp4.Mp4Writer(tmp_path / "big.mp4", 25.0, 16, 16, b"\x00\x00\x01\xb0\x01")
    w.offsets, w.sizes, w.sync = [40, (1 << 32) + 7], [5, 6], [True, False]
    w.f.write(bytes(11))
    w.close()
    video_file = mp4.read_mp4(tmp_path / "big.mp4")
    assert b"co64" in (tmp_path / "big.mp4").read_bytes()
    assert video_file.samples[:, 0].tolist() == [40, (1 << 32) + 7]
    assert video_file.samples[:, 1].tolist() == [5, 6]
    assert video_file.samples[:, 2].tolist() == [1, 0]


def test_other_codecs_and_containers_raise(tmp_path):
    data = (FIXTURES / "pan.mp4").read_bytes()
    i = data.index(b"mp4v", data.index(b"stsd"))
    (tmp_path / "h264.mp4").write_bytes(data[:i] + b"avc1" + data[i + 4:])
    with pytest.raises(NotImplementedError, match="A11, H.264"):
        video.GeneralVideoCapture(tmp_path / "h264.mp4", device="cpu")
    (tmp_path / "clip.avi").write_bytes(b"RIFF")
    with pytest.raises(NotImplementedError, match="A11, other containers"):
        video.GeneralVideoCapture(tmp_path / "clip.avi", device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        video.VideoWriter(tmp_path / "out.ts", device="cpu").write(np.zeros((16, 16, 3), np.uint8))
