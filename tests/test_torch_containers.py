"""What the video containers share, ``mft_tpu_torch/io/container.py``, and
the writer at every suffix, against cv2 and the JAX package on the CPU.

- The reader is picked by a file's first bytes, as libavformat probes, not
  by its suffix: a file misnamed or in upper case reads as in JAX.
- ``VideoWriter`` at each suffix the JAX package's writer takes
  (``.mp4``, ``.mov``, ``.m4v``, ``.3gp``, ``.avi``, ``.mkv``, in either
  case): cv2 reads the file with the JAX writer's frame count, fps and
  size, to the port's own frames, at a PSNR no lower than cv2's writer's;
  the ``ftyp`` brands and QuickTime's handler boxes are cv2's.
- The suffixes cv2 also takes (``.mpg``, ``.ts``, ``.asf``, ``.nut``) and
  unknown containers raise naming "A11, other containers".
"""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io import video as jax_video
from mft_tpu_torch.io import container, video

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


def pan(H, W, n=14, seed=0):
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((2 * H, 2 * W, 3)) * 255).astype(np.uint8), (0, 0), 2)
    return [np.ascontiguousarray(big[2 * t:2 * t + H, 3 * t:3 * t + W]) for t in range(n)]


def _psnr(frames, got):
    mse = np.mean([(a.astype(np.float64) - b) ** 2 for a, b in zip(frames, got)])
    return 10 * np.log10(255.0 ** 2 / mse)


SUFFIXES = [".mp4", ".mov", ".m4v", ".3gp", ".avi", ".mkv", ".MOV", ".Mkv"]


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_writer_at_every_suffix_reads_as_the_jax_writers(tmp_path, suffix):
    frames = pan(48, 64, seed=len(suffix))
    port, jax = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    with video.VideoWriter(port, fps=29.97, device="cpu") as w:
        for f in frames:
            w.write(f)
    with jax_video.VideoWriter(jax, fps=29.97) as w:
        for f in frames:
            w.write(f)
    mine, theirs = cv2.VideoCapture(str(port)), cv2.VideoCapture(str(jax))
    for prop in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS, cv2.CAP_PROP_FRAME_WIDTH,
                 cv2.CAP_PROP_FRAME_HEIGHT):
        assert mine.get(prop) == theirs.get(prop), prop
    got = list(video.get_video_frames(port, device="cpu"))
    want = cv2_frames(port)
    assert len(got) == len(want) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert video.get_video_length(port, device="cpu") == len(frames)
    assert _psnr(frames, got) >= _psnr(frames, cv2_frames(jax))


@pytest.mark.parametrize("suffix", [".mp4", ".mov", ".m4v", ".3gp"])
def test_iso_brands_and_quicktime_boxes_are_cv2s(tmp_path, suffix):
    frames = pan(32, 48, 2, seed=1)
    port, jax = tmp_path / f"p{suffix}", tmp_path / f"j{suffix}"
    with video.VideoWriter(port, fps=25.0, device="cpu") as w:
        for f in frames:
            w.write(f)
    with jax_video.VideoWriter(jax, fps=25.0) as w:
        for f in frames:
            w.write(f)
    mine, theirs = port.read_bytes(), jax.read_bytes()
    size = struct.unpack(">I", theirs[:4])[0]
    assert mine[:size] == theirs[:size]                 # ftyp
    for box in (b"wide", b"mhlr", b"dhlr", b"FFMP"):
        assert (box in mine) == (box in theirs), box


@pytest.mark.parametrize("suffix", [".mpg", ".ts", ".asf", ".nut", ".webm"])
def test_other_writer_suffixes_raise(tmp_path, suffix):
    assert cv2.VideoWriter(str(tmp_path / f"c{suffix}"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                           (32, 32)).isOpened() == (suffix != ".webm")
    w = video.VideoWriter(tmp_path / f"x{suffix}", device="cpu")
    with pytest.raises(NotImplementedError, match="A11, other containers"):
        w.write(np.zeros((32, 32, 3), np.uint8))


@pytest.mark.parametrize("name,kind", [("mp4v.avi", "avi"), ("mjpg.mkv", "mkv"),
                                       ("mjpg.mp4", "mp4"), ("mjpg.mov", "mp4")])
def test_probe_by_content(tmp_path, name, kind):
    src = DATA / "video" / name
    assert container.probe(src) == kind
    for other in ("clip.mp4", "clip.avi", "CLIP.MKV", "clip.bin"):
        (tmp_path / other).write_bytes(src.read_bytes())
        assert container.probe(tmp_path / other) == kind
        got = list(video.get_video_frames(tmp_path / other, device="cpu"))
        assert all(np.array_equal(a, b) for a, b in zip(got, cv2_frames(src)))
        assert len(got) == 6


def test_unknown_containers_raise(tmp_path):
    (tmp_path / "x.mpg").write_bytes(b"\x00\x00\x01\xba" + bytes(60))
    (tmp_path / "y.avi").write_bytes(b"RIFF" + bytes(60))
    for name in ("x.mpg", "y.avi"):
        with pytest.raises(NotImplementedError, match="A11, other containers"):
            video.GeneralVideoCapture(tmp_path / name, device="cpu")
