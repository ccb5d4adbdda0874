"""Video input/output over image directories: frame generators and a writer.

A copy of ``mft_tpu/io/video.py`` (reference MFT/utils/io.py:566-615 and
vis_utils.py:621-658) without OpenCV. Frames are (H, W, 3) uint8 BGR, as
``cv2.imread`` gives them; PNGs go through :mod:`mft_tpu_torch.io.png`.

Differences by design (ROADMAP A11): the card's machine has no video or JPEG
codec, so a video file, a ``.jpg``/``.jpeg`` frame and a writer for a path
with a suffix (``.mp4``) raise ``NotImplementedError``; a writer for a path
without a suffix writes numbered PNG frames (``00000.png``, ...) where the
JAX package writes JPEGs.
"""

from collections import deque
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.png import encode_png, imread

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png"}


def _no_codec(what):
    return NotImplementedError(
        f"{what}: the port reads and writes PNG image directories only; video "
        "files and JPEG need a codec (OpenCV's), which the card's machine lacks "
        "(ROADMAP A11)")


class GeneralVideoCapture:
    """A directory of images read as a video, in sorted file-name order
    (reversed with ``reverse``); ``read()`` as ``cv2.VideoCapture.read``."""

    def __init__(self, path, reverse=False):
        path = Path(path)
        self.image_inputs = path.is_dir()
        if not self.image_inputs:
            raise _no_codec(f"video file {path}")
        self.path = path
        self.images = sorted(p for p in path.iterdir()
                             if p.suffix.lower() in IMAGE_SUFFIXES)
        if reverse:
            self.images = self.images[::-1]
        self.i = 0

    def read(self):
        if self.i >= len(self.images):
            return False, None
        image = self.images[self.i]
        if image.suffix.lower() != ".png":
            raise _no_codec(f"JPEG frame {image}")
        self.frame_src = image.name
        img = imread(image)
        self.i += 1
        return True, img

    def release(self):
        pass


def get_video_frames(path, reverse=False):
    """Generator of (H, W, 3) uint8 BGR frames."""
    cap = GeneralVideoCapture(path, reverse=reverse)
    try:
        while True:
            ok, frame = cap.read()
            if not ok or frame is None:
                return
            yield frame
    finally:
        cap.release()


def get_video_length(path):
    return sum(1 for _ in get_video_frames(path))


class VideoWriter:
    """Image-sequence writer for visualizations: ``path`` without a suffix
    is a directory that receives ``00000.png``, ``00001.png``, ..."""

    def __init__(self, path, fps=25.0):
        self.path = Path(path)
        self.fps = fps
        if self.path.suffix != "":
            raise _no_codec(f"video writer for {self.path}")
        self.path.mkdir(parents=True, exist_ok=True)
        self.i = 0

    def write(self, frame):
        """frame: (H, W, 3) uint8 BGR."""
        (self.path / f"{self.i:05d}.png").write_bytes(encode_png(np.asarray(frame)))
        self.i += 1

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LookaheadIter:
    """Iterator wrapper with non-consuming peek/lookahead (reference
    MFT/utils/io.py:64-87): inspect upcoming frames without advancing the
    decode position."""

    def __init__(self, it):
        self._iter = iter(it)
        self._ahead = deque()

    def __iter__(self):
        return self

    def __next__(self):
        if self._ahead:
            return self._ahead.popleft()
        return next(self._iter)

    def lookahead(self):
        for x in self._ahead:
            yield x
        for x in self._iter:
            self._ahead.append(x)
            yield x

    def peek(self, *default):
        return next(iter(self.lookahead()), *default)
