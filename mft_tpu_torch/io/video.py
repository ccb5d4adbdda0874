"""Video input/output over image directories: frame generators and a writer.

A copy of ``mft_tpu/io/video.py`` (reference MFT/utils/io.py:566-615 and
vis_utils.py:621-658) without OpenCV. Frames are (H, W, 3) uint8 BGR, as
``cv2.imread`` gives them: PNG and JPEG frames go through
:func:`mft_tpu_torch.io.image.imread` (a JPEG through the port's codec,
:mod:`mft_tpu_torch.io.jpeg`: J1 on host threads and J2 on the card for a
CUDA ``device``). A writer for a path without a suffix writes
``00000.jpg``, ``00001.jpg``, ... at quality 95 (``cv2.imwrite``'s
default), as the JAX package does, through J3 and J1.

Difference by design (ROADMAP A11): the card's machine has no video codec,
so a video file and a writer for a path with a suffix (``.mp4``) raise
``NotImplementedError``.
"""

from collections import deque
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.image import imread
from mft_tpu_torch.io.jpeg import encode_jpeg

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png"}


def _no_codec(what):
    return NotImplementedError(
        f"{what}: the port reads and writes image directories only; video files "
        "need a video codec (OpenCV's), which the card's machine lacks (ROADMAP A11)")


class GeneralVideoCapture:
    """A directory of images read as a video, in sorted file-name order
    (reversed with ``reverse``); ``read()`` as ``cv2.VideoCapture.read``.
    ``device`` decodes JPEG frames."""

    def __init__(self, path, reverse=False, device="cuda"):
        path = Path(path)
        self.device = device
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
        self.frame_src = image.name
        img = imread(image, self.device)
        self.i += 1
        return True, img

    def release(self):
        pass


def get_video_frames(path, reverse=False, device="cuda"):
    """Generator of (H, W, 3) uint8 BGR frames."""
    cap = GeneralVideoCapture(path, reverse=reverse, device=device)
    try:
        while True:
            ok, frame = cap.read()
            if not ok or frame is None:
                return
            yield frame
    finally:
        cap.release()


def get_video_length(path, device="cuda"):
    return sum(1 for _ in get_video_frames(path, device=device))


class VideoWriter:
    """Image-sequence writer for visualizations: ``path`` without a suffix
    is a directory that receives ``00000.jpg``, ``00001.jpg``, ... (JPEG at
    quality 95, encoded for ``device``)."""

    def __init__(self, path, fps=25.0, device="cuda"):
        self.path = Path(path)
        self.fps = fps
        self.device = device
        if self.path.suffix != "":
            raise _no_codec(f"video writer for {self.path}")
        self.path.mkdir(parents=True, exist_ok=True)
        self.i = 0

    def write(self, frame):
        """frame: (H, W, 3) uint8 BGR."""
        (self.path / f"{self.i:05d}.jpg").write_bytes(
            encode_jpeg(np.asarray(frame), 95, self.device))
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
