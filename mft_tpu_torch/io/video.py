"""Video input/output: video files and image directories, frame generators and
a writer.

A copy of ``mft_tpu/io/video.py`` (reference MFT/utils/io.py:566-615 and
vis_utils.py:621-658) without OpenCV. Frames are (H, W, 3) uint8 BGR, as
``cv2.VideoCapture.read`` / ``cv2.imread`` give them.

- A video file is read through the container that its first bytes name,
  whatever its suffix, as libavformat probes (:mod:`mft_tpu_torch.io.container`):
  MP4/QuickTime (:mod:`.mp4`), AVI (:mod:`.avi`, OpenDML too) or Matroska
  (:mod:`.mkv`). Its first video track's codec picks the decoder: MPEG-4
  Part 2 (:mod:`mft_tpu_torch.io.mpeg4`: V1 on the host, V2 on the card
  for a CUDA ``device``) or Motion JPEG (:mod:`mft_tpu_torch.io.mjpeg`: J1
  on the host, J4 on the card), each as cv2's libavcodec decodes it.
  Another codec (``avc1`` ...) or container (``.mpg``, ``.ts`` ...) raises
  ``NotImplementedError`` naming its ROADMAP item.
- PNG and JPEG frames of a directory go through
  :func:`mft_tpu_torch.io.image.imread` (a JPEG through the port's codec,
  :mod:`mft_tpu_torch.io.jpeg`).
- A writer for a path with the suffix ``.mp4``, ``.mov``, ``.m4v``,
  ``.3gp``, ``.avi`` or ``.mkv`` (any case) writes an ``mp4v`` track (V3 and
  V2 on the card, V1 on the host) at the given fps into that container, as
  the JAX package's ``cv2.VideoWriter`` with fourcc ``mp4v``; its bytes
  are the port's own, not libavcodec's. Other suffixes that cv2 opens
  (``.mpg``, ``.ts``, ``.asf``, ``.nut``) raise naming "A11, other
  containers". A path without a suffix receives ``00000.jpg``,
  ``00001.jpg``, ... at quality 95 (``cv2.imwrite``'s default), through J3
  and J1.
"""

from collections import deque
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.container import MJPEG, open_track
from mft_tpu_torch.io.image import imread
from mft_tpu_torch.io.jpeg import encode_jpeg
from mft_tpu_torch.io.mjpeg import decode_mjpeg_frames
from mft_tpu_torch.io.mpeg4 import Mp4vEncoder, decode_frames, find_vop, parse_config, vop_coded

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png"}


class GeneralVideoCapture:
    """A video file or a directory of images read as a video (images in
    sorted file-name order, reversed with ``reverse``; a file's frames in
    its order, as the JAX package's); ``read()`` as
    ``cv2.VideoCapture.read``. ``device`` runs the codecs' card stages."""

    def __init__(self, path, reverse=False, device="cuda"):
        path = Path(path)
        self.device = device
        self.image_inputs = path.is_dir()
        self.path = path
        if not self.image_inputs:
            self.video = open_track(path)
            decode = decode_mjpeg_frames if self.video.codec == MJPEG else decode_frames
            self.frames = decode(self.video, device)
            return
        self.images = sorted(p for p in path.iterdir()
                             if p.suffix.lower() in IMAGE_SUFFIXES)
        if reverse:
            self.images = self.images[::-1]
        self.i = 0

    def read(self):
        if not self.image_inputs:
            frame = next(self.frames, None)
            return frame is not None, frame
        if self.i >= len(self.images):
            return False, None
        image = self.images[self.i]
        self.frame_src = image.name
        img = imread(image, self.device)
        self.i += 1
        return True, img

    def release(self):
        if not self.image_inputs:
            self.frames.close()


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
    """The number of frames: an MPEG-4 track's coded VOPs that its edit list
    shows (no pixels decoded), a Motion JPEG track's non-empty samples
    shown, an image directory's images."""
    path = Path(path)
    if path.is_dir():
        return sum(1 for _ in get_video_frames(path, device=device))
    video = open_track(path)
    if video.codec == MJPEG:
        return int(sum(shown and size > 0 for shown, size in zip(video.shown(),
                                                                 video.samples[:, 1])))
    vol = parse_config(video.config) if video.config else None
    n = 0
    for shown, data in zip(video.shown(), video.read_samples()):
        if not data:
            continue
        new_vol = find_vop(data, vol)[1]
        vol = new_vol or vol
        if vol is None:
            raise ValueError("MPEG-4 stream without a VOL header")
        n += bool(shown and vop_coded(data, vol))
    return n


class VideoWriter:
    """Writer for visualizations: ``path`` with a suffix of
    :data:`mft_tpu_torch.io.container.WRITER_SUFFIXES` is a file of that
    container with one ``mp4v`` track at ``fps`` (the port's encoder,
    :class:`mft_tpu_torch.io.mpeg4.Mp4vEncoder`, for ``device``); ``path``
    without a suffix is a directory that receives ``00000.jpg``,
    ``00001.jpg``, ... (JPEG at quality 95, encoded for ``device``). As in
    the JAX package, the file is opened at the first frame: another suffix
    raises there."""

    def __init__(self, path, fps=25.0, device="cuda"):
        self.path = Path(path)
        self.fps = fps
        self.device = device
        self.encoder = None
        self.image_dir = self.path.suffix == ""
        if self.image_dir:
            self.path.mkdir(parents=True, exist_ok=True)
            self.i = 0
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, frame):
        """frame: (H, W, 3) uint8 BGR."""
        frame = np.asarray(frame)
        if self.image_dir:
            (self.path / f"{self.i:05d}.jpg").write_bytes(encode_jpeg(frame, 95, self.device))
            self.i += 1
            return
        if self.encoder is None:
            H, W = frame.shape[:2]
            self.encoder = Mp4vEncoder(self.path, self.fps, W, H, self.device)
        self.encoder.write(frame)

    def close(self):
        if self.encoder is not None:
            self.encoder.close()
            self.encoder = None

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
