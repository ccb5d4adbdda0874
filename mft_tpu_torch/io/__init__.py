"""I/O: PNG and JPEG without OpenCV or PIL, an image reader in
``cv2.imread``'s role, the flowou codecs, the tiered flow cache, and video:
MP4/QuickTime, AVI and Matroska files with MPEG-4 Part 2 or Motion JPEG
video, and PNG/JPEG image directories.

Port of ``mft_tpu/io`` (reference MFT/utils/io.py). The codecs' files are
the JAX package's, so the two packages read each other's caches and exports.
JPEG runs the port's codec (:mod:`mft_tpu_torch.io.jpeg`: entropy coding on
host threads, the pixel stages on the card); ``mp4v`` video its own
(:mod:`mft_tpu_torch.io.mpeg4`: the VLC stage on host threads, the pixel
stages on the card), Motion JPEG video J1 and its own pixel stage J4
(:mod:`mft_tpu_torch.io.mjpeg`). The containers are read and written by
:mod:`mft_tpu_torch.io.mp4`, :mod:`mft_tpu_torch.io.avi` and
:mod:`mft_tpu_torch.io.mkv`; :mod:`mft_tpu_torch.io.container` picks the
reader by a file's first bytes and the writer by its suffix. Other video
codecs and containers raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from mft_tpu_torch.io.cache import FlowCache
from mft_tpu_torch.io.flowou_codecs import read_flowou, write_flowou
from mft_tpu_torch.io.image import imdecode, imread
from mft_tpu_torch.io.jpeg import decode_jpeg, decode_jpeg_frames, encode_jpeg, jpeg_roundtrip
from mft_tpu_torch.io.avi import AviWriter, read_avi
from mft_tpu_torch.io.container import open_track, open_writer
from mft_tpu_torch.io.mjpeg import decode_mjpeg_frames
from mft_tpu_torch.io.mkv import MkvWriter, read_mkv
from mft_tpu_torch.io.mp4 import Mp4Writer, read_mp4
from mft_tpu_torch.io.mpeg4 import Mp4vEncoder, decode_frames
from mft_tpu_torch.io.video import (
    GeneralVideoCapture,
    LookaheadIter,
    VideoWriter,
    get_video_frames,
    get_video_length,
)

__all__ = [
    "read_flowou", "write_flowou", "FlowCache", "imread", "imdecode",
    "decode_jpeg", "decode_jpeg_frames", "encode_jpeg", "jpeg_roundtrip",
    "read_mp4", "Mp4Writer", "decode_frames", "Mp4vEncoder", "read_avi", "AviWriter",
    "read_mkv", "MkvWriter", "open_track", "open_writer", "decode_mjpeg_frames",
    "GeneralVideoCapture", "get_video_frames", "get_video_length",
    "VideoWriter", "LookaheadIter",
]
