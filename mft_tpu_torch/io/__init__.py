"""I/O: PNG and JPEG without OpenCV or PIL, an image reader in
``cv2.imread``'s role, the flowou codecs, the tiered flow cache, and video
as PNG/JPEG image directories.

Port of ``mft_tpu/io`` (reference MFT/utils/io.py). The codecs' files are
the JAX package's, so the two packages read each other's caches and exports.
JPEG runs the port's codec (:mod:`mft_tpu_torch.io.jpeg`: entropy coding on
host threads, the pixel stages on the card). Video files need a codec the
card's machine lacks (ROADMAP A11): :mod:`mft_tpu_torch.io.video` raises
``NotImplementedError`` for them.
"""

from mft_tpu_torch.io.cache import FlowCache
from mft_tpu_torch.io.flowou_codecs import read_flowou, write_flowou
from mft_tpu_torch.io.image import imdecode, imread
from mft_tpu_torch.io.jpeg import decode_jpeg, decode_jpeg_frames, encode_jpeg, jpeg_roundtrip
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
    "GeneralVideoCapture", "get_video_frames", "get_video_length",
    "VideoWriter", "LookaheadIter",
]
