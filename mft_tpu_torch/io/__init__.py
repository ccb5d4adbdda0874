"""Host-side I/O: PNG without OpenCV, the flowou codecs, the tiered flow
cache, and video as PNG image directories.

Port of ``mft_tpu/io`` (reference MFT/utils/io.py). The codecs' files are
the JAX package's, so the two packages read each other's caches and exports.
Video files and JPEG frames need a codec the card's machine lacks
(ROADMAP A11): :mod:`mft_tpu_torch.io.video` raises ``NotImplementedError``
for them.
"""

from mft_tpu_torch.io.cache import FlowCache
from mft_tpu_torch.io.flowou_codecs import read_flowou, write_flowou
from mft_tpu_torch.io.video import (
    GeneralVideoCapture,
    LookaheadIter,
    VideoWriter,
    get_video_frames,
    get_video_length,
)

__all__ = [
    "read_flowou", "write_flowou", "FlowCache",
    "GeneralVideoCapture", "get_video_frames", "get_video_length",
    "VideoWriter", "LookaheadIter",
]
