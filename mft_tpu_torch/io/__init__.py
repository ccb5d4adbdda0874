"""Host-side I/O: PNG without OpenCV, the flowou codecs, the tiered flow cache.

Port of ``mft_tpu/io`` (reference MFT/utils/io.py) without its video
capture and writer, which need OpenCV (ROADMAP A11). The codecs' files are
the JAX package's, so the two packages read each other's caches and exports.
"""

from mft_tpu_torch.io.cache import FlowCache
from mft_tpu_torch.io.flowou_codecs import read_flowou, write_flowou

__all__ = ["read_flowou", "write_flowou", "FlowCache"]
