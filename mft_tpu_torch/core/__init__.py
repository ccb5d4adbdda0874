"""Core numerics: device choice, coordinate grids, bilinear sampling, FlowOU.

Channel-last at the public functions, as in ``mft_tpu.core``: a dense map is
(H, W, C), a flow (H, W, 2) with (dx, dy) last, occlusion and sigma (H, W).
"""

from mft_tpu_torch.core.coords import grid_coords
from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.core.flowou import FlowOU, identity_flowou, invalid_mask
from mft_tpu_torch.core.interp import bilinear_sample

__all__ = [
    "grid_coords",
    "resolve_device",
    "FlowOU",
    "identity_flowou",
    "invalid_mask",
    "bilinear_sample",
]
