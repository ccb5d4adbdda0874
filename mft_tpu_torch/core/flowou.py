"""FlowOU: the (flow, occlusion, sigma) value type.

Layout of ``mft_tpu.core.flowou.FlowOU``: flow (H, W, 2), occlusion (H, W)
in [0, 1], sigma (H, W) >= 0; a stacked candidate axis may lead.
"""

import dataclasses

import torch

from mft_tpu_torch.core.coords import grid_coords


@dataclasses.dataclass(frozen=True)
class FlowOU:
    """Dense flow field with per-pixel occlusion probability and sigma."""

    flow: torch.Tensor
    occlusion: torch.Tensor
    sigma: torch.Tensor


def identity_flowou(shape, device=None, dtype=torch.float32) -> FlowOU:
    """Zero-motion, zero-occlusion, zero-sigma FlowOU of spatial ``shape``."""
    H, W = shape
    return FlowOU(flow=torch.zeros((H, W, 2), device=device, dtype=dtype),
                  occlusion=torch.zeros((H, W), device=device, dtype=dtype),
                  sigma=torch.zeros((H, W), device=device, dtype=dtype))


def invalid_mask(flow: torch.Tensor) -> torch.Tensor:
    """(H, W) bool mask of flows whose endpoint leaves [0, W) x [0, H)."""
    H, W = flow.shape[-3], flow.shape[-2]
    end = grid_coords(H, W, device=flow.device) + flow.float()
    return ((end[..., 0] < 0) | (end[..., 1] < 0)
            | (end[..., 0] >= W) | (end[..., 1] >= H))
