"""FlowOU: the (flow, occlusion, sigma) value type and its geometric algebra.

Layout of ``mft_tpu.core.flowou.FlowOU``: flow (H, W, 2), occlusion (H, W)
in [0, 1], sigma (H, W) >= 0; a stacked candidate axis may lead.

The algebra of ``mft_tpu/core/flowou.py`` (reference MFT/results.py): chain,
backward warp, point warp, sampling, chaining two results, forward-backward
error. Every sample is one launch of ``ops.bilinear_warp`` in its 'exact'
mode (float32 taps, zeros outside the image); ``plain=True`` runs its plain
version on any device. ``ops`` is imported inside the functions, because it
imports this module's neighbours.
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

    @property
    def H(self) -> int:
        return self.flow.shape[0]

    @property
    def W(self) -> int:
        return self.flow.shape[1]

    def chain(self, flow_bc, plain: bool = False):
        return chain_flow(self.flow, flow_bc, plain)

    def warp_backward(self, img, plain: bool = False):
        return warp_backward(self.flow, img, plain)

    def warp_forward_points(self, points, plain: bool = False):
        return warp_forward_points(self.flow, points, plain)

    def sample(self, points, plain: bool = False):
        return sample_flowou(self, points, plain)

    def invalid_mask(self):
        return invalid_mask(self.flow)


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


def sample_maps(maps: torch.Tensor, points: torch.Tensor, plain: bool = False):
    """Bilinear zero-padded sample of (T, H, W, C) maps at (..., 2) points,
    shared by the T maps (exact mode, one launch) -> (T, ..., C) float32."""
    from mft_tpu_torch import ops
    T, C = maps.shape[0], maps.shape[-1]
    pts = points.float().reshape(1, -1, 2).expand(T, -1, -1)
    warp = ops.bilinear_warp_ref if plain else ops.bilinear_warp
    out = warp(maps.float().contiguous(), pts, "exact")
    return out.reshape(T, *points.shape[:-1], C)


def _endpoints(flow: torch.Tensor) -> torch.Tensor:
    H, W = flow.shape[0], flow.shape[1]
    return grid_coords(H, W, device=flow.device) + flow.float()


def _warp_back(flow, maps, plain):
    """(H, W, C) maps sampled at the (H, W) flow's endpoints."""
    return sample_maps(maps[None], _endpoints(flow), plain)[0]


def chain_flow(flow_ab: torch.Tensor, flow_bc: torch.Tensor, plain: bool = False):
    """A->B then B->C gives A->C: flow_ab + flow_bc sampled at the A->B
    endpoints (zeros outside the image). Reference MFT/results.py:87-114."""
    return flow_ab + _warp_back(flow_ab, flow_bc, plain)


def warp_backward(flow: torch.Tensor, img: torch.Tensor, plain: bool = False):
    """Sample ``img`` ((H, W) or (H, W, C)) at the flow endpoints; same rank
    as ``img``. Reference MFT/results.py:116-136."""
    squeeze = img.dim() == 2
    out = _warp_back(flow, img[..., None] if squeeze else img, plain)
    return out[..., 0] if squeeze else out


def warp_forward_points(flow: torch.Tensor, points: torch.Tensor, plain: bool = False):
    """(N, 2) query points plus the flow sampled at them.
    Reference MFT/results.py:138-157."""
    return points.float() + sample_maps(flow[None], points, plain)[0]


def sample_flowou(result: FlowOU, points: torch.Tensor, plain: bool = False):
    """Flow (N, 2), occlusion (N,) and sigma (N,) at (N, 2) query points,
    sampled as one packed 4-channel map. Reference MFT/results.py:159-188."""
    packed = torch.cat([result.flow.float(), result.occlusion[..., None].float(),
                        result.sigma[..., None].float()], dim=-1)
    s = sample_maps(packed[None], points, plain)[0]
    return s[..., :2], s[..., 2], s[..., 3]


def chain_results(left: FlowOU, right: FlowOU, plain: bool = False) -> FlowOU:
    """template->left composed with left->right: flow chained, occlusion the
    max of left and back-warped right, sigma their root sum of squares.
    Reference MFT/MFT.py:233-239."""
    flow = chain_flow(left.flow, right.flow, plain)
    occl = torch.maximum(left.occlusion, warp_backward(left.flow, right.occlusion, plain))
    sigma = torch.sqrt(torch.square(left.sigma)
                       + torch.square(warp_backward(left.flow, right.sigma, plain)))
    return FlowOU(flow=flow, occlusion=occl, sigma=sigma)


def chain_results_packed(left: FlowOU, right: FlowOU, plain: bool = False) -> FlowOU:
    """:func:`chain_results` with one 4-channel sample instead of three;
    channels are summed apart, so the result is the same."""
    packed = torch.cat([right.flow.float(), right.occlusion[..., None].float(),
                        right.sigma[..., None].float()], dim=-1)
    s = _warp_back(left.flow, packed, plain)
    flow = left.flow + s[..., :2]
    occl = torch.maximum(left.occlusion, s[..., 2])
    sigma = torch.sqrt(torch.square(left.sigma) + torch.square(s[..., 3]))
    return FlowOU(flow=flow, occlusion=occl, sigma=sigma)


def forward_backward_error(flow_forward, flow_backward, plain: bool = False):
    """(H, W, 2) A->B->A consistency error.
    Reference MFT/utils/interpolation.py:333-359."""
    return chain_flow(flow_forward, flow_backward, plain)


def forward_backward_error_magnitude(flow_forward, flow_backward, plain: bool = False):
    """(H, W) magnitude of :func:`forward_backward_error`.
    Reference MFT/utils/interpolation.py:362-375."""
    err = forward_backward_error(flow_forward, flow_backward, plain)
    return torch.sqrt(torch.sum(torch.square(err), dim=-1))
