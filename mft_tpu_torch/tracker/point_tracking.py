"""Dense tracking results -> sparse point tracks.

Port of ``mft_tpu/tracker/point_tracking.py`` (reference
MFT/point_tracking.py:6-27): query points are warped forward by the dense
flow sampled at them, and the occlusion is sampled at them. One call is one
launch of ``ops.bilinear_warp`` (exact mode): flow and occlusion go in as
three packed channels, which are summed apart, so the result equals two
separate samples. ``plain=True`` runs the plain version on any device.
"""

import numpy as np
import torch

from mft_tpu_torch.core.flowou import FlowOU, sample_maps


def _tracks(flows, occls, queries, plain):
    """flows (T, H, W, 2), occls (T, H, W), queries (N, 2) float32 on their
    device -> coords (T, N, 2), occlusion (T, N)."""
    maps = torch.cat([flows.float(), occls[..., None].float()], dim=-1)
    s = sample_maps(maps, queries, plain)
    return queries + s[..., :2], s[..., 2]


def _queries(queries, device):
    return torch.as_tensor(np.asarray(queries, np.float32), device=device)


def point_tracks(result: FlowOU, queries: torch.Tensor, plain: bool = False):
    """args: result FlowOU; queries (N, 2) template-frame (x, y) coordinates
    on the result's device. returns: coords (N, 2) in the current frame,
    occlusion (N,) in [0, 1], as tensors."""
    coords, occl = _tracks(result.flow[None], result.occlusion[None],
                           queries.float(), plain)
    return coords[0], occl[0]


def convert_to_point_tracking(result: FlowOU, queries, plain: bool = False):
    """Numpy in, numpy out: coords (N, 2) and occlusion (N,) float32."""
    coords, occl = point_tracks(result, _queries(queries, result.flow.device), plain)
    return coords.cpu().numpy(), occl.cpu().numpy().astype(np.float32)


def convert_to_point_tracking_batch(results, queries, plain: bool = False):
    """T same-shape FlowOU results at once: one stack, one launch, one fetch.

    returns: coords (T, N, 2), occlusion (T, N) float32 numpy arrays.
    """
    flows = torch.stack([r.flow for r in results])
    occls = torch.stack([r.occlusion for r in results])
    coords, occl = _tracks(flows, occls, _queries(queries, flows.device), plain)
    return coords.cpu().numpy(), occl.cpu().numpy().astype(np.float32)
