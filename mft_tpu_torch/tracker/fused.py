"""Fused chain + select on FlowOU values.

Port of ``mft_tpu/tracker/fused.py``: chain occlusion and sigma for every
candidate, select per pixel on (-sigma, occlusion threshold, validity) with
the first maximum winning, then chain the flow of the winner only. The
chained flow of losing candidates is never observed, so this equals
chain-all-then-select.

:func:`chain_select` launches the kernel ``mft_chain_select`` for CUDA maps
(the plain version for CPU maps); :func:`chain_select_ref` is the plain
PyTorch version. Both follow the exact float32 math of the JAX
``chain_select_ref``.

:func:`chain_select_pallas` is the port of the JAX TPU form of the step
(``mft_tpu/tracker/fused.py:79 chain_select_pallas``), which JAX takes only on
a TPU backend: every candidate's flow (split into bf16 hi and lo parts),
occlusion and sigma, in bf16, sampled in one 'tpu'-mode warp (1/256-px snap,
``ops.bilinear_warp_blocked``), then chained and selected (``select_best``).
The tracker does not use it.
"""

import torch

from mft_tpu_torch import ops
from mft_tpu_torch.core.coords import grid_coords
from mft_tpu_torch.core.flowou import FlowOU
from mft_tpu_torch.tracker.select import select_best


def _maps(left: FlowOU, right: FlowOU):
    return (left.flow.float().contiguous(), left.occlusion.float().contiguous(),
            left.sigma.float().contiguous(), right.flow.float().contiguous(),
            right.occlusion.float().contiguous(), right.sigma.float().contiguous())


def chain_select(left: FlowOU, right: FlowOU, valid,
                 occlusion_threshold: float = 0.02) -> FlowOU:
    """args: left/right FlowOU with a stacked candidate axis (N, H, W, ...),
    or a clip axis before it (C, N, H, W, ...); valid (N,) bool, shared by
    the clips. returns the selected chained FlowOU (H, W, ...), or
    (C, H, W, ...): one kernel launch for every C."""
    flow, occl, sigma = ops.chain_select(*_maps(left, right), valid,
                                         occlusion_threshold)
    return FlowOU(flow=flow, occlusion=occl, sigma=sigma)


def chain_select_ref(left: FlowOU, right: FlowOU, valid,
                     occlusion_threshold: float = 0.02) -> FlowOU:
    """Plain PyTorch version of :func:`chain_select`, on any device; with a
    clip axis, one single-clip selection a clip."""
    flow, occl, sigma = ops.chain_select_ref(*_maps(left, right), valid,
                                             occlusion_threshold)
    return FlowOU(flow=flow, occlusion=occl, sigma=sigma)


def chain_select_pallas(left: FlowOU, right: FlowOU, valid,
                        occlusion_threshold: float = 0.02, plain: bool = False) -> FlowOU:
    """The TPU form of :func:`chain_select`: the same selection on samples
    snapped to 1/256 px, with the flow reconstructed from bf16 hi + lo parts
    (~2^-16 relative) and occlusion and sigma rounded to bf16. One launch of
    the warp kernel; ``plain=True`` runs its plain version."""
    N, H, W = left.occlusion.shape
    grid = grid_coords(H, W, device=left.flow.device)
    sx = grid[None, ..., 0] + left.flow[..., 0].float()
    sy = grid[None, ..., 1] + left.flow[..., 1].float()
    fhi, flo = ops.split_hi_lo(right.flow)
    maps = torch.cat([fhi, flo, right.occlusion[..., None].bfloat16(),
                      right.sigma[..., None].bfloat16()], dim=-1)      # (N, H, W, 6)
    coords = torch.stack([sx.reshape(N, -1), sy.reshape(N, -1)], dim=-1)
    samp = ops.bilinear_warp_blocked(maps, coords, plain=plain).reshape(N, H, W, 6)
    c_flow = left.flow + (samp[..., 0:2] + samp[..., 2:4])
    c_occ = torch.maximum(left.occlusion, samp[..., 4])
    c_sig = torch.sqrt(torch.square(left.sigma) + torch.square(samp[..., 5]))
    return select_best(c_flow, c_occ, c_sig, valid, occlusion_threshold)
