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
"""

from mft_tpu_torch import ops
from mft_tpu_torch.core.flowou import FlowOU


def _maps(left: FlowOU, right: FlowOU):
    return (left.flow.float().contiguous(), left.occlusion.float().contiguous(),
            left.sigma.float().contiguous(), right.flow.float().contiguous(),
            right.occlusion.float().contiguous(), right.sigma.float().contiguous())


def chain_select(left: FlowOU, right: FlowOU, valid,
                 occlusion_threshold: float = 0.02) -> FlowOU:
    """args: left/right FlowOU with a stacked candidate axis (N, H, W, ...);
    valid (N,) bool. returns the selected chained FlowOU (H, W, ...)."""
    flow, occl, sigma = ops.chain_select(*_maps(left, right), valid,
                                         occlusion_threshold)
    return FlowOU(flow=flow, occlusion=occl, sigma=sigma)


def chain_select_ref(left: FlowOU, right: FlowOU, valid,
                     occlusion_threshold: float = 0.02) -> FlowOU:
    """Plain PyTorch version of :func:`chain_select`, on any device."""
    flow, occl, sigma = ops.chain_select_ref(*_maps(left, right), valid,
                                             occlusion_threshold)
    return FlowOU(flow=flow, occlusion=occl, sigma=sigma)
