"""Per-pixel candidate selection over the delta axis.

Port of ``mft_tpu/tracker/select.py`` (reference MFT/MFT.py:112-142): score
= -sigma; candidates whose occlusion exceeds the threshold, and invalid
candidates, score -inf; the first maximum wins (``torch.argmax``, as
``jnp.argmax``); endpoints that leave the image are marked occluded.
"""

import torch

from mft_tpu_torch.core.flowou import FlowOU, invalid_mask


def select_best(flows, occlusions, sigmas, valid,
                occlusion_threshold: float = 0.02) -> FlowOU:
    """args: flows (N, H, W, 2), occlusions and sigmas (N, H, W) chained
    candidates (candidate 0 = delta inf), valid (N,) bool.
    returns: the selected FlowOU (H, W, ...)."""
    scores = torch.where(occlusions > occlusion_threshold, -torch.inf, -sigmas)
    scores = torch.where(torch.as_tensor(valid, device=scores.device)[:, None, None],
                         scores, -torch.inf)
    best = torch.argmax(scores, dim=0)
    pick = lambda a: torch.gather(a, 0, best[None]).squeeze(0)
    sel_flow = torch.stack([pick(flows[..., 0]), pick(flows[..., 1])], dim=-1)
    sel_occl = torch.where(invalid_mask(sel_flow), 1.0, pick(occlusions))
    return FlowOU(flow=sel_flow, occlusion=sel_occl, sigma=pick(sigmas))
