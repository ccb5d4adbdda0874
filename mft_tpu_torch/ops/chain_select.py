"""MFT chain + select: the CUDA kernel and its plain version.

:func:`chain_select` (kernel ``mft_chain_select``) replaces
``mft_tpu/ops/warp_pallas.py bilinear_warp_blocked`` as
``mft_tpu/tracker/fused.py chain_select_pallas`` uses it, together with the
chaining, argmax and winner pick around it. It launches its kernel on CUDA
tensors and uses :func:`chain_select_ref` on CPU tensors.

Both hold to the exact float32 math of ``mft_tpu.tracker.fused.chain_select_ref``
(not to the TPU path's 1/256-px snap and bf16 hi/lo split), NaN included: a
chained occlusion is NaN where either operand is, a NaN score counts as the
maximum (the first NaN candidate wins, as ``argmax`` picks it). Inputs are
the stacked candidate maps: left/right flow (N, H, W, 2), occlusion and sigma
(N, H, W), valid (N,) bool. Outputs: flow (H, W, 2), occlusion and sigma (H, W).
With a leading clip axis, maps (C, N, H, W[, 2]) and valid (N,) shared by the
clips, the outputs are (C, H, W[, 2]): C single-clip selections, which the
kernel makes in one launch.
"""

import torch

from mft_tpu_torch.core.coords import grid_coords
from mft_tpu_torch.core.flowou import invalid_mask
from mft_tpu_torch.core.interp import sample_stacked
from mft_tpu_torch.ops import _build


def chained_sigma(lsig, s_sig):
    """sqrt(lsig² + s_sig²) in float32, each square and the sum rounded as
    JAX's ``jnp.sqrt(jnp.square(a) + jnp.square(b))`` rounds them, and the
    sqrt correctly rounded, as XLA's and CUDA's ``sqrtf`` are: taken in
    float64 and rounded once (PyTorch's vectorised sqrt on the CPU is not
    always correctly rounded; its float64 one errs by at most an ulp there,
    too little to move a float32 result)."""
    sq = torch.square(lsig.float()) + torch.square(s_sig.float())
    return torch.sqrt(sq.double()).float()


def select_candidates(lflow, locc, lsig, rocc, rsig, valid,
                      occlusion_threshold: float = 0.02):
    """Chain every candidate's occlusion and sigma and pick the per-pixel
    winner: occluded (> threshold) or invalid candidates score -inf, the
    others -sigma, and the first maximum wins (as ``jnp.argmax``).

    returns: best (H, W) int64, chained occlusion and sigma (N, H, W).
    """
    N, H, W = locc.shape
    grid = grid_coords(H, W, device=lflow.device)
    cand = torch.arange(N, device=lflow.device)[:, None, None].expand(N, H, W)
    packed = torch.stack([rocc.float(), rsig.float()], dim=-1)  # (N, H, W, 2)
    sampled = sample_stacked(packed, grid + lflow.float(), cand)
    c_occ = torch.maximum(locc.float(), sampled[..., 0])
    c_sig = chained_sigma(lsig, sampled[..., 1])
    scores = torch.where(c_occ > occlusion_threshold, -torch.inf, -c_sig)
    scores = torch.where(valid.to(lflow.device)[:, None, None], scores, -torch.inf)
    return torch.argmax(scores, dim=0), c_occ, c_sig


def chain_select_ref(lflow, locc, lsig, rflow, rocc, rsig, valid,
                     occlusion_threshold: float = 0.02):
    """Plain version of :func:`chain_select`: returns (flow, occlusion, sigma);
    with a clip axis, one single-clip call a clip, stacked."""
    if locc.dim() == 4:
        per_clip = [chain_select_ref(*(m[c] for m in (lflow, locc, lsig, rflow, rocc, rsig)),
                                     valid, occlusion_threshold)
                    for c in range(locc.shape[0])]
        return tuple(torch.stack(out) for out in zip(*per_clip))
    H, W = locc.shape[1:]
    best, c_occ, c_sig = select_candidates(lflow, locc, lsig, rocc, rsig, valid,
                                           occlusion_threshold)
    pick = lambda a: torch.gather(a, 0, best[None]).squeeze(0)
    lflow = lflow.float()
    sel_lflow = torch.stack([pick(lflow[..., 0]), pick(lflow[..., 1])], dim=-1)
    grid = grid_coords(H, W, device=lflow.device)
    sel_flow = sel_lflow + sample_stacked(rflow.float(), grid + sel_lflow, best)
    sel_occ = torch.where(invalid_mask(sel_flow), 1.0, pick(c_occ))
    return sel_flow, sel_occ, pick(c_sig)


def chain_select(lflow, locc, lsig, rflow, rocc, rsig, valid,
                 occlusion_threshold: float = 0.02):
    """Chain every candidate's occlusion and sigma, select per pixel, chain
    the winner's flow. Returns (flow (H, W, 2), occlusion (H, W), sigma (H, W)),
    or with a leading clip axis (C, H, W, 2), (C, H, W), (C, H, W): one launch
    for the C clips."""
    if lflow.device.type == "cpu":
        return chain_select_ref(lflow, locc, lsig, rflow, rocc, rsig, valid,
                                occlusion_threshold)
    if lflow.device.type != "cuda":
        raise ValueError(f"chain_select: unsupported device {lflow.device}")
    clips = locc.shape[:-3]   # () or (C,)
    if len(clips) > 1:
        raise ValueError(f"chain_select maps have at most one clip axis, got {tuple(locc.shape)}")
    N, H, W = locc.shape[-3:]
    C = clips[0] if clips else 1
    dev = lflow.device
    maps = [lflow, locc, lsig, rflow, rocc, rsig]
    shapes = [(*clips, N, H, W, 2), (*clips, N, H, W), (*clips, N, H, W)] * 2
    for m, s in zip(maps, shapes):
        if (m.shape != s or m.dtype != torch.float32 or m.device != dev
                or not m.is_contiguous()):
            raise ValueError(f"chain_select maps must be contiguous float32 {s} "
                             f"on {dev}, got {tuple(m.shape)} {m.dtype} {m.device}")
    if valid.shape != (N,) or valid.device != dev:
        raise ValueError(f"valid must be ({N},) on {dev}")
    if H * W > 2**31 - 1:
        raise ValueError(f"chain_select takes maps of fewer than 2^31 pixels, got {H}x{W}")
    if lflow.data_ptr() % 8 or rflow.data_ptr() % 8:
        raise ValueError("chain_select reads the flows' (x, y) pairs as 8-byte words: "
                         "lflow and rflow must start 8-byte aligned")
    valid = valid.to(torch.uint8).contiguous()
    oflow = torch.empty((*clips, H, W, 2), dtype=torch.float32, device=dev)
    oocc = torch.empty((*clips, H, W), dtype=torch.float32, device=dev)
    osig = torch.empty((*clips, H, W), dtype=torch.float32, device=dev)
    err = _build.library().mft_chain_select(
        oflow.data_ptr(), oocc.data_ptr(), osig.data_ptr(),
        *(m.data_ptr() for m in maps), valid.data_ptr(),
        float(occlusion_threshold), C, N, H, W,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mft_chain_select")
    chain_select.launches += 1
    return oflow, oocc, osig


chain_select.launches = 0
