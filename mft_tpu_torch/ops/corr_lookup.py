"""Correlation-pyramid window lookup: CUDA kernels and their plain versions.

Two functions, each a wrapper that launches its kernel on a CUDA tensor and
uses its plain PyTorch version on a CPU tensor:

- :func:`corr_lookup` (kernel ``mft_corr_lookup``, replacing
  ``mft_tpu/ops/corr_lookup_pallas.py corr_lookup_pallas``) returns the
  (B, P, L*(2r+1)^2) bilinear window samples in the volume dtype;
- :func:`corr_lookup_fused` (kernel ``mft_corr_lookup_conv``, replacing
  ``corr_lookup_pallas_fused``) returns relu(samples @ wc + bias), (B, P, F)
  in the volume dtype, with the samples rounded through the volume dtype and
  the product accumulated in float32.

Layouts are those of the JAX kernels: the pyramid is a list of (B, P, h_l, w_l)
maps (f32 or bf16), coords (B, P, 2) float32 (x, y) centres at level-0 scale.
Window channel k = i*(2r+1) + j samples at offset (dx = i - r, dy = j - r),
the reference's transposed order.

The plain versions are the exact bilinear math (``_lookup_level`` in
``mft_tpu/models/raft/corr.py``), not the TPU's tent-matmul formulation,
whose bf16 tent weights round.
"""

import torch

from mft_tpu_torch.core.interp import sample_stacked
from mft_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def _lookup_level_ref(corr_l: torch.Tensor, coords: torch.Tensor, radius: int):
    """(B, P, (2r+1)^2) float32 window samples of one level at ``coords``
    (already at this level's scale), zeros outside each pixel's map."""
    B, P, h, w = corr_l.shape
    n = 2 * radius + 1
    off = torch.arange(n, dtype=torch.float32, device=coords.device) - radius
    x = coords[..., 0:1] + off.repeat_interleave(n)   # i-major: i offsets x
    y = coords[..., 1:2] + off.repeat(n)
    pixel = torch.arange(B * P, device=coords.device).view(B, P, 1)
    return sample_stacked(corr_l.reshape(B * P, h, w, 1), torch.stack([x, y], -1),
                          pixel.expand(B, P, n * n))[..., 0]


def _samples_ref(pyramid, coords, radius):
    coords = coords.float()
    return torch.cat([_lookup_level_ref(corr_l, coords / (2.0 ** lvl), radius)
                      for lvl, corr_l in enumerate(pyramid)], dim=-1)


def corr_lookup_ref(pyramid, coords, radius: int = 4) -> torch.Tensor:
    """Plain version of :func:`corr_lookup`."""
    return _samples_ref(pyramid, coords, radius).to(pyramid[0].dtype)


def corr_lookup_fused_ref(pyramid, coords, wc, bias, radius: int = 4):
    """Plain version of :func:`corr_lookup_fused`."""
    dt = pyramid[0].dtype
    samples = _samples_ref(pyramid, coords, radius).to(dt).float()
    acc = torch.matmul(samples, wc.to(dt).float()) + bias.float()
    return torch.relu(acc).to(dt)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _check_inputs(pyramid, coords):
    if not 1 <= len(pyramid) <= 4:
        raise ValueError(f"1..4 pyramid levels supported, got {len(pyramid)}")
    dt = pyramid[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"volume dtype must be float32 or bfloat16, got {dt}")
    B, P = pyramid[0].shape[:2]
    dev = coords.device
    for lvl in pyramid:
        if (lvl.dim() != 4 or lvl.shape[:2] != (B, P) or lvl.dtype != dt
                or lvl.device != dev or not lvl.is_contiguous()):
            raise ValueError("pyramid levels must be contiguous (B, P, h, w) "
                             "maps of one dtype on the coords' device")
    if (coords.shape != (B, P, 2) or coords.dtype != torch.float32
            or not coords.is_contiguous()):
        raise ValueError(f"coords must be contiguous float32 (B, P, 2) = "
                         f"({B}, {P}, 2), got {tuple(coords.shape)} {coords.dtype}")
    hw = []
    for l in range(4):
        hw += list(pyramid[l].shape[2:]) if l < len(pyramid) else [0, 0]
    ptrs = [lvl.data_ptr() for lvl in pyramid] + [None] * (4 - len(pyramid))
    return dt, B, P, ptrs, hw


def _require_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def corr_lookup(pyramid, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup: (B, P, L*(2r+1)^2) samples in the volume dtype."""
    if coords.device.type == "cpu":
        return corr_lookup_ref(pyramid, coords, radius)
    _require_cuda(coords, "corr_lookup")
    dt, B, P, ptrs, hw = _check_inputs(pyramid, coords)
    C = len(pyramid) * (2 * radius + 1) ** 2
    out = torch.empty((B, P, C), dtype=dt, device=coords.device)
    err = _build.library().mft_corr_lookup(
        out.data_ptr(), coords.data_ptr(), *ptrs, *hw, len(pyramid), B * P,
        radius, _DTYPE_CODE[dt], torch.cuda.current_stream(coords.device).cuda_stream)
    _build.check(err, "mft_corr_lookup")
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0


def corr_lookup_fused(pyramid, coords, wc, bias, radius: int = 4) -> torch.Tensor:
    """Lookup fused with a 1x1 conv + relu: (B, P, F) in the volume dtype.

    args: wc (L*(2r+1)^2, F) conv kernel, bias (F,).
    """
    if coords.device.type == "cpu":
        return corr_lookup_fused_ref(pyramid, coords, wc, bias, radius)
    _require_cuda(coords, "corr_lookup_fused")
    dt, B, P, ptrs, hw = _check_inputs(pyramid, coords)
    C = len(pyramid) * (2 * radius + 1) ** 2
    F = wc.shape[-1]
    if wc.shape != (C, F):
        raise ValueError(f"wc must be (L*(2r+1)^2, F) = ({C}, F), got {tuple(wc.shape)}")
    wc = wc.to(dt).contiguous()
    bias = bias.float().contiguous()
    if bias.shape != (F,) or wc.device != coords.device or bias.device != coords.device:
        raise ValueError("bias must be (F,) and wc, bias on the coords' device")
    out = torch.empty((B, P, F), dtype=dt, device=coords.device)
    err = _build.library().mft_corr_lookup_conv(
        out.data_ptr(), coords.data_ptr(), wc.data_ptr(), bias.data_ptr(), *ptrs,
        *hw, len(pyramid), B * P, radius, F, _DTYPE_CODE[dt],
        torch.cuda.current_stream(coords.device).cuda_stream)
    _build.check(err, "mft_corr_lookup_conv")
    corr_lookup_fused.launches += 1
    return out


corr_lookup_fused.launches = 0
