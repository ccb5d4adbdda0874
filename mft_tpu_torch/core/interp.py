"""Bilinear sampling in plain PyTorch.

Semantics of ``mft_tpu.core.interp.bilinear_sample``: torch ``grid_sample``
with ``align_corners=True, padding_mode='zeros'`` expressed directly in pixel
coordinates. The four taps are weighted and summed in the same order as the
JAX function, and as the port's CUDA kernels, so results agree to float
rounding (bit for bit with the kernels).
"""

import torch


def sample_stacked(maps: torch.Tensor, coords: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Sample map ``idx`` of a stack at fractional pixel coordinates.

    args:
      maps: (N, H, W, C) stack of maps.
      coords: (..., 2) (x, y) pixel coordinates.
      idx: integer tensor of shape ``coords.shape[:-1]``: which map each
        position samples.
    returns:
      (..., C), float32 for float32 or bf16 maps. A tap outside its own
      H x W map contributes zero; the weights are NOT renormalized.
    """
    N, H, W, C = maps.shape
    flat = maps.reshape(N * H * W, C)
    x = coords[..., 0]
    y = coords[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx = x - x0f
    wy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    base = idx * (H * W)

    def tap(xi, yi, w):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], v, 0.0) * w[..., None]

    return (tap(x0, y0, (1.0 - wx) * (1.0 - wy))
            + tap(x0 + 1, y0, wx * (1.0 - wy))
            + tap(x0, y0 + 1, (1.0 - wx) * wy)
            + tap(x0 + 1, y0 + 1, wx * wy))


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) map at (..., 2) (x, y) coordinates -> (..., C)."""
    idx = torch.zeros(coords.shape[:-1], dtype=torch.long, device=coords.device)
    return sample_stacked(img[None], coords, idx)
