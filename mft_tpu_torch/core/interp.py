"""Bilinear sampling and splatting in plain PyTorch.

Semantics of ``mft_tpu.core.interp.bilinear_sample``: torch ``grid_sample``
with ``align_corners=True, padding_mode='zeros'`` expressed directly in pixel
coordinates. The four taps are weighted and summed in the same order as the
JAX function, and as the port's CUDA kernels, so results agree to float
rounding (bit for bit with the kernels).

:func:`bilinear_splat` and :func:`warp_forward_image` are the scatter side
(``mft_tpu.core.interp``'s, reference MFT/utils/interpolation.py:234-309 and
MFT/results.py:190-248): one ``index_add_`` on the flat grid, the
counterpart of JAX's ``.at[].add``.
"""

import torch

from mft_tpu_torch.core.coords import grid_coords


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


def bilinear_splat(data: torch.Tensor, coords: torch.Tensor, grid_shape,
                   point_weights: torch.Tensor = None):
    """Bilinearly scatter-add ``data`` points onto a grid.

    args:
      data: (N, C) values to splat.
      coords: (N, 2) (x, y) destination coordinates.
      grid_shape: (H, W).
      point_weights: optional (N,) weight of each point (e.g. a 0/1 mask).
    returns:
      grid (H, W, C) of accumulated weighted values, counts (H, W, 1) of
      accumulated weights, in ``data``'s dtype.

    The border rule is JAX's: the integer corners are taken first, then the
    coordinates and corners are clamped into the grid and the weights come
    from the clamped values, so a point clamped onto the far border splats
    with zero weight. The four corners' contributions are added in JAX's
    order (all points' top-left corners, then bottom-left, top-right,
    bottom-right); on the CPU the additions into one cell run in that order,
    on CUDA they are float atomics, whose order (and so the last bits of a
    cell that several points reach) varies from run to run.
    """
    H, W = grid_shape
    C = data.shape[1]
    x = coords[:, 0]
    y = coords[:, 1]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = x0 + 1
    y1 = y0 + 1

    x = x.clamp(0.0, W - 1.0)
    y = y.clamp(0.0, H - 1.0)
    x0, x1 = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0, y1 = y0.clamp(0, H - 1), y1.clamp(0, H - 1)

    x0f, x1f, y0f, y1f = (v.to(data.dtype) for v in (x0, x1, y0, y1))
    w_a = (x1f - x) * (y1f - y)
    w_b = (x1f - x) * (y - y0f)
    w_c = (x - x0f) * (y1f - y)
    w_d = (x - x0f) * (y - y0f)
    if point_weights is not None:
        pw = point_weights.to(data.dtype)
        w_a, w_b, w_c, w_d = w_a * pw, w_b * pw, w_c * pw, w_d * pw

    flat_idx = torch.cat([y0, y1, y0, y1]) * W + torch.cat([x0, x0, x1, x1])
    weights = torch.cat([w_a, w_b, w_c, w_d])[:, None]
    values = weights * torch.cat([data, data, data, data], dim=0)
    grid = torch.zeros((H * W, C), dtype=data.dtype, device=data.device)
    counts = torch.zeros((H * W, 1), dtype=data.dtype, device=data.device)
    grid.index_add_(0, flat_idx, values)
    counts.index_add_(0, flat_idx, weights)
    return grid.reshape(H, W, C), counts.reshape(H, W, 1)


def warp_forward_image(img: torch.Tensor, flow: torch.Tensor, mask=None,
                       border=None) -> torch.Tensor:
    """Forward-warp (splat) an image by a dense flow field.

    args:
      img: (H, W) or (H, W, C) values to warp.
      flow: (H, W, 2) flow field (dst = src + flow).
      mask: optional (H, W) bool; only True pixels are splatted.
      border: optional fill value for cells that received no weight.
    returns:
      float32 warped image of ``img``'s shape: each cell the weighted mean
      of what reached it, 0 (or ``border``) where nothing did.
    """
    H, W = img.shape[0], img.shape[1]
    squeeze = img.dim() == 2
    vals = img.reshape(H * W, 1 if squeeze else -1).float()
    dst = (grid_coords(H, W, device=flow.device) + flow.float()).reshape(-1, 2)
    pw = mask.reshape(-1) if mask is not None else None
    accum, counts = bilinear_splat(vals, dst, (H, W), point_weights=pw)
    hit = counts > 0
    out = torch.where(hit, accum / torch.where(hit, counts, 1.0), 0.0)
    if border is not None:
        out = torch.where(hit, out, border)
    return out[..., 0] if squeeze else out.reshape(img.shape)
