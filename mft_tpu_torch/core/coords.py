"""Coordinate grid helpers.

Convention (as ``mft_tpu.core.coords``): coordinates are (x, y) pixel
positions in float32 in the LAST axis. A dense grid has shape (H, W, 2) with
``grid[y, x] == (x, y)``.
"""

import torch


def grid_coords(H: int, W: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Dense pixel-coordinate grid, shape (H, W, 2), last axis = (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=dtype),
                            torch.arange(W, device=device, dtype=dtype),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)
