"""Convex (mask-weighted) and bilinear 8x upsampling, the 1/8 flow downsampling.

Port of ``mft_tpu/models/raft/upsample.py``: the 576-channel mask is read as
(9, 8, 8) k-major, softmaxed over the 9 neighbourhood taps, and combined with
the zero-padded 3x3 neighbourhood (k = ky*3 + kx) of each scaled field. The
small model, which has no mask head, upsamples bilinearly with
align_corners=True (``upsample8``; ``upflow8`` also scales the flow by 8).
"""

import torch
import torch.nn.functional as F


def convex_upsample_multi(fields, mask, mult_coefs):
    """Convex 8x upsampling of several fields sharing one mask.

    args:
      fields: list of (B, C_i, h, w) coarse fields (float32).
      mask: (B, 576, h, w) raw mask logits.
      mult_coefs: per-field scale (8.0 for flow, 1.0 for occlusion, ...).
    returns:
      list of (B, 8h, 8w, C_i), channel-last like the FlowOU maps.
    """
    B, _, h, w = fields[0].shape
    f = torch.cat([c * x for x, c in zip(fields, mult_coefs)], dim=1)
    C = f.shape[1]
    m = torch.softmax(mask.reshape(B, 9, 64, h, w), dim=1)
    fp = F.pad(f, (1, 1, 1, 1))
    taps = torch.stack([fp[:, :, ky:ky + h, kx:kx + w]
                        for ky in range(3) for kx in range(3)], dim=1)
    up = torch.einsum("bkdyx,bkcyx->bdcyx", m, taps)       # (B, 64, C, h, w)
    # d = dy*8 + dx -> out[b, 8y+dy, 8x+dx, c]
    up = up.reshape(B, 8, 8, C, h, w).permute(0, 4, 1, 5, 2, 3)
    up = up.reshape(B, 8 * h, 8 * w, C)
    outs, off = [], 0
    for x in fields:
        outs.append(up[..., off:off + x.shape[1]])
        off += x.shape[1]
    return outs


def resize_bilinear_align_corners(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True in the JAX package's
    arithmetic: source positions (H-1) * (i / (Ho-1)), four taps weighted
    a(1-wy)(1-wx) + b(1-wy)wx + c wy(1-wx) + d wy wx. By gathers and not
    ``F.interpolate``, whose CUDA backward adds with atomics in no fixed
    order: a training step of the small model stays reproducible bit for
    bit.

    args: img (B, C, H, W); out_hw (Ho, Wo).
    returns: (B, Ho, Wo, C), channel-last like the FlowOU maps.
    """
    B, C, H, W = img.shape
    Ho, Wo = out_hw

    def positions(n_in, n_out):
        step = torch.arange(n_out, dtype=torch.float32, device=img.device) / max(n_out - 1, 1)
        s = (n_in - 1.0) * step
        i0 = torch.floor(s).long()
        return i0, torch.clamp(i0 + 1, max=n_in - 1), s - i0

    y0, y1, wy = positions(H, Ho)
    x0, x1, wx = positions(W, Wo)
    wy, wx = wy[:, None], wx[None, :]
    rows0, rows1 = img[:, :, y0], img[:, :, y1]
    a, b = rows0[..., x0], rows0[..., x1]
    c, d = rows1[..., x0], rows1[..., x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return out.permute(0, 2, 3, 1)


def upsample8(maps: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, 8h, 8w, C), bilinear, no value scaling
    (reference utils.py:125-127)."""
    return resize_bilinear_align_corners(maps, (8 * maps.shape[2], 8 * maps.shape[3]))


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) flow -> (B, 8h, 8w, 2), bilinear, values scaled by 8
    (reference utils.py:121-123)."""
    return 8.0 * upsample8(flow)


def downsample_flow8(flow: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2) flow -> (B, H/8, W/8, 2) at 1/8 scale and magnitude:
    bilinear resize with align_corners=True (reference MFT/raft.py:98-101)."""
    B, H, W, _ = flow.shape
    small = F.interpolate(flow.permute(0, 3, 1, 2), size=(H // 8, W // 8),
                          mode="bilinear", align_corners=True)
    return small.permute(0, 2, 3, 1) / 8.0
