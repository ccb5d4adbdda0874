"""All-pairs correlation pyramid and the per-iteration window lookup.

Port of ``mft_tpu/models/raft/corr.py`` for the main path:
- the level-0 volume is one batched matrix product of the stride-8 features,
  scaled by 1/sqrt(C) before it is rounded to the volume dtype;
- coarser levels dot the SAME source features with 2x2 average-pooled target
  features (pooling the volume over target windows == pooling the features,
  the dot product being linear), with torch avg_pool2d floor semantics;
- the pyramid is a list of (B, P, h_l, w_l) maps, P = H8*W8 source pixels in
  raster order, and coords are (B, P, 2) float32 (x, y) at level-0 scale.

The low-memory methods 'alt' and 'win' keep no volume: the pyramid is one
of pooled target features (:func:`build_feature_pyramid`) and every lookup
recomputes the window correlations from the features
(:func:`corr_lookup_features`).

The lookup itself runs on the kernels of ``mft_tpu_torch.ops``;
``plain=True`` makes the caller's choice of their plain PyTorch versions
explicit (for comparing the two on the card).
"""

import math

import torch
import torch.nn.functional as F

from mft_tpu_torch import ops


def avg_pool2x2(f: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool of (B, C, H, W) features; an odd trailing row or
    column is dropped (torch avg_pool2d floor semantics)."""
    return F.avg_pool2d(f, kernel_size=2, stride=2)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> list:
    """All-pairs correlation pyramid from (B, C, H, W) stride-8 features.

    returns: ``num_levels`` maps, level l: (B, H*W, H/2^l, W/2^l), in the
    features' dtype (the product accumulates in float32).
    """
    B, C, H, W = fmap1.shape
    f1 = fmap1.flatten(2).transpose(1, 2)                  # (B, P, C)
    f2 = fmap2
    scale = 1.0 / math.sqrt(C)
    zero = f1.new_zeros(())
    pyramid = []
    for lvl in range(num_levels):
        if lvl > 0:
            f2 = avg_pool2x2(f2)
        h, w = f2.shape[2], f2.shape[3]
        # alpha scales the f32 accumulator before the one rounding to dtype
        corr = torch.baddbmm(zero, f1, f2.reshape(B, C, h * w), beta=0.0,
                             alpha=scale)
        pyramid.append(corr.view(B, H * W, h, w))
    return pyramid


def build_feature_pyramid(fmap2: torch.Tensor, num_levels: int = 4) -> list:
    """Pooled target features of the 'alt' and 'win' lookups.

    args: fmap2 (B, C, H, W) stride-8 features.
    returns: ``num_levels`` channel-last maps, level l: (B, h_l, w_l, C)
      contiguous in C (the (B, h_l*w_l, C) rows of the JAX
      ``build_feature_pyramid``), pooled as :func:`build_corr_pyramid` pools.
    """
    levels, f = [], fmap2
    for lvl in range(num_levels):
        if lvl > 0:
            f = avg_pool2x2(f)
        levels.append(f.permute(0, 2, 3, 1).contiguous())
    return levels


def corr_lookup_features(method: str, f1, f2_pyramid, coords, radius: int = 4,
                         plain: bool = False):
    """(B, P, L*(2r+1)^2) window samples from features, no volume.

    args: method 'alt' or 'win' (which kernel); f1 (B, H8, W8, C)
      channel-last source features; f2_pyramid from
      :func:`build_feature_pyramid`; coords (B, P, 2) float32.
    """
    if plain:
        return ops.corr_lookup_alt_ref(f1, f2_pyramid, coords, radius)
    lookup = {"alt": ops.corr_lookup_alt, "win": ops.corr_lookup_win}[method]
    return lookup(f1, f2_pyramid, coords, radius)


def corr_lookup(pyramid, coords, radius: int = 4, plain: bool = False):
    """(B, P, L*(2r+1)^2) window samples in the volume dtype."""
    if plain:
        return ops.corr_lookup_ref(pyramid, coords, radius)
    return ops.corr_lookup(pyramid, coords, radius)


def corr_lookup_fused_conv(pyramid, coords, weight, bias, radius: int = 4,
                           plain: bool = False):
    """relu(convc1(lookup)): the lookup fused with a 1x1 conv.

    args: weight (F, L*(2r+1)^2, 1, 1) and bias (F,) of the conv.
    returns: (B, P, F) in the volume dtype.
    """
    wc = weight.reshape(weight.shape[0], -1).t()
    if plain:
        return ops.corr_lookup_fused_ref(pyramid, coords, wc, bias, radius)
    return ops.corr_lookup_fused(pyramid, coords, wc, bias, radius)
