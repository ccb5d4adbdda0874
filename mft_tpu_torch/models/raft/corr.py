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

The other stored forms of the volume are tagged tuples, as in the JAX
package, and :func:`corr_lookup` dispatches on the tag:
- ``("i8", levels, scales)``: int8 levels with a float32 scale per (pair,
  level), from :func:`quantize_pyramid` ('int8');
- ``("packed", packed, dims)``: all levels side by side in one zero-row-padded
  (B, P, H0, sum w_l) map, from :func:`pack_corr_pyramid` ('packed');
- ``("packed_i8", packed, scales, dims)``: that map in int8
  (:func:`pack_corr_pyramid_i8`, 'packed_i8');
- ``("t", levels_t)``: lane-major (B, h_l, w_l, P) levels, from
  :func:`build_corr_pyramid_t` ('pallas_t');
- ``("fold", levels, dims)``: folded (B, P, h_l*w_l/128, 128) levels (fold =
  128/w_l image rows per 128-lane row), the smallest ones a single
  zero-padded row, built in one launch by :func:`build_corr_pyramid_folded`
  ('fold');
- ``("mixed", folded, fdims, padded)``: the leading levels folded, the rest
  plain, from :func:`build_corr_pyramid_mixed` ('mixed').
The int8 forms sample bfloat16 whatever the volume dtype; the others sample
in the volume dtype.

The lookup itself runs on the kernels of ``mft_tpu_torch.ops``;
``plain=True`` makes the caller's choice of their plain PyTorch versions
explicit (for comparing the two on the card).
"""

import functools
import math

import torch
import torch.nn.functional as F

from mft_tpu_torch import ops
from mft_tpu_torch.ops.corr_lookup import dequant_levels, unpack_levels

PACKED_MAX_WIDTH = 128   # sum of the level widths of a packed map
FOLD_LANES = 128         # values per row of a folded level
MIXED_MAX_FOLD = 4       # 'mixed' folds a level only up to this many rows per lane row
QUANT_CHUNK = 1 << 26    # values of one pair-level quantized at once


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


def build_corr_pyramid_t(fmap1: torch.Tensor, fmap2: torch.Tensor,
                         num_levels: int = 4) -> list:
    """The pyramid of :func:`build_corr_pyramid` in lane-major layout.

    returns: ``num_levels`` maps, level l: (B, h_l, w_l, H*W), the source
    pixel on the fastest axis. The levels of :func:`build_corr_pyramid`,
    moved: the same values bit for bit, whatever order the BLAS library of
    the device sums a product with swapped operands in.
    """
    pyramid = build_corr_pyramid(fmap1, fmap2, num_levels)
    for l in range(num_levels):   # one level in both layouts at a time
        pyramid[l] = pyramid[l].permute(0, 2, 3, 1).contiguous()
    return pyramid


def _quantize_into(corr: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Quantize one pair's (P, h, w) level into ``out`` (int8); its scale.

    In chunks of source pixels, so no float32 copy of the level is held. The
    maximum of |a| is max(max a, -min a), taken in the level's dtype (which
    rounds nothing).
    """
    rows = max(1, QUANT_CHUNK // max(1, corr[0].numel()))
    starts = range(0, corr.shape[0], rows)
    bounds = torch.stack([torch.stack(torch.aminmax(corr[s:s + rows])) for s in starts])
    mx = torch.maximum(-bounds[:, 0].amin(), bounds[:, 1].amax())
    mx = mx.float().clamp(min=1e-12)
    # tensor by tensor: torch turns ``127.0 / mx`` into 127 * (1/mx), and a
    # division by a host scalar on the card into a product with its inverse
    c127 = torch.full_like(mx, 127.0)
    mul = c127 / mx
    for s in starts:
        a = corr[s:s + rows].float() * mul     # a new tensor: corr is not written
        # integers in [-127, 127] after clamp_: the int8 copy is exact
        out[s:s + rows].copy_(a.round_().clamp_(-127.0, 127.0))
    return mx / c127


def _quantize_pairs(pair_levels, B: int):
    """int8 levels and (B, L) scales of the pyramid whose pair b has the
    (P, h_l, w_l) levels ``pair_levels(b)``, quantized one pair at a time."""
    levels = scales = None
    for b in range(B):
        pair = pair_levels(b)
        if levels is None:
            levels = [torch.empty((B, *c.shape), dtype=torch.int8, device=c.device)
                      for c in pair]
            scales = torch.empty((B, len(pair)), dtype=torch.float32,
                                 device=pair[0].device)
        for lvl, corr in enumerate(pair):
            scales[b, lvl] = _quantize_into(corr, levels[lvl][b])
        del pair
    return levels, scales


def quantize_pyramid(pyramid):
    """int8 levels and (B, L) float32 scales, value = q * scale.

    Per (pair, level): mx = max(max|a|, 1e-12) over the level's values ``a``
    (as stored, widened to f32), q = clip(round(a * (127/mx)), -127, 127)
    rounded half to even, scale = mx/127; the error is at most mx/254 per
    value (JAX ``quantize_pyramid``). Works pair by pair and level by level.
    """
    return _quantize_pairs(lambda b: [c[b] for c in pyramid], pyramid[0].shape[0])


def build_corr_pyramid_i8(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          num_levels: int = 4):
    """:func:`quantize_pyramid` of :func:`build_corr_pyramid`, built pair by
    pair, so only one pair's pyramid in the volume dtype exists at a time
    beside the int8 one. returns: (levels, scales)."""
    pair = lambda b: [c[0] for c in build_corr_pyramid(fmap1[b:b + 1], fmap2[b:b + 1],
                                                       num_levels)]
    return _quantize_pairs(pair, fmap1.shape[0])


def pack_corr_pyramid(pyramid):
    """Levels side by side in one (B, P, H0, sum w_l) map per pixel.

    Level l fills columns [off_l, off_l + w_l) and rows [0, h_l); rows h_l..H0-1
    are zero. As in the JAX package, the sum of the widths must be at most
    128 (W8 <= 68), else ValueError.
    returns: (packed, dims), dims the levels' (h_l, w_l).
    """
    B, P, H0, _ = pyramid[0].shape
    dims = tuple((c.shape[2], c.shape[3]) for c in pyramid)
    if sum(w for _, w in dims) > PACKED_MAX_WIDTH:
        raise ValueError(f"packed layout needs sum of level widths <= "
                         f"{PACKED_MAX_WIDTH}, got {[w for _, w in dims]}")
    packed = pyramid[0].new_zeros((B, P, H0, sum(w for _, w in dims)))
    for view, corr in zip(unpack_levels(packed, dims), pyramid):
        view.copy_(corr)
    return packed, dims


def pack_corr_pyramid_i8(pyramid):
    """:func:`pack_corr_pyramid` of the :func:`quantize_pyramid` levels.
    returns: (packed int8, scales (B, L) float32, dims)."""
    levels, scales = quantize_pyramid(pyramid)
    packed, dims = pack_corr_pyramid(levels)
    return packed, scales, dims


def packable(H8: int, W8: int, num_levels: int) -> bool:
    """True iff every level fits the folded layout: the whole map fits one
    128-lane row, or whole image rows pack evenly into rows of 128 lanes (128
    divisible by w and h*w by 128), as the JAX ``_packable`` checks."""
    h, w = H8, W8
    for lvl in range(num_levels):
        if lvl > 0:
            h, w = h // 2, w // 2
        if h * w > FOLD_LANES and (FOLD_LANES % w or (h * w) % FOLD_LANES):
            return False
    return True


def folded_operands(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4):
    """The operands of the folded build: (f1 (B, C, H*W), f2_levels, dims).

    The target features are pooled per level and flattened to (B, C, h*w); a
    level of fewer than 128 positions gets zero features up to 128, so its
    padding lanes are zero. dims[l] = (h_l, w_l). Raises ValueError for dims
    :func:`packable` rejects, as the JAX model does for corr_method 'fold'.
    """
    B, C, H, W = fmap1.shape
    if not packable(H, W, num_levels):
        raise ValueError(f"corr_method='fold' needs packable dims, got {H}x{W}")
    f2, f2_levels, dims = fmap2, [], []
    for lvl in range(num_levels):
        if lvl > 0:
            f2 = avg_pool2x2(f2)
        h, w = f2.shape[2], f2.shape[3]
        flat = f2.reshape(B, C, h * w)
        if h * w < FOLD_LANES:
            flat = F.pad(flat, (0, FOLD_LANES - h * w))
        f2_levels.append(flat.contiguous())
        dims.append((h, w))
    return fmap1.reshape(B, C, H * W).contiguous(), f2_levels, tuple(dims)


def build_corr_pyramid_folded(fmap1: torch.Tensor, fmap2: torch.Tensor,
                              num_levels: int = 4, plain: bool = False):
    """The pyramid of :func:`build_corr_pyramid` in the folded layout, all
    levels in one launch of the product kernel (``ops.corr_build_folded``) on
    :func:`folded_operands`.

    The sum runs over the channels, scaled by 1/sqrt(C) after it and rounded
    once to the features' dtype. ``plain`` runs the kernel's plain version.
    returns: (levels, dims): levels[l] (B, H*W, max(h_l*w_l, 128)/128, 128),
      dims[l] = (h_l, w_l). Raises ValueError for dims :func:`packable`
      rejects, as the JAX model does for corr_method 'fold'.
    """
    f1, f2_levels, dims = folded_operands(fmap1, fmap2, num_levels)
    build = ops.corr_build_folded_ref if plain else ops.corr_build_folded
    return build(f1, f2_levels), dims


def build_corr_pyramid_mixed(fmap1: torch.Tensor, fmap2: torch.Tensor,
                             num_levels: int = 4, max_fold: int = None):
    """:func:`build_corr_pyramid` with the leading levels folded.

    A level is folded to (B, P, h*w/128, 128) (a view: the product's flat
    rows are already dense) while no earlier level stayed plain, it has more
    than 128 values, 128 is divisible by w, h by fold = 128/w, and fold <=
    ``max_fold`` (default 4); the others stay (B, P, h, w), as the JAX
    ``build_corr_pyramid_mixed`` splits them.
    returns: ("mixed", folded, fdims, padded).
    """
    max_fold = MIXED_MAX_FOLD if max_fold is None else max_fold
    folded, fdims, padded = [], [], []
    for corr in build_corr_pyramid(fmap1, fmap2, num_levels):
        B, P, h, w = corr.shape
        fold = FOLD_LANES // w if w and FOLD_LANES % w == 0 else 0
        if (not padded and h * w > FOLD_LANES and fold and h % fold == 0
                and fold <= max_fold):
            folded.append(corr.view(B, P, h // fold, FOLD_LANES))
            fdims.append((h, w))
        else:
            padded.append(corr)
    return ("mixed", folded, tuple(fdims), padded)


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


# tag of a stored volume -> (kernel wrapper, plain version)
_LOOKUPS = {
    # plain: the plain forward, and the plain backward where a level needs one
    "volume": (ops.corr_lookup, functools.partial(ops.corr_lookup, plain=True)),
    "i8": (ops.corr_lookup_q, ops.corr_lookup_q_ref),
    "packed": (ops.corr_lookup_packed, ops.corr_lookup_packed_ref),
    "packed_i8": (ops.corr_lookup_packed_i8, ops.corr_lookup_packed_i8_ref),
    "t": (ops.corr_lookup_t, ops.corr_lookup_t_ref),
    "fold": (ops.corr_lookup_folded, ops.corr_lookup_folded_ref),
    "mixed": (ops.corr_lookup_mixed, ops.corr_lookup_mixed_ref),
}


def corr_lookup(pyramid, coords, radius: int = 4, plain: bool = False):
    """(B, P, L*(2r+1)^2) window samples.

    args: pyramid, the list of :func:`build_corr_pyramid` (samples in the
      volume dtype) or one of the tagged tuples of the module docstring.
    """
    tag, *args = pyramid if isinstance(pyramid, tuple) else ("volume", pyramid)
    kernel, ref = _LOOKUPS[tag]
    return (ref if plain else kernel)(*args, coords, radius)


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
