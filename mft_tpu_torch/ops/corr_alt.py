"""Window correlations straight from the features, with no all-pairs volume.

Two wrappers compute one function, each launching its own CUDA kernel on
CUDA tensors and using the plain version :func:`corr_lookup_alt_ref` on CPU
tensors:

- :func:`corr_lookup_alt` (kernel ``mft_corr_alt``, replacing
  ``mft_tpu/ops/alt_corr_pallas.py corr_lookup_alt``);
- :func:`corr_lookup_win` (kernel ``mft_corr_win``, replacing
  ``corr_lookup_win``): the same samples, with the target features a tile of
  source pixels needs staged once in shared memory.

In bfloat16 both entry points run one kernel on the tensor cores
(``csrc/corr_alt.cu window_tc_kernel``): per 8x8 tile of source pixels and
per level, the tile's features times the box of target positions its
windows touch, then a rounding repair that recomputes in the plain order
the tap dots of every sample near a bf16 rounding boundary. Its samples are
held to :func:`mft_tpu_torch.ops.product.product_error_bound` (K = C, scale
1/sqrt(C), S from :func:`mft_tpu_torch.ops.product.corr_window_magnitude`)
and equal the plain version's wherever the repair's premise holds; each
wrapper counts those launches in ``tensor_core_launches``. In float32 the
kernels run on the CUDA cores and give the plain version's bits.

For pair b, source pixel p, level l and window channel k = i*(2r+1) + j the
output is the bilinear sample, zeros outside the map, at
(x/2^l + i - r, y/2^l + j - r) of the map q -> <f1[b,p], f2_l[b,q]> / sqrt(C),
where (x, y) = coords[b, p]. The first window axis offsets x (the
reference's transposed order, as in :mod:`mft_tpu_torch.ops.corr_lookup`).

Layouts: f1 (B, H8, W8, C) source features, channel-last; the pyramid a list
of (B, h_l, w_l, C) channel-last target features
(:func:`mft_tpu_torch.models.raft.corr.build_feature_pyramid`); coords
(B, H8*W8, 2) float32 (x, y) at level-0 scale. f1 is cast to the pyramid's
dtype (f32 or bf16), the dots accumulate in f32 and are scaled by 1/sqrt(C)
in f32, and the (B, H8*W8, L*(2r+1)^2) samples are written in the pyramid's
dtype.

The plain version computes, per pixel and level, the (2r+2)^2 dots with the
integer taps around the window and combines them bilinearly, which is what
the kernels do; it works in chunks of pixels, so it also runs on a sample of
pixels of a 2160x3840 frame. Each dot is summed in one fixed order, the one
the CUDA-core kernels' lanes follow (:func:`_tree_dots`).
"""

import math

import torch

from mft_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_RADIUS = 4          # the kernels keep (2r+2)^2 <= 100 tap dots per pixel
MAX_CHANNELS = 256      # 8 lanes x 4 chunks of 8 channels per tap dot


# --------------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------------- #
def _tree_dots(g: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(R, T) float32 dots of taps g (R, T, C) with features f (R, C), both
    taken in float32.

    The order of the kernels: channel c = 64*m + 8*s + q (zeros beyond C),
    products in f32, then halving trees over q (8 -> 1), over m (4 -> 1, more
    above 256 channels) and over s (8 -> 1). In a kernel, lane s of an 8-lane
    group holds q and m of its channels and the s-tree is three shuffles.
    """
    R, T, C = g.shape
    M = 4 if C <= 256 else 1 << (math.ceil(C / 64) - 1).bit_length()
    prod = g.float() * f.float()[:, None, :]
    if 64 * M > C:
        prod = torch.nn.functional.pad(prod, (0, 64 * M - C))
    y = prod.view(R, T, M, 8, 8)                           # [m, s, q]
    while y.shape[-1] > 1:                                 # q
        y = y[..., : y.shape[-1] // 2] + y[..., y.shape[-1] // 2:]
    y = y[..., 0]                                          # (R, T, M, 8)
    while y.shape[2] > 1:                                  # m
        y = y[:, :, : y.shape[2] // 2] + y[:, :, y.shape[2] // 2:]
    y = y[:, :, 0]                                         # (R, T, 8)
    while y.shape[-1] > 1:                                 # s
        y = y[..., : y.shape[-1] // 2] + y[..., y.shape[-1] // 2:]
    return y[..., 0]


def _level_ref(f1, f2, coords, lvl, radius, scale, chunk, dot=_tree_dots):
    """(R, (2r+1)^2) samples of one level for R flat pixels, in the dtype of
    ``dot``'s result (float32 for :func:`_tree_dots`).

    args: f1 (R, C) in the pyramid dtype, f2 (B, h, w, C), coords (R, 2)
    level-0 float32; row r belongs to pair r // (R // B); ``dot(g, f)``
    gives the (r, T) dots of taps g (r, T, C) with features f (r, C).
    """
    B, h, w, C = f2.shape
    R = f1.shape[0]
    n = 2 * radius + 1
    dev = f1.device
    flat = f2.reshape(B * h * w, C)
    taps = torch.arange(n + 1, device=dev) - radius        # -r .. r+1
    per_pair = R // B
    out = None
    for s in range(0, R, chunk):
        e = min(R, s + chunk)
        c = coords[s:e] * (1.0 / 2.0 ** lvl)
        x0f, y0f = torch.floor(c[:, 0]), torch.floor(c[:, 1])
        wx, wy = (c[:, 0] - x0f)[:, None, None], (c[:, 1] - y0f)[:, None, None]
        xs = x0f.long()[:, None] + taps                        # (r, n+1)
        ys = y0f.long()[:, None] + taps
        valid = (((xs >= 0) & (xs < w))[:, :, None]
                 & ((ys >= 0) & (ys < h))[:, None, :])         # [tx, ty]
        b = torch.arange(s, e, device=dev) // per_pair
        idx = (b[:, None, None] * (h * w) + ys.clamp(0, h - 1)[:, None, :] * w
               + xs.clamp(0, w - 1)[:, :, None])               # (r, n+1, n+1)
        dots = dot(flat[idx.reshape(e - s, -1)], f1[s:e]) * scale
        d = torch.where(valid, dots.view(e - s, n + 1, n + 1), 0.0)
        # d[tx, ty]: the four taps of sample (i, j) are d[i|i+1, j|j+1]
        smp = (d[:, :-1, :-1] * ((1.0 - wx) * (1.0 - wy))
               + d[:, 1:, :-1] * (wx * (1.0 - wy))
               + d[:, :-1, 1:] * ((1.0 - wx) * wy)
               + d[:, 1:, 1:] * (wx * wy))
        if out is None:
            out = torch.empty((R, n * n), dtype=smp.dtype, device=dev)
        out[s:e] = smp.reshape(e - s, n * n)
    return out


def window_samples(f1, f2_pyramid, coords, radius: int = 4, chunk: int = 1024,
                   dot=_tree_dots, scale=None) -> torch.Tensor:
    """(B, N, L*(2r+1)^2) samples of the dots ``dot`` gives, scaled by
    ``scale`` (default 1/sqrt(C) in float32), unrounded: the plain version
    before its one rounding. Arguments as :func:`corr_lookup_alt_ref`; f1 is
    taken in the pyramid dtype."""
    B, N = coords.shape[:2]
    C = f2_pyramid[0].shape[-1]
    f1 = f1.reshape(B * N, C).to(f2_pyramid[0].dtype)
    coords = coords.float().reshape(B * N, 2)
    if scale is None:
        scale = 1.0 / math.sqrt(C)
    out = torch.cat([_level_ref(f1, f2, coords, lvl, radius, scale, chunk, dot)
                     for lvl, f2 in enumerate(f2_pyramid)], dim=-1)
    return out.reshape(B, N, -1)


def corr_lookup_alt_ref(f1, f2_pyramid, coords, radius: int = 4,
                        chunk: int = 1024) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_alt` and :func:`corr_lookup_win`.

    args: f1 (B, ..., C) source features of the N = coords.shape[1] pixels
      (any pixel subset: the function is per pixel); f2_pyramid list of
      (B, h_l, w_l, C); coords (B, N, 2) level-0 (x, y); ``chunk`` pixels
      are gathered at a time (memory: about 3 * chunk * (2r+2)^2 * C
      floats).
    returns: (B, N, L*(2r+1)^2) in the pyramid dtype.
    """
    return window_samples(f1, f2_pyramid, coords, radius, chunk).to(f2_pyramid[0].dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _launch_args(name, f1, f2_pyramid, coords, radius):
    """Check the inputs; allocate the output; the entry points' arguments
    up to the dtype code."""
    if coords.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {coords.device}")
    if not 1 <= len(f2_pyramid) <= 4:
        raise ValueError(f"{name}: 1..4 pyramid levels supported, got {len(f2_pyramid)}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: radius must be 0..{MAX_RADIUS}, got {radius}")
    dt = f2_pyramid[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{name}: feature dtype must be float32 or bfloat16, got {dt}")
    if f1.dim() != 4:
        raise ValueError(f"{name}: f1 must be (B, H8, W8, C), got {tuple(f1.shape)}")
    B, H8, W8, C = f1.shape
    if C % 8 or C > MAX_CHANNELS:
        raise ValueError(f"{name}: C must be a multiple of 8 up to {MAX_CHANNELS}, got {C}")
    dev = coords.device
    for lvl in f2_pyramid:
        if (lvl.dim() != 4 or lvl.shape[0] != B or lvl.shape[3] != C or lvl.dtype != dt
                or lvl.device != dev or not lvl.is_contiguous() or lvl.data_ptr() % 16):
            raise ValueError(f"{name}: pyramid levels must be 16-byte aligned contiguous "
                             f"(B, h, w, C) = ({B}, h, w, {C}) {dt} maps on {dev}")
    if (coords.shape != (B, H8 * W8, 2) or coords.dtype != torch.float32
            or not coords.is_contiguous()):
        raise ValueError(f"{name}: coords must be contiguous float32 (B, H8*W8, 2) = "
                         f"({B}, {H8 * W8}, 2), got {tuple(coords.shape)} {coords.dtype}")
    f1 = f1.to(dt).contiguous()
    if f1.device != dev or f1.data_ptr() % 16:
        raise ValueError(f"{name}: f1 must be on {dev} and 16-byte aligned")
    hw = []
    for l in range(4):
        hw += list(f2_pyramid[l].shape[1:3]) if l < len(f2_pyramid) else [0, 0]
    ptrs = [lvl.data_ptr() for lvl in f2_pyramid] + [None] * (4 - len(f2_pyramid))
    n = 2 * radius + 1
    out = torch.empty((B, H8 * W8, len(f2_pyramid) * n * n), dtype=dt, device=dev)
    args = [out.data_ptr(), f1.data_ptr(), coords.data_ptr(), *ptrs, *hw,
            len(f2_pyramid), B, H8, W8, C, radius, 1.0 / math.sqrt(C), _DTYPE_CODE[dt]]
    return out, args


def corr_lookup_alt(f1, f2_pyramid, coords, radius: int = 4) -> torch.Tensor:
    """Window correlations: (B, H8*W8, L*(2r+1)^2) in the pyramid dtype.
    float32: one warp per pixel reading the target features from device
    memory; bfloat16: the tile product on the tensor cores (module
    docstring), as :func:`corr_lookup_win`."""
    if coords.device.type == "cpu":
        return corr_lookup_alt_ref(f1, f2_pyramid, coords, radius)
    out, args = _launch_args("corr_lookup_alt", f1, f2_pyramid, coords, radius)
    err = _build.library().mft_corr_alt(
        *args, torch.cuda.current_stream(coords.device).cuda_stream)
    _build.check(err, "mft_corr_alt")
    corr_lookup_alt.launches += 1
    corr_lookup_alt.tensor_core_launches += out.dtype == torch.bfloat16
    return out


corr_lookup_alt.launches = 0
corr_lookup_alt.tensor_core_launches = 0


def corr_lookup_win(f1, f2_pyramid, coords, radius: int = 4, stats=None) -> torch.Tensor:
    """Window correlations of 8x8 source-pixel tiles that stage, per level,
    the box of target features their windows touch in shared memory when the
    box holds at most 1600 positions (float32: in bands of whole rows of up
    to 80 KB, the dots on the CUDA cores; bfloat16: in chunks of 32
    positions, the tile product on the tensor cores), else read each pixel's
    taps from device memory in the plain order, as the float32
    :func:`corr_lookup_alt` does.

    ``stats``, if given, is a CUDA int32 tensor of 2 counters to which the
    kernel adds the (tile, level) pairs that were staged and that were not;
    without it, the wrapper's ``stats`` attribute (None by default) is
    taken, so a caller can count a whole tracked clip's launches.
    """
    if coords.device.type == "cpu":
        return corr_lookup_alt_ref(f1, f2_pyramid, coords, radius)
    stats = corr_lookup_win.stats if stats is None else stats
    out, args = _launch_args("corr_lookup_win", f1, f2_pyramid, coords, radius)
    if stats is not None and (stats.shape != (2,) or stats.dtype != torch.int32
                              or stats.device != coords.device):
        raise ValueError("corr_lookup_win: stats must be an int32 (2,) tensor on "
                         f"{coords.device}")
    err = _build.library().mft_corr_win(
        *args, None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(coords.device).cuda_stream)
    _build.check(err, "mft_corr_win")
    corr_lookup_win.launches += 1
    corr_lookup_win.tensor_core_launches += out.dtype == torch.bfloat16
    return out


corr_lookup_win.launches = 0
corr_lookup_win.tensor_core_launches = 0
corr_lookup_win.stats = None
