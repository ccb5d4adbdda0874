"""Correlation-pyramid window lookup: CUDA kernels and their plain versions.

Each function is a wrapper that launches its kernel on a CUDA tensor and
uses its plain PyTorch version on a CPU tensor:

- :func:`corr_lookup` (kernel ``mft_corr_lookup``, replacing
  ``mft_tpu/ops/corr_lookup_pallas.py corr_lookup_pallas``) returns the
  (B, P, L*(2r+1)^2) bilinear window samples in the volume dtype, through
  the staged per-pixel gather of ``csrc/corr_gather.cu``;
- :func:`corr_lookup_fused` (kernels ``mft_corr_lookup_conv_tc`` for
  bfloat16 and ``mft_corr_lookup_conv`` for float32, ``csrc/corr_lookup.cu``,
  replacing ``corr_lookup_pallas_fused``) returns relu(samples @ wc + bias),
  (B, P, F) in the volume dtype, with the samples rounded through the volume
  dtype and the product accumulated in float32: in bfloat16 on the tensor
  cores, in their order of summation, held to
  :func:`mft_tpu_torch.ops.product.product_error_bound`; its samples come
  from the same gather as :func:`corr_lookup`'s;
- four lookups of the same samples from other stored forms of the volume,
  the first three on :func:`corr_lookup`'s gather (``csrc/corr_gather.cu``):
  :func:`corr_lookup_q` (``mft_corr_lookup_q``, replacing
  ``corr_lookup_pallas_q``) from int8 levels with a scale per (pair, level),
  dequantized as it stages, :func:`corr_lookup_packed`
  (``mft_corr_lookup_packed``, replacing ``corr_lookup_pallas_packed``) from
  all levels side by side in one zero-row-padded (B, P, H0, sum w_l) map,
  each level addressed through its column offset and the map's row stride,
  :func:`corr_lookup_packed_i8` (``mft_corr_lookup_packed_i8``, replacing
  ``corr_lookup_pallas_packed_i8``) from that map in int8, and
  :func:`corr_lookup_t` (``mft_corr_lookup_t`` in ``csrc/corr_volume.cu``,
  replacing ``corr_lookup_pallas_t``) from lane-major (B, h_l, w_l, P)
  levels, staging per group of pixels the union of their windows' boxes
  (:func:`lane_major_staged_counts` counts the staged (group, level)s). The
  int8 forms return bfloat16 samples, the others the volume dtype;
- two lookups of the same samples from folded levels, both on
  :func:`corr_lookup`'s gather (``csrc/corr_gather.cu``):
  :func:`corr_lookup_folded` (``mft_corr_lookup_folded``, replacing
  ``corr_lookup_pallas_folded``) from (B, P, rows_l, 128) levels, lane
  u*w + x of row q holding image row q*fold + u, the smallest levels one
  zero-padded row; and :func:`corr_lookup_mixed` (``mft_corr_lookup_mixed``,
  replacing ``corr_lookup_pallas_mixed``) from folded big levels followed by
  plain (B, P, h_l, w_l) ones. A folded level's value (y, x) is element
  y*w + x of the pixel's rows: the folded lookup gives each level a pixel
  stride of rows_l*128 values and a row stride of w_l, and the mixed one
  hands the folded levels' dense views (fold*w = 128) to the gather. The
  gather kernels (K2, #4, #9, K6-K8 and the fused lookup) and the
  lane-major one take radius 1..4.

Layouts are those of the JAX kernels: the pyramid is a list of (B, P, h_l, w_l)
maps (f32 or bf16), coords (B, P, 2) float32 (x, y) centres at level-0 scale.
Window channel k = i*(2r+1) + j samples at offset (dx = i - r, dy = j - r),
the reference's transposed order.

The plain versions are the exact bilinear math (``_lookup_level`` in
``mft_tpu/models/raft/corr.py``), not the TPU's tent-matmul formulation,
whose bf16 tent weights round. An int8 value is dequantized (``q * scale``
in float32) before it is sampled, as the JAX package's non-TPU path does, and
the samples are rounded once.
"""

import torch

from mft_tpu_torch.core.interp import sample_stacked
from mft_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
GATHER_MAX_RADIUS = 4   # corr_gather.cuh's gather is compiled for radius 1..4
FUSED_TC_MAX_F = 256    # wgmma's widest N: the tensor-core fused lookup's F


def unpack_levels(packed: torch.Tensor, dims) -> list:
    """(B, P, H0, sum w_l) packed volume -> per-level (B, P, h_l, w_l) views."""
    levels, off = [], 0
    for h, w in dims:
        levels.append(packed[:, :, :h, off:off + w])
        off += w
    return levels


def unfold_levels(levels, dims) -> list:
    """Folded (B, P, rows_l, 128) levels -> (B, P, h_l, w_l) views: the first
    h_l*w_l lanes of each pixel's rows (all of them but a small level's
    padding)."""
    return [lvl.reshape(*lvl.shape[:2], -1)[..., :h * w].unflatten(-1, (h, w))
            for lvl, (h, w) in zip(levels, dims)]


def dequant_levels(levels, scales: torch.Tensor) -> list:
    """int8 levels times their (B, L) per-(pair, level) scales, float32."""
    return [lvl.float() * scales[:, i, None, None, None]
            for i, lvl in enumerate(levels)]


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


def corr_lookup_q_ref(levels, scales, coords, radius: int = 4) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_q`."""
    return _samples_ref(dequant_levels(levels, scales), coords,
                        radius).to(torch.bfloat16)


def corr_lookup_packed_ref(packed, dims, coords, radius: int = 4) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_packed`."""
    return corr_lookup_ref(unpack_levels(packed, dims), coords, radius)


def corr_lookup_packed_i8_ref(packed, scales, dims, coords,
                              radius: int = 4) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_packed_i8`."""
    return corr_lookup_q_ref(unpack_levels(packed, dims), scales, coords, radius)


def corr_lookup_t_ref(levels_t, coords, radius: int = 4) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_t`."""
    return corr_lookup_ref([lvl.movedim(3, 1) for lvl in levels_t], coords, radius)


def corr_lookup_folded_ref(levels, dims, coords, radius: int = 4,
                           ywin: int = 0) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_folded`."""
    return corr_lookup_ref(unfold_levels(levels, dims), coords, radius)


def corr_lookup_mixed_ref(folded, fdims, padded, coords, radius: int = 4) -> torch.Tensor:
    """Plain version of :func:`corr_lookup_mixed`."""
    return corr_lookup_ref(unfold_levels(folded, fdims) + list(padded), coords, radius)


def corr_lookup_fused_ref(pyramid, coords, wc, bias, radius: int = 4):
    """Plain version of :func:`corr_lookup_fused`."""
    dt = pyramid[0].dtype
    samples = _samples_ref(pyramid, coords, radius).to(dt).float()
    acc = torch.matmul(samples, wc.to(dt).float()) + bias.float()
    return torch.relu(acc).to(dt)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _check_coords(coords, B, P):
    if (coords.shape != (B, P, 2) or coords.dtype != torch.float32
            or not coords.is_contiguous()):
        raise ValueError(f"coords must be contiguous float32 (B, P, 2) = "
                         f"({B}, {P}, 2), got {tuple(coords.shape)} {coords.dtype}")


def _check_levels(levels, coords, dtypes, lane_major=False):
    """(dtype, B, P, level pointers, (h_l, w_l) of 4 levels) of contiguous
    (B, P, h, w) levels, or (B, h, w, P) ones if ``lane_major``."""
    if not 1 <= len(levels) <= 4:
        raise ValueError(f"1..4 pyramid levels supported, got {len(levels)}")
    dt = levels[0].dtype
    if dt not in dtypes:
        raise TypeError(f"volume dtype must be one of {dtypes}, got {dt}")
    bp = lambda t: (t.shape[0], t.shape[3]) if lane_major else tuple(t.shape[:2])
    B, P = bp(levels[0])
    dev = coords.device
    for lvl in levels:
        if (lvl.dim() != 4 or bp(lvl) != (B, P) or lvl.dtype != dt
                or lvl.device != dev or not lvl.is_contiguous()):
            raise ValueError(f"pyramid levels must be contiguous "
                             f"{'(B, h, w, P)' if lane_major else '(B, P, h, w)'} "
                             "maps of one dtype on the coords' device")
    _check_coords(coords, B, P)
    hw = []
    for l in range(4):
        if l < len(levels):
            hw += list(levels[l].shape[1:3] if lane_major else levels[l].shape[2:])
        else:
            hw += [0, 0]
    ptrs = [lvl.data_ptr() for lvl in levels] + [None] * (4 - len(levels))
    return dt, B, P, ptrs, hw


def _check_scales(scales, B, L, dev):
    if (scales.shape != (B, L) or scales.dtype != torch.float32
            or scales.device != dev or not scales.is_contiguous()):
        raise ValueError(f"scales must be contiguous float32 (B, L) = ({B}, {L}) "
                         f"on the coords' device, got {tuple(scales.shape)} "
                         f"{scales.dtype}")


def _check_packed(packed, dims, coords, dtypes):
    """(dtype, B, P, H0, Wp, (h_l, w_l) of 4 levels) of a packed volume."""
    if not 1 <= len(dims) <= 4:
        raise ValueError(f"1..4 pyramid levels supported, got {len(dims)}")
    if packed.dtype not in dtypes:
        raise TypeError(f"packed volume dtype must be one of {dtypes}, "
                        f"got {packed.dtype}")
    if packed.dim() != 4 or packed.device != coords.device or not packed.is_contiguous():
        raise ValueError("the packed volume must be a contiguous (B, P, H0, sum_w) "
                         "tensor on the coords' device")
    B, P, H0, Wp = packed.shape
    if any(h > H0 for h, _ in dims) or sum(w for _, w in dims) != Wp:
        raise ValueError(f"dims {tuple(dims)} do not fit a ({H0}, {Wp}) packed map")
    _check_coords(coords, B, P)
    hw = [int(v) for h_w in dims for v in h_w] + [0, 0] * (4 - len(dims))
    return packed.dtype, B, P, H0, Wp, hw


def _check_folded(levels, dims, coords, dtypes, dense_only=False):
    """(dtype, B, P, rows of 4 levels, (h_l, w_l) of 4 levels) of contiguous
    folded (B, P, rows_l, 128) levels: rows_l*128 = h_l*w_l, or one row of at
    most 128 values unless ``dense_only``."""
    if not 1 <= len(levels) <= 4 or len(dims) != len(levels):
        raise ValueError(f"1..4 folded levels with their dims supported, got "
                         f"{len(levels)} levels and {len(dims)} dims")
    dt = levels[0].dtype
    if dt not in dtypes:
        raise TypeError(f"volume dtype must be one of {dtypes}, got {dt}")
    B, P = levels[0].shape[:2]
    for lvl, (h, w) in zip(levels, dims):
        rows = lvl.shape[2] if lvl.dim() == 4 else 0
        dense = rows * 128 == h * w
        if (lvl.dim() != 4 or tuple(lvl.shape[:2]) != (B, P) or lvl.shape[3] != 128
                or lvl.dtype != dt or lvl.device != coords.device
                or not lvl.is_contiguous()
                or not (dense or (not dense_only and rows == 1 and h * w < 128))):
            raise ValueError(f"folded levels must be contiguous (B, P, h*w/128, 128) "
                             f"maps of one dtype on the coords' device (or one row "
                             f"for fewer than 128 values); got {tuple(lvl.shape)} for "
                             f"dims ({h}, {w})")
    _check_coords(coords, B, P)
    rows = [lvl.shape[2] for lvl in levels] + [0] * (4 - len(levels))
    hw = [int(v) for h_w in dims for v in h_w] + [0, 0] * (4 - len(dims))
    return dt, B, P, rows, hw


def _require_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def _channels(num_levels: int, radius: int) -> int:
    return num_levels * (2 * radius + 1) ** 2


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_gather_radius(radius: int):
    if not 1 <= radius <= GATHER_MAX_RADIUS:
        raise ValueError(f"the gather kernel takes radius 1..{GATHER_MAX_RADIUS}, "
                         f"got {radius}")


def _check_fused_width(F: int):
    """The tensor-core fused lookup writes rows of F bf16 outputs with
    16-byte stores and holds Wc (F rows) in shared memory: F a multiple of 8
    up to 256."""
    if F % 8 or not 8 <= F <= FUSED_TC_MAX_F:
        raise ValueError(f"the tensor-core fused lookup takes F a multiple of 8 up to "
                         f"{FUSED_TC_MAX_F}, got {F}")


def corr_lookup(pyramid, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup: (B, P, L*(2r+1)^2) samples in the volume dtype."""
    if coords.device.type == "cpu":
        return corr_lookup_ref(pyramid, coords, radius)
    _require_cuda(coords, "corr_lookup")
    _check_gather_radius(radius)
    dt, B, P, ptrs, hw = _check_levels(pyramid, coords, tuple(_DTYPE_CODE))
    C = _channels(len(pyramid), radius)
    out = torch.empty((B, P, C), dtype=dt, device=coords.device)
    err = _build.library().mft_corr_lookup(
        out.data_ptr(), coords.data_ptr(), *ptrs, *hw, len(pyramid), B * P,
        radius, _DTYPE_CODE[dt], _stream(coords))
    _build.check(err, "mft_corr_lookup")
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0


def corr_lookup_fused(pyramid, coords, wc, bias, radius: int = 4) -> torch.Tensor:
    """Lookup fused with a 1x1 conv + relu: (B, P, F) in the volume dtype.

    args: wc (L*(2r+1)^2, F) conv kernel, any strides: the transposed view of
      a (F, L*(2r+1)^2) conv weight is passed to the bfloat16 kernel as it is,
      with no copy; bias (F,). bfloat16 runs on the tensor cores (F a
      multiple of 8 up to 256), float32 on the CUDA cores.
    """
    if coords.device.type == "cpu":
        return corr_lookup_fused_ref(pyramid, coords, wc, bias, radius)
    _require_cuda(coords, "corr_lookup_fused")
    _check_gather_radius(radius)
    dt, B, P, ptrs, hw = _check_levels(pyramid, coords, tuple(_DTYPE_CODE))
    C = _channels(len(pyramid), radius)
    F = wc.shape[-1]
    if wc.shape != (C, F):
        raise ValueError(f"wc must be (L*(2r+1)^2, F) = ({C}, F), got {tuple(wc.shape)}")
    bias = bias.float().contiguous()
    if bias.shape != (F,) or wc.device != coords.device or bias.device != coords.device:
        raise ValueError("bias must be (F,) and wc, bias on the coords' device")
    out = torch.empty((B, P, F), dtype=dt, device=coords.device)
    lib = _build.library()
    args = (*ptrs, *hw, len(pyramid), B * P, radius, F, _stream(coords))
    if dt == torch.bfloat16:
        _check_fused_width(F)
        wt = wc.to(dt).t().contiguous()   # (F, C): wgmma's K-major operand
        err = lib.mft_corr_lookup_conv_tc(out.data_ptr(), coords.data_ptr(), wt.data_ptr(),
                                          bias.data_ptr(), *args)
        _build.check(err, "mft_corr_lookup_conv_tc")
        corr_lookup_fused.tensor_core_launches += 1
    else:
        wc = wc.to(dt).contiguous()
        err = lib.mft_corr_lookup_conv(out.data_ptr(), coords.data_ptr(), wc.data_ptr(),
                                       bias.data_ptr(), *args)
        _build.check(err, "mft_corr_lookup_conv")
    corr_lookup_fused.launches += 1
    return out


corr_lookup_fused.launches = 0
corr_lookup_fused.tensor_core_launches = 0


def corr_lookup_q(levels, scales, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup on int8 levels: (B, P, L*(2r+1)^2) bfloat16 samples.

    args: levels, a list of (B, P, h_l, w_l) int8 maps; scales (B, L) float32,
      value = q * scale (:func:`mft_tpu_torch.models.raft.corr.quantize_pyramid`).
    """
    if coords.device.type == "cpu":
        return corr_lookup_q_ref(levels, scales, coords, radius)
    _require_cuda(coords, "corr_lookup_q")
    _check_gather_radius(radius)
    _, B, P, ptrs, hw = _check_levels(levels, coords, (torch.int8,))
    _check_scales(scales, B, len(levels), coords.device)
    out = torch.empty((B, P, _channels(len(levels), radius)), dtype=torch.bfloat16,
                      device=coords.device)
    err = _build.library().mft_corr_lookup_q(
        out.data_ptr(), coords.data_ptr(), scales.data_ptr(), *ptrs, *hw,
        len(levels), B, P, radius, _stream(coords))
    _build.check(err, "mft_corr_lookup_q")
    corr_lookup_q.launches += 1
    return out


corr_lookup_q.launches = 0


def corr_lookup_packed(packed, dims, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup on the packed volume: (B, P, L*(2r+1)^2) samples in its dtype.

    args: packed (B, P, H0, sum w_l) float32 or bfloat16, level l in columns
      [sum_{m<l} w_m, ... + w_l) and rows [0, h_l), zeros below; dims the
      levels' (h_l, w_l) (:func:`mft_tpu_torch.models.raft.corr.pack_corr_pyramid`).
      A tap outside its level's own columns or rows is zero.
    """
    if coords.device.type == "cpu":
        return corr_lookup_packed_ref(packed, dims, coords, radius)
    _require_cuda(coords, "corr_lookup_packed")
    _check_gather_radius(radius)
    dt, B, P, H0, Wp, hw = _check_packed(packed, dims, coords, tuple(_DTYPE_CODE))
    out = torch.empty((B, P, _channels(len(dims), radius)), dtype=dt,
                      device=coords.device)
    err = _build.library().mft_corr_lookup_packed(
        out.data_ptr(), coords.data_ptr(), packed.data_ptr(), H0, Wp, *hw, len(dims),
        B, P, radius, _DTYPE_CODE[dt], _stream(coords))
    _build.check(err, "mft_corr_lookup_packed")
    corr_lookup_packed.launches += 1
    return out


corr_lookup_packed.launches = 0


def corr_lookup_packed_i8(packed, scales, dims, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup on the int8 packed volume: (B, P, L*(2r+1)^2) bfloat16.

    args: packed (B, P, H0, sum w_l) int8 as in :func:`corr_lookup_packed`;
      scales (B, L) float32, value = q * scale.
    """
    if coords.device.type == "cpu":
        return corr_lookup_packed_i8_ref(packed, scales, dims, coords, radius)
    _require_cuda(coords, "corr_lookup_packed_i8")
    _check_gather_radius(radius)
    _, B, P, H0, Wp, hw = _check_packed(packed, dims, coords, (torch.int8,))
    _check_scales(scales, B, len(dims), coords.device)
    out = torch.empty((B, P, _channels(len(dims), radius)), dtype=torch.bfloat16,
                      device=coords.device)
    err = _build.library().mft_corr_lookup_packed_i8(
        out.data_ptr(), coords.data_ptr(), scales.data_ptr(), packed.data_ptr(), H0,
        Wp, *hw, len(dims), B, P, radius, _stream(coords))
    _build.check(err, "mft_corr_lookup_packed_i8")
    corr_lookup_packed_i8.launches += 1
    return out


corr_lookup_packed_i8.launches = 0


def corr_lookup_t(levels_t, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup on lane-major levels: (B, P, L*(2r+1)^2) in their dtype.

    args: levels_t, a list of (B, h_l, w_l, P) float32 or bfloat16 maps, the
      source pixel on the fastest axis
      (:func:`mft_tpu_torch.models.raft.corr.build_corr_pyramid_t`).
    """
    if coords.device.type == "cpu":
        return corr_lookup_t_ref(levels_t, coords, radius)
    _require_cuda(coords, "corr_lookup_t")
    _check_gather_radius(radius)
    dt, B, P, ptrs, hw = _check_levels(levels_t, coords, tuple(_DTYPE_CODE),
                                       lane_major=True)
    out = torch.empty((B, P, _channels(len(levels_t), radius)), dtype=dt,
                      device=coords.device)
    err = _build.library().mft_corr_lookup_t(
        out.data_ptr(), coords.data_ptr(), *ptrs, *hw, len(levels_t), B, P, radius,
        _DTYPE_CODE[dt], _stream(coords))
    _build.check(err, "mft_corr_lookup_t")
    corr_lookup_t.launches += 1
    return out


corr_lookup_t.launches = 0


def lane_major_staged_counts(reset: bool = False):
    """(staged, read per pixel): the (group, level)s of :func:`corr_lookup_t`'s
    launches on the card since the last reset whose union box was staged in
    shared memory and that read their taps from device memory per pixel
    (unions over the kernel's cap). Waits for the card; ``reset`` zeroes the
    counts after reading them."""
    import ctypes
    counts = (ctypes.c_longlong * 2)()
    _build.check(_build.library().mft_corr_lookup_t_counts(counts, int(reset)),
                 "mft_corr_lookup_t_counts")
    return int(counts[0]), int(counts[1])


def corr_lookup_folded(levels, dims, coords, radius: int = 4, ywin: int = 0) -> torch.Tensor:
    """Window lookup on folded levels: (B, P, L*(2r+1)^2) samples in their dtype.

    args: levels, a list of (B, P, rows_l, 128) float32 or bfloat16 maps from
      :func:`mft_tpu_torch.models.raft.corr.build_corr_pyramid_folded`, dims
      their (h_l, w_l). A tap outside its level's h_l x w_l map is zero; the
      padding lanes of a small level are never read. ``ywin`` is the JAX
      kernel's row window, which contracts only the rows the windows reach
      (and all rows where they do not fit): exact either way, so it changes
      nothing here.
    """
    if coords.device.type == "cpu":
        return corr_lookup_folded_ref(levels, dims, coords, radius, ywin)
    _require_cuda(coords, "corr_lookup_folded")
    _check_gather_radius(radius)
    dt, B, P, rows, hw = _check_folded(levels, dims, coords, tuple(_DTYPE_CODE))
    ptrs = [lvl.data_ptr() for lvl in levels] + [None] * (4 - len(levels))
    out = torch.empty((B, P, _channels(len(levels), radius)), dtype=dt,
                      device=coords.device)
    err = _build.library().mft_corr_lookup_folded(
        out.data_ptr(), coords.data_ptr(), *ptrs, *hw, *rows, len(levels), B, P, radius,
        _DTYPE_CODE[dt], _stream(coords))
    _build.check(err, "mft_corr_lookup_folded")
    corr_lookup_folded.launches += 1
    return out


corr_lookup_folded.launches = 0


def corr_lookup_mixed(folded, fdims, padded, coords, radius: int = 4) -> torch.Tensor:
    """Window lookup on a mixed pyramid: (B, P, L*(2r+1)^2) in its dtype.

    args: folded, the leading levels as (B, P, h_l*w_l/128, 128) maps, fdims
      their (h_l, w_l); padded, the remaining levels as (B, P, h_l, w_l) maps
      (:func:`mft_tpu_torch.models.raft.corr.build_corr_pyramid_mixed`);
      either list may be empty, not both.
    """
    if coords.device.type == "cpu":
        return corr_lookup_mixed_ref(folded, fdims, padded, coords, radius)
    _require_cuda(coords, "corr_lookup_mixed")
    _check_gather_radius(radius)
    levels = unfold_levels(folded, fdims) + list(padded)
    if folded:
        _check_folded(folded, fdims, coords, tuple(_DTYPE_CODE), dense_only=True)
    dt, B, P, ptrs, hw = _check_levels(levels, coords, tuple(_DTYPE_CODE))
    out = torch.empty((B, P, _channels(len(levels), radius)), dtype=dt,
                      device=coords.device)
    err = _build.library().mft_corr_lookup_mixed(
        out.data_ptr(), coords.data_ptr(), *ptrs, *hw, len(levels), B, P, radius,
        _DTYPE_CODE[dt], _stream(coords))
    _build.check(err, "mft_corr_lookup_mixed")
    corr_lookup_mixed.launches += 1
    return out


corr_lookup_mixed.launches = 0
