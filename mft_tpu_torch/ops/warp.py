"""Dense bilinear warp: the CUDA kernel, its plain version and the JAX entry points.

:func:`bilinear_warp` (kernel ``mft_warp``, ``csrc/warp.cu``) samples a
channel-last (N, H, W, C) map at per-pixel (x, y) coordinates, align_corners
pixel convention, zeros outside the map. It launches its kernel on CUDA
tensors and uses :func:`bilinear_warp_ref` on CPU tensors.

It replaces the three tent-matmul warps of ``mft_tpu/ops/warp_pallas.py``
(``bilinear_warp_pallas``, ``bilinear_warp_banded``, ``bilinear_warp_tiled``)
and serves ``bilinear_warp_blocked`` too: the four functions below keep JAX's
names, arguments and return shapes, and each is one launch with the mode its
JAX function implies. Their tiling arguments choose TPU tiles, not the
function, so they are accepted; a pixel count that JAX cannot tile raises the
same ``ValueError``.

A mode is one of :data:`MODES`:

- ``'exact'``: float32 taps and weights (``dot_dtype=float32, snap=False``);
  the FlowOU algebra and point tracking use it;
- ``'tpu'``: coordinates snapped to 1/256 px (:func:`snap256`), map taps and
  row weights rounded to bfloat16, column weights float32, float32 sums
  (``bilinear_warp_pallas``'s defaults; banded, blocked and tiled always);
- ``'snap'`` and ``'bf16'``: one of the two.

The sample is summed as the TPU kernels sum it: over the two rows first
(``r = wy0*m[y0] + wy1*m[y0+1]`` for each of the two columns), then over the
two columns (``wx0*r0 + wx1*r1``), with tent weights ``max(0, 1 - |s - k|)``
at ``k = floor(s)`` and ``floor(s) + 1``. The kernel does the same float ops
in the same order, so both give the same bits.
"""

import torch

from mft_tpu_torch.ops import _build

# mode -> (snap, bf16 operands)
MODES = {"exact": (False, False), "tpu": (True, True), "snap": (True, False),
         "bf16": (False, True)}
_MAP_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 16


def snap256(s: torch.Tensor) -> torch.Tensor:
    """Snap the fraction of ``s`` to a 1/256 grid, rounding half to even
    (``_snap256``): tent weights then are multiples of 2^-8, exact in bf16."""
    f = torch.floor(s)
    return f + torch.round((s - f) * 256.0) * (1.0 / 256.0)


def split_hi_lo(x: torch.Tensor):
    """Split float32 values into two bfloat16 parts, x ~= hi + lo, as JAX's
    ``split_hi_lo``: hi = bf16(x), lo = bf16(x - hi)."""
    x = x.float()
    hi = x.bfloat16()
    lo = (x - hi.float()).bfloat16()
    return hi, lo


def _xy(coords):
    """(sx, sy) float32 (N, P) views of (N, P, 2) coords or of a pair."""
    if isinstance(coords, (tuple, list)):
        return coords[0], coords[1]
    return coords[..., 0], coords[..., 1]


# --------------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------------- #
def bilinear_warp_ref(maps, coords, mode: str = "exact", planar: bool = False):
    """Plain version of :func:`bilinear_warp`, on any device."""
    snap, bf16 = MODES[mode]
    N, H, W, C = maps.shape
    sx, sy = (t.float() for t in _xy(coords))
    if snap:
        sx, sy = snap256(sx), snap256(sy)
    flat = maps.reshape(N * H * W, C)
    flat = (flat.bfloat16() if bf16 else flat).float()
    base = torch.arange(N, device=maps.device)[:, None] * (H * W)
    x0f, y0f = torch.floor(sx), torch.floor(sy)

    def tent(s, k0f, k):
        return torch.clamp_min(1.0 - torch.abs(s - (k0f + k)), 0.0)

    wx = [tent(sx, x0f, k) for k in (0, 1)]
    wy = [tent(sy, y0f, k) for k in (0, 1)]
    if bf16:
        wy = [w.bfloat16().float() for w in wy]

    def tap(kx, ky):
        xk, yk = x0f + kx, y0f + ky
        ok = (xk >= 0) & (xk < W) & (yk >= 0) & (yk < H)
        idx = (base + torch.where(ok, yk, 0.0).long() * W
               + torch.where(ok, xk, 0.0).long())
        return torch.where(ok[..., None], flat[idx], 0.0)

    r = [wy[0][..., None] * tap(kx, 0) + wy[1][..., None] * tap(kx, 1) for kx in (0, 1)]
    out = wx[0][..., None] * r[0] + wx[1][..., None] * r[1]
    return out.permute(2, 0, 1).contiguous() if planar else out


# --------------------------------------------------------------------------- #
# kernel wrapper
# --------------------------------------------------------------------------- #
def bilinear_warp(maps, coords, mode: str = "exact", planar: bool = False):
    """Bilinear zero-padded sample of ``maps`` at ``coords``, one launch.

    args: maps (N, H, W, C) float32 or bfloat16, contiguous, C <= 16; coords
      (N, P, 2) float32 (x, y) pixel coordinates, any strides (an expanded
      tensor shares one set of coordinates between the N maps), or a pair
      (sx, sy) of (N, P) float32 tensors with the same strides; mode one of
      :data:`MODES`.
    returns: float32 (N, P, C), or (C, N, P) with ``planar``.
    """
    if maps.device.type == "cpu":
        return bilinear_warp_ref(maps, coords, mode, planar)
    if maps.device.type != "cuda":
        raise ValueError(f"bilinear_warp: unsupported device {maps.device}")
    snap, bf16 = MODES[mode]
    if maps.dim() != 4 or maps.dtype not in _MAP_DTYPES or not maps.is_contiguous():
        raise ValueError(f"maps must be a contiguous (N, H, W, C) float32 or bfloat16 "
                         f"tensor, got {tuple(maps.shape)} {maps.dtype}")
    N, H, W, C = maps.shape
    if C > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {C}")
    sx, sy = _xy(coords)
    if (sx.dim() != 2 or sx.shape != sy.shape or sx.shape[0] != N
            or sx.stride() != sy.stride() or sx.dtype != torch.float32
            or sy.dtype != torch.float32 or sx.device != maps.device
            or sy.device != maps.device):
        raise ValueError(f"coords must give float32 (N, P) = ({N}, P) x and y with one "
                         f"set of strides on {maps.device}")
    P = sx.shape[1]
    if planar:
        out = torch.empty((C, N, P), dtype=torch.float32, device=maps.device)
        o_strides = (P, 1, N * P)
    else:
        out = torch.empty((N, P, C), dtype=torch.float32, device=maps.device)
        o_strides = (P * C, C, 1)
    err = _build.library().mft_warp(
        out.data_ptr(), maps.data_ptr(), sx.data_ptr(), sy.data_ptr(), N, H, W, C, P,
        *sx.stride(), *o_strides, int(maps.dtype == torch.bfloat16), int(snap), int(bf16),
        torch.cuda.current_stream(maps.device).cuda_stream)
    _build.check(err, "mft_warp")
    bilinear_warp.launches += 1
    return out


bilinear_warp.launches = 0


# --------------------------------------------------------------------------- #
# the JAX entry points of mft_tpu/ops/warp_pallas.py
# --------------------------------------------------------------------------- #
def _tile_p(P: int, cap: int) -> int:
    return min(P & (-P), cap)


def _require_tile(P: int, cap: int):
    """JAX's tiling of the pixel axis: a power-of-two tile >= 8 dividing P."""
    if _tile_p(P, cap) < 8:
        raise ValueError(f"P={P} has no power-of-two tiling")


def _launch(maps, coords, mode, planar=False, plain=False):
    if maps.dtype not in _MAP_DTYPES:
        maps = maps.float()
    coords = (tuple(c.float() for c in coords) if isinstance(coords, (tuple, list))
              else coords.float())
    fn = bilinear_warp_ref if plain else bilinear_warp
    return fn(maps.contiguous(), coords, mode, planar)


def bilinear_warp_pallas(maps, coords, dot_dtype=torch.bfloat16, tile_p: int = 512,
                         snap: bool = True, plain: bool = False):
    """``warp_pallas.py bilinear_warp_pallas``: maps (N, H, W, C), coords
    (N, P, 2) -> (N, P, C) float32. ``dot_dtype`` bfloat16 rounds the map and
    the row weights (the MXU's operands), float32 does not; ``snap`` snaps
    the coordinates to 1/256 px. ``plain`` runs the plain version."""
    if dot_dtype not in _MAP_DTYPES:
        raise ValueError(f"dot_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {dot_dtype}")
    _require_tile(coords.shape[1], tile_p)
    mode = {(False, False): "exact", (True, True): "tpu", (True, False): "snap",
            (False, True): "bf16"}[(bool(snap), dot_dtype == torch.bfloat16)]
    return _launch(maps, coords, mode, plain=plain)


def bilinear_warp_banded(maps, coords, band: int = 128, tile_p: int = 256,
                         plain: bool = False):
    """``bilinear_warp_banded``: :func:`bilinear_warp_pallas` in its default
    'tpu' mode (JAX's banded kernel, or its fallback to #14 with ``tile_p``)."""
    _require_tile(coords.shape[1], tile_p)
    return _launch(maps, coords, "tpu", plain=plain)


def _blocked_tiles(H, W, P, ywin, xband, block_hw) -> bool:
    BH, BW = block_hw
    return not (P != H * W or H % ywin or W % xband or H % BH or W % BW
                or H // ywin < 2 or W // xband < 2)


def bilinear_warp_blocked(maps, coords, ywin: int = 128, xband: int = 128,
                          block_hw=(16, 32), plain: bool = False):
    """``bilinear_warp_blocked``: maps (N, H, W, C), coords (N, H*W, 2) in
    raster order -> (N, H*W, C) float32, 'tpu' mode. Where JAX cannot tile
    the frame it falls back to the banded kernel with its default tiles, and
    the port checks the pixel count as that fallback does."""
    N, H, W, C = maps.shape
    P = coords.shape[1]
    if not _blocked_tiles(H, W, P, ywin, xband, block_hw):
        _require_tile(P, 256)
    return _launch(maps, coords, "tpu", plain=plain)


def bilinear_warp_tiled(maps, sx, sy, ywin: int = 128, xband: int = 128,
                        block_hw=(8, 128), plain: bool = False):
    """``bilinear_warp_tiled``: maps (N, H, W, C), sx and sy (N, H, W) ->
    a list of C (N, H, W) float32 planes, 'tpu' mode, written in place by
    the kernel (no transpose)."""
    N, H, W, C = maps.shape
    BH, BW = block_hw
    if H % BH or W % BW or W % xband or H % ywin or H // ywin < 2:
        if not _blocked_tiles(H, W, H * W, 128, 128, (16, 32)):
            _require_tile(H * W, 256)
    xy = (sx.float().contiguous().reshape(N, H * W), sy.float().contiguous().reshape(N, H * W))
    out = _launch(maps, xy, "tpu", planar=True, plain=plain)
    return [out[c].reshape(N, H, W) for c in range(C)]
