"""The plain versions of 'int8', 'packed', 'packed_i8' and 'pallas_t' against
the JAX package on the inputs where their kernels take different routes.

On the card, the int8 and the packed lookups stage each pixel's boxes (the
gather of ``csrc/corr_gather.cuh``; the packed map's rows of sum w_l values
start at any byte: 74 bytes a row in bf16 and 37 in int8 at 12x20), and the
lane-major lookup stages, per group of 16 pixels (8 in float32) and level,
the union of the pixels' boxes, or reads each pixel's taps from device
memory where that union is too large. The routes split on the coordinates
(local: the pixel grid + U(-2, 2); uniform: windows anywhere over the map
and past it), on the radius and on a level-0 width that is no multiple of 16
(groups then straddle two image rows). The kernels are held bit for bit to
these plain versions on the card (tests/test_torch_kernels_cuda.py); here
the plain versions are held to JAX on the same inputs.

JAX's Pallas lane-major kernel needs a power-of-two divisor of P of at least
128 and takes tens of seconds a call in interpret mode at radius 4, so at
12x20 (P = 240) both methods are compared with JAX's ``corr_lookup``
dispatch, and with the Pallas kernels in interpret mode on local coordinates
at shapes they take.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.models.raft.corr import build_corr_pyramid as jax_build_pyramid
from mft_tpu.models.raft.corr import corr_lookup as jax_corr_lookup
from mft_tpu.models.raft.corr import quantize_pyramid as jax_quantize
from mft_tpu.ops.corr_lookup_pallas import build_corr_pyramid_t as jax_build_t
from mft_tpu.ops.corr_lookup_pallas import (corr_lookup_pallas_packed,
                                            corr_lookup_pallas_packed_i8,
                                            corr_lookup_pallas_q, corr_lookup_pallas_t)
from mft_tpu.ops.corr_lookup_pallas import pack_corr_pyramid as jax_pack
from mft_tpu.ops.corr_lookup_pallas import pack_corr_pyramid_i8 as jax_pack_i8
from mft_tpu_torch.models.raft import corr as tcorr

B, C = 2, 16


def _features(rng, H8, W8):
    return (rng.standard_normal((B, H8, W8, C)).astype(np.float32),
            rng.standard_normal((B, H8, W8, C)).astype(np.float32))


def _nchw(f):
    return torch.from_numpy(f).permute(0, 3, 1, 2).contiguous()


def _coords(rng, kind, H8, W8):
    """(B, P, 2) float32: 'uniform' over the map and 4 px past it, 'local'
    the pixel grid + U(-2, 2)."""
    P = H8 * W8
    if kind == "uniform":
        return rng.uniform(-4, W8 + 4, (B, P, 2)).astype(np.float32)
    grid = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, P, 2)
    return (grid + rng.uniform(-2, 2, (B, P, 2))).astype(np.float32)


def _volumes(rng, method, H8, W8):
    """(JAX tagged volume, port tagged volume, f32 pyramid) of one pair of
    feature maps."""
    f1, f2 = _features(rng, H8, W8)
    pyr = jax_build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    port = [torch.from_numpy(np.array(lvl)) for lvl in pyr]
    if method == "int8":
        return ("i8", *jax_quantize(pyr)), ("i8", *tcorr.quantize_pyramid(port)), pyr
    if method == "packed":
        return ("packed", *jax_pack(pyr)), ("packed", *tcorr.pack_corr_pyramid(port)), pyr
    if method == "packed_i8":
        return (("packed_i8", *jax_pack_i8(pyr)),
                ("packed_i8", *tcorr.pack_corr_pyramid_i8(port)), pyr)
    jt = jax_build_t(jnp.asarray(f1), jnp.asarray(f2), 4)
    return ("t", jt), ("t", tcorr.build_corr_pyramid_t(_nchw(f1), _nchw(f2), 4)), pyr


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["uniform", "local"])
@pytest.mark.parametrize("method", ["int8", "packed", "packed_i8", "pallas_t"])
def test_plain_matches_jax_dispatch_at_12x20(rng, method, kind, radius):
    """Level 0 of 12x20 (P = 240): a 16-pixel group straddles two image
    rows, and the packed map's rows of 37 values start 8-byte aligned only
    at the first. Against JAX's exact dispatch path: f32 1e-4; the int8
    forms, which both round once to bf16: at most one bf16 ulp of the
    output."""
    H8, W8 = 12, 20
    jvol, tvol, _ = _volumes(rng, method, H8, W8)
    coords = _coords(rng, kind, H8, W8)
    want = np.asarray(jax_corr_lookup(jvol, jnp.asarray(coords.reshape(B, H8, W8, 2)),
                                      radius=radius).astype(jnp.float32))
    want = want.reshape(B, H8 * W8, -1)
    got = tcorr.corr_lookup(tvol, torch.from_numpy(coords), radius)
    assert tuple(got.shape) == (B, H8 * W8, 4 * (2 * radius + 1) ** 2)
    if method in ("int8", "packed_i8"):
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want)
        assert (err <= _bf16_ulp(want) + 1e-30).all(), float(err.max())
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("method,H8,W8,radius", [
    ("int8", 16, 24, 1), ("int8", 16, 24, 2), ("int8", 16, 24, 3), ("int8", 16, 24, 4),
    ("packed", 16, 24, 1), ("packed", 16, 24, 2), ("packed", 16, 24, 3),
    ("packed", 16, 24, 4), ("packed_i8", 16, 24, 1), ("packed_i8", 16, 24, 2),
    ("packed_i8", 16, 24, 3), ("packed_i8", 16, 24, 4),
    ("pallas_t", 8, 16, 1), ("pallas_t", 8, 16, 2)])
def test_plain_matches_jax_pallas_kernel_local(rng, method, H8, W8, radius):
    """Local coordinates against the JAX Pallas kernels in interpret mode:
    'packed' and 'pallas_t' in f32 1e-4 ('pallas_t' at P = 128 and radius
    1-2, where interpret mode takes seconds); the int8 kernels round their
    tent weights and row contraction to bf16, so they are held to the bound
    JAX's own test uses, 4 * max|corr| / 200."""
    jvol, tvol, pyr = _volumes(rng, method, H8, W8)
    coords = _coords(rng, "local", H8, W8)
    jc = jnp.asarray(coords)
    if method == "int8":
        want = corr_lookup_pallas_q(jvol[1], jvol[2], jc, radius)
    elif method == "packed":
        want = corr_lookup_pallas_packed(jvol[1], jvol[2], jc, radius, tile_p=128)
    elif method == "packed_i8":
        want = corr_lookup_pallas_packed_i8(jvol[1], jvol[2], jvol[3], jc, radius, tile_p=128)
    else:
        want = corr_lookup_pallas_t(jvol[1], jc, radius, tile_p=128)
    want = np.asarray(want.astype(jnp.float32))
    got = tcorr.corr_lookup(tvol, torch.from_numpy(coords), radius).float().numpy()
    assert got.shape == want.shape
    if method in ("int8", "packed_i8"):
        bound = float(np.max(np.abs(np.asarray(pyr[0], np.float32)))) / 200.0
        np.testing.assert_allclose(got, want, atol=4 * bound)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# corr_volume.cu lane_group_kernel: pixels a group (GroupShape::G) and the
# map positions a staged union box may hold (kCap)
LANE_GROUP = {"bfloat16": 16, "float32": 8}
LANE_CAP = 512


def _union_boxes(coords, dims, radius, G):
    """The lane-major kernel's union boxes: per level, (B, groups, 4) int
    (x, y, width, height) of the bounding box of the (2r+3)^2 boxes of each
    group of G consecutive pixels of a pair, a box's origin as
    corr_gather.cuh box_origin: floor(c/2^l - r) clamped to [-side, extent]."""
    B, P, _ = coords.shape
    side = 2 * radius + 3
    groups = -(-P // G)
    boxes = []
    for l, (h, w) in enumerate(dims):
        a = coords.astype(np.float32) * np.float32(2.0 ** -l)
        o = np.floor(a + np.float32(-radius))
        ox = np.clip(o[..., 0], -side, w).astype(np.int64)
        oy = np.clip(o[..., 1], -side, h).astype(np.int64)
        pad = groups * G - P        # a last partial group: its pixels only
        lo = lambda v: np.pad(v, ((0, 0), (0, pad)), constant_values=1 << 40)
        hi = lambda v: np.pad(v, ((0, 0), (0, pad)), constant_values=-(1 << 40))
        x0 = lo(ox).reshape(B, groups, G).min(-1)
        y0 = lo(oy).reshape(B, groups, G).min(-1)
        x1 = hi(ox).reshape(B, groups, G).max(-1)
        y1 = hi(oy).reshape(B, groups, G).max(-1)
        boxes.append(np.stack([x0, y0, x1 - x0 + side, y1 - y0 + side], -1))
    return boxes


@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lane_union_holds_every_tap(rng, dtype, radius):
    """Brute force over every tap of every window (the plain version's
    floor(c/2^l + offset), in float32): each tap inside the map lies in its
    group's union box, at 12x20 (groups straddle rows; P = 240) with local
    pixels, pixels far outside the map and positions that round up."""
    H8, W8 = 12, 20
    dims = [(H8, W8), (H8 // 2, W8 // 2), (H8 // 4, W8 // 4), (H8 // 8, W8 // 8)]
    coords = _coords(rng, "local", H8, W8)
    far = rng.random((B, H8 * W8)) < 0.1
    coords[far] = rng.uniform(-40, 60, (int(far.sum()), 2))
    up = rng.random((B, H8 * W8)) < 0.1         # c/2^l just below an integer
    coords[up] = np.nextafter(rng.integers(1, 12, (int(up.sum()), 2)).astype(np.float32),
                              np.float32(-np.inf))
    G = LANE_GROUP[dtype]
    n = 2 * radius + 1
    off = np.arange(n, dtype=np.float32) - np.float32(radius)
    for l, ((h, w), box) in enumerate(zip(dims, _union_boxes(coords, dims, radius, G))):
        a = coords * np.float32(2.0 ** -l)
        x0 = np.floor(a[..., 0, None] + off).astype(np.int64)       # (B, P, n)
        y0 = np.floor(a[..., 1, None] + off).astype(np.int64)
        u = np.repeat(box, G, axis=1)[:, :H8 * W8]                   # each pixel's union
        for dx in (0, 1):
            for dy in (0, 1):
                x = (x0 + dx)[:, :, :, None]                          # (B, P, n, n)
                y = (y0 + dy)[:, :, None, :]
                inside_map = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                ux, uy = u[..., 0, None, None], u[..., 1, None, None]
                uw, uh = u[..., 2, None, None], u[..., 3, None, None]
                in_union = (x >= ux) & (x < ux + uw) & (y >= uy) & (y < uy + uh)
                assert bool((in_union | ~inside_map).all()), f"level {l}"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lane_union_fits_cap_on_local_coordinates(rng, dtype):
    """At the 512x512 slice (64x64, 4 levels, radius 4), local coordinates
    give union boxes within the kernel's cap at every level, so the tracker's
    windows take the staged path; uniform ones over the map and 10 px past it
    do not at level 0."""
    H8 = W8 = 64
    dims = [(64, 64), (32, 32), (16, 16), (8, 8)]
    G = LANE_GROUP[dtype]
    local = _union_boxes(_coords(rng, "local", H8, W8), dims, 4, G)
    assert all(int((b[..., 2] * b[..., 3]).max()) <= LANE_CAP for b in local)
    wide = rng.uniform(-10, 74, (B, H8 * W8, 2)).astype(np.float32)
    level0 = _union_boxes(wide, dims, 4, G)[0]
    assert int((level0[..., 2] * level0[..., 3]).min()) > LANE_CAP


def test_lookup_probe_tool_finds_its_anchors():
    """tools/torch_lookup_probe.py edits corr_volume.cu and corr_gather.cuh
    into its variants: each text it edits at is in the source once, and each
    variant differs from the whole kernel."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "torch_lookup_probe.py"
    spec = importlib.util.spec_from_file_location("torch_lookup_probe", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    variants = tool.variants()
    for kernel in ("K9", "K6"):
        whole = variants[f"{kernel} whole"][1]
        for name, (_, files) in variants.items():
            if name.startswith(kernel) and name != f"{kernel} whole":
                assert files != whole, name
