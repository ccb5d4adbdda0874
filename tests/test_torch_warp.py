"""The port's bilinear warp against the JAX package's Pallas warps, on the CPU.

The same numpy maps and coordinates go through each JAX entry point of
``mft_tpu/ops/warp_pallas.py`` (Pallas interpret mode, at a shape that takes
that function's own kernel branch, not a fallback) and through the port's
function of the same name, which on CPU tensors runs the plain version that
the CUDA kernel ``mft_warp`` follows bit for bit on the card.

Stated tolerances:
- 'exact' mode: |d| <= 1e-5 + 1e-6*|JAX| (JAX's own bound against
  ``bilinear_sample`` in ``test_bilinear_warp_pallas_f32_exact`` is 1e-5);
- the bf16 modes: |d| <= 1e-5*max|map|: every product of a bf16 tap and a
  bf16 row weight is exact in float32, so only the float32 sum order of the
  column products can differ.

Coordinates: 'wild' (anywhere over the map and beyond it, off-map taps
included), 'local' (the pixel grid + U(-2, 2)) and 'half' (the pixel grid +
half-integer shifts and odd multiples of 1/512, where the 1/256 snap rounds
half to even).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.ops import warp_pallas as jw
from mft_tpu_torch import ops

KINDS = ("wild", "local", "half")
MODES = {  # port mode -> (JAX dot_dtype, snap)
    "exact": (jnp.float32, False), "snap": (jnp.float32, True),
    "tpu": (jnp.bfloat16, True), "bf16": (jnp.bfloat16, False)}


def _coords(rng, kind, N, H, W, P=None):
    """(N, P, 2) float32; P < H*W samples the first P grid pixels."""
    P = P or H * W
    g = np.mgrid[0:H, 0:W].transpose(1, 2, 0)[..., ::-1].reshape(1, H * W, 2)[:, :P]
    if kind == "wild":
        c = rng.random((N, P, 2)) * [[W * 1.4, H * 1.4]] - [[0.2 * W, 0.2 * H]]
    elif kind == "local":
        c = g + rng.random((N, P, 2)) * 4 - 2
    else:
        half = rng.integers(-6, 7, (N, P, 2)) * 0.5
        odd512 = (2 * rng.integers(0, 256, (N, P, 2)) + 1) / 512.0
        c = g + np.where(rng.random((N, P, 2)) < 0.5, half, rng.integers(-3, 4, (N, P, 2))
                         + odd512)
    return c.astype(np.float32)


def _maps(rng, N, H, W, C, scale=1.0):
    return (scale * rng.standard_normal((N, H, W, C))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_close(got, want, mode, maps):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if mode == "exact":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(maps).max()), rtol=0)


@pytest.mark.parametrize("C", [1, 4, 6, 16])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_warp_pallas_matches_jax(rng, mode, kind, C):
    """#14 bilinear_warp_pallas in each of its modes (dot dtype x snap), at
    the channel counts the kernel compiles (1, 4, 6) and a generic one (16)."""
    N, H, W, P = 2, 32, 16, 64
    maps, coords = _maps(rng, N, H, W, C), _coords(rng, kind, N, H, W, P)
    dot, snap = MODES[mode]
    want = jw.bilinear_warp_pallas(jnp.asarray(maps), jnp.asarray(coords), dot_dtype=dot,
                                   tile_p=64, snap=snap)
    got = ops.bilinear_warp_pallas(_t(maps), _t(coords),
                                   dot_dtype=torch.float32 if dot == jnp.float32
                                   else torch.bfloat16, tile_p=64, snap=snap)
    _assert_close(got, want, "exact" if mode == "exact" else "tpu", maps)


@pytest.mark.parametrize("kind", KINDS)
def test_warp_banded_matches_jax(rng, kind):
    """#15 bilinear_warp_banded on its own branch (band 16 over 64 rows)."""
    N, H, W, C = 1, 64, 64, 3
    maps, coords = _maps(rng, N, H, W, C), _coords(rng, kind, N, H, W)
    want = jw.bilinear_warp_banded(jnp.asarray(maps), jnp.asarray(coords), band=16,
                                   tile_p=64)
    got = ops.bilinear_warp_banded(_t(maps), _t(coords), band=16, tile_p=64)
    _assert_close(got, want, "tpu", maps)


@pytest.mark.parametrize("kind", KINDS)
def test_warp_blocked_matches_jax(rng, kind):
    """bilinear_warp_blocked on its own branch (16-row windows, 16-column
    bands, 8x8 blocks), bf16 maps as chain + select gives them."""
    N, H, W, C = 1, 64, 64, 3
    maps, coords = _maps(rng, N, H, W, C), _coords(rng, kind, N, H, W)
    bf = jnp.asarray(maps, jnp.bfloat16)
    want = jw.bilinear_warp_blocked(bf, jnp.asarray(coords), ywin=16, xband=16,
                                    block_hw=(8, 8))
    got = ops.bilinear_warp_blocked(_t(maps).bfloat16(), _t(coords), ywin=16, xband=16,
                                    block_hw=(8, 8))
    _assert_close(got, want, "tpu", maps)


@pytest.mark.parametrize("kind", KINDS)
def test_warp_tiled_matches_jax(rng, kind):
    """#16 bilinear_warp_tiled on its own branch (16-row windows, 64-column
    bands at 32x128): C planes of (N, H, W)."""
    N, H, W, C = 1, 32, 128, 3
    maps, coords = _maps(rng, N, H, W, C), _coords(rng, kind, N, H, W)
    sx, sy = coords[..., 0].reshape(N, H, W), coords[..., 1].reshape(N, H, W)
    want = jw.bilinear_warp_tiled(jnp.asarray(maps), jnp.asarray(sx), jnp.asarray(sy),
                                  ywin=16, xband=64)
    got = ops.bilinear_warp_tiled(_t(maps), _t(sx), _t(sy), ywin=16, xband=64)
    assert len(got) == len(want) == C
    for g, w in zip(got, want):
        _assert_close(g, w, "tpu", maps)


def test_split_hi_lo_bit_for_bit(rng):
    """hi = bf16(x), lo = bf16(x - hi), as JAX's split_hi_lo, bit for bit
    (flow-sized values, and values whose rounding ties)."""
    x = np.concatenate([(300 * rng.standard_normal(4096)).astype(np.float32),
                        np.float32(1 + 2.0 ** -8) * np.arange(-64, 64, dtype=np.float32)])
    jhi, jlo = jw.split_hi_lo(jnp.asarray(x))
    hi, lo = ops.split_hi_lo(_t(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    for got, want in ((hi, jhi), (lo, jlo)):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


def test_snap256_rounds_half_to_even():
    """Fractions that are odd multiples of 1/512 round to the even 1/256
    step, as jnp.round does (CUDA's roundf would round them away from 0)."""
    s = (np.arange(-2048, 2048, dtype=np.float32) + 0.5) / 512.0 + 7.0
    want = np.asarray(jw._snap256(jnp.asarray(s)))
    np.testing.assert_array_equal(ops.snap256(_t(s)).numpy(), want)
    assert float(ops.snap256(torch.tensor([1.0 / 512.0]))) == 0.0
    assert float(ops.snap256(torch.tensor([3.0 / 512.0]))) == 2.0 / 256.0


def test_untileable_pixel_counts_raise_as_jax(rng):
    """P with no power-of-two tile >= 8 raises ValueError in every entry
    point, as in JAX (directly in #14, through the fallbacks elsewhere)."""
    maps = _maps(rng, 1, 6, 10, 2)
    coords = _coords(rng, "local", 1, 6, 10)         # P = 60
    sx, sy = coords[..., 0].reshape(1, 6, 10), coords[..., 1].reshape(1, 6, 10)
    jm, jc = jnp.asarray(maps), jnp.asarray(coords)
    tm, tc = _t(maps), _t(coords)
    cases = [
        (lambda: jw.bilinear_warp_pallas(jm, jc), lambda: ops.bilinear_warp_pallas(tm, tc)),
        (lambda: jw.bilinear_warp_banded(jm, jc), lambda: ops.bilinear_warp_banded(tm, tc)),
        (lambda: jw.bilinear_warp_blocked(jm, jc), lambda: ops.bilinear_warp_blocked(tm, tc)),
        (lambda: jw.bilinear_warp_tiled(jm, jnp.asarray(sx), jnp.asarray(sy)),
         lambda: ops.bilinear_warp_tiled(tm, _t(sx), _t(sy))),
    ]
    for jax_fn, port_fn in cases:
        with pytest.raises(ValueError, match="tiling"):
            jax_fn()
        with pytest.raises(ValueError, match="tiling"):
            port_fn()
    # a tile cap below 8 refuses even a tileable P
    with pytest.raises(ValueError, match="tiling"):
        ops.bilinear_warp_pallas(tm, tc[:, :32], tile_p=4)


@pytest.mark.parametrize("planar", [False, True])
def test_dispatch_on_cpu_launches_nothing(rng, planar):
    """On CPU tensors the wrapper runs the plain version and counts no
    launch; shared (expanded) coordinates give each map's own sample."""
    maps = _t(_maps(rng, 3, 8, 12, 5))
    pts = _t(_coords(rng, "wild", 1, 8, 12, 40))
    shared = pts.expand(3, -1, -1)
    ops.reset_launch_counts()
    got = ops.bilinear_warp(maps, shared, "exact", planar=planar)
    assert ops.launch_counts()["bilinear_warp"] == 0
    want = ops.bilinear_warp_ref(maps, pts.repeat(3, 1, 1), "exact")
    if planar:
        want = want.permute(2, 0, 1)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


def test_exact_mode_matches_bilinear_sample(rng):
    """The exact mode is JAX's bilinear_sample up to the sum order of its
    four taps (1e-5 + 1e-6*|JAX|)."""
    from mft_tpu.core.interp import bilinear_sample
    maps = _maps(rng, 1, 20, 24, 4, scale=30.0)
    coords = _coords(rng, "wild", 1, 20, 24)
    want = bilinear_sample(jnp.asarray(maps[0]), jnp.asarray(coords[0]))
    got = ops.bilinear_warp(_t(maps), _t(coords), "exact")[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
