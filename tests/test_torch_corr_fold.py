"""The port's folded and mixed volumes against the JAX package.

corr_method 'fold' (every level folded into rows of 128 lanes, built inside
one kernel) and 'mixed' (the big levels folded, the rest plain): the
functions that build the pyramids and the two lookups. The same numpy inputs
go through the JAX functions (its Pallas kernels in interpret mode on the
CPU, or its exact dispatch path) and through the port's wrappers, which use
their plain PyTorch versions for CPU tensors. The kernels are held against those plain
versions on the card by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.models.raft.corr import build_corr_pyramid_mixed as jax_build_mixed
from mft_tpu.models.raft.corr import corr_lookup as jax_corr_lookup
from mft_tpu.models.raft.raft import _packable as jax_packable
from mft_tpu.ops.corr_lookup_pallas import (build_corr_pyramid_pallas,
                                            corr_lookup_pallas_folded,
                                            corr_lookup_pallas_mixed)
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft import corr as tcorr
from mft_tpu_torch.models.raft import RAFT
from mft_tpu_torch.models.raft.raft import RAFTParams
from mft_tpu_torch.ops.corr_lookup import unfold_levels

R = 4
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _features(rng, B, H8, W8, C):
    f1 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    return f1, f2


def _nchw(f, dtype="float32"):
    return torch.from_numpy(f).permute(0, 3, 1, 2).to(TORCH_DT[dtype])


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _port(a, dtype="float32"):
    return torch.from_numpy(_np(a)).to(TORCH_DT[dtype])


def _assert_bf16_close(got: np.ndarray, want: np.ndarray):
    """At most one bfloat16 ulp of the output (2^-7 relative: the two sum
    the same exact products in another float32 order and round once), plus
    1e-6 absolute for values next to zero."""
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_folded_matches_jax(rng, dtype):
    """build_corr_pyramid_folded against build_corr_pyramid_pallas (interpret
    mode) on a 16x32 map: level 0 in 4 rows of 128 lanes (fold 4), level 1
    (8x16 = 128 values) in one row, 4x8 and 2x4 zero-padded to one row. The
    same layout and, the sum order aside, the same values: f32 1e-5; bf16
    one bf16 ulp. The padding lanes are exactly zero in both."""
    f1, f2 = _features(rng, 2, 16, 32, 24)
    want, wdims = build_corr_pyramid_pallas(jnp.asarray(f1), jnp.asarray(f2), 4,
                                            dtype=JAX_DT[dtype])
    got, gdims = tcorr.build_corr_pyramid_folded(_nchw(f1, dtype), _nchw(f2, dtype), 4)
    assert tuple(gdims) == tuple(tuple(d) for d in wdims) == (
        (16, 32), (8, 16), (4, 8), (2, 4))
    for g, w, (h, wd) in zip(got, want, gdims):
        assert g.dtype == TORCH_DT[dtype] and tuple(g.shape) == w.shape
        g, w = g.float().numpy(), _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        else:
            _assert_bf16_close(g, w)
        flat = g.reshape(*g.shape[:2], -1)
        assert (flat[..., h * wd:] == 0).all()


def test_build_folded_equals_the_volume(rng):
    """Unfolded, the folded levels are build_corr_pyramid's levels (float32;
    the two sum the channels in other orders: 1e-5)."""
    f1, f2 = _features(rng, 2, 16, 32, 24)
    levels, dims = tcorr.build_corr_pyramid_folded(_nchw(f1), _nchw(f2), 4)
    volume = tcorr.build_corr_pyramid(_nchw(f1), _nchw(f2), 4)
    for got, want in zip(unfold_levels(levels, dims), volume):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _folded_pair(rng, B=1, H8=32, W8=32, C=16):
    """JAX folded levels of f32 features and the port's copy of the values.
    32x32: level 0 folds 4 rows (8 rows of 128 lanes), 16x16 folds 8, 8x8 and
    4x4 are one zero-padded row each."""
    f1, f2 = _features(rng, B, H8, W8, C)
    levels, dims = build_corr_pyramid_pallas(jnp.asarray(f1), jnp.asarray(f2), 4)
    return levels, dims, [_port(l) for l in levels], tuple(tuple(d) for d in dims)


@pytest.mark.parametrize("ywin", [0, 16])
def test_folded_lookup_matches_jax(rng, ywin):
    """corr_lookup_folded against corr_lookup_pallas_folded (interpret mode)
    on the same levels, f32: 1e-4 (the JAX kernel contracts tent weights,
    the port gathers). ``ywin`` = 16 rows makes the JAX kernel contract only
    a row window on level 0 where a tile's windows fit in it (coordinates
    near the top of the map, y in [2, 5]) and all rows where they do not
    (x anywhere): exact either way, so the port ignores it and gives the
    same samples with and without it."""
    jlev, jdims, tlev, tdims = _folded_pair(rng)
    P = 32 * 32
    coords = np.stack([rng.uniform(-3, 35, (1, P)), rng.uniform(2, 5, (1, P))],
                      axis=-1).astype(np.float32)
    coords[:, P // 2:] = rng.uniform(-3, 35, (1, P // 2, 2))   # windows that do not fit
    want = _np(corr_lookup_pallas_folded(jlev, jdims, jnp.asarray(coords), R,
                                         tile_p=128, ywin=ywin))
    got = ops.corr_lookup_folded(tlev, tdims, torch.from_numpy(coords), R, ywin=ywin)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, P, 324)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        got, ops.corr_lookup_folded(tlev, tdims, torch.from_numpy(coords), R),
        atol=0.0, rtol=0.0)


@pytest.mark.parametrize("dims", [(8, 12), (11, 11)])
def test_folded_lookup_small_levels_match_jax(rng, dims):
    """Pyramids whose level 0 fits one row of 128 lanes (8x12: 96 values,
    11x11: 121): every level is one zero-padded row and no w but 1 divides
    128, which the kernel addresses with a pixel stride of 128 and a row
    stride of w. corr_lookup_folded against corr_lookup_pallas_folded
    (interpret mode) on the same random levels, f32: 1e-4, coordinates
    inside and past every level's edges."""
    H8, W8 = dims
    level_dims = ((H8, W8), (H8 // 2, W8 // 2), (H8 // 4, W8 // 4), (H8 // 8, W8 // 8))
    B, P = 2, 64
    levels = []
    for h, w in level_dims:
        v = rng.standard_normal((B, P, 128)).astype(np.float32)
        v[..., h * w:] = 0.0                    # zero padding, as the build leaves it
        levels.append(v.reshape(B, P, 1, 128))
    coords = rng.uniform(-6, W8 + 6, (B, P, 2)).astype(np.float32)
    want = _np(corr_lookup_pallas_folded([jnp.asarray(v) for v in levels], level_dims,
                                         jnp.asarray(coords), R, tile_p=64))
    got = ops.corr_lookup_folded([torch.from_numpy(v) for v in levels], level_dims,
                                 torch.from_numpy(coords), R)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, P, 324)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_folded_lookup_through_corr_lookup_tag(rng):
    """The ("fold", levels, dims) tag against JAX's corr_lookup on its own
    tagged tuple (the Pallas kernel in interpret mode), f32: 1e-4."""
    jlev, jdims, tlev, tdims = _folded_pair(rng, B=2, H8=16, W8=16)
    coords = rng.uniform(-4, 20, (2, 256, 2)).astype(np.float32)
    want = _np(jax_corr_lookup(("fold", jlev, jdims),
                               jnp.asarray(coords.reshape(2, 16, 16, 2)), R))
    got = tcorr.corr_lookup(("fold", tlev, tdims), torch.from_numpy(coords), R)
    np.testing.assert_allclose(got.numpy(), want.reshape(2, 256, -1), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dims", [(16, 32), (16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_mixed_matches_jax(rng, dtype, dims):
    """build_corr_pyramid_mixed splits the levels as JAX does: at 16x32
    level 0 folds (fold 4) and the rest stay plain (fold 8 > max_fold 4);
    at 16x16 nothing folds. Values: f32 1e-5, bf16 one bf16 ulp."""
    f1, f2 = _features(rng, 2, *dims, 24)
    jtag, jfold, jfdims, jpad = jax_build_mixed(jnp.asarray(f1), jnp.asarray(f2), 4,
                                                dtype=JAX_DT[dtype])
    ttag, tfold, tfdims, tpad = tcorr.build_corr_pyramid_mixed(_nchw(f1, dtype),
                                                               _nchw(f2, dtype), 4)
    assert ttag == jtag == "mixed"
    assert tfdims == tuple(tuple(d) for d in jfdims)
    assert len(tfold) == (1 if dims == (16, 32) else 0) and len(tpad) == 4 - len(tfold)
    for g, w in zip(tfold + tpad, list(jfold) + list(jpad)):
        assert g.dtype == TORCH_DT[dtype] and tuple(g.shape) == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=1e-5)
        else:
            _assert_bf16_close(g.float().numpy(), _np(w))


@pytest.mark.parametrize("dims", [(16, 32), (16, 16)])
def test_mixed_lookup_matches_jax(rng, dims):
    """corr_lookup_mixed on JAX's mixed pyramid values against JAX's exact
    dispatch (unfold + tent matmuls on the CPU), and where a level folds
    also against corr_lookup_pallas_mixed in interpret mode; f32: 1e-4, as
    tests/test_pallas_ops.py holds the JAX kernel. 16x16 is the all-plain
    case, where no level folds."""
    H8, W8 = dims
    P = H8 * W8
    f1, f2 = _features(rng, 2, H8, W8, 24)
    jvol = jax_build_mixed(jnp.asarray(f1), jnp.asarray(f2), 4)
    tvol = ("mixed", [_port(a) for a in jvol[1]], tuple(tuple(d) for d in jvol[2]),
            [_port(a) for a in jvol[3]])
    coords = rng.uniform(-4, W8 + 4, (2, P, 2)).astype(np.float32)
    got = tcorr.corr_lookup(tvol, torch.from_numpy(coords), R)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, P, 324)
    want = _np(jax_corr_lookup(jvol, jnp.asarray(coords.reshape(2, H8, W8, 2)), R))
    np.testing.assert_allclose(got.numpy(), want.reshape(2, P, -1), atol=1e-4, rtol=1e-4)
    if jvol[1]:
        want = _np(corr_lookup_pallas_mixed(jvol[1], jvol[2], jvol[3], jnp.asarray(coords),
                                            R, tile_p=256))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dims", [(135, 240), (64, 64), (8, 9), (60, 68), (48, 64),
                                  (16, 24), (32, 48), (270, 480)])
def test_packable_dims_as_jax(dims):
    """'fold' takes exactly the maps JAX's _packable takes, and raises JAX's
    ValueError for the others (1080x1920, W8 = 240, among them)."""
    H8, W8 = dims
    ok = tcorr.packable(H8, W8, 4)
    assert ok == jax_packable(H8, W8, 4)
    f = torch.zeros((1, 4, H8, W8))
    if ok:
        levels, ldims = tcorr.build_corr_pyramid_folded(f, f, 4)
        assert len(levels) == 4 and ldims[0] == dims
    else:
        with pytest.raises(ValueError, match="corr_method='fold' needs packable dims"):
            tcorr.build_corr_pyramid_folded(f, f, 4)


def test_fold_model_raises_on_unpackable_dims():
    """RAFT with corr_method 'fold' on 1080x1920 features (135x240) raises
    the ValueError before building anything."""
    model = RAFT(RAFTParams(corr_method="fold"))
    f = torch.zeros((1, 256, 135, 240))
    with pytest.raises(ValueError, match="packable dims, got 135x240"):
        model.flow_from_features(f, f, f, iters=1)


def test_folded_wrappers_count_no_launch_on_cpu(rng):
    """On CPU tensors the wrappers take their plain versions and count no
    kernel launch."""
    jlev, jdims, tlev, tdims = _folded_pair(rng, H8=16, W8=16)
    coords = torch.zeros((1, 256, 2))
    ops.reset_launch_counts()
    ops.corr_lookup_folded(tlev, tdims, coords, R)
    ops.corr_lookup_mixed([], (), tcorr.build_corr_pyramid(
        torch.zeros(1, 8, 16, 16), torch.zeros(1, 8, 16, 16), 4), coords, R)
    ops.corr_build_folded(torch.zeros(1, 8, 256), [torch.zeros(1, 8, 256)])
    assert all(v == 0 for v in ops.launch_counts().values())
