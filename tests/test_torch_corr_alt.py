"""The port's feature-based window correlations ('alt', 'win') against the JAX package.

The same numpy inputs go through the JAX Pallas kernels ``corr_lookup_alt``
and ``corr_lookup_win`` (interpret mode on the CPU, as
tests/test_pallas_ops.py runs them) and through the port's wrappers, which
use their plain PyTorch version for CPU tensors. The kernels themselves are
held against that plain version on the card by
tests/test_torch_kernels_cuda.py.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.models.raft.corr import _lookup_level_mxu
from mft_tpu.ops.alt_corr_pallas import (build_feature_pyramid as jax_feature_pyramid,
                                         build_feature_pyramid_slab, corr_lookup_alt,
                                         corr_lookup_win)
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft.corr import build_feature_pyramid, normalize_features
from mft_tpu_torch.models.raft.raft import (AUTO_ALIASES, CORR_METHODS,
                                            VOLUME_METHODS, RAFT, RAFTParams)
from mft_tpu_torch.models.raft.wrapper import SAME_CONV_BACKENDS, raft_params_from_config

R = 4
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _features(rng, B, H8, W8, C):
    f1 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    return f1, f2


def _coords(rng, kind, B, H8, W8):
    if kind == "wild":
        c = rng.random((B, H8 * W8, 2)) * [[W8 * 1.4, H8 * 1.4]] - 3
    else:
        g = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, H8 * W8, 2)
        c = g + rng.random((B, H8 * W8, 2)) * 4 - 2
    return c.astype(np.float32)


def _port(f1, f2, coords, levels, dtype="float32", lookup=ops.corr_lookup_alt):
    """The port's lookup on (B, H8, W8, C) numpy features (CPU: plain version)."""
    t = lambda a: torch.from_numpy(a).to(TORCH_DT[dtype])
    pyr = build_feature_pyramid(t(f2).permute(0, 3, 1, 2), levels)
    return lookup(t(f1), pyr, torch.from_numpy(coords), R)


def test_alt_matches_jax_alt_kernel(rng):
    """f32, B=1, 8x16, C=32, 4 levels, coordinates leaving the map on every
    side: the JAX kernel contracts tent matrices, the port sums 100 tap dots
    bilinearly; both exact in f32 up to summation order: 1e-4 abs and rel."""
    B, H8, W8, C = 1, 8, 16, 32
    f1, f2 = _features(rng, B, H8, W8, C)
    coords = _coords(rng, "wild", B, H8, W8)
    want = corr_lookup_alt(jnp.asarray(f1.reshape(B, H8 * W8, C)),
                           jax_feature_pyramid(jnp.asarray(f2), 4, dtype=jnp.float32),
                           jnp.asarray(coords), R, tile_p=128)
    got = _port(f1, f2, coords, 4)
    assert got.dtype == torch.float32 and got.shape == (B, H8 * W8, 4 * 81)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


WIN_ROWS = {"local": slice(0, 128), "misaligned": slice(128, 256), "wild": slice(256, 512)}


@pytest.fixture(scope="module")
def win_case():
    """One JAX ``corr_lookup_win`` call (interpret mode) at B=1, 32x16, C=16,
    4 levels, 64-pixel tiles. Its level 0 folds 8 rows into a slab row and
    keeps a 16-row window, chosen per tile: tiles 0-1 hold local coordinates
    (grid + U(-1, 1); window rows [0, 16)), tiles 2-3 the centres near y = 17
    of test_pallas_ops.py test_corr_lookup_win_misaligned_window (window
    [8, 24), which must start fold-aligned), tiles 4-7 wild ones (the
    all-rows fallback)."""
    rng = np.random.default_rng(1)
    B, H8, W8, C = 1, 32, 16, 16
    P = H8 * W8
    f1, f2 = _features(rng, B, H8, W8, C)
    grid = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, P, 2)
    coords = (grid + rng.uniform(-1, 1, (B, P, 2))).astype(np.float32)
    coords[:, WIN_ROWS["misaligned"]] = np.stack(
        [rng.uniform(1, 15, (B, 128)), rng.uniform(16.5, 17.5, (B, 128))], axis=-1)
    coords[:, WIN_ROWS["wild"]] = _coords(rng, "wild", B, H8, W8)[:, WIN_ROWS["wild"]]
    want = corr_lookup_win(jnp.asarray(f1.reshape(B, P, C)),
                           build_feature_pyramid_slab(jnp.asarray(f2), 4, dtype=jnp.float32),
                           jnp.asarray(coords), R, tile_p=64)
    got = _port(f1, f2, coords, 4, lookup=ops.corr_lookup_win)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kind", sorted(WIN_ROWS))
def test_win_matches_jax_win_kernel(win_case, kind):
    """f32: the port's ``corr_lookup_win`` computes the same function as the
    JAX kernel on either of its paths: 1e-4 abs and rel."""
    got, want = win_case
    rows = WIN_ROWS[kind]
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_pyramid_matches_jax(rng, dtype):
    """Pooled target features, odd sizes pooled with floor (7x9 -> 3x4 ->
    1x2 -> 0x1 is cut at 3 levels): f32 equal to 1e-6; bf16 both round the
    f32 mean once, to within one bf16 ulp (rtol 8e-3)."""
    B, H8, W8, C = 2, 7, 9, 16
    _, f2 = _features(rng, B, H8, W8, C)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_feature_pyramid(jnp.asarray(f2).astype(jdt), 3, dtype=jdt)
    got = build_feature_pyramid(torch.from_numpy(f2).to(TORCH_DT[dtype])
                                .permute(0, 3, 1, 2), 3)
    tol = (1e-6, 1e-6) if dtype == "float32" else (1e-6, 8e-3)
    for g, (w, (h, ww)) in zip(got, want):
        assert g.shape == (B, h, ww, C) and g.dtype == TORCH_DT[dtype] and g.is_contiguous()
        np.testing.assert_allclose(g.float().numpy().reshape(B, h * ww, C),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=tol[0], rtol=tol[1])


def test_alt_bf16_matches_exact_function(rng):
    """bf16 features: the port dots bf16 values in f32 and rounds each sample
    once to bf16. Reference: the JAX exact volume lookup (_lookup_level_mxu)
    in f32 over the volume of the same bf16 feature values, made in float64.
    Tolerance: one bf16 rounding, rtol 2^-8 = 3.9e-3, plus atol 1e-5."""
    B, H8, W8, C = 2, 8, 16, 32
    f1, f2 = _features(rng, B, H8, W8, C)
    coords = _coords(rng, "wild", B, H8, W8)
    got = _port(f1, f2, coords, 4, dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    t1 = torch.from_numpy(f1).to(torch.bfloat16).double().numpy().reshape(B, -1, C)
    pyr = build_feature_pyramid(torch.from_numpy(f2).to(torch.bfloat16).permute(0, 3, 1, 2), 4)
    want = []
    for lvl, f2l in enumerate(pyr):
        h, w = f2l.shape[1:3]
        vol = np.einsum("bpc,bqc->bpq", t1, f2l.double().numpy().reshape(B, h * w, C))
        vol = (vol / math.sqrt(C)).astype(np.float32).reshape(B, H8 * W8, h, w)
        want.append(np.asarray(_lookup_level_mxu(jnp.asarray(vol),
                                                 jnp.asarray(coords) / 2.0 ** lvl, R)))
    want = np.concatenate(want, axis=-1)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5, rtol=2.0 ** -8)


def test_plain_version_is_per_pixel(rng):
    """Chunking and pixel subsets do not change a sample (the property the
    2160x3840 check on sampled pixels relies on): bit-identical, since every
    dot is summed in one fixed order."""
    B, H8, W8, C = 2, 6, 10, 24
    f1, f2 = _features(rng, B, H8, W8, C)
    coords = torch.from_numpy(_coords(rng, "wild", B, H8, W8))
    f1t = torch.from_numpy(f1)
    pyr = build_feature_pyramid(torch.from_numpy(f2).permute(0, 3, 1, 2), 3)
    full = ops.corr_lookup_alt_ref(f1t, pyr, coords, R)
    same = lambda a, b: torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    same(ops.corr_lookup_alt_ref(f1t, pyr, coords, R, chunk=7), full)
    idx = torch.from_numpy(rng.choice(H8 * W8, 17, replace=False))
    sub = ops.corr_lookup_alt_ref(f1t.reshape(B, -1, C)[:, idx], pyr, coords[:, idx], R,
                                  chunk=5)
    same(sub, full[:, idx])


@pytest.mark.parametrize("lookup", [ops.corr_lookup_alt, ops.corr_lookup_win])
def test_wrappers_raise_off_cpu_and_cuda(lookup):
    """A tensor on neither the CPU nor a card raises; it is never moved."""
    f1 = torch.zeros((1, 4, 4, 8), device="meta")
    pyr = [torch.zeros((1, 4, 4, 8), device="meta")]
    coords = torch.zeros((1, 16, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lookup(f1, pyr, coords, R)


# every JAX corr_method other than 'auto', 'alt' and 'win'
OTHER_JAX_METHODS = ("fold", "gather", "int8", "mixed", "mxu", "packed", "packed_i8",
                     "pallas", "pallas_t")


@pytest.mark.parametrize("method", OTHER_JAX_METHODS)
def test_unported_corr_method_raises(method):
    """Every JAX corr_method is ported now, none raises: the volume methods
    and the aliases of 'auto' ('mxu', 'gather', 'pallas', the same function;
    their JAX parity is in test_torch_schedule.py) are read as they are and
    run: one iteration on 8x8 features gives finite flow, an alias the
    'auto' path's flow."""
    assert set(OTHER_JAX_METHODS) == set(AUTO_ALIASES) | set(VOLUME_METHODS)
    params = raft_params_from_config({"corr_method": method})
    assert params.corr_method == method
    f = torch.randn((1, 256, 8, 8), generator=torch.Generator().manual_seed(0))
    model = RAFT(params)
    with torch.no_grad():
        out = model.flow_from_features(f, f.flip(-1), f, iters=1)
    assert out["flow"].shape == (1, 64, 64, 2) and bool(out["flow"].isfinite().all())
    if method in AUTO_ALIASES:
        model.cfg = RAFTParams()
        with torch.no_grad():
            want = model.flow_from_features(f, f.flip(-1), f, iters=1)
        assert torch.equal(out["flow"], want["flow"])


def test_ported_corr_methods_are_read():
    for method in CORR_METHODS:
        assert raft_params_from_config({"corr_method": method}).corr_method == method
    assert raft_params_from_config({}).corr_method == "auto"
    with pytest.raises(ValueError, match="unknown corr_method"):
        raft_params_from_config({"corr_method": "volume"})
    assert RAFT(RAFTParams(corr_method="win")).cfg.corr_method == "win"


@pytest.mark.parametrize("key,value", [("normalized_features", True),
                                       ("relu_uncertainty", True),
                                       ("OU_last_iter_only", True),
                                       ("conv_backend", "pallas")])
def test_unported_raft_options_raise(key, value):
    """Every option of this list, once unported, is read and runs now; none
    raises. normalized_features: the model on (f1, f2) gives the default
    model's outputs on the normalized features (``corr.normalize_features``),
    bit for bit (the context features are not normalized). relu_uncertainty:
    the default model's outputs with relu on the uncertainty, bit for bit.
    conv_backend 'pallas' is read and runs: the model's update block takes
    it, and one step of it computes the 'auto' block's result (f32, 1e-4;
    the product kernel's plain version on the CPU). OU_last_iter_only is
    read; in test mode the heads run on the last iteration either way, so
    the flow is the default model's, bit for bit (its train-mode effect is
    held against JAX in tests/test_torch_train_model.py). Their JAX parity
    is in tests/test_torch_raft_variants.py."""
    f = torch.randn((1, 256, 8, 8), generator=torch.Generator().manual_seed(0))
    if key in ("normalized_features", "relu_uncertainty", "OU_last_iter_only"):
        params = raft_params_from_config({key: value})
        assert getattr(params, {"OU_last_iter_only": "ou_last_iter_only"}.get(key, key))
        default = RAFT(raft_params_from_config({}))
        model = RAFT(params)
        model.load_state_dict(default.state_dict())
        with torch.no_grad():
            got = model.flow_from_features(f, f.flip(-1), f, iters=2)
            if key == "normalized_features":
                want = default.flow_from_features(normalize_features(f),
                                                  normalize_features(f.flip(-1)), f, iters=2)
            else:
                want = default.flow_from_features(f, f.flip(-1), f, iters=2)
        if key == "relu_uncertainty":
            assert bool((got["uncertainty"] >= 0).all())
            want["uncertainty"] = torch.relu(want["uncertainty"])
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        return
    params = raft_params_from_config({key: value})
    assert params.conv_backend == "pallas"
    block = RAFT(params).update_block
    assert block.conv_backend == "pallas"
    auto = RAFT(raft_params_from_config({})).update_block
    block.load_state_dict(auto.state_dict())
    gen = torch.Generator().manual_seed(0)
    t = lambda c: torch.randn((1, c, 3, 5), generator=gen)
    args = (t(128), t(128), t(324), t(2))
    with torch.no_grad():
        for g, w in zip(block(*args, need_mask=False), auto(*args, need_mask=False)):
            if w is not None:
                torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_conv_backends_of_the_same_convolution_are_accepted():
    for backend in SAME_CONV_BACKENDS:
        assert raft_params_from_config({"conv_backend": backend}) == RAFTParams(
            compute_dtype="auto")
    with pytest.raises(ValueError, match="unknown conv_backend"):
        raft_params_from_config({"conv_backend": "winograd"})


@pytest.mark.parametrize("tile,ok", [(0, True), (8, True), (16, True), (256, True),
                                     (12, False), (4, False), (24, False)])
def test_corr_tile_is_checked(tile, ok):
    """corr_tile: 0 or a power of two >= 8, as the JAX wrapper's _pow2_tile
    checks it; a valid tile changes nothing in the port, a bad one raises."""
    if ok:
        assert raft_params_from_config({"corr_tile": tile}) == RAFTParams(
            compute_dtype="auto")
    else:
        with pytest.raises(ValueError, match="corr_tile"):
            raft_params_from_config({"corr_tile": tile})


@pytest.mark.parametrize("value", ["auto", "on", "off"])
def test_fuse_lookup_values_are_accepted(value):
    """fuse_lookup chooses the TPU's fusion of lookup and convc1, not the
    function; the port fuses on the 'auto' volume path whatever it says."""
    assert raft_params_from_config({"fuse_lookup": value}) == RAFTParams(
        compute_dtype="auto")
