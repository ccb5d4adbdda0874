"""The port's correlation pyramid and window lookups against the JAX package.

Same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode on the CPU, as tests/test_pallas_ops.py runs them, and the
exact ``_lookup_level_mxu`` math) and through the port's plain PyTorch
versions. The kernels themselves are held against those plain versions on
the card by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.models.raft.corr import _lookup_level_mxu
from mft_tpu.models.raft.corr import build_corr_pyramid as jax_build_pyramid
from mft_tpu.ops.corr_lookup_pallas import (corr_lookup_pallas,
                                            corr_lookup_pallas_fused)
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft.corr import build_corr_pyramid

B, H8, W8, C, R = 2, 8, 16, 64, 4
P = H8 * W8
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _features(rng):
    f1 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    return f1, f2


def _inputs(rng, dtype):
    """JAX-built pyramid in ``dtype`` (as numpy f32 values), coords leaving
    the maps on every side, a convc1-shaped kernel and bias."""
    f1, f2 = _features(rng)
    pyr = [np.array(l.astype(dtype).astype(jnp.float32))
           for l in jax_build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)]
    coords = rng.uniform(-6, W8 + 6, (B, P, 2)).astype(np.float32)
    wc = (rng.standard_normal((4 * 81, 256)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((256,)) * 0.1).astype(np.float32)
    return pyr, coords, wc, bias


def _torch_pyr(pyr, dtype):
    return [torch.from_numpy(l).to(TORCH_DT[dtype]) for l in pyr]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pyramid_matches_jax(rng, dtype):
    """(B, P, h, w) levels from (B, C, H8, W8) features, one rounding to dtype.
    f32: summation order only (1e-5); bf16: one bf16 ulp of |corr| <= ~4."""
    f1, f2 = _features(rng)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jdt)
    t = lambda f: torch.from_numpy(f).permute(0, 3, 1, 2).to(TORCH_DT[dtype])
    got = build_corr_pyramid(t(f1), t(f2), 4)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == TORCH_DT[dtype]
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol, err_msg=f"level {lvl}")


def test_lookup_plain_matches_mxu_and_pallas_f32(rng):
    """f32: the exact bilinear math against the tent-matmul forms (2e-5)."""
    pyr, coords, _, _ = _inputs(rng, jnp.float32)
    got = ops.corr_lookup_ref(_torch_pyr(pyr, "float32"),
                              torch.from_numpy(coords), R).numpy()
    mxu = np.concatenate([np.asarray(_lookup_level_mxu(
        jnp.asarray(l), jnp.asarray(coords) / 2.0 ** i, R))
        for i, l in enumerate(pyr)], axis=-1)
    pallas = np.asarray(corr_lookup_pallas([jnp.asarray(l) for l in pyr],
                                           jnp.asarray(coords), R, tile_p=64))
    assert got.shape == (B, P, 324)
    np.testing.assert_allclose(got, mxu, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)


def _window_samples_np(level, coords, radius):
    """float32 numpy model of one level's window samples, every operation
    rounded where the plain version rounds it: x = c/2^l + (i - r), taps at
    floor(x) and floor(x) + 1, zeros outside the map, the four weighted taps
    summed in order."""
    B_, P_, h, w = level.shape
    off = np.arange(-radius, radius + 1, dtype=np.float32)
    x = (coords[..., 0, None, None] + off[:, None]).astype(np.float32)   # i offsets x
    y = (coords[..., 1, None, None] + off[None, :]).astype(np.float32)
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    one = np.float32(1.0)
    flat = level.reshape(B_ * P_, h * w)
    pix = np.arange(B_ * P_).reshape(B_, P_, 1, 1)

    def tap(xi, yi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = np.clip(yi, 0, h - 1).astype(np.int64) * w + np.clip(xi, 0, w - 1).astype(np.int64)
        return np.where(ok, flat[pix, idx], np.float32(0.0))

    acc = tap(x0, y0) * ((one - wx) * (one - wy))
    acc = acc + tap(x0 + 1, y0) * (wx * (one - wy))
    acc = acc + tap(x0, y0 + 1) * ((one - wx) * wy)
    acc = acc + tap(x0 + 1, y0 + 1) * (wx * wy)
    return acc.reshape(B_, P_, -1)


def test_lookup_plain_at_round_up_positions(rng):
    """Coordinates c with c/2^l = nextafter(m, -inf) for integers m != 0: for
    the window offsets k that carry |m + k| past a power of two, c/2^l + k
    rounds up to the integer m + k, so that sample's taps start one column
    (row) past floor(c/2^l) + k, the margin a kernel's staged tap box must
    keep. The port's plain lookup samples there as JAX's Pallas kernel does
    (f32, 2e-5, as above) and equals the float32 model of the positions
    rounded as written, bit for bit."""
    pyr, _, _, _ = _inputs(rng, jnp.float32)
    m = rng.integers(-3, 11, (B, P, 2))
    m = np.where(m >= 0, m + 1, m).astype(np.float32)
    level = rng.integers(0, 4, (B, P, 1)).astype(np.float32)
    coords = (np.nextafter(m, np.float32(-np.inf)) * np.float32(2.0) ** level).astype(np.float32)
    off = np.arange(-R, R + 1, dtype=np.float32)
    ups = sum(int((np.floor((coords / np.float32(2.0 ** l))[..., None] + off)
                   != np.floor(coords / np.float32(2.0 ** l))[..., None] + off).sum())
              for l in range(4))
    assert ups > 0
    got = ops.corr_lookup_ref(_torch_pyr(pyr, "float32"), torch.from_numpy(coords), R).numpy()
    pallas = np.asarray(corr_lookup_pallas([jnp.asarray(l) for l in pyr],
                                           jnp.asarray(coords), R, tile_p=64))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    model = np.concatenate([_window_samples_np(l, coords / np.float32(2.0 ** i), R)
                            for i, l in enumerate(pyr)], axis=-1)
    np.testing.assert_array_equal(got, model)


def test_lookup_plain_matches_pallas_bf16(rng):
    """bf16: the Pallas kernel rounds its tent weights and row contraction to
    bf16, the port samples exactly and rounds once: a few bf16 ulps of
    |samples| <= ~4 apart (atol 0.06, rtol 0.02)."""
    pyr, coords, _, _ = _inputs(rng, jnp.bfloat16)
    got = ops.corr_lookup_ref(_torch_pyr(pyr, "bfloat16"), torch.from_numpy(coords), R)
    want = corr_lookup_pallas([jnp.asarray(l, jnp.bfloat16) for l in pyr],
                              jnp.asarray(coords), R, tile_p=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.06, rtol=0.02)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_pallas_fused(rng, dtype):
    """relu(samples @ wc + b): f32 1e-4 (sum order); bf16 as the JAX package's
    own fused-kernel test bounds its bf16 path (0.15)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pyr, coords, wc, bias = _inputs(rng, jdt)
    got = ops.corr_lookup_fused_ref(_torch_pyr(pyr, dtype), torch.from_numpy(coords),
                                    torch.from_numpy(wc), torch.from_numpy(bias), R)
    want = corr_lookup_pallas_fused([jnp.asarray(l, jdt) for l in pyr],
                                    jnp.asarray(coords), jnp.asarray(wc, jdt),
                                    jnp.asarray(bias), R, tile_p=64)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, P, 256)
    tol = 1e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_order_is_fixed(rng, dtype):
    """K1's plain version sums in one fixed order, sequential FMAs over k
    (the order of K1's repair): every pair's rows have the same bits whether
    the call holds 1, 2 or all B pairs, and in bf16 the sums equal numpy's
    sequential float32 ``acc + a*b`` (each bf16 product exact)."""
    pyr, coords, wc, bias = _inputs(rng, jnp.float32)
    tp, tc = _torch_pyr(pyr, dtype), torch.from_numpy(coords)
    tw, tb = torch.from_numpy(wc).to(TORCH_DT[dtype]), torch.from_numpy(bias)
    whole = ops.corr_lookup_fused_ref(tp, tc, tw, tb, R)
    for m in (1, B - 1):
        part = ops.corr_lookup_fused_ref([l[:m] for l in tp], tc[:m], tw, tb, R)
        assert torch.equal(part, whole[:m])
        rest = ops.corr_lookup_fused_ref([l[m:] for l in tp], tc[m:], tw, tb, R)
        assert torch.equal(rest, whole[m:])
    if dtype == "bfloat16":
        from mft_tpu_torch.ops.corr_lookup import fused_product_ref
        s = ops.corr_lookup_ref(tp, tc, R).reshape(B * P, -1)
        got = fused_product_ref(s, tw).numpy()
        a, w = s.float().numpy(), tw.float().numpy()
        want = np.zeros((B * P, w.shape[1]), np.float32)
        for k in range(a.shape[1]):
            want = want + a[:, k:k + 1] * w[k]
        np.testing.assert_array_equal(got, want)


def test_wrappers_use_plain_version_on_cpu(rng):
    pyr, coords, wc, bias = _inputs(rng, jnp.float32)
    tp, tc = _torch_pyr(pyr, "float32"), torch.from_numpy(coords)
    ops.reset_launch_counts()
    assert torch.equal(ops.corr_lookup(tp, tc, R), ops.corr_lookup_ref(tp, tc, R))
    tw, tb = torch.from_numpy(wc), torch.from_numpy(bias)
    assert torch.equal(ops.corr_lookup_fused(tp, tc, tw, tb, R),
                       ops.corr_lookup_fused_ref(tp, tc, tw, tb, R))
    g = torch.ones((*tc.shape[:2], len(tp) * (2 * R + 1) ** 2))
    dims = [tuple(lvl.shape[2:]) for lvl in tp]
    assert all(torch.equal(a, b) for a, b in zip(ops.corr_lookup_bwd(g, tc, dims, R),
                                                   ops.corr_lookup_bwd_ref(g, tc, dims, R)))
    assert ops.launch_counts() == {k.__name__: 0 for k in ops.KERNELS}
    # the 14 kernels of the Pallas sites' paths, the backward, JPEG's J1 (decode,
    # progressive decode, encode), J2 and J3, the mp4v codec's V1 (decode,
    # encode), V2 and V3, and Motion JPEG's J4
    assert len(ops.KERNELS) == 25


@pytest.mark.parametrize("radius", [0, 1, 4, 5])
def test_gather_radius_is_checked(radius):
    """The gather kernel (corr_gather.cu) is compiled for radius 1..4; its
    wrappers refuse any other radius before they launch."""
    from mft_tpu_torch.ops.corr_lookup import GATHER_MAX_RADIUS, _check_gather_radius
    assert GATHER_MAX_RADIUS == 4
    if 1 <= radius <= 4:
        _check_gather_radius(radius)
    else:
        with pytest.raises(ValueError, match="radius 1..4"):
            _check_gather_radius(radius)


@pytest.mark.parametrize("F", [8, 96, 100, 256, 264])
def test_fused_width_is_checked(F):
    """The tensor-core fused lookup takes F a multiple of 8 up to 256 (its
    16-byte output stores, wgmma's widest N); its wrapper refuses any other
    F before it launches."""
    from mft_tpu_torch.ops.corr_lookup import FUSED_TC_MAX_F, _check_fused_width
    assert FUSED_TC_MAX_F == 256
    if F % 8 == 0 and F <= 256:
        _check_fused_width(F)
    else:
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            _check_fused_width(F)


def test_wrappers_refuse_other_devices(rng):
    pyr, coords, _, _ = _inputs(rng, jnp.float32)
    meta = [torch.empty(l.shape, device="meta") for l in pyr]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.corr_lookup(meta, torch.empty(coords.shape, device="meta"), R)



def test_k1_repair_tool_finds_its_anchors():
    """tools/torch_k1_repair.py edits corr_lookup.cu's text into its two
    variants: each anchor it edits at is in the source once, the hooked
    variant records and counts, and the other has no window test left."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("torch_k1_repair",
                                                  root / "tools" / "torch_k1_repair.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "mft_tpu_torch" / "ops" / "csrc" / "corr_lookup.cu").read_text()
    out = tool.variants(src)
    assert set(out) == {"hooked", "no repair"}
    assert "g_values[" in out["hooked"] and "atomicAdd(&g_listed" in out["hooked"]
    assert "near |= pair" in src and "near |= pair" not in out["no repair"]
