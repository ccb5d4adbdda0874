"""The port's stored forms of the correlation volume against the JAX package.

'int8' (quantized levels), 'packed' (all levels in one map), 'packed_i8'
(both) and 'pallas_t' (lane-major levels): the pyramid functions and the four
lookups.
The shapes are those of tests/test_corr_methods.py (2 pairs, 16x24 source
pixels, 16 channels, coordinates uniform in [-4, 28]). The same numpy inputs
go through the JAX functions (its exact dispatch path, and its Pallas kernels
in interpret mode on the CPU) and through the port's wrappers, which use
their plain PyTorch versions for CPU tensors. The kernels themselves are held
against those plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.models.raft.corr import build_corr_pyramid as jax_build_pyramid
from mft_tpu.models.raft.corr import corr_lookup as jax_corr_lookup
from mft_tpu.models.raft.corr import quantize_pyramid as jax_quantize
from mft_tpu.ops.corr_lookup_pallas import (build_corr_pyramid_t as jax_build_t,
                                            corr_lookup_pallas_packed,
                                            corr_lookup_pallas_packed_i8,
                                            corr_lookup_pallas_q, corr_lookup_pallas_t)
from mft_tpu.ops.corr_lookup_pallas import pack_corr_pyramid as jax_pack
from mft_tpu.ops.corr_lookup_pallas import pack_corr_pyramid_i8 as jax_pack_i8
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft import corr as tcorr

B, C, H8, W8, R = 2, 16, 16, 24, 4
P = H8 * W8
METHODS = ("int8", "packed", "packed_i8", "pallas_t")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(rng):
    f1 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    f2 = rng.standard_normal((B, H8, W8, C)).astype(np.float32)
    return f1, f2


def _nchw(f, dtype="float32"):
    return torch.from_numpy(f).permute(0, 3, 1, 2).to(TORCH_DT[dtype])


def _coords(rng):
    return rng.uniform(-4, 28, (B, P, 2)).astype(np.float32)


def _jax_pyramid(rng, dtype="float32"):
    """JAX pyramid and the port's copy of the same values."""
    f1, f2 = _features(rng)
    pyr = jax_build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=JAX_DT[dtype])
    port = [torch.from_numpy(np.array(l, np.float32)).to(TORCH_DT[dtype]) for l in pyr]
    return pyr, port


def _stored(rng, method):
    """(JAX tagged volume, port tagged volume) of one f32 pyramid."""
    f1, f2 = _features(rng)
    pyr = jax_build_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    port = [torch.from_numpy(np.array(l)) for l in pyr]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(rng, dtype):
    """int8 levels and scales equal to JAX's, bit for bit: ties round half to
    even and q = round(a * (127/mx)), not a / scale."""
    pyr, port = _jax_pyramid(rng, dtype)
    want_levels, want_scales = jax_quantize(pyr)
    got_levels, got_scales = tcorr.quantize_pyramid(port)
    assert got_scales.dtype == torch.float32 and got_scales.shape == (B, 4)
    np.testing.assert_array_equal(got_scales.numpy(), np.asarray(want_scales))
    for lvl, (g, w) in enumerate(zip(got_levels, want_levels)):
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"level {lvl}")


def test_quantize_ties_round_half_to_even():
    """Values whose a * (127/mx) is exactly k + 1/2 (mx = 127 here)."""
    a = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -33.5, 3.0],
                     dtype=torch.float32).reshape(1, 1, 1, 9)
    levels, scales = tcorr.quantize_pyramid([a])
    want_levels, want_scales = jax_quantize([jnp.asarray(a.numpy())])
    assert levels[0].flatten().tolist() == [127, -127, 0, 2, 2, 0, -2, -34, 3]
    np.testing.assert_array_equal(levels[0].numpy(), np.asarray(want_levels[0]))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))


def test_quantize_in_chunks_equals_whole(rng, monkeypatch):
    """Chunks of a few source pixels give the values of one pass, and the
    pair-by-pair build_corr_pyramid_i8 those of quantizing the whole pyramid."""
    f1, f2 = _features(rng)
    pyr = tcorr.build_corr_pyramid(_nchw(f1), _nchw(f2), 4)
    before = [lvl.clone() for lvl in pyr]
    whole_levels, whole_scales = tcorr.quantize_pyramid(pyr)
    assert all(torch.equal(a, b) for a, b in zip(pyr, before))   # input not written
    monkeypatch.setattr(tcorr, "QUANT_CHUNK", 7 * W8 * H8)
    for levels, scales in (tcorr.quantize_pyramid(pyr),
                           tcorr.build_corr_pyramid_i8(_nchw(f1), _nchw(f2), 4)):
        assert torch.equal(scales, whole_scales)
        for g, w in zip(levels, whole_levels):
            assert torch.equal(g, w)


def test_pack_matches_jax(rng):
    """The packed map (zero rows under each level), its dims, and the int8
    packed map with its scales equal JAX's."""
    pyr, port = _jax_pyramid(rng)
    want, want_dims = jax_pack(pyr)
    got, got_dims = tcorr.pack_corr_pyramid(port)
    assert got_dims == want_dims == ((16, 24), (8, 12), (4, 6), (2, 3))
    assert tuple(got.shape) == (B, P, H8, 45)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want8, want_scales, _ = jax_pack_i8(pyr)
    got8, got_scales, dims8 = tcorr.pack_corr_pyramid_i8(port)
    assert got8.dtype == torch.int8 and dims8 == want_dims
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(got_scales.numpy(), np.asarray(want_scales))
    for view, lvl in zip(tcorr.dequant_levels(tcorr.unpack_levels(got8, dims8), got_scales),
                         port):
        # the quantization error bound, max|corr| / 254 per value, plus a few
        # f32 ulps of |corr| <= 8 for the roundings of a * (127/mx) and q * scale
        bound = lvl.abs().amax(dim=(1, 2, 3))[:, None, None, None] / 254 + 4e-6
        assert bool(((view - lvl).abs() <= bound).all())


def test_packed_layout_width_guard(rng):
    """Level widths 80 + 40 + 20 + 10 = 150 > 128: both packers refuse, as
    JAX's do (tests/test_corr_methods.py)."""
    f = _nchw(rng.standard_normal((1, 80, 80, 4)).astype(np.float32))
    pyr = tcorr.build_corr_pyramid(f, f)
    with pytest.raises(ValueError, match="128"):
        tcorr.pack_corr_pyramid(pyr)
    with pytest.raises(ValueError, match="128"):
        tcorr.pack_corr_pyramid_i8(pyr)


def test_build_corr_pyramid_t_matches_jax(rng):
    """(B, h_l, w_l, P) lane-major levels in f32: sum order only (1e-5)."""
    f1, f2 = _features(rng)
    want = jax_build_t(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = tcorr.build_corr_pyramid_t(_nchw(f1), _nchw(f2), 4)
    volume = tcorr.build_corr_pyramid(_nchw(f1), _nchw(f2), 4)
    for g, w, v in zip(got, want, volume):
        assert tuple(g.shape) == w.shape and g.shape[-1] == P
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
        assert torch.equal(g.movedim(3, 1), v)


@pytest.mark.parametrize("method", METHODS)
def test_lookup_matches_jax_dispatch(rng, method):
    """Against JAX's exact dispatch path (its ``corr_lookup`` on the tagged
    tuple: on the CPU the int8 forms dequantize the same int8 values and
    sample exactly in f32). f32 forms: 1e-4; int8 forms, which both round
    the samples once to bf16: at most one bf16 ulp of the output."""
    jvol, tvol, _ = _stored(rng, method)
    coords = _coords(rng)
    want = np.asarray(jax_corr_lookup(jvol, jnp.asarray(coords.reshape(B, H8, W8, 2)),
                                      radius=R).astype(jnp.float32)).reshape(B, P, -1)
    got = tcorr.corr_lookup(tvol, torch.from_numpy(coords), R)
    assert tuple(got.shape) == (B, P, 324)
    if method in ("int8", "packed_i8"):
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want)
        assert (err <= _bf16_ulp(want) + 1e-30).all(), float(err.max())
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_lookup_matches_jax_pallas_kernel(rng, method):
    """Against the JAX Pallas kernel in interpret mode. 'packed' and
    'pallas_t' in f32: 1e-4. The int8 kernels round their tent weights and
    row contraction to bf16, so they are held to the bound JAX's own test
    uses, 4 * max|corr| / 200."""
    jvol, tvol, pyr = _stored(rng, method)
    coords = _coords(rng)
    jc = jnp.asarray(coords)
    if method == "int8":
        want = corr_lookup_pallas_q(jvol[1], jvol[2], jc, R)
    elif method == "packed":
        want = corr_lookup_pallas_packed(jvol[1], jvol[2], jc, R, tile_p=128)
    elif method == "packed_i8":
        want = corr_lookup_pallas_packed_i8(jvol[1], jvol[2], jvol[3], jc, R, tile_p=128)
    else:
        want = corr_lookup_pallas_t(jvol[1], jc, R, tile_p=128)
    want = np.asarray(want.astype(jnp.float32))
    got = tcorr.corr_lookup(tvol, torch.from_numpy(coords), R).float().numpy()
    if method in ("int8", "packed_i8"):
        bound = float(np.max(np.abs(np.asarray(pyr[0], np.float32)))) / 200.0
        np.testing.assert_allclose(got, want, atol=4 * bound)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("method", ["packed", "pallas_t"])
def test_bf16_forms_sample_in_bf16(rng, method):
    """'packed' and 'pallas_t' keep the volume dtype: a bf16 volume gives
    bf16 samples, equal to the list-of-levels lookup of the same values."""
    f1, f2 = _features(rng)
    t1, t2 = _nchw(f1, "bfloat16"), _nchw(f2, "bfloat16")
    volume = tcorr.build_corr_pyramid(t1, t2, 4)
    coords = torch.from_numpy(_coords(rng))
    if method == "packed":
        stored = ("packed", *tcorr.pack_corr_pyramid(volume))
    else:
        stored = ("t", tcorr.build_corr_pyramid_t(t1, t2, 4))
    got = tcorr.corr_lookup(stored, coords, R)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ops.corr_lookup(volume, coords, R))


def test_packed_taps_stay_in_their_level(rng):
    """Coordinates just past each level's right and bottom edges: the taps
    beyond a level's own columns are zero, never the next level's values."""
    _, port = _jax_pyramid(rng)
    packed, dims = tcorr.pack_corr_pyramid(port)
    coords = torch.from_numpy(_coords(rng))
    coords[0, :, 0] = W8 - 1 + torch.linspace(0.0, 3.0, P)     # x past level 0
    coords[1, :, 0] = torch.linspace(-2.0, 2.0 * W8, P)        # every level's edge
    coords[1, :, 1] = H8 - 1 + torch.linspace(0.0, 3.0, P)     # y past the rows
    got = ops.corr_lookup_packed(packed, dims, coords, R)
    want = ops.corr_lookup(port, coords, R)
    assert torch.equal(got, want)
    shifted = packed.clone()
    for view in tcorr.unpack_levels(shifted, dims)[1:]:
        view.fill_(1e3)                  # other levels' columns must not leak
    level0 = ops.corr_lookup_packed(shifted, dims, coords, R)[..., :81]
    assert torch.equal(level0, want[..., :81])


@pytest.mark.parametrize("method", METHODS)
def test_wrappers_count_no_launch_on_cpu(rng, method):
    """On the CPU a wrapper is its plain version and counts no launch."""
    _, tvol, _ = _stored(rng, method)
    coords = torch.from_numpy(_coords(rng))
    ops.reset_launch_counts()
    got = tcorr.corr_lookup(tvol, coords, R)
    assert torch.equal(got, tcorr.corr_lookup(tvol, coords, R, plain=True))
    assert ops.launch_counts() == {k.__name__: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("method", METHODS)
def test_wrappers_refuse_other_devices(rng, method):
    """A tensor on neither the CPU nor a card raises; it is never moved."""
    _, tvol, _ = _stored(rng, method)
    meta = tuple(torch.empty(a.shape, dtype=a.dtype, device="meta")
                 if isinstance(a, torch.Tensor) else
                 [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in a]
                 if isinstance(a, list) else a for a in tvol[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        tcorr.corr_lookup((tvol[0], *meta), torch.empty((B, P, 2), device="meta"), R)
