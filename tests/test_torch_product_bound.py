"""The error bound that holds the bfloat16 tensor-core products to their plain versions.

On the card the bf16 volume build (#5), convolution (#13) and fused lookup
(K1) sum on the tensor cores in an order of their own and are held to
``ops.product_error_bound`` against the plain versions on every element
(tests/test_torch_kernels_cuda.py, chip_smoke.py). Here, on the CPU:
- the bound covers an independent summation order: JAX's Pallas kernels in
  interpret mode, in bf16, against the port's plain versions;
- it covers a float32 sum of the same exact products in a random order
  (K1: reversed, and in blocks of 16 as wgmma's k16 steps sum);
- it has teeth: the plain result with one channel or one tap dropped, or
  without the bias, breaks it on some element, at the cuda tests' shapes;
- the conv kernel's weight reordering round-trips.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from mft_tpu.ops.conv_pallas import conv_pallas as jax_conv_pallas
from mft_tpu.ops.corr_lookup_pallas import build_corr_pyramid_pallas
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft import corr as tcorr
from mft_tpu_torch.ops.product import corr_scale

# the update block's convs with their channels cut by 8 (Cout 2 kept), as
# tests/test_torch_conv.py: (Cout, Cin, kh, kw, act)
JAX_SHAPES = {
    "convc1": (32, 41, 1, 1, "relu"), "convc2": (24, 32, 3, 3, "relu"),
    "gru_zr1": (32, 48, 1, 5, None), "gru_q2": (16, 48, 5, 1, "tanh"),
    "flow_head2": (2, 32, 3, 3, None), "gru_z": (16, 24, 1, 5, "sigmoid"),
}
# tests/test_torch_kernels_cuda.py's conv shapes: (Cout, Cin, kh, kw)
CUDA_SHAPES = [(64, 81, 1, 1), (48, 64, 3, 3), (16, 32, 3, 3), (32, 64, 3, 3),
               (64, 96, 1, 5), (32, 96, 5, 1), (64, 32, 3, 3), (2, 64, 3, 3)]


def _violations(got, want, magnitude, K, scale=1.0) -> int:
    """Elements with |got - want| above the bound."""
    bound = ops.product_error_bound(want, magnitude, K, scale)
    return int(((got.float() - want.float()).abs() > bound).sum())


def _conv_inputs(rng, Cout, Cin, kh, kw, B=2, H=12, W=20):
    """NCHW bf16 activations, nn.Conv2d weights (bf16), a float32 bias."""
    x = torch.from_numpy(rng.standard_normal((B, Cin, H, W)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((Cout, Cin, kh, kw))
                          / np.sqrt(Cin * kh * kw)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal((Cout,))).astype(np.float32))
    return x.bfloat16(), w.bfloat16(), b, ((kh // 2, kh // 2), (kw // 2, kw // 2))


@pytest.mark.parametrize("name", sorted(JAX_SHAPES))
def test_bound_covers_jax_conv(rng, name):
    """JAX's conv_pallas (interpret mode, bf16: one f32 dot per tap) against
    the port's plain version (one k at a time): within the bound on every
    element."""
    Cout, Cin, kh, kw, act = JAX_SHAPES[name]
    x, w, b, pad = _conv_inputs(rng, Cout, Cin, kh, kw, H=8, W=16)
    want = ops.conv_pallas_ref(x, w, b, pad, act=act)
    got = jax_conv_pallas(jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16),
                          jnp.asarray(w.float().permute(2, 3, 1, 0).numpy(), jnp.bfloat16),
                          jnp.asarray(b.numpy()), pad, act=act)
    got = torch.from_numpy(np.array(got.astype(jnp.float32))).permute(0, 3, 1, 2)
    assert got.shape == want.shape
    assert _violations(got, want, ops.conv_pallas_magnitude(x, w, pad), Cin * kh * kw) == 0


def test_bound_covers_jax_build(rng):
    """JAX's build_corr_pyramid_pallas (interpret mode, bf16: one f32
    dot_general per 128-lane row) against the port's plain folded build, on
    a 16x32 map with C = 40: every level within the bound."""
    f1 = rng.standard_normal((2, 16, 32, 40)).astype(np.float32)
    f2 = rng.standard_normal((2, 16, 32, 40)).astype(np.float32)
    got, _ = build_corr_pyramid_pallas(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jnp.bfloat16)
    t1 = torch.from_numpy(f1).permute(0, 3, 1, 2).bfloat16()
    t2 = torch.from_numpy(f2).permute(0, 3, 1, 2).bfloat16()
    want, _ = tcorr.build_corr_pyramid_folded(t1, t2, 4, plain=True)
    a, f2_levels, _ = tcorr.folded_operands(t1, t2, 4)
    mags = ops.corr_build_folded_magnitude(a, f2_levels)
    for g, w, m in zip(got, want, mags):
        g = torch.from_numpy(np.array(g.astype(jnp.float32)))
        assert g.shape == w.shape
        assert _violations(g, w, m, 40, corr_scale(40)) == 0


def _permuted_conv(x, w, b, pad, act, perm):
    """conv_pallas_ref's sum of the exact products, k = (c, ky, kx) taken in
    the order ``perm``, in float32."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = w.shape
    (pt, pb), (pl, pr) = pad
    xp = F.pad(x.float(), (pl, pr, pt, pb))
    wf = w.float()
    acc = torch.zeros((B, Cout, H, W))
    for k in perm:
        c, t = divmod(int(k), kh * kw)
        ky, kx = divmod(t, kw)
        acc += xp[:, c:c + 1, ky:ky + H, kx:kx + W] * wf[:, c, ky, kx].view(1, Cout, 1, 1)
    acc += b.view(1, Cout, 1, 1)
    return {None: acc, "relu": torch.relu(acc)}[act].bfloat16()


@pytest.mark.parametrize("shape", CUDA_SHAPES[:4])
def test_bound_covers_permuted_conv_sum(rng, shape):
    """A float32 sum of the same terms in a random order stays within it."""
    Cout, Cin, kh, kw = shape
    x, w, b, pad = _conv_inputs(rng, Cout, Cin, kh, kw)
    want = ops.conv_pallas_ref(x, w, b, pad, act="relu")
    got = _permuted_conv(x, w, b, pad, "relu", rng.permutation(Cin * kh * kw))
    assert _violations(got, want, ops.conv_pallas_magnitude(x, w, pad), Cin * kh * kw) == 0


def test_bound_covers_permuted_build_sum(rng):
    """The folded build's float32 sum over the channels in a random order,
    scaled and rounded once, stays within it on every level."""
    f1 = torch.from_numpy(rng.standard_normal((3, 40, 16, 32)).astype(np.float32)).bfloat16()
    f2 = torch.from_numpy(rng.standard_normal((3, 40, 16, 32)).astype(np.float32)).bfloat16()
    a, f2_levels, _ = tcorr.folded_operands(f1, f2, 4)
    want = ops.corr_build_folded_ref(a, f2_levels)
    mags = ops.corr_build_folded_magnitude(a, f2_levels)
    perm = rng.permutation(40)
    for lvl, (w, m) in enumerate(zip(want, mags)):
        f2l = f2_levels[lvl].float()
        acc = torch.zeros((3, a.shape[2], f2l.shape[2]))
        for c in perm:
            acc += a[:, c, :, None].float() * f2l[:, c, None, :]
        got = (acc * corr_scale(40)).bfloat16().reshape(w.shape)
        assert _violations(got, w, m, 40, corr_scale(40)) == 0


@pytest.mark.parametrize("drop", ["channel", "tap", "bias"])
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_bound_has_teeth_conv(rng, shape, drop):
    """The plain conv with its middle input channel or middle tap dropped, or
    without the bias, breaks the bound on some element."""
    Cout, Cin, kh, kw = shape
    x, w, b, pad = _conv_inputs(rng, Cout, Cin, kh, kw)
    want = ops.conv_pallas_ref(x, w, b, pad)
    w2, b2 = w.clone(), b.clone()
    if drop == "channel":
        w2[:, Cin // 2] = 0
    elif drop == "tap":
        w2[:, :, kh // 2, kw // 2] = 0
    else:
        b2.zero_()
    broken = ops.conv_pallas_ref(x, w2, b2, pad)
    assert _violations(broken, want, ops.conv_pallas_magnitude(x, w, pad), Cin * kh * kw) > 0


def test_bound_has_teeth_build(rng):
    """The folded build with one channel of f1 dropped breaks the bound on
    some element of every level (the cuda tests' 16x32, C = 40)."""
    f1 = torch.from_numpy(rng.standard_normal((3, 40, 16, 32)).astype(np.float32)).bfloat16()
    f2 = torch.from_numpy(rng.standard_normal((3, 40, 16, 32)).astype(np.float32)).bfloat16()
    a, f2_levels, _ = tcorr.folded_operands(f1, f2, 4)
    want = ops.corr_build_folded_ref(a, f2_levels)
    dropped = a.clone()
    dropped[:, 20] = 0
    broken = ops.corr_build_folded_ref(dropped, f2_levels)
    mags = ops.corr_build_folded_magnitude(a, f2_levels)
    for g, w, m in zip(broken, want, mags):
        assert _violations(g, w, m, 40, corr_scale(40)) > 0


@pytest.mark.parametrize("shape", CUDA_SHAPES + [(126, 256, 3, 3), (576, 128, 1, 1)])
def test_conv_weight_tiles_round_trip(rng, shape):
    """(Cout, Cin, kh, kw) -> (kh*kw, npad, cpad): tap-major, zeros past Cout
    and Cin, npad 8 for Cout <= 8 else a multiple of 64, cpad a multiple of
    64; back to the weights exactly."""
    Cout, Cin, kh, kw = shape
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    tiles = ops.conv_weight_tiles(w)
    npad = 8 if Cout <= 8 else -(-Cout // 64) * 64
    assert tiles.shape == (kh * kw, npad, -(-Cin // 64) * 64) and tiles.dtype == w.dtype
    back = tiles[:, :Cout, :Cin].reshape(kh, kw, Cout, Cin).permute(2, 3, 0, 1)
    assert torch.equal(back, w)
    assert not tiles[:, Cout:].any() and not tiles[:, :, Cin:].any()
    assert torch.equal(tiles[kw * (kh // 2) + kw // 2, :Cout, :Cin], w[:, :, kh // 2, kw // 2])


def _fused_inputs(rng, B=2, H8=6, W8=8, F=48):
    """K1's operands: a bf16 pyramid of 4 levels of random values, coords
    leaving the maps, a bf16 (C, F) convc1 kernel (C = 324) and an f32 bias."""
    dims = [(H8, W8), (H8 // 2, W8 // 2), (H8 // 4, W8 // 4), (1, 1)]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    pyr = [t(rng.standard_normal((B, H8 * W8, h, w))).bfloat16() for h, w in dims]
    coords = t(rng.uniform(-6, W8 + 6, (B, H8 * W8, 2)))
    wc = t(rng.standard_normal((324, F)) * 0.05).bfloat16()
    return pyr, coords, wc, t(0.1 * rng.standard_normal(F))


def test_fused_magnitude_matches_numpy(rng):
    """ops.corr_lookup_fused_magnitude is sum_k |sample_k| * |wc[k, f]| of
    the bf16 samples and kernel, against a float64 numpy sum."""
    pyr, coords, wc, _ = _fused_inputs(rng)
    s = ops.corr_lookup_ref(pyr, coords, 4).float().numpy().astype(np.float64)
    want = np.abs(s) @ np.abs(wc.float().numpy().astype(np.float64))
    got = ops.corr_lookup_fused_magnitude(pyr, coords, wc, 4)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _fused_acc(samples, w, order):
    """samples @ w, the float32 sum of the exact products over k taken
    ``order``: 'in order' (the plain version's sequential sum: each product
    is exact, so each step rounds once, as a fused multiply-add), 'reversed',
    'blocked by 16' (a partial sum per 16 k, the partials added in order), or
    with sample k = 100 'dropped'."""
    C = w.shape[0]
    acc = torch.zeros((*samples.shape[:-1], w.shape[1]))
    if order == "blocked by 16":
        for k0 in range(0, C, 16):
            part = torch.zeros_like(acc)
            for k in range(k0, min(k0 + 16, C)):
                part += samples[..., k, None] * w[k]
            acc += part
    else:
        for k in (reversed(range(C)) if order == "reversed" else range(C)):
            if not (order == "dropped" and k == 100):
                acc += samples[..., k, None] * w[k]
    return acc


def _fused_sum(samples, w, bias, order):
    """relu(samples @ w + bias) in bf16, summed as :func:`_fused_acc`."""
    return torch.relu(_fused_acc(samples, w, order) + bias).bfloat16()


@pytest.mark.parametrize("order", ["reversed", "blocked by 16", "dropped"])
def test_bound_covers_fused_sum_orders(rng, order):
    """K1's 324-term sum in bf16, reversed or blocked by 16 (wgmma's k16
    steps), stays within the bound of corr_lookup_fused_ref on every element:
    the bound admits any order. With one window sample dropped it breaks."""
    pyr, coords, wc, bias = _fused_inputs(rng)
    want = ops.corr_lookup_fused_ref(pyr, coords, wc, bias, 4)
    samples = ops.corr_lookup_ref(pyr, coords, 4).float()
    got = _fused_sum(samples, wc.float(), bias, order)
    mag = ops.corr_lookup_fused_magnitude(pyr, coords, wc, 4)
    assert got.shape == want.shape
    if order == "dropped":
        assert _violations(got, want, mag, 324) > 0
    else:
        assert _violations(got, want, mag, 324) == 0


# corr_lookup.cu kWindow: the bf16 K1's rounding repair recomputes an output
# in the plain version's order where relu(acc - e + b) and relu(acc + e + b)
# round to two bf16 values, e = REPAIR_WINDOW * ||a_p|| * max_f ||w_f||
REPAIR_WINDOW = 2.0 ** -20


@pytest.mark.parametrize("order", ["reversed", "blocked by 16"])
def test_repair_window_covers_sum_orders(rng, order):
    """The premise of K1's rounding repair, on every element at convc1's
    width (F = 256): a float32 sum of the 324 exact products in another
    order differs from the plain version's sequential sum by less than a
    quarter of the window e (room for the tensor cores' sums, which differ
    from the plain one about twice as much as a round-to-nearest blocked
    sum does), so the outputs that the window passes round as the plain
    version's, and the repaired result equals the plain one bit for bit;
    the window flags under 3% of the outputs."""
    pyr, coords, wc, bias = _fused_inputs(rng, H8=16, W8=16, F=256)
    samples = ops.corr_lookup_ref(pyr, coords, 4).float()
    w = wc.float()
    plain = _fused_acc(samples, w, "in order")
    other = _fused_acc(samples, w, order)
    e = (REPAIR_WINDOW * samples.double().norm(dim=-1, keepdim=True)
         * w.double().norm(dim=0).max()).float()
    assert bool(((other - plain).abs() < e / 4).all())
    flagged = (torch.relu(other - e + bias).bfloat16().view(torch.int16)
               != torch.relu(other + e + bias).bfloat16().view(torch.int16))
    repaired = torch.where(flagged, plain, other)
    want = torch.relu(plain + bias).bfloat16()
    assert torch.equal(torch.relu(repaired + bias).bfloat16().view(torch.int16),
                       want.view(torch.int16))
    assert float(flagged.float().mean()) < 0.03
