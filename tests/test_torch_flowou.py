"""The port's FlowOU algebra, selection, point tracking and TPU-form chain +
select against the JAX package, on the CPU.

The same numpy FlowOU maps go through each JAX function and its port. The
port samples through ``ops.bilinear_warp`` (its plain version on CPU
tensors; the CUDA kernel follows it bit for bit on the card) in 'exact'
mode, JAX through ``bilinear_sample``: the same bilinear sample, its taps
summed in another order. Stated tolerance: |d| <= 1e-5 + 1e-6*|JAX|.
``chain_select_pallas`` runs the 'tpu' mode on both sides (JAX's Pallas warp
in interpret mode): held at 1e-5 * max|map| per sample channel, and to the
same winner at every pixel.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.core import flowou as jf
from mft_tpu.tracker import point_tracking as jpt
from mft_tpu.tracker.fused import chain_select_pallas as jax_chain_select_pallas
from mft_tpu.tracker.select import select_best as jax_select_best
from mft_tpu_torch import ops
from mft_tpu_torch.core import flowou as tf
from mft_tpu_torch.tracker import point_tracking as tpt
from mft_tpu_torch.tracker.fused import chain_select_pallas
from mft_tpu_torch.tracker.select import select_best

H, W = 24, 20


def _result(rng, spread=16.0, lead=()):
    """A FlowOU of numpy arrays: flows up to +-spread/2 px (some endpoints
    leave the image), occlusion in [0, 0.04), sigma in [0.1, 2.1)."""
    flow = (rng.random((*lead, H, W, 2)) * spread - spread / 2).astype(np.float32)
    occl = (rng.random((*lead, H, W)) * 0.04).astype(np.float32)
    sigma = (rng.random((*lead, H, W)) * 2 + 0.1).astype(np.float32)
    return flow, occl, sigma


def _jax(r):
    return jf.FlowOU(*map(jnp.asarray, r))


def _port(r):
    return tf.FlowOU(*(torch.from_numpy(a) for a in r))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def _points(rng, n=50):
    """Queries over the image and a little beyond, plus half-pixel ones."""
    pts = rng.random((n, 2)) * [W + 4, H + 4] - 2
    pts[: n // 5] = np.round(pts[: n // 5] * 2) / 2
    return pts.astype(np.float32)


def test_chain_flow_and_forward_backward_error(rng):
    a, b = _result(rng)[0], _result(rng)[0]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(tf.chain_flow(ta, tb), jf.chain_flow(ja, jb))
    _close(tf.forward_backward_error(ta, tb), jf.forward_backward_error(ja, jb))
    _close(tf.forward_backward_error_magnitude(ta, tb),
           jf.forward_backward_error_magnitude(ja, jb))


@pytest.mark.parametrize("channels", [None, 1, 3])
def test_warp_backward(rng, channels):
    """2-D and 3-D images."""
    flow = _result(rng)[0]
    shape = (H, W) if channels is None else (H, W, channels)
    img = (10 * rng.standard_normal(shape)).astype(np.float32)
    _close(tf.warp_backward(torch.from_numpy(flow), torch.from_numpy(img)),
           jf.warp_backward(jnp.asarray(flow), jnp.asarray(img)))


def test_warp_forward_points_and_sample(rng):
    r = _result(rng)
    pts = _points(rng)
    _close(tf.warp_forward_points(torch.from_numpy(r[0]), torch.from_numpy(pts)),
           jf.warp_forward_points(jnp.asarray(r[0]), jnp.asarray(pts)))
    for got, want in zip(tf.sample_flowou(_port(r), torch.from_numpy(pts)),
                         jf.sample_flowou(_jax(r), jnp.asarray(pts))):
        _close(got, want)


@pytest.mark.parametrize("fn", ["chain_results", "chain_results_packed"])
def test_chain_results(rng, fn):
    left, right = _result(rng), _result(rng)
    got = getattr(tf, fn)(_port(left), _port(right))
    want = getattr(jf, fn)(_jax(left), _jax(right))
    for name in ("flow", "occlusion", "sigma"):
        _close(getattr(got, name), getattr(want, name))


def test_chain_results_packed_equals_three_samples(rng):
    """Channels are summed apart: the packed sample gives the same bits."""
    left, right = _port(_result(rng)), _port(_result(rng))
    a, b = tf.chain_results(left, right), tf.chain_results_packed(left, right)
    for name in ("flow", "occlusion", "sigma"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), atol=0.0, rtol=0.0)


def test_flowou_methods(rng):
    r, other = _result(rng), _result(rng)[0]
    pts = _points(rng)
    img = rng.standard_normal((H, W, 2)).astype(np.float32)
    p, j = _port(r), _jax(r)
    assert (p.H, p.W) == (j.H, j.W) == (H, W)
    _close(p.chain(torch.from_numpy(other)), j.chain(jnp.asarray(other)))
    _close(p.warp_backward(torch.from_numpy(img)), j.warp_backward(jnp.asarray(img)))
    _close(p.warp_forward_points(torch.from_numpy(pts)),
           j.warp_forward_points(jnp.asarray(pts)))
    for got, want in zip(p.sample(torch.from_numpy(pts)), j.sample(jnp.asarray(pts))):
        _close(got, want)
    np.testing.assert_array_equal(p.invalid_mask().numpy(), np.asarray(j.invalid_mask()))


@pytest.mark.parametrize("ties", [False, True])
def test_select_best(rng, ties):
    """First maximum wins (candidates 1 and 2 identical with ``ties``);
    invalid and occluded candidates lose; endpoints off the image occluded."""
    flows, occls, sigmas = _result(rng, spread=40.0, lead=(5,))
    if ties:
        for a in (flows, occls, sigmas):
            a[2] = a[1]
    valid = np.array([True, True, True, False, True])
    got = select_best(*(torch.from_numpy(a) for a in (flows, occls, sigmas)),
                      torch.from_numpy(valid), 0.02)
    want = jax_select_best(*(jnp.asarray(a) for a in (flows, occls, sigmas, valid)), 0.02)
    for name in ("flow", "occlusion", "sigma"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_point_tracks(rng):
    r = _result(rng)
    pts = _points(rng)
    coords, occl = tpt.point_tracks(_port(r), torch.from_numpy(pts))
    jcoords, jocc = jpt.point_tracks(_jax(r), jnp.asarray(pts))
    _close(coords, jcoords)
    _close(occl, jocc)


def test_convert_to_point_tracking(rng):
    r = _result(rng)
    pts = _points(rng)
    coords, occl = tpt.convert_to_point_tracking(_port(r), pts)
    jcoords, jocc = jpt.convert_to_point_tracking(_jax(r), pts)
    assert isinstance(coords, np.ndarray) and occl.dtype == np.float32
    _close(coords, jcoords)
    _close(occl, jocc)


def test_convert_to_point_tracking_batch(rng):
    results = [_result(rng) for _ in range(3)]
    pts = _points(rng, 37)
    coords, occl = tpt.convert_to_point_tracking_batch([_port(r) for r in results], pts)
    jcoords, jocc = jpt.convert_to_point_tracking_batch([_jax(r) for r in results], pts)
    assert coords.shape == (3, 37, 2) and occl.shape == (3, 37)
    assert isinstance(coords, np.ndarray) and occl.dtype == np.float32
    _close(coords, jcoords)
    _close(occl, jocc)


@pytest.mark.parametrize("case", ["small_flow", "large_flow"])
def test_chain_select_pallas_matches_jax(rng, case):
    """The TPU form on both sides: 1/256-px snap, bf16 hi/lo flow, bf16
    occlusion and sigma, one 'tpu' warp. Each sample differs by at most
    1e-5*max|map| (the column sum's order), so flow by 2e-5*max|flow| (hi +
    lo) and occlusion and sigma by 1e-5*max; the winners are the same."""
    spread = 60.0 if case == "large_flow" else 6.0
    N = 4
    left, right = _result(rng, spread, (N,)), _result(rng, spread, (N,))
    valid = np.array([True, True, False, True])
    got = chain_select_pallas(_port(left), _port(right), torch.from_numpy(valid), 0.02)
    want = jax_chain_select_pallas(_jax(left), _jax(right), jnp.asarray(valid), 0.02)
    fmax = float(np.abs(right[0]).max())
    np.testing.assert_allclose(got.flow.numpy(), np.asarray(want.flow),
                               atol=2e-5 * fmax + 1e-5, rtol=1e-6)
    np.testing.assert_allclose(got.occlusion.numpy(), np.asarray(want.occlusion),
                               atol=1e-5 * float(right[1].max()), rtol=1e-6)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma),
                               atol=1e-5 * float(right[2].max()), rtol=1e-6)


def test_cpu_calls_launch_nothing(rng):
    """Every entry point of the slice runs the plain version on CPU tensors."""
    r, left, right = _result(rng), _result(rng, lead=(3,)), _result(rng, lead=(3,))
    pts = _points(rng)
    ops.reset_launch_counts()
    tf.chain_results(_port(r), _port(r))
    tf.chain_results_packed(_port(r), _port(r))
    tpt.convert_to_point_tracking(_port(r), pts)
    tpt.convert_to_point_tracking_batch([_port(r)], pts)
    chain_select_pallas(_port(left), _port(right), torch.tensor([True] * 3))
    assert all(n == 0 for n in ops.launch_counts().values())
