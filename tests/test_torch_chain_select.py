"""The port's chain + select against the JAX package, on the CPU.

Same numpy candidate maps go through JAX ``chain_select_ref`` (the exact
path, held tight), JAX ``chain_select_pallas`` (the TPU path in Pallas
interpret mode, with its 1/256-px snap and bf16 maps, held loose) and the
port's plain version, which the port's CUDA kernel follows bit for bit.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.core.flowou import FlowOU as JaxFlowOU
from mft_tpu.tracker.fused import chain_select_pallas
from mft_tpu.tracker.fused import chain_select_ref as jax_chain_select_ref
from mft_tpu_torch import ops
from mft_tpu_torch.core.flowou import FlowOU
from mft_tpu_torch.ops.chain_select import chained_sigma
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _maps(rng, N=4, H=16, W=16, spread=6.0, tie=False):
    mk = lambda *s: rng.random(s).astype(np.float32)
    left = (mk(N, H, W, 2) * spread - spread / 2, mk(N, H, W) * 0.03,
            mk(N, H, W) + 0.1)
    right = (mk(N, H, W, 2) * spread - spread / 2, mk(N, H, W) * 0.03,
             mk(N, H, W) + 0.1)
    if tie:  # candidates 0 and 1 identical: the first must win
        for m in left + right:
            m[1] = m[0]
    return left, right


def _jax(left, right, valid, fn):
    out = fn(JaxFlowOU(*map(jnp.asarray, left)), JaxFlowOU(*map(jnp.asarray, right)),
             jnp.asarray(valid), 0.02)
    return [np.asarray(x) for x in (out.flow, out.occlusion, out.sigma)]


def _port(left, right, valid, fn=chain_select_ref):
    out = fn(FlowOU(*map(torch.from_numpy, left)), FlowOU(*map(torch.from_numpy, right)),
             torch.tensor(valid), 0.02)
    return [x.numpy() for x in (out.flow, out.occlusion, out.sigma)]


@pytest.mark.parametrize("case", ["small_flow", "large_flow", "ties"])
def test_plain_matches_jax_ref(rng, case):
    """Exact f32 math on both sides: equal to float rounding (1e-6), and so
    the same winner at every pixel; large flows leave the image."""
    spread = 60.0 if case == "large_flow" else 6.0
    left, right = _maps(rng, spread=spread, tie=case == "ties")
    valid = [True, True, False, True]
    want = _jax(left, right, valid, jax_chain_select_ref)
    got = _port(left, right, valid)
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6, err_msg=name)


def test_plain_matches_jax_pallas_path_loosely(rng):
    """The TPU path snaps positions to 1/256 px and samples bf16 maps, so
    near-ties may pick another winner: bounds of the JAX package's own
    chain_select_pallas test (99% / 98% of pixels close)."""
    left, right = _maps(rng)
    valid = [True, True, False, True]
    a = _port(left, right, valid)
    b = _jax(left, right, valid, chain_select_pallas)
    assert np.isclose(a[1], b[1], atol=2e-2).mean() > 0.99
    assert np.isclose(a[2], b[2], atol=2e-2).mean() > 0.99
    assert np.isclose(a[0], b[0], atol=0.15).mean() > 0.98


def test_all_invalid_selects_first_candidate(rng):
    """argmax of all -inf scores is candidate 0, as in jnp.argmax."""
    left, right = _maps(rng)
    valid = [False] * 4
    want = _jax(left, right, valid, jax_chain_select_ref)
    got = _port(left, right, valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_dispatch_uses_plain_version_on_cpu(rng):
    left, right = _maps(rng)
    valid = [True, False, True, True]
    ops.reset_launch_counts()
    a = _port(left, right, valid, fn=chain_select)
    b = _port(left, right, valid, fn=chain_select_ref)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert ops.launch_counts()["chain_select"] == 0


def _assert_same_values(got, want, name):
    """Identical NaN positions, exactly equal values elsewhere."""
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep], want[keep], err_msg=name)


def test_cpu_sqrt_within_one_ulp_of_jax():
    """The premise of the exact sigmas below: JAX's chained sigma on the
    CPU (``jnp.sqrt(jnp.square(a) + jnp.square(b))``, run op by op, so no
    multiply-add is fused) is numpy's unfused float32 sum under a correctly
    rounded sqrt, and the port's ``chained_sigma`` gives the same bits."""
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0.1, 2.0, 1 << 18).astype(np.float32) for _ in range(2))
    exact = np.sqrt(a * a + b * b)
    jax_sigma = jnp.sqrt(jnp.square(jnp.asarray(a)) + jnp.square(jnp.asarray(b)))
    np.testing.assert_array_equal(np.asarray(jax_sigma), exact)
    port_sigma = chained_sigma(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(port_sigma.numpy(), exact)


@pytest.mark.parametrize("planted", ["lsig", "locc", "rocc", "rsig", "all four"])
def test_plain_matches_jax_ref_with_nan(rng, planted):
    """NaN in a candidate map: torch.maximum and jnp.maximum propagate it
    into the chained occlusion, and argmax takes the first NaN score as the
    maximum, in both packages. The port's plain version (which the CUDA
    kernel follows bit for bit) must give JAX's NaN positions and JAX's
    values elsewhere, exactly."""
    left, right = _maps(rng, N=5, H=9, W=11)
    maps = {"lsig": left[2], "locc": left[1], "rocc": right[1], "rsig": right[2]}
    for name in (maps if planted == "all four" else [planted]):
        m = maps[name]
        m[rng.random(m.shape) < 0.15] = np.nan
    valid = [True, True, False, True, True]
    want = _jax(left, right, valid, jax_chain_select_ref)
    got = _port(left, right, valid)
    assert any(np.isnan(w).any() for w in want)
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        _assert_same_values(g, w, name)


def test_nan_sigma_is_selected_first():
    """One pixel, sigmas (1.0, NaN, 0.5) over three valid candidates with
    zero flows and occlusions: argmax picks candidate 1, whose chained sigma
    is NaN, in JAX and in the port."""
    z = lambda *s: np.zeros(s, np.float32)
    lsig = np.array([1.0, np.nan, 0.5], np.float32).reshape(3, 1, 1)
    left = (z(3, 1, 1, 2), z(3, 1, 1), lsig)
    right = (z(3, 1, 1, 2), z(3, 1, 1), z(3, 1, 1))
    valid = [True] * 3
    want = _jax(left, right, valid, jax_chain_select_ref)
    got = _port(left, right, valid)
    assert np.isnan(want[2]).all() and np.isnan(got[2]).all()
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        _assert_same_values(g, w, name)


@pytest.mark.parametrize("N", [1, 8])
def test_all_invalid_matches_jax(rng, N):
    """Every candidate invalid: all scores -inf, candidate 0 wins with its
    chained occlusion and sigma, as jnp.argmax picks it; exact."""
    left, right = _maps(rng, N=N, H=7, W=10, spread=20.0)
    valid = [False] * N
    want = _jax(left, right, valid, jax_chain_select_ref)
    got = _port(left, right, valid)
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        _assert_same_values(g, w, name)
