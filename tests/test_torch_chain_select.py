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
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref


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
