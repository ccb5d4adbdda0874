"""The port's convolution kernel (conv_backend 'pallas') against the JAX package.

``ops.conv_pallas`` (its plain version on CPU tensors; the kernel is held
against it on the card by tests/test_torch_kernels_cuda.py) against JAX's
``conv_pallas`` in interpret mode, for each conv shape of the update block
with its channels cut, and each activation; then ``update.conv_apply``'s
routing. The port works in NCHW with nn.Conv2d weights (Cout, Cin, kh, kw),
JAX in NHWC with HWIO kernels: the same numpy values, transposed.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from mft_tpu.ops.conv_pallas import conv_pallas as jax_conv_pallas
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft.update import BasicUpdateBlock, conv_apply

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# the update block's convs with their channels cut by 8 (Cout 2 kept), with
# the activation each takes on the port's path: (Cout, Cin, kh, kw, act)
SHAPES = {
    "convc1": (32, 41, 1, 1, "relu"), "convc2": (24, 32, 3, 3, "relu"),
    "convf2": (8, 16, 3, 3, "relu"), "conv": (16, 32, 3, 3, "relu"),
    "gru_zr1": (32, 48, 1, 5, None), "gru_q2": (16, 48, 5, 1, None),
    "flow_head1": (32, 16, 3, 3, "relu"), "flow_head2": (2, 32, 3, 3, None),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(rng, Cout, Cin, kh, kw, B=2, H=8, W=16):
    x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
    k = (rng.standard_normal((kh, kw, Cin, Cout)) / np.sqrt(Cin * kh * kw)).astype(np.float32)
    b = (0.1 * rng.standard_normal((Cout,))).astype(np.float32)
    return x, k, b


def _both(x, k, b, kh, kw, act, dtype):
    pad = ((kh // 2, kh // 2), (kw // 2, kw // 2))
    want = jax_conv_pallas(jnp.asarray(x, JAX_DT[dtype]), jnp.asarray(k, JAX_DT[dtype]),
                           jnp.asarray(b), pad, act=act)
    want = np.array(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(TORCH_DT[dtype])
    tk = torch.from_numpy(k).permute(3, 2, 0, 1).to(TORCH_DT[dtype])
    got = ops.conv_pallas(tx, tk, torch.from_numpy(b), pad, act=act)
    assert got.dtype == TORCH_DT[dtype] and tuple(got.shape) == want.shape
    return got.float().numpy(), want


def _assert_close(got, want, dtype):
    """float32: JAX's own 1e-4 (tests/test_update_fusion.py, the conv
    backends against each other; the two sum in other orders). bfloat16: one
    bf16 ulp of the output (2^-7 relative; the products are exact, only the
    float32 sum order differs before the one rounding), plus 1e-5 absolute
    next to zero, where that order's differences exceed an ulp."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_conv_matches_jax(rng, name, dtype):
    Cout, Cin, kh, kw, act = SHAPES[name]
    got, want = _both(*_inputs(rng, Cout, Cin, kh, kw), kh, kw, act, dtype)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "relu", "sigmoid", "tanh"])
def test_conv_activations_match_jax(rng, act, dtype):
    """Each act on the float32 sum plus bias, before the one cast; on a 1x5
    conv whose padding is only left and right."""
    got, want = _both(*_inputs(rng, 16, 24, 1, 5), 1, 5, act, dtype)
    _assert_close(got, want, dtype)


def test_conv_takes_any_strides_and_refuses_non_same_padding(rng):
    """A channel-last input (convc1 reads the lookup's samples so) gives the
    contiguous input's values; padding that is not SAME-size raises."""
    x, k, b = _inputs(rng, 8, 12, 3, 3)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tk, tb = torch.from_numpy(k).permute(3, 2, 0, 1), torch.from_numpy(b)
    pad = ((1, 1), (1, 1))
    torch.testing.assert_close(ops.conv_pallas(tx, tk, tb, pad),
                               ops.conv_pallas(tx.contiguous(), tk, tb, pad),
                               atol=0.0, rtol=0.0)
    with pytest.raises(ValueError, match="SAME-size"):
        ops.conv_pallas(tx, tk, tb, ((1, 1), (0, 0)))


def test_conv_apply_routes_as_jax(rng, monkeypatch):
    """conv_apply with backend 'pallas' runs the kernel's wrapper (its plain
    version when ``plain``), except for a tiny-Cin conv (Cin <= 8, kh*kw > 1),
    which stays F.conv2d as JAX sends it to im2col; any other backend is
    F.conv2d. All compute the same convolution (f32, 1e-4)."""
    calls = []
    for name in ("conv_pallas", "conv_pallas_ref"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x = torch.from_numpy(rng.standard_normal((1, 12, 6, 10)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 12, 3, 3)).astype(np.float32))
    b = torch.zeros(8)
    pad = ((1, 1), (1, 1))
    want = F.conv2d(x, w, b, padding=1)
    for backend, plain, called in (("pallas", False, ["conv_pallas"]),
                                   ("pallas", True, ["conv_pallas_ref"]),
                                   ("auto", False, [])):
        calls.clear()
        got = conv_apply(x, w, b, pad, backend, plain, act="relu")
        assert calls == called, backend
        torch.testing.assert_close(got, torch.relu(want), atol=1e-4, rtol=1e-4)
    calls.clear()
    conv_apply(x[:, :2], w[:, :2], b, pad, "pallas")
    assert calls == []


def test_update_block_routes_jax_convs(rng, monkeypatch):
    """With conv_backend 'pallas' one update step (unfused convc1) runs the
    kernel for convc1, convc2, convf2, conv, the GRU's zr and q convs of
    both passes and the flow head's two convs: 10 calls; convf1 and the
    mask head stay nn.Conv2d. Same result as the 'auto' block (f32, 1e-4)."""
    calls = []
    fn = ops.conv_pallas
    monkeypatch.setattr(ops, "conv_pallas", lambda *a, **k: (calls.append(1), fn(*a, **k))[1])
    torch.manual_seed(0)
    auto = BasicUpdateBlock(128, 324)
    pallas = BasicUpdateBlock(128, 324, conv_backend="pallas")
    pallas.load_state_dict(auto.state_dict())
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    net, inp, corr, flow = t(1, 128, 4, 6), t(1, 128, 4, 6), t(1, 324, 4, 6), t(1, 2, 4, 6)
    with torch.no_grad():
        want = auto(net, inp, corr, flow, need_mask=True)
        got = pallas(net, inp, corr, flow, need_mask=True)
    assert len(calls) == 10
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
