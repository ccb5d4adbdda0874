"""The port's train-mode model against the JAX package's, and the lookup's
backward against JAX's VJP.

- ``ops.corr_lookup_bwd_ref`` (the plain version of the backward kernel
  ``mft_corr_lookup_bwd``) against ``jax.vjp`` of the JAX lookup's 'mxu'
  path (the tent-matmul form whose VJP is #2's backward), f32, every level,
  integer coordinates and taps off the map;
- the autograd function of ``ops.corr_lookup``: its level gradients are the
  plain backward's, coordinates that require a gradient raise;
- the train-mode forward (``test_mode=False``) against JAX's, with and
  without ``OU_last_iter_only``, and the batch statistics it writes;
- batch norm in train mode against flax's ``nn.BatchNorm``;
- the train-mode routes: 'auto' volume for the methods without a backward,
  no fused lookup, cuDNN in place of conv_backend 'pallas', and
  ``cast_per_call`` equal to the bf16 model.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from mft_tpu.models.raft.corr import corr_lookup as jax_corr_lookup
from mft_tpu.models.raft.raft import RAFT as JaxRAFT, RAFTParams as JaxParams
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft import RAFT
from mft_tpu_torch.models.raft import raft as raft_module
from mft_tpu_torch.models.raft.convert import params_from_flax
from mft_tpu_torch.models.raft.layers import BatchNorm
from mft_tpu_torch.models.raft.raft import RAFTParams

H8, W8 = 10, 12
DIMS = ((10, 12), (5, 6), (2, 3), (1, 1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU training math: the suite
    runs 6 xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lookup_inputs(seed, radius):
    r = np.random.default_rng(seed)
    B, P = 2, H8 * W8
    pyr = [r.normal(size=(B, P, h, w)).astype(np.float32) for h, w in DIMS]
    coords = np.stack([r.uniform(-6, W8 + 6, (B, P)), r.uniform(-6, H8 + 6, (B, P))],
                      -1).astype(np.float32)
    coords[0, :40] = np.round(coords[0, :40])          # integer coordinates
    coords[1, :10] = np.array([W8 + 60, -60], np.float32)   # every tap off the map
    n = (2 * radius + 1) ** 2
    g = r.normal(size=(B, P, len(DIMS) * n)).astype(np.float32)
    return pyr, coords, g


@pytest.mark.parametrize("radius", [4, 2])
def test_lookup_backward_matches_jax_vjp(radius):
    """f32: the same four products per map position, summed in another
    order than JAX's two tent matmuls: 2e-6 absolute (|g| ~ 1, four terms);
    positions outside every window's box are 0 in both."""
    pyr, coords, g = _lookup_inputs(0, radius)
    B, P = coords.shape[:2]
    cj = jnp.asarray(coords).reshape(B, H8, W8, 2)
    _, vjp = jax.vjp(lambda p: jax_corr_lookup(p, cj, radius, method="mxu"),
                     [jnp.asarray(x) for x in pyr])
    want = vjp(jnp.asarray(g).reshape(B, H8, W8, -1))[0]
    got = ops.corr_lookup_bwd_ref(torch.from_numpy(g), torch.from_numpy(coords), DIMS, radius)
    for lvl, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-6, rtol=0, err_msg=f"level {lvl}")
        assert np.array_equal(a.numpy() == 0, b == 0) or lvl == 3, lvl
    assert all(float(t[1, :10].abs().max()) == 0.0 for t in got)   # off the map


def test_lookup_autograd_function():
    """The lookup's gradient is the plain backward's, bit for bit; the plain
    route gives the same; coordinates must not require a gradient; without
    a level that requires one, no autograd function runs."""
    pyr, coords, g = _lookup_inputs(1, 4)
    levels = [torch.from_numpy(x).requires_grad_() for x in pyr]
    c, gt = torch.from_numpy(coords), torch.from_numpy(g)
    out = ops.corr_lookup(levels, c, 4)
    assert out.grad_fn is not None
    torch.testing.assert_close(out, ops.corr_lookup_ref(levels, c, 4), atol=0, rtol=0)
    grads = torch.autograd.grad(out, levels, gt)
    want = ops.corr_lookup_bwd_ref(gt, c, DIMS, 4)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    grads_plain = torch.autograd.grad(ops.corr_lookup(levels, c, 4, plain=True), levels, gt)
    assert all(torch.equal(a, b) for a, b in zip(grads_plain, want))
    with pytest.raises(ValueError, match="coordinate gradient"):
        ops.corr_lookup(levels, c.clone().requires_grad_(), 4)
    with torch.no_grad():
        assert ops.corr_lookup(levels, c, 4).grad_fn is None
    # bf16: one rounding of the f32 sum
    g16 = gt.to(torch.bfloat16)
    got16 = ops.corr_lookup_bwd_ref(g16, c, DIMS, 4)
    want16 = ops.corr_lookup_bwd_ref(g16.float(), c, DIMS, 4)
    assert all(torch.equal(a, b.to(torch.bfloat16)) for a, b in zip(got16, want16))


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxRAFT(cfg=JaxParams())
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda k: model.init(k, dummy, dummy, iters=1))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    # running statistics away from flax's (0, 1) start
    r = np.random.default_rng(5)
    stats = jax.tree.map(lambda a: a + np.float32(0.1) * np.abs(
        r.normal(size=a.shape)).astype(np.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _images(B=2, H=64, W=64, seed=0):
    r = np.random.default_rng(seed)
    tex = (r.random((B, H + 8, W + 8, 3)) * 255).astype(np.float32)
    return tex[:, :H, :W].copy(), tex[:, 2:H + 2, 3:W + 3].copy()


@pytest.mark.parametrize("ou_last_iter_only", [False, True])
def test_train_forward_matches_jax(jax_variables, ou_last_iter_only):
    """train_mode, test_mode=False, 2 iterations at 64x64, f32: every
    iteration's upsampled flow, occlusion logits and uncertainty, and the
    batch statistics, within 1e-4 (convolution and mean orders)."""
    iters = 2
    jm = JaxRAFT(cfg=JaxParams(ou_last_iter_only=ou_last_iter_only), train_mode=True)
    i1, i2 = _images()
    want, new_vars = jm.apply(jax_variables, i1, i2, iters=iters, test_mode=False,
                              mutable=["batch_stats"])
    model = RAFT(RAFTParams(ou_last_iter_only=ou_last_iter_only), train_mode=True)
    model.load_state_dict(params_from_flax(jax_variables))
    got = model(torch.from_numpy(i1).permute(0, 3, 1, 2),
                torch.from_numpy(i2).permute(0, 3, 1, 2), iters=iters, test_mode=False)
    heads = 1 if ou_last_iter_only else iters
    assert [len(got[k]) for k in ("flow", "occlusion", "uncertainty")] == [iters, heads, heads]
    for k in ("flow", "occlusion", "uncertainty"):
        assert len(want[k]) == len(got[k])
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["coords"].detach().numpy(), np.asarray(want["coords"]),
                               atol=1e-4, rtol=1e-4)
    stats = params_from_flax({"batch_stats": jax.tree.map(np.asarray,
                                                          new_vars["batch_stats"])})
    sd = model.state_dict()
    for k, v in stats.items():
        torch.testing.assert_close(sd[k], v, atol=1e-4, rtol=1e-4)


def test_batch_norm_matches_flax():
    """Batch statistics (flax's E[x^2] - E[x]^2 variance), the normalised
    output and the running update, f32: 1e-5; a bf16 input keeps its dtype
    and the statistics stay float32."""
    r = np.random.default_rng(3)
    x = (r.normal(size=(3, 5, 7, 4)) * 2 + 1).astype(np.float32)        # NHWC
    scale, bias = r.normal(size=4).astype(np.float32), r.normal(size=4).astype(np.float32)
    mean0, var0 = r.normal(size=4).astype(np.float32), r.random(4).astype(np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = bn.apply(v, x, mutable=["batch_stats"])
    m = BatchNorm(4)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    m.use_batch_stats = True
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-6)
    out16 = m(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16 and m.running_var.dtype == torch.float32


def test_train_mode_routes(monkeypatch):
    """In train mode every corr_method looks up the 'auto' volume (whose
    lookup has a backward) and conv_backend 'pallas' builds a cuDNN update
    block; test_mode=False never fuses the lookup with convc1."""
    def no_fusion(*a, **k):
        raise AssertionError("the fused lookup ran in a test_mode=False forward")
    monkeypatch.setattr(raft_module, "corr_lookup_fused_conv", no_fusion)
    gen = torch.Generator().manual_seed(0)
    f1, f2, cn = (torch.randn((1, 256, 8, 8), generator=gen) for _ in range(3))
    base = RAFT(RAFTParams(), train_mode=True)
    want = base.flow_from_features(f1, f2, cn, iters=2, test_mode=False)
    for method in ("int8", "alt", "fold", "packed_i8"):
        model = RAFT(RAFTParams(corr_method=method, conv_backend="pallas"), train_mode=True)
        assert model.update_block.conv_backend == "auto"
        model.load_state_dict(base.state_dict())
        got = model.flow_from_features(f1, f2, cn, iters=2, test_mode=False)
        assert all(torch.equal(a, b) for a, b in zip(got["flow"], want["flow"])), method
    eval_model = RAFT(RAFTParams())
    eval_model.load_state_dict(base.state_dict())
    out = eval_model.flow_from_features(f1, f2, cn, iters=2, test_mode=False)
    assert len(out["flow"]) == 2
    with pytest.raises(ValueError, match="inference-only"):
        eval_model.flow_from_features(f1, f2, cn, iters=(2, 1), test_mode=False)


def test_cast_per_call_is_the_bf16_model():
    """cast_per_call(bf16) keeps float32 parameters, takes float32
    gradients, and computes what the bf16 inference model computes, bit for
    bit (the same casts before every conv)."""
    f32 = RAFT(RAFTParams())
    mixed = RAFT(RAFTParams())
    mixed.load_state_dict(f32.state_dict())
    mixed.cast_per_call(torch.bfloat16)
    bf16 = RAFT(RAFTParams())
    bf16.load_state_dict(f32.state_dict())
    bf16.set_compute_dtype(torch.bfloat16)
    assert mixed.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in mixed.parameters())
    i1, i2 = (torch.from_numpy(x).permute(0, 3, 1, 2) for x in _images(B=1))
    with torch.no_grad():
        a = mixed(i1, i2, iters=1)
        b = bf16(i1, i2, iters=1)
    for k in ("flow", "occlusion", "uncertainty"):
        assert torch.equal(a[k], b[k]), k
    out = mixed(i1, i2, iters=1, test_mode=False)
    out["flow"][-1].abs().mean().backward()
    assert mixed.fnet.conv1.weight.grad.dtype == torch.float32
