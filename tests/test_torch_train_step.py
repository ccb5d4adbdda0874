"""The port's train step against the JAX package's, in both recipes.

Two steps of ``make_train_step`` from the same weights (JAX's random init,
carried across by ``params_from_flax``) on the same numpy batches: f32,
128x128, 2 pairs, 3 iterations, lr 1e-3 over 10 steps. Per step the loss
and the metrics; the gradients of step 1 directly; then the parameters'
updates after step 2 and, in the full recipe, the batch statistics. On the
CPU the port runs the kernels' plain versions (the lookup's plain backward
included); JAX runs its 'auto' lookup, the tent-matmul form on the CPU.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mft_tpu.models.raft.raft import RAFT as JaxRAFT, RAFTParams as JaxParams
from mft_tpu.train.loop import make_train_step as jax_make_train_step
from mft_tpu.train.losses import sequence_loss as jax_sequence_loss
from mft_tpu.train.optim import make_optimizer as jax_make_optimizer
from mft_tpu_torch.models.raft import RAFT
from mft_tpu_torch.models.raft.convert import params_from_flax
from mft_tpu_torch.models.raft.raft import RAFTParams
from mft_tpu_torch.train.loop import freeze, make_train_step
from mft_tpu_torch.train.optim import make_optimizer

H, W, B, ITERS, LR, STEPS = 128, 128, 2, 3, 1e-3, 10
# conv biases that a norm follows in the encoders
BEFORE_NORM = re.compile(r"^[fc]net\.(conv1|layer\d_\d\.(conv1|conv2|downsample_conv))\.bias$")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU training math: the suite
    runs 6 xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxRAFT(cfg=JaxParams())
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda k: model.init(k, dummy, dummy, iters=1))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def _batch(seed):
    r = np.random.default_rng(seed)
    tex = (r.random((B, H + 8, W + 8, 3)) * 255).astype(np.float32)
    img1, img2 = tex[:, :H, :W].copy(), tex[:, 3:H + 3, 2:W + 2].copy()
    flow = np.broadcast_to(np.array([-2.0, -3.0], np.float32), (B, H, W, 2)).copy()
    flow += r.normal(size=flow.shape).astype(np.float32)
    valid = (r.random((B, H, W)) > 0.1).astype(np.float32)
    occl = (r.random((B, H, W)) > 0.7).astype(np.float32)
    occl[:, ::7] = 0.5    # soft ground truth: left out of the occlusion loss
    return img1, img2, flow, valid, occl


def _loss_kwargs(official):
    return dict(gamma=0.85, freeze_optical_flow=official,
                occlusion_module="separate_with_uncertainty",
                uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
                weighting_unc_loss=False)


def _jax_run(variables, official):
    """(metrics of both steps, gradients of step 1, variables after step 2)."""
    model = JaxRAFT(cfg=JaxParams(), train_mode=not official)
    trainable = ("occlusion_block",) if official else None
    tx, _ = jax_make_optimizer(lr=LR, num_steps=STEPS, params=variables["params"],
                               trainable_prefixes=trainable)
    lk = _loss_kwargs(official)
    step = jax_make_train_step(model, tx, lk, iters=ITERS, train_bn=not official)
    extra = {k: v for k, v in variables.items() if k != "params"}
    batch0 = tuple(jnp.asarray(x) for x in _batch(0))

    def loss_fn(params):
        v = {"params": params, **extra}
        if official:
            preds = model.apply(v, batch0[0], batch0[1], iters=ITERS, test_mode=False)
        else:
            preds, _ = model.apply(v, batch0[0], batch0[1], iters=ITERS, test_mode=False,
                                   mutable=["batch_stats"])
        return jax_sequence_loss(preds, *batch0[2:4], occl_gt=batch0[4], **lk)[0]

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
        jax.tree.map(jnp.asarray, variables["params"])))
    state = {"variables": jax.tree.map(jnp.asarray, variables),
             "opt_state": tx.init(jax.tree.map(jnp.asarray, variables["params"])), "step": 0}
    metrics = []
    for s in range(2):
        state, m = step(state, tuple(jnp.asarray(x) for x in _batch(s)))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads, jax.tree.map(np.asarray, state["variables"])


@pytest.mark.parametrize("recipe", ["official", "full"])
def test_train_step_matches_jax(jax_variables, recipe):
    """Tolerances (f32; the two frameworks sum convolutions, means and the
    lookup's gradient in other orders): loss and metrics 1e-5 relative (the
    px rates 2e-3 absolute after step 2: a pixel's EPE can cross a
    threshold). Gradients per tensor: the largest gap within 3e-2 of the
    tensor's largest |gradient| and the gap's norm within 1e-2 of its norm.
    The encoders' normalisations amplify f32 rounding in the backward:
    measured against a float64 evaluation of the port, JAX's f32 gradients
    are up to 1.1% of the largest value off (cnet.layer1_1.conv2), the
    port's up to 1.3% (fnet.layer2_1.conv2), every other tensor far less;
    the port's lookup backward agrees with autograd through the plain gather
    to 1e-6. A conv bias that a norm follows has a zero gradient in exact
    arithmetic: both within 1e-5 of its weight's largest gradient. Updates
    (parameter after step 2 minus before): Adam normalises, so where a
    gradient is near zero its step can take either sign, and in the full
    recipe step 2 starts from encoders that step 1 moved by their gradients'
    noise: every update within 2 * (lr_0 + lr_1) of JAX's (the most two
    steps of opposite sign can differ) and each tensor's update vector at
    a cosine >= 0.99 to JAX's (measured >= 0.998), the biases before a norm
    aside; in the official recipe, whose gradients agree to ~1e-7, at least
    99% of each tensor's updates also within 1e-3 relative plus
    1e-6 * (lr_0 + lr_1). Batch statistics 1e-4."""
    official = recipe == "official"
    jmetrics, jgrads, jafter = _jax_run(jax_variables, official)

    model = RAFT(RAFTParams(), train_mode=not official)
    model.load_state_dict(params_from_flax(jax_variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = ("occlusion_block",) if official else None
    tx, schedule = make_optimizer(lr=LR, num_steps=STEPS, params=dict(model.named_parameters()),
                                  trainable_prefixes=trainable)
    freeze(model, tx.mask)
    state = {"model": model, "opt_state": tx.init(dict(model.named_parameters())), "step": 0}
    step = make_train_step(model, tx, _loss_kwargs(official), iters=ITERS)
    grads = None
    for s in range(2):
        state, metrics = step(state, tuple(torch.from_numpy(x) for x in _batch(s)))
        assert set(metrics) == set(jmetrics[s])
        for k, v in metrics.items():
            atol = 2e-3 if (s == 1 and "px" in k) else 0.0
            np.testing.assert_allclose(float(v), jmetrics[s][k], rtol=1e-5, atol=atol,
                                       err_msg=f"step {s} {k}")
        if s == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    assert state["step"] == 2

    jgrad_sd = params_from_flax({"params": jgrads})
    names = [n for n, _ in model.named_parameters()]
    trained = [n for n in names if not official or n.startswith("occlusion_block")]
    assert sorted(grads) == sorted(trained)
    for n in trained:
        got, want = grads[n], jgrad_sd[n]
        if BEFORE_NORM.match(n):
            # zero in exact arithmetic (the norm takes the mean out): both
            # are rounding noise, far below the conv weight's gradient
            scale = float(jgrad_sd[n[:-len("bias")] + "weight"].abs().max())
            assert float(got.abs().max()) <= 1e-5 * scale, n
            assert float(want.abs().max()) <= 1e-5 * scale, n
            continue
        assert float((got - want).abs().max()) <= 3e-2 * float(want.abs().max()), n
        assert float((got - want).norm()) <= 1e-2 * float(want.norm()), n

    after = model.state_dict()
    jafter_sd = params_from_flax(jafter)
    lr_sum = schedule(0) + schedule(1)
    for n in names:
        if n not in trained:
            assert torch.equal(after[n], before[n]), f"frozen {n} moved"
            continue
        got, want = after[n] - before[n], jafter_sd[n] - before[n]
        assert bool((got != 0).any()), f"trainable {n} did not move"
        diff = (got - want).abs()
        assert float(diff.max()) <= 2 * lr_sum, n
        if BEFORE_NORM.match(n):
            continue   # the updates of rounding noise
        cos = float((got * want).sum() / (got.norm() * want.norm()))
        assert cos >= 0.99, (n, cos)
        if official:
            close = diff <= 1e-3 * want.abs() + 1e-6 * lr_sum
            assert float(close.float().mean()) >= 0.99, (n, float(close.float().mean()))
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        if official:
            assert torch.equal(after[k], before[k]), k
        else:
            assert not torch.equal(after[k], before[k]), k
            torch.testing.assert_close(after[k], jafter_sd[k], atol=1e-4, rtol=1e-4)
