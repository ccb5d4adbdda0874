"""The port's training losses and optimizer against the JAX package's.

Same numpy inputs through ``mft_tpu.train.losses`` / ``optim`` and
``mft_tpu_torch.train.losses`` / ``optim``: every flow, occlusion and
uncertainty loss type and flag, the OneCycle schedule at every step, and N
AdamW + clip updates on given gradients with and without freezing.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from mft_tpu.train import losses as jl
from mft_tpu.train.optim import make_optimizer as jax_make_optimizer
from mft_tpu.train.optim import onecycle_linear as jax_onecycle
from mft_tpu_torch.train import losses as tl
from mft_tpu_torch.train.optim import apply_updates, make_optimizer, onecycle_linear

B, H, W, N = 2, 12, 16, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU training math: the suite
    runs 6 xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    flow_gt = (r.normal(size=(B, H, W, 2)) * 4).astype(np.float32)
    flow_gt[0, 0, :3] = 500.0                      # beyond MAX_FLOW
    valid = (r.random((B, H, W)) > 0.2).astype(np.float32)
    occl = r.choice(np.array([0.0, 0.005, 0.5, 0.995, 1.0], np.float32), size=(B, H, W))
    flows = [flow_gt + (r.normal(size=flow_gt.shape) * s).astype(np.float32)
             for s in (3.0, 1.5, 0.5)]
    occls = [r.normal(size=(B, H, W, 2)).astype(np.float32) for _ in range(N)]
    uncs = [r.normal(size=(B, H, W, 1)).astype(np.float32) for _ in range(N)]
    return flow_gt, valid, occl, flows, occls, uncs


def _t(xs):
    return [torch.from_numpy(x) for x in xs] if isinstance(xs, list) else torch.from_numpy(xs)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("loss_type", ["L1", "L1_non_occluded", "L1_occluded_to_epe3"])
def test_flow_loss(loss_type):
    """f32 means over the full tensors: 1e-5 relative."""
    flow_gt, valid, occl, flows, _, _ = _inputs()
    jloss, jm = jl.sequence_flow_loss([jnp.asarray(f) for f in flows], flow_gt, valid,
                                      occl_gt=occl, gamma=0.85, flow_loss_type=loss_type)
    tloss, tm = tl.sequence_flow_loss(_t(flows), _t(flow_gt), _t(valid), occl_gt=_t(occl),
                                      gamma=0.85, flow_loss_type=loss_type)
    _close(tloss, jloss)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k])


def test_occlusion_loss():
    flow_gt, valid, occl, _, occls, _ = _inputs(1)
    jloss, jm = jl.sequence_occl_loss([jnp.asarray(o) for o in occls], occl, flow_gt, valid,
                                      gamma=0.8)
    tloss, tm = tl.sequence_occl_loss(_t(occls), _t(occl), _t(flow_gt), _t(valid), gamma=0.8)
    _close(tloss, jloss)
    _close(tm["train/cross_entropy_occl"], jm["train/cross_entropy_occl"])


@pytest.mark.parametrize("weighting", [False, True])
@pytest.mark.parametrize("unc_type", ["huber", "huber_non_occluded", "L2", "L2_non_occluded",
                                      "huber_epe_direct", "huber_epe_direct_non_occluded"])
def test_uncertainty_loss(unc_type, weighting):
    flow_gt, valid, occl, flows, _, uncs = _inputs(2)
    jloss, jm = jl.sequence_uncertainty_loss(
        [jnp.asarray(f) for f in flows], [jnp.asarray(u) for u in uncs], flow_gt, valid,
        gamma=0.85, uncertainty_loss_type=unc_type, weighting_unc_loss=weighting,
        occl_gt=occl)
    tloss, tm = tl.sequence_uncertainty_loss(
        _t(flows), _t(uncs), _t(flow_gt), _t(valid), gamma=0.85,
        uncertainty_loss_type=unc_type, weighting_unc_loss=weighting, occl_gt=_t(occl))
    _close(tloss, jloss, rtol=2e-5)
    _close(tm["train/uncert"], jm["train/uncert"], rtol=2e-5)


@pytest.mark.parametrize("freeze_flow", [False, True])
@pytest.mark.parametrize("flow_type", ["L1", "L1_occluded_to_epe3"])
def test_sequence_loss_and_its_gradient(freeze_flow, flow_type):
    """The combined objective, and its gradient with respect to every
    prediction (1e-5 relative; 1e-7 absolute on near-zero entries)."""
    flow_gt, valid, occl, flows, occls, uncs = _inputs(3)
    kw = dict(gamma=0.85, freeze_optical_flow=freeze_flow, optical_flow_loss_type=flow_type,
              uncertainty_loss_type="huber_non_occluded", weighting_unc_loss=True)

    def jfn(fl, oc, un):
        preds = {"flow": fl, "occlusion": oc, "uncertainty": un}
        return jl.sequence_loss(preds, flow_gt, valid, occl_gt=occl, **kw)[0]

    jargs = [[jnp.asarray(x) for x in xs] for xs in (flows, occls, uncs)]
    jloss, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(*jargs)
    targs = [[t.requires_grad_() for t in _t(xs)] for xs in (flows, occls, uncs)]
    preds = dict(zip(("flow", "occlusion", "uncertainty"), targs))
    tloss, tm = tl.sequence_loss(preds, _t(flow_gt), _t(valid), occl_gt=_t(occl), **kw)
    _close(tloss, jloss)
    inputs = [t for ts in targs for t in ts]
    tgrads = torch.autograd.grad(tloss, inputs, allow_unused=True)
    for x, got, want in zip(inputs, tgrads, [g for gs in jgrads for g in gs]):
        got = torch.zeros_like(x) if got is None else got   # unused: a zero gradient
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert "train/epe" in tm and "train/uncert" in tm


def test_onecycle_every_step():
    """The float32 schedule at every step of a short run and a few of the
    recipe's: equal to JAX's (1e-7 relative)."""
    for lr, total in ((1.25e-4, 50_100), (1e-3, 110)):
        ours, theirs = onecycle_linear(lr, total), jax_onecycle(lr, total)
        steps = range(total + 3) if total < 1000 else list(range(0, 3000)) + [total - 1]
        for s in steps:
            np.testing.assert_allclose(ours(s), float(theirs(s)), rtol=1e-7, err_msg=str(s))


def _params(seed=0):
    r = np.random.default_rng(seed)
    shapes = {"fnet.conv1.weight": (4, 3, 3, 3), "fnet.conv1.bias": (4,),
              "occlusion_block.occl_head.conv1.weight": (2, 4, 3, 3),
              "occlusion_block.occl_head.conv1.bias": (2,),
              "cnet.norm1.weight": (4,)}
    return {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _flax_tree(flat):
    """{'fnet': {'conv1': {'kernel': ...}}} by the state-dict -> flax names
    (kernels left in OIHW: the optimizer is elementwise)."""
    from mft_tpu_torch.models.raft.convert import flax_path
    tree = {}
    for name, v in flat.items():
        node = tree
        *mods, leaf = flax_path(name).split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("trainable", [None, ("occlusion_block",)])
def test_optimizer_updates(trainable):
    """6 AdamW + clip updates on given gradients (the 3rd and 5th clipped:
    global norm above 1) against optax's chain: parameters 1e-6 relative +
    1e-9; frozen parameters unchanged bit for bit."""
    params = _params()
    r = np.random.default_rng(9)
    tx_j, _ = jax_make_optimizer(lr=1e-3, num_steps=20, weight_decay=1e-2,
                                 params=_flax_tree(params), trainable_prefixes=trainable)
    pj = jax.tree.map(jnp.asarray, _flax_tree(params))
    state_j = tx_j.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tx_t, _ = make_optimizer(lr=1e-3, num_steps=20, weight_decay=1e-2, params=pt,
                             trainable_prefixes=trainable)
    state_t = tx_t.init(pt)
    for step in range(6):
        scale = 3.0 if step in (2, 4) else 0.05
        grads = {k: (r.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        upd, state_j = tx_j.update(jax.tree.map(jnp.asarray, _flax_tree(grads)), state_j, pj)
        pj = optax.apply_updates(pj, upd)
        gt = {k: torch.from_numpy(v) for k, v in grads.items() if tx_t.trains(k)}
        upd_t, state_t = tx_t.update(gt, state_t, pt)
        apply_updates(pt, upd_t)
    want = {k: np.asarray(v) for k, v in zip(params, [
        _get(pj, k) for k in params])}
    for k in params:
        if trainable is not None and not k.startswith("occlusion_block"):
            assert np.array_equal(pt[k].numpy(), params[k]), k
        np.testing.assert_allclose(pt[k].numpy(), want[k], rtol=1e-6, atol=1e-9, err_msg=k)
    assert state_t["count"] == 6


@pytest.mark.parametrize("peak", [1e27, 1e15], ids=["norm_overflows", "norm_huge"])
def test_optimizer_step_with_exploding_gradients(peak):
    """One element's gradient at ``peak``, the rest O(1), on the first step
    (OneCycle's warm-up): where the float32 global norm overflows (1e27) the
    clip scales every gradient to 0 and no parameter moves; where it is huge
    but finite (1e15) the O(1) gradients, clipped to ~1e-15, are far below
    AdamW's eps and their parameters do not move either. optax does the
    same: the parameters that move, and their values, equal its."""
    params = _params()
    r = np.random.default_rng(10)
    tx_j, _ = jax_make_optimizer(lr=1.25e-4, num_steps=5, weight_decay=1e-5)
    pj = jax.tree.map(jnp.asarray, _flax_tree(params))
    tx_t, _ = make_optimizer(lr=1.25e-4, num_steps=5, weight_decay=1e-5)
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    grads = {k: r.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    first = next(iter(grads))
    grads[first].flat[0] = peak
    upd, _ = tx_j.update(jax.tree.map(jnp.asarray, _flax_tree(grads)), tx_j.init(pj), pj)
    pj = optax.apply_updates(pj, upd)
    upd_t, _ = tx_t.update({k: torch.from_numpy(v) for k, v in grads.items()},
                           tx_t.init(pt), pt)
    apply_updates(pt, upd_t)
    moved_t = {k for k in params if not np.array_equal(pt[k].numpy(), params[k])}
    moved_j = {k for k in params if not np.array_equal(np.asarray(_get(pj, k)), params[k])}
    assert moved_t == moved_j
    assert moved_t == (set() if peak > 1e19 else {first})
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(_get(pj, k)), rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def _get(tree, name):
    from mft_tpu_torch.models.raft.convert import flax_path
    node = tree
    for part in flax_path(name).split("/"):
        node = node[part]
    return node
