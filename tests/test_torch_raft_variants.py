"""Every RAFT variant of the port against the JAX package's, with the same weights.

The JAX weights are ``RAFT(...).init`` at PRNGKey(0) (jitted, in a module
fixture: the big model and the small one; the 'morelayers' tree is the big
one with JAX's init of an ``OcclusionAndUncertaintyBlock('morelayers')`` in
place of its heads), carried across by ``params_from_flax``. Both models see the same
numpy images, 64x96 (pyramid levels 8x12 .. 1x1), float32; the port runs its
kernels' plain versions on the CPU. Covered: the small model in test mode,
the train sequence and the per-pair schedule; every OU module (big and
small) and ``relu_uncertainty`` in test mode and the train sequence;
``normalized_features`` (the bf16 rounding order too); the fused encoder;
TC mode; a small-model training step; the converter and the checkpoint
export of both new trees; the training loop's ``--small``.

f32 tolerance of the model outputs: 1e-4 absolute and 1e-4 relative (the
two frameworks sum convolutions in other orders; through 3 iterations the
largest gaps measured are ~1e-5 of outputs of order 1-10).
"""

import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mft_tpu.config import Config as JaxConfig
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu.models.raft.encoder_fuse import fused_basic_encode as jax_fused_basic_encode
from mft_tpu.models.raft import wrapper as jax_wrapper
from mft_tpu.models.raft.raft import RAFT as JaxRAFT, RAFTParams as JaxParams
from mft_tpu.models.raft.update import OcclusionAndUncertaintyBlock as JaxOUBlock
from mft_tpu.train.loop import make_train_step as jax_make_train_step
from mft_tpu.train.losses import sequence_loss as jax_sequence_loss
from mft_tpu.train.optim import make_optimizer as jax_make_optimizer
from mft_tpu_torch import environment
from mft_tpu_torch.config import Config
from mft_tpu_torch.models.raft import RAFT, RAFTFlow
from mft_tpu_torch.models.raft.convert import flax_from_params, params_from_flax
from mft_tpu_torch.models.raft.corr import normalize_features
from mft_tpu_torch.models.raft.encoder_fuse import fused_basic_encode
from mft_tpu_torch.models.raft.flax_msgpack import read_variables
from mft_tpu_torch.models.raft.raft import RAFTParams
from mft_tpu_torch.models.raft.wrapper import load_weights, random_init
from mft_tpu_torch.train import synth as tsynth
from mft_tpu_torch.train.checkpoint import export_weights
from mft_tpu_torch.train.loop import freeze, main, make_train_step
from mft_tpu_torch.train.optim import make_optimizer

H, W, ITERS = 64, 96, 3
TOL = dict(atol=1e-4, rtol=1e-4)
# the JAX trees: name -> RAFTParams keywords
TREES = {"big": {}, "small": {"small": True},
         "morelayers": {"occlusion_module": "separate_with_uncertainty_morelayers"}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU convolutions: the
    suite runs 6 xdist workers, and each one's default thread pool (every
    core) oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    """numpy copies of the JAX random-init variables of each tree."""
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    out = {}
    for name in ("big", "small"):
        model = JaxRAFT(cfg=JaxParams(**TREES[name]))
        init = jax.jit(lambda k, m=model: m.init(k, dummy, dummy, iters=1))
        out[name] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    # the OU block's input: net, inp 128 each, corr 324, flow, delta 2 each, motion 128
    ins = [jnp.zeros((1, 8, 8, c), jnp.float32) for c in (128, 128, 324, 2, 2, 128)]
    heads = JaxOUBlock(architecture="morelayers").init(jax.random.PRNGKey(1), *ins)
    params = dict(out["big"]["params"], occlusion_block=jax.tree.map(np.asarray,
                                                                     heads["params"]))
    out["morelayers"] = dict(out["big"], params=params)
    return out


def _tree(trees, small, module):
    """The tree of a variant: 'morelayers' heads have their own; without OU
    heads the model has no occlusion_block."""
    tree = trees["small" if small else "morelayers" if module and "morelayers" in module
                 else "big"]
    if module is None:
        tree = {c: {k: v for k, v in t.items() if k != "occlusion_block"}
                for c, t in tree.items()}
    return tree


def _images(B=2, seed=0, size=(H, W)):
    h, w = size
    rng = np.random.default_rng(seed)
    tex = (rng.random((B, h + 8, w + 8, 3)) * 255).astype(np.float32)
    return tex[:, :h, :w].copy(), tex[:, 3:h + 3, 2:w + 2].copy()


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _port(tree, train_mode=False, **kw):
    model = RAFT(RAFTParams(compute_dtype="float32", **kw), train_mode=train_mode)
    model.load_state_dict(params_from_flax(tree))
    return model if train_mode else model.eval()


def _assert_outputs(got, want, tol=TOL):
    """The same keys in the same order; every output (each iteration's, for
    the train sequence) within ``tol``."""
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (list, tuple)):
            assert isinstance(g, list) and len(g) == len(w), k
            pairs = zip(g, w)
        else:
            pairs = [(g, w)]
        for gi, wi in pairs:
            gi = gi.detach().numpy()
            assert gi.shape == wi.shape, k
            np.testing.assert_allclose(gi, np.asarray(wi), err_msg=k, **tol)


def _both(trees, iters=ITERS, test_mode=True, B=2, **kw):
    """(port outputs, JAX outputs) of the variant ``kw`` on the same images."""
    tree = _tree(trees, kw.get("small", False), kw.get("occlusion_module",
                                                       "separate_with_uncertainty"))
    img1, img2 = _images(B)
    jkw = {**kw}
    if jkw.get("corr_method") == "alt":
        jkw["corr_method"] = "mxu"   # the exact volume lookup of the same function
    want = JaxRAFT(cfg=JaxParams(compute_dtype="float32", **jkw)).apply(
        tree, jnp.asarray(img1), jnp.asarray(img2), iters=iters, test_mode=test_mode)
    model = _port(tree, **kw)
    with torch.no_grad():
        got = model(_nchw(img1), _nchw(img2), iters=iters, test_mode=test_mode)
    return got, want


@pytest.mark.parametrize("mode", ["test", "sequence"])
def test_small_model_matches_jax(trees, mode):
    """The small RAFT (bottleneck encoders, radius 3, ConvGRU, bilinear
    upsampling) in test mode and the train sequence (every iteration's flow,
    occlusion and uncertainty)."""
    got, want = _both(trees, test_mode=mode == "test", small=True)
    _assert_outputs(got, want)


def test_small_model_schedule_matches_jax(trees):
    """The per-pair schedule (1, 3) on the small model: each pair its own
    count (the pairs reordered so that the active ones are a batch prefix),
    the heads and the bilinear upsampling where a pair ends."""
    got, want = _both(trees, iters=(1, 3), small=True)
    _assert_outputs(got, want)


OU_CASES = [("big", "separate_with_uncertainty", True),
            ("big", "separate_with_uncertainty_morelayers", False),
            ("big", "separate_with_uncertainty_upsample8", False),
            ("big", "separate", False),
            ("big", None, False),
            ("small", "separate", False),
            ("small", None, False),
            ("small", "separate_with_uncertainty_upsample8", True)]


@pytest.mark.parametrize("mode", ["test", "sequence"])
@pytest.mark.parametrize("model,module,relu", OU_CASES)
def test_ou_modules_match_jax(trees, model, module, relu, mode):
    """Each OU module: 'morelayers' heads, 'upsample8' (uncertainty x 8), an
    occlusion-only module ('separate': no uncertainty key), none (no
    occlusion key either; the last test-mode iteration fuses the lookup
    too), and ``relu_uncertainty``; the same keys as JAX's outputs."""
    kw = dict(occlusion_module=module, relu_uncertainty=relu, small=model == "small")
    got, want = _both(trees, test_mode=mode == "test", **kw)
    keys = ["flow"] + ["occlusion"] * (module is not None) + [
        "uncertainty"] * bool(module and "with_uncertainty" in module) + ["coords"]
    assert list(got) == keys
    if relu:
        unc = got["uncertainty"] if mode == "test" else got["uncertainty"][-1]
        assert bool((unc >= 0).all()) and bool((unc == 0).any())
    _assert_outputs(got, want)


@pytest.mark.parametrize("model,method", [("big", "auto"), ("big", "alt"), ("small", "auto"),
                                          ("small", "alt")])
def test_normalized_features_match_jax(trees, model, method):
    """``normalized_features`` on the 'auto' volume and on 'alt' (against
    JAX's 'mxu', its exact volume lookup of the same function, as
    test_torch_corr_alt.py holds 'alt')."""
    got, want = _both(trees, normalized_features=True, corr_method=method,
                      small=model == "small")
    _assert_outputs(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_features_rounds_as_jax(dtype):
    """The features over their f32 norm cast to the dtype, divided in the
    dtype, on the fnet widths 128 and 256: in bf16 bit for bit with JAX's
    expression (which is not the f32 quotient rounded once); in f32 within
    one ulp (2.5e-7 relative: XLA's CPU division is not always correctly
    rounded)."""
    rng = np.random.default_rng(3)
    for C in (128, 256):
        f = rng.standard_normal((2, 12, 9, C)).astype(np.float32) * 3
        jf = jnp.asarray(f).astype(dtype)
        want = np.asarray((jf / jnp.linalg.norm(jf.astype(jnp.float32), axis=-1,
                                                keepdims=True).astype(jf.dtype)).astype(
            jnp.float32))
        tf = torch.from_numpy(f).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
        out = normalize_features(tf)
        assert out.dtype == tf.dtype
        got = out.float().permute(0, 2, 3, 1).numpy()
        if dtype == "float32":   # XLA's CPU division may differ in the last bit
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0.0)
        else:
            np.testing.assert_array_equal(got, want)
            # another rounding than one of the f32 quotient
            once = tf.float() / torch.linalg.vector_norm(tf.float(), dim=1, keepdim=True)
            assert not torch.equal(once.to(tf.dtype), out)


def test_fused_encoder_matches_jax(trees):
    """The grouped-conv fnet + cnet stack against JAX's
    ``fused_basic_encode`` and against the port's two encoders apart (f32,
    1e-4: cuDNN's or the CPU's grouped conv sums in its own order), and
    through ``RAFTFlow(fused_encoder=True).padded_encode``."""
    tree = trees["big"]
    img, _ = _images(1)
    jf, jc = jax_fused_basic_encode(tree, jnp.asarray(img))
    model = _port(tree)
    with torch.no_grad():
        tf, tc = fused_basic_encode(model, _nchw(img))
        sf, sc = model.encode(_nchw(img))
    for got, want in ((tf, jf), (tc, jc)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(tf, sf, **TOL)
    torch.testing.assert_close(tc, sc, **TOL)
    flower = RAFTFlow(_flow_config(Config, fused=True), device="cpu")
    flower.load_state_dict(params_from_flax(tree))
    assert flower.fused_encoder
    pf, pc = flower.padded_encode(torch.from_numpy(img))
    torch.testing.assert_close(pf, tf, atol=0.0, rtol=0.0)
    torch.testing.assert_close(pc, tc, atol=0.0, rtol=0.0)
    small = RAFTFlow(_flow_config(Config, fused=True, small=True), device="cpu")
    assert not small.fused_encoder   # the big model's encoders only, as in JAX


def _flow_config(cls, fused=False, **raft):
    conf = cls()
    conf.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32", **raft}
    conf.model = None
    conf.flow_iters = ITERS
    if fused:
        conf.fused_encoder = True
    return conf


def test_tc_mode_matches_jax(trees, monkeypatch):
    """``compute_flow(mode='TC')``: source pixel coordinates in raster order,
    destinations = source + flow, occlusion and sigma flattened; 60x92 BGR
    images (padded to 64x96), against JAX's compute_flow on the same
    weights: coordinates exact, the rest 1e-4."""
    # the fixture's weights in place of JAX's random init
    monkeypatch.setattr(jax_wrapper, "_random_init", lambda model, hw: trees["big"])
    jf = JaxRAFTFlow(_flow_config(JaxConfig))
    tf = RAFTFlow(_flow_config(Config), device="cpu")
    tf.load_state_dict(params_from_flax(trees["big"]))
    a, b = _images(1, size=(60, 92))
    img1, img2 = a[0].astype(np.uint8), b[0].astype(np.uint8)
    jsrc, jdst, jextra = jf.compute_flow(img1, img2, mode="TC", numpy_out=True)
    src, dst, extra = tf.compute_flow(img1, img2, mode="TC", numpy_out=True)
    assert src.shape == dst.shape == (60 * 92, 2) and extra["occlusion"].shape == (60 * 92,)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_allclose(dst, jdst, **TOL)
    for k in ("occlusion", "sigma"):
        np.testing.assert_allclose(extra[k], jextra[k], err_msg=k, **TOL)
    flow, _ = tf.compute_flow(img1, img2, numpy_out=True)
    np.testing.assert_array_equal(dst, src + flow.reshape(-1, 2))
    with pytest.raises(ValueError, match="unknown mode"):
        tf.compute_flow(img1, img2, mode="sparse")


@pytest.mark.parametrize("module", ["separate", None])
def test_flow_service_needs_both_heads(module):
    """A module without the uncertainty head (or without both) fails in
    ``compute_flow`` and in the tracker, naming the missing head, as JAX's
    service fails reading ``out['uncertainty']``."""
    from mft_tpu_torch.tracker import MFT
    flower = RAFTFlow(_flow_config(Config, occlusion_module=module), device="cpu")
    img = np.zeros((16, 16, 3), np.uint8)
    missing = "occlusion" if module is None else "uncertainty"
    with pytest.raises(ValueError, match=f"no {missing} head"):
        flower.compute_flow(img, img)
    conf = Config()
    conf.flow_config = _flow_config(Config, occlusion_module=module)
    conf.flow_config.of_class = RAFTFlow
    conf.deltas = [np.inf, 1]
    conf.occlusion_threshold = 0.02
    tracker = MFT(conf, device="cpu")
    tracker.init(img)
    with pytest.raises(ValueError, match=f"no {missing} head"):
        tracker.track(img)


def _before_norm(name):
    """fnet's biases that an instance norm follows: zero gradient in exact
    arithmetic (the norm takes the mean out)."""
    return name.startswith("fnet.") and name.endswith(".bias") and name != "fnet.conv2.bias"


def _train_batch(seed, B=2):
    r = np.random.default_rng(seed)
    img1, img2 = _images(B, seed)
    flow = np.broadcast_to(np.array([-2.0, -3.0], np.float32), (B, H, W, 2)).copy()
    flow += r.normal(size=flow.shape).astype(np.float32)
    valid = (r.random((B, H, W)) > 0.1).astype(np.float32)
    occl = (r.random((B, H, W)) > 0.7).astype(np.float32)
    occl[:, ::7] = 0.5    # soft ground truth: left out of the occlusion loss
    return img1, img2, flow, valid, occl


def test_small_train_step_matches_jax(trees):
    """One step of ``make_train_step`` of the small model (full recipe,
    train mode, lr 1e-3 over 10 steps) against JAX's on the same batch:
    loss and metrics 1e-5 relative; per gradient the largest gap within 1e-2
    of the tensor's largest |gradient| and the gap's norm within 3e-3 of its
    norm (f32 sums in other orders, amplified by fnet's instance norms in the
    backward), the biases before those norms (zero in exact arithmetic)
    within 1e-5 of their conv weight's largest gradient; the update every
    trainable tensor takes within 2 lr_0 of JAX's (Adam's first step is
    about lr * sign(g), whose sign rounding noise can flip) with a cosine
    >= 0.99 to it, those biases aside."""
    tree = trees["small"]
    lk = dict(gamma=0.85, freeze_optical_flow=False, occlusion_module="separate_with_uncertainty",
              uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
              weighting_unc_loss=False)
    batch = _train_batch(0)
    jmodel = JaxRAFT(cfg=JaxParams(small=True), train_mode=True)
    jb = tuple(jnp.asarray(x) for x in batch)

    def loss_fn(params):
        preds = jmodel.apply({"params": params}, jb[0], jb[1], iters=ITERS, test_mode=False)
        return jax_sequence_loss(preds, *jb[2:4], occl_gt=jb[4], **lk)[0]

    params = jax.tree.map(jnp.asarray, tree["params"])
    jgrads = params_from_flax({"params": jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
        params))})
    tx, _ = jax_make_optimizer(lr=1e-3, num_steps=10, params=params)
    jstep = jax_make_train_step(jmodel, tx, lk, iters=ITERS)
    jstate, jmetrics = jstep({"variables": {"params": params}, "opt_state": tx.init(params),
                              "step": 0}, jb)
    jafter = params_from_flax(jax.tree.map(np.asarray, jstate["variables"]))

    model = _port(tree, train_mode=True, small=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ttx, schedule = make_optimizer(lr=1e-3, num_steps=10, params=dict(model.named_parameters()))
    freeze(model, ttx.mask)
    state = {"model": model, "opt_state": ttx.init(dict(model.named_parameters())), "step": 0}
    state, metrics = make_train_step(model, ttx, lk, iters=ITERS)(
        state, tuple(torch.from_numpy(x) for x in batch))
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    lr0 = schedule(0)
    after = model.state_dict()
    for n, p in model.named_parameters():
        got, want = p.grad, jgrads[n]
        if _before_norm(n):
            scale = float(jgrads[n[:-len("bias")] + "weight"].abs().max())
            assert float(got.abs().max()) <= 1e-5 * scale, n
            assert float(want.abs().max()) <= 1e-5 * scale, n
            continue
        assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max()), n
        assert float((got - want).norm()) <= 3e-3 * float(want.norm()), n
        du, dj = after[n] - before[n], jafter[n] - before[n]
        assert float((du - dj).abs().max()) <= 2 * lr0, n
        cos = float((du * dj).sum() / (du.norm() * dj.norm()))
        assert cos >= 0.99, (n, cos)


@pytest.mark.parametrize("name", ["small", "morelayers"])
def test_converter_round_trips_new_trees(trees, name, tmp_path):
    """``params_from_flax`` maps every leaf of the small model's and the
    'morelayers' heads' flax trees onto the port's state dict (names and
    shapes), ``flax_from_params`` maps back to the same tree bit for bit,
    and the checkpoint export (``export_weights``) writes a msgpack that the
    port's reader and ``load_weights`` read back unchanged."""
    tree = trees[name]
    sd = params_from_flax(tree)
    model = RAFT(RAFTParams(**TREES[name]))
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    back = flax_from_params(sd)
    flat = lambda t, p=(): [x for k, v in sorted(t.items()) for x in (
        flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), np.asarray(v))])]
    got, exp = flat(back), flat(tree)
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (p, a), (_, b) in zip(got, exp):
        np.testing.assert_array_equal(a, b, err_msg="/".join(p))
    model.load_state_dict(sd)
    path = tmp_path / f"{name}.msgpack"
    export_weights(path, model)
    for k, v in load_weights(path).items():
        assert torch.equal(v, sd[k]), k
    read = flat(read_variables(path))
    assert [p for p, _ in read] == [p for p, _ in exp]


def test_loop_trains_the_small_model(tmp_path, monkeypatch):
    """``--small`` through the entry point: 1 step at 64x96 with 1 iteration
    on a tiny Sintel-form tree, from the random init of ``build_state``; the
    export holds the small model's tree (no batch norm) and loads into a
    small RAFT; the step moved the weights."""
    root = tsynth.write_sintel_tree(tmp_path / "sintel", scenes=("synth_0",), frames=3, H=88,
                                    W=120, seed=7)
    monkeypatch.setattr(environment, "env_settings",
                        lambda: types.SimpleNamespace(sintel_dir=str(root)))
    args = ["--name", "s", "--stage", "sintel", "--small", "--num_steps", "1",
            "--batch_size", "2", "--image_size", "64", "96", "--iters", "1",
            "--num_workers", "1", "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu"]
    main(args)
    sd = params_from_flax(read_variables(tmp_path / "ck" / "s" / "s_step1.msgpack"))
    small = RAFT(RAFTParams(small=True))
    small.load_state_dict(sd)
    assert not any("running" in k for k in sd)   # no batch norm
    init = random_init(RAFT(RAFTParams(small=True)), 1234)   # build_state's seed
    assert not torch.equal(sd["update_block.flow_head.conv2.weight"],
                           init.state_dict()["update_block.flow_head.conv2.weight"])
