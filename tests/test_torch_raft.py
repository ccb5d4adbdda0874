"""The port's RAFT-OU against the JAX package's, with the same weights.

The JAX RAFTFlow makes its random weights with flax ``RAFT.init``; the port
takes them through ``params_from_flax``. Both see the same uint8 BGR images
(60x68, so both pad to 64x72 and the pyramid's odd 9-wide level pools with
floor semantics) and 3 GRU iterations. On the CPU the port runs its kernels'
plain versions.
"""

import numpy as np
import pytest
import jax
import torch

from mft_tpu.config import Config as JaxConfig
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu_torch.config import Config
from mft_tpu_torch.models.raft import RAFT, RAFTFlow
from mft_tpu_torch.models.raft.convert import params_from_flax

H, W, ITERS = 60, 68, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flow_config(cls, dtype, corr_method="auto", conv_backend="auto"):
    conf = cls()
    conf.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": dtype, "corr_method": corr_method,
                        "conv_backend": conv_backend}
    conf.model = None
    conf.flow_iters = ITERS
    return conf


@pytest.fixture(scope="module")
def jax_variables():
    """numpy copy of the JAX package's random-init RAFT-OU weights."""
    flower = JaxRAFTFlow(_flow_config(JaxConfig, "float32"))
    return jax.tree.map(np.asarray, flower.variables)


def _images(seed=0, size=(H, W)):
    h, w = size
    rng = np.random.default_rng(seed)
    tex = (rng.random((h + 8, w + 8, 3)) * 255).astype(np.uint8)
    return tex[:h, :w].copy(), tex[3:h + 3, 2:w + 2].copy()


def _both(jax_variables, dtype, init_flow=None, jax_method="auto", port_method="auto",
          conv_backend="auto", size=(H, W)):
    jf = JaxRAFTFlow(_flow_config(JaxConfig, dtype, jax_method, conv_backend))
    jf.variables = jax.tree.map(np.asarray, jax_variables)
    tf = RAFTFlow(_flow_config(Config, dtype, port_method, conv_backend), device="cpu")
    tf.load_state_dict(params_from_flax(jax_variables))
    img1, img2 = _images(size=size)
    jflow, jextra = jf.compute_flow(img1, img2, mode="flow", numpy_out=True,
                                    init_flow=init_flow)
    tflow, textra = tf.compute_flow(img1, img2, mode="flow", numpy_out=True,
                                    init_flow=init_flow)
    return (jflow, jextra["occlusion"], jextra["sigma"]), (tflow, textra["occlusion"],
                                                           textra["sigma"])


def test_params_from_flax_covers_the_model(jax_variables):
    """Every state-dict entry of the port's RAFT has a flax leaf of its shape."""
    sd = params_from_flax(jax_variables)
    want = RAFT().state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # HWIO -> OIHW, values carried over unchanged
    k = np.asarray(jax_variables["params"]["update_block"]["encoder"]["convc1"]["kernel"])
    np.testing.assert_array_equal(sd["update_block.encoder.convc1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("init", ["zero", "flow_init"])
def test_compute_flow_matches_jax_f32(jax_variables, init):
    """float32: convolution sum order only, through 3 iterations: 1e-4
    absolute (flow in px, sigma ~3, occlusion in [0, 1]), 1e-5 relative.
    ``flow_init``: a smooth full-resolution initial flow, padded and
    downsampled to 1/8 by both wrappers."""
    init_flow = None
    if init == "flow_init":
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        init_flow = np.stack([3.0 + 0.05 * ys, -2.0 + 0.03 * xs], axis=-1)
    (jf, jo, js), (tf, to, ts) = _both(jax_variables, "float32", init_flow)
    assert tf.shape == (H, W, 2) and to.shape == (H, W) and ts.shape == (H, W)
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-5)


def _assert_close_in_scale(ported, reference):
    """Mean error under 2% of the mean magnitude and 99% of pixels within
    10% of it, for flow, occlusion and sigma."""
    for got, want, name in zip(ported, reference, ("flow", "occlusion", "sigma")):
        scale = float(np.abs(want).mean()) + 1e-6
        err = np.abs(got.astype(np.float32) - want.astype(np.float32))
        assert np.isfinite(got).all(), name
        assert err.mean() < 0.02 * scale, (name, err.mean(), scale)
        assert np.quantile(err, 0.99) < 0.1 * scale, (name, np.quantile(err, 0.99), scale)


def test_compute_flow_matches_jax_bf16(jax_variables):
    """bfloat16: the two frameworks round at other places (JAX's CPU lookup
    also rounds its tent weights to bf16), 8-bit mantissas, so compare in
    relation to the outputs' scale: mean error under 2% of the mean
    magnitude and 99% of pixels within 10% of it."""
    want, got = _both(jax_variables, "bfloat16")
    _assert_close_in_scale(got, want)


@pytest.mark.parametrize("method", ["packed", "pallas_t"])
def test_volume_layouts_match_jax_f32(jax_variables, method):
    """corr_method 'packed' / 'pallas_t' (the volume packed in one map, or
    lane-major) against the JAX RAFT with the same method, whose CPU path
    unpacks or transposes back and samples exactly: f32, 1e-4 absolute and
    1e-5 relative, as the volume path is held."""
    (jf, jo, js), (tf, to, ts) = _both(jax_variables, "float32", jax_method=method,
                                       port_method=method)
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("method", ["int8", "packed_i8"])
def test_int8_volumes_match_jax_f32_model(jax_variables, method):
    """corr_method 'int8' / 'packed_i8' in an f32 model against the JAX RAFT
    with the same method: both quantize the same volume to the same int8
    values and round the samples to bf16, so the relative tolerance of the
    bf16 comparison applies."""
    want, got = _both(jax_variables, "float32", jax_method=method, port_method=method)
    _assert_close_in_scale(got, want)


@pytest.mark.parametrize("method", ["alt", "win"])
def test_feature_lookup_methods_match_jax_f32(jax_variables, method):
    """corr_method 'alt' / 'win' (no volume; the plain version on the CPU)
    against the JAX RAFT with 'mxu', its exact volume lookup of the same
    function: the same weights, 3 iterations, f32, 1e-4 absolute and 1e-5
    relative, as the volume path is held."""
    (jf, jo, js), (tf, to, ts) = _both(jax_variables, "float32", jax_method="mxu",
                                       port_method=method)
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("method", ["fold", "mixed"])
def test_folded_volumes_match_jax_f32(jax_variables, method):
    """corr_method 'fold' / 'mixed' against the JAX RAFT with the same
    method, at 64x256 (stride-8 map 8x32: level 0 folds 4 rows into each
    128-lane row, the others are one zero-padded row ('fold') or stay plain
    ('mixed')). JAX builds and looks up the folded volume with its Pallas
    kernels in interpret mode, the mixed one on its exact CPU path; f32,
    1e-4 absolute and 1e-5 relative, as the volume path is held."""
    (jf, jo, js), (tf, to, ts) = _both(jax_variables, "float32", jax_method=method,
                                       port_method=method, size=(64, 256))
    assert tf.shape == (64, 256, 2)
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-5)


def test_conv_backend_pallas_matches_jax_f32(jax_variables):
    """conv_backend 'pallas' at 64x512, the JAX model's only width class
    where its conv_apply reaches conv_pallas (W8 = 64; interpret mode): the
    update block's convs in the port's fixed order against JAX's per-tap
    dots; f32, 1e-4 absolute and 1e-5 relative, as the volume path is
    held."""
    (jf, jo, js), (tf, to, ts) = _both(jax_variables, "float32", conv_backend="pallas",
                                       size=(64, 512))
    assert tf.shape == (64, 512, 2)
    np.testing.assert_allclose(tf, jf, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(ts, js, atol=1e-4, rtol=1e-5)


# the update block's convs that conv_apply runs, with the act the port fuses
ROUTED_CONVS = {("encoder", "convc1"): "relu", ("encoder", "convc2"): "relu",
                ("encoder", "convf2"): "relu", ("encoder", "conv"): "relu",
                **{("gru", f"conv{g}{s}"): None for s in "12" for g in "zrq"},
                ("flow_head", "conv1"): "relu", ("flow_head", "conv2"): None}


def test_bf16_pallas_convs_add_float32_biases(jax_variables):
    """A bf16 model with conv_backend 'pallas' adds each routed conv's
    float32 bias parameter, as JAX's conv_apply(matmul='pallas') does
    (mft_tpu/ops/conv_pallas.py, interpret mode). The flax params get
    random nonzero biases, and kernels and inputs on a 2^-8 grid whose
    products sum exactly in float32 in any order, so the two must agree bit
    for bit; a bias rounded to bf16 first moves many outputs by an ulp."""
    import jax.numpy as jnp
    from mft_tpu.models.raft.update import conv_apply as jax_conv_apply
    from mft_tpu_torch.models.raft.update import conv_apply

    rng = np.random.default_rng(5)
    variables = jax.tree.map(np.array, jax_variables)
    block = variables["params"]["update_block"]
    for mod, name in ROUTED_CONVS:
        leaf = block[mod][name]
        leaf["kernel"] = (rng.integers(-4, 5, leaf["kernel"].shape) / 256).astype(np.float32)
        leaf["bias"] = rng.standard_normal(leaf["bias"].shape).astype(np.float32)
    flower = RAFTFlow(_flow_config(Config, "bfloat16", conv_backend="pallas"), device="cpu")
    flower.load_state_dict(params_from_flax(variables))
    for (mod, name), act in ROUTED_CONVS.items():
        m = getattr(getattr(flower.model.update_block, mod), name)
        assert m.weight.dtype == torch.bfloat16 and m.bias.dtype == torch.float32
        kernel, bias = block[mod][name]["kernel"], block[mod][name]["bias"]
        kh, kw, cin, _ = kernel.shape
        x = rng.integers(-1, 2, (1, 4, 64, cin)).astype(np.float32)   # W = 64: conv_pallas
        pad = ((kh // 2, kh // 2), (kw // 2, kw // 2))
        want = jax_conv_apply(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel),
                              jnp.asarray(bias), pad, jnp.bfloat16, "pallas")
        if act:
            want = jax.nn.relu(want)
        got = conv_apply(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(), m.weight,
                         m.bias, pad, "pallas", act=act)
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want.astype(jnp.float32)),
                                      err_msg=f"{mod}.{name}")


def test_cuda_entry_point_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        RAFTFlow(_flow_config(Config, "float32"))
