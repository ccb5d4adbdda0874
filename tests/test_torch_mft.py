"""The port's MFT tracker against the JAX package's, frame by frame.

Both trackers track the same 64x64 BGR clip (a random texture under a
constant shift) with the default deltas {inf, 1, 2, 4, 8, 16, 32}, the same
RAFT-OU weights (the JAX random init, carried over by ``params_from_flax``),
2 GRU iterations and float32 compute. The JAX tracker runs its fused frame
step with ``chain_select_ref`` on the CPU; the port its plain versions.
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch

from mft_tpu.config import Config as JaxConfig
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu.tracker import MFT as JaxMFT
from mft_tpu_torch.config import Config, default_config
from mft_tpu_torch.models.raft import RAFTFlow
from mft_tpu_torch.models.raft.convert import params_from_flax
from mft_tpu_torch.tracker import MFT

H = W = 64
FRAMES = 5
DELTAS = [np.inf, 1, 2, 4, 8, 16, 32]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cls, flower_cls, corr_method="auto", conv_backend="auto"):
    conf = cls()
    flow = cls()
    flow.of_class = flower_cls
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32", "corr_method": corr_method,
                        "conv_backend": conv_backend}
    flow.model = None
    flow.flow_iters = 2
    conf.flow_config = flow
    conf.deltas = DELTAS
    conf.occlusion_threshold = 0.02
    return conf


def _clip(n, seed=0):
    rng = np.random.default_rng(seed)
    tex = (rng.random((H + 2 * n + 2, W + 2 * n + 2, 3)) * 255).astype(np.uint8)
    return [np.ascontiguousarray(tex[k:k + H, 2 * k:2 * k + W]) for k in range(n + 1)]


def _run_both(n_frames, jax_method="auto", port_method="auto", conv_backend="auto"):
    frames = _clip(n_frames)
    jt = JaxMFT(_config(JaxConfig, JaxRAFTFlow, jax_method, conv_backend))
    tt = MFT(_config(Config, RAFTFlow, port_method, conv_backend), device="cpu")
    tt.flower.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jt.flower.variables)))
    jt.init(frames[0])
    tt.init(frames[0])
    out = []
    for img in frames[1:]:
        a = jt.track(img).result
        b = tt.track(img).result
        out.append(([np.asarray(x) for x in (a.flow, a.occlusion, a.sigma)],
                    [x.numpy() for x in (b.flow, b.occlusion, b.sigma)]))
    return out


@pytest.fixture(scope="module")
def both_runs():
    return _run_both(FRAMES)


ALT_FRAMES = 3


@pytest.fixture(scope="module")
def both_runs_alt():
    """The port with corr_method 'alt' (no volume) against the JAX tracker
    with 'mxu', its exact volume lookup of the same function."""
    return _run_both(ALT_FRAMES, jax_method="mxu", port_method="alt")


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
def test_frame_matches_jax(both_runs, frame):
    """float32, same math: 1e-4 on flow (px), occlusion and sigma at every
    pixel, so every pixel selected the same candidate."""
    want, got = both_runs[frame - 1]
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5,
                                   err_msg=f"frame {frame} {name}")


@pytest.mark.parametrize("frame", range(1, ALT_FRAMES + 1))
def test_alt_frame_matches_jax(both_runs_alt, frame):
    """float32: 1e-4 on flow (px), occlusion and sigma at every pixel."""
    want, got = both_runs_alt[frame - 1]
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5,
                                   err_msg=f"alt frame {frame} {name}")


@pytest.mark.parametrize("key,value,error", [
    ("cache_delta_infinity", True, None),
    ("warm_start_inf+cache_delta_infinity", True, ValueError),
    ("warm_start_inf", True, None),
])
def test_unported_tracker_options_raise(key, value, error):
    """Every tracker option of the JAX package is ported: cache_delta_infinity
    builds and tracks as JAX's tracker does (the same candidates, the template
    pair cacheable, so a second pass over a frame runs no RAFT and gives the
    same result; tests/test_torch_mft_cache.py holds its frames against
    JAX's); warm_start_inf with
    cache_delta_infinity is refused with the JAX tracker's ValueError, before
    any model is built. warm_start_inf without an infinite delta is a no-op,
    as in JAX (``_warm_start``)."""
    conf = _config(Config, RAFTFlow)
    for k in key.split("+"):
        setattr(conf, k, value)
    if key == "cache_delta_infinity":
        from mft_tpu_torch.io import FlowCache
        jconf = _config(JaxConfig, JaxRAFTFlow)
        jconf.cache_delta_infinity = True
        jconf.flow_config.of_class = lambda config, **kw: None   # no model needed
        jt = JaxMFT(jconf)
        tt = MFT(conf, device="cpu")
        for start, td in ((0, 1), (9, 1), (9, -1)):
            for m in (jt, tt):
                m.start_frame_i, m.time_direction = start, td
            for t in range(start, start + 40 * td, td):
                assert ([dataclasses.astuple(c) for c in tt._candidates(t)]
                        == [dataclasses.astuple(c) for c in jt._candidates(t)])
        frames, cache = _clip(1), FlowCache(None)
        results = []
        for _ in range(2):   # the second pass hits the template pair too: no RAFT
            tt.init(frames[0], flow_cache=cache)
            results.append(tt.track(frames[1]).result)
        assert (cache.hits, cache.misses, sorted(cache.device_cache)) == (2, 2, [(0, 1)])
        assert all(torch.equal(getattr(results[0], f), getattr(results[1], f))
                   for f in ("flow", "occlusion", "sigma"))
        return
    if error is None:
        jconf = _config(JaxConfig, JaxRAFTFlow)
        jconf.warm_start_inf = True
        for c in (conf, jconf):
            c.deltas = [1, 2]
            c.flow_config.of_class = lambda config, **kw: None   # no model needed
        assert not MFT(conf, device="cpu")._warm_start() and not JaxMFT(jconf)._warm_start()
        return
    with pytest.raises(error, match="cannot be combined"):
        MFT(conf, device="cpu")
    jconf = _config(JaxConfig, JaxRAFTFlow)
    for k in key.split("+"):
        setattr(jconf, k, value)
    with pytest.raises(ValueError, match="cannot be combined"):
        JaxMFT(jconf)
    for k in key.split("+"):
        setattr(conf, k, False)
    assert MFT(conf, device="cpu").deltas == DELTAS


@pytest.mark.parametrize("exact", [False, True])
def test_exact_chain_is_accepted(exact):
    """exact_chain asks the JAX tracker for chain_select_ref's exact math,
    which the port's chain + select always computes: both values build."""
    conf = _config(Config, RAFTFlow)
    conf.exact_chain = exact
    assert MFT(conf, device="cpu").occlusion_threshold == 0.02


def test_default_config_is_the_main_path():
    cfg = default_config()
    assert cfg.deltas == DELTAS and cfg.occlusion_threshold == 0.02
    flow = cfg.flow_config
    assert flow.flow_iters == 12 and flow.of_class is RAFTFlow
    assert flow.raft_params == {"occlusion_module": "separate_with_uncertainty",
                                "small": False, "compute_dtype": "bfloat16"}


def test_ring_slots_follow_the_frame_index():
    """The template lives in slot ``ring``; frame t in slot t % ring;
    candidates before the start are invalid and read the template."""
    tt = MFT(_config(Config, RAFTFlow), device="cpu")
    tt.start_frame_i, tt.time_direction = 0, 1
    cands = tt._candidates(3)
    assert [c.slot for c in cands] == [32, 2, 1, 32, 32, 32, 32]
    assert [c.valid for c in cands] == [True, True, True, False, False, False, False]
    assert [c.left_id for c in cands] == [0, 2, 1, -1, -5, -13, -29]
    assert [c.cacheable for c in cands] == [False, True, True, False, False, False, False]
    slots, valid, wslot = tt._step_indices(cands, 3)
    assert slots.tolist() == [32, 2, 1, 32, 32, 32, 32] and wslot == 3
    assert tt._step_indices(cands, 3)[0] is slots      # cached upload


def test_tracker_raises_without_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        MFT(_config(Config, RAFTFlow))
