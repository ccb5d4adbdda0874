"""The port's multi-clip StreamingTracker on the CPU.

Against the JAX package's ``StreamingTracker`` (no mesh, ``chain_select_ref``
on the CPU): 2 clips of 64x64 BGR texture, deltas {inf, 1, 2}, 2 GRU
iterations, float32, the same RAFT-OU weights (the JAX random init carried
over by ``params_from_flax``), through the feature-ring step and the
injected step, at ``test_torch_mft.py``'s tolerance. Against the port's
single-clip ``MFT`` (itself held to JAX in ``test_torch_mft.py``,
``test_torch_schedule.py`` and ``test_torch_warm_start.py``), per clip: the
per-delta schedule (over 8 clips), the template warm start and the image
step of a flower with no ``padded_encode``. The clip axis of the plain chain
+ select against single-clip calls, bit for bit, and the errors.
"""

import numpy as np
import pytest
import jax
import torch

from mft_tpu.config import Config as JaxConfig
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu.parallel.streaming import StreamingTracker as JaxStreamingTracker
from mft_tpu_torch import ops
from mft_tpu_torch.config import Config
from mft_tpu_torch.core.flowou import FlowOU
from mft_tpu_torch.models.raft import RAFTFlow
from mft_tpu_torch.models.raft.convert import params_from_flax
from mft_tpu_torch.parallel import StreamingTracker
from mft_tpu_torch.tracker import MFT
from mft_tpu_torch.tracker.fused import chain_select, chain_select_ref

H = W = 64
C = 2
STEPS = 4
DELTAS = [np.inf, 1, 2]
TOL = dict(atol=1e-4, rtol=1e-5)   # test_torch_mft.py's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU convolutions: the
    suite runs 6 xdist workers, and each one's default thread pool (every
    core) oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cls, flower_cls, iters=2, schedule=None, warm=False):
    conf = cls()
    flow = cls()
    flow.of_class = flower_cls
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32"}
    flow.model = None
    flow.flow_iters = iters
    conf.flow_config = flow
    conf.deltas = DELTAS
    conf.occlusion_threshold = 0.02
    conf.flow_iters_schedule = schedule
    conf.warm_start_inf = warm
    return conf


def _clips(n_clips, steps=STEPS):
    """(steps + 1, n_clips, H, W, 3) uint8 BGR: clip c a texture of its own
    seed shifted (2, 1) px a frame."""
    out = []
    for c in range(n_clips):
        rng = np.random.default_rng(10 + c)
        tex = (rng.random((H + steps + 2, W + 2 * steps + 2, 3)) * 255).astype(np.uint8)
        out.append([tex[k:k + H, 2 * k:2 * k + W] for k in range(steps + 1)])
    return np.ascontiguousarray(np.stack(out, axis=1))


def _rows(seed):
    """Injected rows of one pair for every clip: plausible flows,
    occlusions and sigmas."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, 3, (C, H, W, 2)).astype(np.float32),
            rng.uniform(0, 0.03, (C, H, W)).astype(np.float32),
            rng.uniform(0.2, 2.0, (C, H, W)).astype(np.float32))


def _np(r):
    return [np.asarray(x) for x in (r.flow, r.occlusion, r.sigma)]


@pytest.fixture(scope="module")
def jax_and_port():
    """Both trackers over the same clips: the feature-ring step for STEPS
    timesteps, then, from a new init, the injected step (pairs 1 and 2
    injected every timestep, the template pair through RAFT). Two JAX
    streaming compiles: its feature step and its injected step."""
    frames = _clips(C)
    jt = JaxStreamingTracker(_config(JaxConfig, JaxRAFTFlow), n_clips=C)
    tt = StreamingTracker(_config(Config, RAFTFlow), n_clips=C, device="cpu")
    tt.flower.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jt.flower.variables)))
    runs = {}
    for kind in ("features", "injected"):
        a0, b0 = jt.init(frames[0]), tt.init(frames[0])
        out = [(_np(a0), _np(b0))]
        for k in range(1, STEPS + 1):
            inj = {1: _rows(2 * k), 2: _rows(2 * k + 1)} if kind == "injected" else None
            out.append((_np(jt.track(frames[k], injected=inj)),
                        _np(tt.track(frames[k], injected=inj))))
        runs[kind] = out
    return runs


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_feature_step_matches_jax(jax_and_port, step):
    """float32, same math: 1e-4 on flow (px), occlusion and sigma at every
    pixel of every clip; step 0 is init's zero FlowOUs."""
    want, got = jax_and_port["features"][step]
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        assert g.shape == w.shape and g.shape[0] == C, name
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {step} {name}")


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_injected_step_matches_jax(jax_and_port, step):
    """The injected rows as given, the template pair through RAFT (a batch
    of C pairs), chain + select over all three: JAX's values."""
    want, got = jax_and_port["injected"][step]
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {step} {name}")


def _against_single(cfg_fn, n_clips, steps):
    """The streaming tracker over n_clips clips against one single-clip MFT a
    clip, every timestep, every clip: test_torch_mft.py's tolerance (the
    batches differ in size, and CPU convolutions may sum in another order)."""
    frames = _clips(n_clips, steps)
    st = StreamingTracker(cfg_fn(), n_clips=n_clips, device="cpu")
    st.init(frames[0])
    stream = [st.track(frames[k]) for k in range(1, steps + 1)]
    single = MFT(cfg_fn(), device="cpu")
    single.flower = st.flower   # the same weights
    for c in range(n_clips):
        single.init(frames[0, c])
        for k in range(1, steps + 1):
            want = single.track(frames[k, c]).result
            got = stream[k - 1]
            for g, w, name in zip((got.flow[c], got.occlusion[c], got.sigma[c]),
                                  (want.flow, want.occlusion, want.sigma),
                                  ("flow", "occlusion", "sigma")):
                np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                           err_msg=f"clip {c} step {k} {name}")
    return st


SCHEDULE = {np.inf: 2, 1: 1, 2: 1}


def test_schedule_over_8_clips_matches_single(monkeypatch):
    """The per-delta schedule repeated over 8 clips, clip-major (24 pairs,
    (2, 1, 1) * 8): RAFT._flow_scheduled sorts the pairs by count, and the
    permutation of the 24 pairs stays one torch.cat per tensor (the left and
    right features and the context; no warm start, so no initial flow)."""
    from mft_tpu_torch.models.raft import raft as raft_module
    cat, calls = torch.cat, []

    def counting_cat(tensors, *args, **kwargs):
        tensors = list(tensors)
        calls.append(len(tensors))
        return cat(tensors, *args, **kwargs)

    monkeypatch.setattr(raft_module.torch, "cat", counting_cat)
    st = _against_single(lambda: _config(Config, RAFTFlow, schedule=SCHEDULE), 8, 3)
    assert st.iters_schedule == (2, 1, 1)
    # 3 permutations a timestep of 24 single-pair slices, one cat each
    assert calls.count(24) == 3 * 3


def test_warm_start_matches_single():
    """Each clip's template pair starts from that clip's flow of the previous
    frame: the single-clip warm tracker's results, per clip."""
    st = _against_single(lambda: _config(Config, RAFTFlow, warm=True), C, STEPS)
    assert st._warm


SHIFT = np.array([0.5, 0.25], np.float32)


class FakeFlower:
    """A flower with no ``padded_encode``: flow = (stamp difference) * SHIFT,
    occlusion ~0, sigma 1, from the frames' stamped pixel (0, 0)."""

    plain_ops = False

    def __init__(self, config, device="cpu"):
        self.device = device

    def forward_batch(self, images1, images2, **kwargs):
        assert not kwargs
        dt = images2[:, 0, 0, 0].float() - images1[:, 0, 0, 0].float()
        N, Hh, Ww, _ = images1.shape
        flow = (dt[:, None, None, None] * torch.from_numpy(SHIFT)).expand(N, Hh, Ww, 2)
        occl = torch.full((N, Hh, Ww), 1e-4)
        return flow.contiguous(), occl, torch.ones((N, Hh, Ww))


def _stamped(steps, n_clips):
    frames = np.full((steps + 1, n_clips, 32, 40, 3), 100, np.uint8)
    frames[:, :, 0, 0, :] = np.arange(steps + 1)[:, None, None]
    return frames


def test_image_step_matches_single_and_shift():
    """The image step (every pair through forward_batch on the ring's
    images) per clip against the single-clip tracker's unfused step, and the
    interior flow against the stamped shift."""
    cfg = lambda: _config(Config, FakeFlower)
    frames = _stamped(STEPS, 3)
    st = StreamingTracker(cfg(), n_clips=3, device="cpu")
    assert not st._use_features()
    st.init(frames[0])
    stream = [st.track(frames[k]) for k in range(1, STEPS + 1)]
    for c in range(3):
        single_cfg = cfg()
        single_cfg.timers_enabled = True   # the single tracker's image step
        single = MFT(single_cfg, device="cpu")
        single.init(frames[0, c])
        for k in range(1, STEPS + 1):
            want = single.track(frames[k, c]).result
            got = stream[k - 1]
            for g, w in zip((got.flow[c], got.occlusion[c], got.sigma[c]),
                            (want.flow, want.occlusion, want.sigma)):
                torch.testing.assert_close(g, w, atol=0, rtol=0)
    interior = stream[-1].flow[:, 8:-8, 8:-8].numpy()
    np.testing.assert_allclose(interior, np.broadcast_to(SHIFT * STEPS, interior.shape),
                               atol=1e-5)


def _maps(rng, n_clips=3, N=4, Hh=9, Ww=11, spread=8.0):
    mk = lambda *s: rng.random(s).astype(np.float32)
    t = torch.from_numpy
    return [t(mk(n_clips, N, Hh, Ww, 2) * spread - spread / 2), t(mk(n_clips, N, Hh, Ww) * 0.03),
            t(mk(n_clips, N, Hh, Ww) + 0.1), t(mk(n_clips, N, Hh, Ww, 2) * spread - spread / 2),
            t(mk(n_clips, N, Hh, Ww) * 0.03), t(mk(n_clips, N, Hh, Ww) + 0.1)]


def _same_bits(got, want):
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep].view(torch.int32), want[keep].view(torch.int32))


@pytest.mark.parametrize("planted", ["none", "locc", "lsig", "rocc", "rsig", "all four"])
def test_clip_axis_plain_k3_equals_single_calls(rng, planted):
    """The plain chain + select with a clip axis equals one single-clip call
    a clip, bit for bit, NaN positions included (the NaN cases of
    test_torch_chain_select.py: the first NaN score wins, a NaN occlusion
    propagates); the CPU dispatch of the kernel's wrapper and the FlowOU
    API give the same bits and launch nothing."""
    maps = _maps(rng)
    index = {"locc": 1, "lsig": 2, "rocc": 4, "rsig": 5}
    for name in (index if planted == "all four" else [] if planted == "none" else [planted]):
        m = maps[index[name]]
        m[torch.from_numpy(rng.random(tuple(m.shape)) < 0.15)] = float("nan")
    valid = torch.tensor([True, False, True, True])
    want = [ops.chain_select_ref(*(m[c] for m in maps), valid) for c in range(3)]
    if planted != "none":
        assert any(bool(torch.isnan(w).any()) for per in want for w in per)
    ops.reset_launch_counts()
    got_ref = ops.chain_select_ref(*maps, valid)
    got_dispatch = ops.chain_select(*maps, valid)
    left, right = FlowOU(*maps[:3]), FlowOU(*maps[3:])
    got_flowou = chain_select(left, right, valid)
    got_flowou_ref = chain_select_ref(left, right, valid)
    assert ops.launch_counts()["chain_select"] == 0
    for got in (got_ref, got_dispatch,
                (got_flowou.flow, got_flowou.occlusion, got_flowou.sigma),
                (got_flowou_ref.flow, got_flowou_ref.occlusion, got_flowou_ref.sigma)):
        for f in range(3):
            _same_bits(got[f], torch.stack([w[f] for w in want]))


def test_tensor_frames_are_bgr_as_numpy_ones():
    """uint8 BGR frames given as a CPU tensor: the same RGB ring images and
    the same results, bit for bit, as the same frames given as numpy
    (``init`` and one ``track``); both equal JAX's streaming ``_to_device``
    of the frames as a device array, which flips them. The single-clip
    tracker passes a tensor through unflipped, as JAX's does."""
    import jax.numpy as jnp
    frames = _clips(C, 1)
    st = StreamingTracker(_config(Config, RAFTFlow), n_clips=C, device="cpu")
    runs = []
    for to in (np.asarray, torch.from_numpy):
        st.init(to(frames[0]))
        imgs = st.mem_imgs[:, st.template_slot].clone()
        runs.append((imgs, *_np(st.track(to(frames[1])))))
    for got, want in zip(runs[1], runs[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    jax_rgb = np.asarray(JaxStreamingTracker._to_device(np.asarray(jnp.asarray(frames[0]))))
    np.testing.assert_array_equal(runs[0][0].numpy(), jax_rgb)
    np.testing.assert_array_equal(st._to_device(torch.from_numpy(frames[0])).numpy(), jax_rgb)
    assert torch.equal(st._single._to_device(torch.from_numpy(frames[0, 0])),
                       torch.from_numpy(frames[0, 0]))


def test_errors():
    """init: H and W multiples of 8, C frames; track: C frames; injection
    needs the feature ring; the image step refuses a schedule and a warm
    start."""
    st = StreamingTracker(_config(Config, FakeFlower), n_clips=2, device="cpu")
    with pytest.raises(ValueError, match="multiples of 8"):
        st.init(np.zeros((2, 36, 40, 3), np.uint8))
    with pytest.raises(ValueError, match="frames"):
        st.init(np.zeros((3, 32, 40, 3), np.uint8))
    st.init(_stamped(1, 2)[0])
    with pytest.raises(ValueError, match="2 clips"):
        st.track(_stamped(1, 3)[1])
    with pytest.raises(NotImplementedError, match="feature-ring"):
        st.track(_stamped(1, 2)[1], injected={1: tuple(np.zeros((2, 32, 40)))})
    for kw in ({"schedule": {np.inf: 2, 1: 1, 2: 1}}, {"warm": True}):
        st = StreamingTracker(_config(Config, FakeFlower, **kw), n_clips=2, device="cpu")
        st.init(_stamped(1, 2)[0])
        with pytest.raises(NotImplementedError, match="flow_iters_schedule/warm_start_inf"):
            st.track(_stamped(1, 2)[1])
