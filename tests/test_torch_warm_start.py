"""Template-pair warm starting (``warm_start_inf``) and the phase-timer frame
step (``timers_enabled``) against the JAX package's.

Mirrors ``tests/test_warm_start_inf.py``: the same weights (the committed
``weights/raftou_synth.msgpack``) and images go through both packages in
float32; the port runs its kernels' plain versions on the CPU.
- ``features_forward(init_slot=)`` equals an explicit full-batch init that
  is zero but for that pair, with and without a schedule, and JAX's;
- a warm tracker's first frame equals a cold one's (the previous-frame
  slot is still zero);
- warm trackers with a schedule track as JAX's, forward and backward;
- the unfused timer step equals the fused step.
"""

from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from flax import serialization

import mft_tpu.models.raft.wrapper as jax_wrapper
from mft_tpu.config import Config as JaxConfig
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu.tracker import MFT as JaxMFT
from mft_tpu_torch.config import Config, warm_config
from mft_tpu_torch.models.raft import RAFTFlow
from mft_tpu_torch.tracker import MFT

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "raftou_synth.msgpack"
H, W = 64, 60          # padded to 64x64: an 8x8 map at stride 8
DELTAS = [np.inf, 1, 2, 4]
SCHEDULE = {np.inf: 2, 1: 1, 2: 2, 4: 3}
ITERS = 3


def _flow_config(cls):
    flow = cls()
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32"}
    flow.model = str(WEIGHTS)
    flow.flow_iters = ITERS
    return flow


@pytest.fixture(scope="module")
def flowers():
    """A JAX and a port RAFTFlow on the committed weights (the JAX one given
    the variables flax restores from the file in place of its flax init),
    shared by the trackers below."""
    variables = serialization.msgpack_restore(WEIGHTS.read_bytes())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wrapper, "load_variables", lambda *args, **kw: variables)
        jf = JaxRAFTFlow(_flow_config(JaxConfig))
    return jf, RAFTFlow(_flow_config(Config), device="cpu")


def _feats(flowers, B, seed=3):
    """Both packages' features of the same 2B images: (jax triple, port triple)."""
    jf, tf = flowers
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (2 * B, H, W, 3)).astype(np.float32)
    fmap, cnet = jf.padded_encode(H, W)(jf.variables, jnp.asarray(imgs))
    tfm, tcn = tf.padded_encode(torch.from_numpy(imgs))
    return (fmap[:B], fmap[B:], cnet[:B]), (tfm[:B], tfm[B:], tcn[:B])


def _init(seed=7):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 3, (H, W, 2)).astype(np.float32)


@pytest.mark.parametrize("sched", [None, (1, 3)], ids=["uniform", "schedule"])
def test_init_slot_matches_explicit_init_and_jax(flowers, sched):
    """init_slot=1: the one map padded and downsampled once, scattered into
    a zero batch; equal to the full-batch init with zeros elsewhere (and the
    other pair to a cold run), and to JAX's features_forward(init_slot=1)
    (the schedule (1, 3) reorders the pairs, the init with them). float32:
    1e-4 absolute, 1e-5 relative."""
    jf, tf = flowers
    (jf1, jf2, jcn), (f1, f2, cn) = _feats(flowers, 2)
    init = _init()
    kw = {} if sched is None else {"iters_schedule": sched}
    got = tf.features_forward(f1, f2, cn, H, W, torch.from_numpy(init), init_slot=1, **kw)
    batch = np.zeros((2, H, W, 2), np.float32)
    batch[1] = init
    full = tf.features_forward(f1, f2, cn, H, W, torch.from_numpy(batch), **kw)
    cold = tf.features_forward(f1, f2, cn, H, W, **kw)
    want = jf.features_forward(H, W, iters_schedule=sched, init_slot=1)(
        jf.variables, jf1, jf2, jcn, jnp.asarray(init))
    for g, fb, c, w, name in zip(got, full, cold, want, ("flow", "occlusion", "sigma")):
        g = g.numpy()
        np.testing.assert_allclose(g, fb.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(g[0], c.numpy()[0], atol=1e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-5, err_msg=name)
    assert not np.allclose(got[0][1].numpy(), cold[0][1].numpy())


def _tracker_config(cls, flower, warm=True, timers=False):
    conf = cls()
    conf.flow_config = _flow_config(cls)
    conf.flow_config.of_class = lambda config, **kw: flower
    conf.deltas = DELTAS
    conf.occlusion_threshold = 0.02
    conf.warm_start_inf = warm
    conf.timers_enabled = timers
    conf.flow_iters_schedule = SCHEDULE
    return conf


def _clip(n, seed=0):
    """A smooth random texture (noise on 8- and 2-px cells, bilinear) shifted
    2 px right and 1 px down per frame, which the trained weights track."""
    rng = np.random.default_rng(seed)
    th, tw = H + n + 2, W + 2 * n + 2
    tex = 0
    for cell, amp in ((8, 180.0), (2, 60.0)):
        g = torch.from_numpy(rng.random((1, 3, th // cell + 2, tw // cell + 2)))
        up = torch.nn.functional.interpolate(g, size=(th, tw), mode="bilinear",
                                             align_corners=False)
        tex = tex + amp * up[0].permute(1, 2, 0).numpy()
    tex = tex.clip(0, 255).astype(np.uint8)
    return [np.ascontiguousarray(tex[k:k + H, 2 * k:2 * k + W]) for k in range(n + 1)]


def _port_tracker(flowers, **kw):
    return MFT(_tracker_config(Config, flowers[1], **kw), device="cpu")


def _track(tracker, frames, td):
    start = 0 if td > 0 else len(frames) - 1
    tracker.init(frames[0], start_frame_i=start, time_direction=td)
    return [tracker.track(img) for img in frames[1:]]


def _outputs(result):
    return [np.asarray(x) for x in (result.flow, result.occlusion, result.sigma)]


def test_first_frame_matches_cold_tracker(flowers):
    """The previous-frame slot is zero on the first tracked frame: the
    identity flow, which is the cold init."""
    frames = _clip(1, seed=1)
    warm = _track(_port_tracker(flowers, warm=True), frames, 1)[0].result
    cold = _track(_port_tracker(flowers, warm=False), frames, 1)[0].result
    for a, b in zip(_outputs(warm), _outputs(cold)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


FRAMES = 4


@pytest.fixture(scope="module")
def warm_trackers(flowers):
    """The JAX and the port's warm scheduled trackers and the port's timer-step
    one; each init starts them afresh, so both directions share them (and
    JAX's compiled frame step)."""
    return (JaxMFT(_tracker_config(JaxConfig, flowers[0])), _port_tracker(flowers),
            _port_tracker(flowers, timers=True))


@pytest.fixture(scope="module", params=[1, -1], ids=["forward", "backward"])
def warm_runs(request, warm_trackers):
    """Warm trackers with SCHEDULE over 4 frames in both packages, and the
    port's timer-step tracker on the same clip; time_direction +1 or -1
    (backward: init on the clip's last frame as frame 4)."""
    td = request.param
    frames = _clip(FRAMES, seed=4)
    if td < 0:
        frames = frames[::-1]
    jt, tt, timer = warm_trackers
    want = [_outputs(m.result) for m in _track(jt, frames, td)]
    got = [_outputs(m.result) for m in _track(tt, frames, td)]
    return want, got, _track(timer, frames, td)


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
def test_warm_tracker_matches_jax(warm_runs, frame):
    """float32: 1e-4 on flow (px), occlusion and sigma at every pixel."""
    want, got, _ = warm_runs
    for g, w, name in zip(got[frame - 1], want[frame - 1], ("flow", "occlusion", "sigma")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5,
                                   err_msg=f"frame {frame} {name}")


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
def test_timer_step_matches_fused_step(warm_runs, frame):
    """The unfused step (both images of each pair encoded again, the warm
    init as a full batch) equals the fused one: 1e-4 (JAX's
    test_fused_and_unfused_warm_paths_agree); its two phases timed."""
    _, got, timed = warm_runs
    meta = timed[frame - 1]
    for g, w, name in zip(_outputs(meta.result), got[frame - 1],
                          ("flow", "occlusion", "sigma")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"frame {frame} {name}")
    assert set(meta.phase_ms) == {"flow+chain", "selection"}
    assert all(ms > 0 for ms in meta.phase_ms.values())


def test_warm_config_builds():
    """warm_config(): the schedule and the warm start, no raise."""
    cfg = warm_config()
    cfg.flow_config.of_class = lambda config, **kw: None
    tt = MFT(cfg, device="cpu")
    assert tt._warm_start() and tt._inf_idx == 0
    assert tt.iters_schedule == (5, 4, 5, 6, 8, 10, 12)
