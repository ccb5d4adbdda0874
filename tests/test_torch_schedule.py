"""Per-pair iteration schedules (``RAFT._flow_scheduled``) against the JAX
package's, and the tracker's schedules (``flow_iters_schedule``).

Mirrors ``tests/test_iter_schedule.py``: the same weights (the committed
``weights/raftou_synth.msgpack`` as flax restores it, carried over by
``params_from_flax``) and the same encoder features (JAX's, moved to NCHW)
go through both ``flow_from_features`` with a schedule, in float32; the
port runs its kernels' plain versions on the CPU. The corr_method aliases
'mxu', 'gather' and 'pallas' run the port's 'auto' path and are held
against JAX's own paths of those names.
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
from mft_tpu.models.raft.raft import RAFT as JaxRAFT, RAFTParams as JaxRAFTParams
from mft_tpu.tracker import MFT as JaxMFT
from mft_tpu_torch.config import Config, fast_config
from mft_tpu_torch.models.raft import RAFTFlow
from mft_tpu_torch.models.raft.convert import params_from_flax
from mft_tpu_torch.models.raft.raft import (AUTO_ALIASES, RAFT, SCHEDULE_METHODS,
                                            RAFTParams)
from mft_tpu_torch.tracker import MFT

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "raftou_synth.msgpack"
# 64x64 images: an 8x8 map at stride 8; 'mixed' folds nothing there, so its
# cases run at 64x256 (an 8x32 map whose level 0 folds 4 rows per 128 lanes)
SIZES = {"mixed": (64, 256)}
H, W = 64, 64


@pytest.fixture(scope="module")
def jax_variables():
    """The committed weights, restored by flax (no flax init needed)."""
    return serialization.msgpack_restore(WEIGHTS.read_bytes())


def _models(jax_variables, method):
    jm = JaxRAFT(cfg=JaxRAFTParams(corr_method=method))
    tm = RAFT(RAFTParams(corr_method=method))
    tm.load_state_dict(params_from_flax(jax_variables))
    return jm, tm.eval()


def _features(jm, variables, B, size=(H, W), seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (2 * B, *size, 3)).astype(np.float32)
    fmap, cnet = jm.apply(variables, jnp.asarray(imgs), method=lambda m, im: m.encode(im))
    return fmap[:B], fmap[B:], cnet[:B]


def _to_torch(*arrays):
    return [torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous()
            for a in arrays]


def _jax_fwd(jm, variables, f1, f2, cn, iters, flow_init=None, raw=False):
    out = jm.apply(variables, f1, f2, cn, method=lambda m, a, b, c: m.flow_from_features(
        a, b, c, iters=iters, flow_init=flow_init, test_mode=True))
    return out if raw else {k: np.asarray(v) for k, v in out.items()}


def _port_fwd(tm, f1, f2, cn, iters, flow_init=None):
    with torch.no_grad():
        out = tm.flow_from_features(f1, f2, cn, iters, flow_init)
    return {k: v.numpy() for k, v in out.items()}


KEYS = ("flow", "occlusion", "uncertainty", "coords")


def _assert_outputs(got, want, method, tol=1e-4):
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        if method == "packed_i8":
            # int8 volume, bf16 samples in both: in relation to the scale, as
            # test_torch_mft.py::test_int8_frame_matches_jax
            scale = float(np.abs(want[k]).mean()) + 1e-6
            err = np.abs(got[k] - want[k])
            assert np.isfinite(got[k]).all(), k
            assert err.mean() < 0.02 * scale, (k, err.mean(), scale)
            assert np.quantile(err, 0.99) < 0.1 * scale, (k, np.quantile(err, 0.99))
        else:
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=1e-5,
                                       err_msg=f"{method} {k}")


SCHEDULE_JAX_METHODS = ("auto", "mixed", "packed", "packed_i8")


@pytest.mark.parametrize("method", SCHEDULE_JAX_METHODS)
def test_scheduled_matches_jax(jax_variables, method):
    """A schedule with a tie, unsorted (2, 1, 2): both sort the pairs
    stably, slice the stored volume to the active prefix and scatter the
    outputs back. float32: 1e-4 absolute, 1e-5 relative ('packed_i8':
    relative to the outputs' scale)."""
    jm, tm = _models(jax_variables, method)
    sched = (2, 1, 2)
    f1, f2, cn = _features(jm, jax_variables, 3, SIZES.get(method, (H, W)))
    want = _jax_fwd(jm, jax_variables, f1, f2, cn, sched)
    got = _port_fwd(tm, *_to_torch(f1, f2, cn), sched)
    _assert_outputs(got, want, method)


@pytest.mark.parametrize("method", AUTO_ALIASES)
def test_alias_uniform_matches_jax(jax_variables, method):
    """corr_method 'mxu', 'gather', 'pallas' run the port's 'auto' path (K1 +
    K2): 2 uniform iterations against JAX's path of that name (its Pallas
    lookup in interpret mode for 'pallas'), float32, 1e-4 / 1e-5; and a
    schedule takes them as JAX's does, equal to the 'auto' schedule."""
    jm, tm = _models(jax_variables, method)
    assert method in SCHEDULE_METHODS
    f1, f2, cn = _features(jm, jax_variables, 2, seed=4)
    want = _jax_fwd(jm, jax_variables, f1, f2, cn, 2)
    got = _port_fwd(tm, *_to_torch(f1, f2, cn), 2)
    _assert_outputs(got, want, method)
    auto = _models(jax_variables, "auto")[1]
    _assert_outputs(_port_fwd(tm, *_to_torch(f1, f2, cn), (2, 1)),
                    _port_fwd(auto, *_to_torch(f1, f2, cn), (2, 1)), method, tol=0.0)


def test_uniform_schedule_matches_int_iters(jax_variables):
    jm, tm = _models(jax_variables, "auto")
    f1, f2, cn = _to_torch(*_features(jm, jax_variables, 2))
    ref = _port_fwd(tm, f1, f2, cn, 3)
    out = _port_fwd(tm, f1, f2, cn, (3, 3))
    _assert_outputs(out, ref, "auto", tol=1e-5)


def test_scheduled_pairs_match_individual_runs(jax_variables):
    """Each pair equals a uniform run of its own count, alone."""
    jm, tm = _models(jax_variables, "auto")
    sched = (3, 1, 2)
    f1, f2, cn = _to_torch(*_features(jm, jax_variables, 3))
    out = _port_fwd(tm, f1, f2, cn, sched)
    for b, it in enumerate(sched):
        ref = _port_fwd(tm, f1[b:b + 1], f2[b:b + 1], cn[b:b + 1], it)
        for k in KEYS:
            np.testing.assert_allclose(out[k][b], ref[k][0], atol=1e-4, rtol=1e-4,
                                       err_msg=f"pair {b} ({it} iters) {k}")


def test_scheduled_flow_init_matches_jax(jax_variables):
    """A low-resolution init for every pair goes through the same sort."""
    jm, tm = _models(jax_variables, "auto")
    f1, f2, cn = _features(jm, jax_variables, 3, seed=2)
    rng = np.random.default_rng(5)
    init = rng.normal(0, 1.5, (3, H // 8, W // 8, 2)).astype(np.float32)
    sched = (1, 3, 2)
    want = _jax_fwd(jm, jax_variables, f1, f2, cn, sched, jnp.asarray(init))
    got = _port_fwd(tm, *_to_torch(f1, f2, cn), sched, torch.from_numpy(init))
    _assert_outputs(got, want, "auto")


@pytest.mark.parametrize("sched", [(3,), (3, 0)], ids=["length", "zero"])
def test_schedule_validation(jax_variables, sched):
    """JAX's ValueErrors, with JAX's messages."""
    jm, tm = _models(jax_variables, "auto")
    f1, f2, cn = _features(jm, jax_variables, 2)
    with pytest.raises(ValueError) as jax_err:
        _jax_fwd(jm, jax_variables, f1, f2, cn, sched)
    with pytest.raises(ValueError) as port_err:
        _port_fwd(tm, *_to_torch(f1, f2, cn), sched)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("method", ["alt", "win", "int8", "pallas_t", "fold"])
def test_unsliceable_methods_raise(jax_variables, method):
    """The methods whose stored volume JAX does not slice by pairs raise its
    NotImplementedError, with its message."""
    jm, tm = _models(jax_variables, method)
    f1, f2, cn = _features(jm, jax_variables, 2)
    with pytest.raises(NotImplementedError) as jax_err:
        _jax_fwd(jm, jax_variables, f1, f2, cn, (2, 1))
    with pytest.raises(NotImplementedError) as port_err:
        _port_fwd(tm, *_to_torch(f1, f2, cn), (2, 1))
    assert str(port_err.value) == str(jax_err.value)


# --------------------------------------------------------------------------- #
# the tracker
# --------------------------------------------------------------------------- #
TH, TW = 60, 64
DELTAS = [np.inf, 1, 2, 4]
SCHEDULE = {np.inf: 3, 1: 1, 2: 2, 4: 3}


def _flow_config(cls, iters=3):
    flow = cls()
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32"}
    flow.model = str(WEIGHTS)
    flow.flow_iters = iters
    return flow


@pytest.fixture(scope="module")
def flowers(jax_variables):
    """A JAX and a port RAFTFlow on the committed weights (the JAX one given
    the restored variables in place of its flax init), shared by the
    trackers below."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wrapper, "load_variables", lambda *args, **kw: jax_variables)
        jf = JaxRAFTFlow(_flow_config(JaxConfig))
    return jf, RAFTFlow(_flow_config(Config), device="cpu")


def _tracker_config(cls, flower, schedule=None):
    conf = cls()
    conf.flow_config = _flow_config(cls)
    conf.flow_config.of_class = lambda config, **kw: flower
    conf.deltas = DELTAS
    conf.occlusion_threshold = 0.02
    if schedule is not None:
        conf.flow_iters_schedule = schedule
    return conf


@pytest.mark.parametrize("schedule,want", [
    ({float("inf"): 3, 1: 1}, (3, 1, 3, 3)),
    ([3, 1, 2, 1], (3, 1, 2, 1)),
    ({"inf": 4}, (4, 3, 3, 3)),
    (None, None),
], ids=["mapping", "sequence", "inf-key", "none"])
def test_tracker_schedule_resolution(schedule, want):
    """The mapping, sequence and 'inf'-keyed forms, a missing delta falling
    back to flow_iters, as the JAX tracker resolves them."""
    tt = MFT(_tracker_config(Config, None, schedule), device="cpu")
    jt = JaxMFT(_tracker_config(JaxConfig, None, schedule))
    assert tt.iters_schedule == tt._iters_schedule() == jt._iters_schedule() == want


def test_tracker_schedule_length_raises():
    with pytest.raises(ValueError, match="flow_iters_schedule len 2 != 4 deltas"):
        MFT(_tracker_config(Config, None, [3, 1]), device="cpu")


def test_fast_config_schedule():
    """fast_config()'s schedule in the tracker's delta order."""
    cfg = fast_config()
    cfg.flow_config.of_class = lambda config, **kw: None
    assert MFT(cfg, device="cpu").iters_schedule == (12, 4, 5, 6, 8, 10, 12)


def _clip(n, seed=0):
    """A smooth random texture (noise on 8- and 2-px cells, bilinear) shifted
    2 px right and 1 px down per frame: the trained weights track it
    (white noise would send their flows to tens of px)."""
    rng = np.random.default_rng(seed)
    th, tw = TH + n + 2, TW + 2 * n + 2
    tex = 0
    for cell, amp in ((8, 180.0), (2, 60.0)):
        g = torch.from_numpy(rng.random((1, 3, th // cell + 2, tw // cell + 2)))
        up = torch.nn.functional.interpolate(g, size=(th, tw), mode="bilinear",
                                             align_corners=False)
        tex = tex + amp * up[0].permute(1, 2, 0).numpy()
    tex = tex.clip(0, 255).astype(np.uint8)
    return [np.ascontiguousarray(tex[k:k + TH, 2 * k:2 * k + TW]) for k in range(n + 1)]


FRAMES = 5


@pytest.fixture(scope="module")
def scheduled_trackers(flowers):
    """Both trackers with SCHEDULE; each init starts them afresh, so both
    directions share them (and JAX's compiled frame step)."""
    return (JaxMFT(_tracker_config(JaxConfig, flowers[0], SCHEDULE)),
            MFT(_tracker_config(Config, flowers[1], SCHEDULE), device="cpu"))


@pytest.fixture(scope="module", params=[1, -1], ids=["forward", "backward"])
def scheduled_runs(request, scheduled_trackers):
    """Both trackers with SCHEDULE over 5 frames, time_direction +1 or -1
    (backward: init on the clip's last frame as frame 5)."""
    td = request.param
    frames = _clip(FRAMES)
    if td < 0:
        frames = frames[::-1]
    jt, tt = scheduled_trackers
    start = 0 if td > 0 else FRAMES
    jt.init(frames[0], start_frame_i=start, time_direction=td)
    tt.init(frames[0], start_frame_i=start, time_direction=td)
    out = []
    for img in frames[1:]:
        a, b = jt.track(img).result, tt.track(img).result
        out.append(([np.asarray(x) for x in (a.flow, a.occlusion, a.sigma)],
                    [x.numpy() for x in (b.flow, b.occlusion, b.sigma)]))
    return out


@pytest.mark.parametrize("frame", range(1, FRAMES + 1))
def test_scheduled_tracker_matches_jax(scheduled_runs, frame):
    """float32: 1e-4 on flow (px), occlusion and sigma at every pixel."""
    want, got = scheduled_runs[frame - 1]
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5,
                                   err_msg=f"frame {frame} {name}")


@pytest.mark.parametrize("name,sched", [("fast", (12, 4, 5, 6, 8, 10, 12)),
                                        ("warm", (5, 4, 5, 6, 8, 10, 12))])
def test_fused_iterations_match_jax_loop(jax_variables, monkeypatch, name, sched):
    """The lookups of one scheduled forward of 7 pairs, counted in both
    loops (JAX with fuse_lookup 'on', as on the TPU, traced abstractly by
    jax.eval_shape: its loop runs, nothing is computed): fused with convc1
    on every iteration after which no pair ends, the plain lookup on the
    others: 6 and 6 for the fast and warm schedules (chip_smoke.py's
    CONFIG_LAUNCHES)."""
    import jax
    import mft_tpu.models.raft.raft as jraft
    import mft_tpu_torch.models.raft.raft as traft
    counts = {}

    def counting(module, fn_name, key):
        fn = getattr(module, fn_name)

        def wrapped(*args, **kwargs):
            counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, fn_name, wrapped)

    for module, pkg in ((jraft, "jax"), (traft, "port")):
        counting(module, "corr_lookup_fused_conv", (pkg, "fused"))
        counting(module, "corr_lookup", (pkg, "lookup"))
    jm = JaxRAFT(cfg=JaxRAFTParams(fuse_lookup="on"))
    feats = jax.ShapeDtypeStruct((7, H // 8, W // 8, 256), jnp.float32)
    jax.eval_shape(lambda v, a, b, c: _jax_fwd(jm, v, a, b, c, sched, raw=True),
                   jax_variables, feats, feats, feats)
    _, tm = _models(jax_variables, "auto")
    f = torch.randn((7, 256, H // 8, W // 8), generator=torch.Generator().manual_seed(0))
    _port_fwd(tm, f, f.flip(0), f, sched)
    assert counts == {("jax", "fused"): 6, ("jax", "lookup"): 6,
                      ("port", "fused"): 6, ("port", "lookup"): 6}
