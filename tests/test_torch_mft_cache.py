"""The port's MFT tracker under a FlowCache, and its track_chunk.

The cached, injected and RAFT-free frames are held against the JAX
package's tracker on the same clip, weights and settings as
tests/test_torch_mft.py (64x64, 2 GRU iterations, float32, the JAX random
init carried over by ``params_from_flax``); track_chunk against the port's
own per-frame track.
"""

import numpy as np
import pytest
import jax
import torch

from mft_tpu.config import Config as JaxConfig
from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
from mft_tpu.tracker import MFT as JaxMFT
from mft_tpu_torch.config import Config
from mft_tpu_torch.models.raft import RAFTFlow
from mft_tpu_torch.models.raft.convert import params_from_flax
from mft_tpu_torch.tracker import MFT
from tests.test_torch_mft import _clip, _config


CACHE_DELTAS = [np.inf, 1, 2]
CACHE_FRAMES = 2
# the pair batches each pass runs through RAFT (features_forward), a frame a
# batch: the whole batch of 3, the template pair alone, none
CACHE_BATCHES = {"cold": [3, 3], "warm": [1, 1], "no_raft": []}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cache_runs():
    """Both trackers (deltas {inf, 1, 2}), each with its own FlowCache, over
    three passes of one clip from frame 0 on one tracker: 'cold' (every
    frame the whole batch, the cacheable pairs written back), 'warm' (every
    finite pair hits: the template pair alone runs through RAFT, the hits
    injected) and, with cache_delta_infinity, 'no_raft' (the template pair
    (0, t) hits the entry its finite pair (0, t) wrote: no RAFT at all).
    returns: {pass: {'results': [(jax, port) arrays a frame], 'counts': the
    two caches' (hits, misses, device-tier keys, RAM-tier keys) after the
    pass, 'batches': the port's RAFT batch sizes}}."""
    from mft_tpu.io.cache import FlowCache as JaxFlowCache
    from mft_tpu_torch.io import FlowCache
    frames = _clip(CACHE_FRAMES)
    jconf, tconf = _config(JaxConfig, JaxRAFTFlow), _config(Config, RAFTFlow)
    jconf.deltas = tconf.deltas = CACHE_DELTAS
    jt, tt = JaxMFT(jconf), MFT(tconf, device="cpu")
    tt.flower.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jt.flower.variables)))
    batches, forward = [], tt.flower.features_forward

    def counting(fmap1, *args, **kw):
        batches.append(fmap1.shape[0])
        return forward(fmap1, *args, **kw)

    tt.flower.features_forward = counting
    jc, tc = JaxFlowCache(None), FlowCache(None)
    out = {}
    for name in CACHE_BATCHES:
        jconf.cache_delta_infinity = tconf.cache_delta_infinity = name == "no_raft"
        jt.init(frames[0], flow_cache=jc)
        tt.init(frames[0], flow_cache=tc)
        batches.clear()
        results = []
        for img in frames[1:]:
            a, b = jt.track(img).result, tt.track(img).result
            results.append(([np.asarray(x) for x in (a.flow, a.occlusion, a.sigma)],
                            [x.numpy() for x in (b.flow, b.occlusion, b.sigma)]))
        out[name] = dict(results=results, batches=list(batches),
                         counts=[(c.hits, c.misses, sorted(c.device_cache),
                                  sorted(c.ram_cache)) for c in (jc, tc)])
    return out


@pytest.mark.parametrize("name", list(CACHE_BATCHES))
def test_cached_frames_match_jax(cache_runs, name):
    """Under a FlowCache: the cold pass's full batches, the warm pass's
    injected frames and cache_delta_infinity's RAFT-free frames against the
    JAX tracker's same frames (float32, 1e-4 on flow (px), occlusion and
    sigma at every pixel); equal hits, misses and entries (both trackers'
    device tiers: jax arrays on the CPU, torch tensors), the port's RAFT
    batches as the pass predicts."""
    run = cache_runs[name]
    for k, (want, got) in enumerate(run["results"]):
        for g, w, field in zip(got, want, ("flow", "occlusion", "sigma")):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5,
                                       err_msg=f"{name} frame {k + 1} {field}")
    jax_counts, port_counts = run["counts"]
    assert port_counts == jax_counts
    assert run["batches"] == CACHE_BATCHES[name]
    hits = {"cold": 0, "warm": 3, "no_raft": 8}[name]    # cumulative
    assert port_counts[:2] == (hits, 3) and port_counts[3] == []


def test_track_chunk_matches_per_frame():
    """track_chunk equals one track() call a frame bit for bit (chunks of 3,
    then 5 as a stacked RGB tensor, as tests/test_tracker.py chunks JAX's),
    and on a cold FlowCache it writes the same rows per-frame tracking
    writes, reading none."""
    from mft_tpu_torch.io import FlowCache
    frames = _clip(8)
    conf = _config(Config, RAFTFlow)
    conf.deltas = [np.inf, 1, 2, 4]
    ta, tb = MFT(conf, device="cpu"), MFT(conf, device="cpu")
    tb.flower.load_state_dict(ta.flower.model.state_dict())
    ca, cb = FlowCache(None), FlowCache(None)
    ta.init(frames[0], flow_cache=ca)
    seq = [ta.track(img) for img in frames[1:]]
    tb.init(frames[0], flow_cache=cb)
    stacked = torch.from_numpy(np.stack([f[:, :, ::-1] for f in frames[4:]]).copy())
    metas = tb.track_chunk(frames[1:4]) + tb.track_chunk(stacked)
    assert len(metas) == 8 and tb.current_frame_i == ta.current_frame_i == 8
    for k, (a, b) in enumerate(zip(seq, metas)):
        for field in ("flow", "occlusion", "sigma"):
            assert torch.equal(getattr(a.result, field), getattr(b.result, field)), \
                (k + 1, field)
    assert sorted(ca.device_cache) == sorted(cb.device_cache) and len(cb.device_cache) == 20
    for key, rows in ca.device_cache.items():
        assert all(torch.equal(x, y) for x, y in zip(rows, cb.device_cache[key])), key
    assert (cb.hits, cb.misses) == (0, 0) and (ca.hits, ca.misses) == (0, 20)
