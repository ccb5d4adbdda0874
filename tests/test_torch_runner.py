"""The port's TAP-Vid runner, evaluator and report against the JAX package's.

One synthetic DAVIS-form sequence (T = 6 frames of a 64x64 random texture
shifted 1 px right and down a frame, 'fullres'), deltas {inf, 1, 2}, mode
'both': both runners track it with the same RAFT-OU weights (the JAX random
init, written as a flax msgpack file that both packages load), 2 GRU
iterations, float32, the port on the CPU (its plain versions). The JAX
runner's passes go one frame a ``track_chunk`` call (the same results as its
chunks of 8, each of which JAX compiles as one unrolled program).
"""

import functools
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from mft_tpu.eval import evaluate as jax_evaluate
from mft_tpu.eval import report as jax_report
from mft_tpu.eval import runner as jax_runner
from mft_tpu_torch.eval import evaluate, report, runner

T, H, W, N_TRACKS = 6, 64, 64, 8
DEFAULT_TOL = 1e-4          # tests/test_torch_mft.py: px at the tracker's raster

TRACKER_CFG = """
import numpy as np
from {pkg}.config import Config
from {pkg}.models.raft import RAFTFlow
from {pkg}.tracker import MFT


def get_config():
    flow = Config()
    flow.of_class = RAFTFlow
    flow.raft_params = {{"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32"}}
    flow.model = r"{weights}"
    flow.flow_iters = 2
    flow.name = "runner_test_flow"
    conf = Config()
    conf.tracker_class = MFT
    conf.flow_config = flow
    conf.deltas = [np.inf, 1, 2]
    conf.occlusion_threshold = 0.02
    conf.name = "runner_test"
    return conf
"""

DATASET_CFG = """
from {pkg}.config import Config


def get_config():
    conf = Config()
    conf.pickles = [r"{pickle}"]
    conf.scaling = "fullres"
    conf.name = "synth"
    return conf
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _synthetic_pickle(path):
    rng = np.random.default_rng(0)
    tex = (rng.random((H + T, W + T, 3)) * 255).astype(np.uint8)
    video = np.stack([tex[T - t:T - t + H, T - t:T - t + W] for t in range(T)])
    base = rng.integers(8, 40, (N_TRACKS, 1, 2)).astype(np.float64)
    points = (base + np.arange(T).reshape(1, T, 1)) / np.array([W, H])
    occluded = np.zeros((N_TRACKS, T), bool)
    occluded[0, 3:] = True   # one track leaves view: strided queries differ by frame
    with open(path, "wb") as f:
        pickle.dump({"seq0": {"video": video, "points": points, "occluded": occluded}}, f)


class _RecordingCache(jax_runner.FlowCache):
    """The JAX runner's FlowCache, its counters and device-tier entries kept
    when the runner clears it at the end of the sequence."""
    states = []

    def clear(self, remove_disk=False):
        _RecordingCache.states.append(dict(hits=self.hits, misses=self.misses,
                                           device_entries=len(self.device_cache),
                                           ram_entries=len(self.ram_cache)))
        super().clear(remove_disk)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runners and evaluators on the synthetic sequence. returns: the
    port's run report, the JAX cache's state, and the work directory."""
    from flax import serialization
    from mft_tpu.config import Config as JaxConfig
    from mft_tpu.models.raft import RAFTFlow as JaxRAFTFlow
    tmp = tmp_path_factory.mktemp("runner")
    _synthetic_pickle(tmp / "synth.pkl")
    flow = JaxConfig()
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "compute_dtype": "float32"}
    flow.model = None
    flow.flow_iters = 2
    (tmp / "weights.msgpack").write_bytes(
        serialization.to_bytes(JaxRAFTFlow(flow).variables))
    for pkg, tag in (("mft_tpu", "jax"), ("mft_tpu_torch", "port")):
        (tmp / f"tracker_{tag}.py").write_text(
            TRACKER_CFG.format(pkg=pkg, weights=tmp / "weights.msgpack"))
        (tmp / f"dataset_{tag}.py").write_text(
            DATASET_CFG.format(pkg=pkg, pickle=tmp / "synth.pkl"))

    def args(mod, tag, *extra):
        return mod.get_parser().parse_args([
            "--trackers", str(tmp / f"tracker_{tag}.py"),
            "--dataset", str(tmp / f"dataset_{tag}.py"),
            "--export", str(tmp / f"export_{tag}"), *extra])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runner, "FlowCache", _RecordingCache)
        mp.setattr(jax_runner, "track_sequence",
                   functools.partial(jax_runner.track_sequence, chunk=1))
        _RecordingCache.states.clear()
        assert jax_runner.run(args(jax_runner, "jax", "--cache", str(tmp / "cache_jax"))) == 0
    port = runner.run(args(runner, "port", "--cache", str(tmp / "cache_port"),
                           "--device", "cpu", "--write_flow"))
    jax_evaluate.run(args(jax_evaluate, "jax"))
    evaluate.run(args(evaluate, "port"))
    return port, _RecordingCache.states[0], tmp


@pytest.mark.parametrize("mode", ["first", "strided"])
def test_predictions_match_jax(runs, mode):
    """The prediction pickles: (1, N, T, 2) tracks and (1, N, T) occlusion at
    the 256x256 raster, within the tracker tests' 1e-4 px (scaled by
    256 / 64) and 1e-4."""
    _, _, tmp = runs
    got, want = [pickle.load(open(tmp / f"export_{tag}/runner_test/results/seq0-{mode}.pklz",
                                  "rb")) for tag in ("port", "jax")]
    assert set(got) == {"tracks", "occluded"}
    assert got["tracks"].shape == want["tracks"].shape and got["tracks"].shape[-2:] == (T, 2)
    np.testing.assert_allclose(got["tracks"], want["tracks"], atol=DEFAULT_TOL * 256 / W)
    np.testing.assert_allclose(got["occluded"], want["occluded"], atol=DEFAULT_TOL)


def test_cache_counts_match_jax(runs):
    """One cache a sequence over both modes' passes: the same hits, misses
    and device-tier entries (CPU tensors in the port, jax arrays in JAX);
    the passes' own counts sum to the cache's."""
    port, jax_state, _ = runs
    state = port["caches"]["seq0"]
    assert {k: state[k] for k in jax_state} == jax_state
    assert state["hits"] > 0 and state["devices"] == ["cpu"] and state["ram_entries"] == 0
    assert sum(p["hits"] for p in port["passes"]) == state["hits"]
    assert sum(p["misses"] for p in port["passes"]) == state["misses"]
    assert [(p["mode"], p["start_frame"], p["direction"], p["frames"])
            for p in port["passes"]] == [("first", 0, "forward", 5),
                                         ("strided", 0, "forward", 5),
                                         ("strided", 0, "backward", 0),
                                         ("strided", 5, "forward", 0),
                                         ("strided", 5, "backward", 5)]


@pytest.mark.parametrize("mode", ["first", "strided"])
def test_evaluate_matches_jax(runs, mode):
    """Each metric x100 within 0.5 of JAX's; JAX's evaluator reads the
    port's prediction files to the port's own metrics."""
    _, _, tmp = runs
    suffix = "-strided" if mode == "strided" else ""
    with open(tmp / f"export_port/runner_test/eval/tapvid-eval{suffix}.pklz", "rb") as f:
        ours = pickle.load(f)
    theirs = pd.read_pickle(tmp / f"export_jax/runner_test/eval/tapvid-eval{suffix}.pklz")
    assert [r["seq"] for r in ours["rows"]] == list(theirs["seq"]) == ["seq0"]
    for k, v in ours["means"].items():
        assert abs(100 * v - 100 * theirs[k].mean()) <= 0.5, k
    dataset = jax_runner.load_config(tmp / "dataset_jax.py")
    read_by_jax = jax_evaluate.evaluate_tracker(tmp / "export_port/runner_test/results",
                                                dataset, mode)
    for k, v in ours["rows"][0].items():
        assert read_by_jax[k].iloc[0] == v, k


def test_report_matches_jax(runs, capsys):
    """The port's report of its evaluation prints JAX's report of the same
    numbers (written as JAX's pandas pickles), LaTeX rows included."""
    _, _, tmp = runs
    port_export = tmp / "export_port"
    mirror = tmp / "export_mirror"
    for suffix in ("", "-strided"):
        with open(port_export / f"runner_test/eval/tapvid-eval{suffix}.pklz", "rb") as f:
            rows = pickle.load(f)["rows"]
        path = mirror / f"runner_test/eval/tapvid-eval{suffix}.pklz"
        path.parent.mkdir(parents=True, exist_ok=True)
        pd.DataFrame.from_dict(dict(enumerate(rows)), orient="index").to_pickle(path)
    ours = report.report(["runner_test"], port_export, latex=True)
    theirs = jax_report.report(["runner_test"], mirror, latex=True)
    assert ours == theirs
    assert "runner_test (ours)" in ours and "CoTracker" in ours


def test_write_flow_exports_decode(runs):
    """--write_flow: the 'first' pass's template -> frame results as
    .flowouX16.pkl files (FlowOU.write), one a frame, which the JAX codec
    reads; frame 0's is the identity."""
    from mft_tpu.io import read_flowou as jax_read
    _, _, tmp = runs
    files = sorted((tmp / "export_port/runner_test/flowous/seq0").iterdir())
    assert [f.name for f in files] == [f"0--{k}.flowouX16.pkl" for k in range(T)]
    for k, f in enumerate(files):
        flow, occl, sigma = jax_read(f)
        assert flow.shape == (H, W, 2) and np.isfinite(flow).all() and np.isfinite(sigma).all()
        if k == 0:
            assert not flow.any() and not occl.any()


def test_runner_refuses_what_jax_refuses(tmp_path):
    """warm_start_inf with cache_delta_infinity, and configs of one run with
    different flow setups, raise before any tracking."""
    bad = tmp_path / "bad.py"
    bad.write_text("from mft_tpu_torch.config import warm_config\n"
                   "def get_config():\n"
                   "    c = warm_config()\n    c.cache_delta_infinity = True\n    return c\n")
    parser = runner.get_parser()
    with pytest.raises(ValueError, match="cannot be combined"):
        runner.run(parser.parse_args(["--trackers", str(bad), "--device", "cpu"]))
    with pytest.raises(ValueError, match="same flow setup"):
        runner.run(parser.parse_args(["--trackers", "synth", "fast", "--device", "cpu"]))
    args = parser.parse_args([])
    assert (args.trackers, args.dataset, args.device) == (["default"], "tapvid_davis", "cuda")
