"""The port's submission writers, RGB-Stacking and JHMDB readers and small
utilities against the JAX package's.

The writers get one deterministic stub flower each (the same class for both
packages) that records the ``init_flow`` it is given; the readers a
synthetic pickle and a synthetic JHMDB tree (``scipy.io.savemat``, PNGs),
at the protocol's 256x256 and at another size.
"""

import logging
import pdb
import pickle
import sys

import cv2
import numpy as np
import pytest
import scipy.io
import torch

from mft_tpu.eval import submissions as jax_submissions
from mft_tpu.eval import tapvid as jax_tapvid
from mft_tpu.utils import rand_utils as jax_rand_utils
from mft_tpu_torch.apps import demo
from mft_tpu_torch.eval import evaluate, runner, submissions, tapvid
from mft_tpu_torch.train import loop
from mft_tpu_torch.utils import notifications, rand_utils, various


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StubFlower:
    """A deterministic flow of the two images and of ``init_flow``."""

    def __init__(self):
        self.inits = []

    def compute_flow(self, img1, img2, mode="flow", init_flow=None, numpy_out=False):
        assert mode == "flow" and numpy_out
        self.inits.append(None if init_flow is None else np.array(init_flow))
        d = (img1.astype(np.float32) - img2.astype(np.float32)) / 37.0
        flow = np.stack([d[..., 0] - d[..., 2], d[..., 1] * 0.5], -1)
        if init_flow is not None:
            flow = flow + 0.25 * np.asarray(init_flow)
        return flow.astype(np.float32), {}


def _sintel_tree(root, scenes=2, frames=3, H=20, W=36):
    rng = np.random.default_rng(0)
    for s in range(scenes):
        d = root / "test" / "final" / f"scene_{s}"
        d.mkdir(parents=True)
        for k in range(frames):
            assert cv2.imwrite(str(d / f"frame_{k + 1:04d}.png"),
                               (rng.random((H, W, 3)) * 255).astype(np.uint8))


def _kitti_tree(root, pairs=2, H=15, W=42):
    rng = np.random.default_rng(1)
    d = root / "testing" / "image_2"
    d.mkdir(parents=True)
    for i in range(pairs):
        for t in (10, 11):
            assert cv2.imwrite(str(d / f"{i:06d}_{t}.png"),
                               (rng.random((H, W, 3)) * 255).astype(np.uint8))


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("warm_start", [True, False])
def test_sintel_submission_matches_jax(tmp_path, warm_start):
    """The .flo files byte for byte, the same init_flow sequence."""
    _sintel_tree(tmp_path / "sintel")
    fj, fp = StubFlower(), StubFlower()
    nj = jax_submissions.create_sintel_submission(fj, tmp_path / "sintel", tmp_path / "jax",
                                                  warm_start=warm_start)
    npt = submissions.create_sintel_submission(fp, tmp_path / "sintel", tmp_path / "port",
                                               warm_start=warm_start)
    assert nj == npt == 4
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and len(names) == 4
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes(), n
    assert len(fj.inits) == len(fp.inits) == 4
    assert [i is None for i in fp.inits] == ([True, False] * 2 if warm_start else [True] * 4)
    for a, b in zip(fj.inits, fp.inits):
        assert (a is None and b is None) or np.array_equal(a, b)


def test_kitti_submission_matches_jax(tmp_path):
    """The same files, decoding to the same 16-bit arrays (OpenCV's PNG
    encoder and the port's compress the same samples differently)."""
    _kitti_tree(tmp_path / "kitti")
    fj, fp = StubFlower(), StubFlower()
    assert jax_submissions.create_kitti_submission(fj, tmp_path / "kitti", tmp_path / "jax") == 2
    assert submissions.create_kitti_submission(fp, tmp_path / "kitti", tmp_path / "port") == 2
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and len(names) == 2
    for n in names:
        a = cv2.imread(str(tmp_path / "jax" / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "port" / n), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b), n
    assert fj.inits == fp.inits == [None, None]


def _assert_records_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_records_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _rgb_stacking_pickle(path):
    rng = np.random.default_rng(2)
    examples = []
    for shape in ((256, 256), (200, 300)):
        T, N = 7, 5
        examples.append({
            "video": (rng.random((T, *shape, 3)) * 255).astype(np.uint8),
            "points": rng.random((N, T, 2)),
            "occluded": rng.random((N, T)) > 0.7,
        })
    with open(path, "wb") as f:
        pickle.dump(examples, f)


@pytest.mark.parametrize("query_mode", ["strided", "first"])
@pytest.mark.parametrize("size", [(256, 256), (128, 160)])
def test_rgb_stacking_reader_matches_jax(tmp_path, query_mode, size):
    _rgb_stacking_pickle(tmp_path / "rgb.pkl")
    got = list(tapvid.create_rgb_stacking_dataset(tmp_path / "rgb.pkl", query_mode, size))
    want = list(jax_tapvid.create_rgb_stacking_dataset(tmp_path / "rgb.pkl", query_mode, size))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_records_equal(g, w)


def _jhmdb_tree(root, H=240, W=320):
    """Two test videos and one training video of a JHMDB-form tree, one
    first-frame joint outside the image."""
    rng = np.random.default_rng(3)
    (root / "splits").mkdir(parents=True)
    (root / "splits" / "wave_test_split1.txt").write_text("v1.avi 2\nv2.avi 1\nv3.avi 2\n\n")
    for video, T in (("v1", 4), ("v3", 3)):
        jdir = root / "joint_positions" / "wave" / video
        jdir.mkdir(parents=True)
        pos = np.stack([rng.uniform(-10, W + 10, (15, T)), rng.uniform(0, H - 1, (15, T))])
        pos[0, 0, 0] = -5.0
        pos[1, 1, 0] = W + 3.0
        scipy.io.savemat(str(jdir / "joint_positions.mat"), {"pos_img": pos})
        idir = root / "Rename_Images" / "wave" / video
        idir.mkdir(parents=True)
        for k in range(T + (1 if video == "v1" else 0)):   # v1: pose shorter than video
            assert cv2.imwrite(str(idir / f"{k + 1:05d}.png"),
                               (rng.random((H, W, 3)) * 255).astype(np.uint8))


@pytest.mark.parametrize("size", [(256, 256), (96, 128)])
def test_jhmdb_reader_matches_jax(tmp_path, size):
    _jhmdb_tree(tmp_path / "jhmdb")
    got = list(tapvid.create_jhmdb_dataset(tmp_path / "jhmdb", size))
    want = list(jax_tapvid.create_jhmdb_dataset(tmp_path / "jhmdb", size))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_records_equal(g, w)


def test_jhmdb_reader_refuses_an_empty_tree(tmp_path):
    (tmp_path / "splits").mkdir()
    with pytest.raises(ValueError, match="No JHMDB videos"):
        next(tapvid.create_jhmdb_dataset(tmp_path))


def test_tmp_np_seed_matches_jax():
    np.random.seed(123)
    with rand_utils.tmp_np_seed(5):
        got = np.random.rand(4)
    after = np.random.rand(2)
    np.random.seed(123)
    with jax_rand_utils.tmp_np_seed(5):
        want = np.random.rand(4)
    assert np.array_equal(got, want) and np.array_equal(after, np.random.rand(2))
    np.random.seed(9)
    with rand_utils.tmp_np_seed(None):
        a = np.random.rand(3)
    np.random.seed(9)
    assert np.array_equal(a, np.random.rand(3))


def test_sparse_exception_logger(caplog):
    log = various.SparseExceptionLogger(logging.getLogger("sparse_test"), prefix_len=10)
    with caplog.at_level(logging.ERROR, logger="sparse_test"):
        log("CUDA out of memory: tried 1 GiB")
        log("CUDA out of memory: tried 2 GiB")
        log("another message")
        try:
            raise ValueError("boom")
        except ValueError as e:
            log("boom happened", exc=e)
    assert len(caplog.records) == 3
    assert caplog.records[-1].exc_info is not None
    assert log.summary() == {"CUDA out o": 2, "another me": 1, "boom happe": 1}


def test_send_notification_runs_the_command(tmp_path, monkeypatch):
    out = tmp_path / "msg.txt"
    monkeypatch.setenv("MFT_NOTIFY_CMD", f"printf %s {{message}} > {out}")
    assert notifications.send_notification("run 'x' done; ok")
    assert out.read_text() == "run 'x' done; ok"

    @notifications.with_notification
    def job(fail):
        if fail:
            raise RuntimeError("bad")
        return 3

    assert job(False) == 3 and out.read_text() == "job finished"
    with pytest.raises(RuntimeError):
        job(True)
    assert out.read_text() == "job FAILED: RuntimeError('bad')"
    monkeypatch.delenv("MFT_NOTIFY_CMD")
    if "telegram_send" not in sys.modules:
        monkeypatch.setitem(sys.modules, "telegram_send", None)   # no backend: a no-op
        assert notifications.send_notification("nobody listens") is False


ENTRIES = {
    "runner": lambda: runner.main(),
    "evaluate": lambda: evaluate.main(),
    "train": lambda: loop.main(["--device", "no_such_device"]),
    "demo": lambda: demo.main(["--video", "no_such_dir", "--config", "no_such_config",
                               "--device", "cpu"]),
}


@pytest.mark.parametrize("debug", [False, True], ids=["unset", "MFT_TPU_DEBUG"])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_debug_entry(monkeypatch, tmp_path, capsys, entry, debug):
    """With MFT_TPU_DEBUG set, the exception opens pdb post mortem and is
    raised again; unset, it is raised as before and pdb stays closed."""
    calls = []
    monkeypatch.setattr(pdb, "post_mortem", lambda tb=None: calls.append(tb))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["prog", "--trackers", "no_such_config",
                                      "--dataset", "no_such_dataset"])
    if debug:
        monkeypatch.setenv("MFT_TPU_DEBUG", "1")
    else:
        monkeypatch.delenv("MFT_TPU_DEBUG", raising=False)
    with pytest.raises((ValueError, RuntimeError)):
        ENTRIES[entry]()
    assert len(calls) == (1 if debug else 0)
    if debug:
        assert calls[0] is not None
