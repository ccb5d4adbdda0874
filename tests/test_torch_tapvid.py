"""The port's TAP-Vid reading, resizing, query sampling and metrics against
the JAX package's (``mft_tpu/eval``, whose ``resize_video`` calls OpenCV),
and its small helpers (``utils/misc.py``)."""

import pickle

import numpy as np
import pytest

from mft_tpu.eval import metrics as jax_metrics
from mft_tpu.eval import tapvid as jax_tapvid
from mft_tpu.utils import misc as jax_misc
from mft_tpu_torch.eval import metrics, tapvid
from mft_tpu_torch.utils import misc


def _video(rng, N, H, W, smooth):
    """uint8 frames: uniform noise, or a smooth gradient with a little noise
    (values land on and near the rounding boundaries of the resizes)."""
    if not smooth:
        return rng.integers(0, 256, (N, H, W, 3)).astype(np.uint8)
    y, x = np.mgrid[:H, :W]
    base = (x * 255.0 / W + y * 127.0 / H)[None, ..., None] + np.array([0, 40, 90])
    return ((base + rng.integers(0, 8, (N, H, W, 3))) % 256).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [
    ((256, 256), (256, 256)),     # the headline protocol's first stage: a copy
    ((256, 256), (512, 512)),     # ... and its second: INTER_LINEAR, exactly 2x
    ((480, 854), (256, 256)),     # DAVIS 480p to 256x256: INTER_AREA, general
    ((64, 96), (32, 48)),         # INTER_AREA, 2 x 2 blocks
    ((60, 90), (20, 30)),         # INTER_AREA, 3 x 3 blocks
    ((37, 70), (80, 150)),        # INTER_LINEAR, uneven factors
    ((50, 80), (60, 40)),         # one side up, one down: INTER_LINEAR
])
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_resize_video_matches_opencv(rng, src, dst, smooth):
    """Bit for bit with the JAX package's cv2.resize at every stage shape."""
    video = _video(rng, 2, *src, smooth)
    got = tapvid.resize_video(video, dst)
    want = jax_tapvid.resize_video(video, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_video_fake_and_lazy(rng):
    video = _video(rng, 3, 16, 24, True)
    assert not tapvid.resize_video(video, (8, 12), fake_video=True).any()
    lazy = tapvid.resize_video(video, (32, 48), lazy_video=True)
    np.testing.assert_array_equal(lazy[1](), jax_tapvid.resize_video(video, (32, 48))[1])


def _tracks(rng, N=9, T=13):
    occl = rng.uniform(size=(N, T)) < 0.3
    occl[0] = True   # never visible: dropped in 'first'
    pts = rng.uniform(0, 256, (N, T, 2))
    return occl, pts, np.zeros((T, 8, 8, 3), np.uint8)


@pytest.mark.parametrize("mode", ["first", "strided"])
def test_query_sampling_matches_jax(rng, mode):
    occl, pts, frames = _tracks(rng)
    fn = f"sample_queries_{mode}"
    got, want = getattr(tapvid, fn)(occl, pts, frames), getattr(jax_tapvid, fn)(occl, pts, frames)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _synth_tracks(rng, N=12, T=20, noise=1.0):
    gt_tracks = rng.uniform(20, 230, (1, N, 1, 2)) + np.cumsum(
        rng.normal(0, 2, (1, N, T, 2)), axis=2)
    gt_occluded = rng.uniform(size=(1, N, T)) < 0.2
    gt_occluded[:, :, 0] = False
    pred_tracks = gt_tracks + rng.normal(0, noise, gt_tracks.shape)
    pred_occluded = gt_occluded ^ (rng.uniform(size=gt_occluded.shape) < 0.1)
    q = np.stack([np.zeros(N), gt_tracks[0, :, 0, 1], gt_tracks[0, :, 0, 0]], axis=-1)[None]
    return q, gt_occluded, gt_tracks, pred_occluded, pred_tracks


@pytest.mark.parametrize("mode", ["first", "strided"])
def test_metrics_match_jax(rng, mode):
    args = _synth_tracks(rng)
    got = metrics.compute_tapvid_metrics(*args, mode)
    want = jax_metrics.compute_tapvid_metrics(*args, mode)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="query mode"):
        metrics.compute_tapvid_metrics(*args, "sideways")


def test_pck_and_latex_match_jax(rng):
    gt = rng.uniform(10, 90, (4, 5, 2))
    pred = gt + rng.normal(0, 3, gt.shape)
    valid = rng.uniform(size=(4, 5)) < 0.8
    assert metrics.compute_pck(gt, pred, valid) == jax_metrics.compute_pck(gt, pred, valid)
    scalars = metrics.compute_tapvid_metrics(*_synth_tracks(rng), "strided")
    assert metrics.latex_table(scalars) == jax_metrics.latex_table(scalars)
    pck = metrics.compute_pck(gt, pred)
    assert metrics.latex_table(pck) == jax_metrics.latex_table(pck)


def _davis_pickle(path, rng, H=40, W=56, T=7):
    data = {}
    for s in range(2):
        points = rng.uniform(0.05, 0.95, (5, T, 2))
        occluded = rng.uniform(size=(5, T)) < 0.25
        data[f"seq{s}"] = {"video": _video(rng, T, H, W, True), "points": points,
                           "occluded": occluded}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


@pytest.mark.parametrize("scaling", ["fullres", "32x32_48x48", "x20", "28x"])
def test_dataset_records_match_jax(tmp_path, rng, scaling):
    """create_tapvid_dataset: every stage resized, points scaled to the last
    stage's raster, both query modes, equal to JAX's record for record."""
    path = _davis_pickle(tmp_path / "davis.pkl", rng)
    got = list(tapvid.create_tapvid_dataset(path, ["first", "strided"], scaling))
    want = list(jax_tapvid.create_tapvid_dataset(path, ["first", "strided"], scaling))
    assert [s["video_name"] for s in got] == [s["video_name"] for s in want] == ["seq0", "seq1"]
    for g, w in zip(got, want):
        for mode in ("first", "strided"):
            for k in w["data"][mode]:
                np.testing.assert_array_equal(g["data"][mode][k], w["data"][mode][k],
                                              err_msg=f"{mode} {k}")


def test_unported_readers_raise(tmp_path):
    """Kinetics shards (JPEG frames) are read now, through the loader and
    the dataset, as JAX reads them (PIL's RGB decode); the RGB-Stacking and
    JHMDB readers are ported (tests/test_torch_eval_extra.py)."""
    import cv2
    rng = np.random.default_rng(3)
    frames = [(rng.random((32, 40, 3)) * 255).astype(np.uint8) for _ in range(3)]
    shard = tmp_path / "kinetics.pkl"
    with open(shard, "wb") as f:
        pickle.dump([{"video": [cv2.imencode(".jpg", x)[1].tobytes() for x in frames],
                      "points": rng.random((4, 3, 2)), "occluded": rng.random((4, 3)) > 0.5}],
                    f)
    got = tapvid.load_pickle_sequences(shard, device="cpu")
    want = jax_tapvid.load_pickle_sequences(shard)
    assert list(got) == list(want) == ["kin-kinetics-0000"]
    assert np.array_equal(got["kin-kinetics-0000"]["video"], want["kin-kinetics-0000"]["video"])
    for mode in ("first", "strided"):
        g = next(tapvid.create_tapvid_dataset(shard, mode, "64x64", device="cpu"))
        w = next(jax_tapvid.create_tapvid_dataset(shard, mode, "64x64"))
        assert g["video_name"] == w["video_name"]
        for key, val in w["data"][mode].items():
            assert np.array_equal(g["data"][mode][key], val), key


@pytest.mark.parametrize("scale", ["fullres", "256x256", "256x256_512x512", "x256",
                                   "512x", "fullres_128x96"])
def test_parse_scale_matches_jax(scale):
    shape = {"W": 854, "H": 480}
    assert misc.parse_scale_WH(scale, shape) == jax_misc.parse_scale_WH(scale, shape)


def test_misc_helpers_match_jax():
    import torch
    xs = list("abcdef")
    assert misc.make_pairs(xs) == jax_misc.make_pairs(xs)
    for d in (1, 2, 5, 7):
        assert list(misc.make_delta_pairs(xs, d)) == list(jax_misc.make_delta_pairs(xs, d))
    for s, n in (("short", 10), ("a much longer string", 10)):
        assert misc.trim_string(s, n) == jax_misc.trim_string(s, n)
    t = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(misc.ensure_numpy(t), t.numpy())
    a = np.ones(3)
    assert misc.ensure_numpy(a) is a
    np.testing.assert_array_equal(misc.ensure_numpy([1, 2]), jax_misc.ensure_numpy([1, 2]))
    with pytest.raises(ValueError):
        misc.parse_scale_WH("x", {"W": 4, "H": 4})
