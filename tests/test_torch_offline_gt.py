"""The port's offline ground-truth generators against the JAX package's.

``train/generate_occlusions_ft3d.py`` (FlyingThings3D occlusion maps from
forward-backward consistency) and ``train/kubric_longflow.py`` (MOVi-E
longterm flow and occlusion from depth, camera and object poses), both in
float64 torch ops on the CPU here: bit for bit with JAX's numpy on synthetic
inputs made from a seed, the files they write decoding to JAX's, and the
port's dataset readers reading them back.
"""

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io.flowou_codecs import read_flowou as jax_read_flowou
from mft_tpu.train import generate_occlusions_ft3d as jax_occ
from mft_tpu.train import kubric_longflow as jax_kub
from mft_tpu_torch.io.flowou_codecs import read_flowou
from mft_tpu_torch.train import datasets
from mft_tpu_torch.train import generate_occlusions_ft3d as occ
from mft_tpu_torch.train import kubric_longflow as kub
from mft_tpu_torch.train.flow_readers import write_pfm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fb_flows(rng, H, W):
    """A forward flow (a smooth field of a few px that leaves the frame at
    the right border) and a backward flow that undoes it, except in a
    block where it does not: float32 (H, W, 2) each."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    fwd = np.stack([2.5 + 3 * np.sin(ys / 7) + xs / W * 4, 1.5 * np.cos(xs / 9)], -1)
    fwd += rng.normal(scale=0.2, size=(H, W, 2))
    bwd = -fwd + rng.normal(scale=0.3, size=(H, W, 2))
    h, w = H // 4, W // 4
    bwd[h:2 * h, w:2 * w] += rng.normal(scale=4.0, size=(h, w, 2))
    return fwd.astype(np.float32), bwd.astype(np.float32)


def test_occlusion_from_fb_bit_for_bit():
    """48x64 flows, both directions: every map equal to JAX's; the maps hold
    consistent, inconsistent and out-of-frame pixels."""
    rng = np.random.default_rng(0)
    fwd, bwd = fb_flows(rng, 48, 64)
    for f, b in ((fwd, bwd), (bwd, fwd)):
        got = occ.occlusion_from_fb(f, b, device="cpu")
        want = jax_occ.occlusion_from_fb(f, b)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert 0.1 < want.mean() < 0.9, want.mean()
    rt_sq, rhs, out = occ.occlusion_terms(torch.from_numpy(fwd), torch.from_numpy(bwd))
    assert out.any() and (~out & (rt_sq > rhs)).any() and (~out & (rt_sq <= rhs)).any()


def test_occlusion_from_fb_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    f = np.zeros((8, 8, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        occ.occlusion_from_fb(f, f)


def ft3d_tree(root, rng, frames=4, H=40, W=56):
    """A FlyingThings3D-form tree: one TRAIN scene (A/0000), left frames as
    PNGs and both directions' flows as 3-channel PFMs."""
    scene = ("TRAIN", "A", "0000")
    img_dir = root.joinpath("frames_cleanpass", *scene, "left")
    img_dir.mkdir(parents=True)
    for i in range(frames):
        cv2.imwrite(str(img_dir / f"{6 + i:04d}.png"),
                    rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    for direction, tag in (("into_future", "IntoFuture"), ("into_past", "IntoPast")):
        d = root.joinpath("optical_flow", *scene, direction, "left")
        d.mkdir(parents=True)
        for i in range(frames):
            f, _ = fb_flows(rng, H, W)
            if direction == "into_past":
                f = -f
            flow3 = np.concatenate([f, np.zeros((H, W, 1), np.float32)], -1)
            write_pfm(d / f"OpticalFlow{tag}_{6 + i:04d}_L.pfm", flow3)


def test_process_pair_dir_matches_jax(tmp_path):
    """The port's PNGs decode (cv2) to JAX's, pair for pair, in both
    directions; FlyingThings3D(load_occlusion=True) reads them back."""
    rng = np.random.default_rng(1)
    ft3d_tree(tmp_path / "port", rng)
    scene = ("TRAIN", "A", "0000")
    fwd = tmp_path.joinpath("port", "optical_flow", *scene, "into_future", "left")
    bwd = tmp_path.joinpath("port", "optical_flow", *scene, "into_past", "left")
    out_f = tmp_path.joinpath("port", "occlusions", *scene, "into_future", "left")
    out_b = tmp_path.joinpath("port", "occlusions", *scene, "into_past", "left")
    assert occ.generate(tmp_path / "port", device="cpu") == 3
    n = jax_occ.process_pair_dir(fwd, bwd, tmp_path / "jax_f", tmp_path / "jax_b")
    assert n == 3
    for ours, theirs in ((out_f, tmp_path / "jax_f"), (out_b, tmp_path / "jax_b")):
        names = sorted(p.name for p in ours.glob("*.png"))
        assert names == sorted(p.name for p in theirs.glob("*.png")) and len(names) == 3
        for name in names:
            got = cv2.imread(str(ours / name), cv2.IMREAD_UNCHANGED)
            want = cv2.imread(str(theirs / name), cv2.IMREAD_UNCHANGED)
            assert got.dtype == np.uint8 and got.shape == want.shape == (40, 56)
            np.testing.assert_array_equal(got, want)
    ds = datasets.FlyingThings3D(root=str(tmp_path / "port"), load_occlusion=True)
    assert len(ds) == 6   # 3 pairs a direction
    for k in range(len(ds)):
        want = cv2.imread(ds.occlusion_list[k], cv2.IMREAD_UNCHANGED) / 255.0
        _, _, flow, _, occl = ds[k]
        assert flow.shape == (40, 56, 2)
        np.testing.assert_array_equal(occl, want.astype(np.float32))


def kubric_scene(rng, T=3, H=32, W=48, K=3):
    """A MOVi-E-form scene: smooth depth, K rectangular instances over the
    background (pixels of instance ids and of 0 both), a camera moving a
    little, each instance under its own rigid motion."""
    def quats(n, spread):
        q = rng.normal(scale=spread, size=(n, 4))
        q[:, 0] += 1.0
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)

    ys, xs = np.mgrid[0:H, 0:W]
    depth = np.empty((T, H, W), np.float32)
    seg = np.zeros((T, H, W), np.int32)
    for t in range(T):
        depth[t] = 6.0 + np.sin(xs / 9.0 + t) + 0.5 * np.cos(ys / 7.0)
        for k in range(K):
            y0, x0 = rng.integers(0, H - 10), rng.integers(0, W - 14)
            seg[t, y0:y0 + 10, x0:x0 + 14] = k + 1
            depth[t, y0:y0 + 10, x0:x0 + 14] = 3.0 + k
    cam_pos = np.cumsum(rng.normal(scale=0.05, size=(T, 3)), 0).astype(np.float32)
    inst_pos = rng.normal(scale=0.5, size=(K, T, 3)).astype(np.float32)
    return {"depth": depth, "segmentation": seg,
            "video": rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8),
            "camera": {"focal_length": np.float32(35.0), "sensor_width": np.float32(32.0),
                       "positions": cam_pos, "quaternions": quats(T, 0.02)},
            "instances": {"positions": inst_pos,
                          "quaternions": quats(K * T, 0.1).reshape(K, T, 4)}}


@pytest.mark.parametrize("K", [3, 0])
def test_track_scene_bit_for_bit(K):
    """T = 3, 32x48, 3 instances (and none): flows, occlusions and the
    instance mask equal to JAX's; both occluded and visible pixels."""
    scene = kubric_scene(np.random.default_rng(2), K=K)
    got = kub.track_scene(scene, device="cpu")
    want = jax_kub.track_scene(scene)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    occl = want[1][1:]
    assert 0.0 < occl.mean() < 1.0, occl.mean()
    assert want[2].any() == (K > 0) and not want[2].all()


def test_quaternions_and_camera_bit_for_bit():
    """quat_rotate (and its inverse), unproject and project on their own."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, 7, 4))
    v = rng.normal(size=(5, 7, 3))
    np.testing.assert_array_equal(kub.quat_rotate(torch.from_numpy(q), torch.from_numpy(v)),
                                  jax_kub.quat_rotate(q, v))
    np.testing.assert_array_equal(
        kub.quat_rotate_inverse(torch.from_numpy(q), torch.from_numpy(v)),
        jax_kub.quat_rotate_inverse(q, v))
    scene = kubric_scene(rng)
    cam, (T, H, W) = scene["camera"], scene["depth"].shape
    assert kub.intrinsics(cam, H, W) == jax_kub.intrinsics(cam, H, W)
    p = kub.unproject(torch.from_numpy(scene["depth"][1]), cam, 1, H, W)
    np.testing.assert_array_equal(p, jax_kub.unproject(scene["depth"][1], cam, 1, H, W))
    for g, w in zip(kub.project(p, cam, 2, H, W), jax_kub.project(p.numpy(), cam, 2, H, W)):
        np.testing.assert_array_equal(g, w)


def test_save_scene_flowous_and_reader(tmp_path):
    """The flowou files decode equal to JAX's (each side's reader); the
    port's KubricLongTerm reads the written scene back."""
    scene = kubric_scene(np.random.default_rng(4))
    flows, occl, marker = kub.track_scene(scene, device="cpu")
    kub.save_scene_flowous(tmp_path / "port", flows, occl, marker)
    jax_kub.save_scene_flowous(tmp_path / "jax", flows, occl, marker)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"0000_to_{t:04d}.flowou.png" for t in range(3)]
    for name in names:
        for reader in (read_flowou, jax_read_flowou):
            for g, w in zip(reader(tmp_path / "port" / name), reader(tmp_path / "jax" / name)):
                np.testing.assert_array_equal(g, w)
    flow, occlusion, _ = read_flowou(tmp_path / "port" / names[2])
    assert np.abs(flow - flows[2]).max() < 0.1   # the codec's step

    root = tmp_path / "kubric"
    kub.save_scene_flowous(root / "train" / "00000" / "flowou", flows, occl, marker)
    img_dir = root / "train" / "00000" / "images"
    img_dir.mkdir(parents=True)
    for t, frame in enumerate(scene["video"]):
        cv2.imwrite(str(img_dir / f"{t:04d}.png"), frame[:, :, ::-1])
    ds = datasets.KubricLongTerm(root=str(root))
    assert len(ds) == 2
    img1, img2, flow_gt, valid, occl_gt = ds[1]
    np.testing.assert_array_equal(img1, scene["video"][0])
    np.testing.assert_array_equal(img2, scene["video"][2])
    assert flow_gt.shape == (32, 48, 2) and occl_gt.shape == (32, 48)


def test_load_movi_scene_and_missing_tfds(tmp_path):
    """load_movi_scene lays a (T, H, W, 1) record out as JAX's does;
    generate_dataset needs tensorflow_datasets, which is absent here, where
    JAX's fails alike."""
    rng = np.random.default_rng(5)
    scene = kubric_scene(rng)
    record = {"depth": scene["depth"][..., None], "segmentations": scene["segmentation"][..., None],
              "video": scene["video"], "camera": scene["camera"], "instances": scene["instances"]}
    got, want = kub.load_movi_scene(record), jax_kub.load_movi_scene(record)
    for key in ("depth", "segmentation", "video"):
        np.testing.assert_array_equal(got[key], want[key])
    for part in ("camera", "instances"):
        for key in want[part]:
            np.testing.assert_array_equal(got[part][key], want[part][key])
    for gen in (kub.generate_dataset, jax_kub.generate_dataset):
        with pytest.raises(ModuleNotFoundError, match="tensorflow_datasets"):
            gen("movi_e/256x256", None, tmp_path)
