"""The port's training data path against the JAX package's, and the
training loop end to end on the CPU.

- ``train/synth.py``: the same arrays for a seed, bit for bit;
- flow readers: files written by either package read back by the other;
- OpenCV's resize and HSV conversions, written in numpy, against cv2;
- FlowAugmenter / SparseFlowAugmenter against JAX's under the same seed;
- MpiSintel and fetch_dataset('sintel') samples on a tiny synthetic
  Sintel-form tree against JAX's;
- checkpoints: round trip, resume equal to the uninterrupted run, and the
  msgpack export read by flax's ``msgpack_restore`` and the port's RAFTFlow;
- ``python -m mft_tpu_torch.train.loop @args --device cpu`` on the tiny
  tree (checkpoint, export, panels, scalars, validation).
"""

import json
import types

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.train import augment as jaug
from mft_tpu.train import datasets as jds
from mft_tpu.train import flow_readers as jfr
from mft_tpu.train import synth as jsynth
from mft_tpu_torch import environment
from mft_tpu_torch.io.png import decode_png
from mft_tpu_torch.models.raft import RAFT
from mft_tpu_torch.models.raft.raft import RAFTParams
from mft_tpu_torch.train import augment as taug
from mft_tpu_torch.train import datasets as tds
from mft_tpu_torch.train import flow_readers as tfr
from mft_tpu_torch.train import synth as tsynth
from mft_tpu_torch.train.checkpoint import (export_weights, latest_checkpoint,
                                            restore_checkpoint, save_checkpoint)
from mft_tpu_torch.train.logger import TrainLogger
from mft_tpu_torch.train.loop import freeze, main, make_train_step
from mft_tpu_torch.train.optim import make_optimizer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU training math: the suite
    runs 6 xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_synth_is_bit_equal():
    """Scenes, pair blocks and batches: every array equal for a seed."""
    a = jsynth.make_batch(np.random.default_rng(3), 2, 48, 64, T=4)
    b = tsynth.make_batch(np.random.default_rng(3), 2, 48, 64, T=4)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(jsynth.scene_pair_block(np.random.default_rng(4), 40, 56, T=3),
                    tsynth.scene_pair_block(np.random.default_rng(4), 40, 56, T=3)):
        assert all(np.array_equal(u, v) for u, v in zip(x, y))


def test_pair_flow_from_frame_zero_is_flow_occl():
    rng = np.random.default_rng(0)
    scene = tsynth.Scene(rng, 48, 64, T=3)
    comps = [scene.composite(t) for t in range(3)]
    flow, occl = tsynth.pair_flow_occl(scene, 0, 2, comps[0][1], comps[2][1])
    want_flow, want_occl = scene.flow_occl(2)
    assert np.array_equal(flow, want_flow) and np.array_equal(occl, want_occl)


def test_flow_readers_cross_read(tmp_path):
    """Each format written by one package, read by the other: equal arrays."""
    r = np.random.default_rng(0)
    flow = (r.normal(size=(9, 13, 2)) * 20).astype(np.float32)
    for write, read in ((jfr.write_flo, tfr.read_flo), (tfr.write_flo, jfr.read_flo)):
        write(tmp_path / "a.flo", flow)
        assert np.array_equal(read(tmp_path / "a.flo"), flow)
    for data in (flow[..., 0], np.concatenate([flow, flow[..., :1]], -1)):
        for write, read in ((jfr.write_pfm, tfr.read_pfm), (tfr.write_pfm, jfr.read_pfm)):
            write(tmp_path / "a.pfm", data)
            assert np.array_equal(read(tmp_path / "a.pfm"), data)
    kflow = np.round(flow * 64) / 64
    valid = (r.random((9, 13)) > 0.3).astype(np.float32)
    for write, read in ((jfr.write_kitti_flow, tfr.read_kitti_flow),
                        (tfr.write_kitti_flow, jfr.read_kitti_flow)):
        write(tmp_path / "k.png", kflow, valid)
        f, v = read(tmp_path / "k.png")
        assert np.array_equal(f, kflow) and np.array_equal(v, valid)
    u = flow[..., 0].copy()
    u[0, 0] = np.nan
    np.savez(tmp_path / "v.npz", u=u, v=flow[..., 1])
    for x, y in zip(jfr.read_viper_flow(tmp_path / "v.npz"),
                    tfr.read_viper_flow(tmp_path / "v.npz")):
        assert np.array_equal(x, y)
    from mft_tpu.io.flowou_codecs import write_flowou
    occl, sigma = r.random((9, 13)).astype(np.float32), r.random((9, 13)).astype(np.float32)
    write_flowou(tmp_path / "a.flowou.png", flow, occl, sigma)
    for x, y in zip(jfr.read_gen(tmp_path / "a.flowou.png"),
                    tfr.read_gen(tmp_path / "a.flowou.png")):
        assert np.array_equal(x, y)
    img = r.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "i.png"), img[:, :, ::-1])
    assert np.array_equal(tfr.read_image(tmp_path / "i.png"), img)
    tfr.write_image(tmp_path / "j.png", img)
    assert np.array_equal(jfr.read_image(tmp_path / "j.png"), img)
    grey16 = r.integers(0, 65536, (9, 13), dtype=np.uint16)
    cv2.imwrite(str(tmp_path / "g.png"), grey16)
    assert np.array_equal(tfr.read_image(tmp_path / "g.png"), jfr.read_image(tmp_path / "g.png"))
    cv2.imwrite(str(tmp_path / "p.ppm"), img[:, :, ::-1])
    assert np.array_equal(tfr.read_image(tmp_path / "p.ppm"), jfr.read_image(tmp_path / "p.ppm"))
    cv2.imwrite(str(tmp_path / "p.jpg"), img)
    assert np.array_equal(tfr.read_image(tmp_path / "p.jpg", device="cpu"),
                          jfr.read_image(tmp_path / "p.jpg"))
    assert np.array_equal(tfr.read_gen(tmp_path / "p.jpg", device="cpu"),
                          jfr.read_gen(tmp_path / "p.jpg"))


@pytest.mark.parametrize("shape,new_wh", [((37, 53, 3), (71, 40)), ((37, 53, 3), (30, 20)),
                                          ((37, 53, 2), (70, 28)), ((37, 53, 2), (71, 40)),
                                          ((37, 53), (90, 61)), ((37, 53), (30, 20)),
                                          ((60, 100), (59, 99))])
def test_resize_matches_cv2(shape, new_wh):
    """uint8 images bit for bit; float32 maps (the augmenters resize flow,
    2 channels, and occlusion and validity, 1): 2-channel equal, 1-channel
    within one float32 ulp of the map's largest |value| (OpenCV's vector
    sums)."""
    r = np.random.default_rng(1)
    if len(shape) == 3 and shape[2] == 3:
        a = r.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(taug.cv_resize_linear(a, new_wh),
                              cv2.resize(a, new_wh, interpolation=cv2.INTER_LINEAR))
        return
    f = (r.normal(size=shape) * 10).astype(np.float32)
    got = taug.cv_resize_linear(f, new_wh)
    want = cv2.resize(f, new_wh, interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=float(np.abs(f).max()) * 2.0 ** -23)
    if f.ndim == 3 and f.shape[2] == 2:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("width", [1, 120])
def test_hsv_matches_cv2(width):
    """RGB triples on a lattice and HSV triples, in rows of 1 pixel (OpenCV's
    scalar code) and of 120 (3 vector blocks and a scalar tail): bit for bit."""
    rgb = np.stack(np.meshgrid(*[np.arange(0, 256, 3)] * 3, indexing="ij"), -1)
    rgb = rgb.reshape(-1, 3)[:len(rgb.reshape(-1, 3)) // 120 * 120]
    rgb = rgb.reshape(-1, width, 3).astype(np.uint8)
    assert np.array_equal(taug.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(0, 256, 2), np.arange(0, 256, 2),
                               indexing="ij"), -1).reshape(-1, width, 3).astype(np.uint8)
    assert np.array_equal(taug.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _sample(seed, H=96, W=128):
    r = np.random.default_rng(seed)
    img1 = r.integers(0, 256, (H, W, 3), dtype=np.uint8)
    img2 = np.roll(img1, 3, axis=1)
    flow = (r.normal(size=(H, W, 2)) * 5).astype(np.float32)
    occl = (r.random((H, W, 1)) > 0.8).astype(np.float32)
    valid = (r.random((H, W)) > 0.1).astype(np.float32)
    return img1, img2, flow, valid, occl


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["dense", "dense_no_occl", "sparse"])
def test_augmenters_match_jax(seed, kind):
    """The same draws in the same order: images equal bit for bit; flow
    equal (2-channel resize); occlusion and validity within 1e-6 (1-channel
    resize, a float32 ulp)."""
    kw = dict(crop_size=(64, 96), min_scale=-0.4, max_scale=0.8, do_flip=True, seed=seed)
    if kind == "sparse":
        ja, ta = jaug.SparseFlowAugmenter(**kw), taug.SparseFlowAugmenter(**kw)
    else:
        load = kind == "dense"
        ja = jaug.FlowAugmenter(load_occlusion=load, v_flip_prob=0.5, **kw)
        ta = taug.FlowAugmenter(load_occlusion=load, v_flip_prob=0.5, **kw)
    for k in range(3):
        img1, img2, flow, valid, occl = _sample(100 * seed + k)
        if kind == "dense_no_occl":
            valid = None
        args = lambda: (img1.copy(), img2.copy(), flow.copy(),
                        None if valid is None else valid.copy(), occl.copy())
        want, got = ja(*args()), ta(*args())
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
        np.testing.assert_allclose(got[3], want[3], atol=1e-6)
        np.testing.assert_allclose(got[4], want[4], atol=1e-6)
    assert ja.rng.random() == ta.rng.random()        # the same number of draws


def test_unported_corruptions_raise(tmp_path):
    """Text overlays still raise (no font rasterizer); the JPEG corruption
    and the blend with a source directory are ported: the JPEG corruption
    bit for bit with JAX's, the augmenters built with JAX's settings."""
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        taug.FlowAugmenter((8, 8), do_add_text_transform=True)
    img = np.random.default_rng(1).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    assert np.array_equal(taug.jpeg_corrupt(img, 1, device="cpu"), jaug.jpeg_corrupt(img, 1))
    cv2.imwrite(str(tmp_path / "b.png"), img)
    for kw in (dict(do_jpeg_transform=True), dict(blend_source=str(tmp_path))):
        t, j = taug.FlowAugmenter((8, 8), device="cpu", **kw), jaug.FlowAugmenter((8, 8), **kw)
        assert t.do_jpeg_transform == j.do_jpeg_transform
        assert t.blend_aug.do_blend_transform == j.blend_aug.do_blend_transform
        assert t.blend_aug.image_list == j.blend_aug.image_list


@pytest.fixture(scope="module")
def sintel_root(tmp_path_factory):
    return tsynth.write_sintel_tree(tmp_path_factory.mktemp("sintel"),
                                    scenes=("alley_1", "synth_0"), frames=3, H=88, W=120,
                                    seed=7)


def test_sintel_tree_and_datasets_match_jax(sintel_root):
    """MpiSintel with and without the val subsplit, and fetch_dataset
    ('sintel') with the same augmenter seeds: the same file lists and
    samples (images equal, flow equal, occlusion and validity 1e-6)."""
    for kw in (dict(dstype="clean", load_occlusion=True), dict(dstype="final", subsplit="val"),
               dict(dstype="clean", subsplit="train", load_occlusion=True)):
        j, t = jds.MpiSintel(None, root=sintel_root, **kw), tds.MpiSintel(None, root=sintel_root, **kw)
        assert j.image_list == t.image_list and j.flow_list == t.flow_list
        assert j.occlusion_list == t.occlusion_list and len(t) > 0
        for i in range(len(t)):
            for x, y in zip(j[i], t[i]):
                assert np.array_equal(x, y)
    env = types.SimpleNamespace(sintel_dir=str(sintel_root))
    jmix = jds.fetch_dataset("sintel", (48, 64), env=env)
    tmix = tds.fetch_dataset("sintel", (48, 64), env=env)
    assert len(jmix) == len(tmix) == 8
    for k, (jp, tp) in enumerate(zip(jmix.parts, tmix.parts)):
        jp.augmentor.rng = np.random.default_rng(k)
        tp.augmentor.rng = np.random.default_rng(k)
    for i in range(len(tmix)):
        want, got = jmix[i], tmix[i]
        for a, (x, y) in enumerate(zip(want, got)):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_allclose(y, x, atol=1e-6 if a >= 3 else 0, rtol=0)


def _tiny_state(official=False, seed=0):
    torch.manual_seed(seed)
    model = RAFT(RAFTParams(), train_mode=not official)
    from mft_tpu_torch.models.raft.wrapper import random_init
    random_init(model, seed)
    tx, _ = make_optimizer(lr=1e-3, num_steps=10, params=dict(model.named_parameters()),
                           trainable_prefixes=("occlusion_block",) if official else None)
    freeze(model, tx.mask)
    state = {"model": model, "opt_state": tx.init(dict(model.named_parameters())), "step": 0}
    lk = dict(gamma=0.85, freeze_optical_flow=official,
              occlusion_module="separate_with_uncertainty",
              uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
              weighting_unc_loss=False)
    return state, make_train_step(model, tx, lk, iters=2)


def _tiny_batch(seed):
    b = tsynth.make_batch(np.random.default_rng(seed), 2, 64, 64, T=3)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in b)


def test_batch_loader_joins_its_workers():
    """Leaving the loop over a BatchLoader stops and joins its worker
    threads: a batch still being built finishes before the caller goes on,
    so no worker's work (a JPEG stage's launches among it) lands in what
    runs next."""
    import threading
    import time

    class Slow:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            time.sleep(0.05)
            return (np.full(2, i, np.float32),)

    before = set(threading.enumerate())
    for k, _ in enumerate(tds.BatchLoader(Slow(), 2, num_workers=3)):
        if k == 1:
            break
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]


def test_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Full recipe on the CPU (64x64, 2 iterations): steps 1-2, save, a
    fresh state restored from the checkpoint takes step 3; its weights,
    batch statistics and optimizer state equal the uninterrupted run's
    step 3 bit for bit (the CPU's sums are deterministic)."""
    state, step = _tiny_state()
    for s in range(2):
        state, _ = step(state, _tiny_batch(s))
    path = save_checkpoint(tmp_path, state["step"], state)
    assert latest_checkpoint(tmp_path) == path and path.name == "step_00000002"
    state, _ = step(state, _tiny_batch(2))

    fresh, fresh_step = _tiny_state(seed=1)
    fresh = restore_checkpoint(path, fresh)
    assert fresh["step"] == 2
    fresh, _ = fresh_step(fresh, _tiny_batch(2))
    assert fresh["step"] == 3
    a, b = state["model"].state_dict(), fresh["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k in ("mu", "nu"):
        assert all(torch.equal(state["opt_state"][k][n], fresh["opt_state"][k][n])
                   for n in state["opt_state"][k])
    assert state["opt_state"]["count"] == fresh["opt_state"]["count"] == 3


def test_export_read_by_flax_and_raftflow(tmp_path):
    """export_weights writes flax msgpack: flax's msgpack_restore (what JAX's
    load_variables decodes with) gives the variables tree of every weight
    and statistic, leaf for leaf, under the flax names that
    params_from_flax maps (tests/test_torch_raft.py ties those to JAX's
    init); the port's RAFTFlow loads it."""
    from flax import serialization
    from mft_tpu_torch.config import default_flow_config
    from mft_tpu_torch.models.raft import RAFTFlow
    from mft_tpu_torch.models.raft.convert import params_from_flax
    state, _ = _tiny_state()
    model = state["model"]
    with torch.no_grad():
        model.cnet.norm1.running_mean.add_(0.25)
    export_weights(tmp_path / "w.msgpack", model)
    tree = serialization.msgpack_restore((tmp_path / "w.msgpack").read_bytes())
    assert set(tree) == {"params", "batch_stats"}
    assert tree["params"]["fnet"]["conv1"]["kernel"].shape == (7, 7, 3, 64)   # HWIO
    sd = params_from_flax(tree)
    assert set(sd) == set(model.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    conf = default_flow_config()
    conf.model = str(tmp_path / "w.msgpack")
    conf.raft_params = dict(conf.raft_params, compute_dtype="float32")
    conf.flow_iters = 1
    flower = RAFTFlow(conf, device="cpu")
    assert all(torch.equal(flower.model.state_dict()[k], v)
               for k, v in model.state_dict().items())


def test_train_logger(tmp_path):
    tlog = TrainLogger(tmp_path / "runs")
    for i in range(20):
        tlog.push({"train/loss": torch.tensor(float(i))}, lr=0.5)
    tlog.write_dict({"val/x": 1.0})
    r = np.random.default_rng(0)
    flow = torch.from_numpy(r.normal(size=(1, 16, 24, 2)).astype(np.float32))
    preds = {"flow": [flow], "occlusion": [flow], "uncertainty": [flow[..., :1]]}
    batch = (flow.new_full((1, 16, 24, 3), 100.0), flow.new_zeros((1, 16, 24, 3)),
             flow, flow.new_ones((1, 16, 24)), flow.new_zeros((1, 16, 24)))
    tlog.write_prediction_panels(batch, preds)
    tlog.close()
    recs = [json.loads(line) for line in (tmp_path / "runs" / "scalars.jsonl").open()]
    assert [rec["step"] for rec in recs] == [10, 20, 20]
    assert recs[0]["train/loss"] == 4.5 and recs[0]["lr"] == 0.5
    panels = sorted((tmp_path / "runs" / "panels" / "step_000020").glob("*.png"))
    assert len(panels) == 12
    assert decode_png((tmp_path / "runs" / "panels" / "step_000020" / "flow_gt.png")
                      .read_bytes()).shape == (16, 24, 3)


@pytest.mark.parametrize("recipe", ["official", "full"])
def test_loop_cli_on_the_cpu(tmp_path, sintel_root, monkeypatch, recipe):
    """The entry point with an @file, on the CPU: 2 steps at 64x96 with 1
    iteration on the tiny Sintel-form tree, validation on its val scene;
    checkpoint, export, panels and scalars are written; the export loads;
    frozen parameters (official) are unchanged and trainable ones moved."""
    monkeypatch.setattr(environment, "env_settings",
                        lambda: types.SimpleNamespace(sintel_dir=str(sintel_root)))
    init = tmp_path / "init.pth"
    model = RAFT(RAFTParams())
    from mft_tpu_torch.models.raft.wrapper import random_init
    random_init(model, 3)
    torch.save(model.state_dict(), init)
    args = ["--name", "t", "--stage", "sintel", "--validation", "sintel_val_subsplit",
            "--restore_ckpt", str(init), "--num_steps", "2", "--batch_size", "2",
            "--image_size", "64", "96", "--iters", "1", "--num_workers", "1",
            "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu"]
    if recipe == "official":
        args += ["--freeze_optical_flow_training", "--freeze_features_training"]
    (tmp_path / "args.txt").write_text("\n".join(args) + "\n")
    main([f"@{tmp_path / 'args.txt'}"])
    run = tmp_path / "ck" / "t"
    assert (run / "step_00000002" / "state.pt").is_file()
    payload = torch.load(run / "step_00000002" / "state.pt", weights_only=True)
    assert payload["step"] == 2
    from mft_tpu_torch.models.raft.convert import params_from_flax
    from mft_tpu_torch.models.raft.flax_msgpack import read_variables
    after = params_from_flax(read_variables(run / "t_step2.msgpack"))
    before = model.state_dict()
    for k, v in before.items():
        frozen = recipe == "official" and not k.startswith("occlusion_block")
        if frozen or k.endswith(("running_mean", "running_var")) and recipe == "official":
            assert torch.equal(after[k], v), k
    moved = [k for k in before if not torch.equal(after[k], before[k])]
    assert moved and (recipe == "full" or all(k.startswith("occlusion_block") for k in moved))
    assert (recipe == "full") == any("running" in k for k in moved)
    recs = [json.loads(line) for line in (run / "runs" / "scalars.jsonl").open()]
    assert any("val/sintel_val_subsplit/epe" in rec for rec in recs)
    assert (run / "runs" / "panels" / "step_000002" / "flow_est.png").is_file()


def _write_tree(kind, root, r):
    """A tiny tree of each dataset's on-disk layout (48x64 frames)."""
    H, W = 48, 64
    img = lambda: r.integers(0, 256, (H, W, 3), dtype=np.uint8)
    flow = lambda: (r.normal(size=(H, W, 2)) * 3).astype(np.float32)
    mk = lambda p: (p.mkdir(parents=True, exist_ok=True), p)[1]
    if kind == "chairs":
        d = mk(root / "data")
        for i in (1, 2, 3):
            cv2.imwrite(str(d / f"{i:05d}_img1.ppm"), img())
            cv2.imwrite(str(d / f"{i:05d}_img2.ppm"), img())
            tfr.write_flo(d / f"{i:05d}_flow.flo", flow())
        np.savetxt(root / "chairs_split.txt", np.array([1, 2, 1]), fmt="%d")
        return dict(root=str(d))
    if kind == "things":
        for t in range(3):
            cv2.imwrite(str(mk(root / "frames_finalpass/TRAIN/A/0000/left") / f"{t:04d}.png"),
                        img())
            for direction in ("into_future", "into_past"):
                tfr.write_pfm(mk(root / f"optical_flow/TRAIN/A/0000/{direction}/left")
                              / f"{t:04d}.pfm", np.concatenate([flow(), flow()[..., :1]], -1))
                if t < 2:
                    cv2.imwrite(str(mk(root / f"occlusions/TRAIN/A/0000/{direction}/left")
                                    / f"{t + (direction == 'into_past'):04d}.png"),
                                (r.random((H, W)) > 0.7).astype(np.uint8) * 255)
        return dict(root=str(root), dstype="frames_finalpass", load_occlusion=True)
    if kind == "kubric":
        from mft_tpu_torch.io.flowou_codecs import write_flowou
        for scene in ("s0", "s1"):
            for t in range(3):
                cv2.imwrite(str(mk(root / "train" / scene / "images") / f"{t:04d}.png"), img())
                f = flow() if t else np.where(r.random((H, W, 1)) > 0.5, 0.5, 0.0).astype(
                    np.float32) * np.ones((1, 1, 2), np.float32)
                write_flowou(mk(root / "train" / scene / "flowou") / f"0000_to_{t:04d}.flowou.png",
                             f, (r.random((H, W)) > 0.7).astype(np.float32),
                             r.random((H, W)).astype(np.float32))
        return dict(root=str(root), correct_flow=True)
    if kind == "kitti":
        for i in range(2):
            for k in (10, 11):
                cv2.imwrite(str(mk(root / "training/image_2") / f"{i:06d}_{k}.png"), img())
            tfr.write_kitti_flow(mk(root / "training/flow_occ") / f"{i:06d}_10.png",
                                 np.round(flow() * 64) / 64,
                                 (r.random((H, W)) > 0.3).astype(np.float32))
        return dict(root=str(root))
    if kind == "hd1k":
        for t in range(3):
            cv2.imwrite(str(mk(root / "hd1k_input/image_2") / f"000000_{t:04d}.png"), img())
            tfr.write_kitti_flow(mk(root / "hd1k_flow_gt/flow_occ") / f"000000_{t:04d}.png",
                                 np.round(flow() * 64) / 64,
                                 (r.random((H, W)) > 0.3).astype(np.float32))
        return dict(root=str(root))
    if kind == "viper":
        for t in range(3):
            cv2.imwrite(str(mk(root / "val/img/001") / f"001_{t:05d}.png"), img())
            f = flow()
            f[0, :4, 0] = np.nan
            np.savez(mk(root / "val/flow/001") / f"001_{t:05d}.npz", u=f[..., 0], v=f[..., 1])
        return dict(root=str(root))
    raise ValueError(kind)


DATASETS = {"chairs": "FlyingChairs", "things": "FlyingThings3D", "kubric": "KubricLongTerm",
            "kitti": "KITTI", "hd1k": "HD1K", "viper": "VIPER"}


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_other_datasets_match_jax(tmp_path, kind, augment):
    """Every other dataset on a tiny tree of its layout: the same pairs and
    the same samples as JAX's, without augmentation and with it (the same
    seeded generator on both sides; the sparse datasets through
    SparseFlowAugmenter): images and flow equal, occlusion and validity
    within 1e-6."""
    kw = _write_tree(kind, tmp_path, np.random.default_rng(0))
    aug = dict(crop_size=(32, 48), min_scale=-0.1, max_scale=0.3, do_flip=True) if augment \
        else None
    j = getattr(jds, DATASETS[kind])(aug, **kw)
    t = getattr(tds, DATASETS[kind])(aug, **kw)
    assert j.image_list == t.image_list and j.flow_list == t.flow_list and len(t) > 0
    assert j.occlusion_list == t.occlusion_list
    if augment:
        j.augmentor.rng = np.random.default_rng(5)
        t.augmentor.rng = np.random.default_rng(5)
        if kind in ("kitti", "hd1k", "viper"):
            j.augmentor._dense.rng = j.augmentor.rng
            t.augmentor._dense.rng = t.augmentor.rng
    for i in range(len(t)):
        for a, (x, y) in enumerate(zip(j[i], t[i])):
            assert x.shape == y.shape and x.dtype == y.dtype, (i, a)
            np.testing.assert_allclose(y, x, atol=1e-6 if a >= 3 else 0, rtol=0,
                                       err_msg=f"sample {i} array {a}")


def test_validation_metrics_match_jax():
    from mft_tpu.train import validate as jval
    from mft_tpu_torch.train import validate as tval
    r = np.random.default_rng(2)
    gt, pred = (r.normal(size=(2, 20, 24, 2)) * 3).astype(np.float32)
    valid = (r.random((20, 24)) > 0.2).astype(np.float32)
    occl = r.choice(np.array([0.0, 0.005, 0.5, 1.0], np.float32), size=(20, 24))
    pocc, sigma = r.random((20, 24)).astype(np.float32), (r.random((20, 24)) * 6).astype(
        np.float32)
    assert tval.flow_metrics(pred, gt, valid) == jval.flow_metrics(pred, gt, valid)
    assert tval.ou_metrics(pocc, sigma, occl, gt, pred, valid) == jval.ou_metrics(
        pocc, sigma, occl, gt, pred, valid)
    assert tval.flow_metrics(pred, gt, valid * 0) == {}
