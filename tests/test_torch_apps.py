"""The port's demo apps and what they stand on, against the JAX package's.

The forward splat (``bilinear_splat``, ``warp_forward_image``,
``FlowOU.warp_forward``), the demo's drawing (``draw_dots`` bit for bit with
OpenCV's filled circle, ``make_default_edit``'s rectangle) and its
per-frame function against JAX's composition on the same FlowOU arrays,
``flow_panel``, the video I/O over PNG/JPEG directories (the writer's JPEG
files byte for byte with JAX's ``cv2.imwrite``), and JAX-free runs of each
app on ``demo_cpu`` at 128x128 against a direct run of the port's tracker /
flow network (its ``.mp4`` outputs byte for byte with the port's writer on
the drawn frames, read back by cv2), the demo on an ``.mp4`` against the
same frames as a PNG directory. No JAX tracker runs here
(``test_torch_mft.py`` holds the tracker's parity).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mft_tpu.apps import demo as jax_demo
from mft_tpu.apps import flow_demo as jax_flow_demo
from mft_tpu.core.flowou import FlowOU as JaxFlowOU
from mft_tpu.core.interp import bilinear_splat as jax_splat
from mft_tpu.core.interp import warp_forward_image as jax_warp_forward
from mft_tpu.io import video as jax_video
from mft_tpu.tracker.point_tracking import convert_to_point_tracking as jax_points
from mft_tpu_torch.apps import demo, flow_demo
from mft_tpu_torch.config import demo_cpu_config
from mft_tpu_torch.core import FlowOU, bilinear_splat, warp_forward_image
from mft_tpu_torch.io import video
from mft_tpu_torch.io.png import encode_png
from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_splat_close(got, want):
    """The scatter side's tolerance: 1e-5 of the largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def _splat_inputs(rng, N, H, W, C):
    data = rng.standard_normal((N, C)).astype(np.float32)
    x = rng.uniform(-3.0, W + 2.0, N)
    y = rng.uniform(-3.0, H + 2.0, N)
    # exactly on the far borders (zero weight after the clamp), on the near
    # ones, and at integer positions
    x[:6] = W - 1.0
    y[6:12] = H - 1.0
    x[12:16], y[16:20] = 0.0, 0.0
    x[20:30] = np.round(x[20:30])
    return data, np.stack([x, y], 1).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True], ids=["all", "point_weights"])
@pytest.mark.parametrize("C", [1, 3])
def test_bilinear_splat_matches_jax(weighted, C):
    rng = np.random.default_rng(C)
    H, W, N = 13, 17, 400
    data, coords = _splat_inputs(rng, N, H, W, C)
    pw = rng.random(N) > 0.3 if weighted else None
    want = jax_splat(jnp.asarray(data), jnp.asarray(coords), (H, W),
                     None if pw is None else jnp.asarray(pw))
    got = bilinear_splat(torch.from_numpy(data), torch.from_numpy(coords), (H, W),
                         None if pw is None else torch.from_numpy(pw))
    for g, w in zip(got, want):
        _assert_splat_close(g.numpy(), w)


def test_far_border_point_splats_nothing():
    """JAX's border rule: a point clamped onto the far border has zero weight."""
    data = torch.ones((2, 1))
    coords = torch.tensor([[4.0, 1.5], [1.5, 7.0]])
    grid, counts = bilinear_splat(data, coords, (5, 5))
    assert float(counts.sum()) == 0.0 and float(grid.abs().sum()) == 0.0


def _flow(rng, H, W, scale=3.0):
    return rng.normal(0.0, scale, (H, W, 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["grey", "color_mask", "color_mask_border"])
def test_warp_forward_image_matches_jax(case):
    rng = np.random.default_rng(7)
    H, W = 24, 31
    img = (rng.random((H, W) if case == "grey" else (H, W, 3)) * 255).astype(np.float32)
    flow = _flow(rng, H, W)
    mask = None if case == "grey" else rng.random((H, W)) > 0.4
    border = 11.0 if case.endswith("border") else None
    want = jax_warp_forward(jnp.asarray(img), jnp.asarray(flow),
                            None if mask is None else jnp.asarray(mask), border=border)
    got = warp_forward_image(torch.from_numpy(img), torch.from_numpy(flow),
                             None if mask is None else torch.from_numpy(mask), border=border)
    _assert_splat_close(got.numpy(), want)


def _flowous(rng, H, W):
    flow = _flow(rng, H, W)
    occl = rng.random((H, W)).astype(np.float32)
    sigma = rng.random((H, W)).astype(np.float32) * 4
    return (JaxFlowOU(jnp.asarray(flow), jnp.asarray(occl), jnp.asarray(sigma)),
            FlowOU(torch.from_numpy(flow), torch.from_numpy(occl), torch.from_numpy(sigma)))


def test_flowou_warp_forward_matches_jax():
    """Arrays in (as the demo passes them), a tensor on the flow's device out."""
    rng = np.random.default_rng(3)
    H, W = 20, 28
    jr, tr = _flowous(rng, H, W)
    edit = (rng.random((H, W, 3)) * 255).astype(np.float32)
    mask = rng.random((H, W)) > 0.5
    got = tr.warp_forward(edit, mask=mask, border=0.0)
    assert isinstance(got, torch.Tensor) and got.device == tr.flow.device
    _assert_splat_close(got.numpy(), jr.warp_forward(jnp.asarray(edit),
                                                     mask=jnp.asarray(mask), border=0.0))
    got = tr.warp_forward(mask.astype(np.float32)[..., None])
    _assert_splat_close(got.numpy(), jr.warp_forward(jnp.asarray(mask.astype(np.float32)[..., None])))


def _border_points(H, W):
    """Every kind of center within 3 px of each border, rounding halves, and
    points just outside."""
    xs = [-0.6, -0.5, -0.4, 0.0, 0.5, 1.5, 2.5, 3.0, W / 2 + 0.5,
          W - 4.0, W - 3.5, W - 2.0, W - 1.0, W - 0.6, W - 0.5, W + 0.2]
    ys = [-0.6, -0.4, 0.0, 1.0, 2.5, 3.0, H / 2, H - 3.5, H - 2.0, H - 1.0, H - 0.5, H + 1]
    xg, yg = np.meshgrid(np.asarray(xs, np.float32), np.asarray(ys, np.float32))
    return np.stack([xg.reshape(-1), yg.reshape(-1)], 1)


@pytest.mark.parametrize("shape", [(20, 24), (9, 7)])
def test_draw_dots_bit_for_bit_with_jax(shape):
    rng = np.random.default_rng(1)
    H, W = shape
    frame = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    coords = _border_points(H, W)
    occl = rng.random(len(coords)).astype(np.float32)
    got = demo.draw_dots(frame, coords, occl)
    want = jax_demo.draw_dots(frame, coords, occl)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # one dot alone: the disc of cv2.circle(..., 3, color, -1)
    one = demo.draw_dots(np.zeros((9, 9, 3), np.uint8), np.array([[4.0, 4.0]]), [0.0])
    assert int((one[..., 1] == 255).sum()) == 29
    assert np.array_equal(one, jax_demo.draw_dots(np.zeros((9, 9, 3), np.uint8),
                                                  np.array([[4.0, 4.0]]), [0.0]))


@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (512, 512)])
def test_default_edit_is_jax_rectangle(monkeypatch, shape):
    """JAX's edit without its text label (no font here): pixel for pixel."""
    monkeypatch.setattr(cv2, "putText", lambda *a, **k: None)
    frame = np.zeros((*shape, 3), np.uint8)
    assert np.array_equal(demo.make_default_edit(frame), jax_demo.make_default_edit(frame))


def test_render_frame_matches_jax_composition():
    """convert_to_point_tracking + draw_dots + draw_edit on the same FlowOU
    arrays: the tracks within 1e-4 px, the dots bit for bit, the edit image
    within 1 level (0 expected: the CPU splat adds in JAX's order)."""
    rng = np.random.default_rng(5)
    H, W = 64, 96
    jr, tr = _flowous(rng, H, W)
    frame = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    queries = demo.get_queries(frame.shape, 10)
    assert np.array_equal(queries, jax_demo.get_queries(frame.shape, 10))
    edit = demo.make_default_edit(frame)
    edit_mask = edit.any(axis=2)
    dots, edited, coords, occl = demo.render_frame(frame, tr, queries, edit, edit_mask)
    jc, jo = jax_points(jr, jnp.asarray(queries))
    jc, jo = np.asarray(jc), np.asarray(jo)
    np.testing.assert_allclose(coords, jc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(occl, jo, rtol=0, atol=1e-6)
    assert np.array_equal(dots, jax_demo.draw_dots(frame, jc, jo))
    want = jax_demo.draw_edit(frame, jr, edit, edit_mask)
    assert np.abs(edited.astype(int) - want).max() <= 1
    assert np.array_equal(edited, want)


def test_flow_panel_matches_jax():
    rng = np.random.default_rng(2)
    H, W = 16, 24
    frame = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    flow = _flow(rng, H, W)
    extra = {"occlusion": rng.random((H, W)).astype(np.float32) * 1.2 - 0.1,
             "sigma": rng.random((H, W)).astype(np.float32) * 5}
    for e in (None, extra):
        got = flow_demo.flow_panel(frame, flow, e)
        want = jax_flow_demo.flow_panel(frame, flow, e)
        assert got.shape == (H * (2 if e is None else 3), W, 3)
        assert np.array_equal(got, want)


def _write_clip(path, n=3, H=128, W=128, seed=0):
    """A random texture under a (2, 1) px shift, as port-written PNG frames."""
    rng = np.random.default_rng(seed)
    tex = (rng.random((H + 2 * n, W + 2 * n, 3)) * 255).astype(np.uint8)
    path.mkdir()
    frames = [np.ascontiguousarray(tex[k:k + H, 2 * k:2 * k + W]) for k in range(n)]
    for k, f in enumerate(frames):
        (path / f"{k:03d}.png").write_bytes(encode_png(f))
    return frames


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """Both apps on demo_cpu at 128x128, 3 frames, on the CPU."""
    tmp = tmp_path_factory.mktemp("apps")
    frames = _write_clip(tmp / "clip")
    n = demo.main(["--video", str(tmp / "clip"), "--config", "demo_cpu", "--out",
                   str(tmp / "out"), "--grid_spacing", "20", "--device", "cpu"])
    m = flow_demo.main(["--video", str(tmp / "clip"), "--config", "demo_cpu", "--out",
                        str(tmp / "flow"), "--show_ou", "--mp4", "--device", "cpu"])
    return frames, n, m, tmp


def _mp4_bytes(path, frames, fps):
    """The port's writer's bytes for ``frames`` at ``fps``."""
    with video.VideoWriter(path, fps=fps, device="cpu") as w:
        for f in frames:
            w.write(f)
    return path.read_bytes()


def _cv2_read(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def test_demo_run_matches_direct_tracker(demo_runs):
    """The demo's ``<name>_points.mp4`` and ``<name>_edit.mp4`` equal, byte
    for byte, the port's writer on a direct port MFT run plus
    convert_to_point_tracking and the drawing functions; cv2 reads both
    back, 3 frames each."""
    frames, n, _, tmp = demo_runs
    assert n == 3
    conf = demo_cpu_config()
    tracker = conf.tracker_class(conf, device="cpu")
    queries = demo.get_queries(frames[0].shape, 20)
    edit = demo.make_default_edit(frames[0])
    pts, edits = [], []
    for i, frame in enumerate(frames):
        result = (tracker.init(frame) if i == 0 else tracker.track(frame)).result
        coords, occl = convert_to_point_tracking(result, queries)
        pts.append(demo.draw_dots(frame, coords, occl))
        edits.append(demo.draw_edit(frame, result, edit, edit.any(axis=2)))
    for name, want in (("points", pts), ("edit", edits)):
        path = tmp / "out" / f"clip_{name}.mp4"
        assert path.read_bytes() == _mp4_bytes(tmp / f"want_{name}.mp4", want, 25.0), name
        back = _cv2_read(path)
        assert len(back) == 3 and back[0].shape == (128, 128, 3)
        assert all(np.array_equal(a, b) for a, b in zip(
            back, video.get_video_frames(path, device="cpu")))


def test_flow_demo_run_matches_direct_flow(demo_runs):
    frames, _, m, tmp = demo_runs
    assert m == 2
    conf = demo_cpu_config()
    flower = conf.flow_config.of_class(conf.flow_config, device="cpu")
    panels = []
    for k in range(2):
        flow, extra = flower.compute_flow(frames[k], frames[k + 1], numpy_out=True)
        want = flow_demo.flow_panel(frames[k], flow, extra)
        assert want.shape == (3 * 128, 128, 3)
        assert np.array_equal(cv2.imread(str(tmp / "flow" / f"flow_{k:04d}.png")), want)
        panels.append(want)
    path = tmp / "flow" / "flow.mp4"
    assert path.read_bytes() == _mp4_bytes(tmp / "want_flow.mp4", panels, 10.0)
    assert len(_cv2_read(path)) == 2


def test_demo_on_mp4_matches_png_directory(tmp_path):
    """The demo on an ``.mp4`` (the port's writer) tracks and renders as on
    the same decoded frames written as a PNG directory: equal output bytes,
    which cv2 reads back."""
    frames = _write_clip(tmp_path / "src")
    (tmp_path / "clip.mp4").write_bytes(_mp4_bytes(tmp_path / "w.mp4", frames, 25.0))
    decoded = list(video.get_video_frames(tmp_path / "clip.mp4", device="cpu"))
    assert np.array_equal(decoded, list(jax_video.get_video_frames(tmp_path / "clip.mp4")))
    (tmp_path / "dir").mkdir()
    for k, f in enumerate(decoded):
        (tmp_path / "dir" / f"{k:03d}.png").write_bytes(encode_png(f))
    for src, out in ((tmp_path / "clip.mp4", "a"), (tmp_path / "dir", "b")):
        assert demo.main(["--video", str(src), "--config", "demo_cpu", "--out",
                          str(tmp_path / out), "--grid_spacing", "20", "--device", "cpu"]) == 3
    for name in ("points", "edit"):
        a = (tmp_path / "a" / f"clip_{name}.mp4").read_bytes()
        assert a == (tmp_path / "b" / f"dir_{name}.mp4").read_bytes()
        assert len(_cv2_read(tmp_path / "a" / f"clip_{name}.mp4")) == 3


def _png_dir(path):
    """PNG frames written by OpenCV (adaptive row filters): colour, grey,
    BGRA and 16-bit, named out of creation order."""
    rng = np.random.default_rng(4)
    path.mkdir()
    imgs = {"b.png": (rng.random((12, 16, 3)) * 255).astype(np.uint8),
            "a.png": (rng.random((12, 16)) * 255).astype(np.uint8),
            "d.PNG": (rng.random((12, 16, 4)) * 255).astype(np.uint8),
            "c.png": (rng.random((12, 16, 3)) * 65535).astype(np.uint16)}
    for name, img in imgs.items():
        assert cv2.imwrite(str(path / name), img)
    (path / "notes.txt").write_text("not a frame")
    return path


@pytest.mark.parametrize("reverse", [False, True])
def test_video_frames_match_jax(tmp_path, reverse):
    d = _png_dir(tmp_path / "frames")
    got = list(video.get_video_frames(d, reverse=reverse))
    want = list(jax_video.get_video_frames(d, reverse=reverse))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)
    assert video.get_video_length(d) == jax_video.get_video_length(d) == 4
    cap, jcap = video.GeneralVideoCapture(d, reverse), jax_video.GeneralVideoCapture(d, reverse)
    cap.read(), jcap.read()
    assert cap.frame_src == jcap.frame_src


def test_lookahead_iter_matches_jax():
    for cls in (video.LookaheadIter, jax_video.LookaheadIter):
        it = cls(range(5))
        assert it.peek() == 0 and next(it) == 0
        assert list(zip(range(2), it.lookahead())) == [(0, 1), (1, 2)]
        assert list(it) == [1, 2, 3, 4]
        assert it.peek(None) is None


def test_video_writer_writes_png_frames(tmp_path):
    """The image-directory writer writes JAX's frames: ``%05d.jpg`` at
    quality 95, byte for byte with ``cv2.imwrite``."""
    rng = np.random.default_rng(6)
    frames = [(rng.random((10, 14, 3)) * 255).astype(np.uint8) for _ in range(2)]
    with video.VideoWriter(tmp_path / "out", device="cpu") as w, \
            jax_video.VideoWriter(tmp_path / "jax") as jw:
        for f in frames:
            w.write(f)
            jw.write(f)
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["00000.jpg",
                                                                             "00001.jpg"]
    for name in names:
        assert (tmp_path / "out" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_video_codecs_raise(tmp_path):
    """What the port's video I/O does not read yet raises, naming its ROADMAP
    item: an H.264 ('avc1') track, a file of no container it knows (a RIFF
    that is not AVI), a writer for an MPEG program stream, a B-VOP."""
    from mft_tpu_torch.io import mpeg4
    from mft_tpu_torch.io.mp4 import Mp4Writer
    data = _mp4_bytes(tmp_path / "ok.mp4", [np.zeros((16, 16, 3), np.uint8)] * 2, 25.0)
    i = data.index(b"mp4v", data.index(b"stsd"))
    (tmp_path / "h264.mp4").write_bytes(data[:i] + b"avc1" + data[i + 4:])
    with pytest.raises(NotImplementedError, match="A11, H.264"):
        video.GeneralVideoCapture(tmp_path / "h264.mp4", device="cpu")
    (tmp_path / "clip.avi").write_bytes(b"RIFF" + bytes(60))
    with pytest.raises(NotImplementedError, match="A11, other containers"):
        video.GeneralVideoCapture(tmp_path / "clip.avi", device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        video.VideoWriter(tmp_path / "out.mpg", device="cpu").write(np.zeros((16, 16, 3), np.uint8))
    vol = mpeg4.Vol(16, 16, 25)
    bw = mpeg4.BitWriter()
    mpeg4.write_vop_header(bw, vol, [2, 1, 0, 4, 1, 0, 0, 0])
    bw.stuff()
    with Mp4Writer(tmp_path / "b.mp4", 25.0, 16, 16, mpeg4.write_config(vol)) as w:
        w.add(bw.getvalue(), False)
    with pytest.raises(ValueError, match="B-VOPs.*A11"):
        list(video.get_video_frames(tmp_path / "b.mp4", device="cpu"))
    d = tmp_path / "jpg"
    d.mkdir()
    rng = np.random.default_rng(8)
    assert cv2.imwrite(str(d / "0.png"), (rng.random((4, 4, 3)) * 255).astype(np.uint8))
    assert cv2.imwrite(str(d / "1.jpg"), (rng.random((4, 4, 3)) * 255).astype(np.uint8))
    got = list(video.get_video_frames(d, device="cpu"))
    want = list(jax_video.get_video_frames(d))
    assert len(got) == len(want) == 2
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_demo_defaults_to_the_card():
    args = demo.get_parser().parse_args(["--video", "x"])
    assert args.device == "cuda" and args.config == "default"
    assert flow_demo.get_parser().parse_args(["--video", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            conf = demo_cpu_config()
            conf.tracker_class(conf, device=args.device)
