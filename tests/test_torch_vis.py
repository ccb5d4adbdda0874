"""The port's visualization helpers (``mft_tpu_torch/utils/vis.py``) against
the JAX package's (``mft_tpu/utils/vis.py``), which call OpenCV, on seeded
inputs, bit for bit; and the OpenCV operations the port writes in numpy
(grey, HSV both ways, the VIRIDIS map, remap, resize, equalizeHist,
addWeighted) against cv2 itself, over every 8-bit colour where the input is
a pixel, and over sizes whose pixel counts end OpenCV's vector loops at
every remainder.
"""

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.utils import vis as jv
from mft_tpu_torch.train.augment import hsv_to_rgb, rgb_to_hsv
from mft_tpu_torch.utils import vis as tv


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers
    share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _img(rng, H, W, C=3):
    return rng.integers(0, 256, (H, W, C) if C else (H, W), dtype=np.uint8)


def _flow(rng, H, W, scale=4.0):
    return (rng.normal(0, scale, (H, W, 2))).astype(np.float32)


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


ALL_COLOURS = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                                   indexing="ij"), -1).astype(np.uint8).reshape(4096, 4096, 3)
# row widths: remainders of OpenCV's 32-pixel vector loop (rows convert one by one)
SIZES = [(1, 1), (1, 31), (1, 33), (5, 7), (8, 8), (13, 21), (37, 53), (64, 48), (3, 100)]


# -- OpenCV's operations against cv2 ------------------------------------------ #

def test_grey_and_hsv_of_every_colour():
    """Grey, and the HSV conversions the helpers take from train/augment.py,
    over every 8-bit colour (rows of 4096 pixels: OpenCV's vector loop),
    256 rows at a time (each row converts on its own; this keeps the
    temporaries to a few hundred MB)."""
    for rows in np.split(ALL_COLOURS, 16):
        _eq(tv.bgr_to_gray(rows), cv2.cvtColor(rows, cv2.COLOR_BGR2GRAY))
        _eq(rgb_to_hsv(rows), cv2.cvtColor(rows, cv2.COLOR_RGB2HSV))
        hsv = rows.copy()
        hsv[..., 0] %= 180
        _eq(hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_opencv_pixel_ops_at_every_vector_remainder(size):
    """HSV -> BGR takes OpenCV's vector arithmetic for whole groups of 32
    pixels of a row and its scalar arithmetic for the rest; the other
    operations agree in both loops."""
    rng = np.random.default_rng(size[0] * 100 + size[1])
    hsv = _img(rng, *size)
    hsv[..., 0] %= 180
    _eq(hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    img = _img(rng, *size)
    _eq(tv.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    _eq(rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    grey = _img(rng, *size, C=0) // 3 + 40
    _eq(tv.equalize_histogram(grey), cv2.equalizeHist(grey))
    _eq(tv.apply_colormap(grey), cv2.applyColorMap(grey, cv2.COLORMAP_VIRIDIS))
    other = _img(rng, *size)
    for alpha in (0.5, 0.3, 0.71, 0.123):
        _eq(tv.add_weighted(img, alpha, other, 1 - alpha),
            cv2.addWeighted(img, alpha, other, 1 - alpha, 0))


def test_equalize_hist_flat_image():
    g = np.full((9, 11), 77, np.uint8)
    _eq(tv.equalize_histogram(g), cv2.equalizeHist(g))


@pytest.mark.parametrize("size", [(40, 56), (33, 71), (7, 5), (128, 96)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_remap_matches_opencv(size, channels):
    """Float maps, constant border: INTER_LINEAR of uint8 with taps outside
    the image among them, INTER_NEAREST with maps at .5 exactly."""
    rng = np.random.default_rng(size[0] + channels)
    img = _img(rng, *size, C=channels if channels > 1 else 0)
    ys, xs = np.mgrid[0:size[0], 0:size[1]].astype(np.float32)
    flow = _flow(rng, *size, scale=3.0)
    mx, my = xs + flow[..., 0], ys + flow[..., 1]
    for interp in (cv2.INTER_LINEAR, cv2.INTER_NEAREST):
        want = cv2.remap(img, mx, my, interp, borderMode=cv2.BORDER_CONSTANT)
        _eq(tv.remap(img, mx, my, interp), want)
    half_x, half_y = np.floor(mx) + 0.5, np.floor(my) + 0.5
    _eq(tv.remap(img, half_x, half_y, tv.INTER_NEAREST),
        cv2.remap(img, half_x.astype(np.float32), half_y.astype(np.float32), cv2.INTER_NEAREST))


# -- the helpers against JAX's ------------------------------------------------- #

RESIZES = [((37, 53), (80, 100), None), ((64, 64), (47, 30), None), ((50, 70), (35, 50), None),
           ((64, 48), (24, 32), None), ((33, 17), (9, 65), None), ((20, 30), None, (2.5, 1.7)),
           ((21, 31), None, (0.5, 0.5)), ((20, 30), None, (0.5, 0.5)),
           ((40, 40), (40, 40), None)]


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "linear"])
@pytest.mark.parametrize("case", RESIZES, ids=[f"{s}->{d or f}" for s, d, f in RESIZES])
def test_resize_matches_jax(case, interp, align_corners):
    (H, W), dsize, fxy = case
    rng = np.random.default_rng(H * W)
    flag = cv2.INTER_NEAREST if interp == "nearest" else cv2.INTER_LINEAR
    kw = dict(dsize=dsize, interpolation=flag, align_corners=align_corners)
    if fxy:
        kw.update(fx=fxy[0], fy=fxy[1])
    for img in (_img(rng, H, W), _img(rng, H, W, C=0)):
        _eq(tv.resize(img, **kw), jv.resize(img, **kw))
    if interp == "nearest":                   # any dtype
        f = rng.normal(size=(H, W, 2)).astype(np.float32)
        _eq(tv.resize(f, **kw), jv.resize(f, **kw))


def test_resize_other_interpolations_raise():
    img = np.zeros((8, 8, 3), np.uint8)
    for flag in (cv2.INTER_CUBIC, cv2.INTER_AREA, cv2.INTER_LANCZOS4):
        with pytest.raises(NotImplementedError, match="A11"):
            tv.resize(img, (4, 4), interpolation=flag)
    with pytest.raises(NotImplementedError, match="A11"):
        tv.apply_colormap(img[..., 0], cv2.COLORMAP_JET)


@pytest.mark.parametrize("size", [(24, 30), (37, 53), (1, 33)])
def test_flow_and_colour_helpers_match_jax(size):
    rng = np.random.default_rng(size[1])
    H, W = size
    flow, img = _flow(rng, H, W), _img(rng, H, W)
    _eq(tv.flow_to_color(flow), jv.flow_to_color(flow))
    _eq(tv.flow_to_color(flow, clip_flow=3.0, convert_to_bgr=True, rad_max=5.0),
        jv.flow_to_color(flow, clip_flow=3.0, convert_to_bgr=True, rad_max=5.0))
    _eq(tv.vis_flow(flow), jv.vis_flow(flow))
    _eq(tv.vis_flow(flow, img, alpha=0.3, rad_max=6.0), jv.vis_flow(flow, img, alpha=0.3,
                                                                     rad_max=6.0))
    for max_flow in (None, 3.0, 1e9):        # over-range pixels saturated through HSV
        _eq(tv.flow_to_color_matlab(flow, max_flow), jv.flow_to_color_matlab(flow, max_flow))
    _eq(tv.to_gray_3ch(img), jv.to_gray_3ch(img))
    _eq(tv.color_checkerboard(H, W), jv.color_checkerboard(H, W))
    _eq(tv.color_checkerboard(H, W, square=3), jv.color_checkerboard(H, W, square=3))
    scalar = rng.normal(size=(H, W)).astype(np.float32)
    _eq(tv.vis_scalar_map(scalar), jv.vis_scalar_map(scalar))
    _eq(tv.vis_scalar_map(scalar, vmin=-0.5, vmax=0.5), jv.vis_scalar_map(scalar, -0.5, 0.5))
    _eq(tv.colorbar((0, 1)), jv.colorbar((0, 1)))
    _eq(tv.colorbar((0, 1), height=37, width=5), jv.colorbar((0, 1), height=37, width=5))


@pytest.mark.parametrize("size", [(24, 30), (37, 53), (96, 64)])
def test_alignment_helpers_match_jax(size):
    rng = np.random.default_rng(size[0])
    H, W = size
    src, dst, flow = _img(rng, H, W), _img(rng, H, W), _flow(rng, H, W, 5.0)
    for alpha in (0.5, 0.25):
        _eq(tv.vis_flow_align(flow, src, dst, alpha), jv.vis_flow_align(flow, src, dst, alpha))
    for eq in (False, True):
        _eq(tv.vis_alignment_plain(src, dst, eq), jv.vis_alignment_plain(src, dst, eq))
    flat = np.full_like(src, 90)
    _eq(tv.vis_alignment_plain(flat, dst), jv.vis_alignment_plain(flat, dst))


def test_compositing_helpers_match_jax():
    rng = np.random.default_rng(7)
    H, W = 29, 41
    a, b = _img(rng, H, W), _img(rng, H, W)
    amap = rng.random((H, W)).astype(np.float32)
    mask = rng.random((H, W)) > 0.6
    _eq(tv.blend(a, b, 0.35), jv.blend(a, b, 0.35))
    _eq(tv.blend(a, b, amap), jv.blend(a, b, amap))
    _eq(tv.blend(a, b, amap[..., None]), jv.blend(a, b, amap[..., None]))
    _eq(tv.checkerboard(H, W), jv.checkerboard(H, W))
    _eq(tv.checkerboard(H, W, 5, (10, 250)), jv.checkerboard(H, W, 5, (10, 250)))
    for normal, spacing in (((2, 1), 10), ((1, -3), 6), ((0, 1), 4)):
        _eq(tv.hatch_pattern((H, W), normal, spacing), jv.hatch_pattern((H, W), normal, spacing))
        _eq(tv.hatch_overlay(a, mask, (10, 20, 30), 0.7, spacing, normal),
            jv.hatch_overlay(a, mask, (10, 20, 30), 0.7, spacing, normal))
    _eq(tv.blend_mask(a, mask), jv.blend_mask(a, mask))
    _eq(tv.blend_mask(a, mask, (255, 0, 9), 0.2), jv.blend_mask(a, mask, (255, 0, 9), 0.2))
    _eq(tv.blend_with_alpha(a, b, amap), jv.blend_with_alpha(a, b, amap))
    _eq(tv.blend_with_alpha_premult(a // 2, b, amap), jv.blend_with_alpha_premult(a // 2, b, amap))
    images = [_img(rng, 10, 12) for _ in range(5)]
    _eq(tv.image_grid(images), jv.image_grid(images))
    _eq(tv.image_grid(images, cols=2, pad=3, pad_value=200),
        jv.image_grid(images, cols=2, pad=3, pad_value=200))
    grid = [images[:3], images[2:]]
    _eq(tv.tile_images(grid), jv.tile_images(grid))
    _eq(tv.tile_images(grid, h_space=4, w_space=2, bg_color=128),
        jv.tile_images(grid, h_space=4, w_space=2, bg_color=128))
    canvas_t, canvas_j = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
    tv.place_img_at(images[0], canvas_t, 7, 30)
    jv.place_img_at(images[0], canvas_j, 7, 30)
    _eq(canvas_t, canvas_j)
    for text, n, keep in (("short", 10, "right"), ("a_rather_long_name.png", 12, "right"),
                          ("a_rather_long_name.png", 12, "left"), ("abcdefghij", 6, "left")):
        assert tv.shorten_text(text, n, keep) == jv.shorten_text(text, n, keep)
    with pytest.raises(ValueError):
        tv.shorten_text("a_rather_long_name.png", 5, "middle")
    for alpha in (0.5, 0.3, 0.85):
        got = tv.OverlayBackground(a, b).overlay(b, a, alpha=alpha)
        want = jv.OverlayBackground(a, b).overlay(b, a, alpha=alpha)
        for g, w in zip(got, want):
            _eq(g, w)


def test_knn_interp_matches_jax():
    rng = np.random.default_rng(3)
    db = rng.random((60, 2)) * 50
    vals = rng.normal(size=60)
    queries = rng.random((25, 2)) * 60
    t, j = tv.make_knn_interp(db, vals), jv.make_knn_interp(db, vals)
    for K, max_dist, min_k in ((1, None, None), (4, None, None), (4, 6.0, None), (5, 8.0, 3)):
        np.testing.assert_array_equal(t(queries, K, max_dist, min_k), j(queries, K, max_dist, min_k))
