"""Visualization helpers: the flow colorwheel, compositing, layout, colour
maps and resampling, in numpy on the host as the JAX package runs them.

A port of ``mft_tpu/utils/vis.py`` (reference MFT/utils/vis_utils.py and
MFT/RAFT/core/utils/flow_viz.py) without OpenCV. Its pure-numpy helpers are
copied; the OpenCV calls they make are numpy code here that follows
OpenCV's own arithmetic, bit for bit with the JAX functions under the
OpenCV build of the test machine (``tests/test_torch_vis.py``):

- ``cvtColor`` BGR -> GRAY: 15-bit fixed point (3735, 19235, 9798), rounded;
- HSV <-> RGB (uint8, hue 0..180): ``train/augment.py``'s ``hsv_to_rgb``
  and ``rgb_to_hsv`` (OpenCV's integer tables one way; its float sector
  formula the other, truncated in its vector loop's blocks of 32 pixels of
  a row and rounded in the rest);
- ``applyColorMap(COLORMAP_VIRIDIS)``: :data:`VIRIDIS_BGR`, OpenCV's
  256-entry table, read once from cv2 and written here as constants;
- ``remap`` INTER_LINEAR (float maps, constant border 0): float32 weights
  ``x - floor(x)``, each pair of taps mixed by a fused multiply-add, rows
  first, rounded; INTER_NEAREST: the map rounded half to even;
- ``resize``: INTER_NEAREST ``floor(x / scale)``; INTER_LINEAR on uint8
  OpenCV's 11-bit fixed-point weights (``eval/tapvid.py``), a scale of
  exactly 2 on both sides as INTER_AREA's 2 x 2 mean;
- ``equalizeHist``: the cumulative histogram times ``255 / (total - the
  first bin's count)`` in float32, rounded;
- ``addWeighted`` (gamma 0): ``a * alpha + b * beta`` in float32 by fused
  multiply-adds, rounded.

The helpers that draw (lines, circles, polylines, dots, tracks, boxes,
markers) need OpenCV's anti-aliased rasterizer, and ``draw_text`` /
``name_images`` its Hershey font; ``FlowGUI`` needs a window. They are not
here (ROADMAP A11).
"""

import numpy as np

from mft_tpu_torch.train.augment import hsv_to_rgb, rgb_to_hsv

# cv2's enum values, so that callers may pass either
INTER_NEAREST, INTER_LINEAR = 0, 1
COLORMAP_VIRIDIS = 16

# OpenCV's COLORMAP_VIRIDIS table, BGR: read once from cv2 5.0.0
# (``cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], COLORMAP_VIRIDIS)``)
VIRIDIS_BGR = np.frombuffer(bytes.fromhex(
    "5401445602445704455905455a07465c08465d0a465e0b46600d47610e476310476411476513476714486816"
    "486917486a18486c1a486d1b486e1c486f1d48701f4871204873214874234875244876254877264878284879"
    "29487a2a477a2c477b2d477c2e477d2f477e30467e32467f3346803446813545813745823845833944833a44"
    "843b44843d43853e43853f4286404286414287424187444188454088464088473f89483f89493e894a3e8a4c"
    "3e8a4d3d8a4e3d8a4f3c8b503c8b513b8b523b8b533a8c543a8c55398c56398c58388c59388c5a378d5b378d"
    "5c368d5d368d5e358d5f358d60348d61348d62338d63338e64328e65328e66318e67318e68318e69308e6a30"
    "8e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c8e722c8e732c8e742b8e752b8e762a8e772a8e78"
    "2a8e79298e7a298e7b298e7c288e7d288e7e278e7f278e80278e81268e82268e82268e83258e84258e85258e"
    "86248e87248e88238e89238d8a238d8b228d8c228d8d228d8e218d8f218d90218c91218c92208c92208c9320"
    "8c941f8b951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f88a01f88a11f87a1"
    "1f87a21f86a32086a42085a52185a62185a72284a82283a92383aa2482ab2582ac2581ad2681ad2780ae287f"
    "af297fb02a7eb12c7db22d7cb32e7cb42f7bb5317ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d"
    "73bc3f72bd4071be4270bf446fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c8"
    "5a63c85c62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d17751d17a50"
    "d27c4ed37f4dd3814bd48449d58648d58946d68b45d68e43d79041d79340d8953ed8983cd99b3bd99d39daa0"
    "37daa236dba534dba832dcaa30dcad2fddb02dddb22bdeb529deb828deba26dfbd25dfc023dfc221e0c520e0"
    "c81fe1ca1de1cd1ce1d01be2d21ae2d519e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1c"
    "e5ef1de5f11ee6f420e6f621e6f823e7fb25e7fd"), np.uint8).reshape(256, 3)


def _make_colorwheel():
    """55-color wheel (RY/YG/GC/CB/BM/MR ramps), rows = colors, cols = RGB."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False), (YG, 1, 0, True), (GC, 1, 2, False),
        (CB, 2, 1, True), (BM, 2, 0, False), (MR, 0, 2, True),
    ]
    for n, c_full, c_ramp, down in ramps:
        wheel[col:col + n, c_full] = 255
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, c_ramp] = 255 - ramp if down else ramp
        col += n
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_color(flow, clip_flow=None, convert_to_bgr=False, rad_max=None):
    """(H, W, 2) flow -> (H, W, 3) uint8 colorwheel visualization.

    Reference parity: flow_viz.py flow_to_color (magnitude-normalized hue
    encoding; unnormalized radius saturates toward white).
    """
    flow = np.asarray(flow, np.float32)
    if clip_flow is not None:
        flow = np.clip(flow, -clip_flow, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if rad_max is None:
        rad_max = max(float(rad.max()), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    ncols = _COLORWHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = _COLORWHEEL[k0, c] / 255.0
        col1 = _COLORWHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate small flows toward white
        ch = 2 - c if convert_to_bgr else c
        img[..., ch] = np.floor(255 * col)
    return img


# -- colour conversions (OpenCV's arithmetic) ---------------------------------- #

_F32 = np.float32


def _fma(a, b, c):
    """float32 a * b + c rounded once (float64 holds the product exactly)."""
    return (np.asarray(a, np.float64) * b + c).astype(_F32)


def bgr_to_gray(img) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2GRAY)`` of uint8 BGR."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(np.uint8)


def equalize_histogram(gray) -> np.ndarray:
    """``cv2.equalizeHist`` of a uint8 image."""
    gray = np.asarray(gray, np.uint8)
    hist = np.bincount(gray.ravel(), minlength=256)
    first = int(np.flatnonzero(hist)[0]) if gray.size else 0
    if gray.size == 0 or hist[first] == gray.size:
        return np.full_like(gray, first)
    scale = _F32(255.0 / (gray.size - hist[first]))
    lut = np.zeros(256, np.uint8)
    cum = np.cumsum(hist[first + 1:])
    lut[first + 1:] = np.clip(np.rint(cum.astype(_F32) * scale), 0, 255)
    return lut[gray]


def add_weighted(a, alpha, b, beta) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, 0)`` of uint8 arrays."""
    t = _fma(np.asarray(b, _F32), _F32(beta), _F32(0.0))
    out = _fma(np.asarray(a, _F32), _F32(alpha), t)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def apply_colormap(gray, cmap=COLORMAP_VIRIDIS) -> np.ndarray:
    """``cv2.applyColorMap(gray, cmap)`` of uint8 grey: (..., 3) BGR."""
    if cmap != COLORMAP_VIRIDIS:
        raise NotImplementedError(f"colour map {cmap}: only COLORMAP_VIRIDIS is ported "
                                  "(ROADMAP A11)")
    return VIRIDIS_BGR[np.asarray(gray, np.uint8)]


# -- resampling (OpenCV's arithmetic) -------------------------------------------- #

def remap(src, map_x, map_y, interpolation=INTER_LINEAR) -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, interpolation,
    borderMode=BORDER_CONSTANT)`` (border value 0) with float32 maps:
    INTER_LINEAR of uint8, INTER_NEAREST of any dtype."""
    src = np.asarray(src)
    mx, my = np.asarray(map_x, _F32), np.asarray(map_y, _F32)
    H, W = src.shape[:2]
    planar = src.ndim == 2
    s = src[..., None] if planar else src
    if interpolation == INTER_NEAREST:
        ix, iy = np.rint(mx).astype(np.int64), np.rint(my).astype(np.int64)
        ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        out = s[np.clip(iy, 0, H - 1), np.clip(ix, 0, W - 1)] * ok[..., None]
        out = out.astype(src.dtype)
    elif interpolation == INTER_LINEAR:
        if src.dtype != np.uint8:
            raise NotImplementedError("remap INTER_LINEAR of uint8 only (ROADMAP A11)")
        fx, fy = np.floor(mx), np.floor(my)
        a, b = (mx - fx).astype(_F32)[..., None], (my - fy).astype(_F32)[..., None]
        ix, iy = fx.astype(np.int64), fy.astype(np.int64)
        sf = s.astype(_F32)

        def tap(dx, dy):
            xx, yy = ix + dx, iy + dy
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            return sf[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)] * ok[..., None]

        p00, p01, p10, p11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
        v0 = _fma(a, p01 - p00, p00)
        v1 = _fma(a, p11 - p10, p10)
        out = np.clip(np.rint(_fma(b, v1 - v0, v0)), 0, 255).astype(np.uint8)
    else:
        raise NotImplementedError(f"remap interpolation {interpolation}: INTER_NEAREST and "
                                  "INTER_LINEAR are ported (ROADMAP A11)")
    return out[..., 0] if planar else out


def resize(src, dsize=None, fx=None, fy=None, interpolation=INTER_LINEAR,
           align_corners=False):
    """cv2.resize with an optional align_corners=True mode.

    align_corners resizing maps corner pixel CENTERS onto each other
    (torch interpolate semantics) instead of area edges; the reference
    implements it by remap with an explicit grid (vis_utils.py resize).
    INTER_NEAREST takes any dtype, INTER_LINEAR uint8; other
    interpolations raise ``NotImplementedError`` (ROADMAP A11).
    """
    src = np.asarray(src)
    if interpolation not in (INTER_NEAREST, INTER_LINEAR):
        raise NotImplementedError(f"resize interpolation {interpolation}: INTER_NEAREST and "
                                  "INTER_LINEAR are ported (ROADMAP A11)")
    H, W = src.shape[:2]
    if align_corners:
        if dsize is None:
            dsize = (int(round(W * fx)), int(round(H * fy)))
        out_w, out_h = dsize
        xs = np.linspace(0, W - 1, out_w, dtype=np.float32)
        ys = np.linspace(0, H - 1, out_h, dtype=np.float32)
        map_x, map_y = np.meshgrid(xs, ys)
        return remap(src, map_x, map_y, interpolation)
    if dsize is None or tuple(dsize) == (0, 0):
        inv_x, inv_y = float(fx), float(fy)
        out_w, out_h = int(np.rint(W * inv_x)), int(np.rint(H * inv_y))
    else:
        out_w, out_h = dsize
        inv_x, inv_y = out_w / W, out_h / H
    if interpolation == INTER_NEAREST:
        sx = np.minimum(np.floor(np.arange(out_w) * (1.0 / inv_x)).astype(np.int64), W - 1)
        sy = np.minimum(np.floor(np.arange(out_h) * (1.0 / inv_y)).astype(np.int64), H - 1)
        return np.ascontiguousarray(src[sy][:, sx])
    if src.dtype != np.uint8:
        raise NotImplementedError("resize INTER_LINEAR of uint8 only (ROADMAP A11)")
    from mft_tpu_torch.eval.tapvid import _resize_linear
    frame = src[..., None] if src.ndim == 2 else src
    if (out_w, out_h) == (W, H):
        out = frame.copy()
    elif 1.0 / inv_x == 2 and 1.0 / inv_y == 2:
        out = _halve(frame, out_h, out_w)        # OpenCV takes INTER_AREA's 2 x 2 mean
    else:
        out = _resize_linear(frame, out_h, out_w, 1.0 / inv_x, 1.0 / inv_y)
    return out[..., 0] if src.ndim == 2 else out


def _halve(frame, out_h, out_w):
    """OpenCV's resizeAreaFast at scale 2 of uint8 (H, W, C): each whole
    2 x 2 block (sum + 2) >> 2, the blocks that the image cuts (an odd side)
    the mean of their pixels inside it, rounded half to even."""
    H, W, C = frame.shape
    h2, w2 = H // 2, W // 2
    src = frame.astype(np.int64)
    out = np.zeros((out_h, out_w, C), np.uint8)
    full = src[:2 * h2, :2 * w2].reshape(h2, 2, w2, 2, C).sum(axis=(1, 3))
    out[:min(h2, out_h), :min(w2, out_w)] = ((full + 2) >> 2)[:out_h, :out_w]
    for dy in range(out_h):
        for dx in range(out_w):
            if dy < h2 and dx < w2:
                continue
            block = src[2 * dy:2 * dy + 2, 2 * dx:2 * dx + 2].reshape(-1, C)
            if len(block):
                mean = block.sum(axis=0).astype(np.float32) / np.float32(len(block))
                out[dy, dx] = np.clip(np.rint(mean), 0, 255)
    return out


# -- overlays and compositing ----------------------------------------------------- #

def vis_flow(flow, img=None, alpha=0.6, rad_max=None):
    """Dense flow color overlaid on an optional BGR image."""
    color = flow_to_color(flow, convert_to_bgr=True, rad_max=rad_max)
    if img is None:
        return color
    return blend(img, color, alpha)


def blend(img_a, img_b, alpha):
    """alpha*b + (1-alpha)*a; alpha scalar or (H, W)/(H, W, 1) map."""
    a = np.asarray(img_a, np.float32)
    b = np.asarray(img_b, np.float32)
    if np.ndim(alpha) == 2:
        alpha = alpha[..., None]
    out = a * (1 - alpha) + b * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


def checkerboard(H, W, square=8, colors=(200, 120)):
    """(H, W) uint8 checkerboard (background for alpha visualization)."""
    ys, xs = np.mgrid[0:H, 0:W]
    cells = ((ys // square) + (xs // square)) % 2
    return np.where(cells == 0, colors[0], colors[1]).astype(np.uint8)


def image_grid(images, cols=None, pad=2, pad_value=0):
    """Tile equally-sized (H, W, 3) images into a grid canvas."""
    n = len(images)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    H, W = images[0].shape[:2]
    canvas = np.full((rows * (H + pad) - pad, cols * (W + pad) - pad, 3),
                     pad_value, np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * (H + pad):r * (H + pad) + H,
               c * (W + pad):c * (W + pad) + W] = img
    return canvas


def colorbar(values_range, height=200, width=30, cmap=COLORMAP_VIRIDIS):
    """Vertical colorbar image for scalar-map visualizations."""
    ramp = np.linspace(255, 0, height).astype(np.uint8)[:, None]
    return apply_colormap(np.repeat(ramp, width, axis=1), cmap)


def vis_scalar_map(data, vmin=None, vmax=None, cmap=COLORMAP_VIRIDIS):
    """(H, W) scalar map -> BGR heatmap."""
    data = np.asarray(data, np.float32)
    vmin = float(data.min()) if vmin is None else vmin
    vmax = float(data.max()) if vmax is None else vmax
    norm = (data - vmin) / max(vmax - vmin, 1e-9)
    return apply_colormap((np.clip(norm, 0, 1) * 255).astype(np.uint8), cmap)


# -- hatching (reference cv2_hatch / hatch_pattern) --------------------------- #

def hatch_pattern(shape, normal=(2, 1), spacing=10):
    """Boolean diagonal-stripe pattern; ``normal`` is the stripe normal."""
    H, W = shape[:2]
    ys, xs = np.mgrid[0:H, 0:W]
    proj = xs * normal[0] + ys * normal[1]
    period = spacing * float(np.hypot(*normal))
    return (proj % period) < max(np.hypot(*normal), 1.0)


def hatch_overlay(img, mask, color=(0, 0, 0), alpha=1.0, spacing=10,
                  normal=(2, 1)):
    """Draw diagonal hatching over the masked region of a BGR image."""
    stripes = hatch_pattern(img.shape, normal=normal, spacing=spacing)
    sel = np.logical_and(np.asarray(mask, bool), stripes)
    out = img.astype(np.float32).copy()
    out[sel] = (1 - alpha) * out[sel] + alpha * np.asarray(color, np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


# -- mask / alpha compositing (reference blend_mask / blend_with_alpha) ------- #

def blend_mask(img, mask, color=(0, 255, 0), alpha=0.5):
    """Tint the masked region with a color."""
    out = img.astype(np.float32).copy()
    m = np.asarray(mask, bool)
    out[m] = (1 - alpha) * out[m] + alpha * np.asarray(color, np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def blend_with_alpha(img1, img2, img1_alpha):
    """Per-pixel alpha composite: img1 over img2 with (H, W) alpha."""
    a = np.asarray(img1_alpha, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    out = img1.astype(np.float32) * a + img2.astype(np.float32) * (1 - a)
    return np.clip(out, 0, 255).astype(np.uint8)


def blend_with_alpha_premult(img1_premult, img2, img1_alpha):
    """Premultiplied-alpha composite (img1 already multiplied by alpha)."""
    a = np.asarray(img1_alpha, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    out = img1_premult.astype(np.float32) + img2.astype(np.float32) * (1 - a)
    return np.clip(out, 0, 255).astype(np.uint8)


def to_gray_3ch(img):
    """BGR -> 3-channel grayscale (for alignment overlays)."""
    return np.repeat(bgr_to_gray(img)[..., None], 3, axis=2)


def color_checkerboard(H, W, square=8):
    """BGR checkerboard with a distinct hue per cell (warp debugging)."""
    ys, xs = np.mgrid[0:H, 0:W]
    cy, cx = ys // square, xs // square
    hue = ((cy * 37 + cx * 61) % 180).astype(np.uint8)
    hsv = np.stack([hue, np.full((H, W), 200, np.uint8),
                    np.full((H, W), 230, np.uint8)], axis=-1)
    return np.ascontiguousarray(hsv_to_rgb(hsv)[..., ::-1])


# -- labelled grids (reference griddify / tile) -------------------------------- #

def tile_images(img_grid, h_space=1, w_space=None, bg_color=0):
    """Tile a 2D list of equally-sized images with spacing."""
    w_space = h_space if w_space is None else w_space
    rows = []
    for row in img_grid:
        H = row[0].shape[0]
        spacer = np.full((H, w_space, 3), bg_color, np.uint8)
        parts = []
        for i, img in enumerate(row):
            if i:
                parts.append(spacer)
            parts.append(img)
        rows.append(np.concatenate(parts, axis=1))
    W = rows[0].shape[1]
    vspace = np.full((h_space, W, 3), bg_color, np.uint8)
    out = []
    for i, r in enumerate(rows):
        if i:
            out.append(vspace)
        out.append(r)
    return np.concatenate(out, axis=0)


# -- alignment visualizations ------------------------------------------------- #

def vis_flow_align(flow, src_img, dst_img, alpha=0.5):
    """Warp-alignment check: backward-warp dst by the flow and blend with src.

    A correct flow makes the blend look sharp (reference vis_flow_align).
    """
    H, W = flow.shape[:2]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    map_x = xs + np.asarray(flow, np.float32)[..., 0]
    map_y = ys + np.asarray(flow, np.float32)[..., 1]
    warped = remap(dst_img, map_x, map_y, INTER_LINEAR)
    return blend(to_gray_3ch(src_img), to_gray_3ch(warped), alpha)


# -- matlab-style flow colormap (reference flow_viz.py flow2color_matlab) ----- #

def flow_to_color_matlab(flow, max_flow=None):
    """Middlebury 'matlab-style' variant: like flow_to_color but saturating
    out-of-range magnitudes at full saturation instead of renormalizing."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if max_flow is None:
        max_flow = max(float(rad.max()), 1e-5)
    out = flow_to_color(np.stack([u, v], -1), rad_max=max_flow)
    # saturate over-range pixels fully
    over = rad > max_flow
    if np.any(over):
        hsv = rgb_to_hsv(out)
        hsv[..., 1] = np.where(over, 255, hsv[..., 1])
        out = hsv_to_rgb(hsv)
    return out


def vis_alignment_plain(src, dst, equalize_hist=False):
    """Red/blue=dst-gray, green=src-gray false-color alignment check.

    Reference parity: vis_utils.py:245-266 (per-image min/max normalization
    unless histogram equalization is requested).
    """
    assert src.shape == dst.shape
    sg = bgr_to_gray(src)
    dg = bgr_to_gray(dst)
    if equalize_hist:
        sg = equalize_histogram(sg).astype(np.float32) / 255
        dg = equalize_histogram(dg).astype(np.float32) / 255
    else:
        sg = sg.astype(np.float32) / 255
        dg = dg.astype(np.float32) / 255
        sg = (sg - sg.min()) / max(np.ptp(sg), 1e-12)
        dg = (dg - dg.min()) / max(np.ptp(dg), 1e-12)
    out = np.stack([dg, sg, dg], axis=-1)
    return np.uint8(out * 255)


def place_img_at(img, canvas, tl_row, tl_col):
    """Paste img into canvas at (row, col), in place (vis_utils.py:541-543)."""
    H, W = img.shape[:2]
    canvas[tl_row:tl_row + H, tl_col:tl_col + W, :] = img


def shorten_text(text, max_len, keep="right"):
    """Ellipsis-shorten a string keeping its right or left end
    (vis_utils.py:347-357)."""
    if len(text) <= max_len:
        return text
    margin = 3 if max_len > 8 else 0
    if keep == "right":
        return "." * margin + text[-(max_len - margin):]
    if keep == "left":
        return text[: max_len - margin] + "." * margin
    raise ValueError("Invalid 'keep' value")


class OverlayBackground:
    """Blend images-after-drawing back over their saved originals.

    Reference parity: vis_utils.py:1167-1185 — snapshot backgrounds at
    construction, then ``overlay(imgs, alpha)`` mixes each drawn-on image
    with its original.
    """

    def __init__(self, *background_images):
        self.backgrounds_copy = [img.copy() for img in background_images]

    def overlay(self, *overlay_images, alpha=0.5):
        return [add_weighted(ov, alpha, bg, 1 - alpha)
                for ov, bg in zip(overlay_images, self.backgrounds_copy)]


def make_knn_interp(db_xy, db_values):
    """K-NN interpolator factory (reference vis_utils.py:661-703).

    returns interp(query_xy, K, max_dist=None) -> values with the
    reference's negative-distance weighting and NaN for empty neighborhoods.
    """
    from scipy.spatial import KDTree

    tree = KDTree(db_xy)
    N = db_xy.shape[0]

    def interp(query_xy, K, max_dist=None, min_K=None):
        bound = np.inf if max_dist is None else max_dist
        dists, ids = tree.query(query_xy, k=K, distance_upper_bound=bound)
        dists = np.atleast_2d(np.asarray(dists, np.float64))
        ids = np.atleast_2d(ids)
        valid = ids < N
        dists[~valid] = np.nan
        with np.errstate(invalid="ignore"):
            weights = (-dists) / np.nansum(-dists, axis=-1, keepdims=True)
        vals = np.full(dists.shape, np.nan)
        vals[valid] = np.asarray(db_values)[ids[valid]]
        vals[valid] *= weights[valid]
        out = np.nansum(vals, axis=-1)
        # nansum turns all-NaN rows into 0.0 — keep them NaN (reference
        # semantics: queries with no (or too few) neighbors are invalid)
        needed = 1 if min_K is None else min_K
        out[valid.sum(axis=-1) < needed] = np.nan
        return out

    return interp
