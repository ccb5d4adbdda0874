"""Training-time augmentation of flow + occlusion samples (host-side numpy).

Port of ``mft_tpu/train/augment.py`` (reference MFT/RAFT/core/utils/
augmentor.py) without OpenCV: the same draws, in the same order, from the
same ``np.random.Generator`` as the JAX package's augmenters, so a seed gives
the same transforms. The OpenCV calls are written in numpy:

- ``cv2.resize(INTER_LINEAR)`` of uint8 images: ``eval/tapvid.py``'s
  bit-exact fixed-point version; of float32 maps (flow, occlusion,
  validity): OpenCV's float weights, source positions (dx + 0.5) / scale -
  0.5 in float32, the horizontal taps clamped into the row and the rows
  clamped into the image, ``S0 * b0 + S1 * b1`` per pass in float32
  (OpenCV's vector code may fuse the multiply-add, so the float maps agree
  to a few float32 ulps);
- ``cv2.cvtColor`` RGB <-> HSV of uint8 images (hue in [0, 180)): OpenCV's
  integer tables (shift 12) one way and its float sector formula the other
  (1 - s*h fused; the blocks of 32 pixels of a row that OpenCV's vector
  code converts truncated to uint8, the rest of the row rounded), equal to
  cv2's (OpenCV 5 on x86) on every input tried;
- ``cv2.resize(INTER_AREA)`` of the float32 blend image, shrinking (the
  area table of ``eval/tapvid.py``, or block sums for integer factors) and
  growing (OpenCV's area-mode bilinear weights);
- ``cv2.imencode``/``cv2.imdecode`` of the JPEG corruption: the port's codec
  (:func:`mft_tpu_torch.io.jpeg.jpeg_roundtrip`: J3 then J2 on the card, no
  entropy stage, for the augmenter's ``device``), and ``cv2.imread`` of the
  blend images: :func:`mft_tpu_torch.io.image.imread`.

Not ported (ROADMAP A14): ``TextAugmenter`` with text on needs OpenCV's
Hershey font data; enabling it raises ``NotImplementedError``. Disabled, it
draws nothing, as in JAX.
"""

import os

import numpy as np

from mft_tpu_torch.eval.tapvid import _area_tab, _resize_linear
from mft_tpu_torch.io.image import imread
from mft_tpu_torch.io.jpeg import jpeg_roundtrip

_NOT_PORTED = "ROADMAP A14: no font rasterizer (OpenCV's Hershey fonts) on the card's machine"
HSV_SHIFT = 12
HSV2RGB_BLOCK = 32   # pixels of a row that OpenCV's vector HSV -> RGB code takes at once


# --------------------------------------------------------------------------- #
# OpenCV's resize and colour conversions, in numpy
# --------------------------------------------------------------------------- #
def _float_tab(ssize: int, dsize: int, double: bool):
    """(first source index, float32 weight of the next one) per destination
    index, before any clamping: the position in float32, or in float64 and
    the weight rounded once (``double``)."""
    scale = 1.0 / (dsize / ssize)
    f = (np.arange(dsize, dtype=np.float64) + 0.5) * scale - 0.5
    if double:
        s = np.floor(f).astype(np.int64)
        return s, (f - s).astype(np.float32)
    f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _resize_float(a, Ho: int, Wo: int):
    """cv2.resize(INTER_LINEAR) of a float32 (H, W) or (H, W, C) map."""
    a = np.asarray(a, np.float32)
    squeeze = a.ndim == 2
    if squeeze:
        a = a[..., None]
    H, W, C = a.shape
    # OpenCV computes the positions of 1- and 3-channel maps in float64
    double = C in (1, 3)
    sx, fx = _float_tab(W, Wo, double)
    lo, hi = sx < 0, sx >= W - 1
    fx[lo | hi] = 0.0
    sx[lo], sx[hi] = 0, W - 1
    a0 = (np.float32(1.0) - fx)[None, :, None]
    a1 = fx[None, :, None]
    rows = a[:, sx] * a0 + a[:, np.minimum(sx + 1, W - 1)] * a1          # (H, Wo, C)
    sy, fy = _float_tab(H, Ho, double)
    b0 = (np.float32(1.0) - fy)[:, None, None]
    b1 = fy[:, None, None]
    out = rows[np.clip(sy, 0, H - 1)] * b0 + rows[np.clip(sy + 1, 0, H - 1)] * b1
    return out[..., 0] if squeeze else out


def cv_resize_linear(a, new_wh):
    """``cv2.resize(a, new_wh, interpolation=cv2.INTER_LINEAR)`` for uint8
    images and float32 maps."""
    Wo, Ho = new_wh
    a = np.asarray(a)
    if (Ho, Wo) == a.shape[:2]:
        return a.copy()
    if a.dtype == np.uint8:
        squeeze = a.ndim == 2
        out = _resize_linear(a[..., None] if squeeze else a, Ho, Wo)
        return out[..., 0] if squeeze else out
    return _resize_float(a, Ho, Wo)


def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i > 0, np.rint((255 << HSV_SHIFT) / i), 0).astype(np.int64)
        hdiv = np.where(i > 0, np.rint((180 << HSV_SHIFT) / (6.0 * i)), 0).astype(np.int64)
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv(img):
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of a uint8 (H, W, 3) image."""
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    vr = v == r
    vg = v == g
    s = (diff * _SDIV[v] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(vr, g - b, np.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv):
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of a uint8 (H, W, 3) image
    (hue in [0, 180))."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.where(h < 0, h + f32(6), np.where(h >= 6, h - f32(6), h))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, f32(0), h)
    # 1 - s*h as one fused multiply-add (a single rounding), as OpenCV's
    # vector code computes it
    fma = lambda a, b: (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(f32)
    tab = np.stack([v, v * (f32(1) - s), v * fma(s, h), v * fma(s, f32(1) - h)], axis=-1)
    idx = _SECTORS[sector]                                   # (H, W, 3): b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    # OpenCV converts blocks of HSV2RGB_BLOCK pixels of a row with vector
    # code, which truncates to uint8, and the row's remaining pixels with
    # scalar code, which rounds
    W = hsv.shape[-2]
    vector = (np.arange(W) < W - W % HSV2RGB_BLOCK)[:, None]
    out = np.where(vector, np.trunc(rgb), np.rint(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_area_float(a, Ho: int, Wo: int):
    """``cv2.resize(a, (Wo, Ho), interpolation=cv2.INTER_AREA)`` of a
    float32 (H, W, C) image."""
    a = np.asarray(a, np.float32)
    H, W, C = a.shape
    if (Ho, Wo) == (H, W):
        return a.copy()
    scale_x, scale_y = W / Wo, H / Ho
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(round(scale_x)), int(round(scale_y))
        eps = np.finfo(np.float64).eps
        if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
            # integer factors (resizeAreaFast): the block's samples summed in
            # row-major order, four at a time, times 1/area in float32
            blocks = a.reshape(Ho, iy, Wo, ix, C).transpose(0, 2, 1, 3, 4).reshape(Ho, Wo, -1, C)
            area = ix * iy
            acc = np.zeros((Ho, Wo, C), np.float32)
            k = 0
            while k + 4 <= area:
                acc = acc + (((blocks[:, :, k] + blocks[:, :, k + 1]) + blocks[:, :, k + 2])
                             + blocks[:, :, k + 3])
                k += 4
            for k in range(k, area):
                acc = acc + blocks[:, :, k]
            return acc * np.float32(1.0 / area)
        rows = np.zeros((H, Wo, C), np.float32)
        for dx, sx, alpha in _area_tab(W, Wo):
            rows[:, dx] = rows[:, dx] + a[:, sx] * alpha
        out = np.zeros((Ho, Wo, C), np.float32)
        prev = None
        for dy, sy, beta in _area_tab(H, Ho):
            if dy != prev:
                out[dy] = beta * rows[sy]
                prev = dy
            else:
                out[dy] = out[dy] + beta * rows[sy]
        return out

    # growing on either side: OpenCV's area-mode bilinear weights
    def tab(ssize, dsize):
        d = np.arange(dsize)
        s0 = np.floor(d * (ssize / dsize)).astype(np.int64)
        f = ((d + 1) - (s0 + 1) * (dsize / ssize)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f))
        return s0, f.astype(np.float32)

    sx, fx = tab(W, Wo)
    edge = sx >= W - 1
    fx[edge] = 0
    sx[edge] = W - 1
    a0 = (np.float32(1) - fx)[None, :, None]
    a1 = fx[None, :, None]
    rows = np.where(edge[None, :, None], a[:, sx],
                    a[:, sx] * a0 + a[:, np.minimum(sx + 1, W - 1)] * a1)
    sy, fy = tab(H, Ho)
    b0 = (np.float32(1) - fy)[:, None, None]
    b1 = fy[:, None, None]
    return rows[np.clip(sy, 0, H - 1)] * b0 + rows[np.clip(sy + 1, 0, H - 1)] * b1


def _perlin_noise_2d(shape, res, rng):
    """Gradient (Perlin) noise in [-1, 1] on an H x W grid, the JAX package's
    (``shape`` a multiple of ``res``; the same draws from ``rng``)."""
    H, W = shape
    gy, gx = res
    d0, d1 = H // gy, W // gx
    angles = 2.0 * np.pi * rng.random((gy + 1, gx + 1))
    grad = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    y = np.arange(H, dtype=np.float64) / d0
    x = np.arange(W, dtype=np.float64) / d1
    yi = np.minimum(y.astype(np.int64), gy - 1)
    xi = np.minimum(x.astype(np.int64), gx - 1)
    yf = (y - yi)[:, None]
    xf = (x - xi)[None, :]
    g00 = grad[yi][:, xi]
    g01 = grad[yi][:, xi + 1]
    g10 = grad[yi + 1][:, xi]
    g11 = grad[yi + 1][:, xi + 1]
    n00 = g00[..., 0] * xf + g00[..., 1] * yf
    n01 = g01[..., 0] * (xf - 1.0) + g01[..., 1] * yf
    n10 = g10[..., 0] * xf + g10[..., 1] * (yf - 1.0)
    n11 = g11[..., 0] * (xf - 1.0) + g11[..., 1] * (yf - 1.0)
    u = xf ** 3 * (xf * (xf * 6.0 - 15.0) + 10.0)
    v = yf ** 3 * (yf * (yf * 6.0 - 15.0) + 10.0)
    nx0 = n00 * (1.0 - u) + n01 * u
    nx1 = n10 * (1.0 - u) + n11 * u
    return np.sqrt(2.0) * (nx0 * (1.0 - v) + nx1 * v)


# --------------------------------------------------------------------------- #
# the corruption augmenters
# --------------------------------------------------------------------------- #
# JPEG-corruption severity -> libjpeg quality (the JAX package's table)
_JPEG_SEVERITY_QUALITY = {1: 25, 2: 18, 3: 15}


def jpeg_corrupt(img, severity, device="cuda"):
    """Encode + decode a uint8 RGB image as JPEG at the severity's quality
    (JAX ``augment.py:57-68``: ``cv2.imencode`` of the BGR flip, 4:2:0, then
    ``cv2.imdecode``, flipped back): J3 then J2 for ``device``."""
    quality = _JPEG_SEVERITY_QUALITY[int(severity)]
    bgr = np.ascontiguousarray(np.asarray(img)[:, :, ::-1])
    return np.ascontiguousarray(jpeg_roundtrip(bgr, quality, device)[:, :, ::-1])


class BlendAugmenter:
    """Lighten-only blend of a random distractor image through Perlin alpha
    (reference augmentor.py:26-93, JAX ``augment.py:71-127``): a random image
    under ``source_dir`` (read for ``device``), resized to the frame, its
    alpha clipped Perlin noise, blended identically into both frames with
    random opacity in [0, 0.6]."""

    def __init__(self, source_dir=None, do_blend_transform=True,
                 blend_prop=0.5, blend_clip_min=0.5, blend_clip_max=0.8,
                 octaves=8, rng=None, device="cuda"):
        self.do_blend_transform = bool(do_blend_transform and source_dir)
        self.blend_prop = blend_prop
        self.blend_clip_min = blend_clip_min
        self.blend_clip_max = blend_clip_max
        self.octaves = octaves
        self.rng = rng if rng is not None else np.random.default_rng()
        self.device = device
        self.image_list = []
        if self.do_blend_transform:
            for root, _dirs, files in os.walk(source_dir):
                self.image_list += [os.path.join(root, f) for f in files]
            self.image_list.sort()
            self.do_blend_transform = bool(self.image_list)

    def _perlin_alpha(self, H, W):
        g = self.octaves
        Hb = ((H // g ** 2) + 1) * g ** 2
        Wb = ((W // g ** 2) + 1) * g ** 2
        noise = _perlin_noise_2d((Hb, Wb), (g, g), self.rng)[:H, :W]
        noise = noise - noise.min()
        noise = np.clip(noise, self.blend_clip_min, self.blend_clip_max)
        noise = noise - self.blend_clip_min
        m = noise.max()
        return noise / m if m > 0 else noise

    def _lighten_only(self, img, blend_rgb, alpha, opacity):
        """max-blend composited at per-pixel ratio alpha*opacity."""
        ratio = (alpha * opacity)[..., None]
        comp = np.maximum(img.astype(np.float32), blend_rgb)
        out = comp * ratio + img.astype(np.float32) * (1.0 - ratio)
        return np.round(out).astype(np.uint8)

    def __call__(self, img1, img2):
        if not self.do_blend_transform or self.rng.uniform() >= self.blend_prop:
            return img1, img2
        H, W = img1.shape[:2]
        path = self.image_list[int(self.rng.integers(len(self.image_list)))]
        blend = imread(path, self.device)
        if blend is None:
            return img1, img2
        blend = _resize_area_float(blend[:, :, ::-1].astype(np.float32), H, W)
        alpha = self._perlin_alpha(H, W)
        opacity = self.rng.uniform(0.0, 0.6)
        return (self._lighten_only(img1, blend, alpha, opacity),
                self._lighten_only(img2, blend, alpha, opacity))


class TextAugmenter:
    """Random text overlays (reference augmentor.py:96-154): not ported; off
    by default, and then it does nothing."""

    def __init__(self, do_add_text=False, **kwargs):
        if do_add_text:
            raise NotImplementedError(f"TextAugmenter: {_NOT_PORTED}")

    def __call__(self, img1, img2, valid):
        return img1, img2, valid


# --------------------------------------------------------------------------- #
# photometric and spatial augmentation
# --------------------------------------------------------------------------- #
def _adjust_photometric(img, rng, brightness=0.4, contrast=0.4, saturation=0.4,
                        hue=0.5 / 3.14):
    """torchvision-ColorJitter-style photometric jitter on uint8 RGB."""
    out = img.astype(np.float32)
    out = out * rng.uniform(1 - brightness, 1 + brightness)
    mean = out.mean()
    out = (out - mean) * rng.uniform(1 - contrast, 1 + contrast) + mean
    gray = out.mean(axis=2, keepdims=True)
    out = (out - gray) * rng.uniform(1 - saturation, 1 + saturation) + gray
    out = np.clip(out, 0, 255).astype(np.uint8)
    hsv = rgb_to_hsv(out).astype(np.int32)
    hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-hue, hue) * 180)) % 180
    return hsv_to_rgb(hsv.astype(np.uint8))


class FlowAugmenter:
    """Dense-flow augmentation (reference augmentor.py:157-324)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=True,
                 load_occlusion=False, asymmetric_color_aug_prob=1.0, spatial_aug_prob=0.8,
                 eraser_aug_prob=0.5, stretch_prob=0.8, max_stretch=0.2, h_flip_prob=0.5,
                 v_flip_prob=0.1, out_of_frame_occlusion=True, seed=None,
                 do_jpeg_transform=False, jpeg_prop=0.8, blend_source=None,
                 do_blend_transform=None, blend_prop=0.5, do_add_text_transform=False,
                 add_text_prop=0.5, max_add_text=3, device="cuda"):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.load_occlusion = load_occlusion
        self.asymmetric_color_aug_prob = asymmetric_color_aug_prob
        self.spatial_aug_prob = spatial_aug_prob
        self.eraser_aug_prob = eraser_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.out_of_frame_occlusion = out_of_frame_occlusion
        self.rng = np.random.default_rng(seed)
        # the corruptions (reference augmentor.py:169-183): blend -> text ->
        # jpeg after the spatial transform; ``device`` runs the JPEG codec
        self.device = device
        self.do_jpeg_transform = do_jpeg_transform
        self.jpeg_prop = jpeg_prop
        if do_blend_transform is None:
            do_blend_transform = blend_source is not None
        self.blend_aug = BlendAugmenter(source_dir=blend_source,
                                        do_blend_transform=do_blend_transform,
                                        blend_prop=blend_prop, rng=self.rng, device=device)
        self.text_aug = TextAugmenter(do_add_text=do_add_text_transform)

    def color_transform(self, img1, img2):
        """Strong symmetric jitter, then with probability a weak asymmetric
        pass per image (reference augmentor.py:195-208)."""
        stacked = np.concatenate([img1, img2], axis=0)
        stacked = _adjust_photometric(stacked, self.rng)
        img1, img2 = np.split(stacked, 2, axis=0)
        if self.rng.uniform() < self.asymmetric_color_aug_prob:
            weak = dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05)
            img1 = _adjust_photometric(img1, self.rng, **weak)
            img2 = _adjust_photometric(img2, self.rng, **weak)
        return img1, img2

    def jpeg_transform(self, img1, img2):
        """JPEG-corrupt both frames at a shared random severity 1..3
        (reference augmentor.py:212-218)."""
        if self.do_jpeg_transform and self.rng.uniform() < self.jpeg_prop:
            severity = int(self.rng.integers(1, 4))
            img1 = jpeg_corrupt(img1, severity, self.device)
            img2 = jpeg_corrupt(img2, severity, self.device)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        """Occlusion simulation: rectangles of img2 -> its mean colour."""
        H, W = img1.shape[:2]
        if self.rng.uniform() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.integers(1, 3)):
                x0 = int(self.rng.uniform(0, W))
                y0 = int(self.rng.uniform(0, H))
                dx = int(self.rng.uniform(*bounds))
                dy = int(self.rng.uniform(*bounds))
                img2[y0:y0 + dy, x0:x0 + dx] = mean_color
        return img1, img2

    def spatial_transform(self, img1, img2, flow, occl, valid=None):
        H, W = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / H, (self.crop_size[1] + 8) / W)
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if self.rng.uniform() < self.stretch_prob:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if self.rng.uniform() < self.spatial_aug_prob:
            new_wh = (int(round(W * scale_x)), int(round(H * scale_y)))
            img1 = cv_resize_linear(img1, new_wh)
            img2 = cv_resize_linear(img2, new_wh)
            flow = cv_resize_linear(flow, new_wh)
            flow = flow * np.array([scale_x, scale_y], np.float32)
            if occl is not None:
                occl = cv_resize_linear(occl, new_wh)
            if valid is not None:
                valid = cv_resize_linear(valid, new_wh)

        if self.do_flip:
            if self.rng.uniform() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
                occl = occl[:, ::-1] if occl is not None else None
                valid = valid[:, ::-1] if valid is not None else None
            if self.rng.uniform() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)
                occl = occl[::-1] if occl is not None else None
                valid = valid[::-1] if valid is not None else None

        H2, W2 = img1.shape[:2]
        y0 = self.rng.integers(0, H2 - self.crop_size[0] + 1)
        x0 = self.rng.integers(0, W2 - self.crop_size[1] + 1)
        sl = (slice(y0, y0 + self.crop_size[0]), slice(x0, x0 + self.crop_size[1]))
        img1, img2, flow = img1[sl], img2[sl], flow[sl]
        occl = occl[sl] if occl is not None else None
        valid = valid[sl] if valid is not None else None
        cc = lambda a: np.ascontiguousarray(a) if a is not None else None
        return cc(img1), cc(img2), cc(flow), cc(occl), cc(valid)

    @staticmethod
    def mark_out_of_frame_occluded(flow, occl):
        """Pixels whose flow endpoint leaves the crop become occluded
        (reference augmentor.py:292-302)."""
        H, W = flow.shape[:2]
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        ex = xs + flow[..., 0]
        ey = ys + flow[..., 1]
        oof = (ex < 0) | (ey < 0) | (ex >= W) | (ey >= H)
        occl = occl.copy()
        occl[oof] = 1.0
        return occl

    def __call__(self, img1, img2, flow, valid=None, occl=None):
        """returns (img1, img2, flow, valid, occl), channel-last numpy."""
        occl2d = occl[..., 0] if (occl is not None and occl.ndim == 3) else occl
        img1, img2 = self.color_transform(img1, img2)
        if not self.load_occlusion:
            # with real occlusion ground truth the eraser would corrupt it
            img1, img2 = self.eraser_transform(img1, img2)
        if valid is None:
            valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        valid = np.asarray(valid, np.float32)
        valid = valid[..., 0] if valid.ndim == 3 else valid
        img1, img2, flow, occl2d, valid = self.spatial_transform(img1, img2, flow, occl2d,
                                                                 valid)
        # post-spatial corruptions, reference order: blend -> text -> jpeg
        img1, img2 = self.blend_aug(img1, img2)
        img1, img2, valid = self.text_aug(img1, img2, valid)
        img1, img2 = self.jpeg_transform(img1, img2)
        valid = valid.astype(np.float32)
        if occl2d is not None and self.out_of_frame_occlusion:
            occl2d = self.mark_out_of_frame_occluded(flow, occl2d)
        occl_out = occl2d[..., None] if occl2d is not None else None
        return img1, img2, flow, valid, occl_out


class SparseFlowAugmenter:
    """Sparse-flow (KITTI/HD1K) augmentation with a validity-aware resize
    (reference augmentor.py:327-501)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 load_occlusion=False, seed=None, **kwargs):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.rng = np.random.default_rng(seed)
        self.spatial_aug_prob = 0.8
        self.h_flip_prob = 0.5
        self.eraser_aug_prob = 0.5
        self._dense = FlowAugmenter(crop_size, seed=seed, **kwargs)
        self._dense.rng = self.rng
        self._dense.blend_aug.rng = self.rng

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx, fy):
        H, W = flow.shape[:2]
        Ho, Wo = int(round(H * fy)), int(round(W * fx))
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        v = valid > 0.5
        pts_x = xs[v] * fx
        pts_y = ys[v] * fy
        fl = flow[v] * np.array([fx, fy], np.float32)
        xi = np.round(pts_x).astype(np.int32)
        yi = np.round(pts_y).astype(np.int32)
        keep = (xi >= 0) & (xi < Wo) & (yi >= 0) & (yi < Ho)
        out_flow = np.zeros((Ho, Wo, 2), np.float32)
        out_valid = np.zeros((Ho, Wo), np.float32)
        out_flow[yi[keep], xi[keep]] = fl[keep]
        out_valid[yi[keep], xi[keep]] = 1.0
        return out_flow, out_valid

    def color_transform(self, img1, img2):
        """Symmetric-only, weaker jitter (reference augmentor.py:360-369)."""
        stacked = np.concatenate([img1, img2], axis=0)
        stacked = _adjust_photometric(stacked, self.rng, brightness=0.3, contrast=0.3,
                                      saturation=0.3, hue=0.3 / 3.14)
        return np.split(stacked, 2, axis=0)

    def __call__(self, img1, img2, flow, valid=None, occl=None):
        if valid is None:
            valid = np.ones(flow.shape[:2], np.float32)
        if valid.ndim == 3:
            valid = valid[..., 0]
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self._dense.eraser_transform(img1, img2)

        H, W = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / H, (self.crop_size[1] + 1) / W)
        scale = max(2 ** self.rng.uniform(self.min_scale, self.max_scale), min_scale)
        if self.rng.uniform() < self.spatial_aug_prob:
            new_wh = (int(round(W * scale)), int(round(H * scale)))
            img1 = cv_resize_linear(img1, new_wh)
            img2 = cv_resize_linear(img2, new_wh)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale, scale)

        if self.do_flip and self.rng.uniform() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            valid = valid[:, ::-1]

        H2, W2 = img1.shape[:2]
        y0 = self.rng.integers(0, max(H2 - self.crop_size[0], 0) + 1)
        x0 = self.rng.integers(0, max(W2 - self.crop_size[1], 0) + 1)
        sl = (slice(y0, y0 + self.crop_size[0]), slice(x0, x0 + self.crop_size[1]))
        img1, img2 = img1[sl], img2[sl]
        flow, valid = flow[sl], valid[sl]
        img1, img2 = self._dense.blend_aug(img1, img2)
        img1, img2, valid = self._dense.text_aug(img1, img2, valid)
        img1, img2 = self._dense.jpeg_transform(img1, img2)
        valid = valid.astype(np.float32)
        occl_out = np.zeros((*flow.shape[:2], 1), np.float32)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid), occl_out)
