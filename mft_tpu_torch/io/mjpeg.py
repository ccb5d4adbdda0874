"""Motion JPEG video frames, decoded as ``cv2.VideoCapture`` decodes them,
and the plain version of their pixel stage.

The JAX package reads MJPEG video (in AVI, Matroska or MP4/QuickTime)
through ``cv2.VideoCapture``: libavcodec's ``mjpegdec`` decodes each frame,
swscale converts it to BGR. That is not libjpeg-turbo's arithmetic, which
:mod:`mft_tpu_torch.io.jpeg` follows for ``cv2.imread``: the two differ in
most values of a colour frame. What this module follows, checked against
this container's OpenCV 5.0.0 (libavcodec 62.28, swscale 9.5):

- parsing: :func:`mft_tpu_torch.io.jpeg.parse_jpeg`, with the tables of ITU
  T.81 Annex K in force before a frame's own DHT, and every frame's DHT and
  DQT kept for the frames after it (``mjpegdec`` keeps its tables; camera
  MJPEG usually carries no DHT);
- entropy decoding: J1, as for still images;
- pixels (J4, :func:`decode_pixels_ref` here, ``ops/csrc/mjpeg.cu`` on the
  card): dequantization with the DC offset ``4 << 8`` that ``mjpegdec``
  starts its DC prediction from (clipped to int16; AC products stored as
  int16), libavcodec's 8-bit simple IDCT (the one V2 runs,
  :func:`mft_tpu_torch.io.mpeg4.idct_ref`), the planes clamped at their
  coded sampling; then swscale's YUVJ (full-range BT.601) -> BGR24:
  4:2:0 and 4:2:2 through its x86 special converter (16-bit fixed point,
  each chroma sample over the pixels it covers, no interpolation), 4:4:4
  through the generic scaler's full-chroma output (30-bit fixed point),
  grey as Y in all three channels.

No EXIF orientation is applied (``cv2.VideoCapture`` here does not turn a
frame that carries one). Kinds that raise ``ValueError`` naming
:data:`ROADMAP_KINDS`: interlaced frames (a SOF height under 3/4 of the
container's, ``mjpegdec``'s test), progressive, lossless and
arithmetic-coded frames, RGB (Adobe) frames, samplings other than 4:2:0,
4:2:2, 4:4:4 and grey, and 4:2:0 or 4:2:2 frames of odd height (swscale's
generic path, which interpolates chroma).
"""

import numpy as np

from mft_tpu_torch.io import jpeg as _j
from mft_tpu_torch.io.mpeg4 import idct_ref

ROADMAP_KINDS = "ROADMAP A11, other MJPEG kinds"

GREY, SUBSAMPLED, FULL = 0, 1, 2            # the conversion paths (mjpeg.cuh)
# full-range BT.601: roundToInt16(c << 13) of ff_yuv2rgb_c_init_tables,
# the chroma coefficients scaled by 224 / 255
K_Y, K_UB, K_UG, K_VG, K_VR = 8192, 14516, -2819, -5850, 11485
DC_OFFSET = 4 << 8                           # mjpegdec's last_dc at a scan's start

_SOF_KINDS = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential",
              0xC6: "differential", 0xC7: "differential", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded",
              0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded"}


def default_tables() -> dict:
    """The Huffman tables in force before a frame's DHT (Annex K)."""
    return dict(_j.STD_HUFF)


def _sof_marker(data: bytes):
    """The first SOFn marker of a frame (None if it has none before SOS)."""
    pos, n = 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            return None
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return m
        if m in (0xDA, 0xD9):
            return None
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        pos += 2 + ((data[pos + 2] << 8) | data[pos + 3])
    return None


def conversion(geom: "_j.Geometry"):
    """(path, chroma row shift) of swscale's conversion of a frame, or
    ``ValueError`` for a frame whose conversion the port does not match."""
    if geom.color == _j.GREY:
        return GREY, 0
    if geom.color != _j.YCC:
        raise ValueError(f"RGB (Adobe) MJPEG frames are not supported ({ROADMAP_KINDS})")
    luma, cb, cr = zip(geom.fh, geom.fv)
    if luma == (1, 1) and cb == cr == (1, 1):
        return FULL, 0
    if luma == (1, 1) and cb == cr and cb in ((2, 2), (2, 1)):
        if geom.H % 2:
            raise ValueError(f"MJPEG frames of 4:2:0 or 4:2:2 sampling and odd height "
                             f"({geom.H}) are not supported: swscale converts them through "
                             f"its interpolating scaler ({ROADMAP_KINDS})")
        return SUBSAMPLED, cb[1] - 1
    raise ValueError(f"MJPEG sampling factors {geom.factors} are not supported (4:2:0, "
                     f"4:2:2, 4:4:4 and grey only; {ROADMAP_KINDS})")


def geometry_vector(geom: "_j.Geometry") -> np.ndarray:
    """The int64 descriptor J4 reads (mjpeg.cuh read_geom): H, W, ncomp,
    conversion path, chroma row shift, blocks, samples, then per component
    (3 slots) bw, bh, boff, poff."""
    kind, vshift = conversion(geom)
    out = [geom.H, geom.W, geom.ncomp, kind, vshift, geom.blocks, geom.samples]
    for c in range(3):
        out += [geom.bw[c], geom.bh[c], geom.boff[c], geom.poff[c]] if c < geom.ncomp else [0] * 4
    return np.array(out, np.int64)


def parse_frame(data: bytes, huff: dict, qt: dict, height: int = 0) -> "_j.JpegFile":
    """Parse one MJPEG frame with the tables in force (updated in place);
    ``height``: the container's frame height (0: unknown), which tells an
    interlaced field from a frame."""
    m = _sof_marker(data)
    if m in _SOF_KINDS:
        raise ValueError(f"{_SOF_KINDS[m]} MJPEG frames are not supported ({ROADMAP_KINDS})")
    jf = _j.parse_jpeg(data, huff, qt)
    if height and jf.geom.H < height * 3 // 4:
        raise ValueError(f"interlaced MJPEG (fields of {jf.geom.H} rows in a frame of "
                         f"{height}) is not supported ({ROADMAP_KINDS})")
    conversion(jf.geom)
    return jf


# --------------------------------------------------------------------------- #
# J4's plain version
# --------------------------------------------------------------------------- #
def samples_ref(coefs, qtabs, geom) -> np.ndarray:
    """(N, blocks, 64) int16 quantized coefficients and (N, ncomp, 64) int32
    tables -> (N, samples) uint8 planes: each component a row-major plane
    of 8 bw x 8 bh samples at ``geom.poff``."""
    coefs = np.asarray(coefs, np.int16)
    qtabs = np.asarray(qtabs, np.int64)
    N = coefs.shape[0]
    out = np.zeros((N, geom.samples), np.uint8)
    for c in range(geom.ncomp):
        nb = geom.bw[c] * geom.bh[c]
        v = coefs[:, geom.boff[c]:geom.boff[c] + nb].astype(np.int64) * qtabs[:, c, None, :]
        blk = v.astype(np.int16)                                # AC wraps
        blk[..., 0] = np.clip(v[..., 0] + DC_OFFSET, -32768, 32767)
        pix = np.clip(idct_ref(blk), 0, 255).astype(np.uint8)   # (N, nb, 64)
        pix = pix.reshape(N, geom.bh[c], geom.bw[c], 8, 8).transpose(0, 1, 3, 2, 4)
        out[:, geom.poff[c]:geom.poff[c] + nb * 64] = pix.reshape(N, -1)
    return out


def _plane(planes, geom, c):
    return planes[:, geom.poff[c]:geom.poff[c] + geom.bw[c] * geom.bh[c] * 64].reshape(
        -1, 8 * geom.bh[c], 8 * geom.bw[c])


def to_bgr_ref(planes, geom) -> np.ndarray:
    """(N, samples) uint8 planes -> (N, H, W, 3) uint8 BGR, as swscale
    converts the frame (see the module docstring)."""
    planes = np.asarray(planes)
    kind, vshift = conversion(geom)
    H, W = geom.H, geom.W
    y = _plane(planes, geom, 0)[:, :H, :W].astype(np.int64)
    if kind == GREY:
        return np.repeat(y[..., None], 3, -1).astype(np.uint8)
    rows = np.arange(H) if kind == FULL else np.arange(H) >> vshift
    cols = np.arange(W) if kind == FULL else np.arange(W) >> 1
    u = _plane(planes, geom, 1)[:, rows][:, :, cols].astype(np.int64)
    v = _plane(planes, geom, 2)[:, rows][:, :, cols].astype(np.int64)
    if kind == SUBSAMPLED:
        yc = (y * 8 * K_Y) >> 16
        uc, vc = u * 8 - 1024, v * 8 - 1024
        b = yc + ((uc * K_UB) >> 16)
        g = yc + ((uc * K_UG) >> 16) + ((vc * K_VG) >> 16)
        r = yc + ((vc * K_VR) >> 16)
    else:
        yv = (y << 9) * K_Y + (1 << 21)
        uv, vv = (u - 128) << 9, (v - 128) << 9
        b, g, r = (np.clip(x, 0, (1 << 30) - 1) >> 22 for x in
                   (yv + uv * K_UB, yv + vv * K_VG + uv * K_UG, yv + vv * K_VR))
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def decode_pixels_ref(coefs, qtabs, geom) -> np.ndarray:
    """J4's plain version: (N, blocks, 64) int16 coefficients and (N, ncomp,
    64) int32 tables of N frames of one geometry -> (N, H, W, 3) uint8 BGR."""
    return to_bgr_ref(samples_ref(coefs, qtabs, geom), geom)


# --------------------------------------------------------------------------- #
# frames of a file
# --------------------------------------------------------------------------- #
def decode_mjpeg_frames(video, device="cuda"):
    """Generator of the (H, W, 3) uint8 BGR frames of an MJPEG track (a
    :class:`mft_tpu_torch.io.container.VideoTrack`), as
    ``cv2.VideoCapture.read`` gives them: frames parsed in order (tables
    kept from frame to frame), each through J1 (natively for a CUDA
    ``device``) and one J4 launch on ``device``. An empty sample (an AVI's
    dropped frame) gives no frame, as cv2."""
    from mft_tpu_torch.core.device import resolve_device
    from mft_tpu_torch.io.jpeg import decode_pixel_groups
    from mft_tpu_torch.ops.mjpeg import mjpeg_decode_pixels
    dev = resolve_device(device)
    huff, qt = default_tables(), {}
    for shown, data in zip(video.shown(), video.read_samples()):
        if not data:
            continue
        jf = parse_frame(data, huff, qt, video.height)
        if shown:
            yield decode_pixel_groups([jf], dev, mjpeg_decode_pixels)[0]
