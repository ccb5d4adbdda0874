"""Flow-file readers and writers: .flo, .pfm, KITTI 16-bit PNG, VIPER .npz,
flowou PNG, and images.

Port of ``mft_tpu/train/flow_readers.py`` (reference
MFT/RAFT/core/utils/frame_utils.py:12-161) without OpenCV: images go through
:func:`mft_tpu_torch.io.image.imread` in ``cv2.imread``'s role (PNG, JPEG
through the port's codec (VIPER's frames), binary PPM (FlyingChairs); BGR,
so ``read_image`` flips to RGB as the JAX package does after ``cv2.imread``).
All readers return channel-last numpy arrays.
"""

import re
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.image import imread
from mft_tpu_torch.io.png import decode_png, encode_png

FLO_MAGIC = 202021.25


def read_flo(path):
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != FLO_MAGIC:
            raise ValueError(f"bad .flo magic in {path}")
        W = int(np.fromfile(f, np.int32, count=1)[0])
        H = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * W * H)
    return data.reshape(H, W, 2)


def write_flo(path, flow):
    """(H, W, 2) float32 -> Middlebury .flo."""
    H, W = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([W, H], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path):
    """PFM -> (H, W) or (H, W, 3) float32 (bottom-up storage flipped)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode("latin-1")
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"malformed PFM header: {path}")
        W, H = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (H, W, 3) if color else (H, W)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path, data, scale=1.0):
    data = np.flipud(np.asarray(data, np.float32))
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        endian_scale = -scale if data.dtype.byteorder in ("<", "=") else scale
        f.write(f"{endian_scale}\n".encode())
        data.tofile(f)


def read_kitti_flow(path):
    """KITTI 16-bit PNG -> (flow (H, W, 2), valid (H, W)) float32; the file's
    channels are (flow_u*64 + 2^15, flow_v*64 + 2^15, valid)."""
    raw = decode_png(Path(path).read_bytes())
    if raw.ndim != 3 or raw.shape[2] < 3:
        raise ValueError(f"{path}: a KITTI flow PNG has 3 channels")
    raw = raw[:, :, 2::-1].astype(np.float32)   # BGR(A) -> RGB
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    return flow, raw[:, :, 2]


def write_kitti_flow(path, flow, valid=None):
    H, W = flow.shape[:2]
    if valid is None:
        valid = np.ones((H, W), np.float32)
    enc = np.concatenate([flow * 64.0 + 2 ** 15, valid[..., None]], axis=2)
    Path(path).write_bytes(encode_png(enc[:, :, ::-1].astype(np.uint16)))


def read_viper_flow(path):
    """VIPER .npz with 'u'/'v' -> (H, W, 2) float32, NaNs -> 0 + invalid."""
    data = np.load(path)
    flow = np.stack([data["u"], data["v"]], axis=-1).astype(np.float32)
    valid = np.isfinite(flow).all(axis=-1)
    flow[~np.isfinite(flow)] = 0.0
    return flow, valid.astype(np.float32)


def read_flowou_png(path):
    """Kubric longterm .flowou.png -> (flow (H,W,2), occl (H,W), sigma (H,W))."""
    from mft_tpu_torch.io.flowou_codecs import read_flowou
    return read_flowou(path)


def read_image(path, device="cuda"):
    """RGB uint8 image (H, W, 3) of a PNG, JPEG or binary PPM file, as
    ``cv2.imread(path, IMREAD_COLOR)`` and a BGR -> RGB flip give it: grey
    replicated to 3 channels, alpha dropped, 16-bit samples >> 8, a JPEG
    turned by its EXIF orientation (decoded for ``device``)."""
    img = imread(path, device)
    if img is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(img[:, :, ::-1])


def write_image(path, img):
    """(H, W, 3) RGB uint8 -> PNG (the inverse of :func:`read_image`)."""
    Path(path).write_bytes(encode_png(np.ascontiguousarray(np.asarray(img)[:, :, ::-1])))


def read_gen(path, device="cuda"):
    """Extension-dispatching reader (reference frame_utils.py:146-161);
    ``device`` decodes a JPEG."""
    ext = Path(path).suffix.lower()
    name = Path(path).name.lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        if name.endswith(".flowou.png"):
            return read_flowou_png(path)
        return read_image(path, device)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        data = read_pfm(path)
        return data[..., :2] if data.ndim == 3 else data
    if ext == ".npz":
        return read_viper_flow(path)
    raise ValueError(f"don't know how to read {path}")
