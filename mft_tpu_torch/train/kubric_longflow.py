"""Kubric 'MOVi-E longterm' ground truth: dense template -> frame flow and
occlusion for every pixel of a Kubric scene's frame 0.

Port of ``mft_tpu/train/kubric_longflow.py``: each frame-0 pixel is
unprojected with the depth map and the camera pose, attached to its object
(or the static background), moved with the object's rigid pose to every
other frame, reprojected with that frame's camera, and tested for occlusion
by comparing depths. The results are written as ``0000_to_XXXX.flowou.png``
files that ``datasets.KubricLongTerm`` reads; the 0000_to_0000 file is an
all-zero flow (see :func:`save_scene_flowous`).

:func:`track_scene` runs in float64 on the device with JAX's (numpy's)
per-element operations in its order; the per-instance mask loops of JAX are
a gather of each pixel's pose by its frame-0 instance, which changes no
element's arithmetic, so on the CPU the results are JAX's bit for bit.

Conventions (Kubric/Blender): the camera looks along -Z with +X right and +Y
up in camera space; quaternions are (w, x, y, z); 'depth' is the range along
the optical axis (z-depth). The scene dict is laid out as the MOVi-E tfds
record:

  scene = {
    'depth': (T, H, W) float32,
    'segmentation': (T, H, W) int32  (0 = background, k = instance k),
    'camera': {'focal_length': f, 'sensor_width': s,
               'positions': (T, 3), 'quaternions': (T, 4)},
    'instances': {'positions': (K, T, 3), 'quaternions': (K, T, 4)},
  }

    python -m mft_tpu_torch.train.kubric_longflow --tfds_name movi_e/256x256 \\
        --out datasets/kubric_movi_e_longterm [--device cpu]

(reading MOVi-E needs ``tensorflow_datasets``, imported only there.)
"""

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.io.flowou_codecs import write_flowou
from mft_tpu_torch.io.png import encode_png

logger = logging.getLogger(__name__)

DEPTH_OCCLUSION_RTOL = 0.01   # relative depth slack for the occlusion test
DEPTH_OCCLUSION_ATOL = 0.05


# -- quaternion algebra (w, x, y, z), float64 tensors ------------------------ #

def _cross(a, b):
    """Cross product over the last axis, numpy's per-component order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    q, v = q.double(), v.double()
    w, u = q[..., 0:1], q[..., 1:4]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_conjugate(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_rotate_inverse(q, v):
    return quat_rotate(quat_conjugate(q.double()), v)


# -- camera model ------------------------------------------------------------ #

def intrinsics(camera, H, W):
    """Pixel focal lengths and principal point from Kubric camera params."""
    f = float(np.asarray(camera["focal_length"]))
    sw = float(np.asarray(camera["sensor_width"]))
    fx = f / sw * W
    fy = fx  # Kubric's sensor height is sensor_width * H / W: square pixels
    return fx, fy, W / 2.0, H / 2.0


def _pixel_centres(H, W, device):
    """(us, vs) (H, W) float64: pixel centres x + 0.5, y + 0.5."""
    vs, us = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device) + 0.5,
                            torch.arange(W, dtype=torch.float64, device=device) + 0.5,
                            indexing="ij")
    return us, vs


def _pose(camera, frame, device):
    q = torch.as_tensor(np.asarray(camera["quaternions"])[frame], device=device).double()
    t = torch.as_tensor(np.asarray(camera["positions"])[frame], device=device).double()
    return q, t


def unproject(depth, camera, frame, H, W):
    """Frame pixels and z-depth ((H, W) tensor) -> world points (H, W, 3)."""
    fx, fy, cx, cy = intrinsics(camera, H, W)
    us, vs = _pixel_centres(H, W, depth.device)
    d = depth.double()
    # the focal lengths as device tensors: CUDA divides by a Python scalar as
    # a product with its reciprocal, which is not numpy's rounding
    fx, fy = (torch.tensor(f, dtype=torch.float64, device=depth.device) for f in (fx, fy))
    x = (us - cx) / fx * d
    y = -(vs - cy) / fy * d
    z = -d
    p_cam = torch.stack([x, y, z], dim=-1)
    q, t = _pose(camera, frame, depth.device)
    return quat_rotate(q[None, None], p_cam) + t


def project(p_world, camera, frame, H, W):
    """World points (..., 3) -> (u, v) pixel coordinates and z-depth."""
    fx, fy, cx, cy = intrinsics(camera, H, W)
    q, t = _pose(camera, frame, p_world.device)
    p_cam = quat_rotate_inverse(q[None, None], p_world - t)
    z = -p_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = cx + fx * p_cam[..., 0] / z_safe
    v = cy - fy * p_cam[..., 1] / z_safe
    return u, v, z


# -- tracking ----------------------------------------------------------------- #

def _bilinear(data, u, v):
    """Bilinear sample of (H, W) float data at (u, v) pixel-centre coords."""
    H, W = data.shape
    x = (u - 0.5).clamp(0, W - 1)
    y = (v - 0.5).clamp(0, H - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = x - x0
    wy = y - y0
    return (data[y0, x0] * (1 - wx) * (1 - wy) + data[y0, x1] * wx * (1 - wy)
            + data[y1, x0] * (1 - wx) * wy + data[y1, x1] * wx * wy)


def track_terms(scene, device="cuda"):
    """:func:`track_scene` on ``device``, with the occlusion test's two
    sides: returns tensors on the device, flows (T, H, W, 2) float32, the
    occlusions (T, H, W) float32, the frame-0 instance mask (H, W) bool, and
    per frame the projected depth z and the test's threshold
    depth_at * (1 + rtol) + atol, (T, H, W) float64, NaN out of view."""
    dev = resolve_device(device)
    depth = torch.as_tensor(np.asarray(scene["depth"]), device=dev)
    seg0 = torch.as_tensor(np.asarray(scene["segmentation"])[0], device=dev).long()
    camera = scene["camera"]
    inst_pos = torch.as_tensor(np.asarray(scene["instances"]["positions"]),
                               device=dev).double()                         # (K, T, 3)
    inst_quat = torch.as_tensor(np.asarray(scene["instances"]["quaternions"]),
                                device=dev).double()                        # (K, T, 4)
    T, H, W = depth.shape
    K = inst_pos.shape[0]

    # frame-0 pixel -> world point and owning instance
    p_world0 = unproject(depth[0], camera, 0, H, W)                   # (H, W, 3)
    us0, vs0 = _pixel_centres(H, W, dev)
    attached = (seg0 >= 1) & (seg0 <= K)
    if K == 0:   # no instances: every pixel is background; a pose to gather
        inst_pos = torch.zeros((1, T, 3), dtype=torch.float64, device=dev)
        inst_quat = torch.zeros((1, T, 4), dtype=torch.float64, device=dev)
    idx = torch.where(attached, seg0 - 1, 0)
    # object-local coordinates of instance pixels, each with its own pose
    local = torch.where(attached[..., None],
                        quat_rotate_inverse(inst_quat[idx, 0], p_world0 - inst_pos[idx, 0]),
                        0.0)

    flows = torch.zeros((T, H, W, 2), dtype=torch.float32, device=dev)
    occlusions = torch.zeros((T, H, W), dtype=torch.float32, device=dev)
    zs = torch.empty((T, H, W), dtype=torch.float64, device=dev)
    limits = torch.empty_like(zs)
    for t in range(T):
        moved = quat_rotate(inst_quat[idx, t], local) + inst_pos[idx, t]
        p_world_t = torch.where(attached[..., None], moved, p_world0)
        u, v, z = project(p_world_t, camera, t, H, W)
        flows[t, ..., 0] = u - us0
        flows[t, ..., 1] = v - vs0
        in_view = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
        depth_at = _bilinear(depth[t].double(), u, v)
        limit = depth_at * (1 + DEPTH_OCCLUSION_RTOL) + DEPTH_OCCLUSION_ATOL
        occlusions[t] = (~in_view | (z > limit)).float()
        zs[t] = torch.where(in_view, z, float("nan"))
        limits[t] = torch.where(in_view, limit, float("nan"))
    return flows, occlusions, seg0 > 0, zs, limits


def track_scene(scene, device="cuda"):
    """Template -> frame flow and occlusion for every frame, computed on
    ``device``. returns numpy arrays: flows (T, H, W, 2) float32,
    occlusions (T, H, W) float32, object_marker (H, W) bool (the frame-0
    instance mask)."""
    flows, occlusions, marker, _, _ = track_terms(scene, device)
    return flows.cpu().numpy(), occlusions.cpu().numpy(), marker.cpu().numpy()


def save_scene_flowous(out_dir, flows, occlusions, object_marker=None):
    """Write 0000_to_XXXX.flowou.png files and a ZERO frame-0 flow.

    The reference pipeline's data carries a +0.5 px raster offset on object
    pixels, which KubricLongTerm's ``correct_flow`` removes by subtracting
    the 0000_to_0000 marker and back-warping. This generator computes exact
    flows with one pixel-centre convention for all pixels, so it writes an
    all-zero frame-0 flow: ``correct_flow`` then changes nothing and the
    exact flows pass through unbiased. ``object_marker`` is accepted for
    JAX's signature but not encoded.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    T, H, W = occlusions.shape
    sigma = np.zeros((H, W), np.float32)
    write_flowou(out_dir / "0000_to_0000.flowou.png", np.zeros((H, W, 2), np.float32),
                 np.zeros((H, W), np.float32), sigma)
    for t in range(1, T):
        write_flowou(out_dir / f"0000_to_{t:04d}.flowou.png", flows[t], occlusions[t], sigma)


def load_movi_scene(record):
    """One tfds MOVi-E record (numpy) in the scene dict layout."""
    def arr(x):
        return np.asarray(x)

    depth = arr(record["depth"])
    if depth.ndim == 4:  # (T, H, W, 1)
        depth = depth[..., 0]
    seg = arr(record["segmentations"])
    return {
        "depth": depth,
        "segmentation": seg[..., 0] if seg.ndim == 4 else seg,
        "video": arr(record["video"]),
        "camera": {
            "focal_length": arr(record["camera"]["focal_length"]),
            "sensor_width": arr(record["camera"]["sensor_width"]),
            "positions": arr(record["camera"]["positions"]),
            "quaternions": arr(record["camera"]["quaternions"]),
        },
        "instances": {
            "positions": arr(record["instances"]["positions"]),
            "quaternions": arr(record["instances"]["quaternions"]),
        },
    }


def generate_dataset(tfds_name, data_dir, out_root, split="train", max_scenes=None,
                     device="cuda"):
    """Stream a MOVi tfds dataset and write the longterm flow ground truth
    and the frames (RGB video -> PNG)."""
    import tensorflow_datasets as tfds  # optional heavy dependency

    out_root = Path(out_root) / split
    ds = tfds.load(tfds_name, data_dir=data_dir, split=split)
    for i, record in enumerate(tfds.as_numpy(ds)):
        if max_scenes is not None and i >= max_scenes:
            break
        scene = load_movi_scene(record)
        scene_dir = out_root / f"{i:05d}"
        flows, occl, marker = track_scene(scene, device)
        save_scene_flowous(scene_dir / "flowou", flows, occl, marker)
        img_dir = scene_dir / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        for t, frame in enumerate(scene["video"]):
            (img_dir / f"{t:04d}.png").write_bytes(
                encode_png(np.ascontiguousarray(frame[:, :, ::-1])))
        logger.info("scene %05d done (%d frames)", i, len(scene["video"]))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Kubric longterm flow GT generator")
    parser.add_argument("--tfds_name", default="movi_e/256x256")
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--out", default="datasets/kubric_movi_e_longterm")
    parser.add_argument("--split", default="train")
    parser.add_argument("--max_scenes", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    generate_dataset(args.tfds_name, args.data_dir, args.out, args.split, args.max_scenes,
                     args.device)


if __name__ == "__main__":
    main()
