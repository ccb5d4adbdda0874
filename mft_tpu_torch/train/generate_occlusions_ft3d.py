"""Offline occlusion maps for FlyingThings3D.

Port of ``mft_tpu/train/generate_occlusions_ft3d.py``. FlyingThings3D ships
forward and backward flow but no occlusion ground truth; the maps are
derived by a forward-backward consistency test plus an out-of-frame test and
written as PNGs mirroring the flow directory layout (both time directions),
which ``datasets.FlyingThings3D(load_occlusion=True)`` then reads.

A pixel is occluded when the round trip misses by more than the classical
tolerance |f + b(p+f)|^2 > a1 * (|f|^2 + |b(p+f)|^2) + a2 (Sundaram et al.
2010), or when its flow's end point leaves the image. The sampling and the
test run as torch ops in float64 on the device, with JAX's (numpy's)
per-element operations in its order, so on the CPU the maps are JAX's bit
for bit; on the card a pixel can differ only where its two sides of the
threshold lie within the rounding of the sums.

    python -m mft_tpu_torch.train.generate_occlusions_ft3d \\
        --root datasets/FlyingThings3D --split TRAIN [--device cpu]
"""

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.io.png import encode_png
from mft_tpu_torch.train.flow_readers import read_pfm

logger = logging.getLogger(__name__)

ALPHA1 = 0.01
ALPHA2 = 0.5


def _bilinear2(data, x, y):
    """Sample (H, W, C) at float coordinates with border clamping."""
    H, W = data.shape[:2]
    x = x.clamp(0, W - 1)
    y = y.clamp(0, H - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    return (data[y0, x0] * (1 - wx) * (1 - wy) + data[y0, x1] * wx * (1 - wy)
            + data[y1, x0] * (1 - wx) * wy + data[y1, x1] * wx * wy)


def _sq_norm(v):
    """|v|^2 over the last axis of 2: v0*v0 + v1*v1, numpy's sum order."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]


def occlusion_terms(flow_fwd, flow_bwd, alpha1=ALPHA1, alpha2=ALPHA2):
    """The two sides of the consistency test and the out-of-frame mask:
    (|f + b(p+f)|^2, a1 * (|f|^2 + |b(p+f)|^2) + a2, out of frame), float64
    and bool tensors on the flows' device; ``flow_fwd``/``flow_bwd`` (H, W,
    2) tensors."""
    H, W = flow_fwd.shape[:2]
    dev = flow_fwd.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    f64 = flow_fwd.double()
    ex = xs + f64[..., 0]
    ey = ys + f64[..., 1]
    bwd_at = _bilinear2(flow_bwd.double(), ex, ey)
    rt_sq = _sq_norm(f64 + bwd_at)   # the round trip's residual
    rhs = alpha1 * (_sq_norm(f64) + _sq_norm(bwd_at)) + alpha2
    out_of_frame = (ex < 0) | (ey < 0) | (ex >= W) | (ey >= H)
    return rt_sq, rhs, out_of_frame


def occlusion_from_fb(flow_fwd, flow_bwd, alpha1=ALPHA1, alpha2=ALPHA2, device="cuda"):
    """(H, W, 2) forward and backward flow (numpy) -> (H, W) float32 0/1
    occlusion map (numpy), computed on ``device``."""
    dev = resolve_device(device)
    f = torch.from_numpy(np.ascontiguousarray(flow_fwd)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(flow_bwd)).to(dev)
    rt_sq, rhs, out_of_frame = occlusion_terms(f, b, alpha1, alpha2)
    return ((rt_sq > rhs) | out_of_frame).float().cpu().numpy()


def _write_png(path, occ):
    Path(path).write_bytes(encode_png((occ * 255).astype(np.uint8)))


def process_pair_dir(fwd_dir, bwd_dir, out_fwd_dir, out_bwd_dir, device="cuda"):
    """Occlusions for one into_future/into_past directory pair. returns the
    number of pairs written."""
    fwd_dir, bwd_dir = Path(fwd_dir), Path(bwd_dir)
    out_fwd_dir, out_bwd_dir = Path(out_fwd_dir), Path(out_bwd_dir)
    out_fwd_dir.mkdir(parents=True, exist_ok=True)
    out_bwd_dir.mkdir(parents=True, exist_ok=True)

    fwd_files = sorted(fwd_dir.glob("*.pfm"))
    bwd_files = sorted(bwd_dir.glob("*.pfm"))
    # into_future flow i pairs with into_past flow i+1 (frames i -> i+1 -> i)
    n = 0
    for i in range(len(fwd_files) - 1):
        f = read_pfm(fwd_files[i])[..., :2]
        b = read_pfm(bwd_files[i + 1])[..., :2]
        _write_png(out_fwd_dir / (fwd_files[i].stem + ".png"),
                   occlusion_from_fb(f, b, device=device))
        _write_png(out_bwd_dir / (bwd_files[i + 1].stem + ".png"),
                   occlusion_from_fb(b, f, device=device))
        n += 1
    return n


def generate(root, split="TRAIN", device="cuda"):
    """Every ``optical_flow/<split>/*/*/into_future/left`` directory of the
    tree at ``root``, with its into_past twin, into ``occlusions/``.
    returns the number of pairs written."""
    root = Path(root)
    total = 0
    for fwd in sorted(root.glob(f"optical_flow/{split}/*/*/into_future/left")):
        bwd = Path(str(fwd).replace("into_future", "into_past"))
        out_f = Path(str(fwd).replace("optical_flow", "occlusions"))
        out_b = Path(str(bwd).replace("optical_flow", "occlusions"))
        total += process_pair_dir(fwd, bwd, out_f, out_b, device=device)
    return total


def main(argv=None):
    parser = argparse.ArgumentParser(description="generate FlyingThings3D occlusion maps")
    parser.add_argument("--root", default="datasets/FlyingThings3D")
    parser.add_argument("--split", default="TRAIN")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    logger.info("generated %d occlusion pairs", generate(args.root, args.split, args.device))


if __name__ == "__main__":
    main()
