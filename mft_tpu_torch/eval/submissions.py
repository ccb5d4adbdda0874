"""Benchmark-submission writers: Sintel (.flo) and KITTI (16-bit png).

A copy of ``mft_tpu/eval/submissions.py`` (reference MFT/RAFT/evaluate.py:
22-71, create_sintel_submission / create_kitti_submission) without OpenCV:
run the flow model over the official test splits and write upload-ready
files, with the previous frame's flow passed as ``init_flow`` for Sintel
(the reference uses forward_interpolate; the dense flow takes its role).
Frames are read as ``cv2.imread`` reads them (:func:`io.png.imread`),
the files written by ``train.flow_readers``.
"""

import logging
from pathlib import Path

from mft_tpu_torch.io.png import imread
from mft_tpu_torch.train.flow_readers import write_flo, write_kitti_flow

logger = logging.getLogger(__name__)


def create_sintel_submission(flower, root, out_dir, dstype="final",
                             warm_start=True):
    """Write <out_dir>/<dstype>/<scene>/frame_XXXX.flo for the test split."""
    root = Path(root) / "test" / dstype
    out_root = Path(out_dir) / dstype
    n = 0
    for scene_dir in sorted(root.glob("*")):
        images = sorted(scene_dir.glob("*.png"))
        flow_prev = None
        scene_out = out_root / scene_dir.name
        scene_out.mkdir(parents=True, exist_ok=True)
        for i in range(len(images) - 1):
            img1 = imread(images[i])
            img2 = imread(images[i + 1])
            init = flow_prev if warm_start else None
            flow, _ = flower.compute_flow(img1, img2, mode="flow",
                                          init_flow=init, numpy_out=True)
            write_flo(scene_out / f"frame_{i + 1:04d}.flo", flow)
            if warm_start:
                flow_prev = flow
            n += 1
    logger.info("wrote %d sintel %s flows to %s", n, dstype, out_root)
    return n


def create_kitti_submission(flower, root, out_dir):
    """Write <out_dir>/flow/XXXXXX_10.png KITTI submission files."""
    root = Path(root) / "testing"
    out_root = Path(out_dir) / "flow"
    out_root.mkdir(parents=True, exist_ok=True)
    images1 = sorted(root.glob("image_2/*_10.png"))
    images2 = sorted(root.glob("image_2/*_11.png"))
    for i1, i2 in zip(images1, images2):
        flow, _ = flower.compute_flow(imread(i1), imread(i2), mode="flow",
                                      numpy_out=True)
        write_kitti_flow(out_root / i1.name, flow)
    logger.info("wrote %d kitti flows to %s", len(images1), out_root)
    return len(images1)
