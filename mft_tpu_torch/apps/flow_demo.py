"""Pairwise-flow demo: run the RAFT-OU network on consecutive frames and
render flow-colorwheel panels.

Port of ``mft_tpu/apps/flow_demo.py`` (role parity with the reference's RAFT
demo, MFT/RAFT/demo.py:42-75): read a video file (MP4/QuickTime, AVI or
Matroska; MPEG-4 Part 2 or Motion JPEG) or a PNG/JPEG image directory,
compute flow for each consecutive pair, and write each panel
(frame stacked over flow color, reference demo.py:33) to
``<out>/flow_XXXX.png``; ``--mp4`` also writes the panels to
``<out>/flow.mp4``, as the JAX demo does (the port's ``mp4v`` encoder).

    python -m mft_tpu_torch.apps.flow_demo --video <clip.mp4|.avi|.mkv|.mov or image-dir>
        [--config synth] [--out flow_demo_out] [--show_ou] [--mp4] [--device cpu]
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from mft_tpu_torch.config import tracker_config
from mft_tpu_torch.io.png import encode_png
from mft_tpu_torch.io.video import VideoWriter, get_video_frames
from mft_tpu_torch.utils.vis import flow_to_color

logger = logging.getLogger(__name__)


def flow_panel(frame_bgr, flow, extra=None):
    """Stack the frame over its flow-color rendering (reference demo.py:26-39,
    ``viz``). With OU ``extra``, a third row shows occlusion (red) and
    sigma (green) maps."""
    flow_rgb = flow_to_color(np.asarray(flow))
    rows = [frame_bgr, flow_rgb[:, :, ::-1]]  # flow_to_color is RGB; demo is BGR
    if extra is not None:
        occl = np.clip(np.asarray(extra["occlusion"]), 0.0, 1.0)
        sigma = np.asarray(extra["sigma"])
        sigma = sigma / max(float(sigma.max()), 1e-6)
        ou = np.stack([np.zeros_like(occl), sigma, occl], axis=-1)
        rows.append((ou * 255).astype(np.uint8))
    return np.concatenate(rows, axis=0)


def run(args):
    config = tracker_config(args.config)
    flower = config.flow_config.of_class(config.flow_config, device=args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    writer = None
    prev = None
    n = 0
    for frame in get_video_frames(args.video, device=args.device):
        if prev is not None:
            flow, extra = flower.compute_flow(prev, frame, mode="flow", numpy_out=True)
            panel = flow_panel(prev, flow, extra if args.show_ou else None)
            (out_dir / f"flow_{n:04d}.png").write_bytes(encode_png(panel))
            if args.mp4:
                if writer is None:
                    writer = VideoWriter(out_dir / "flow.mp4", fps=args.fps, device=args.device)
                writer.write(panel)
            n += 1
        prev = frame
    if writer is not None:
        writer.close()
    logger.info("wrote %d flow panels to %s", n, out_dir)
    return n


def get_parser():
    parser = argparse.ArgumentParser(description="pairwise-flow demo (PyTorch port)")
    parser.add_argument("--video", required=True,
                        help="video file (MP4/QuickTime, AVI or Matroska; MPEG-4 Part 2 or "
                             "Motion JPEG) or PNG/JPEG image directory")
    parser.add_argument("--config", default="default",
                        help="tracker config (default, synth, fast, warm, demo_cpu or "
                             "a .py file); its flow_config selects the net")
    parser.add_argument("--out", default="flow_demo_out")
    parser.add_argument("--mp4", action="store_true",
                        help="also write the panels to <out>/flow.mp4")
    parser.add_argument("--show_ou", action="store_true",
                        help="append an occlusion/sigma panel row")
    parser.add_argument("--fps", type=float, default=10.0)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return parser


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
