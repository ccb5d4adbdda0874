"""Demo app: track a video, render point tracks + first-frame edit propagation.

Port of ``mft_tpu/apps/demo.py`` (role parity with reference demo.py): a
query grid is tracked from frame 0, drawn as occlusion-colored dots into
``<out>/<name>_points.mp4``, and an "edit" overlay drawn on the first frame
is propagated to every frame by forward splatting into
``<out>/<name>_edit.mp4``, as the JAX demo writes them. Input is a video
file (MP4/QuickTime, AVI or Matroska, whatever its suffix, with MPEG-4
Part 2 or Motion JPEG video, as cv2 reads it) or a PNG/JPEG image
directory; the outputs are ``mp4v`` files (:mod:`mft_tpu_torch.io.video`:
the port's codecs, their pixel stages on the card).

    python -m mft_tpu_torch.apps.demo --video <clip.mp4|.avi|.mkv|.mov or image-dir>
        [--config synth] [--out demo_out] [--grid_spacing 30] [--max_frames N]
        [--device cpu]

Drawing without OpenCV: a dot is the filled radius-3 disc of
``cv2.circle(img, center, 3, color, -1)`` (8-connected, not anti-aliased),
the edit the filled rectangle of the JAX demo. The JAX edit's text label
(``cv2.putText``) is not drawn: it needs a font rasterizer.
"""

import argparse
import logging
from pathlib import Path

import numpy as np

from mft_tpu_torch.config import tracker_config
from mft_tpu_torch.io.video import VideoWriter, get_video_frames
from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking
from mft_tpu_torch.utils.various import debug_entry

logger = logging.getLogger(__name__)

# cv2.circle(..., radius=3, thickness=-1): the half-width of each row of the
# filled disc, rows dy = -3..3
_DISC_HALF_WIDTHS = (0, 2, 2, 3, 2, 2, 0)
EDIT_COLOR = (0, 200, 255)


def get_queries(frame_shape, spacing=30):
    """Grid of query points every ``spacing`` px (reference demo.py:106-116)."""
    H, W = frame_shape[:2]
    xs = np.arange(spacing // 2, W, spacing, dtype=np.float32)
    ys = np.arange(spacing // 2, H, spacing, dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    return np.stack([xg.reshape(-1), yg.reshape(-1)], axis=1)


def _fill_disc(canvas, xi, yi, color):
    H, W = canvas.shape[:2]
    for dy, half in zip(range(-3, 4), _DISC_HALF_WIDTHS):
        y = yi + dy
        if 0 <= y < H:
            canvas[y, max(xi - half, 0):min(xi + half + 1, W)] = color


def draw_dots(frame, coords, occlusions):
    """Visible points green, occluded red (reference demo.py:118-128)."""
    canvas = frame.copy()
    for (x, y), occl in zip(coords, occlusions):
        xi, yi = int(round(float(x))), int(round(float(y)))
        if 0 <= xi < frame.shape[1] and 0 <= yi < frame.shape[0]:
            _fill_disc(canvas, xi, yi, (0, 0, 255) if occl > 0.5 else (0, 255, 0))
    return canvas


def make_default_edit(frame):
    """A synthetic first-frame edit: the JAX demo's filled rectangle, corners
    (W // 8, H // 8) and (W // 2, H // 4) included (its text label is not
    drawn)."""
    H, W = frame.shape[:2]
    edit = np.zeros((H, W, 3), np.uint8)
    edit[H // 8:H // 4 + 1, W // 8:W // 2 + 1] = EDIT_COLOR
    return edit


def draw_edit(frame, result, edit, edit_mask):
    """Propagate the first-frame edit by forward splatting the edit pixels
    along the template->current flow (reference demo.py:130-146); the splats
    run on the result's device, the blend on the host."""
    warped = result.warp_forward(edit.astype(np.float32), mask=edit_mask,
                                 border=0.0).cpu().numpy()
    warped_mask = result.warp_forward(edit_mask.astype(np.float32)[..., None],
                                      border=0.0)[..., 0].cpu().numpy()
    alpha = np.clip(warped_mask, 0, 1)[..., None]
    out = frame.astype(np.float32) * (1 - alpha) + warped * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


def render_frame(frame, result, queries, edit, edit_mask):
    """One frame's output: the dots and the edit drawn over ``frame``.

    returns: (points image, edit image, coords (N, 2), occlusion (N,)).
    """
    coords, occl = convert_to_point_tracking(result, queries)
    return (draw_dots(frame, coords, occl), draw_edit(frame, result, edit, edit_mask),
            coords, occl)


def run(args):
    config = tracker_config(args.config)
    tracker = config.tracker_class(config, device=args.device)
    video_name = Path(args.video).stem
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    queries = None
    edit = edit_mask = None
    writer_pts = VideoWriter(out_dir / f"{video_name}_points.mp4", fps=args.fps,
                             device=args.device)
    writer_edit = VideoWriter(out_dir / f"{video_name}_edit.mp4", fps=args.fps,
                              device=args.device)
    n_frames = 0
    try:
        for i, frame in enumerate(get_video_frames(args.video, device=args.device)):
            if args.max_frames and i >= args.max_frames:
                break
            if i == 0:
                meta = tracker.init(frame)
                queries = get_queries(frame.shape, args.grid_spacing)
                edit = make_default_edit(frame)
                edit_mask = edit.any(axis=2)
            else:
                meta = tracker.track(frame)
            dots, edited, _, _ = render_frame(frame, meta.result, queries, edit, edit_mask)
            writer_pts.write(dots)
            writer_edit.write(edited)
            n_frames += 1
    finally:
        writer_pts.close()
        writer_edit.close()
    logger.info("wrote %d frames to %s", n_frames, out_dir)
    return n_frames


def get_parser():
    parser = argparse.ArgumentParser(description="mft-tpu demo (PyTorch port)")
    parser.add_argument("--video", required=True,
                        help="input video file (MP4/QuickTime, AVI or Matroska; MPEG-4 "
                             "Part 2 or Motion JPEG) or PNG/JPEG image directory")
    parser.add_argument("--config", default="default",
                        help="tracker config: default, synth, fast, warm, demo_cpu "
                             "or a .py file building a port config")
    parser.add_argument("--out", default="demo_out")
    parser.add_argument("--grid_spacing", type=int, default=30)
    parser.add_argument("--fps", type=float, default=25.0)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return parser


def _main(argv=None):
    logging.basicConfig(level=logging.INFO)
    return run(get_parser().parse_args(argv))


def main(argv=None):
    """The CLI; with ``MFT_TPU_DEBUG`` set, an exception opens pdb post mortem."""
    return debug_entry(_main)(argv)


if __name__ == "__main__":
    main()
