"""TAP-Vid dataset reading and query sampling.

A copy of ``mft_tpu/eval/tapvid.py`` (reference
MFT/evaluation/tapvid_eval_stuff.py, DeepMind's Apache-2.0 protocol code)
without OpenCV: pickle readers for DAVIS-form dicts, the multi-stage
scaling strings ('256x256_512x512'), first/strided query sampling, and the
fake/lazy video modes of metric-only runs. The protocol's conventions are
kept: points in the pickles are [x, y] scaled to 0..1; query points are
[t, y, x] in FINAL-resolution raster coordinates; strided queries every 5
frames at visible positions.

:func:`resize_video` reproduces ``cv2.resize`` on uint8 frames bit for bit,
as the JAX package calls it: ``INTER_AREA`` when neither side grows (the
integer-factor block average, 2 x 2 rounding half up, or the general area
weights summed in float32 in OpenCV's order), ``INTER_LINEAR`` otherwise
(11-bit fixed-point weights, the vertical pass in OpenCV's vector form
((b0 * (S0 >> 4) >> 16) + (b1 * (S1 >> 4) >> 16) + 2) >> 2), a copy when the
size is unchanged.

The RGB-Stacking reader takes its pickle of decoded arrays, the JHMDB
reader its PNG frames (through :mod:`mft_tpu_torch.io.png`, converted to
RGB where the JAX package uses PIL) and ``joint_positions.mat`` (through
``scipy.io``). A TAP-Vid-Kinetics shard (a list of records whose frames are
JPEG bytes) is decoded by the port's codec as the JAX package's
``PIL.Image.open`` decodes it: RGB, no EXIF orientation, a grey file as
(H, W); each record's files are entropy-decoded on host threads and go
through J2 in one launch where their sizes agree (:mod:`mft_tpu_torch.io.jpeg`).
"""

import math
import pickle
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.jpeg import decode_jpeg_frames
from mft_tpu_torch.io.png import decode_png, to_bgr
from mft_tpu_torch.utils.misc import parse_scale_WH

COEF_BITS = 11                      # cv2's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _linear_tab(ssize: int, dsize: int, clamp: bool, scale=None):
    """cv2's INTER_LINEAR source index and fixed-point weights (a0, a1) per
    destination index; ``clamp`` as on the horizontal axis (the vertical one
    clips its rows instead); ``scale`` source pixels a destination pixel
    (``1 / fx`` where ``cv2.resize`` was given fx; else from the sizes)."""
    scale = 1.0 / (dsize / ssize) if scale is None else scale
    d = np.arange(dsize, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        lo, hi = s < 0, s >= ssize - 1
        f[lo | hi] = 0
        s[lo] = 0
        s[hi] = ssize - 1
    a0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int64)
    a1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int64)
    return s, a0, a1


def _resize_linear(frame, Ho, Wo, scale_x=None, scale_y=None):
    H, W, C = frame.shape
    sx, a0, a1 = _linear_tab(W, Wo, clamp=True, scale=scale_x)
    src = frame.astype(np.int64)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, W - 1)] * a1[None, :, None])   # (H, Wo, C)
    sy, b0, b1 = _linear_tab(H, Ho, clamp=False, scale=scale_y)
    s0 = rows[np.clip(sy, 0, H - 1)] >> 4
    s1 = rows[np.clip(sy + 1, 0, H - 1)] >> 4
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((s0 * b0) >> 16) + ((s1 * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_tab(ssize: int, dsize: int):
    """cv2's computeResizeAreaTab: (destination, source, float32 weight)
    entries in OpenCV's order."""
    scale = 1.0 / (dsize / ssize)
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


def _resize_area(frame, Ho, Wo):
    H, W, C = frame.shape
    scale_x, scale_y = 1.0 / (Wo / W), 1.0 / (Ho / H)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        # integer factors: block sums (cv2's resizeAreaFast)
        sums = (frame[:Ho * iy, :Wo * ix].astype(np.int64)
                .reshape(Ho, iy, Wo, ix, C).sum(axis=(1, 3)))
        if ix == 2 and iy == 2 and C in (1, 3, 4):
            return ((sums + 2) >> 2).astype(np.uint8)
        mean = sums.astype(np.float32) * np.float32(1.0 / (ix * iy))
        return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
    src = frame.astype(np.float32)
    rows = np.zeros((H, Wo, C), np.float32)
    for dx, sx, alpha in _area_tab(W, Wo):
        rows[:, dx] = rows[:, dx] + src[:, sx] * alpha
    out = np.zeros((Ho, Wo, C), np.float32)
    prev = None
    for dy, sy, beta in _area_tab(H, Ho):
        if dy != prev:
            out[dy] = beta * rows[sy]
            prev = dy
        else:
            out[dy] = out[dy] + beta * rows[sy]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _resize_frame(frame, output_size):
    """One (H, W, C) uint8 frame resized to output_size = (H', W') as
    ``cv2.resize`` does in the JAX package's ``resize_video``."""
    H, W = frame.shape[:2]
    Ho, Wo = output_size
    if (Ho, Wo) == (H, W):
        return frame.copy()
    if Ho <= H and Wo <= W:
        return _resize_area(frame, Ho, Wo)
    return _resize_linear(frame, Ho, Wo)


def resize_video(video, output_size, fake_video=False, lazy_video=False):
    """Resize an (N, H, W, 3) uint8 video to output_size = (H', W').

    ``fake_video`` returns zeros (metric-only runs never look at pixels,
    reference tapvid_eval_stuff.py:70-75); ``lazy_video`` returns per-frame
    thunks.
    """
    N, H, W, C = video.shape
    Ho, Wo = output_size
    if fake_video:
        return np.zeros((N, Ho, Wo, C), dtype=video.dtype)
    if lazy_video:
        return [(lambda f=video[i]: _resize_frame(f, (Ho, Wo))) for i in range(N)]
    return np.stack([_resize_frame(video[i], (Ho, Wo)) for i in range(N)])


def sample_queries_first(target_occluded, target_points, frames):
    """One query per track at its first visible frame.

    args: target_occluded (N, T) bool; target_points (N, T, 2) [x, y] in
    raster coords; frames (T, H, W, 3).
    returns dict with video (1, T, H, W, 3), query_points (1, N, 3) [t, y, x],
    target_points (1, N, T, 2), occluded (1, N, T), trackgroup (1, N).
    Reference parity: tapvid_eval_stuff.py:339-386.
    """
    valid = np.sum(~target_occluded, axis=1) > 0
    target_points = target_points[valid]
    target_occluded = target_occluded[valid]
    trackgroup = np.arange(target_occluded.shape[0])

    first_visible = np.argmax(~target_occluded, axis=1)  # (N,)
    q = np.stack([
        first_visible.astype(np.float64),
        target_points[np.arange(len(first_visible)), first_visible, 1],
        target_points[np.arange(len(first_visible)), first_visible, 0],
    ], axis=-1)
    return {
        "video": frames[None],
        "query_points": q[None],
        "target_points": target_points[None],
        "occluded": target_occluded[None],
        "trackgroup": trackgroup[None],
    }


def sample_queries_strided(target_occluded, target_points, frames,
                           query_stride=5):
    """Queries at every ``query_stride``-th frame where the track is visible;
    a track appears once per such frame (trackgroup records the source
    track). Reference parity: tapvid_eval_stuff.py:275-336."""
    queries, tracks, occs, groups = [], [], [], []
    trackgroup = np.arange(target_occluded.shape[0])
    for i in range(0, target_occluded.shape[1], query_stride):
        mask = ~target_occluded[:, i]
        q = np.stack([
            np.full(target_occluded.shape[0], i, np.float64),
            target_points[:, i, 1],
            target_points[:, i, 0],
        ], axis=-1)
        queries.append(q[mask])
        tracks.append(target_points[mask])
        occs.append(target_occluded[mask])
        groups.append(trackgroup[mask])
    return {
        "video": frames[None],
        "query_points": np.concatenate(queries)[None],
        "target_points": np.concatenate(tracks)[None],
        "occluded": np.concatenate(occs)[None],
        "trackgroup": np.concatenate(groups)[None],
    }


def _load_kinetics_video(data, device):
    """A Kinetics record's list of JPEG byte strings -> (N, H, W, 3) uint8
    RGB (or (N, H, W) for grey files), as ``PIL.Image.open`` decodes them."""
    frames = decode_jpeg_frames(data["video"], device, orient=False, rgb=True, keep_grey=True)
    data["video"] = np.stack(frames)
    return data


def load_pickle_sequences(pickle_path, device="cuda"):
    """A TAP-Vid pickle as its ordered {name: record} dict (reference
    tapvid_eval_stuff.py:552-579): a DAVIS-form dict as it is, a Kinetics
    shard (a list of records with JPEG frames) as records ``kin-<shard>-<i>``
    with decoded frames (``device`` runs the decoder)."""
    with open(pickle_path, "rb") as f:
        data = pickle.load(f)
    if isinstance(data, list):
        shard = Path(pickle_path).stem
        data = {f"kin-{shard}-{i:04d}": _load_kinetics_video(rec, device)
                for i, rec in enumerate(data)}
    return data


def create_tapvid_dataset(pickle_path, query_modes, scaling=None,
                          fake_video=False, lazy_video=False, device="cuda"):
    """Yield per-sequence evaluation records.

    args:
      pickle_path: TAP-Vid pickle (DAVIS dict or Kinetics shard list; the
        shard's JPEG frames are decoded for ``device``).
      query_modes: iterable of 'first' / 'strided'.
      scaling: resolution string ('256x256', '256x256_512x512', 'fullres',
        ...): the video passes through ALL stages in order; query and target
        points are scaled to the FINAL stage's resolution.
      fake_video / lazy_video: skip or defer the pixels (metric-only runs).

    yields: {'video_name': str, 'data': {mode: sampled record}}.
    Reference parity: tapvid_eval_stuff.py:552-672.
    """
    if isinstance(query_modes, str):
        query_modes = [query_modes]
    sequences = load_pickle_sequences(pickle_path, device)
    for name, record in sequences.items():
        frames = record["video"]
        N, H, W, C = frames.shape
        stages = parse_scale_WH(scaling or "fullres", {"W": W, "H": H})
        for stage in stages:
            frames = resize_video(frames, (stage["H"], stage["W"]),
                                  fake_video=fake_video, lazy_video=lazy_video)
            if lazy_video and not isinstance(frames, np.ndarray):
                break  # lazy mode: single stage only
        final = stages[-1]

        points = record["points"] * np.array([final["W"], final["H"]])
        occluded = record["occluded"]

        data = {}
        for mode in query_modes:
            if mode == "first":
                data[mode] = sample_queries_first(occluded, points, frames)
            elif mode == "strided":
                data[mode] = sample_queries_strided(occluded, points, frames)
            else:
                raise ValueError(f"unknown query mode {mode}")
        yield {"video_name": name, "data": data}


def create_rgb_stacking_dataset(pickle_path, query_mode="strided",
                                train_size=(256, 256)):
    """TAP-Vid RGB-stacking (robotics) sequences.

    Reference parity: tapvid_eval_stuff.py:675-702 — a pickle holding a LIST
    of examples with decoded video arrays; frames are normalized to [-1, 1]
    and the point coordinates scaled to the fixed 256x256 protocol size.

    yields: {'robotics': sampled record}.
    """
    with open(pickle_path, "rb") as f:
        examples = pickle.load(f)
    H, W = train_size
    for example in examples:
        frames = example["video"]
        if frames.shape[1:3] != (H, W):  # native RGB-stacking is 256x256
            frames = resize_video(frames, (H, W))
        frames = frames.astype(np.float32) / 255.0 * 2.0 - 1.0
        points = example["points"] * np.array([W, H])
        occluded = example["occluded"]
        if query_mode == "strided":
            converted = sample_queries_strided(occluded, points, frames)
        elif query_mode == "first":
            converted = sample_queries_first(occluded, points, frames)
        else:
            raise ValueError(f"unknown query mode {query_mode!r}")
        yield {"robotics": converted}


def _read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG, as PIL's ``Image.open(path).convert('RGB')``
    gives it: alpha dropped, grey replicated, palettes expanded, 16-bit colour
    samples' high byte, 16-bit grey clipped at 255 (where ``cv2.imread`` keeps
    the high byte)."""
    img = decode_png(Path(path).read_bytes())
    if img.dtype == np.uint16 and img.ndim == 2:
        img = np.minimum(img, 255).astype(np.uint8)
    return np.ascontiguousarray(to_bgr(img)[:, :, ::-1])


def create_jhmdb_dataset(jhmdb_path, train_size=(256, 256)):
    """JHMDB pose-tracking sequences (split1 test videos) for PCK eval.

    Reference parity: tapvid_eval_stuff.py:389-485, without the TF I/O and
    without the convergence-display shuffle (videos come in sorted order —
    the per-video records are identical). Layout expected under
    ``jhmdb_path``: ``splits/*_test_split1.txt`` (``<video>.avi 2`` marks
    test videos), ``joint_positions/<video>/joint_positions.mat`` (field
    ``pos_img`` (2, n_joints, n_frames)), ``Rename_Images/<video>/*.png``.

    yields: {'jhmdb': record} with video/query/target points scaled to
    ``train_size``, invalid first-frame joints set to -1, frames in [-1, 1].
    """
    from scipy import io as scipy_io

    root = Path(jhmdb_path)
    videos = []
    for split_file in sorted((root / "splits").glob("*split1.txt")):
        video_folder = "_".join(split_file.name.split("_")[:-2])
        for line in split_file.read_text().splitlines():
            if not line.strip():
                continue
            video, traintest = line.split()
            video = video.rsplit(".", 1)[0]
            if int(traintest) == 2:
                videos.append(f"{video_folder}/{video}")
    if not videos:
        raise ValueError(f"No JHMDB videos found in directory {jhmdb_path}")

    Ht, Wt = train_size
    for video in videos:
        joints = root / "joint_positions" / video / "joint_positions.mat"
        if not joints.exists():
            continue
        gt_pose = scipy_io.loadmat(str(joints))["pos_img"]
        gt_pose = np.transpose(gt_pose, [1, 2, 0])  # (n_joints, n_frames, 2)

        frame_files = sorted((root / "Rename_Images" / video).glob("*.png"))
        frames = np.stack([_read_rgb(f) for f in frame_files])
        height, width = frames.shape[1:3]

        invalid = np.logical_or(
            np.logical_or(gt_pose[:, 0:1, 0] < 0, gt_pose[:, 0:1, 0] >= width),
            np.logical_or(gt_pose[:, 0:1, 1] < 0, gt_pose[:, 0:1, 1] >= height))
        invalid = np.tile(invalid, [1, gt_pose.shape[1]])[..., None].astype(np.float32)

        gt_pose_orig = gt_pose
        gt_pose = gt_pose * np.array([Wt / width, Ht / height])
        gt_pose = (1.0 - invalid) * gt_pose + invalid * (-1.0)

        frames = resize_video(frames, (Ht, Wt))
        frames = frames / (255.0 / 2.0) - 1.0
        queries = gt_pose[:, 0]
        queries = np.concatenate([queries[..., 0:1] * 0, queries[..., ::-1]],
                                 axis=-1)
        if gt_pose.shape[1] < frames.shape[0]:
            frames = frames[: gt_pose.shape[1]]  # pose shorter than video

        yield {"jhmdb": {
            "video": frames[np.newaxis],
            "query_points": queries[np.newaxis],
            "target_points": gt_pose[np.newaxis],
            "gt_pose": gt_pose[np.newaxis],
            "gt_pose_orig": gt_pose_orig[np.newaxis],
            "occluded": gt_pose[np.newaxis, ..., 0] * 0,
            "fname": video,
            "im_size": np.array([height, width]),
        }}
