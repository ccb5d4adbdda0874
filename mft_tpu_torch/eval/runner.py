"""TAP-Vid benchmark runner: track every sequence, write prediction pickles.

Port of ``mft_tpu/eval/runner.py`` (reference
MFT/runners/run_MFT_tapvid.py:86-316): per sequence x query mode x start
frame x direction, track with the port's MFT tracker (``track_chunk``),
sample the query tracks (``convert_to_point_tracking_batch``: one warp
launch per group of up to 64 frames), scale them to the 256x256 metric
raster and write ``{seq}-{mode}.pklz`` with {'tracks': (1, N, T, 2),
'occluded': (1, N, T)}, the JAX package's files, so its ``evaluate`` reads
them. One FlowCache per sequence serves every pass and config, so the
strided passes reuse pairwise flows. ``--cont`` skips existing results.

Usage (on the card; ``--device cpu`` runs the plain versions)::

    python -m mft_tpu_torch.eval.runner --trackers synth --dataset tapvid_davis

``--trackers`` takes the port's config names (``default``, ``synth``,
``fast``, ``warm``, ``demo_cpu``) or ``.py`` files whose ``get_config()``
builds a port config; ``--dataset`` ``tapvid_davis`` or such a file.
"""

import argparse
import logging
import pickle
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mft_tpu_torch.config import dataset_config, tracker_config
from mft_tpu_torch.eval.tapvid import create_tapvid_dataset
from mft_tpu_torch.io.cache import FlowCache
from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking_batch
from mft_tpu_torch.utils.repro import code_export
from mft_tpu_torch.utils.various import debug_entry

logger = logging.getLogger(__name__)

CONVERT_GROUP = 64   # frames per point-tracking conversion (one warp launch)


def track_sequence(tracker, video, start_frame, direction="forward",
                   flow_cache=None, chunk=8):
    """Track from ``start_frame`` to the video's end (or start, backward),
    ``chunk`` frames a ``track_chunk`` call (which goes frame by frame by
    itself when the cache holds any of the chunk's pairs).

    returns: {frame_i: meta}, meta.result a FlowOU (template -> frame_i).
    Reference parity: run_MFT_tapvid.py:251-285.
    """
    time_direction = 1 if direction == "forward" else -1
    metas = {start_frame: tracker.init(video[start_frame], start_frame_i=start_frame,
                                       time_direction=time_direction,
                                       flow_cache=flow_cache)}
    frame_is = (list(range(start_frame + 1, len(video))) if time_direction > 0
                else list(range(start_frame - 1, -1, -1)))
    for s in range(0, len(frame_is), chunk):
        idxs = frame_is[s:s + chunk]
        for fi, meta in zip(idxs, tracker.track_chunk([video[i] for i in idxs])):
            metas[fi] = meta
    return metas


def _flow_identity(cfg):
    """Everything that changes the pairwise flows a config produces (JAX
    ``_flow_identity``): the flow config, the deltas, the iteration schedule
    (its matching semantics, not its spelling) and the warm-start mode. The
    configs of one run must share it, as they share one cache a sequence."""
    def stable(v):
        # dict repr depends on insertion order
        if hasattr(v, "items"):
            return repr(sorted((str(k), stable(x)) for k, x in v.items()))
        return repr(v)

    def norm_sched(s):
        # numeric keys by value (1 == 1.0), 'inf' as infinity, other string
        # keys dropped (they never match); a sequence stays positional
        if not s:
            return None
        if hasattr(s, "items"):
            out = []
            for k, v in s.items():
                if isinstance(k, str):
                    if k == "inf":
                        out.append((float("inf"), int(v)))
                else:
                    out.append((float(k), int(v)))
            return tuple(sorted(out))
        return tuple(int(i) for i in s)

    fc = cfg.flow_config
    return (str(fc.model or None), int(fc.flow_iters or 12),
            stable(fc.raft_params or None),
            tuple(sorted(float(d) for d in cfg.deltas)),
            norm_sched(cfg.flow_iters_schedule or None),
            bool(cfg.warm_start_inf))


def _cache_state(cache: FlowCache) -> dict:
    """The cache's counters and tiers (before the sequence's clear)."""
    disk = len(list(cache.cache_dir.glob(f"*{cache.ext}"))) if cache.cache_dir else 0
    return dict(hits=cache.hits, misses=cache.misses,
                device_entries=len(cache.device_cache), device_bytes=cache.device_bytes,
                devices=sorted({str(v[0].device) for v in cache.device_cache.values()}),
                ram_entries=len(cache.ram_cache), ram_bytes=cache.ram_bytes,
                disk_entries=disk)


def run(args):
    """Track every sequence of the dataset with every tracker config.

    returns: {'passes': one record a tracked pass (seq, mode, config,
    start_frame, direction, frames, seconds of tracking to the device's
    completion, the cache's hits and misses in the pass), 'caches': {seq:
    the cache's state before its clear}}.
    """
    configs = [tracker_config(p) for p in args.trackers]
    config = configs[0]
    for cfg in configs:
        # the runner swaps tracker.C per config without rebuilding the
        # tracker, so every config's invariant is checked here
        if cfg.warm_start_inf and cfg.cache_delta_infinity:
            raise ValueError(
                f"config {cfg.name}: warm_start_inf and cache_delta_infinity "
                "cannot be combined (warm-started template flows depend on "
                "tracking history and are not reusable cache entries)")
    for cfg in configs[1:]:
        if _flow_identity(cfg) != _flow_identity(config):
            raise ValueError(
                "all tracker configs of one run must share the same flow "
                "setup (model, iters, raft_params, iteration schedule): "
                "pairwise flows are cached per sequence and reused across "
                f"configs. {cfg.name} differs from {config.name}.")
    tracker = config.tracker_class(config, device=args.device)
    sync = torch.cuda.synchronize if tracker.device.type == "cuda" else (lambda: None)
    dataset_conf = dataset_config(args.dataset)

    export_root = Path(args.export)
    for cfg in configs:
        (export_root / cfg.name / "results").mkdir(parents=True, exist_ok=True)
        code_export(export_root / cfg.name / "code")

    query_modes = ["first", "strided"] if args.mode == "both" else [args.mode]
    report = {"passes": [], "caches": {}}

    for pickle_path in dataset_conf.pickles:
        dataset = create_tapvid_dataset(pickle_path, query_modes, dataset_conf.scaling,
                                        device=args.device)
        for seq in dataset:
            name = seq["video_name"]
            if args.seq and name not in args.seq:
                continue
            video = seq["data"][query_modes[0]]["video"][0]
            video = np.ascontiguousarray(video[..., ::-1])  # RGB -> BGR

            cache_dir = Path(args.cache) / (dataset_conf.name or "ds") / name
            shutil.rmtree(cache_dir, ignore_errors=True)
            flow_cache = FlowCache(cache_dir, max_ram_mb=args.ram_cache_limit * 1e3,
                                   max_device_mb=args.device_cache_limit * 1e3)

            for query_mode in query_modes:
                gt = seq["data"][query_mode]
                query_points = gt["query_points"][0].astype(np.int64)  # (N, tyx)
                start_frames = np.unique(query_points[:, 0])
                N_queries, N_frames = query_points.shape[0], video.shape[0]

                for cfg in configs:
                    tracker.C = cfg  # the runner's config swap
                    out_path = export_root / cfg.name / "results" / f"{name}-{query_mode}.pklz"
                    if args.cont and out_path.exists():
                        logger.info("skipping %s (already computed)", out_path.name)
                        continue
                    pred_occluded = np.zeros((N_queries, N_frames))
                    pred_tracks = np.zeros((N_queries, N_frames, 2))

                    for start_frame in start_frames:
                        mask = query_points[:, 0] == start_frame
                        queries = query_points[mask, 1:][:, ::-1].astype(np.float32)  # yx -> xy

                        directions = ["forward"]
                        if query_mode == "strided":
                            directions.append("backward")
                        for direction in directions:
                            hits, misses = flow_cache.hits, flow_cache.misses
                            sync()
                            t0 = time.perf_counter()
                            metas = track_sequence(tracker, video, int(start_frame),
                                                   direction, flow_cache)
                            sync()
                            report["passes"].append(dict(
                                seq=name, mode=query_mode, config=cfg.name,
                                start_frame=int(start_frame), direction=direction,
                                frames=len(metas) - 1, seconds=time.perf_counter() - t0,
                                hits=flow_cache.hits - hits,
                                misses=flow_cache.misses - misses))
                            frame_list = (list(range(int(start_frame), N_frames))
                                          if direction == "forward"
                                          else list(range(int(start_frame), -1, -1)))
                            for g in range(0, len(frame_list), CONVERT_GROUP):
                                idxs = frame_list[g:g + CONVERT_GROUP]
                                coords, occl = convert_to_point_tracking_batch(
                                    [metas[i].result for i in idxs], queries)
                                for j, fi in enumerate(idxs):
                                    pred_tracks[mask, fi, :] = coords[j]
                                    pred_occluded[mask, fi] = occl[j]

                            # dense flowou export from the template frame
                            # (reference run_MFT_tapvid.py:210-217)
                            if (args.write_flow and start_frame == 0
                                    and query_mode == "first" and direction == "forward"):
                                flowou_dir = export_root / cfg.name / "flowous" / name
                                flowou_dir.mkdir(parents=True, exist_ok=True)
                                for frame_i in frame_list:
                                    metas[frame_i].result.write(
                                        flowou_dir / f"0--{frame_i}.flowouX16.pkl")

                    H, W = video.shape[1], video.shape[2]
                    scale = np.array([256.0 / W, 256.0 / H]).reshape(1, 1, 1, 2)
                    out = {"tracks": pred_tracks[None] * scale,
                           "occluded": pred_occluded[None]}
                    with open(out_path, "wb") as f:
                        pickle.dump(out, f)
                    logger.info("wrote %s", out_path)

            report["caches"][name] = _cache_state(flow_cache)
            logger.info("%s: flow cache %s", name, report["caches"][name])
            shutil.rmtree(cache_dir, ignore_errors=True)
            flow_cache.clear()
    return report


def get_parser():
    parser = argparse.ArgumentParser(description="run the port's MFT on TAP-Vid")
    parser.add_argument("--trackers", nargs="+", default=["default"],
                        help="config names (default, synth, fast, warm, demo_cpu) "
                             "or .py files building port configs")
    parser.add_argument("--dataset", default="tapvid_davis",
                        help="'tapvid_davis' or a .py dataset config file")
    parser.add_argument("--export", default="export")
    parser.add_argument("--cache", default="flow_cache")
    parser.add_argument("--mode", choices=["first", "strided", "both"], default="both")
    parser.add_argument("--seq", nargs="*", default=None)
    parser.add_argument("--cont", action="store_true",
                        help="skip sequences with existing results")
    parser.add_argument("--write_flow", action="store_true",
                        help="also export dense template->frame flowou files")
    parser.add_argument("--ram_cache_limit", type=float, default=10,
                        help="GB of host RAM for the flow cache")
    parser.add_argument("--device_cache_limit", type=float, default=5,
                        help="GB of device memory for the flow cache")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return parser


def _main():
    logging.basicConfig(level=logging.INFO)
    run(get_parser().parse_args())
    return 0


def main():
    """The CLI; with ``MFT_TPU_DEBUG`` set, an exception opens pdb post mortem."""
    return debug_entry(_main)()


if __name__ == "__main__":
    sys.exit(main())
