"""TAP-Vid evaluator: score prediction pickles against the ground truth.

Port of ``mft_tpu/eval/evaluate.py`` (reference
MFT/runners/eval_MFT_tapvid.py:69-161) without pandas: it reads the runner's
``{seq}-{mode}.pklz`` predictions, binarizes occlusion at 0.5, computes the
TAP-Vid metrics on pixel-free (fake) video, and writes
``export/<name>/eval/tapvid-eval[-strided].pklz`` as a plain pickled
{'rows': [one dict of metrics a sequence, 'seq' its name], 'means': {metric:
mean over the sequences}} (the JAX package writes a pandas DataFrame there).

Usage::

    python -m mft_tpu_torch.eval.evaluate --trackers synth --dataset tapvid_davis
"""

import argparse
import logging
import pickle
from pathlib import Path

import numpy as np

from mft_tpu_torch.config import dataset_config, tracker_config
from mft_tpu_torch.eval.metrics import compute_tapvid_metrics
from mft_tpu_torch.eval.tapvid import create_tapvid_dataset
from mft_tpu_torch.utils.various import debug_entry

logger = logging.getLogger(__name__)

OCCLUSION_THRESHOLD = 0.5  # eval-time binarization (eval_MFT_tapvid.py:107)


def evaluate_tracker(result_dir, dataset_conf, query_mode):
    """-> [row dict a sequence]: its metrics' means over the batch, 'seq'."""
    rows = []
    for pickle_path in dataset_conf.pickles:
        dataset = create_tapvid_dataset(pickle_path, [query_mode],
                                        dataset_conf.scaling, fake_video=True)
        for seq in dataset:
            name = seq["video_name"]
            pred_path = Path(result_dir) / f"{name}-{query_mode}.pklz"
            if not pred_path.exists():
                logger.warning("missing predictions for %s", pred_path.name)
                continue
            with open(pred_path, "rb") as f:
                pred = pickle.load(f)

            gt = seq["data"][query_mode]
            H = gt["video"].shape[2]
            W = gt["video"].shape[3]
            scale = np.array([256.0 / W, 256.0 / H]).reshape(1, 1, 1, 2)
            gt_tracks = gt["target_points"] * scale
            # query points stay in final-resolution coords: the metrics read
            # only their t component (eval_MFT_tapvid.py:91-92)
            query_points = gt["query_points"][0].astype(np.int64)

            metrics = compute_tapvid_metrics(
                query_points[None], gt["occluded"], gt_tracks,
                pred["occluded"] > OCCLUSION_THRESHOLD, pred["tracks"], query_mode)
            row = {k: float(np.mean(v)) for k, v in metrics.items()}
            row["seq"] = name
            rows.append(row)
    return rows


def mean_row(rows) -> dict:
    """{metric: mean over the rows} of every metric (not 'seq')."""
    keys = [k for k in (rows[0] if rows else {}) if k != "seq"]
    return {k: float(np.mean([r[k] for r in rows])) for k in keys}


def eval_path(export, name, query_mode) -> Path:
    suffix = "-strided" if query_mode == "strided" else ""
    return Path(export) / name / "eval" / f"tapvid-eval{suffix}.pklz"


def run(args):
    """Evaluate every tracker's predictions; returns {(name, mode): means}."""
    dataset_conf = dataset_config(args.dataset)
    out = {}
    for spec in args.trackers:
        cfg = tracker_config(spec)
        result_dir = Path(args.export) / cfg.name / "results"
        for query_mode in (["first", "strided"] if args.mode == "both" else [args.mode]):
            rows = evaluate_tracker(result_dir, dataset_conf, query_mode)
            path = eval_path(args.export, cfg.name, query_mode)
            path.parent.mkdir(parents=True, exist_ok=True)
            means = mean_row(rows)
            with open(path, "wb") as f:
                pickle.dump({"rows": rows, "means": means}, f)
            logger.info("%s %s:\n%s", cfg.name, query_mode,
                        "\n".join(f"{k:<28}{v:.6f}" for k, v in means.items()))
            out[(cfg.name, query_mode)] = means
    return out


def get_parser():
    parser = argparse.ArgumentParser(description="evaluate TAP-Vid predictions")
    parser.add_argument("--trackers", nargs="+", default=["default"])
    parser.add_argument("--dataset", default="tapvid_davis")
    parser.add_argument("--export", default="export")
    parser.add_argument("--mode", choices=["first", "strided", "both"], default="both")
    return parser


def _main():
    logging.basicConfig(level=logging.INFO)
    run(get_parser().parse_args())
    return 0


def main():
    """The CLI; with ``MFT_TPU_DEBUG`` set, an exception opens pdb post mortem."""
    return debug_entry(_main)()


if __name__ == "__main__":
    raise SystemExit(main())
