"""Benchmark report: the port's TAP-Vid results beside published baselines.

Port of ``mft_tpu/eval/report.py`` (reference run_eval_report.py:35-113)
without pandas or tabulate: it reads the evaluator's pickles, appends the
published competitor numbers (as the reference hardcodes them) and prints
the same org-mode tables (x100, one decimal; a metric a baseline lacks
reads ``nan``); ``--latex`` adds LaTeX rows through ``latex_table``.

Usage::

    python -m mft_tpu_torch.eval.report --trackers synth
"""

import argparse
import logging
import pickle

from mft_tpu_torch.config import tracker_config
from mft_tpu_torch.eval.evaluate import eval_path
from mft_tpu_torch.eval.metrics import latex_table

logger = logging.getLogger(__name__)

COLUMNS = {
    "average_jaccard": "AJ",
    "average_pts_within_thresh": "<D_avg",
    "occlusion_accuracy": "OA",
    "average_prec": "prec_avg",
}

# published numbers (x100) from the reference report generator
BASELINES_STRIDED = {
    "TAP-Net": {"AJ": 38.4, "<D_avg": 53.1, "OA": 82.3},
    "PIPs": {"AJ": 42.0, "<D_avg": 59.4, "OA": 82.1},
    "OmniMotion": {"AJ": 51.7, "<D_avg": 67.5, "OA": 85.3},
    "TAPIR": {"AJ": 61.3, "<D_avg": 72.3, "OA": 87.6},
    "CoTracker": {"AJ": 64.8, "<D_avg": 79.1, "OA": 88.7},
}
BASELINES_FIRST = {
    "TAP-Net": {"AJ": 33.0, "<D_avg": 48.6, "OA": 78.8},
    "TAPIR": {"AJ": 56.2, "<D_avg": 70.0, "OA": 86.5},
    "CoTracker": {"AJ": 60.6, "<D_avg": 75.4, "OA": 89.3},
}


def _means(export_dir, name, query_mode):
    path = eval_path(export_dir, name, query_mode)
    if not path.exists():
        return None
    with open(path, "rb") as f:
        return pickle.load(f)["means"]


def tracker_row(export_dir, name, query_mode):
    """{short column: mean x100 to one decimal} of one tracker, or None."""
    means = _means(export_dir, name, query_mode)
    if means is None:
        return None
    return {short: round(float(means[long]) * 100, 1)
            for long, short in COLUMNS.items() if long in means}


def org_table(rows: dict) -> str:
    """{row name: {column: value}} as tabulate's 'orgtbl' with floatfmt
    '.1f' prints a pandas frame of it: the columns in order of first
    appearance, names left-aligned, numbers right-aligned at the decimal
    point, a missing value 'nan'."""
    cols = []
    for row in rows.values():
        cols += [c for c in row if c not in cols]
    names = list(rows)

    def cell(name, col):
        # 'nan' has no fraction: it ends where the others' '.d' begins
        return f"{rows[name][col]:.1f}" if col in rows[name] else "nan  "

    cells = {c: [cell(n, c) for n in names] for c in cols}
    w0 = max([len(n) for n in names] + [2])
    widths = {c: max([len(c) + 2] + [len(s) for s in cells[c]]) for c in cols}
    lines = ["| " + " " * w0 + " | " + " | ".join(c.rjust(widths[c]) for c in cols) + " |",
             "|" + "-" * (w0 + 2) + "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "|"]
    for i, n in enumerate(names):
        lines.append("| " + n.ljust(w0) + " | "
                     + " | ".join(cells[c][i].rjust(widths[c]) for c in cols) + " |")
    return "\n".join(lines)


def report(tracker_names, export_dir, query_modes=("first", "strided"), latex=False):
    out = []
    for query_mode in query_modes:
        rows = dict(BASELINES_STRIDED if query_mode == "strided" else BASELINES_FIRST)
        for name in tracker_names:
            row = tracker_row(export_dir, name, query_mode)
            if row is not None:
                rows[f"{name} (ours)"] = row
        out.append(f"* TAP-Vid-DAVIS {query_mode} (x100, 256x256 protocol)\n"
                   f"{org_table(rows)}")
        if latex:
            for name in tracker_names:
                means = _means(export_dir, name, query_mode)
                if means is not None:
                    out.append(f"* LaTeX {name} {query_mode}\n" + latex_table(means))
    text = "\n\n".join(out)
    print(text)
    return text


def main():
    parser = argparse.ArgumentParser(description="TAP-Vid report")
    parser.add_argument("--trackers", nargs="+", default=["default"])
    parser.add_argument("--export", default="export")
    parser.add_argument("--mode", choices=["first", "strided", "both"], default="both")
    parser.add_argument("--latex", action="store_true", help="also emit LaTeX table rows")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    names = [tracker_config(p).name for p in args.trackers]
    modes = ["first", "strided"] if args.mode == "both" else [args.mode]
    report(names, args.export, modes, latex=args.latex)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
