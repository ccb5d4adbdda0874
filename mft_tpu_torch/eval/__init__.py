"""TAP-Vid evaluation: dataset reading, metrics, the benchmark runner,
the evaluator and the report, and the Sintel/KITTI submission writers (port
of ``mft_tpu/eval``; reference MFT/evaluation/, MFT/runners/,
run_eval_report.py and MFT/RAFT/evaluate.py). TAP-Vid-Kinetics shards'
JPEG frames decode through the port's codec (:mod:`mft_tpu_torch.io.jpeg`).
"""

from mft_tpu_torch.eval.metrics import compute_tapvid_metrics
from mft_tpu_torch.eval.tapvid import (create_tapvid_dataset, resize_video,
                                       sample_queries_first, sample_queries_strided)

__all__ = ["compute_tapvid_metrics", "sample_queries_first", "sample_queries_strided",
           "resize_video", "create_tapvid_dataset"]
