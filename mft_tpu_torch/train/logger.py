"""Training observability: scalar curves and image panels.

Port of ``mft_tpu/train/logger.py`` (reference tensorboard ``Logger``,
MFT/RAFT/train.py:262-346, and its VAL_FREQ image panels, train.py:
442-465) on its ``use_tensorboard=False`` path, which is the only one here
(the card's machine has no tensorboard): a running-mean console line every
SUM_FREQ steps, every flush and validation result appended to
``scalars.jsonl``, and panels written as PNGs through
:mod:`mft_tpu_torch.io.png`.
"""

import json
import logging
import time
from pathlib import Path

import numpy as np

from mft_tpu_torch.io.png import encode_png

logger = logging.getLogger(__name__)

SUM_FREQ = 10


def _numpy(x):
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def _to_numpy_first(x):
    """(B, H, W[, C]) or (H, W[, C]) array -> (H, W, C) float32 numpy; a 3D
    (1, H, W) array is a batched 2D map, an (H, W, C) one an image."""
    a = _numpy(x).astype(np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 3 and a.shape[0] == 1 and a.shape[-1] > 4:
        a = a[0]
    if a.ndim == 2:
        a = a[..., None]
    return a


def render_panel(key, value):
    """One named array -> uint8 RGB (H, W, 3): 'flow*' colorwheel,
    'occl*'/'sigma*' clamped grey, 'valid' binary, else the raw image
    (reference Logger.write_images, train.py:322-343)."""
    from mft_tpu_torch.utils.vis import flow_to_color
    a = _to_numpy_first(value)
    if "flow" in key:
        return flow_to_color(a[..., :2])
    if key == "valid":
        g = (a[..., 0] > 0.5).astype(np.uint8) * 255
        return np.stack([g, g, g], axis=-1)
    if "occl" in key or "sigma" in key:
        g = np.clip(a[..., 0], 0.0, 255.0).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    return np.clip(a, 0, 255).astype(np.uint8)[..., :3]


class TrainLogger:
    """Scalar and image logging of a training run. Files under ``run_dir``:
    ``scalars.jsonl`` (one {"step": n, ...} object per flush) and
    ``panels/step_N/KEY.png``."""

    def __init__(self, run_dir):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._scalar_file = open(self.run_dir / "scalars.jsonl", "a")
        self.total_steps = 0
        self.running = {}
        self._pushed = 0
        self._t0 = time.time()

    def _flush_running(self, lr=None):
        n = max(self._pushed, 1)   # a resumed run's first flush covers fewer steps
        means = {k: v / n for k, v in self.running.items()}
        if lr is not None:
            means["lr"] = lr
        self.write_dict(means)
        rate = (time.time() - self._t0) / n
        self._t0 = time.time()
        logger.info("step %6d %s (%.2f s/step)", self.total_steps,
                    " ".join(f"{k.split('/')[-1]}={v:.4f}" for k, v in means.items()), rate)
        self.running = {}
        self._pushed = 0

    def push(self, metrics, lr=None):
        """Accumulate one step's metrics; flush every SUM_FREQ steps."""
        self.total_steps += 1
        self._pushed += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % SUM_FREQ == 0:
            self._flush_running(lr=lr)

    def write_dict(self, results):
        """Write a scalar dict (e.g. validation results) at the current step."""
        rec = {"step": self.total_steps}
        rec.update({k: float(v) for k, v in results.items()})
        self._scalar_file.write(json.dumps(rec) + "\n")
        self._scalar_file.flush()

    def write_images(self, images):
        """Write named image panels as PNGs."""
        step_dir = self.run_dir / "panels" / f"step_{self.total_steps:06d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        for key, value in images.items():
            rgb = render_panel(key, value)
            (step_dir / f"{key}.png").write_bytes(encode_png(np.ascontiguousarray(rgb[..., ::-1])))

    def write_prediction_panels(self, batch, preds):
        """The reference's VAL_FREQ panel set (train.py:444-465).

        args: batch (img1, img2, flow_gt, valid, occl_gt) channel-last;
          preds the train-mode output dict of per-iteration lists.
        """
        img1, img2, flow_gt, valid, occl_gt = batch
        self.write_images({"image1": img1, "image2": img2, "valid": valid,
                           "flow_gt": flow_gt})
        if occl_gt is not None:
            self.write_images({"occl_gt": _numpy(occl_gt) * 255.0})
        self.write_images({"flow_est": preds["flow"][-1]})
        if preds.get("occlusion"):
            logits = _to_numpy_first(preds["occlusion"][-1])
            e = np.exp(logits - logits.max(axis=-1, keepdims=True))
            soft = e / e.sum(axis=-1, keepdims=True)
            self.write_images({"occl_est_neg": 255.0 * soft[..., 0:1],
                               "occl_est_pos": 255.0 * soft[..., 1:2]})
        if preds.get("uncertainty"):
            log_var = _to_numpy_first(preds["uncertainty"][-1])[..., 0:1]
            sigma2 = np.exp(log_var)
            sigma = np.sqrt(sigma2)
            panels = {"sigma2_est": sigma2 * 255.0, "sigma_est": sigma * 255.0}
            for name, s in (("sigma2_est_minmax", sigma2), ("sigma_est_minmax", sigma)):
                rng = s.max() - s.min()
                panels[name] = ((s - s.min()) / rng if rng > 0 else s) * 255.0
            self.write_images(panels)

    def close(self):
        self._scalar_file.close()
