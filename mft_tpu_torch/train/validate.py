"""Validation: EPE, pixel-threshold rates, occlusion accuracy, uncertainty.

Port of ``mft_tpu/train/validate.py`` (reference MFT/RAFT/evaluate.py:
75-344): full-resolution forward passes padded to a multiple of 8, EPE and
the 1/3/5 px rates, occlusion accuracy on hard ground truth, uncertainty
overshoot/sub1/sub5; Kubric sweeps the deltas [1, 2, 4, 8, 16]. The forward
is the model's test mode with the batch norm's running statistics (the
reference validates its model in eval mode), so a train-mode model
validates too.
"""

import contextlib
import logging

import numpy as np
import torch

from mft_tpu_torch.models.raft.layers import BatchNorm

logger = logging.getLogger(__name__)

KUBRIC_VAL_DELTAS = (1, 2, 4, 8, 16)


def flow_metrics(pred_flow, gt_flow, valid):
    epe = np.sqrt(np.sum((pred_flow - gt_flow) ** 2, axis=-1))
    epe_v = epe[valid > 0.5]
    if epe_v.size == 0:
        return {}
    return {"epe": float(epe_v.mean()), "1px": float((epe_v < 1).mean()),
            "3px": float((epe_v < 3).mean()), "5px": float((epe_v < 5).mean())}


def ou_metrics(pred_occl, pred_sigma, gt_occl, gt_flow, pred_flow, valid):
    """Occlusion accuracy on hard ground truth + uncertainty calibration."""
    v = valid > 0.5
    m = v & ((gt_occl < 0.01) | (gt_occl > 0.99))
    out = {}
    if m.any():
        out["occl_acc"] = float(((pred_occl > 0.5) == (gt_occl > 0.5))[m].mean())
    epe = np.sqrt(np.sum((pred_flow - gt_flow) ** 2, axis=-1))
    nonoccl = v & (gt_occl < 0.01)
    if nonoccl.any():
        s, e = pred_sigma[nonoccl], epe[nonoccl]
        out["unc_overshoot"] = float(np.maximum(e - s, 0).mean())
        out["unc_sub1"] = float((s < 1).mean())
        out["unc_sub5"] = float((s < 5).mean())
    return out


@contextlib.contextmanager
def running_statistics(model):
    """Batch norm on its running statistics inside the block."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.use_batch_stats for m in norms]
    for m in norms:
        m.use_batch_stats = False
    try:
        yield model
    finally:
        for m, s in zip(norms, saved):
            m.use_batch_stats = s


def _forward(model, img1, img2, iters):
    """Padded full-resolution forward -> (flow, occl_prob, sigma) numpy."""
    from mft_tpu_torch.models.raft.wrapper import pad_to_8
    H, W = img1.shape[:2]
    (pt, pb), (pl, pr) = pad_to_8(H, W)
    pad = ((pt, pb), (pl, pr), (0, 0))
    device = next(model.parameters()).device
    to_t = lambda im: torch.from_numpy(np.pad(im, pad, mode="edge").astype(np.float32)).permute(
        2, 0, 1)[None].to(device)
    with torch.no_grad(), running_statistics(model):
        out = model(to_t(img1), to_t(img2), iters=iters, test_mode=True)
    sl = (0, slice(pt, pt + H), slice(pl, pl + W))
    flow = out["flow"][sl].cpu().numpy()
    occl = torch.softmax(out["occlusion"], dim=-1)[..., 1][sl].cpu().numpy()
    sigma = torch.sqrt(torch.exp(out["uncertainty"][..., 0]))[sl].cpu().numpy()
    return flow, occl, sigma


def _mean_rows(rows):
    keys = set().union(*(r.keys() for r in rows)) if rows else set()
    return {k: float(np.mean([r[k] for r in rows if k in r])) for k in keys}


def validate_dataset(dataset, model, iters=12, max_samples=None):
    """Dense-GT validation over a FlowDataset-style dataset."""
    rows = []
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        img1, img2, gt_flow, valid, gt_occl = dataset[i]
        flow, occl, sigma = _forward(model, img1, img2, iters)
        row = flow_metrics(flow, gt_flow, valid)
        row.update(ou_metrics(occl, sigma, gt_occl, gt_flow, flow, valid))
        rows.append(row)
    return _mean_rows(rows)


def validate_kubric(model, iters=12, max_scenes=None, env=None):
    """Long-term flow validation over deltas (reference evaluate.py:215-300)."""
    from mft_tpu_torch.environment import env_settings
    from mft_tpu_torch.train.datasets import KubricLongTerm
    env = env or env_settings()
    ds = KubricLongTerm(None, split="validation", root=env.kubric_dir, correct_flow=True)
    out = {}
    for delta in KUBRIC_VAL_DELTAS:
        rows = []
        for idx, (_, i) in enumerate(ds.extra_info):
            if i + 1 != delta:
                continue
            if max_scenes is not None and len(rows) >= max_scenes:
                break
            img1, img2, gt_flow, valid, gt_occl = ds[idx]
            flow, occl, sigma = _forward(model, img1, img2, iters)
            row = flow_metrics(flow, gt_flow, valid)
            row.update(ou_metrics(occl, sigma, gt_occl, gt_flow, flow, valid))
            rows.append(row)
        if rows:
            out[f"delta{delta}"] = _mean_rows(rows)
    return out


def run_validation(name, model, iters=12, max_samples=32):
    """Dispatch by validation set name (reference evaluate.py validate_*)."""
    from mft_tpu_torch.environment import env_settings
    from mft_tpu_torch.train import datasets as D
    env = env_settings()
    if name == "sintel_val_subsplit":
        ds = D.MpiSintel(None, dstype="final", root=env.sintel_dir, load_occlusion=True,
                         subsplit="val")
    elif name == "sintel":
        ds = D.MpiSintel(None, dstype="final", root=env.sintel_dir)
    elif name == "chairs":
        ds = D.FlyingChairs(None, split="validation", root=env.flyingchairs_dir)
    elif name == "kubric":
        return validate_kubric(model, iters, max_scenes=8)
    elif name == "kitti":
        ds = D.KITTI(None, root=env.kitti_dir)
    elif name == "viper":
        ds = D.VIPER(None, root=getattr(env, "viper_dir", "datasets/VIPER"))
    else:
        raise ValueError(f"unknown validation set {name!r}")
    ds.device = next(model.parameters()).device
    return validate_dataset(ds, model, iters, max_samples)
