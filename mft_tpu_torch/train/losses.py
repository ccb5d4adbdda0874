"""Sequence losses of RAFT-OU training: flow L1, occlusion CE, uncertainty.

Port of ``mft_tpu/train/losses.py`` (reference MFT/RAFT/train.py:44-245),
channel-last: flow (B, H, W, 2); occl and valid (B, H, W); predictions are
lists over iterations, occlusion (B, H, W, 2) logits and uncertainty
(B, H, W, 1) log-variances. As there:

- every mask multiplies and every mean is over the FULL tensor;
- iteration i of n weighs gamma^(n-i-1);
- flow loss 'L1', 'L1_non_occluded' or 'L1_occluded_to_epe3';
- the occlusion cross-entropy, on hard 0/1 ground truth only, takes the
  SOFTMAXED logits (the reference's double softmax, kept for parity), its
  mask applied per sample;
- uncertainty: exp(-alpha) * huber(epe) + alpha/2 ('huber', 'L2' and their
  '_non_occluded' forms), the 'huber_epe_direct' forms, and the optional
  polynomial re-weighting;
- pixels whose ground-truth flow reaches MAX_FLOW = 400 are left out.
"""

import torch

MAX_FLOW = 400.0


def _huber(x, beta: float = 1.0):
    """torch SmoothL1Loss with beta = 1."""
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _base_valid(flow_gt, valid, max_flow):
    mag = torch.sqrt((flow_gt * flow_gt).sum(dim=-1))
    return (valid >= 0.5) & (mag < max_flow)


def _epe(pred, flow_gt):
    d = pred - flow_gt
    return torch.sqrt((d * d).sum(dim=-1))


FLOW_RATIOS = ("train/epe", "train/1px", "train/3px", "train/5px")


def flow_metric_sums(flow_pred, flow_gt, valid, max_flow=MAX_FLOW):
    """The sums behind the ratio metrics of :func:`sequence_flow_loss`:
    ((4,) float32 sums over the valid pixels of the EPE and of the 1, 3 and
    5 px indicators of ``flow_pred``, in ``FLOW_RATIOS``' order; the valid
    pixel count, int64). Each metric is its sum over max(count, 1), JAX's
    ``vmean``; a data-parallel step divides the sums all-reduced over its
    ranks by the count all-reduced likewise, the global batch's figure."""
    return _metric_sums(flow_pred, flow_gt, _base_valid(flow_gt, valid, max_flow))


def _metric_sums(flow_pred, flow_gt, base_valid):
    epe = _epe(flow_pred, flow_gt)
    vsum = lambda x: torch.where(base_valid, x, 0.0).sum()
    return (torch.stack([vsum(epe), vsum((epe < 1).float()), vsum((epe < 3).float()),
                         vsum((epe < 5).float())]), base_valid.sum())


def sequence_flow_loss(flow_preds, flow_gt, valid, occl_gt=None, gamma=0.8,
                       max_flow=MAX_FLOW, flow_loss_type="L1"):
    """Gamma-weighted L1 flow loss. returns (loss, metrics) with the EPE and
    the 1, 3 and 5 px rates of the last prediction."""
    base_valid = _base_valid(flow_gt, valid, max_flow)
    hard_occl = None
    if "occl" in flow_loss_type:
        if occl_gt is None:
            raise ValueError(f"flow_loss_type {flow_loss_type!r} needs occl_gt")
        hard_occl = occl_gt > 0.99
    n = len(flow_preds)
    loss = 0.0
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        abs_err = (pred - flow_gt).abs()
        if flow_loss_type == "L1":
            m = base_valid
        elif flow_loss_type == "L1_non_occluded":
            m = base_valid & ~hard_occl
        elif flow_loss_type == "L1_occluded_to_epe3":
            m = base_valid & (~hard_occl | (_epe(pred, flow_gt).detach() < 3.0))
        else:
            raise NotImplementedError(flow_loss_type)
        loss = loss + w * (m[..., None] * abs_err).mean()
    sums, count = _metric_sums(flow_preds[-1].detach(), flow_gt, base_valid)
    return loss, dict(zip(FLOW_RATIOS, (sums / count.clamp(min=1)).unbind()))


def sequence_occl_loss(occl_preds, occl_gt, flow_gt, valid, gamma=0.8, max_flow=MAX_FLOW):
    """Cross-entropy of the softmaxed occlusion logits on hard 0/1 ground truth."""
    m = _base_valid(flow_gt, valid, max_flow) & ((occl_gt < 0.01) | (occl_gt > 0.99))
    labels = (occl_gt > 0.5).long()
    n = len(occl_preds)
    loss = 0.0
    i_loss = None
    for i, logits in enumerate(occl_preds):
        w = gamma ** (n - i - 1)
        probs = torch.softmax(logits, dim=-1)           # the quirk
        logp = torch.log_softmax(probs, dim=-1)
        i_loss = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = loss + w * (m * i_loss).mean()
    return loss, {"train/cross_entropy_occl": i_loss.mean()}


_POLY = (-7.27864588e-02, 9.00020608e+00, -1.79078330e+01, 8.68281513e+01)


def _epe_weight_poly(epe):
    """Polynomial epe re-weighting (reference train.py:161-171)."""
    c = torch.tensor(_POLY, dtype=torch.float32, device=epe.device)
    e = epe.clamp(0.0, 50.0).detach()
    return (e ** 3 * c[0] + e ** 2 * c[1] + e * c[2] + c[3]) / 50.0


def sequence_uncertainty_loss(flow_preds, uncertainty_preds, flow_gt, valid, gamma=0.8,
                              max_flow=MAX_FLOW, uncertainty_loss_type="huber",
                              weighting_unc_loss=False, occl_gt=None):
    """Heteroscedastic uncertainty loss (He et al. 2019 eq. 9-10)."""
    base_valid = _base_valid(flow_gt, valid, max_flow)
    if "non_occluded" in uncertainty_loss_type:
        base_valid = base_valid & ~(occl_gt > 0.99)
    n = len(flow_preds)
    loss = 0.0
    i_loss = None
    for i in range(n):
        w = gamma ** (n - i - 1)
        alpha = uncertainty_preds[i][..., 0]
        d = flow_preds[i] - flow_gt
        sq = (d * d).sum(dim=-1)
        epe = torch.sqrt(sq).detach()
        if uncertainty_loss_type in ("huber", "huber_non_occluded", "L2", "L2_non_occluded"):
            exp_neg = torch.exp(-alpha)
            l2 = uncertainty_loss_type.startswith("L2")
            err = 0.5 * exp_neg * (epe * epe) if l2 else exp_neg * _huber(epe)
            i_loss = err + 0.5 * alpha
            if weighting_unc_loss:
                i_loss = _epe_weight_poly(epe * epe if l2 else _huber(epe)) * i_loss
        elif uncertainty_loss_type in ("huber_epe_direct", "huber_epe_direct_non_occluded"):
            comp = -alpha * torch.exp(-alpha)
            i_loss = _huber(comp - sq.detach())
            if weighting_unc_loss:
                i_loss = _epe_weight_poly(epe) * i_loss
        else:
            raise NotImplementedError(uncertainty_loss_type)
        loss = loss + w * (base_valid * i_loss).mean()
    return loss, {"train/uncert": i_loss.mean()}


def sequence_loss(preds, flow_gt, valid, occl_gt=None, gamma=0.8, max_flow=MAX_FLOW, *,
                  freeze_optical_flow=False, occlusion_module="separate_with_uncertainty",
                  uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
                  weighting_unc_loss=False, alpha_flow=1.0, alpha_occl=5.0,
                  alpha_uncertainty=1.0):
    """The training objective (reference train.py:49-86): ``preds`` holds the
    'flow', 'occlusion' and 'uncertainty' lists of the train-mode forward.
    returns (loss, metrics)."""
    total = 0.0
    metrics = {}
    flow_loss, m = sequence_flow_loss(
        preds["flow"], flow_gt, valid, occl_gt=occl_gt, gamma=gamma, max_flow=max_flow,
        flow_loss_type="L1" if freeze_optical_flow else optical_flow_loss_type)
    metrics.update(m)
    if not freeze_optical_flow:   # the metrics are kept when flow is frozen
        total = total + alpha_flow * flow_loss
    if occlusion_module is not None:
        occl_loss, m = sequence_occl_loss(preds["occlusion"], occl_gt, flow_gt, valid,
                                          gamma=gamma, max_flow=max_flow)
        total = total + alpha_occl * occl_loss
        metrics.update(m)
    if occlusion_module is not None and "uncertainty" in occlusion_module:
        unc_loss, m = sequence_uncertainty_loss(
            preds["flow"], preds["uncertainty"], flow_gt, valid, gamma=gamma,
            max_flow=max_flow, uncertainty_loss_type=uncertainty_loss_type,
            weighting_unc_loss=weighting_unc_loss, occl_gt=occl_gt)
        total = total + alpha_uncertainty * unc_loss
        metrics.update(m)
    return total, metrics
