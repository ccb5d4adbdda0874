"""TAP-Vid metrics: occlusion accuracy, <delta^x positions, Jaccard, AJ;
JHMDB PCK; LaTeX rows.

A copy of ``mft_tpu/eval/metrics.py`` (semantics of the reference's
Apache-2.0 evaluation code, MFT/evaluation/tapvid_eval_stuff.py:82-272).
Positions are in the 256x256 raster convention. Metrics are per video (the
batch axis kept); benchmark numbers are means over videos, x100.
"""

import numpy as np

THRESHOLDS = (1, 2, 4, 8, 16)
PCK_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5)


def compute_tapvid_metrics(query_points, gt_occluded, gt_tracks,
                           pred_occluded, pred_tracks, query_mode):
    """args:
      query_points: (B, N, 3) [t, y, x] query coordinates.
      gt_occluded, pred_occluded: (B, N, T) bool, True = occluded.
      gt_tracks, pred_tracks: (B, N, T, 2) [x, y] positions at 256x256 scale.
      query_mode: 'first' or 'strided'.

    returns: dict of per-video arrays (shape (B,)): occlusion_accuracy,
      occlusion_{FP,FN,TP,TN}, pts_within_{t}, prec_at_{t}, jaccard_{t} for
      t in {1,2,4,8,16}, average_jaccard, average_pts_within_thresh,
      average_prec.
    """
    query_points = np.asarray(query_points)
    gt_occluded = np.asarray(gt_occluded, bool)
    gt_tracks = np.asarray(gt_tracks)
    pred_occluded = np.asarray(pred_occluded, bool)
    pred_tracks = np.asarray(pred_tracks)
    B, N, T = gt_occluded.shape

    # evaluation mask: everything but the query frame itself...
    q_frame = np.round(query_points[..., 0]).astype(np.int32)  # (B, N)
    eval_pts = np.ones((B, N, T), bool)
    np.put_along_axis(eval_pts, q_frame[..., None], False, axis=2)
    # ...and the official 'first'-mode masking, which indexes
    # np.where(~gt_occluded[b])[0][0] on the (N, T) array: whole TRACKS before
    # the first track with a visible frame (a no-op when queries were sampled
    # at visible frames), kept so the numbers are the protocol's
    if query_mode == "first":
        for b in range(B):
            index = np.where(~gt_occluded[b])[0][0]
            eval_pts[b, :index] = False
    elif query_mode != "strided":
        raise ValueError(f"unknown query mode {query_mode}")

    out = {}
    n_eval = np.sum(eval_pts)
    out["occlusion_accuracy"] = np.sum(
        (pred_occluded == gt_occluded) & eval_pts, axis=(1, 2)) / n_eval
    out["occlusion_FP"] = np.sum(pred_occluded & ~gt_occluded & eval_pts, axis=(1, 2))
    out["occlusion_FN"] = np.sum(~pred_occluded & gt_occluded & eval_pts, axis=(1, 2))
    out["occlusion_TP"] = np.sum(pred_occluded & gt_occluded & eval_pts, axis=(1, 2))
    out["occlusion_TN"] = np.sum(~pred_occluded & ~gt_occluded & eval_pts, axis=(1, 2))

    visible = ~gt_occluded
    pred_visible = ~pred_occluded
    sq_dist = np.sum(np.square(pred_tracks - gt_tracks), axis=-1)  # (B, N, T)
    gt_visible_count = np.sum(visible & eval_pts, axis=(1, 2))

    frac_list, jac_list, prec_list = [], [], []
    for thresh in THRESHOLDS:
        within = sq_dist < thresh ** 2
        correct = within & visible

        frac = np.sum(correct & eval_pts, axis=(1, 2)) / gt_visible_count
        out[f"pts_within_{thresh}"] = frac
        frac_list.append(frac)

        tp = np.sum(correct & pred_visible & eval_pts, axis=(1, 2))
        prec = tp / np.sum(pred_visible & visible & eval_pts, axis=(1, 2))
        out[f"prec_at_{thresh}"] = prec
        prec_list.append(prec)

        # Jaccard denominator: GT-visible points + false positives (predicted
        # visible but GT-occluded or too far off)
        fp = np.sum(((~visible | ~within) & pred_visible) & eval_pts, axis=(1, 2))
        jac = tp / (gt_visible_count + fp)
        out[f"jaccard_{thresh}"] = jac
        jac_list.append(jac)

    out["average_jaccard"] = np.mean(np.stack(jac_list, axis=1), axis=1)
    out["average_pts_within_thresh"] = np.mean(np.stack(frac_list, axis=1), axis=1)
    out["average_prec"] = np.mean(np.stack(prec_list, axis=1), axis=1)
    return out


def compute_pck(gt_pose, pred_pose, valid=None, thresholds=PCK_THRESHOLDS):
    """JHMDB PCK: the fraction of keypoints within alpha * s_t of the ground
    truth, s_t the diagonal of frame t's ground-truth pose bounding box.

    args: gt_pose, pred_pose (T, J, 2) [x, y]; valid optional (T, J) or (T,)
    bool mask. returns: {'PCK@0.1': float, ...} fractions in [0, 1].
    """
    gt_pose = np.asarray(gt_pose, np.float64)
    pred_pose = np.asarray(pred_pose, np.float64)
    T, J, _ = gt_pose.shape
    if valid is None:
        valid = np.ones((T, J), bool)
    valid = np.asarray(valid, bool)
    if valid.ndim == 1:
        valid = np.tile(valid[:, None], (1, J))

    dist = np.sqrt(np.sum(np.square(pred_pose - gt_pose), axis=-1))  # (T, J)
    bbox = gt_pose.max(axis=1) - gt_pose.min(axis=1)                 # (T, 2)
    scale = np.sqrt(np.sum(np.square(bbox), axis=-1))                # (T,)
    n = max(int(valid.sum()), 1)
    return {f"PCK@{a:g}": float(np.sum((dist <= a * scale[:, None]) & valid) / n)
            for a in thresholds}


def latex_table(mean_scalars):
    """LaTeX header + body rows of TAP-Vid (or PCK) mean metrics: the
    reference's field order and delta-superscript headers, x100 at 3
    significant digits (tapvid_eval_stuff.py:240-272)."""
    if "average_jaccard" in mean_scalars:
        fields = (["average_jaccard", "average_pts_within_thresh",
                   "occlusion_accuracy"]
                  + [f"jaccard_{t}" for t in THRESHOLDS]
                  + [f"pts_within_{t}" for t in THRESHOLDS])
        header = (
            "AJ & $<\\delta^{x}_{avg}$ & OA & "
            + " & ".join(f"Jac. $\\delta^{{{i}}}$" for i in range(5)) + " & "
            + " & ".join(f"$<\\delta^{{{i}}}$" for i in range(5)))
    else:
        fields = [f"PCK@{a:g}" for a in PCK_THRESHOLDS]
        header = " & ".join(fields)
    body = " & ".join(
        f"{float(np.mean(mean_scalars[f]) * 100):.3}" for f in fields)
    return "\n".join([header, body])
