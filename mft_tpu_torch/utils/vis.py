"""Flow visualisation: the Baker et al. colorwheel.

A copy of ``flow_to_color`` from ``mft_tpu/utils/vis.py`` (reference
MFT/RAFT/core/utils/flow_viz.py) for the training logger's panels; the rest
of that module (overlays, tracks, grids, text) goes with the demo apps
(ROADMAP A11).
"""

import numpy as np


def _make_colorwheel():
    """55-color wheel (RY/YG/GC/CB/BM/MR ramps), rows = colors, cols = RGB."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False), (YG, 1, 0, True), (GC, 1, 2, False),
        (CB, 2, 1, True), (BM, 2, 0, False), (MR, 0, 2, True),
    ]
    for n, c_full, c_ramp, down in ramps:
        wheel[col:col + n, c_full] = 255
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, c_ramp] = 255 - ramp if down else ramp
        col += n
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_color(flow, clip_flow=None, convert_to_bgr=False, rad_max=None):
    """(H, W, 2) flow -> (H, W, 3) uint8 colorwheel visualization.

    Reference parity: flow_viz.py flow_to_color (magnitude-normalized hue
    encoding; unnormalized radius saturates toward white).
    """
    flow = np.asarray(flow, np.float32)
    if clip_flow is not None:
        flow = np.clip(flow, -clip_flow, clip_flow)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    if rad_max is None:
        rad_max = max(float(rad.max()), 1e-5)
    u, v = u / rad_max, v / rad_max
    rad = rad / rad_max

    ncols = _COLORWHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros((*u.shape, 3), np.uint8)
    for c in range(3):
        col0 = _COLORWHEEL[k0, c] / 255.0
        col1 = _COLORWHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate small flows toward white
        ch = 2 - c if convert_to_bgr else c
        img[..., ch] = np.floor(255 * col)
    return img
