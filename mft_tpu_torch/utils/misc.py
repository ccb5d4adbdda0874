"""Small shared helpers: scale strings, pair generation, conversions.

A copy of ``mft_tpu/utils/misc.py`` (reference MFT/utils/misc.py), whose
``ensure_numpy`` here knows torch tensors instead of jax arrays.
"""

import numpy as np
import torch


def ensure_numpy(x):
    """Numpy arrays pass through; torch tensors are detached and fetched to
    the host; anything else goes through ``np.asarray``."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def parse_scale_WH(scale_WH: str, frames_shape: dict):
    """Parse a resolution string into a list of {'W', 'H', ...} dicts.

    Grammar (reference MFT/utils/misc.py:65-92): '_'-separated stages, each
    'fullres', 'WxH', 'Wx' (keep aspect) or 'xH' (keep aspect). A stage's
    missing side is computed from the ORIGINAL frame shape's aspect ratio,
    e.g. '256x256_512x512' resizes to 256x256, then to 512x512.
    """
    if scale_WH == "fullres":
        return [frames_shape]
    out = []
    for stage in scale_WH.split("_"):
        if stage == "fullres":
            out.append(frames_shape)
            continue
        new_shape = dict(frames_shape.items())
        w_str, h_str = stage.split("x")
        W = int(w_str) if w_str != "" else None
        H = int(h_str) if h_str != "" else None
        if W is None and H is None:
            raise ValueError(f"scale stage {stage!r}: at least one side must be set")
        new_shape["W"] = W if W is not None else int(round(frames_shape["W"] * (H / frames_shape["H"])))
        new_shape["H"] = H if H is not None else int(round(frames_shape["H"] * (W / frames_shape["W"])))
        out.append(new_shape)
    return out


def make_pairs(xs):
    """Consecutive pairs [(x0, x1), (x1, x2), ...]."""
    return list(zip(xs[:-1], xs[1:]))


def make_delta_pairs(xs, delta=1):
    """Pairs ``(xs[i - delta], xs[i])`` with their indices, out-of-range left
    ones skipped: yields (left_i, left, right_i, right)."""
    for i, x in enumerate(xs):
        left_i = i - delta
        if left_i < 0:
            continue
        yield (left_i, xs[left_i], i, x)


def trim_string(x, max_len, end="..."):
    """``x`` cut to ``max_len`` characters, ``end`` marking the cut."""
    if len(end) >= max_len:
        raise ValueError(f"end {end!r} does not fit in {max_len} characters")
    if len(x) > max_len:
        x = x[: max_len - len(end)] + end
    return x
