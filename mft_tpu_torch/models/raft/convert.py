"""Carry the JAX package's RAFT-OU weights across: flax variables -> state dict.

``params_from_flax`` takes the flax ``{'params': ..., 'batch_stats': ...}``
tree as nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``
gives one) and returns a state dict for :class:`mft_tpu_torch.models.raft.RAFT`:

  .../kernel (kh, kw, cin, cout) HWIO  -> .../weight (cout, cin, kh, kw) OIHW
  .../bias                             -> .../bias
  .../BatchNorm_i/{scale, bias}        -> .../norm{i+1}.{weight, bias}
  batch_stats .../BatchNorm_i/{mean, var} -> .../norm{i+1}.running_{mean, var}

Every other name is the same in both trees (``fnet/layer2_0/downsample_conv``
is ``fnet.layer2_0.downsample_conv``).
"""

import re

import numpy as np
import torch

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _walk(tree, path=()):
    for name, node in tree.items():
        if isinstance(node, dict) or hasattr(node, "items"):
            yield from _walk(node, path + (name,))
        else:
            yield path + (name,), node


def params_from_flax(variables) -> dict:
    """flax RAFT variables (nested dicts of arrays) -> torch state dict."""
    state = {}
    for col in ("params", "batch_stats"):
        for path, value in _walk(variables.get(col, {})):
            *mods, leaf = path
            key = _LEAF.get((col, leaf))
            if key is None:
                raise KeyError(f"unmapped flax leaf {col}/{'/'.join(path)}")
            mods = [re.sub(r"^BatchNorm_(\d)$", lambda m: f"norm{int(m[1]) + 1}", p)
                    for p in mods]
            arr = np.asarray(value, np.float32)
            if leaf == "kernel":
                arr = np.transpose(arr, (3, 2, 0, 1))   # HWIO -> OIHW
            state[".".join(mods + [key])] = torch.tensor(arr)
    return state
