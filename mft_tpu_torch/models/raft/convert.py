"""Carry the JAX package's RAFT-OU weights across: flax variables -> state dict.

``params_from_flax`` takes the flax ``{'params': ..., 'batch_stats': ...}``
tree as nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``
gives one) and returns a state dict for :class:`mft_tpu_torch.models.raft.RAFT`:

  .../kernel (kh, kw, cin, cout) HWIO  -> .../weight (cout, cin, kh, kw) OIHW
  .../bias                             -> .../bias
  .../BatchNorm_i/{scale, bias}        -> .../norm{i+1}.{weight, bias}
  batch_stats .../BatchNorm_i/{mean, var} -> .../norm{i+1}.running_{mean, var}

Every other name is the same in both trees (``fnet/layer2_0/downsample_conv``
is ``fnet.layer2_0.downsample_conv``), in every variant: the small model's
``fnet``/``cnet`` ``conv1``, ``layer{1,2,3}_{0,1}/conv{1,2,3}`` and
``downsample_conv`` (its instance norms and 'none' norms have no
parameters), ``update_block/encoder/{convc1,convf1,convf2,conv}``,
``update_block/gru/{convz,convr,convq}`` and ``update_block/flow_head``;
the 'morelayers' heads' ``occlusion_block/{occl_head,uncertainty_head}/
conv0..conv3``. A tree without batch norm (the small model) has no
'batch_stats'. ``flax_from_params`` maps back, for
writing weights the JAX package reads (``flax_msgpack.write_variables``), and
``flax_path`` gives a state-dict name's flax path.
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


_COLLECTION = {"weight": "params", "bias": "params", "running_mean": "batch_stats",
               "running_var": "batch_stats"}


def flax_path(name: str) -> str:
    """The flax path ('a/b/kernel') of a state-dict name ('a.b.weight'), in
    its collection."""
    *mods, leaf = name.split(".")
    norm = bool(mods) and re.fullmatch(r"norm\d", mods[-1]) is not None
    if norm:
        mods[-1] = f"BatchNorm_{int(mods[-1][4:]) - 1}"
        leaf = {"weight": "scale", "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    elif leaf == "weight":
        leaf = "kernel"
    return "/".join(mods + [leaf])


def flax_from_params(state) -> dict:
    """torch state dict -> flax variables {'params': ..., 'batch_stats': ...}
    as nested dicts of float32 numpy arrays (the inverse of
    :func:`params_from_flax`)."""
    tree = {}
    for name, value in state.items():
        col = _COLLECTION[name.split(".")[-1]]
        arr = value.detach().float().cpu().numpy()
        if arr.ndim == 4:
            arr = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))   # OIHW -> HWIO
        node = tree.setdefault(col, {})
        *mods, leaf = flax_path(name).split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return tree
