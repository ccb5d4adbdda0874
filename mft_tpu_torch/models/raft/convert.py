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

The reference's own checkpoints (PyTorch RAFT-OU ``.pth`` files, saved
through a DataParallel wrapper, so their names may start with ``module.``)
name the layers otherwise; the counterparts of the JAX package's
``mft_tpu/models/raft/convert.py`` map them, name for name as its
``torch_statedict_to_variables`` does (its KeyError for a name it does not
map included):

  fnet.layer2.0.conv1.*         <-> fnet.layer2_0.conv1.*
  fnet.layer2.0.downsample.0.*  <-> fnet.layer2_0.downsample_conv.*
  cnet.layer2.0.downsample.1.*  <-> cnet.layer2_0.norm3.*  (batch norm; the
                                    reference's own norm3 is the same module)
  update_block.mask.0 / .2      <-> update_block.mask_conv1 / mask_conv2
  occlusion_block.<head>.model.{0,2,4,6} <-> <head>.conv{0..3}  ('morelayers')

:func:`params_from_reference` reads such a state dict into the port's,
:func:`reference_state_dict` writes the port's under the reference's names,
:func:`export_torch_checkpoint` saves that as a ``.pth`` (which
``wrapper.load_weights`` reads back), and :func:`main` (``python -m
mft_tpu_torch.models.raft.convert in.pth out.msgpack``) writes its flax
variables file as the JAX package's ``convert.main`` does, byte for byte.
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


# the reference's fnet normalizes by instance norm (no parameters), its cnet
# by batch norm (raft.py:62-63; the small model's norms have no parameters)
_ENCODER = re.compile(r"^(fnet|cnet)\.(conv1|conv2|norm1|layer(\d)\.(\d)\.(.+?))\."
                      r"(weight|bias|running_mean|running_var)$")
_BLOCK_NORM = {"norm1": "norm1", "norm2": "norm2", "downsample.1": "norm3"}


def port_name(key: str):
    """The port's state-dict name of a reference name (``module.`` or not),
    None for a tensor the port keeps none of (``num_batches_tracked``, a
    block's ``norm3``, the alias of its ``downsample.1``, and fnet's block
    norms, as the JAX package's converter skips them); ``KeyError`` for a
    name that that converter does not map either."""
    key = re.sub(r"^module\.", "", key)
    if key.endswith("num_batches_tracked"):
        return None
    leaf = key.rsplit(".", 1)[-1]
    m = _ENCODER.match(key)
    if m:
        enc, batch = m[1], m[1] == "cnet"
        conv_leaf = leaf in ("weight", "bias")
        if m[2] in ("conv1", "conv2") and conv_leaf:
            return f"{enc}.{m[2]}.{leaf}"
        if m[2] == "norm1":                      # the stem's norm
            if not batch:
                raise KeyError(f"the port's instance norm has no parameters: {key}")
            return f"{enc}.norm1.{leaf}"
        block, sub = f"layer{m[3]}_{m[4]}", m[5]
        if sub in ("conv1", "conv2", "conv3") and conv_leaf:
            return f"{enc}.{block}.{sub}.{leaf}"
        if sub == "downsample.0" and conv_leaf:
            return f"{enc}.{block}.downsample_conv.{leaf}"
        if sub in _BLOCK_NORM:
            return f"{enc}.{block}.{_BLOCK_NORM[sub]}.{leaf}" if batch else None
        if sub == "norm3":
            return None
        raise KeyError(f"unmapped encoder sub-layer: {key}")
    m = re.match(r"^update_block\.(encoder|gru|flow_head)\.(\w+)\.(weight|bias)$", key)
    if m:
        return key
    m = re.match(r"^update_block\.mask\.(0|2)\.(weight|bias)$", key)
    if m:
        return f"update_block.mask_conv{1 if m[1] == '0' else 2}.{m[2]}"
    m = re.match(r"^occlusion_block\.(occl_head|uncertainty_head)\.(conv1|conv2)\."
                 r"(weight|bias)$", key)
    if m:
        return key
    m = re.match(r"^occlusion_block\.(occl_head|uncertainty_head)\.model\.(\d)\."
                 r"(weight|bias)$", key)
    if m:
        return f"occlusion_block.{m[1]}.conv{int(m[2]) // 2}.{m[3]}"
    raise KeyError(f"unmapped torch parameter: {key}")


# names that only the reference's state dicts have
_REFERENCE_ONLY = re.compile(r"^module\.|\.layer\d\.\d\.|num_batches_tracked$|"
                             r"^update_block\.mask\.\d\.|\.model\.\d\.")


def is_reference_state_dict(state) -> bool:
    """Whether a state dict names its tensors as the reference does (some
    name only the reference uses) rather than as the port does."""
    return any(_REFERENCE_ONLY.search(k) for k in state)


def params_from_reference(state) -> dict:
    """A reference state dict -> the port's (float32 tensors; OIHW in both)."""
    out = {}
    for key, value in state.items():
        name = port_name(key)
        if name is not None:
            out[name] = torch.as_tensor(value).detach().to("cpu", torch.float32).clone()
    return out


def _sorted(tree):
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def variables_from_reference(state) -> dict:
    """A reference state dict -> flax variables {'params'[, 'batch_stats']}
    as nested dicts of numpy arrays, the JAX package's
    ``torch_statedict_to_variables``: kernels HWIO, values in their stored
    dtype, every level's keys sorted (as flax's ``msgpack_serialize``, which
    flattens the tree as a pytree, writes them)."""
    tree = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        name = port_name(key)
        if name is None:
            continue
        arr = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        if name.endswith(".weight") and arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))        # OIHW -> HWIO
        node = tree[_COLLECTION[name.rsplit(".", 1)[-1]]]
        *mods, leaf = flax_path(name).split("/")
        for mod in mods:
            node = node.setdefault(mod, {})
        node[leaf] = arr
    return _sorted({k: v for k, v in tree.items() if v or k == "params"})


def reference_state_dict(state, module_prefix: bool = False) -> dict:
    """The port's state dict under the reference's names, as its
    ``model.state_dict()`` holds them: a stride-2 block's batch norm as both
    ``norm3`` and ``downsample.1``, every batch norm with a
    ``num_batches_tracked`` of 0, and ``module.`` before every name with
    ``module_prefix`` (the DataParallel form)."""
    heads_with_conv0 = {n.rsplit(".", 2)[0] for n in state if re.search(r"\.conv0\.", n)}
    out = {}
    for name, value in state.items():
        value = value.detach().cpu()
        m = re.match(r"^(fnet|cnet)\.layer(\d)_(\d)\.(\w+)\.(\w+)$", name)
        keys = [name]
        if m:
            enc, a, b, mod, leaf = m.groups()
            base = f"{enc}.layer{a}.{b}"
            if mod == "downsample_conv":
                keys = [f"{base}.downsample.0.{leaf}"]
            elif mod == "norm3":
                keys = [f"{base}.norm3.{leaf}", f"{base}.downsample.1.{leaf}"]
            else:
                keys = [f"{base}.{mod}.{leaf}"]
        elif name.startswith("update_block.mask_conv"):
            mod, leaf = name.split(".")[1:]
            keys = [f"update_block.mask.{0 if mod == 'mask_conv1' else 2}.{leaf}"]
        elif name.rsplit(".", 2)[0] in heads_with_conv0:
            head, mod, leaf = name.rsplit(".", 2)
            keys = [f"{head}.model.{2 * int(mod[4:])}.{leaf}"]
        for key in keys:
            out[key] = value.clone()
            if key.endswith(".running_var"):
                out[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    if module_prefix:
        out = {f"module.{k}": v for k, v in out.items()}
    return out


def export_torch_checkpoint(state, out_pth, module_prefix: bool = True):
    """Write the port's state dict (or a model's) as a reference-style
    ``.pth`` (:func:`reference_state_dict`)."""
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    torch.save(reference_state_dict(state, module_prefix), out_pth)
    return out_pth


def main(argv=None):
    """CLI: convert a reference torch .pth state dict to a flax msgpack
    checkpoint, as the JAX package's ``convert.main`` writes it.

    Usage: python -m mft_tpu_torch.models.raft.convert in.pth out.msgpack
    """
    import argparse
    from pathlib import Path

    from mft_tpu_torch.models.raft.flax_msgpack import dumps
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("src", help="torch .pth checkpoint")
    parser.add_argument("dst", help="output flax .msgpack path")
    args = parser.parse_args(argv)
    state = torch.load(args.src, map_location="cpu", weights_only=True)
    variables = variables_from_reference(state)
    Path(args.dst).parent.mkdir(parents=True, exist_ok=True)
    Path(args.dst).write_bytes(dumps(variables))
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
