"""Device mesh and data-parallel helpers over ``torch.distributed``.

Port of ``mft_tpu/parallel/mesh.py``. JAX runs one controller over every
device: a ``Mesh`` of devices, shardings that place each array (parameters
replicated, batches split on their leading axis over ``"data"``), and XLA
inserts the gradient all-reduces. PyTorch runs one process a card, so the
same layout is made per process:

- :func:`make_mesh` builds a ``DeviceMesh`` over the initialised process
  group (NCCL on the card, gloo on the CPU), one rank a mesh position;
- :func:`replicated` (JAX ``replicated``, ``NamedSharding(mesh, P())``)
  places a tensor as every rank's copy of the axis's first rank's;
- :func:`batch_sharding` (JAX ``batch_sharding``, ``P("data")``) and
  :func:`shard_array` (an explicit spec) take the rank's slice of a global
  tensor;
- :func:`shard_batch_fn` wraps a train step: the state replicated on the
  first call, each batch leaf sliced; the step itself all-reduces the
  gradients (``train/loop.py make_train_step(mesh=)``), which XLA does in
  JAX.

The caller starts the process group, e.g. ``torchrun`` or
``torch.distributed.init_process_group("nccl", init_method="tcp://localhost:<port>",
world_size=w, rank=r)`` with ``torch.cuda.set_device(r)``; every rank calls
these functions in the same order (they are collective).
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(devices=None, axis_names=("data",), shape=None) -> DeviceMesh:
    """A ``DeviceMesh`` over ``devices``: global ranks of the initialised
    process group (default: every rank), laid out as ``shape`` (default
    (len(devices), 1, ...)) with ``axis_names``. Its device type follows
    the group's backend: 'cuda' for NCCL, else 'cpu'."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(init_process_group with backend 'nccl' on the card, 'gloo' on the CPU)")
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=axis_names)


def axis_size(mesh: DeviceMesh, axis: str = "data") -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def shard_range(n: int, mesh: DeviceMesh, axis: str = "data"):
    """(start, stop) of this rank's equal share of ``n`` rows along ``axis``;
    ValueError if the axis's size does not divide ``n``."""
    w = axis_size(mesh, axis)
    if n % w:
        raise ValueError(f"{n} rows do not split evenly over the {w} ranks of "
                         f"mesh axis {axis!r}")
    per = n // w
    r = mesh.get_local_rank(axis)
    return r * per, (r + 1) * per


def shard_array(x: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (JAX
    ``shard_array`` with a ``PartitionSpec``): one entry a leading dimension,
    a mesh axis name to split that dimension over, or None to keep it
    whole. A view, no copy."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            lo, hi = shard_range(x.shape[dim], mesh, axis)
            x = x.narrow(dim, lo, hi - lo)
    return x


def batch_sharding(mesh: DeviceMesh, axis: str = "data"):
    """Placement of a batch (JAX ``batch_sharding``): a function from a
    global tensor to this rank's slice of its leading dimension."""
    return lambda x: shard_array(x, mesh, (axis,))


def replicated(mesh: DeviceMesh, axis: str = "data"):
    """Placement of replicated state (JAX ``replicated``): a function that
    overwrites a tensor in place with the axis's first rank's copy and
    returns it."""
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)

    def place(t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=src, group=group)
        return t
    return place


def _all_reduce(tensors, mesh: DeviceMesh, axis: str, mean: bool):
    tensors = list(tensors)
    w = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if mean and w > 1:
            flat /= w
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))
    return tensors


def all_reduce_mean(tensors, mesh: DeviceMesh, axis: str = "data"):
    """Each tensor replaced in place by its mean over ``axis``'s ranks: one
    all-reduce of a flat buffer per dtype (NCCL's and gloo's SUM, then a
    division by the axis's size; at size 1 the values are unchanged)."""
    return _all_reduce(tensors, mesh, axis, mean=True)


def all_reduce_sum(tensors, mesh: DeviceMesh, axis: str = "data"):
    """Each tensor replaced in place by its sum over ``axis``'s ranks: one
    all-reduce of a flat buffer per dtype (integer counts stay exact)."""
    return _all_reduce(tensors, mesh, axis, mean=False)


def _state_tensors(tree):
    """The tensors of a train state: a module's parameters and buffers, and
    every tensor inside dicts, lists and tuples."""
    if isinstance(tree, torch.nn.Module):
        yield from (t.data for t in tree.parameters())
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _state_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _state_tensors(v)


def _map_leaves(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return tree


def shard_batch_fn(step_fn, mesh: DeviceMesh, axis: str = "data"):
    """Wrap a (state, batch) -> (state, aux) step for data parallelism (JAX
    ``shard_batch_fn``): on its first call the state (the model's
    parameters and buffers, the optimizer state) is broadcast from the
    axis's first rank, so every rank starts from one replica; every call
    hands the step this rank's slice of each batch leaf along its leading
    dimension. The step must average its gradients over the axis, as
    ``make_train_step(mesh=)``'s does."""
    repl = replicated(mesh, axis)
    shard = batch_sharding(mesh, axis)
    placed = False

    def wrapped(state, batch):
        nonlocal placed
        if not placed:
            with torch.no_grad():
                for t in _state_tensors(state):
                    repl(t)
            placed = True
        return step_fn(state, _map_leaves(shard, batch))

    return wrapped
