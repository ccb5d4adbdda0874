"""Device mesh, data parallelism and multi-clip streaming.

Port of ``mft_tpu/parallel``:
- ``mesh``: a ``torch.distributed`` ``DeviceMesh`` with a ``"data"`` axis,
  placement helpers and the data-parallel train-step wrapper (one process a
  card; the train step all-reduces its gradients);
- ``streaming``: many clips tracked in lockstep, one (C·N)-pair batch and
  one chain + select launch a timestep, the clips split over the mesh's
  ``"data"`` axis.
"""

from mft_tpu_torch.parallel.mesh import make_mesh, shard_batch_fn
from mft_tpu_torch.parallel.streaming import StreamingTracker

__all__ = ["make_mesh", "shard_batch_fn", "StreamingTracker"]
