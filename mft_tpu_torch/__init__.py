"""mft_tpu_torch: the MFT dense long-term tracker in PyTorch, with CUDA kernels
written by hand for Hopper (sm_90a).

A port of ``mft_tpu`` (JAX/Pallas on TPU) that stands beside it and imports
nothing of it, nor of JAX:

- ``mft_tpu_torch.core``     FlowOU value type and algebra, coordinate grids,
                             bilinear sampling
- ``mft_tpu_torch.models``   RAFT-OU optical flow network (nn.Modules, NCHW inside)
- ``mft_tpu_torch.tracker``  MFT delta-chaining tracker with a feature ring,
                             selection, point tracking
- ``mft_tpu_torch.ops``      CUDA kernels (correlation lookups and builds,
                             chain+select, convolution, bilinear warp), each
                             beside its plain PyTorch version

Entry points run on ``device="cuda"`` unless the caller passes ``"cpu"``;
on the CPU every kernel wrapper uses its plain version.
"""

__version__ = "0.1.0"
