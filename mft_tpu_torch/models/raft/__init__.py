"""RAFT-OU optical flow network in PyTorch (NCHW inside, nn.Modules).

Architecture of ``mft_tpu.models.raft`` (itself the reference MFT/RAFT), with
the per-iteration correlation lookup on the port's CUDA kernels.
"""

from mft_tpu_torch.models.raft.raft import RAFT, RAFTParams
from mft_tpu_torch.models.raft.wrapper import RAFTFlow

__all__ = ["RAFT", "RAFTParams", "RAFTFlow"]
