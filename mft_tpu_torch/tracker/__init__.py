"""MFT tracker: delta chaining and per-pixel candidate selection."""

from mft_tpu_torch.tracker.mft import MFT

__all__ = ["MFT"]
