"""Device choice for the port's entry points.

Entry points default to the card. Asking for CUDA where there is none is an
error, never a silent move to the CPU: only a caller that passes
``device="cpu"`` (the tests do) gets the CPU and the kernels' plain versions.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
