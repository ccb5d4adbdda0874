"""Encoder building blocks: norms, residual blocks, BasicEncoder.

Port of ``mft_tpu/models/raft/layers.py`` (reference extractor.py):
- fnet uses instance norm (affine-free, eps 1e-5, biased variance over H, W),
  cnet uses batch norm with running statistics (inference only);
- both norms compute in float32 and return the input dtype, so under a bf16
  compute dtype the convolutions run in bf16 and the statistics in f32, as
  the JAX package does;
- convs use torch's symmetric ``k // 2`` padding, which is what the JAX
  package passes explicitly to flax.

Module names follow the flax tree (``layer2_0.downsample_conv``); flax's
``BatchNorm_0/1/2`` are ``norm1/2/3`` here (see convert.py).
"""

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W; no parameters."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
        return ((x32 - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class BatchNorm(nn.Module):
    """Batch norm at inference: running statistics, float32 parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


def make_norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == "batch":
        return BatchNorm(features)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unsupported norm_fn {norm_fn!r}")


def conv(cin: int, cout: int, k, stride: int = 1) -> nn.Conv2d:
    """Conv2d with torch-style symmetric padding k // 2."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=(kh // 2, kw // 2))


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm + relu and a strided 1x1 shortcut when stride > 1."""

    def __init__(self, cin: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = conv(cin, planes, 3, stride)
        self.norm1 = make_norm(norm_fn, planes)
        self.conv2 = conv(planes, planes, 3)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample_conv = None
        if stride != 1:
            self.downsample_conv = conv(cin, planes, 1, stride)
            self.norm3 = make_norm(norm_fn, planes)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample_conv is not None:
            x = self.norm3(self.downsample_conv(x))
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 residual encoder: 7x7/2 stem, stages (64, 96, 128), 1x1 head."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch"):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.norm1 = make_norm(norm_fn, 64)
        cin = 64
        for i, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)], start=1):
            setattr(self, f"layer{i}_0", ResidualBlock(cin, dim, norm_fn, stride))
            setattr(self, f"layer{i}_1", ResidualBlock(dim, dim, norm_fn, 1))
            cin = dim
        self.conv2 = conv(128, output_dim, 1)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        for i in range(1, 4):
            x = getattr(self, f"layer{i}_0")(x)
            x = getattr(self, f"layer{i}_1")(x)
        return self.conv2(x)
