"""Encoder building blocks: norms, residual and bottleneck blocks, the encoders.

Port of ``mft_tpu/models/raft/layers.py`` (reference extractor.py):
- fnet uses instance norm (affine-free, eps 1e-5, biased variance over H, W),
  cnet uses batch norm: running statistics at inference, and in train mode
  flax's ``nn.BatchNorm(use_running_average=False, momentum=0.9)``: the
  batch's mean and biased variance over (N, H, W), the variance as
  E[x^2] - E[x]^2 clipped at 0 (flax's fast variance), and the running
  statistics updated to 0.9 * running + 0.1 * batch;
- both norms compute in float32 and return the input dtype, so under a bf16
  compute dtype the convolutions run in bf16 and the statistics in f32, as
  the JAX package does;
- convs use torch's symmetric ``k // 2`` padding, which is what the JAX
  package passes explicitly to flax; a conv's ``compute_dtype``, when set,
  casts its input, weight and bias at every call (bf16 compute over float32
  master weights, as flax's ``nn.Conv(dtype=)`` under mixed precision);
- the encoder's dropout (``dropout`` > 0 in train mode) follows its last conv;
- ``SmallEncoder`` (the small RAFT's fnet and cnet) stacks bottleneck blocks
  of widths (32, 64, 96) on a 32-channel stem.

Module names follow the flax tree (``layer2_0.downsample_conv``); flax's
``BatchNorm_0/1/2`` are ``norm1/2/3`` here, a bottleneck block's
``BatchNorm_0..3`` ``norm1..4`` (see convert.py).
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
    """Batch norm with float32 parameters and statistics: the running
    statistics unless ``use_batch_stats``, else the batch's, which also
    update the running ones (flax ``nn.BatchNorm`` with momentum 0.9)."""

    MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.use_batch_stats = False
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        x32 = x.float()
        if self.use_batch_stats:
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


def make_norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == "batch":
        return BatchNorm(features)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unsupported norm_fn {norm_fn!r}")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that, with ``compute_dtype`` set, casts its input,
    weight and bias to that dtype at every call."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def compute_dtype(m: nn.Conv2d) -> torch.dtype:
    """The dtype a conv computes in: its ``compute_dtype``, else its weight's."""
    return m.compute_dtype or m.weight.dtype


def conv(cin: int, cout: int, k, stride: int = 1) -> Conv2d:
    """Conv2d with torch-style symmetric padding k // 2."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return Conv2d(cin, cout, (kh, kw), stride=stride, padding=(kh // 2, kw // 2))


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


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at a quarter of the width, each with norm
    + relu, and a strided 1x1 shortcut when stride > 1 (reference
    extractor.py:60-116)."""

    def __init__(self, cin: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        p4 = planes // 4
        self.conv1 = conv(cin, p4, 1)
        self.norm1 = make_norm(norm_fn, p4)
        self.conv2 = conv(p4, p4, 3, stride)
        self.norm2 = make_norm(norm_fn, p4)
        self.conv3 = conv(p4, planes, 1)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample_conv = None
        if stride != 1:
            self.downsample_conv = conv(cin, planes, 1, stride)
            self.norm4 = make_norm(norm_fn, planes)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample_conv is not None:
            x = self.norm4(self.downsample_conv(x))
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 residual encoder: 7x7/2 stem, stages (64, 96, 128), 1x1 head."""

    STEM, STAGES, BLOCK = 64, ((64, 1), (96, 2), (128, 2)), ResidualBlock

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch", dropout: float = 0.0):
        super().__init__()
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        self.conv1 = conv(3, self.STEM, 7, 2)
        self.norm1 = make_norm(norm_fn, self.STEM)
        cin = self.STEM
        for i, (dim, stride) in enumerate(self.STAGES, start=1):
            setattr(self, f"layer{i}_0", self.BLOCK(cin, dim, norm_fn, stride))
            setattr(self, f"layer{i}_1", self.BLOCK(dim, dim, norm_fn, 1))
            cin = dim
        self.conv2 = conv(cin, output_dim, 1)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        for i in range(1, 4):
            x = getattr(self, f"layer{i}_0")(x)
            x = getattr(self, f"layer{i}_1")(x)
        x = self.conv2(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x


class SmallEncoder(BasicEncoder):
    """The small RAFT's stride-8 encoder: 7x7/2 stem of 32, bottleneck stages
    (32, 64, 96), 1x1 head (reference extractor.py:198-270)."""

    STEM, STAGES, BLOCK = 32, ((32, 1), (64, 2), (96, 2)), BottleneckBlock
