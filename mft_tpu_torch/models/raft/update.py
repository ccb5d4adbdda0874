"""Update blocks: motion encoder, separable ConvGRU, flow/mask heads, OU heads.

Port of ``mft_tpu/models/raft/update.py`` (reference MFT/RAFT/core/update.py)
for the big model, NCHW:
- BasicMotionEncoder: corr -> 256 (1x1) -> 192 (3x3), flow -> 128 (7x7) ->
  64 (3x3), concat -> 126 (3x3), concat raw flow -> 128 channels;
- SepConvGRU: a (1,5) then a (5,1) pass; z and r share their input and run
  as one conv with the two kernels concatenated (same math as two convs);
- BasicUpdateBlock: flow head 128->256->2, mask head 128->256->576 * 0.25;
- OcclusionAndUncertaintyBlock ('simple' heads): input concat
  [net, inp, corr, flow, delta_flow, motion] = 712 channels, both heads'
  first convs run as one 712->256 conv.

The convs that the JAX package routes through its ``conv_apply`` (convc1
when unfused, convc2, convf2, conv, the GRU's zr pair and q in both passes,
the flow head's two convs) run through :func:`conv_apply` here: with
``conv_backend='pallas'`` on the product kernel (``ops.conv_pallas``, one
fixed summation order), else ``F.conv2d``. convf1, the mask head and the OU
block stay ``nn.Conv2d``, as they stay ``nn.Conv`` in JAX. The product
kernel has no backward: a model in train mode builds its update block with
``conv_backend`` 'auto' (cuDNN), as JAX trains with its differentiable
lowering in place of ``conv_pallas``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from mft_tpu_torch import ops
from mft_tpu_torch.models.raft.layers import compute_dtype, conv

_ACT = {None: lambda v: v, "relu": torch.relu}


def conv_apply(x, weight, bias, padding, backend: str = "auto", plain: bool = False,
               act=None):
    """One update-block convolution, lowered as the JAX ``conv_apply`` does.

    args: x (B, Cin, H, W); weight (Cout, Cin, kh, kw); bias (Cout,); padding
      ((top, bottom), (left, right)), SAME-size; backend the conv_backend;
      ``plain`` runs the kernel's plain version; act None or 'relu'.
    'pallas' runs the product kernel, whose float32 bias and relu act on the
    float32 sum before the one cast (relu commutes with that rounding, so the result
    equals relu after the cast, as JAX applies it). As in JAX, a tiny-Cin
    conv (Cin <= 8, kh*kw > 1) does not. JAX also needs ``conv_fits_pallas``
    (its TPU memory budget and W of 64 or a multiple of 128); the port's
    kernel takes any SAME-size conv, so it runs at every width. The other
    backends compute the same convolution with ``F.conv2d``.
    """
    kh, kw = weight.shape[2:]
    if backend == "pallas" and not (x.shape[1] <= 8 and kh * kw > 1):
        conv_fn = ops.conv_pallas_ref if plain else ops.conv_pallas
        return conv_fn(x, weight, bias, padding, act=act)
    (pt, pb), (pl, pr) = padding
    if pt != pb or pl != pr:
        x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
    # weight and the float32 bias in x's dtype, as JAX's lax-conv branch
    # casts them
    return _ACT[act](F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), padding=(pt, pl)))


def _same(m: nn.Conv2d):
    ph, pw = m.padding
    return (ph, ph), (pw, pw)


def _apply(m: nn.Conv2d, x, backend, plain, act=None):
    return conv_apply(x, m.weight, m.bias, _same(m), backend, plain, act)


def _fused_pair(conv_a: nn.Conv2d, conv_b: nn.Conv2d, x, backend="auto", plain=False):
    """Two same-shape convs on one input as one conv; channels [a, b]."""
    w = torch.cat([conv_a.weight, conv_b.weight], dim=0)
    b = torch.cat([conv_a.bias, conv_b.bias], dim=0)
    return conv_apply(x, w, b, _same(conv_a), backend, plain)


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden_dim: int = 256, out_dim: int = 2):
        super().__init__()
        self.conv1 = conv(cin, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, out_dim, 3)

    def forward(self, x, backend="auto", plain=False):
        return _apply(self.conv2, _apply(self.conv1, x, backend, plain, "relu"),
                      backend, plain)


class BasicMotionEncoder(nn.Module):
    """Encode (corr window samples, flow) into 128 motion channels.

    ``corr`` is either the (B, 324, H, W) lookup output or, on the fused
    path, a callable ``corr(weight, bias) -> (B, 256, H, W)`` that computes
    relu(convc1(lookup)) inside the lookup kernel.
    """

    def __init__(self, corr_channels: int = 324):
        super().__init__()
        self.convc1 = conv(corr_channels, 256, 1)
        self.convc2 = conv(256, 192, 3)
        self.convf1 = conv(2, 128, 7)
        self.convf2 = conv(128, 64, 3)
        self.conv = conv(256, 126, 3)

    def forward(self, flow, corr, backend="auto", plain=False):
        dt = compute_dtype(self.conv)
        flow = flow.to(dt)
        if callable(corr):
            cor = corr(self.convc1.weight, self.convc1.bias).to(dt)
        else:
            cor = _apply(self.convc1, corr.to(dt), backend, plain, "relu")
        cor = _apply(self.convc2, cor, backend, plain, "relu")
        flo = torch.relu(self.convf1(flow))
        flo = _apply(self.convf2, flo, backend, plain, "relu")
        out = _apply(self.conv, torch.cat([cor, flo], dim=1), backend, plain, "relu")
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}", conv(cin, hidden_dim, k))

    def forward(self, h, x, backend="auto", plain=False):
        hd = h.shape[1]
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            zr = _fused_pair(getattr(self, f"convz{suffix}"),
                             getattr(self, f"convr{suffix}"), hx, backend, plain)
            z = torch.sigmoid(zr[:, :hd])
            r = torch.sigmoid(zr[:, hd:])
            q = torch.tanh(_apply(getattr(self, f"convq{suffix}"),
                                  torch.cat([r * h, x], dim=1), backend, plain))
            h = (1.0 - z) * h + z * q
        return h


class BasicUpdateBlock(nn.Module):
    """One RAFT refinement step: motion encoder -> GRU -> flow delta + up-mask.

    ``conv_backend`` lowers the convs of :func:`conv_apply`; ``plain`` in
    :meth:`forward` runs the plain version of its kernel.
    """

    def __init__(self, hidden_dim: int = 128, corr_channels: int = 324,
                 conv_backend: str = "auto"):
        super().__init__()
        self.conv_backend = conv_backend
        self.encoder = BasicMotionEncoder(corr_channels)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256, 2)
        self.mask_conv1 = conv(hidden_dim, 256, 3)
        self.mask_conv2 = conv(256, 576, 1)

    def routed_convs(self):
        """The convs that :func:`conv_apply` runs (convc1 also inside the
        fused lookup). Their biases stay float32 in a bf16 model, because JAX
        adds the float32 parameter there (``mft_tpu/models/raft/update.py
        conv_apply``, ``mft_tpu/ops/conv_pallas.py``)."""
        enc, gru, head = self.encoder, self.gru, self.flow_head
        return [enc.convc1, enc.convc2, enc.convf2, enc.conv,
                *(getattr(gru, f"conv{gate}{s}") for s in "12" for gate in "zrq"),
                head.conv1, head.conv2]

    def forward(self, net, inp, corr, flow, need_mask: bool = True, plain: bool = False,
                mask_rows=None):
        """One iteration; ``mask_rows`` (start, stop) runs the mask head on
        those batch rows only (the pairs that end at this iteration of a
        per-pair schedule), as JAX's ``mask_rows``."""
        backend = self.conv_backend
        motion_features = self.encoder(flow, corr, backend, plain)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1), backend, plain)
        delta_flow = self.flow_head(net, backend, plain)
        up_mask = None
        if need_mask:
            src = net if mask_rows is None else net[mask_rows[0]:mask_rows[1]]
            # scaled 0.25 to balance gradients (reference update.py:237)
            up_mask = 0.25 * self.mask_conv2(torch.relu(self.mask_conv1(src)))
        return net, up_mask, delta_flow, motion_features


class SimpleHead(nn.Module):
    def __init__(self, cin: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = conv(cin, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, out_dim, 3)


class OcclusionAndUncertaintyBlock(nn.Module):
    """Separate occlusion (2 logits) and uncertainty (1 log-variance) heads."""

    def __init__(self, cin: int = 712, hidden_dim: int = 128):
        super().__init__()
        self.occl_head = SimpleHead(cin, hidden_dim, 2)
        self.uncertainty_head = SimpleHead(cin, hidden_dim, 1)

    def forward(self, net, inp, corr, flow, delta_flow, motion_features):
        dt = compute_dtype(self.occl_head.conv1)
        x = torch.cat([t.to(dt) for t in (net, inp, corr, flow, delta_flow,
                                           motion_features)], dim=1)
        h = torch.relu(_fused_pair(self.occl_head.conv1,
                                   self.uncertainty_head.conv1, x))
        hd = self.occl_head.conv1.out_channels
        occl = self.occl_head.conv2(h[:, :hd])
        uncertainty = self.uncertainty_head.conv2(h[:, hd:])
        return occl, uncertainty
