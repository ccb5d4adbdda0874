"""Fused fnet + cnet encoder: one grouped-conv stack for both feature nets.

Port of ``mft_tpu/models/raft/encoder_fuse.py``. The big model encodes a
frame with two BasicEncoders of the same architecture (fnet: instance norm,
cnet: batch norm, reference extractor.py:118-195) on the same image, so
each pair of convs runs as ONE grouped conv (``groups=2``, the two kernels
concatenated along the output channels) over the image repeated along the
channels. The norms stay per half: instance norm on the fnet half,
eval-mode batch norm (running statistics) on the cnet half. The parameters
are read from the model's unchanged ``fnet`` and ``cnet`` modules.

Used by ``wrapper.RAFTFlow.padded_encode`` when the flow config sets
``fused_encoder`` (big model only, as in JAX); ``RAFT.encode`` remains the
reference. The grouped convs run on cuDNN, as the JAX package leaves them
to XLA: this is not a Pallas site.
"""

import torch
import torch.nn.functional as F

from mft_tpu_torch.models.raft.layers import compute_dtype


def _gconv(x, conv_f, conv_c):
    """The fnet conv on the first half of ``x``'s channels and the cnet conv
    on the second, outputs concatenated [fnet, cnet]."""
    dt = compute_dtype(conv_f)
    weight = torch.cat([conv_f.weight, conv_c.weight]).to(dt)
    bias = torch.cat([conv_f.bias, conv_c.bias]).to(dt)
    return F.conv2d(x.to(dt), weight, bias, stride=conv_f.stride, padding=conv_f.padding,
                    groups=2)


def _norm_pair(y, f_norm, c_norm):
    """Instance norm (``f_norm``) on the fnet half, eval-mode batch norm with
    ``c_norm``'s running statistics on the cnet half; float32 statistics,
    the result in y's dtype."""
    half = y.shape[1] // 2
    yc = y[:, half:].float()
    mul = torch.rsqrt(c_norm.running_var + c_norm.eps) * c_norm.weight
    yc = (yc - c_norm.running_mean[:, None, None]) * mul[:, None, None]
    yc = (yc + c_norm.bias[:, None, None]).to(y.dtype)
    return torch.cat([f_norm(y[:, :half]), yc], dim=1)


def _res_block(x, bf, bc):
    """A fused ResidualBlock pair (reference extractor.py:6-56)."""
    y = torch.relu(_norm_pair(_gconv(x, bf.conv1, bc.conv1), bf.norm1, bc.norm1))
    y = torch.relu(_norm_pair(_gconv(y, bf.conv2, bc.conv2), bf.norm2, bc.norm2))
    if bf.downsample_conv is not None:
        x = _norm_pair(_gconv(x, bf.downsample_conv, bc.downsample_conv), bf.norm3, bc.norm3)
    return torch.relu(x + y)


def fused_basic_encode(model, image):
    """(B, 3, H, W) images in [0, 255] -> (fmap, cnet) of the big ``model``,
    as ``model.encode`` computes them with fnet and cnet apart (eval mode).
    """
    fnet, cnet = model.fnet, model.cnet
    x = (2.0 * (image.float() / 255.0) - 1.0).to(model.dtype)
    y = torch.cat([x, x], dim=1)   # both groups see the image
    y = torch.relu(_norm_pair(_gconv(y, fnet.conv1, cnet.conv1), fnet.norm1, cnet.norm1))
    for i in range(1, 4):
        for j in range(2):
            name = f"layer{i}_{j}"
            y = _res_block(y, getattr(fnet, name), getattr(cnet, name))
    out = _gconv(y, fnet.conv2, cnet.conv2)
    n_f = fnet.conv2.out_channels
    return out[:, :n_f].contiguous(), out[:, n_f:].contiguous()
