"""Counted per-frame FLOP budget for the fused dense-tracking step.

A copy of the JAX package's ``mft_tpu/utils/flops.py`` (``_conv`` through
``frame_flops``): analytic conv/matmul FLOP counts (2 * out_elems * kh * kw
* cin per output channel) for one fused tracker frame at 512x512 with the
reference inference configuration: 7 delta pairs, 12 GRU iterations per
pair, RAFT-big with the separate_with_uncertainty OU module (reference
serycjon/MFT configs/MFT_cfg.py:15,
configs/flow/RAFTou_kubric_huber_split_nonoccl.py:27,
MFT/RAFT/core/{raft,extractor,update}.py architecture). Element-wise work
(norms, activations, warps, selection) is O(HW) noise next to the conv stack
and is not counted: the budget is a conservative (under-)count, so the MFU
derived from it is a lower bound.

:func:`peak_flops` gives the card's dense bf16 peak, the denominator of that
MFU.
"""


def _conv(out_px, kh, kw, cin, cout):
    return 2 * out_px * kh * kw * cin * cout


def basic_encoder_flops(H, W, output_dim=256):
    """One BasicEncoder pass on an (H, W, 3) image (extractor.py:106-168)."""
    h2, w2 = H // 2, W // 2          # after conv1 stride 2
    h4, w4 = H // 4, W // 4          # after layer2 stride 2
    h8, w8 = H // 8, W // 8          # after layer3 stride 2
    f = _conv(h2 * w2, 7, 7, 3, 64)                      # conv1
    f += 2 * (2 * _conv(h2 * w2, 3, 3, 64, 64))          # layer1: 2 res blocks
    f += (_conv(h4 * w4, 3, 3, 64, 96)                   # layer2 block1
          + _conv(h4 * w4, 3, 3, 96, 96)
          + _conv(h4 * w4, 1, 1, 64, 96))                # downsample
    f += 2 * _conv(h4 * w4, 3, 3, 96, 96)                # layer2 block2
    f += (_conv(h8 * w8, 3, 3, 96, 128)                  # layer3 block1
          + _conv(h8 * w8, 3, 3, 128, 128)
          + _conv(h8 * w8, 1, 1, 96, 128))
    f += 2 * _conv(h8 * w8, 3, 3, 128, 128)              # layer3 block2
    f += _conv(h8 * w8, 1, 1, 128, output_dim)           # conv2
    return f


def corr_pyramid_flops(H8, W8, n_pairs, levels=4, C=256):
    """All-pairs dots, pooled-feature pyramid (corr.py build_corr_pyramid)."""
    P = H8 * W8
    f = 0
    h, w = H8, W8
    for lvl in range(levels):
        if lvl:
            h, w = h // 2, w // 2
        f += 2 * P * h * w * C
    return n_pairs * f


def corr_lookup_flops(H8, W8, levels=4, radius=4):
    """One tent-matmul pyramid lookup for one pair (one GRU iteration)."""
    n = 2 * radius + 1
    P = H8 * W8
    f = 0
    h, w = H8, W8
    for lvl in range(levels):
        if lvl:
            h, w = h // 2, w // 2
        f += 2 * P * n * h * w        # y tent contraction
        f += 2 * P * n * n * w        # x tent contraction
    return f


def update_block_flops(H8, W8, corr_ch=324):
    """One BasicUpdateBlock pass for one pair (update.py:211-244), sans mask."""
    P = H8 * W8
    f = _conv(P, 1, 1, corr_ch, 256)          # convc1
    f += _conv(P, 3, 3, 256, 192)             # convc2
    f += _conv(P, 7, 7, 2, 128)               # convf1
    f += _conv(P, 3, 3, 128, 64)              # convf2
    f += _conv(P, 3, 3, 256, 126)             # motion conv
    # GRU: (1,5) pass + (5,1) pass on hx = concat(h 128, x 256) = 384 ch
    for k in (5, 5):
        f += _conv(P, 1, k, 384, 256)         # fused convz+convr
        f += _conv(P, 1, k, 384, 128)         # convq
    f += _conv(P, 3, 3, 128, 256)             # flow head conv1
    f += _conv(P, 3, 3, 256, 2)               # flow head conv2
    return f


def mask_head_flops(H8, W8):
    P = H8 * W8
    return _conv(P, 3, 3, 128, 256) + _conv(P, 1, 1, 256, 576)


def ou_block_flops(H8, W8):
    """'simple' OU heads on the 712-ch input (update.py:304-344)."""
    P = H8 * W8
    f = _conv(P, 3, 3, 712, 256)              # fused occl+unc conv1
    f += _conv(P, 3, 3, 128, 2)               # occl conv2
    f += _conv(P, 3, 3, 128, 1)               # uncertainty conv2
    return f


def upsample_flops(H, W, n_pairs, fields=4):
    """Convex upsampling: 9-tap mask contraction per full-res output px."""
    return n_pairs * 2 * H * W * 9 * fields


def frame_flops(H=512, W=512, n_pairs=7, iters=12):
    """Total counted FLOPs for ONE fused tracker frame.

    The fused step encodes only the incoming frame (1 fnet + 1 cnet pass;
    left-frame features come from the device ring memory), then runs the
    batched n_pairs-pair RAFT tail at the configured iteration count.
    """
    H8, W8 = H // 8, W // 8
    f = basic_encoder_flops(H, W, 256) * 2                 # fnet + cnet
    f += corr_pyramid_flops(H8, W8, n_pairs)
    f += n_pairs * iters * corr_lookup_flops(H8, W8)
    f += n_pairs * iters * update_block_flops(H8, W8)
    f += n_pairs * (mask_head_flops(H8, W8) + ou_block_flops(H8, W8))
    f += upsample_flops(H, W, n_pairs)
    return f


# dense bf16 tensor-core peak by device name (NVIDIA H100 datasheet: SXM5,
# 700 W, 989.4 TFLOP/s without sparsity)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}


def peak_flops(device_name: str | None = None) -> float | None:
    """Peak dense bf16 FLOP/s of a known card, by its
    ``torch.cuda.get_device_name`` (read from card 0 when ``device_name`` is
    None), else None."""
    if device_name is None:
        import torch
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    return PEAK_BF16_FLOPS.get(device_name)
