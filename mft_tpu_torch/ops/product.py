"""Tiled products in one fixed summation order: CUDA kernels and their plain versions.

Each function is a wrapper that launches its kernel (``csrc/product.cu``) on
CUDA tensors and uses its plain PyTorch version on CPU tensors:

- :func:`corr_build_folded` (kernel ``mft_corr_build_folded``, replacing
  ``mft_tpu/ops/corr_lookup_pallas.py build_corr_pyramid_pallas``): every
  level of the all-pairs correlation volume of all pairs, written straight
  into the folded (B, P, Q_l/128, 128) layout;
- :func:`conv_pallas` (kernel ``mft_conv``, replacing
  ``mft_tpu/ops/conv_pallas.py conv_pallas``): a SAME-size convolution of
  NCHW activations with ``nn.Conv2d`` weights (Cout, Cin, kh, kw), bias and
  an activation in float32, one cast at the end.

Summation order. Each output is one float32 sum over k, ascending from
0.0, of a_k * b_k: k is the channel for the volume and (channel, ky, kx), the
weight's own memory order, for the convolution. The plain versions add one k
at a time over whole maps, so kernel and plain version give the same bits
(the kernels are built with -fmad=false; a product of two bfloat16 values is
exact in float32, so for bf16 inputs the product and the sum round once
either way). A library product or convolution sums in an order of its own.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

from mft_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ACT_FN = {None: lambda v: v, "relu": torch.relu, "sigmoid": torch.sigmoid,
           "tanh": torch.tanh}
MAX_LEVELS = 4
LANES = 128   # values per row of a folded level


def corr_scale(C: int) -> float:
    """1/sqrt(C) as the float32 both the kernel and the plain version use."""
    return float(torch.tensor(1.0 / math.sqrt(C), dtype=torch.float32))


def _add_products(acc, a, b, exact: bool):
    """acc += a * b in float32, the product rounded apart from the sum. Where
    a and b hold bfloat16 values (``exact``) the product is exact, so one
    addcmul_ rounds the same way, fused or not."""
    if exact:
        acc.addcmul_(a, b)
    else:
        acc.add_(a * b)


@contextlib.contextmanager
def _one_cpu_thread(device: torch.device):
    """The plain versions run one small operation per k (thousands per
    convolution). On the CPU, threads that synchronise on every one of them
    cost more than they save, most of all when other processes share the
    cores, so those loops run on one thread; on a card this changes nothing."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def corr_build_folded_ref(f1, f2_levels) -> list:
    """Plain version of :func:`corr_build_folded`."""
    B, C, P = f1.shape
    qs = [f2.shape[2] for f2 in f2_levels]
    f2 = torch.cat(list(f2_levels), dim=2).float()      # (B, C, sum Q_l)
    a = f1.float()
    exact = f1.dtype == torch.bfloat16
    acc = torch.zeros((B, P, f2.shape[2]), dtype=torch.float32, device=f1.device)
    with _one_cpu_thread(f1.device):
        for c in range(C):
            _add_products(acc, a[:, c, :, None], f2[:, c, None, :], exact)
    out = (acc * corr_scale(C)).to(f1.dtype)
    return [lvl.reshape(B, P, q // LANES, LANES).contiguous()
            for lvl, q in zip(out.split(qs, dim=2), qs)]


def conv_pallas_ref(x, weight, bias, padding, act=None, out_dtype=None):
    """Plain version of :func:`conv_pallas`."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    (pt, pb), (pl, pr) = _check_padding(padding, kh, kw)
    dt = x.dtype
    xp = F.pad(x.float(), (pl, pr, pt, pb))
    w = weight.to(dt).float()
    exact = dt == torch.bfloat16
    acc = torch.zeros((B, Cout, H, W), dtype=torch.float32, device=x.device)
    with _one_cpu_thread(x.device):
        for c in range(Cin):
            for ky in range(kh):
                for kx in range(kw):
                    _add_products(acc, xp[:, c:c + 1, ky:ky + H, kx:kx + W],
                                  w[:, c, ky, kx].view(1, Cout, 1, 1), exact)
    acc.add_(bias.float().view(1, Cout, 1, 1))
    return _ACT_FN[act](acc).to(out_dtype or dt)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _check_padding(padding, kh, kw):
    (pt, pb), (pl, pr) = padding
    if pt + pb != kh - 1 or pl + pr != kw - 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"padding {padding} is not SAME-size for a {kh}x{kw} kernel")
    return (pt, pb), (pl, pr)


def _require_cuda(t: torch.Tensor, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def corr_build_folded(f1, f2_levels) -> list:
    """All levels of the correlation volume in the folded layout, one launch.

    args: f1 (B, C, P) source features (the NCHW map with its pixels
      flattened); f2_levels, 1..4 (B, C, Q_l) pooled target features of the
      same dtype (float32 or bfloat16), Q_l a multiple of 128: a level of
      fewer than 128 positions comes zero-padded to 128, so its padding lanes
      are zero.
    returns: per level (B, P, Q_l/128, 128) in the features' dtype,
      value = (sum_c f1[b, c, p] * f2_l[b, c, q]) * (1/sqrt(C)), summed in
      float32 and rounded once.
    """
    if f1.device.type == "cpu":
        return corr_build_folded_ref(f1, f2_levels)
    _require_cuda(f1, "corr_build_folded")
    if f1.dtype not in _DTYPE_CODE:
        raise TypeError(f"features must be float32 or bfloat16, got {f1.dtype}")
    if not 1 <= len(f2_levels) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels supported, got {len(f2_levels)}")
    if f1.dim() != 3 or not f1.is_contiguous():
        raise ValueError("f1 must be a contiguous (B, C, P) tensor")
    B, C, P = f1.shape
    for f2 in f2_levels:
        if (f2.dim() != 3 or f2.shape[:2] != (B, C) or f2.shape[2] % LANES
                or f2.dtype != f1.dtype or f2.device != f1.device
                or not f2.is_contiguous()):
            raise ValueError(f"f2 levels must be contiguous (B, C, Q_l) = ({B}, {C}, "
                             f"k*{LANES}) tensors of f1's dtype and device")
    qs = [f2.shape[2] for f2 in f2_levels]
    outs = [torch.empty((B, P, q // LANES, LANES), dtype=f1.dtype, device=f1.device)
            for q in qs]
    pad = [None] * (MAX_LEVELS - len(qs))
    err = _build.library().mft_corr_build_folded(
        f1.data_ptr(), *[f2.data_ptr() for f2 in f2_levels], *pad,
        *[o.data_ptr() for o in outs], *pad, *qs, *[0] * len(pad), len(qs), B, C, P,
        corr_scale(C), _DTYPE_CODE[f1.dtype], _stream(f1))
    _build.check(err, "mft_corr_build_folded")
    corr_build_folded.launches += 1
    return outs


corr_build_folded.launches = 0


def conv_pallas(x, weight, bias, padding, act=None, out_dtype=None):
    """SAME-size convolution: (B, Cout, H, W) in ``out_dtype`` (default x's).

    args: x (B, Cin, H, W) float32 or bfloat16, any strides; weight
      (Cout, Cin, kh, kw), used in x's dtype; bias (Cout,), used in float32;
      padding ((top, bottom), (left, right)) with top + bottom = kh - 1 and
      left + right = kw - 1; act None, 'relu', 'sigmoid' or 'tanh', applied
      to the float32 sum plus bias before the one cast.
    """
    if x.device.type == "cpu":
        return conv_pallas_ref(x, weight, bias, padding, act, out_dtype)
    _require_cuda(x, "conv_pallas")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODE or act not in ACTS:
        raise ValueError(f"unsupported out_dtype {out_dtype} or act {act!r}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"x (B, Cin, H, W) and weight (Cout, Cin, kh, kw) do not "
                         f"match: {tuple(x.shape)}, {tuple(weight.shape)}")
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    (pt, _), (pl, _) = _check_padding(padding, kh, kw)
    w = weight.to(x.dtype).contiguous()
    b = bias.float().contiguous()
    if b.shape != (Cout,) or w.device != x.device or b.device != x.device:
        raise ValueError("bias must be (Cout,) and weight, bias on x's device")
    out = torch.empty((B, Cout, H, W), dtype=out_dtype, device=x.device)
    err = _build.library().mft_conv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), *x.stride(), B, Cin,
        H, W, Cout, kh, kw, pt, pl, ACTS[act], _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[out_dtype], _stream(x))
    _build.check(err, "mft_conv")
    conv_pallas.launches += 1
    return out


conv_pallas.launches = 0
