"""Tiled products: CUDA kernels, their plain versions and the bound that holds them.

Each function is a wrapper that launches its kernel on CUDA tensors and uses
its plain PyTorch version on CPU tensors:

- :func:`corr_build_folded` (replacing ``mft_tpu/ops/corr_lookup_pallas.py
  build_corr_pyramid_pallas``): every level of the all-pairs correlation
  volume of all pairs, written straight into the folded (B, P, Q_l/128, 128)
  layout; kernel ``mft_corr_build_folded_tc`` (``csrc/product_tc.cu``) for
  bfloat16, ``mft_corr_build_folded`` (``csrc/product.cu``) for float32;
- :func:`conv_pallas` (replacing ``mft_tpu/ops/conv_pallas.py
  conv_pallas``): a SAME-size convolution of NCHW activations with
  ``nn.Conv2d`` weights (Cout, Cin, kh, kw), bias and an activation in
  float32, one cast at the end; kernel ``mft_conv_tc`` for bfloat16,
  ``mft_conv`` for float32.

Summation order. Each output is one float32 sum over k of a_k * b_k: k is
the channel for the volume and (channel, ky, kx) for the convolution. The
plain versions add one k at a time, ascending from 0.0, over whole maps.

- float32 kernels take the same order (built with -fmad=false) and give the
  same bits as the plain versions.
- bfloat16 kernels run on the tensor cores, which sum the exact float32
  products in an order of their own, as the TPU's MXU did for the JAX
  kernels. They are held to :func:`product_error_bound` instead.

The fused lookup (``ops/corr_lookup.py corr_lookup_fused``, bfloat16) and
the window correlations (``ops/corr_alt.py corr_lookup_alt``,
``corr_lookup_win``, bfloat16) sum on the tensor cores too;
:func:`corr_lookup_fused_magnitude` and :func:`corr_window_magnitude` give
the S of their bounds.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

from mft_tpu_torch.ops import _build
from mft_tpu_torch.ops.corr_alt import window_samples
from mft_tpu_torch.ops.corr_lookup import corr_lookup_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ACTS = {None: 0, "relu": 1, "sigmoid": 2, "tanh": 3}
_ACT_FN = {None: lambda v: v, "relu": torch.relu, "sigmoid": torch.sigmoid,
           "tanh": torch.tanh}
MAX_LEVELS = 4
LANES = 128   # values per row of a folded level
K_TILE = 64   # channels per k stage of the tensor-core kernels
MAX_TAP = 7   # largest kh, kw of the tensor-core convolution (its halo fits)
# the error bound: per added term four times float32's unit roundoff 2^-24
# (any order of the sum, also the tensor cores' truncating alignment), and
# one bfloat16 ulp of the output at the value
SUM_UNIT = 2.0 ** -22
OUT_ULP = 2.0 ** -7


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
# the error bound of the bfloat16 kernels
# --------------------------------------------------------------------------- #
def product_error_bound(want, magnitude, K: int, scale: float = 1.0):
    """Largest |got - want| allowed for a bfloat16 product: K*2^-22*S*scale +
    2^-7*|want|, in float32.

    The products of bfloat16 values are exact in float32, so two kernels
    differ only in the order of K float32 additions and in the last rounding.
    Any order stays within K*2^-22*S of the exact sum, S = sum_k |a_k*b_k|
    (``magnitude``, with ``scale`` not applied); the one rounding to the output
    type adds an ulp at the value (2^-7 relative for bfloat16). A bias added
    in float32 and relu, sigmoid or tanh (1-Lipschitz) keep the bound.
    """
    return (K * SUM_UNIT * scale) * magnitude.float() + OUT_ULP * want.float().abs()


def corr_build_folded_magnitude(f1, f2_levels) -> list:
    """S of every output of :func:`corr_build_folded`: per level (B, P,
    Q_l/128, 128) float32 sums over the channels of |f1| * |f2_l|, taken in
    float64 (no TF32) and unscaled."""
    a = f1.abs().double().transpose(1, 2)                # (B, P, C)
    B, P, _ = a.shape
    return [torch.bmm(a, f2.abs().double()).float().reshape(B, P, -1, LANES)
            for f2 in f2_levels]


def corr_lookup_fused_magnitude(pyramid, coords, wc, radius: int = 4):
    """S of every output of :func:`mft_tpu_torch.ops.corr_lookup.corr_lookup_fused`:
    (B, P, F) float32 sums over the window samples k of |sample_k| * |wc[k, f]|,
    the samples rounded through the volume dtype and wc taken in it (the
    operands the kernel multiplies), summed in float64 (no TF32); no bias."""
    dt = pyramid[0].dtype
    samples = corr_lookup_ref(pyramid, coords, radius).abs().double()
    return torch.matmul(samples, wc.to(dt).abs().double()).float()


def _abs_dots64(g, f):
    """(R, T) float64 sums over the channels of |g| * |f| (no TF32)."""
    return torch.einsum("rtc,rc->rt", g.double().abs(), f.double().abs())


def corr_window_magnitude(f1, f2_pyramid, coords, radius: int = 4):
    """S of every output of :func:`mft_tpu_torch.ops.corr_alt.corr_lookup_alt`
    and ``corr_lookup_win``: (B, N, L*(2r+1)^2) float32, the plain function
    on |f1| and |f2_l| in float64 and unscaled, i.e. the bilinear sample, zeros
    outside the map, of q -> sum_c |f1[b,p,c]| * |f2_l[b,q,c]|, the features
    taken in the pyramid dtype. A sample is a convex combination of four tap
    dots, so the bound of each dot carries over to it with this S."""
    return window_samples(f1, f2_pyramid, coords, radius, dot=_abs_dots64,
                          scale=1.0).float()


def conv_pallas_magnitude(x, weight, padding):
    """S of every output of :func:`conv_pallas`: (B, Cout, H, W) float32 sums
    of |x| * |w| over (channel, ky, kx), zeros outside the image, taken in
    float64 (no TF32); no bias, no activation."""
    (pt, pb), (pl, pr) = _check_padding(padding, *weight.shape[2:])
    xp = F.pad(x.abs().double(), (pl, pr, pt, pb))
    return F.conv2d(xp, weight.to(x.dtype).abs().double()).float()


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


def _check_aligned(name: str, *tensors):
    """The tensor-core kernels copy 16-byte pieces: every base address must be
    16-byte aligned (a fresh or contiguous allocation is)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start at 16-byte aligned addresses")


def conv_weight_tiles(weight):
    """nn.Conv2d weights (Cout, Cin, kh, kw) in the bfloat16 conv kernel's
    layout: (kh*kw, npad, cpad), tap-major, then output channel, then input
    channel, zeros past Cout and Cin; cpad a multiple of 64, npad 8 for
    Cout <= 8, else a multiple of 64."""
    Cout, Cin, kh, kw = weight.shape
    npad = 8 if Cout <= 8 else -(-Cout // K_TILE) * K_TILE
    cpad = -(-Cin // K_TILE) * K_TILE
    tiles = weight.new_zeros((kh * kw, npad, cpad))
    tiles[:, :Cout, :Cin] = weight.permute(2, 3, 0, 1).reshape(kh * kw, Cout, Cin)
    return tiles


def corr_build_folded(f1, f2_levels) -> list:
    """All levels of the correlation volume in the folded layout, one launch.

    args: f1 (B, C, P) source features (the NCHW map with its pixels
      flattened); f2_levels, 1..4 (B, C, Q_l) pooled target features of the
      same dtype (float32 or bfloat16), Q_l a multiple of 128: a level of
      fewer than 128 positions comes zero-padded to 128, so its padding lanes
      are zero.
    returns: per level (B, P, Q_l/128, 128) in the features' dtype,
      value = (sum_c f1[b, c, p] * f2_l[b, c, q]) * (1/sqrt(C)), summed in
      float32 and rounded once (bfloat16: on the tensor cores, within
      :func:`product_error_bound` of the plain version).
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
    ptrs = ([f2.data_ptr() for f2 in f2_levels] + pad + [o.data_ptr() for o in outs] + pad
            + qs + [0] * len(pad))
    lib = _build.library()
    if f1.dtype == torch.bfloat16:
        # the tensor maps need rows of a multiple of 16 bytes: zero columns
        # past P (the kernel writes rows p < P only)
        Pp = -(-P // 8) * 8
        f1p = F.pad(f1, (0, Pp - P)) if Pp != P else f1
        _check_aligned("corr_build_folded", f1p, *f2_levels, *outs)
        err = lib.mft_corr_build_folded_tc(f1p.data_ptr(), *ptrs, len(qs), B, C, P, Pp,
                                           corr_scale(C), _stream(f1))
        _build.check(err, "mft_corr_build_folded_tc")
        corr_build_folded.tensor_core_launches += 1
    else:
        err = lib.mft_corr_build_folded(f1.data_ptr(), *ptrs, len(qs), B, C, P,
                                        corr_scale(C), _stream(f1))
        _build.check(err, "mft_corr_build_folded")
    corr_build_folded.launches += 1
    return outs


corr_build_folded.launches = 0
corr_build_folded.tensor_core_launches = 0


def conv_pallas(x, weight, bias, padding, act=None, out_dtype=None):
    """SAME-size convolution: (B, Cout, H, W) in ``out_dtype`` (default x's).

    args: x (B, Cin, H, W) float32 or bfloat16, any strides; weight
      (Cout, Cin, kh, kw), used in x's dtype; bias (Cout,), used in float32;
      padding ((top, bottom), (left, right)) with top + bottom = kh - 1 and
      left + right = kw - 1; act None, 'relu', 'sigmoid' or 'tanh', applied
      to the float32 sum plus bias before the one cast. bfloat16 runs on the
      tensor cores (kh, kw <= 7), within :func:`product_error_bound` of the
      plain version.
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
    b = bias.float().contiguous()
    if b.shape != (Cout,) or weight.device != x.device or b.device != x.device:
        raise ValueError("bias must be (Cout,) and weight, bias on x's device")
    out = torch.empty((B, Cout, H, W), dtype=out_dtype, device=x.device)
    lib = _build.library()
    if x.dtype == torch.bfloat16:
        if kh > MAX_TAP or kw > MAX_TAP:
            raise ValueError(f"the bfloat16 conv kernel takes kh, kw <= {MAX_TAP}, "
                             f"got {kh}x{kw}")
        if (H - 1) * x.stride(2) + (W - 1) * x.stride(3) >= 2 ** 31:
            raise ValueError("one image of x spans more than 2^31 elements")
        wt = conv_weight_tiles(weight.to(x.dtype))
        err = lib.mft_conv_tc(
            x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), *x.stride(), B, Cin,
            H, W, Cout, kh, kw, pt, pl, wt.shape[2], wt.shape[1], ACTS[act],
            _DTYPE_CODE[out_dtype], _stream(x))
        _build.check(err, "mft_conv_tc")
        conv_pallas.tensor_core_launches += 1
    else:
        w = weight.to(x.dtype).contiguous()
        err = lib.mft_conv(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), *x.stride(), B, Cin,
            H, W, Cout, kh, kw, pt, pl, ACTS[act], _DTYPE_CODE[out_dtype], _stream(x))
        _build.check(err, "mft_conv")
    conv_pallas.launches += 1
    return out


conv_pallas.launches = 0
conv_pallas.tensor_core_launches = 0
