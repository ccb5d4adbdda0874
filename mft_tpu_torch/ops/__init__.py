"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

| wrapper (kernel)                          | replaces (mft_tpu/ops)                              |
|-------------------------------------------|-----------------------------------------------------|
| corr_lookup_fused (mft_corr_lookup_conv_tc; f32: mft_corr_lookup_conv) | corr_lookup_pallas.py corr_lookup_pallas_fused |
| corr_lookup (mft_corr_lookup)             | corr_lookup_pallas.py corr_lookup_pallas             |
| corr_lookup_bwd (mft_corr_lookup_bwd)     | the VJP of models/raft/corr.py _corr_lookup_pallas_ad (XLA) |
| chain_select (mft_chain_select)           | warp_pallas.py bilinear_warp_blocked (+ chain/select) |
| corr_lookup_alt (mft_corr_alt; bf16: window_tc_kernel) | alt_corr_pallas.py corr_lookup_alt      |
| corr_lookup_win (mft_corr_win; bf16: window_tc_kernel) | alt_corr_pallas.py corr_lookup_win      |
| corr_lookup_q (mft_corr_lookup_q)         | corr_lookup_pallas.py corr_lookup_pallas_q           |
| corr_lookup_packed (mft_corr_lookup_packed) | corr_lookup_pallas.py corr_lookup_pallas_packed    |
| corr_lookup_packed_i8 (mft_corr_lookup_packed_i8) | corr_lookup_pallas.py corr_lookup_pallas_packed_i8 |
| corr_lookup_t (mft_corr_lookup_t)         | corr_lookup_pallas.py corr_lookup_pallas_t           |
| corr_lookup_folded (mft_corr_lookup_folded) | corr_lookup_pallas.py corr_lookup_pallas_folded    |
| corr_lookup_mixed (mft_corr_lookup_mixed) | corr_lookup_pallas.py corr_lookup_pallas_mixed       |
| corr_build_folded (mft_corr_build_folded_tc; f32: mft_corr_build_folded) | corr_lookup_pallas.py build_corr_pyramid_pallas |
| conv_pallas (mft_conv_tc; f32: mft_conv)  | conv_pallas.py conv_pallas                           |
| bilinear_warp (mft_warp)                  | warp_pallas.py bilinear_warp_pallas, _banded, _tiled |
| jpeg_huff_decode, jpeg_huff_decode_progressive, jpeg_huff_encode (J1: host code, mft_jpeg_huff_decode / _decode_progressive / _encode) | no Pallas site: cv2/PIL on the host |
| jpeg_decode_pixels (J2: mft_jpeg_decode_pixels) | no Pallas site: cv2/PIL on the host         |
| jpeg_encode_pixels (J3: mft_jpeg_encode_pixels) | no Pallas site: cv2/PIL on the host         |
| mpeg4_vlc_decode, mpeg4_vlc_encode (V1: host code, mft_mpeg4_vlc_decode / _encode) | no Pallas site: cv2 (libavcodec) on the host |
| mpeg4_decode_pixels (V2: mft_mpeg4_decode_pixels) | no Pallas site: cv2 (libavcodec) on the host |
| mpeg4_encode_pixels (V3: mft_mpeg4_encode_pixels) | no Pallas site: cv2 (libavcodec) on the host |
| mjpeg_decode_pixels (J4: mft_mjpeg_decode_pixels) | no Pallas site: cv2 (libavcodec, swscale) on the host |

A wrapper launches its kernel for CUDA tensors and uses the plain version for
CPU tensors; it raises for anything else. Each wrapper counts its launches in
its ``launches`` attribute (:func:`launch_counts`, :func:`reset_launch_counts`);
the two tiled products, the fused lookup and the two window correlations
also count their bfloat16 launches, which run on the tensor cores, in
``tensor_core_launches`` (:func:`tensor_core_launch_counts`). The lane-major
lookup counts on the card the (group, level)s it staged and those it read
per pixel (:func:`lane_major_staged_counts`).

JPEG's native stages (:mod:`mft_tpu_torch.ops.jpeg`: J1 entropy coding runs
on the host and counts its native calls, J2/J3 the pixel stages on the card)
and the MPEG-4 Part 2 video codec's (:mod:`mft_tpu_torch.ops.mpeg4`: V1 on
the host, V2/V3 on the card) and Motion JPEG's pixel stage
(:mod:`mft_tpu_torch.ops.mjpeg`: J4 on the card, after J1) count in the same
registry.
"""

from mft_tpu_torch.ops.chain_select import chain_select, chain_select_ref
from mft_tpu_torch.ops.corr_alt import (corr_lookup_alt, corr_lookup_alt_ref,
                                        corr_lookup_win)
from mft_tpu_torch.ops.corr_lookup import (
    corr_lookup, corr_lookup_bwd, corr_lookup_bwd_ref, corr_lookup_folded, corr_lookup_folded_ref, corr_lookup_fused,
    corr_lookup_fused_ref, corr_lookup_mixed, corr_lookup_mixed_ref, corr_lookup_packed,
    corr_lookup_packed_i8, corr_lookup_packed_i8_ref, corr_lookup_packed_ref,
    corr_lookup_q, corr_lookup_q_ref, corr_lookup_ref, corr_lookup_t,
    corr_lookup_t_ref, lane_major_staged_counts)
from mft_tpu_torch.ops.jpeg import (jpeg_decode_pixels, jpeg_encode_pixels, jpeg_huff_decode,
                                    jpeg_huff_decode_progressive, jpeg_huff_encode)
from mft_tpu_torch.ops.mjpeg import mjpeg_decode_pixels
from mft_tpu_torch.ops.mpeg4 import (mpeg4_decode_pixels, mpeg4_encode_pixels, mpeg4_vlc_decode,
                                     mpeg4_vlc_encode)
from mft_tpu_torch.ops.product import (conv_pallas, conv_pallas_magnitude, conv_pallas_ref,
                                       conv_weight_tiles, corr_build_folded,
                                       corr_build_folded_magnitude, corr_build_folded_ref,
                                       corr_lookup_fused_magnitude, corr_window_magnitude,
                                       product_error_bound)
from mft_tpu_torch.ops.warp import (bilinear_warp, bilinear_warp_banded, bilinear_warp_blocked,
                                    bilinear_warp_pallas, bilinear_warp_ref,
                                    bilinear_warp_tiled, snap256, split_hi_lo)

KERNELS = (corr_lookup_fused, corr_lookup, corr_lookup_bwd, chain_select, corr_lookup_alt,
           corr_lookup_win, corr_lookup_q, corr_lookup_packed, corr_lookup_packed_i8,
           corr_lookup_t, corr_lookup_folded, corr_build_folded, corr_lookup_mixed,
           conv_pallas, bilinear_warp, jpeg_huff_decode, jpeg_huff_decode_progressive,
           jpeg_huff_encode, jpeg_decode_pixels, jpeg_encode_pixels, mpeg4_vlc_decode,
           mpeg4_vlc_encode, mpeg4_decode_pixels, mpeg4_encode_pixels, mjpeg_decode_pixels)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def tensor_core_launch_counts() -> dict:
    """{wrapper name: bfloat16 launches on the tensor cores since the last
    reset} of the wrappers that have them."""
    return {k.__name__: k.tensor_core_launches for k in KERNELS
            if hasattr(k, "tensor_core_launches")}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "tensor_core_launches"):
            k.tensor_core_launches = 0


__all__ = ["chain_select", "chain_select_ref", "corr_lookup", "corr_lookup_ref",
           "corr_lookup_bwd", "corr_lookup_bwd_ref",
           "corr_lookup_fused", "corr_lookup_fused_ref", "corr_lookup_alt",
           "corr_lookup_alt_ref", "corr_lookup_win", "corr_lookup_q",
           "corr_lookup_q_ref", "corr_lookup_packed", "corr_lookup_packed_ref",
           "corr_lookup_packed_i8", "corr_lookup_packed_i8_ref", "corr_lookup_t",
           "corr_lookup_t_ref", "lane_major_staged_counts", "corr_lookup_folded", "corr_lookup_folded_ref",
           "corr_lookup_mixed", "corr_lookup_mixed_ref", "corr_build_folded",
           "corr_build_folded_ref", "corr_build_folded_magnitude",
           "corr_lookup_fused_magnitude", "corr_window_magnitude", "conv_pallas",
           "conv_pallas_ref", "conv_pallas_magnitude", "conv_weight_tiles",
           "product_error_bound", "bilinear_warp",
           "bilinear_warp_ref", "bilinear_warp_pallas", "bilinear_warp_banded",
           "bilinear_warp_blocked", "bilinear_warp_tiled", "snap256", "split_hi_lo",
           "jpeg_huff_decode", "jpeg_huff_decode_progressive", "jpeg_huff_encode",
           "jpeg_decode_pixels", "jpeg_encode_pixels", "mpeg4_vlc_decode", "mpeg4_vlc_encode",
           "mpeg4_decode_pixels", "mpeg4_encode_pixels", "mjpeg_decode_pixels",
           "KERNELS",
           "launch_counts", "tensor_core_launch_counts", "reset_launch_counts"]
