"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

| wrapper (kernel)                          | replaces (mft_tpu/ops)                              |
|-------------------------------------------|-----------------------------------------------------|
| corr_lookup_fused (mft_corr_lookup_conv_tc; f32: mft_corr_lookup_conv) | corr_lookup_pallas.py corr_lookup_pallas_fused |
| corr_lookup (mft_corr_lookup)             | corr_lookup_pallas.py corr_lookup_pallas             |
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

A wrapper launches its kernel for CUDA tensors and uses the plain version for
CPU tensors; it raises for anything else. Each wrapper counts its launches in
its ``launches`` attribute (:func:`launch_counts`, :func:`reset_launch_counts`);
the two tiled products, the fused lookup and the two window correlations
also count their bfloat16 launches, which run on the tensor cores, in
``tensor_core_launches`` (:func:`tensor_core_launch_counts`). The lane-major
lookup counts on the card the (group, level)s it staged and those it read
per pixel (:func:`lane_major_staged_counts`).
"""

from mft_tpu_torch.ops.chain_select import chain_select, chain_select_ref
from mft_tpu_torch.ops.corr_alt import (corr_lookup_alt, corr_lookup_alt_ref,
                                        corr_lookup_win)
from mft_tpu_torch.ops.corr_lookup import (
    corr_lookup, corr_lookup_folded, corr_lookup_folded_ref, corr_lookup_fused,
    corr_lookup_fused_ref, corr_lookup_mixed, corr_lookup_mixed_ref, corr_lookup_packed,
    corr_lookup_packed_i8, corr_lookup_packed_i8_ref, corr_lookup_packed_ref,
    corr_lookup_q, corr_lookup_q_ref, corr_lookup_ref, corr_lookup_t,
    corr_lookup_t_ref, lane_major_staged_counts)
from mft_tpu_torch.ops.product import (conv_pallas, conv_pallas_magnitude, conv_pallas_ref,
                                       conv_weight_tiles, corr_build_folded,
                                       corr_build_folded_magnitude, corr_build_folded_ref,
                                       corr_lookup_fused_magnitude, corr_window_magnitude,
                                       product_error_bound)
from mft_tpu_torch.ops.warp import (bilinear_warp, bilinear_warp_banded, bilinear_warp_blocked,
                                    bilinear_warp_pallas, bilinear_warp_ref,
                                    bilinear_warp_tiled, snap256, split_hi_lo)

KERNELS = (corr_lookup_fused, corr_lookup, chain_select, corr_lookup_alt,
           corr_lookup_win, corr_lookup_q, corr_lookup_packed, corr_lookup_packed_i8,
           corr_lookup_t, corr_lookup_folded, corr_build_folded, corr_lookup_mixed,
           conv_pallas, bilinear_warp)


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
           "bilinear_warp_blocked", "bilinear_warp_tiled", "snap256", "split_hi_lo", "KERNELS",
           "launch_counts", "tensor_core_launch_counts", "reset_launch_counts"]
