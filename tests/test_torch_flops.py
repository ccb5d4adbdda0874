"""The port's FLOP budget (``mft_tpu_torch/utils/flops.py``) against the JAX
package's (``mft_tpu/utils/flops.py``), and the card's bf16 peak by name."""

import pytest

from mft_tpu.utils import flops as jax_flops
from mft_tpu_torch.utils import flops

SHAPES = [(512, 512, 7, 12), (1080, 1920, 7, 12), (2160, 3840, 7, 12), (256, 320, 1, 4),
          (368, 768, 6, 12), (64, 96, 3, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_frame_flops_match_jax(shape):
    H, W, n_pairs, iters = shape
    assert flops.frame_flops(H, W, n_pairs, iters) == jax_flops.frame_flops(H, W, n_pairs, iters)
    H8, W8 = H // 8, W // 8
    for name, args in (("basic_encoder_flops", (H, W)),
                       ("corr_pyramid_flops", (H8, W8, n_pairs)),
                       ("corr_lookup_flops", (H8, W8)), ("update_block_flops", (H8, W8)),
                       ("mask_head_flops", (H8, W8)), ("ou_block_flops", (H8, W8)),
                       ("upsample_flops", (H, W, n_pairs))):
        assert getattr(flops, name)(*args) == getattr(jax_flops, name)(*args), name


def test_peak_flops_by_device_name():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert flops.peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert flops.peak_flops("TPU v5 lite") is None
    assert flops.peak_flops() is None       # no card here: nothing to read the name from
