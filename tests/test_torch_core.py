"""The port's core numerics and config system against the JAX package's."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.config import Config as JaxConfig
from mft_tpu.config import cfg_value as jax_cfg_value
from mft_tpu.config import load_config as jax_load_config
from mft_tpu.core.flowou import invalid_mask as jax_invalid_mask
from mft_tpu.core.interp import bilinear_sample as jax_bilinear_sample
from mft_tpu_torch.config import Config, cfg_value, load_config
from mft_tpu_torch.core import (bilinear_sample, grid_coords, identity_flowou,
                                invalid_mask, resolve_device)


@pytest.mark.parametrize("channels,coord_shape", [(1, (50, 2)), (3, (7, 9, 2)),
                                                  (2, (20, 24, 2))])
def test_bilinear_sample_matches_jax(rng, channels, coord_shape):
    """Zero padding, taps outside on every side, same op order: 1e-6."""
    H, W = 20, 24
    img = rng.standard_normal((H, W, channels)).astype(np.float32)
    coords = (rng.random(coord_shape) * [W + 6, H + 6] - 3).astype(np.float32)
    got = bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
    want = jax_bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_grid_and_invalid_mask_match_jax(rng):
    flow = (rng.standard_normal((12, 16, 2)) * 8).astype(np.float32)
    g = grid_coords(12, 16)
    assert g[3, 5].tolist() == [5.0, 3.0]
    np.testing.assert_array_equal(invalid_mask(torch.from_numpy(flow)).numpy(),
                                  np.asarray(jax_invalid_mask(jnp.asarray(flow))))


def test_identity_flowou():
    r = identity_flowou((4, 6))
    assert r.flow.shape == (4, 6, 2) and r.occlusion.shape == (4, 6)
    assert not r.flow.any() and not r.sigma.any()


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_config_behaves_as_jax_config(tmp_path):
    """Falsy missing attributes, merge, cfg_value and load_config, side by side."""
    src = tmp_path / "cfg.py"
    src.write_text("def get_config():\n"
                   "    from types import SimpleNamespace\n"
                   "    return SimpleNamespace(deltas=[1, 2], name='x')\n")
    for cls, value, load in ((Config, cfg_value, load_config),
                             (JaxConfig, jax_cfg_value, jax_load_config)):
        a, b = cls(), cls()
        a.x, a.d = 1, {"k": 1}
        b.x, b.d, b.y = 2, {"j": 2}, 3
        assert not a.missing.deeper and isinstance(a.missing, cls)
        a.merge(b, update_dicts=True)
        assert (a.x, a.d, a.y) == (2, {"k": 1, "j": 2}, 3)
        assert value(a.missing, 7) == 7 and value(0, 7) == 0
        assert load(src).deltas == [1, 2]
