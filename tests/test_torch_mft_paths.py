"""The port's MFT tracker against the JAX package's: the int8 volume and
the 'fold', 'mixed' and conv_backend 'pallas' paths.

The other half of ``test_torch_mft.py`` (its helpers: the same 64x64 clip,
deltas, weights and float32 compute), in a file of its own so that the
suite's workers can run the two halves at once.
"""

import numpy as np
import pytest

from test_torch_mft import _run_both


INT8_FRAMES = 3


@pytest.fixture(scope="module")
def both_runs_int8():
    """Both trackers with corr_method 'int8' (the quantized volume)."""
    return _run_both(INT8_FRAMES, jax_method="int8", port_method="int8")


@pytest.mark.parametrize("frame", range(1, INT8_FRAMES + 1))
def test_int8_frame_matches_jax(both_runs_int8, frame):
    """float32 model, int8 volume: both trackers quantize the same volume to
    the same int8 values and round the samples to bf16, so compare in
    relation to the outputs' scale (the tolerance of
    test_torch_raft.py::test_compute_flow_matches_jax_bf16): mean error under
    2% of the mean magnitude and 99% of pixels within 10% of it."""
    want, got = both_runs_int8[frame - 1]
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        scale = float(np.abs(w).mean()) + 1e-6
        err = np.abs(g - w)
        assert np.isfinite(g).all(), name
        assert err.mean() < 0.02 * scale, (frame, name, err.mean(), scale)
        assert np.quantile(err, 0.99) < 0.1 * scale, (frame, name, np.quantile(err, 0.99))


@pytest.mark.parametrize("option", [("fold", "auto"), ("mixed", "auto"), ("auto", "pallas")],
                         ids=["fold", "mixed", "conv_pallas"])
def test_new_path_frame_matches_jax(option):
    """One tracked frame with corr_method 'fold' / 'mixed' or conv_backend
    'pallas', against the JAX tracker with the same option (its folded
    volume through its Pallas kernels in interpret mode; at this 8x8
    stride-8 map its mixed volume folds nothing, and its conv_apply takes
    shifted matmuls, conv_pallas needing W8 = 64): float32, 1e-4 on flow
    (px), occlusion and sigma at every pixel."""
    method, backend = option
    (want, got), = _run_both(1, jax_method=method, port_method=method,
                             conv_backend=backend)
    for g, w, name in zip(got, want, ("flow", "occlusion", "sigma")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-5, err_msg=f"{option} {name}")
