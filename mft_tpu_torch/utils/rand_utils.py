"""RNG helpers: a copy of ``mft_tpu/utils/rand_utils.py``. Reference parity: MFT/utils/rand_utils.py:5-15."""

from contextlib import contextmanager

import numpy as np


@contextmanager
def tmp_np_seed(seed):
    """Temporarily seed numpy's global RNG (no-op when seed is None)."""
    if seed is None:
        yield
        return
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)
