"""Phase timers of the tracker's unfused frame step (``timers_enabled``).

A copy of ``general_time_measurer`` of ``mft_tpu/utils/timing.py``
(reference MFT/utils/timing.py:54-112) without its ``active`` switch (the
tracker makes timers only when they are on): start/stop intervals on the
host clock, each stop after an optional device synchronisation
(``torch.cuda.synchronize`` on the card), reported as their mean or sum
through ``logger.debug`` in the JAX package's words.
"""

import logging
import time

logger = logging.getLogger(__name__)


class general_time_measurer:
    """start/stop accumulator with mean/sum reporting."""

    def __init__(self, name="timer", device_sync_fn=None, start_now=False):
        self.name = name
        self.device_sync_fn = device_sync_fn
        self.intervals = []
        self._t0 = None
        if start_now:
            self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        if self.device_sync_fn is not None:
            self.device_sync_fn()
        self.intervals.append(time.perf_counter() - self._t0)
        self._t0 = None

    def report(self, mode="mean"):
        """The intervals' mean or sum in seconds (None when there are
        none), logged in ms."""
        if not self.intervals:
            return None
        arr = self.intervals
        if mode == "mean":
            val = sum(arr) / len(arr)
        elif mode == "sum":
            val = sum(arr)
        else:
            raise ValueError(mode)
        logger.debug("timer [%s] %s: %.2f ms over %d intervals",
                     self.name, mode, val * 1e3, len(arr))
        return val
