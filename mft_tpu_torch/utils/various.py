"""Debug/robustness helpers: a copy of ``mft_tpu/utils/various.py``.

Role parity with reference MFT/utils/various.py:4-39: a post-mortem debugger
decorator (pdb here; the reference uses ipdb), its ``MFT_TPU_DEBUG`` switch
for the command-line entry points (JAX's ``main`` functions inline it), and
SparseExceptionLogger, which logs each distinct exception message once and
collapses repeated OOM-style messages by prefix.
"""

import functools
import logging
import os
import pdb
import sys
import traceback


def with_debugger(fn):
    """Drop into pdb post-mortem on exception (opt-in debug decorator)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            traceback.print_exc()
            pdb.post_mortem(sys.exc_info()[2])
            raise

    return wrapper


def debug_entry(fn):
    """``fn`` under :func:`with_debugger` when the ``MFT_TPU_DEBUG``
    environment variable is set (the CLIs' ``main``), else ``fn`` itself."""
    return with_debugger(fn) if os.environ.get("MFT_TPU_DEBUG") else fn


class SparseExceptionLogger:
    """Log each distinct exception message once (collapse repeats by prefix)."""

    def __init__(self, logger=None, prefix_len=80):
        self.logger = logger or logging.getLogger(__name__)
        self.prefix_len = prefix_len
        self.seen = set()
        self.counts = {}

    def __call__(self, message, exc=None):
        key = str(message)[: self.prefix_len]
        self.counts[key] = self.counts.get(key, 0) + 1
        if key in self.seen:
            return
        self.seen.add(key)
        if exc is not None:
            self.logger.exception("%s (further repeats suppressed)", message)
        else:
            self.logger.error("%s (further repeats suppressed)", message)

    def summary(self):
        return dict(self.counts)
