"""Tiered pairwise flow cache: device memory -> host RAM -> disk.

A copy of ``mft_tpu/io/cache.py`` (reference FlowCache, MFT/utils/io.py:
618-751): entries are keyed by (left_id, right_id); a write fills the fastest
tier with room; a disk read is promoted into RAM; ``backup_to_disk`` /
``load_from_disk`` keep the RAM tier between runs; ``clear`` wipes it all.

The device tier holds ``torch.Tensor`` triples: an entry read from it feeds
the tracker with no host copy. Any tensor counts as a device value, a CPU one
too, so the tiers fill on the CPU as the JAX package's do there, where jax
arrays count as device arrays. RAM entries are numpy; disk entries use the
flowou codecs (default ``.flowouX16.pkl``).

A disk entry that does not decode is a miss, and ``read`` deletes its file,
so that ``contains`` stops reporting it (the JAX cache keeps such a file,
whose pair ``contains`` then reports on every later pass).
"""

import logging
import shutil
from pathlib import Path

import numpy as np
import torch

from mft_tpu_torch.io import flowou_codecs
from mft_tpu_torch.utils.misc import ensure_numpy

logger = logging.getLogger(__name__)


class FlowCache:
    def __init__(self, cache_dir, max_ram_mb=10000, max_device_mb=5000,
                 ext=".flowouX16.pkl"):
        self.cache_dir = Path(cache_dir) if cache_dir is not None else None
        self.max_ram_bytes = int(max_ram_mb * 1e6)
        self.max_device_bytes = int(max_device_mb * 1e6)
        self.ext = ext
        self.device_cache = {}
        self.ram_cache = {}
        self.device_bytes = 0
        self.ram_bytes = 0
        self.hits = 0
        self.misses = 0
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ #
    def read(self, left_id, right_id):
        """-> (flow (H, W, 2), occl (H, W), sigma (H, W)) or None on a miss:
        tensors from the device tier, numpy arrays from the others."""
        key = (int(left_id), int(right_id))
        if key in self.device_cache:
            self.hits += 1
            return self.device_cache[key]
        if key in self.ram_cache:
            self.hits += 1
            return self.ram_cache[key]
        path = self._path(key)
        if path is not None and path.exists():
            try:
                value = flowou_codecs.read_flowou(path)
            except Exception:
                # a corrupt file is a miss; delete it so contains() agrees
                logger.exception("failed reading cached flow %s; deleting it", path)
                path.unlink(missing_ok=True)
                self.misses += 1
                return None
            self.hits += 1
            self._store_ram(key, value)  # promote
            return value
        self.misses += 1
        return None

    def contains(self, left_id, right_id):
        """Existence-only probe: True if ``read`` would find the entry,
        without the disk tier's decode and RAM promotion (``track_chunk``
        asks it before falling back to per-frame tracking, which then reads
        the entries for real)."""
        key = (int(left_id), int(right_id))
        if key in self.device_cache or key in self.ram_cache:
            return True
        path = self._path(key)
        return path is not None and path.exists()

    def write(self, left_id, right_id, flow, occlusion, sigma):
        key = (int(left_id), int(right_id))
        value = (flow, occlusion, sigma)
        nbytes = sum(int(v.nbytes) for v in value)   # no host fetch to size it
        if self.device_bytes + nbytes <= self.max_device_bytes and _is_device(flow):
            self.device_cache[key] = value
            self.device_bytes += nbytes
        elif self.ram_bytes + nbytes <= self.max_ram_bytes:
            self._store_ram(key, tuple(ensure_numpy(v) for v in value))
        elif self.cache_dir is not None:
            flowou_codecs.write_flowou(self._path(key), flow, occlusion, sigma)
        else:
            logger.warning("flow cache full and no disk tier; dropping %s", key)

    # ------------------------------------------------------------------ #
    def backup_to_disk(self):
        """Flush the RAM and device tiers to disk (reference io.py:719-733)."""
        if self.cache_dir is None:
            return
        for key, value in {**self.ram_cache, **self.device_cache}.items():
            path = self._path(key)
            if not path.exists():
                flowou_codecs.write_flowou(path, *value)

    def load_from_disk(self):
        """Fill the RAM tier from disk (reference io.py:735-744)."""
        if self.cache_dir is None:
            return
        for path in sorted(self.cache_dir.glob(f"*{self.ext}")):
            try:
                li, ri = path.name.split(self.ext)[0].split("--")
                key = (int(li), int(ri))
            except ValueError:
                continue
            if key not in self.ram_cache:
                value = flowou_codecs.read_flowou(path)
                if not self._store_ram(key, value):
                    break  # RAM full

    def clear(self, remove_disk=False):
        self.device_cache.clear()
        self.ram_cache.clear()
        self.device_bytes = 0
        self.ram_bytes = 0
        if remove_disk and self.cache_dir is not None and self.cache_dir.exists():
            shutil.rmtree(self.cache_dir)
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ #
    def _path(self, key):
        if self.cache_dir is None:
            return None
        return self.cache_dir / f"{key[0]}--{key[1]}{self.ext}"

    def _store_ram(self, key, value):
        nbytes = sum(np.asarray(v).nbytes for v in value)
        if self.ram_bytes + nbytes > self.max_ram_bytes:
            return False
        self.ram_cache[key] = value
        self.ram_bytes += nbytes
        return True


def _is_device(x) -> bool:
    return isinstance(x, torch.Tensor)
