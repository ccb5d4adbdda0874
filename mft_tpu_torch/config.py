"""Config system: executable-python configs with falsy-missing-attribute access.

A copy of ``mft_tpu/config.py`` (the port imports nothing of ``mft_tpu``):

- ``Config`` objects return an empty, falsy ``Config`` for missing attributes,
  so ``cfg.foo.bar.baz`` never raises and is False when unset;
- config files are plain .py files exposing ``get_config() -> Config`` and are
  loaded by path via importlib;
- ``merge`` overlays another config.

``default_config()`` builds, without reading any file, the configuration of
``configs/MFT_cfg.py`` + ``configs/flow/raftou_default.py`` for the port.
"""

import importlib.util
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


class Config:
    """Attribute bag whose missing attributes read as falsy empty Configs."""

    def __getattr__(self, name):
        # only called when the attribute is NOT found normally
        return Config()

    def __bool__(self):
        return False

    def merge(self, other, update_dicts=False):
        for key, value in other.__dict__.items():
            if key in self.__dict__:
                ours = getattr(self, key)
                if update_dicts and isinstance(ours, dict) and isinstance(value, dict):
                    ours.update(value)
                else:
                    logger.debug("Rewriting config key [%s] (%r -> %r)",
                                 key, ours, value)
                    setattr(self, key, value)
            else:
                setattr(self, key, value)

    def __repr__(self):
        return repr(self.__dict__)

    def __eq__(self, other):
        if isinstance(other, self.__class__):
            return self.__dict__ == other.__dict__
        return False


def cfg_value(value, default):
    """Missing-vs-falsy config reads: treat only the empty ``Config`` a
    missing attribute returns (or None) as missing, so an explicit 0 or
    False is kept."""
    if value is None or isinstance(value, Config):
        return default
    return value


def load_config(path):
    """Load a .py config file by path and return its ``get_config()`` result."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"config {path} does not exist")
    spec = importlib.util.spec_from_file_location("mft_tpu_torch_loaded_config",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.get_config()


def default_flow_config():
    """RAFT-OU flow config of ``configs/flow/raftou_default.py``: big RAFT
    with separate occlusion + uncertainty heads, 12 iterations, bf16."""
    from mft_tpu_torch.models.raft import RAFTFlow
    conf = Config()
    conf.of_class = RAFTFlow
    conf.raft_params = {
        "occlusion_module": "separate_with_uncertainty",
        "small": False,
        "compute_dtype": "bfloat16",
    }
    # not distributed; a missing checkpoint means random init from init_seed
    conf.model = "checkpoints/raftou_kubric.pt"
    conf.init_seed = 0
    conf.flow_iters = 12
    conf.name = "raftou_default"
    return conf


def default_config():
    """MFT tracker config of ``configs/MFT_cfg.py``: deltas
    {inf, 1, 2, 4, 8, 16, 32}, occlusion threshold 0.02, RAFT-OU flow."""
    from mft_tpu_torch.tracker import MFT
    conf = Config()
    conf.tracker_class = MFT
    conf.flow_config = default_flow_config()
    conf.deltas = [np.inf, 1, 2, 4, 8, 16, 32]
    conf.occlusion_threshold = 0.02
    conf.name = "MFT_cfg"
    return conf
