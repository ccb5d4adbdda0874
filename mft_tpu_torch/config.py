"""Config system: executable-python configs with falsy-missing-attribute access.

A copy of ``mft_tpu/config.py`` (the port imports nothing of ``mft_tpu``):

- ``Config`` objects return an empty, falsy ``Config`` for missing attributes,
  so ``cfg.foo.bar.baz`` never raises and is False when unset;
- config files are plain .py files exposing ``get_config() -> Config`` and are
  loaded by path via importlib;
- ``merge`` overlays another config.

The tracker configurations of ``configs/`` are rebuilt here without reading
any file (those files import the JAX package), field for field:

- ``default_config()``: ``configs/MFT_cfg.py`` + ``configs/flow/raftou_default.py``;
- ``synth_config()``: ``configs/MFT_synth_cfg.py``, whose flow config
  ``synth_flow_config()`` (``configs/flow/raftou_synth.py``) loads the
  committed weights ``weights/raftou_synth.msgpack``;
- ``fast_config()``: ``configs/MFT_fast_cfg.py``, a per-delta iteration
  schedule;
- ``warm_config()``: ``configs/MFT_warm_cfg.py``, that schedule with the
  template pair warm-started from the previous frame;
- ``demo_cpu_config()``: ``configs/MFT_demo_cpu_cfg.py``, 4 deltas and 4
  iterations in float32.
"""

import importlib.util
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

# the weights committed beside the package (configs/flow/raftou_synth.py)
SYNTH_WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "raftou_synth.msgpack"


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
    conf.flow_cache_dir = Path("flow_cache/raftou_default/")
    conf.flow_cache_ext = ".flowouX16.pkl"
    conf.name = "raftou_default"
    return conf


def synth_flow_config():
    """RAFT-OU flow config of ``configs/flow/raftou_synth.py``: the default
    architecture with the committed weights (found relative to the package,
    not the working directory)."""
    conf = default_flow_config()
    conf.model = str(SYNTH_WEIGHTS)
    conf.flow_cache_dir = Path("flow_cache/raftou_synth/")
    conf.name = "raftou_synth"
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


def synth_config():
    """MFT tracker config of ``configs/MFT_synth_cfg.py``: the default
    tracker on the committed weights."""
    conf = default_config()
    conf.flow_config = synth_flow_config()
    conf.name = "MFT_synth_cfg"
    return conf


def fast_config():
    """MFT tracker config of ``configs/MFT_fast_cfg.py``: the default
    tracker with a per-delta iteration schedule (57 pair-iterations a frame
    instead of 84)."""
    conf = default_config()
    conf.flow_iters_schedule = {np.inf: 12, 1: 4, 2: 5, 4: 6, 8: 8, 16: 10, 32: 12}
    conf.name = "MFT_fast_cfg"
    return conf


def warm_config():
    """MFT tracker config of ``configs/MFT_warm_cfg.py``: the fast schedule
    with 5 iterations for the template pair, which starts from the previous
    frame's selected flow (``warm_start_inf``)."""
    conf = default_config()
    conf.flow_iters_schedule = {np.inf: 5, 1: 4, 2: 5, 4: 6, 8: 8, 16: 10, 32: 12}
    conf.warm_start_inf = True
    conf.name = "MFT_warm_cfg"
    return conf


def demo_cpu_config():
    """MFT tracker config of ``configs/MFT_demo_cpu_cfg.py``: deltas
    {inf, 1, 2, 4}, 4 iterations, float32, random weights."""
    from mft_tpu_torch.models.raft import RAFTFlow
    from mft_tpu_torch.tracker import MFT
    flow = Config()
    flow.of_class = RAFTFlow
    flow.raft_params = {"occlusion_module": "separate_with_uncertainty",
                        "small": False, "compute_dtype": "float32"}
    flow.model = None
    flow.init_seed = 0
    flow.flow_iters = 4
    flow.name = "raftou_demo_cpu"
    conf = Config()
    conf.tracker_class = MFT
    conf.flow_config = flow
    conf.deltas = [np.inf, 1, 2, 4]
    conf.occlusion_threshold = 0.02
    conf.name = "MFT_demo_cpu_cfg"
    return conf
