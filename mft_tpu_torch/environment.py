"""Machine-local settings (dataset paths).

A copy of ``mft_tpu/environment.py`` (reference MFT/environment.py:22-59):
``env_settings()`` imports ``mft_tpu_torch/local_environment.py``, writing a
stub there on first use, so each machine fills in its own dataset locations
(the file is listed in ``.gitignore``).
"""

import importlib
import logging
from pathlib import Path

logger = logging.getLogger(__name__)

_LOCAL_PATH = Path(__file__).parent / "local_environment.py"

_STUB = '''"""Machine-local paths: a generated stub, edit it."""


class EnvSettings:
    def __init__(self):
        self.tapvid_davis_dir = "datasets/tapvid_davis/tapvid_davis.pkl"
        self.tapvid_kinetics_dir = "datasets/tapvid_kinetics/"
        self.sintel_dir = "datasets/sintel/"
        self.kubric_dir = "datasets/kubric_movi_e_longterm/"
        self.flyingthings_dir = "datasets/flyingthings3d/"
        self.flyingchairs_dir = "datasets/flyingchairs/"
        self.kitti_dir = "datasets/kitti2015/"
        self.hd1k_dir = "datasets/hd1k/"
        self.viper_dir = "datasets/VIPER/"
        self.checkpoint_dir = "checkpoints/"


def local_env_settings():
    return EnvSettings()
'''


def create_default_local_file():
    _LOCAL_PATH.write_text(_STUB)
    logger.info("created local environment stub at %s - edit dataset paths there",
                _LOCAL_PATH)


def env_settings():
    if not _LOCAL_PATH.exists():
        create_default_local_file()
        importlib.invalidate_caches()
    from mft_tpu_torch.local_environment import local_env_settings
    return local_env_settings()
