"""The port stands alone: no module of mft_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package, nor optax, orbax, OpenCV, pandas, tabulate
or PIL (the card's machine has none of them), and chip_smoke.py refuses to
run without a card or without the package beside it.

Each check runs in a fresh interpreter whose import system refuses ``jax``,
``flax``, ``optax``, ``orbax``, ``msgpack``, ``mft_tpu``, ``cv2``,
``pandas``, ``tabulate`` and ``PIL`` (and their submodules).
"""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import mft_tpu_torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "mft_tpu", "cv2",
           "pandas", "tabulate", "PIL")

_BLOCKER = f"""
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, {str(REPO)!r})
"""


def _run(code: str, cwd=REPO, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", _BLOCKER + code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def _port_modules():
    mods = ["mft_tpu_torch"]
    for info in pkgutil.walk_packages(mft_tpu_torch.__path__, "mft_tpu_torch."):
        mods.append(info.name)
    return mods


def test_port_modules_list_is_complete():
    mods = _port_modules()
    for want in ("mft_tpu_torch.ops._build", "mft_tpu_torch.ops.corr_lookup",
                 "mft_tpu_torch.ops.chain_select", "mft_tpu_torch.ops.corr_alt",
                 "mft_tpu_torch.ops.product", "mft_tpu_torch.models.raft.update",
                 "mft_tpu_torch.models.raft.corr",
                 "mft_tpu_torch.tracker.mft", "mft_tpu_torch.ops.warp",
                 "mft_tpu_torch.core.flowou", "mft_tpu_torch.tracker.select",
                 "mft_tpu_torch.tracker.point_tracking", "mft_tpu_torch.tracker.fused",
                 "mft_tpu_torch.models.raft.wrapper", "mft_tpu_torch.config",
                 "mft_tpu_torch.models.raft.flax_msgpack", "mft_tpu_torch.utils.timing",
                 "mft_tpu_torch.utils.misc", "mft_tpu_torch.utils.repro",
                 "mft_tpu_torch.environment", "mft_tpu_torch.io.png",
                 "mft_tpu_torch.io.flowou_codecs", "mft_tpu_torch.io.cache",
                 "mft_tpu_torch.eval.tapvid", "mft_tpu_torch.eval.metrics",
                 "mft_tpu_torch.eval.runner", "mft_tpu_torch.eval.evaluate",
                 "mft_tpu_torch.eval.report", "mft_tpu_torch.utils.vis",
                 "mft_tpu_torch.train.losses", "mft_tpu_torch.train.optim",
                 "mft_tpu_torch.train.checkpoint", "mft_tpu_torch.train.loop",
                 "mft_tpu_torch.train.synth", "mft_tpu_torch.train.flow_readers",
                 "mft_tpu_torch.train.augment", "mft_tpu_torch.train.datasets",
                 "mft_tpu_torch.train.validate", "mft_tpu_torch.train.logger",
                 "mft_tpu_torch.parallel", "mft_tpu_torch.parallel.mesh",
                 "mft_tpu_torch.parallel.streaming"):
        assert want in mods


def test_port_and_chip_smoke_import_without_jax():
    code = ("import importlib\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_blocker_blocks():
    proc = _run("import mft_tpu\n")
    assert proc.returncode != 0 and "blocked import" in proc.stderr


def test_chip_smoke_fails_without_card():
    """No CUDA here: chip_smoke exits non-zero and prints no result line."""
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.main())\n")
    proc = _run(code)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("path", ["mft_tpu_torch", "chip_smoke.py",
                                  "tools/torch_profile_frame.py",
                                  "tools/torch_lookup_ab.py",
                                  "tools/torch_k1_repair.py",
                                  "tools/torch_window_probe.py",
                                  "tools/torch_lookup_probe.py"])
def test_no_jax_import_statements(path):
    """Also by text: no import line names jax, flax, optax, orbax, mft_tpu,
    cv2, pandas, tabulate or PIL (the port's own package name aside)."""
    root = REPO / path
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in BLOCKED, f"{f}: {s}"
