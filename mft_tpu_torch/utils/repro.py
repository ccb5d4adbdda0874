"""Reproducibility helpers: the git state and a snapshot of the code.

A copy of ``mft_tpu/utils/repro.py`` (reference MFT/utils/repro.py:7-43):
``code_export`` copies the repository's ``.py`` files and its git state into
an experiment's export directory. Without git on the path (or outside a
checkout) the git fields are empty and the export still runs.
"""

import logging
import shutil
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]
SKIPPED = ("export", "flow_cache", "demo_out")


def _git(*args) -> str:
    try:
        return subprocess.run(["git", "-C", str(REPO_ROOT), *args], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def git_commit() -> str:
    return _git("rev-parse", "HEAD")


def git_dirty() -> bool:
    return bool(_git("status", "--porcelain"))


def git_diff() -> str:
    return _git("diff")


def code_export(dst_dir):
    """Snapshot every repository ``.py`` file (+ the git state) into ``dst_dir``."""
    dst = Path(dst_dir)
    dst.mkdir(parents=True, exist_ok=True)
    for src in REPO_ROOT.rglob("*.py"):
        rel = src.relative_to(REPO_ROOT)
        if any(part.startswith(".") or part in SKIPPED for part in rel.parts):
            continue
        target = dst / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, target)
    dirty = git_dirty()
    (dst / "GIT_STATE").write_text(f"commit: {git_commit()}\ndirty: {dirty}\n")
    if dirty:
        (dst / "GIT_DIFF").write_text(git_diff())
    logger.debug("code exported to %s", dst)
