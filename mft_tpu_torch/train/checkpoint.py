"""Training checkpoints: the full train state, and weights for inference.

Port of ``mft_tpu/train/checkpoint.py`` with ``torch.save`` in place of
orbax: ``save_checkpoint`` writes the model's weights and batch statistics,
the optimizer state and the step into ``<dir>/step_XXXXXXXX/state.pt``;
``restore_checkpoint`` reads one into a train state; ``latest_checkpoint``
finds a run's newest; ``export_weights`` writes the flax msgpack variables
file that the port's ``RAFTFlow`` and the JAX package's ``load_variables``
both read.
"""

import logging
from pathlib import Path

import torch

from mft_tpu_torch.models.raft.convert import flax_from_params
from mft_tpu_torch.models.raft.flax_msgpack import write_variables

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(ckpt_dir, step, state):
    """state: {'model': RAFT, 'opt_state': dict, 'step': int}."""
    path = Path(ckpt_dir).resolve() / f"step_{int(step):08d}"
    path.mkdir(parents=True, exist_ok=True)
    payload = {"variables": state["model"].state_dict(),
               "opt_state": state["opt_state"], "step": int(state["step"])}
    torch.save(_to(payload, "cpu"), path / STATE_FILE)
    logger.info("saved checkpoint %s", path)
    return path


def latest_checkpoint(ckpt_dir):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(ckpt_dir.glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_path, state):
    """Load a checkpoint into ``state`` (its model's weights and statistics
    in place; the optimizer state on the model's device) and return it."""
    payload = torch.load(Path(ckpt_path) / STATE_FILE, map_location="cpu",
                         weights_only=True)
    model = state["model"]
    model.load_state_dict(payload["variables"])
    device = next(model.parameters()).device
    return {"model": model, "opt_state": _to(payload["opt_state"], device),
            "step": int(payload["step"])}


def export_weights(path, model):
    """Weights-only flax msgpack export (params + batch_stats)."""
    write_variables(path, flax_from_params(model.state_dict()))
    logger.info("exported inference weights to %s", path)
