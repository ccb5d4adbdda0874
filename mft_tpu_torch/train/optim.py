"""Optimizer, learning-rate schedule and parameter freezing of RAFT-OU training.

Port of ``mft_tpu/train/optim.py`` (reference MFT/RAFT/train.py:252-259,
348-364), with optax's semantics written out in PyTorch:

- ``optax.chain(clip_by_global_norm(clip), adamw(schedule, weight_decay,
  eps))``: the gradients' global norm clipped to ``clip``, Adam's moments
  (b1 0.9, b2 0.999) with bias correction, the decayed weights added to
  Adam's direction, both scaled by -schedule(count), where count is the
  number of updates made before (the first update takes schedule(0));
- the schedule is torch's OneCycleLR(anneal_strategy='linear', pct_start
  0.05, div_factor 25, final_div_factor 1e4) over ``num_steps + 100`` steps;
- freezing by parameter path: with ``trainable_prefixes`` the chain sees the
  trainable parameters alone (``optax.masked``), so the clip's global norm is
  theirs, and a frozen parameter gets a zero update and no weight decay. The
  official recipe trains the paths under 'occlusion_block'.

A parameter's path is its flax path ('occlusion_block/occl_head/conv1/kernel',
:func:`mft_tpu_torch.models.raft.convert.flax_path`). Parameters, gradients
and updates are dicts {state-dict name: tensor}; the optimizer state is a
dict of tensors that ``torch.save`` keeps.
"""

from typing import Sequence

import numpy as np
import torch

from mft_tpu_torch.models.raft.convert import flax_path

B1, B2 = 0.9, 0.999


def onecycle_linear(max_lr, total_steps, pct_start=0.05, div_factor=25.0,
                    final_div_factor=1e4):
    """torch OneCycleLR(anneal_strategy='linear') as a function of the step,
    computed in float32 as the JAX schedule is."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_end = max(float(pct_start * total_steps) - 1.0, 1.0)
    down_end = float(total_steps - 1)
    f32 = np.float32

    def schedule(step):
        s = f32(step)
        up = f32(initial) + f32(max_lr - initial) * min(s / f32(up_end), f32(1.0))
        frac = np.clip((s - f32(up_end)) / f32(max(down_end - up_end, 1.0)), f32(0.0),
                       f32(1.0))
        down = f32(max_lr) + f32(final - max_lr) * frac
        return float(up if s <= f32(up_end) else down)

    return schedule


def trainable_mask(params, trainable_prefixes: Sequence[str]) -> dict:
    """{name: True where the parameter's flax path starts with a prefix}
    (reference weight_freezer, train.py:348-364)."""
    return {name: any(flax_path(name).startswith(p) for p in trainable_prefixes)
            for name in params}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32 (optax global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class AdamW:
    """``optax`` AdamW behind a global-norm clip, with optional freezing: the
    functional form (``init``, ``update``) of the JAX package's ``tx``."""

    def __init__(self, schedule, weight_decay=1e-5, eps=1e-8, clip=1.0, mask=None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.eps = eps
        self.clip = clip
        self.mask = mask   # None: every parameter trains

    def trains(self, name) -> bool:
        return self.mask is None or self.mask[name]

    def init(self, params) -> dict:
        names = [n for n in params if self.trains(n)]
        return {"count": 0,
                "mu": {n: torch.zeros_like(params[n]) for n in names},
                "nu": {n: torch.zeros_like(params[n]) for n in names}}

    def update(self, grads, state, params):
        """(updates, new state): the updates of the trainable parameters
        (frozen ones have none: their update is zero)."""
        names = [n for n in grads if self.trains(n)]
        g_norm = global_norm([grads[n] for n in names])
        clip = self.clip
        # optax: select(g_norm < clip, g, (g / g_norm) * clip), on the card
        # without a host round trip
        clipped = {n: torch.where(g_norm < clip, grads[n], (grads[n] / g_norm) * clip)
                   for n in names}
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        c1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** count
        c2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** count
        mu, nu, updates = {}, {}, {}
        for n in names:
            g = clipped[n]
            mu[n] = (1 - B1) * g + B1 * state["mu"][n]
            nu[n] = (1 - B2) * (g * g) + B2 * state["nu"][n]
            u = (mu[n] / c1.to(g.device)) / (torch.sqrt(nu[n] / c2.to(g.device)) + self.eps)
            u = u + self.weight_decay * params[n]
            updates[n] = -lr * u
        return updates, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(lr=1.25e-4, num_steps=50_000, weight_decay=1e-5, epsilon=1e-8, clip=1.0,
                   params=None, trainable_prefixes=None):
    """AdamW + OneCycle + clip, with optional freezing. returns (tx, schedule)."""
    schedule = onecycle_linear(lr, num_steps + 100)
    mask = None
    if trainable_prefixes is not None:
        if params is None:
            raise ValueError("params are needed to build the freeze mask")
        mask = trainable_mask(params, trainable_prefixes)
    return AdamW(schedule, weight_decay, epsilon, clip, mask), schedule


def apply_updates(params, updates):
    """params[n] += updates[n] in place, for the parameters that have one."""
    with torch.no_grad():
        for n, u in updates.items():
            params[n].add_(u.to(params[n].dtype))
