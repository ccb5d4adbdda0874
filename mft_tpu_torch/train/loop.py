"""RAFT-OU training: the train step, the state and the loop, with the CLI.

Port of ``mft_tpu/train/loop.py`` (reference MFT/RAFT/train.py:369-477 and
its CLI, ``fromfile_prefix_chars='@'``, ``train_params.txt``): AdamW +
OneCycle, gradient clip 1.0, gamma-weighted sequence losses, freezing (flow
and features frozen: only ``occlusion_block`` trains), checkpoints and
inference exports every VAL_FREQ steps and at the end, validation there,
scalars every SUM_FREQ steps.

    python -m mft_tpu_torch.train.loop @train_params.txt [--device cpu]

The recipes:
- official (``--freeze_optical_flow_training --freeze_features_training``):
  the model in test-time mode (batch norm on its running statistics), only
  the occlusion block's parameters require a gradient;
- full (no freeze flags): ``RAFT(train_mode=True)``, batch statistics, and
  gradients into both encoders through the lookup's backward kernel.
``--mixed_precision`` runs the convs in bf16 over float32 parameters and
optimizer state (:meth:`RAFT.cast_per_call`); no loss scaling, bf16 having
float32's exponent range.

The train state is {'model': RAFT, 'opt_state': dict, 'step': int}; the
model holds the parameters and the batch statistics, which a train-mode
forward updates in place (JAX's mutable 'batch_stats').
"""

import argparse
import logging
import time
from pathlib import Path

import torch

from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.models.raft.layers import BatchNorm
from mft_tpu_torch.models.raft.raft import RAFT, RAFTParams
from mft_tpu_torch.train.losses import (FLOW_RATIOS, MAX_FLOW, flow_metric_sums,
                                        sequence_loss)
from mft_tpu_torch.train.optim import apply_updates, make_optimizer
from mft_tpu_torch.utils.various import debug_entry

logger = logging.getLogger(__name__)

SUM_FREQ = 10
VAL_FREQ = 5000


def make_train_step(model, tx, loss_kwargs, iters=12, plain=False, mesh=None):
    """The train step: (state, batch) -> (state, metrics).

    batch = (img1, img2, flow, valid, occl): channel-last tensors on the
    model's device, images RGB in [0, 255]. The loss's gradient reaches the
    parameters that require one; ``tx`` updates its trainable ones in place.
    ``plain`` runs the kernels' plain versions (forward and backward).

    ``mesh``: a ``DeviceMesh`` with a ``"data"`` axis
    (:func:`mft_tpu_torch.parallel.make_mesh`), one process a rank. The step
    then takes the global batch, hands each rank its slice
    (:func:`mft_tpu_torch.parallel.shard_batch_fn`, which also broadcasts
    the state from the first rank on the first call), and averages every
    trainable gradient and the loss metrics over the axis between
    ``loss.backward()`` and the update, where XLA inserts the same sums in
    JAX. The losses are means over whole tensors, so the mean of the ranks'
    equal slices' losses is the global batch's. The flow metrics
    (``losses.FLOW_RATIOS``) are ratios over the valid pixels, whose count
    differs between slices: their sums and the count are summed over the
    axis and divided once, JAX's ``vmean`` over the global batch. A model
    that normalises with batch statistics (``train_mode=True``) takes them
    over the global batch, as JAX's sharded step does: for the step's
    forward each such ``BatchNorm`` gets the mesh (``BatchNorm.mesh``) and
    averages its slice's E[x] and E[x^2] over the axis, one differentiable
    all-reduce a layer and direction; validation and tracking, outside the
    step, never reach a collective. With one rank the step is bit for bit
    the step without a mesh.
    """
    if mesh is not None:
        from mft_tpu_torch.parallel.mesh import all_reduce_mean, all_reduce_sum, shard_batch_fn

    def step(state, batch):
        m = state["model"]
        img1, img2, flow_gt, valid, occl_gt = batch
        params = dict(m.named_parameters())
        for p in params.values():
            p.grad = None
        norms = [] if mesh is None else [b for b in m.modules()
                                         if isinstance(b, BatchNorm) and b.use_batch_stats]
        for b in norms:
            b.mesh = mesh
        try:
            preds = m(img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2), iters=iters,
                      test_mode=False, plain=plain)
        finally:
            for b in norms:
                b.mesh = None
        loss, metrics = sequence_loss(preds, flow_gt, valid, occl_gt=occl_gt, **loss_kwargs)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items() if tx.trains(n) and p.requires_grad}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["train/loss"] = loss.detach()
        if mesh is not None:
            all_reduce_mean(grads.values(), mesh)
            means = [k for k in metrics if k not in FLOW_RATIOS]
            stacked = torch.stack([metrics[k].float() for k in means])
            sums, count = flow_metric_sums(preds["flow"][-1].detach(), flow_gt, valid,
                                           loss_kwargs.get("max_flow", MAX_FLOW))
            all_reduce_mean([stacked], mesh)
            all_reduce_sum([sums, count], mesh)
            metrics.update(zip(means, stacked.unbind()))
            metrics.update(zip(FLOW_RATIOS, (sums / count.clamp(min=1)).unbind()))
        updates, opt_state = tx.update(grads, state["opt_state"], params)
        apply_updates(params, updates)
        return {"model": m, "opt_state": opt_state, "step": state["step"] + 1}, metrics

    if mesh is not None:
        step = shard_batch_fn(step, mesh)
    return step


def build_state(model, tx, restore=None, seed=1234):
    """A fresh train state: random weights from ``seed`` (the JAX init's
    distributions), then the weights file ``restore`` (.msgpack/.bin flax
    variables or the port's .pt/.pth) if given."""
    from mft_tpu_torch.models.raft.wrapper import load_weights, random_init
    device = next(model.parameters()).device
    random_init(model, seed)
    if restore:
        model.load_state_dict(load_weights(Path(restore)))
    model.to(device)
    return {"model": model, "opt_state": tx.init(dict(model.named_parameters())), "step": 0}


def freeze(model, mask):
    """requires_grad of every parameter from the trainable mask (None: all)."""
    for n, p in model.named_parameters():
        p.requires_grad_(mask is None or mask[n])


def _flat(results, prefix):
    out = {}
    for k, v in results.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _panels(tlog, model, batch, iters):
    """The VAL_FREQ prediction panels of the batch's first sample; the batch
    statistics the forward computes are discarded (JAX collects and drops
    the mutation)."""
    saved = {k: v.clone() for k, v in model.named_buffers()}
    try:
        with torch.no_grad():
            preds = model(batch[0][:1].permute(0, 3, 1, 2), batch[1][:1].permute(0, 3, 1, 2),
                          iters=iters, test_mode=False)
        tlog.write_prediction_panels(tuple(b[:1] for b in batch), preds)
    finally:
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])


def train(args, on_step=None):
    """Run a training job from parsed CLI ``args``; ``on_step(state,
    metrics, seconds)`` is called after every step (``seconds``: the step's
    host time, ending when its loss reached the host). returns the state."""
    device = resolve_device(getattr(args, "device", "cuda"))
    cfg = RAFTParams(small=args.small, occlusion_module=args.occlusion_module,
                     compute_dtype="float32")
    model = RAFT(cfg, train_mode=not args.freeze_features_training).to(device)
    if args.mixed_precision:
        model.cast_per_call(torch.bfloat16)

    trainable = None
    if args.freeze_optical_flow_training and args.freeze_features_training:
        trainable = ("occlusion_block",)   # the official recipe
    # --restore_ckpt: a weights file restores the weights only; a checkpoint
    # directory (or a run's root: its newest step_*) the full train state
    restore_dir, restore_weights = None, args.restore_ckpt
    if args.restore_ckpt and Path(args.restore_ckpt).is_dir():
        restore_dir, restore_weights = Path(args.restore_ckpt), None
        if not restore_dir.name.startswith("step_"):
            from mft_tpu_torch.train.checkpoint import latest_checkpoint
            latest = latest_checkpoint(restore_dir)
            if latest is None:
                raise FileNotFoundError(f"no step_* checkpoints under {restore_dir}")
            restore_dir = latest

    params = dict(model.named_parameters())
    tx, schedule = make_optimizer(lr=args.lr, num_steps=args.num_steps,
                                  weight_decay=args.wdecay, epsilon=args.epsilon,
                                  clip=args.clip, params=params, trainable_prefixes=trainable)
    freeze(model, tx.mask)
    state = build_state(model, tx, restore=restore_weights)
    if restore_dir is not None:
        from mft_tpu_torch.train.checkpoint import restore_checkpoint
        state = restore_checkpoint(restore_dir, state)
        logger.info("resumed the train state from %s (step %d)", restore_dir, state["step"])

    loss_kwargs = dict(gamma=args.gamma, freeze_optical_flow=args.freeze_optical_flow_training,
                       occlusion_module=args.occlusion_module,
                       uncertainty_loss_type=args.uncertainty_loss,
                       optical_flow_loss_type=args.optical_flow_loss,
                       weighting_unc_loss=args.weighting_unc_loss)
    step_fn = make_train_step(model, tx, loss_kwargs, iters=args.iters)

    from mft_tpu_torch.train.datasets import BatchLoader, fetch_dataset
    dataset = fetch_dataset(args.stage, args.image_size,
                            dashcam_augmentation=args.dashcam_augmenentation,
                            device=device)
    loader = BatchLoader(dataset, args.batch_size, num_workers=args.num_workers)

    from mft_tpu_torch.train.checkpoint import export_weights, save_checkpoint
    from mft_tpu_torch.train.logger import TrainLogger
    ckpt_dir = Path(args.checkpoint_dir) / args.name
    tlog = TrainLogger(ckpt_dir / "runs")
    tlog.total_steps = state["step"]
    model.train()
    for batch in loader:
        batch = tuple(torch.from_numpy(b).to(device) for b in batch)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        step = state["step"]
        tlog.push(metrics, lr=schedule(step))   # waits for the step's loss
        if on_step is not None:
            on_step(state, metrics, time.perf_counter() - t0)
        if step % VAL_FREQ == 0 or step >= args.num_steps:
            save_checkpoint(ckpt_dir, step, state)
            export_weights(ckpt_dir / f"{args.name}_step{step}.msgpack", model)
            try:
                _panels(tlog, model, batch, args.iters)
            except Exception:
                logger.exception("panel rendering failed")
            if args.validation:
                from mft_tpu_torch.train.validate import run_validation
                for val_name in args.validation:
                    try:
                        res = run_validation(val_name, model, iters=args.iters)
                        logger.info("validation %s @%d: %s", val_name, step, res)
                        tlog.write_dict(_flat(res, f"val/{val_name}/"))
                    except Exception:
                        logger.exception("validation %s failed", val_name)
        if step >= args.num_steps:
            break
    tlog.close()
    return state


def get_parser():
    parser = argparse.ArgumentParser(fromfile_prefix_chars="@")
    parser.add_argument("--name", default="raftou")
    parser.add_argument("--stage", default="sintel_things_kubric_train_subsplit")
    parser.add_argument("--validation", nargs="*", default=[])
    parser.add_argument("--occlusion_module", default="separate_with_uncertainty")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--freeze_optical_flow_training", action="store_true")
    parser.add_argument("--freeze_features_training", action="store_true")
    parser.add_argument("--uncertainty_loss", default="huber_non_occluded")
    parser.add_argument("--optical_flow_loss", default="L1")
    parser.add_argument("--weighting_unc_loss", action="store_true")
    # jpeg-corruption augmentation at p=0.5 (the reference's flag spelling)
    parser.add_argument("--dashcam_augmenentation", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bf16 compute (f32 params; no loss scaling)")
    parser.add_argument("--restore_ckpt", default=None)
    parser.add_argument("--num_steps", type=int, default=50000)
    parser.add_argument("--batch_size", type=int, default=6)
    parser.add_argument("--lr", type=float, default=1.25e-4)
    parser.add_argument("--image_size", type=int, nargs=2, default=[368, 768])
    parser.add_argument("--wdecay", type=float, default=1e-5)
    parser.add_argument("--epsilon", type=float, default=1e-8)
    parser.add_argument("--clip", type=float, default=1.0)
    parser.add_argument("--gamma", type=float, default=0.85)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--checkpoint_dir", default="checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return parser


def _main(argv=None):
    logging.basicConfig(level=logging.INFO)
    train(get_parser().parse_args(argv))


def main(argv=None):
    """The CLI; with ``MFT_TPU_DEBUG`` set, an exception opens pdb post mortem."""
    debug_entry(_main)(argv)


if __name__ == "__main__":
    main()
