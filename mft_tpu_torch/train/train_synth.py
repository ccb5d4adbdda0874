"""Train RAFT-OU from scratch on synthetic scene shards.

Port of ``tools/train_synth.py``, the trainer that made the committed
``weights/raftou_synth.msgpack``: one joint stage (flow L1 + occlusion CE +
heteroscedastic-Huber uncertainty) of the full recipe, ``RAFT(train_mode=
True)`` with batch statistics, bf16 compute over float32 parameters, on
scenes that :mod:`mft_tpu_torch.train.gen_synth_data` wrote to disk. The
host keeps the shards in RAM and applies cheap crop / flip / photometric
augmentation per batch (:class:`CachedSynthData`, the same numpy draws in the
same order as JAX's), a producer thread assembles the next batch while the
card runs the step (:class:`PrefetchBatches`).

Checkpoints: the full train state every ``--save_every`` steps
(``train/checkpoint.py``; ``--resume`` continues from the newest), each with
an atomic flax msgpack weights export that the inference configs read, and
the validation figures of a fixed held-out batch (:func:`run_val`). SIGTERM
and SIGINT save and exit; a non-finite loss stops the run so that it can be
resumed from the last checkpoint.

    python -m mft_tpu_torch.train.train_synth --steps 30000 --batch 8 \\
        --size 256 320 --out checkpoints/synth_run [--device cpu]
"""

import argparse
import json
import logging
import os
import queue
import signal
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from mft_tpu_torch.core.device import resolve_device
from mft_tpu_torch.models.raft.raft import RAFT, RAFTParams
from mft_tpu_torch.train import synth
from mft_tpu_torch.train.checkpoint import (export_weights, latest_checkpoint,
                                            restore_checkpoint, save_checkpoint)
from mft_tpu_torch.train.loop import build_state, make_train_step
from mft_tpu_torch.train.optim import make_optimizer

logger = logging.getLogger("train_synth")

OCCLUSION_MODULE = "separate_with_uncertainty"
LOSS_KWARGS = dict(freeze_optical_flow=False, occlusion_module=OCCLUSION_MODULE,
                   uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1")


# --------------------------------------------------------------------- #
# host-side data: cached shards + cheap augmentation
# --------------------------------------------------------------------- #
class CachedSynthData:
    """RAM-resident shard cache (``gen_synth_data`` output).

    Sampling: pick a scene, a delta t (1/sqrt(t)-weighted, the MFT chain's
    distribution), a random crop to the train size, a random h-flip and a
    per-image photometric jitter. A background thread rescans the shard
    directory, so a generator running beside it keeps enlarging the epoch.
    """

    def __init__(self, data_dir, crop_hw, batch_size, seed=7, rescan_every=120.0):
        self.dir = Path(data_dir)
        self.ch, self.cw = crop_hw
        self.B = batch_size
        self.rng = np.random.default_rng(seed)
        self.scenes = []
        self._seen = set()
        self._lock = threading.Lock()
        self._scan()
        if not self.scenes:
            raise FileNotFoundError(
                f"no shards in {self.dir}; run python -m mft_tpu_torch.train.gen_synth_data "
                "first")
        self._stop = threading.Event()
        self._rescan_every = rescan_every
        self._th = threading.Thread(target=self._rescan_loop, daemon=True)
        self._th.start()

    def _scan(self):
        new = 0
        for p in sorted(self.dir.glob("shard_*.npz")):
            if p.name in self._seen:
                continue
            try:
                with np.load(p) as z:
                    scene = {k: z[k] for k in ("img0", "imgs", "flows", "occls")}
            except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
                continue  # partially written / corrupt shard
            with self._lock:
                self.scenes.append(scene)
            self._seen.add(p.name)
            new += 1
        return new

    def _rescan_loop(self):
        while not self._stop.wait(self._rescan_every):
            n = self._scan()
            if n:
                logger.info("dataset rescan: +%d shards (total %d scenes)", n, len(self.scenes))

    def next_batch(self):
        """Compact-dtype batch: uint8 images, float16 flow, uint8 valid and
        occlusion (the step casts to float32 on the device)."""
        rng = self.rng
        with self._lock:
            n_scenes = len(self.scenes)
        img1 = np.empty((self.B, self.ch, self.cw, 3), np.uint8)
        img2 = np.empty((self.B, self.ch, self.cw, 3), np.uint8)
        flow = np.empty((self.B, self.ch, self.cw, 2), np.float16)
        occl = np.empty((self.B, self.ch, self.cw), np.uint8)
        for i in range(self.B):
            sc = self.scenes[int(rng.integers(n_scenes))]
            T1 = sc["imgs"].shape[0]
            w = 1.0 / np.sqrt(np.arange(1, T1 + 1))
            t = int(rng.choice(T1, p=w / w.sum()))
            H, W = sc["img0"].shape[:2]
            y0 = int(rng.integers(0, H - self.ch + 1))
            x0 = int(rng.integers(0, W - self.cw + 1))
            sl = np.s_[y0:y0 + self.ch, x0:x0 + self.cw]
            a = sc["img0"][sl].astype(np.float32)
            b = sc["imgs"][t][sl].astype(np.float32)
            f = sc["flows"][t][sl].astype(np.float32)
            o = sc["occls"][t][sl].astype(np.float32)
            if rng.random() < 0.5:  # h-flip
                a, b = a[:, ::-1], b[:, ::-1]
                f = f[:, ::-1] * np.array([-1.0, 1.0], np.float32)
                o = o[:, ::-1]
            # photometric: shared gain/bias + small per-channel gain
            gain = rng.uniform(0.7, 1.3)
            bias = rng.uniform(-25, 25)
            cgain = rng.uniform(0.92, 1.08, size=(3,)).astype(np.float32)
            for dst, src in ((img1, a), (img2, b)):
                dst[i] = np.clip(src * (gain * cgain) + bias, 0, 255).astype(np.uint8)
            flow[i] = f.astype(np.float16)
            occl[i] = (o > 0.5).astype(np.uint8)
        valid = np.ones((self.B, self.ch, self.cw), np.uint8)
        return img1, img2, flow, valid, occl

    def close(self):
        self._stop.set()


class PrefetchBatches:
    """A producer thread over ``stream.next_batch`` into a depth-2 queue,
    so that batch assembly overlaps the card's step."""

    def __init__(self, stream, depth=2):
        self.stream = stream
        self.q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err = None
        self._th = threading.Thread(target=self._produce, daemon=True)
        self._th.start()

    def _produce(self):
        while not self._stop.is_set():
            try:
                batch = self.stream.next_batch()
            except Exception as e:  # surfaced in the consumer, which must not hang
                self._err = e
                return
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next_batch(self):
        """The next batch; bounded waits, so a dead producer raises instead
        of blocking the trainer for ever."""
        while True:
            if self._err is not None:
                raise RuntimeError("batch producer died") from self._err
            try:
                return self.q.get(timeout=5.0)
            except queue.Empty:
                continue

    def close(self):
        self._stop.set()
        try:  # unblock a producer waiting on a full queue
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._th.join(timeout=10.0)
        self.stream.close()


def fixed_val_batch(H, W, n=8, seed=99):
    """Deterministic held-out batch (one pair a scene, varied deltas):
    float32 (img1, img2, flow, valid, occl)."""
    rng = np.random.default_rng(seed)
    items = [synth.sample_pair(rng, H, W) for _ in range(n)]
    return tuple(np.stack([i[k] for i in items]).astype(np.float32) for k in range(5))


def run_val(model, batch, iters):
    """EPE, occlusion accuracy and the sigma-EPE correlation of the
    train-mode model on ``batch`` (numpy, :func:`fixed_val_batch`). The
    forward normalises with the batch's statistics, as JAX's apply with
    ``mutable=["batch_stats"]`` does, and discards their update: the
    running statistics are left as they were."""
    vimg1, vimg2, vflow, vvalid, voccl = batch
    device = next(model.parameters()).device
    img1, img2 = (torch.from_numpy(np.ascontiguousarray(b)).to(device).permute(0, 3, 1, 2)
                  for b in (vimg1, vimg2))
    saved = {k: v.clone() for k, v in model.named_buffers()}
    try:
        with torch.no_grad():
            preds = model(img1, img2, iters=iters, test_mode=False)
            flow_p, occl_p, unc_p = (preds[k][-1].float().cpu().numpy()
                                     for k in ("flow", "occlusion", "uncertainty"))
    finally:
        with torch.no_grad():
            for k, v in model.named_buffers():
                v.copy_(saved[k])
    epe = np.sqrt(((flow_p - vflow) ** 2).sum(-1))
    m = vvalid > 0.5
    occ_pred = occl_p[..., 1] > occl_p[..., 0]
    occ_acc = float((occ_pred == (voccl > 0.5))[m].mean())
    sigma = np.exp(0.5 * unc_p[..., 0])
    nonocc = m & (voccl < 0.5)
    corr = float(np.corrcoef(sigma[nonocc], epe[nonocc])[0, 1])
    return dict(val_epe=float(epe[m].mean()), val_epe_nonocc=float(epe[nonocc].mean()),
                val_px1=float((epe[nonocc] < 1).mean()), val_px3=float((epe[nonocc] < 3).mean()),
                val_occ_acc=occ_acc, val_sigma_epe_corr=corr)


def export(path, model):
    """The flax msgpack weights export, written atomically."""
    path = Path(path)
    tmp = Path(str(path) + ".tmp")
    export_weights(tmp, model)
    os.replace(tmp, path)
    logger.info("exported weights to %s", path)


# --------------------------------------------------------------------- #
def train(args, on_step=None):
    """Run the trainer from parsed CLI ``args``; ``on_step(state, metrics)``
    is called after every step. returns {'state', 'steps', 'seconds',
    'data_wait', 'val'}: the train state, the steps this call took, the
    host seconds of its loop (the last loss on the host), the seconds it
    waited for batches and the last validation's figures."""
    device = resolve_device(args.device)
    H, W = args.size
    model = RAFT(RAFTParams(occlusion_module=OCCLUSION_MODULE, compute_dtype="float32"),
                 train_mode=True).to(device)
    model.cast_per_call(torch.bfloat16)
    tx, schedule = make_optimizer(lr=args.lr, num_steps=args.steps,
                                  weight_decay=args.wdecay, clip=1.0)
    state = build_state(model, tx)

    out_dir = Path(args.out)
    if args.resume:
        latest = latest_checkpoint(out_dir)
        if latest is not None:
            state = restore_checkpoint(latest, state)
            logger.info("resumed from %s (step %d)", latest, state["step"])

    step_fn = make_train_step(model, tx, dict(gamma=args.gamma, **LOSS_KWARGS),
                              iters=args.iters)
    vbatch = fixed_val_batch(H, W)

    def validate(tag):
        val = run_val(model, vbatch, args.iters)
        logger.info("%s @%d: %s", tag, state["step"],
                    json.dumps({k: round(v, 4) for k, v in val.items()}))
        return val

    def checkpoint():
        save_checkpoint(out_dir, state["step"], state)
        export(args.export, model)

    data = CachedSynthData(args.data, (H, W), args.batch)
    logger.info("dataset: %d scenes from %s", len(data.scenes), args.data)
    stream = PrefetchBatches(data)

    stop = threading.Event()

    def _signal(signum, frame):
        logger.info("signal %d: will checkpoint and exit", signum)
        stop.set()

    handlers = {s: signal.signal(s, _signal) for s in (signal.SIGTERM, signal.SIGINT)}

    def to_device(batch):
        return tuple(torch.from_numpy(b).to(device, non_blocking=True) for b in batch)

    start = state["step"]
    t_start = t_log = time.time()
    data_wait = wait_log = 0.0
    pend = []   # (loss, epe) on the device, fetched once a log window
    val = None
    try:
        nxt = to_device(stream.next_batch())
        while state["step"] < args.steps and not stop.is_set():
            cur = nxt
            t0 = time.time()
            batch_np = stream.next_batch()
            data_wait += time.time() - t0
            wait_log += time.time() - t0
            # the next batch's upload is queued before the step's launches
            nxt = to_device(batch_np)
            state, metrics = step_fn(state, tuple(b.float() for b in cur))
            if on_step is not None:
                on_step(state, metrics)
            step = state["step"]
            pend.append(torch.stack((metrics["train/loss"], metrics["train/epe"])))
            if step % args.log_every == 0:
                vals = torch.stack(pend).float().cpu().numpy()
                dt = time.time() - t_log
                logger.info("step %6d  loss %.4f  epe %.3f  lr %.2e  %.2f steps/s"
                            "  data-wait %.0f%%", step, vals[:, 0].mean(), vals[:, 1].mean(),
                            float(schedule(step)), len(pend) / dt, 100 * wait_log / dt)
                pend = []
                if not np.isfinite(vals[-1, 0]):
                    logger.error("non-finite loss at step %d: stopping so that the run can "
                                 "be resumed from the last checkpoint", step)
                    break
                t_log, wait_log = time.time(), 0.0
            if step % args.save_every == 0:
                checkpoint()
                val = validate("val")
        if pend:   # the loop's last losses on the host
            torch.stack(pend).cpu()
        seconds = time.time() - t_start
    finally:
        stream.close()
        for s, h in handlers.items():
            signal.signal(s, h)
    checkpoint()
    val = validate("final val")
    return dict(state=state, steps=state["step"] - start, seconds=seconds,
                data_wait=data_wait, val=val)


def get_parser():
    ap = argparse.ArgumentParser(description="train RAFT-OU on synthetic scene shards")
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=[256, 320])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--wdecay", type=float, default=1e-5)
    ap.add_argument("--gamma", type=float, default=0.85)
    ap.add_argument("--data", default="data_synth")
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--out", default="checkpoints/synth_run")
    ap.add_argument("--export", default="checkpoints/raftou_kubric_synth.msgpack")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    return train(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
