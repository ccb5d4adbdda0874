#!/usr/bin/env python3
"""Where one tracked frame of the PyTorch/CUDA port spends its device time.

Drives ``MFT(default_config())`` of ``mft_tpu_torch`` on one NVIDIA card at
512x512 (random weights from seed 0, the synthetic clip of chip_smoke.py),
or another tracker ``--config`` of ``mft_tpu_torch.config`` (``synth``,
``fast``, ``warm``; with ``--weights synth`` any of them on the committed
weights), with another ``--corr-method``, ``--conv-backend`` and frame
``--size``, warms up, then traces
``--frames`` frames with ``torch.profiler`` and prints (with ``--cache-pass``
the traced frames are served by a FlowCache that a first pass over the same
frames filled: 'injected', every finite pair a hit and the template pair
alone through RAFT; 'raft-free', ``cache_delta_infinity`` and no RAFT):

- wall ms per frame (host clock, synchronised) and device-busy ms per frame
  (the sum of kernel times; one stream), hence the device's idle share;
- device ms per frame by kernel group: the port's kernels by name,
  convolutions, matrix products, element-wise, reductions, copies, the rest;
- the kernels with the most device time, and the peak device memory.

With ``--train official|full`` it traces ``--frames`` training steps of that
recipe instead (``mft_tpu_torch.train.loop.make_train_step`` on the
committed weights, batch 6 at 368x768 from ``train/synth.py``, 12
iterations, bf16 compute over float32 parameters), the same breakdown per
step, and times apart the addition of two of the volume's level-gradient
sets, which autograd runs 11 times a full-recipe step (the 12 iterations'
dense gradients summed into the levels' gradients).

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_profile_frame.py [--frames 3] [--out frame_profile.txt]
        [--config default|synth|fast|warm] [--weights config|synth]
        [--corr-method auto|alt|win|int8|packed|packed_i8|pallas_t|fold|mixed]
        [--conv-backend auto|pallas] [--size 2160 3840]
        [--cache-pass none|injected|raft-free] [--train none|official|full]
"""

import argparse
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

GROUPS = (  # first match wins
    ("corr_lookup_bwd", re.compile(r"corr_lookup_bwd_kernel")),
    # corr_lookup.cu: bf16 on the tensor cores (_tc), f32 on the CUDA cores
    ("corr_lookup_fused", re.compile(r"lookup_conv(_tc)?_kernel")),
    # corr_gather.cu: corr_lookup_q and corr_lookup_packed_i8 (int8 taps),
    # then corr_lookup, corr_lookup_mixed, corr_lookup_packed and
    # corr_lookup_folded
    ("corr_lookup_q, corr_lookup_packed_i8",
     re.compile(r"corr_gather_kernel(<\d+, signed char|ILi\dEa)")),
    ("corr_lookup, corr_lookup_mixed, corr_lookup_packed, corr_lookup_folded",
     re.compile(r"corr_gather_kernel")),
    ("chain_select", re.compile(r"chain_select_kernel")),
    # corr_alt.cu: bf16 'alt' and 'win' both run window_tc_kernel (tensor
    # cores); f32 'alt' alt_kernel, f32 'win' win_kernel
    ("corr_lookup_alt/win (bf16)", re.compile(r"window_tc_kernel")),
    ("corr_lookup_alt", re.compile(r"alt_kernel")),
    ("corr_lookup_win", re.compile(r"win_kernel")),
    # corr_volume.cu: corr_lookup_t (lane_group_kernel); lane_major_kernel
    # and pixel_major_kernel (the folded, packed and int8 lookups before they
    # moved onto the gather) in older checkouts, for profiling those
    ("volume-form lookup",
     re.compile(r"pixel_major_kernel|lane_group_kernel|lane_major_kernel")),
    # product.cu (float32) and product_tc.cu (bfloat16, tensor cores)
    ("corr_build_folded", re.compile(r"build_folded(_tc)?_kernel")),
    ("conv_pallas", re.compile(r"conv(_tc)?_kernel")),
    ("convolution", re.compile(r"conv|fprop|implicit|winograd|cudnn", re.I)),
    ("matrix product", re.compile(r"gemm|cutlass|xmma|cublas", re.I)),
    ("reduction", re.compile(r"reduce|softmax|norm", re.I)),
    ("copy / layout", re.compile(r"copy|cat|transpose|permute|index|gather|pad", re.I)),
    ("element-wise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def group_of(name: str) -> str:
    for group, pat in GROUPS:
        if pat.search(name):
            return group
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--out", default=None, help="write the full kernel table here")
    parser.add_argument("--corr-method", default="auto",
                        choices=("auto", "alt", "win", "int8", "packed", "packed_i8",
                                 "pallas_t", "fold", "mixed"))
    parser.add_argument("--conv-backend", default="auto", choices=("auto", "pallas"))
    parser.add_argument("--config", default="default",
                        choices=("default", "synth", "fast", "warm"),
                        help="the tracker config: mft_tpu_torch.config.<name>_config()")
    parser.add_argument("--weights", default="config", choices=("config", "synth"),
                        help="synth: the committed weights (synth_flow_config()) whatever "
                             "the config")
    parser.add_argument("--size", type=int, nargs=2, default=(512, 512),
                        metavar=("H", "W"))
    parser.add_argument("--cache-pass", default="none",
                        choices=("none", "injected", "raft-free"),
                        help="trace frames a filled FlowCache serves (the runner's "
                             "strided passes)")
    parser.add_argument("--train", default="none", choices=("none", "official", "full"),
                        help="trace training steps of this recipe instead of frames")
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from chip_smoke import synthetic_clip
    from mft_tpu_torch import config
    from mft_tpu_torch.tracker import MFT

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.train != "none":
        return profile_train(args, card)
    n = args.warmup + args.frames
    H, W = args.size
    frames = synthetic_clip(n, H=H, W=W)
    cfg = getattr(config, f"{args.config}_config")()
    if args.weights == "synth":
        cfg.flow_config = config.synth_flow_config()
    cfg.flow_config.raft_params["corr_method"] = args.corr_method
    cfg.flow_config.raft_params["conv_backend"] = args.conv_backend
    tracker = MFT(cfg, device="cuda")
    cache = None
    if args.cache_pass != "none":
        from mft_tpu_torch.io import FlowCache
        cache = FlowCache(None)
        cfg.cache_delta_infinity = args.cache_pass == "raft-free"
        tracker.init(frames[0], flow_cache=cache)   # the cold pass writes every pair
        for k in range(1, n + 1):
            tracker.track(frames[k])
    tracker.init(frames[0], flow_cache=cache)
    for k in range(1, args.warmup + 1):
        tracker.track(frames[k])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(args.warmup + 1, n + 1):
            tracker.track(frames[k])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    print(f"card: {card}")
    print(f"frames traced: {args.frames} after {args.warmup} warm-up, {H}x{W}, "
          f"config {args.config}, weights {cfg.flow_config.model} "
          f"({'loaded' if os.path.exists(str(cfg.flow_config.model)) else 'random'}), "
          f"corr_method {args.corr_method}, conv_backend {args.conv_backend}, "
          f"{len(tracker.deltas)} deltas, {tracker.flower.iters} iterations, "
          f"schedule {tracker.iters_schedule}, warm start {tracker._warm_start()}, "
          f"{tracker.flower.dtype}, cache pass {args.cache_pass}")
    return report(prof, args, card, wall_ms, "frame")


def profile_train(args, card) -> int:
    """Trace ``args.frames`` training steps of the ``args.train`` recipe."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mft_tpu_torch.config import SYNTH_WEIGHTS
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.models.raft.raft import RAFTParams
    from mft_tpu_torch.models.raft.wrapper import load_weights
    from mft_tpu_torch.train import synth
    from mft_tpu_torch.train.loop import freeze, make_train_step
    from mft_tpu_torch.train.optim import make_optimizer
    from pathlib import Path
    official = args.train == "official"
    B, H, W, iters = 6, 368, 768, 12
    dev = torch.device("cuda")
    model = RAFT(RAFTParams(), train_mode=not official)
    model.load_state_dict(load_weights(Path(SYNTH_WEIGHTS)))
    model.to(dev).cast_per_call(torch.bfloat16)
    tx, _ = make_optimizer(params=dict(model.named_parameters()),
                           trainable_prefixes=("occlusion_block",) if official else None)
    freeze(model, tx.mask)
    state = {"model": model, "opt_state": tx.init(dict(model.named_parameters())), "step": 0}
    lk = dict(gamma=0.85, freeze_optical_flow=official,
              uncertainty_loss_type="huber_non_occluded")
    step = make_train_step(model, tx, lk, iters=iters)
    batch = tuple(torch.from_numpy(b).to(dev) for b in
                  synth.make_batch(np.random.default_rng(0), B, H, W))
    for _ in range(args.warmup):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            state, metrics = step(state, batch)
        float(metrics["train/loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    # one addition of two sets of level gradients, as autograd sums the
    # iterations' volume gradients (bf16, the levels' shapes)
    H8, W8 = H // 8, W // 8
    grads = [torch.randn((B, H8 * W8, H8 >> l, W8 >> l), device=dev).to(torch.bfloat16)
             for l in range(4)]
    nbytes = sum(g.numel() for g in grads) * 2
    add = lambda: [g + g for g in grads]
    for _ in range(3):
        add()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        add()
    end.record()
    torch.cuda.synchronize()
    add_ms = start.elapsed_time(end) / 10
    print(f"card: {card}")
    print(f"training steps traced: {args.frames} after {args.warmup} warm-up, recipe "
          f"{args.train}, batch {B} at {H}x{W}, {iters} iterations, bf16 compute over f32 "
          f"parameters, weights {SYNTH_WEIGHTS.name}")
    print(f"one addition of two level-gradient sets ({nbytes / 1e9:.3f} GB each, bf16): "
          f"{add_ms:.3f} ms (CUDA events); a full-recipe step sums 12 of them (11 additions)")
    return report(prof, args, card, wall_ms, "step")


def report(prof, args, card, wall_ms, unit) -> int:
    """Print the traced window's breakdown per ``unit`` (frame or step)."""
    import torch
    from torch.autograd import DeviceType
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only: an op's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        kernels[evt.key] = (evt.self_device_time_total / 1e3 / args.frames,
                            evt.count / args.frames)
    busy = sum(ms for ms, _ in kernels.values())
    if busy <= 0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"wall ms per {unit} (profiler on): {wall_ms:.3f}")
    print(f"device-busy ms per {unit}: {busy:.3f} (idle share {1 - busy / wall_ms:.1%})")
    print(f"launches per {unit}: {sum(cnt for _, cnt in kernels.values()):.1f}")
    groups = {}
    for name, (ms, cnt) in kernels.items():
        g = groups.setdefault(group_of(name), [0.0, 0.0])
        g[0] += ms
        g[1] += cnt
    print(f"device ms per {unit} by group:")
    for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:18s} {ms:8.3f} ms  {ms / busy:6.1%}  {cnt:7.1f} launches")
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    print(f"top kernels (ms per {unit}, launches per {unit}):")
    for name, (ms, cnt) in rows[:15]:
        print(f"  {ms:8.3f} {cnt:6.1f}  {group_of(name):16s} {name[:110]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(f"card: {card}\n")
            for name, (ms, cnt) in rows:
                f.write(f"{ms:.4f}\t{cnt:.1f}\t{group_of(name)}\t{name}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
