#!/usr/bin/env python3
"""Where one tracked frame of the PyTorch/CUDA port spends its device time.

Drives ``MFT(default_config())`` of ``mft_tpu_torch`` on one NVIDIA card at
512x512 (random weights from seed 0, the synthetic clip of chip_smoke.py),
or another tracker ``--config`` of ``mft_tpu_torch.config`` (``synth``,
``fast``, ``warm``; with ``--weights synth`` any of them on the committed
weights), with another ``--corr-method``, ``--conv-backend`` and frame
``--size``, warms up, then traces
``--frames`` frames with ``torch.profiler`` and prints:

- wall ms per frame (host clock, synchronised) and device-busy ms per frame
  (the sum of kernel times; one stream), hence the device's idle share;
- device ms per frame by kernel group: the port's kernels by name,
  convolutions, matrix products, element-wise, reductions, copies, the rest;
- the kernels with the most device time, and the peak device memory.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_profile_frame.py [--frames 3] [--out frame_profile.txt]
        [--config default|synth|fast|warm] [--weights config|synth]
        [--corr-method auto|alt|win|int8|packed|packed_i8|pallas_t|fold|mixed]
        [--conv-backend auto|pallas] [--size 2160 3840]
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
    n = args.warmup + args.frames
    H, W = args.size
    frames = synthetic_clip(n, H=H, W=W)
    cfg = getattr(config, f"{args.config}_config")()
    if args.weights == "synth":
        cfg.flow_config = config.synth_flow_config()
    cfg.flow_config.raft_params["corr_method"] = args.corr_method
    cfg.flow_config.raft_params["conv_backend"] = args.conv_backend
    tracker = MFT(cfg, device="cuda")
    tracker.init(frames[0])
    for k in range(1, args.warmup + 1):
        tracker.track(frames[k])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(args.warmup + 1, n + 1):
            tracker.track(frames[k])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames

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
    print(f"card: {card}")
    print(f"frames traced: {args.frames} after {args.warmup} warm-up, {H}x{W}, "
          f"config {args.config}, weights {cfg.flow_config.model} "
          f"({'loaded' if os.path.exists(str(cfg.flow_config.model)) else 'random'}), "
          f"corr_method {args.corr_method}, conv_backend {args.conv_backend}, "
          f"{len(tracker.deltas)} deltas, {tracker.flower.iters} iterations, "
          f"schedule {tracker.iters_schedule}, warm start {tracker._warm_start()}, "
          f"{tracker.flower.dtype}")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"wall ms per frame (profiler on): {wall_ms:.3f}")
    print(f"device-busy ms per frame: {busy:.3f} (idle share {1 - busy / wall_ms:.1%})")
    groups = {}
    for name, (ms, cnt) in kernels.items():
        g = groups.setdefault(group_of(name), [0.0, 0.0])
        g[0] += ms
        g[1] += cnt
    print("device ms per frame by group:")
    for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:18s} {ms:8.3f} ms  {ms / busy:6.1%}  {cnt:7.1f} launches")
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    print("top kernels (ms per frame, launches per frame):")
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
