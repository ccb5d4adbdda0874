#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check its kernels.

Run from any directory, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero and prints no
result line):
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``mft_tpu_torch/ops/csrc`` (one bare nvcc);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes, in bf16 and f32, and time kernel and plain version (CUDA events);
4. the main path: ``MFT(default_config())`` with random weights from a seed,
   ``init`` + ``track`` of synthetic 512x512 frames (a texture under a known
   shift); checks shapes, finiteness, ranges and that the kernels launched
   11, 1 and 1 times per tracked frame;
5. one more frame with the plain versions forced, compared with the kernels'.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Needs no network and imports nothing
of JAX or of the JAX package.
"""

import faulthandler
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = 10          # tracked frames on the main path
WARMUP = 2           # frames left out of the per-frame median
SHIFT = (2, 1)       # (dx, dy) px per frame of the synthetic clip
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


class CheckFailed(Exception):
    pass


def log(*parts):
    print(*parts, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def within(got, want, atol, rtol) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))   # 512x512 at stride 8
B, P, RADIUS, F = 7, 64 * 64, 4, 256               # 7 delta pairs


def window_tap_bytes(pyramid, coords) -> int:
    """Bytes of the pyramid the windows of these coords touch (in-bounds taps
    of each pixel's (2r+2)^2 neighbourhood per level; each read once)."""
    import torch
    n = 0
    for lvl, corr in enumerate(pyramid):
        h, w = corr.shape[2:]
        c = coords / 2.0 ** lvl
        lo = torch.floor(c) - RADIUS
        x_lo, y_lo = lo[..., 0].clamp(min=0), lo[..., 1].clamp(min=0)
        x_hi = (lo[..., 0] + 2 * RADIUS + 1).clamp(max=w - 1)
        y_hi = (lo[..., 1] + 2 * RADIUS + 1).clamp(max=h - 1)
        nx = (x_hi - x_lo + 1).clamp(min=0)
        ny = (y_hi - y_lo + 1).clamp(min=0)
        n += int((nx * ny).sum().item())
    return n * pyramid[0].element_size()


def check_lookups(torch, ops, dev, card):
    gen = torch.Generator(device=dev).manual_seed(1)
    coords = torch.empty((B, P, 2), device=dev)
    coords.uniform_(-10.0, 74.0, generator=gen)   # some windows leave the map
    wc32 = torch.randn((len(LEVELS) * (2 * RADIUS + 1) ** 2, F), device=dev,
                       generator=gen) / 18.0
    bias = 0.1 * torch.randn((F,), device=dev, generator=gen)
    # stated tolerances |kernel - plain| <= atol + rtol*|plain|: the samples
    # are the same float ops in the same order (bit-identical expected); the
    # fused product sums 324 terms in another order than the f32 matmul, and
    # in bf16 that can move the output's rounding by one ulp (2^-8 relative)
    tol = {("lookup", "float32"): (1e-6, 1e-6), ("lookup", "bfloat16"): (1e-6, 1e-6),
           ("fused", "float32"): (1e-4, 1e-4), ("fused", "bfloat16"): (1e-2, 8e-3)}
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(dtype)
               for h, w in LEVELS]
        wc = wc32.to(dtype)
        runs = {
            "lookup": (lambda: ops.corr_lookup(pyr, coords, RADIUS),
                       lambda: ops.corr_lookup_ref(pyr, coords, RADIUS)),
            "fused": (lambda: ops.corr_lookup_fused(pyr, coords, wc, bias, RADIUS),
                      lambda: ops.corr_lookup_fused_ref(pyr, coords, wc, bias, RADIUS)),
        }
        for kind, (kernel, plain) in runs.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = max_err(got, want)
            atol, rtol = tol[(kind, name)]
            ok = within(got, want, atol, rtol)
            log(f"check {kind} {name}: max_abs_err {err:.3e} "
                f"(tolerance atol {atol} + rtol {rtol}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{kind} {name} disagrees with its plain version")
            ms = cuda_ms(kernel, reps=20)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            tap = window_tap_bytes(pyr, coords)
            out_bytes = got.numel() * got.element_size()
            nbytes = tap + coords.numel() * 4 + out_bytes
            ops_n = 0
            if kind == "fused":
                nbytes += wc.numel() * wc.element_size() + bias.numel() * 4
                ops_n = 2 * B * P * wc.shape[0] * F
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / PEAK_OPS_PER_S[name] * 1e3
            log(f"time {kind} {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB, "
                f"{ops_n / 1e9:.2f} GFLOP) [{card}]")
            stats[(kind, name)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        del pyr
    return stats


def chain_select_inputs(torch, dev, N=7, H=512, W=512):
    gen = torch.Generator(device=dev).manual_seed(2)
    u = lambda *s, lo=0.0, hi=1.0: torch.empty(s, device=dev).uniform_(lo, hi, generator=gen)
    lflow = u(N, H, W, 2, lo=-20.0, hi=20.0)
    rflow = u(N, H, W, 2, lo=-20.0, hi=20.0)
    valid = torch.tensor([True] * 5 + [False] * (N - 5), device=dev)
    return (lflow, u(N, H, W, hi=0.03), u(N, H, W, lo=0.1, hi=2.0),
            rflow, u(N, H, W, hi=0.03), u(N, H, W, lo=0.1, hi=2.0), valid)


def chain_select_bytes(torch, maps) -> int:
    """Compulsory bytes: left maps and valid read once, the right occlusion
    and sigma taps each pixel's candidates touch, the winners' right-flow
    taps, and the outputs."""
    from mft_tpu_torch.ops.chain_select import select_candidates
    lflow, locc, lsig, rflow, rocc, rsig, valid = maps
    N, H, W = locc.shape
    dev = lflow.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")

    def touched(cx, cy, cand):
        mask = torch.zeros(N * H * W, dtype=torch.bool, device=dev)
        x0, y0 = torch.floor(cx).long(), torch.floor(cy).long()
        for dx in (0, 1):
            for dy in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                mask[(cand * H * W + yi * W + xi)[ok]] = True
        return int(mask.sum().item())

    cand = torch.arange(N, device=dev)[:, None, None].expand(N, H, W)
    n_occ_sig = touched(xs + lflow[..., 0], ys + lflow[..., 1], cand)
    best, _, _ = select_candidates(lflow, locc, lsig, rocc, rsig, valid)
    sel = torch.gather(lflow, 0, best[None, ..., None].expand(1, H, W, 2))[0]
    n_flow = touched(xs + sel[..., 0], ys + sel[..., 1], best)
    left = N * H * W * (8 + 4 + 4) + N
    return left + n_occ_sig * 8 + n_flow * 8 + H * W * 4 * 4   # + flow, occl, sigma out


def check_chain_select(torch, ops, dev, card):
    maps = chain_select_inputs(torch, dev)
    got = ops.chain_select(*maps)
    torch.cuda.synchronize()
    want = ops.chain_select_ref(*maps)
    # same float ops in the same order (built with -fmad=false): identical
    # results are expected; the tolerance admits last-bit differences only
    tols = (1e-4, 1e-5, 1e-5)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(within(g, w, a, 1e-6) for g, w, a in zip(got, want, tols))
    log(f"check chain_select: max_abs_err flow {errs[0]:.3e} occlusion {errs[1]:.3e} "
        f"sigma {errs[2]:.3e} (tolerance atol {tols} + rtol 1e-6) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "chain_select disagrees with its plain version")
    ms = cuda_ms(lambda: ops.chain_select(*maps), reps=50)
    plain_ms = cuda_ms(lambda: ops.chain_select_ref(*maps), reps=5, warmup=1)
    nbytes = chain_select_bytes(torch, maps)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time chain_select: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB) [{card}]")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes")


# --------------------------------------------------------------------------- #
# phases 4-5: the main path
# --------------------------------------------------------------------------- #
def synthetic_clip(n_frames, H=512, W=512, seed=0):
    """uint8 BGR frames of one multi-scale random texture, shifted by SHIFT
    px per frame (true flow from frame 0 to frame k: -k*SHIFT)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    dx, dy = SHIFT
    th, tw = H + dy * n_frames + 8, W + dx * n_frames + 8
    tex = np.zeros((th, tw, 3), np.float32)
    for cell, amp in ((64, 0.5), (16, 0.3), (4, 0.2)):
        g = torch.from_numpy(rng.random((1, 3, th // cell + 2, tw // cell + 2),
                                        dtype=np.float32))
        up = F.interpolate(g, size=(th, tw), mode="bilinear", align_corners=False)
        tex += amp * up[0].permute(1, 2, 0).numpy()
    tex = (255.0 * tex).clip(0, 255).astype(np.uint8)
    return [np.ascontiguousarray(tex[k * dy:k * dy + H, k * dx:k * dx + W])
            for k in range(n_frames + 1)]


def snapshot(tracker):
    keys = ("mem_imgs", "mem_flow", "mem_occl", "mem_sigma", "mem_fmap", "mem_cnet")
    return tracker.current_frame_i, {k: getattr(tracker, k).clone() for k in keys}


def restore(tracker, snap):
    tracker.current_frame_i, mems = snap
    for k, v in mems.items():
        getattr(tracker, k).copy_(v)


def run_main_path(torch, ops, dev, card):
    from mft_tpu_torch.config import default_config
    from mft_tpu_torch.tracker import MFT

    t0 = time.perf_counter()
    cfg = default_config()
    tracker = MFT(cfg, device=dev)
    frames = synthetic_clip(FRAMES + 1)
    iters = tracker.flower.iters
    log(f"main path: MFT {len(tracker.deltas)} deltas {tracker.deltas}, "
        f"{iters} iterations, {tracker.flower.dtype}, frames "
        f"{frames[0].shape}, set-up {time.perf_counter() - t0:.2f} s")

    ops.reset_launch_counts()
    tracker.init(frames[0])
    frame_ms, results = [], []
    for k in range(1, FRAMES + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = tracker.track(frames[k]).result
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        results.append(res)
    counts = ops.launch_counts()

    log(f"launches over {FRAMES} tracked frames: {counts}")
    want = {"corr_lookup_fused": FRAMES * (iters - 1), "corr_lookup": FRAMES,
            "chain_select": FRAMES}
    check(counts == want, f"launch counts {counts} != {want} "
                          f"(11, 1 and 1 per tracked frame)")
    H, W = frames[0].shape[:2]
    for k, r in enumerate(results, start=1):
        check(tuple(r.flow.shape) == (H, W, 2) and tuple(r.occlusion.shape) == (H, W)
              and tuple(r.sigma.shape) == (H, W), f"frame {k}: wrong shapes")
        check(bool(torch.isfinite(r.flow).all() and torch.isfinite(r.occlusion).all()
                   and torch.isfinite(r.sigma).all()), f"frame {k}: non-finite output")
        check(bool(((r.occlusion >= 0) & (r.occlusion <= 1)).all()),
              f"frame {k}: occlusion outside [0, 1]")
        check(bool((r.sigma > 0).all()), f"frame {k}: sigma not > 0")
    last = results[-1]
    log(f"frame {FRAMES}: mean flow ({float(last.flow[..., 0].mean()):.3f}, "
        f"{float(last.flow[..., 1].mean()):.3f}) px (random weights; true "
        f"{-FRAMES * SHIFT[0]}, {-FRAMES * SHIFT[1]}), mean occlusion "
        f"{float(last.occlusion.mean()):.4f}, mean sigma {float(last.sigma.mean()):.4f}")
    steady = sorted(frame_ms[WARMUP:])
    median = steady[len(steady) // 2] if len(steady) % 2 else 0.5 * (
        steady[len(steady) // 2 - 1] + steady[len(steady) // 2])
    log(f"frame ms: {', '.join(f'{m:.2f}' for m in frame_ms)}")
    log(f"frame ms median after {WARMUP} warm-up frames: {median:.3f} ms "
        f"({1e3 / median:.2f} frames/s) [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # phase 5: the same next frame through the kernels and the plain versions
    t5 = time.perf_counter()
    nxt = synthetic_clip(FRAMES + 1)[-1]
    snap = snapshot(tracker)
    a = tracker.track(nxt).result
    restore(tracker, snap)
    tracker.plain_ops = True
    b = tracker.track(nxt).result
    tracker.plain_ops = False
    torch.cuda.synchronize()
    dflow = (a.flow - b.flow).norm(dim=-1)
    docc = (a.occlusion - b.occlusion).abs()
    dsig = (a.sigma - b.sigma).abs() / b.sigma
    far = float((dflow > 0.5).float().mean())
    # stated tolerance: bf16 rounding differences (the fused product's sum
    # order) may move a few pixels' selection; the bulk must agree
    ok = (far <= 0.01 and float(dflow.median()) <= 0.05
          and float((docc > 0.05).float().mean()) <= 0.01
          and float((dsig > 0.05).float().mean()) <= 0.01)
    log(f"check kernels vs plain, one frame: flow |d| median "
        f"{float(dflow.median()):.3e} px, max {float(dflow.max()):.3e} px, share > 0.5 px "
        f"{far:.4%}; occlusion |d| max {float(docc.max()):.3e}, share > 0.05 "
        f"{float((docc > 0.05).float().mean()):.4%}; sigma rel |d| share > 5% "
        f"{float((dsig > 0.05).float().mean()):.4%} (tolerance: share > 0.5 px <= 1%, "
        f"median <= 0.05 px, occlusion/sigma shares <= 1%) {'ok' if ok else 'FAIL'}")
    check(ok, "main path with kernels disagrees with the plain versions")
    log(f"phase 5 seconds {time.perf_counter() - t5:.2f}")
    return counts


def main() -> int:
    # a hang exits non-zero with a traceback instead of running out the clock
    faulthandler.dump_traceback_later(900, exit=True)
    try:
        return run()
    finally:
        faulthandler.cancel_dump_traceback_later()


def run() -> int:
    t_all = time.perf_counter()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from mft_tpu_torch import ops
    from mft_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t = time.perf_counter()
    card = card_line()
    log(card)   # as nvidia-smi prints it: name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"phase 1 seconds {time.perf_counter() - t:.2f}")

    t = time.perf_counter()
    path = _build.library_path()
    _build.library()
    log(f"build: {path.name} in {_build.build_seconds:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    log(f"phase 2 seconds {time.perf_counter() - t:.2f}")

    try:
        t = time.perf_counter()
        lk = check_lookups(torch, ops, dev, card)
        cs = check_chain_select(torch, ops, dev, card)
        log(f"phase 3 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        counts = run_main_path(torch, ops, dev, card)
        log(f"phase 4-5 seconds {time.perf_counter() - t:.2f}")
        for stats in (*lk.values(), cs):
            check(all(math.isfinite(stats[k]) for k in
                      ("max_abs_err", "ms", "plain_ms", "bound_ms")),
                  f"non-finite measurement {stats}")
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    src = "mft_tpu_torch/ops/csrc/"
    kernels = [
        dict(name="corr_lookup_fused", route="cuda", source=src + "corr_lookup.cu",
             replaces="mft_tpu/ops/corr_lookup_pallas.py:281",
             launches=counts["corr_lookup_fused"], **lk[("fused", "bfloat16")],
             library_ms=None),
        dict(name="corr_lookup", route="cuda", source=src + "corr_lookup.cu",
             replaces="mft_tpu/ops/corr_lookup_pallas.py:168",
             launches=counts["corr_lookup"], **lk[("lookup", "bfloat16")],
             library_ms=None),
        dict(name="chain_select", route="cuda", source=src + "chain_select.cu",
             replaces="mft_tpu/ops/warp_pallas.py:432",
             launches=counts["chain_select"], **cs, library_ms=None),
    ]
    log(f"total seconds {time.perf_counter() - t_all:.2f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
