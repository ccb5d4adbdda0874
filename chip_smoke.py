#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check its kernels.

Run from any directory, with no arguments:

    python3 chip_smoke.py

Phases, in the order they run (each prints its seconds; any failure exits
non-zero and prints no result line):
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``mft_tpu_torch/ops/csrc`` (one bare nvcc per
   source, started together) and check that the SASS of the tensor-core
   kernels (#5, #13, the bf16 fused lookup K1 and the bf16 window
   correlations K4/K5) holds HGMMA in every instance (``cuobjdump -sass``)
   and that ptxas gave every instance of the staged gather
   (``corr_gather.cu``: K2, the folded #4, #9, the int8 K6 and the packed K7,
   K8), of K1 (``corr_lookup.cu``), of the warp (``warp.cu``), of the bf16
   window correlations (``corr_alt.cu``), of the lane-major lookup K9
   (``corr_volume.cu``), of chain + select K3 (``chain_select.cu``) and of
   the lookup's backward (``corr_lookup_bwd.cu``) a 0-byte stack frame and
   no spills;
3. hold each kernel against its plain PyTorch version at the main path's
   shapes, in bf16 and f32, and time it (device time by CUDA graph replay,
   as every kernel and library call below; the plain versions eagerly); K1
   in bf16 sums on the tensor cores and is also held to
   ``ops.product_error_bound`` on every element (largest ratio logged), and
   timed beside the unfused pair K2 + ``torch.addmm`` + relu; K3 bit for bit
   (NaN positions equal) on uniform flows, on local ones, on local ones
   with every candidate valid (each timed with its own bound) and on maps
   with NaN occlusions and sigmas;
3b. the same for the window-correlation kernels of corr_method 'alt' and
   'win' (no volume), on wild and on local coordinates: float32 bit for
   bit; bfloat16, one tile product on the tensor cores for both, within
   ``ops.product_error_bound`` on every element (largest ratio logged), its
   outputs that differ from the plain version's counted;
3c. the same for the lookups of the volume's other stored forms,
   corr_method 'int8', 'packed', 'packed_i8' and 'pallas_t' (K6-K9), on
   uniform and on local coordinates; for each of them the outputs that
   differ from the plain version's bits are counted (not gated: 0
   expected), and for K9 the share of (group, level) union boxes it staged;
3d. the same for the folded volume's build and lookup (corr_method 'fold'),
   the mixed lookup ('mixed') and the update block's convolution
   (conv_backend 'pallas') at every conv shape of the frame and each
   activation: the lookups and the f32 products held to bit-identical
   results, the bf16 products (tensor cores, ``product_tc.cu``) to
   ``ops.product_error_bound`` on every element, with the largest ratio to
   the bound logged; the lookups' outputs that differ from the plain
   version's bits are counted;
3e. the same for the bilinear warp (``mft_warp``) through each of its JAX
   entry points, in 'tpu' mode at the shapes where JAX takes each of its
   three warp kernels and bilinear_warp_blocked, and in 'exact' mode on
   4-channel FlowOU maps at 512x512 and 2160x3840; bit-identical results;
4. the main path: ``MFT(default_config())`` with random weights from a seed,
   ``init`` + ``track`` of synthetic 512x512 frames (a texture under a known
   shift); checks shapes, finiteness, ranges and that the kernels launched
   11, 1 and 1 times per tracked frame;
5. one more frame with the plain versions forced, compared with the kernels';
11. the slice's path on the main path's results: point tracking of the 10
   tracked frames (the demo's query grid and every pixel), chain_results of
   two results, and the TPU-form chain + select (``chain_select_pallas``) on
   the next frame's 7 candidates, each through the warp kernel and through
   the plain versions (identical), each call one warp launch; the TPU form's
   gap to K3 is printed (not gated); chain_select_pallas again at 1080x1920
   in phase 9;
6. the same tracker with corr_method 'alt', then 'win', at 512x512: frame
   times, peak memory, 12 launches of the method's kernel and 1 chain +
   select per frame, a frame against the plain versions, and (printed, not
   gated) a frame against the volume path;
8. the same for 'int8', 'packed', 'packed_i8' and 'pallas_t', with the
   share of K9's (group, level) union boxes staged over the tracked
   'pallas_t' frames;
10. the same for corr_method 'fold', for 'mixed' and for conv_backend
   'pallas': each path's launches per frame ('fold' one build and 12 folded
   lookups, 'mixed' 12 mixed lookups, 'pallas' 11 fused lookups, 1 lookup
   and 109 convs, every build and conv on the tensor cores), the frame
   against the plain versions ('fold' and 'pallas' relative to the volume
   path's gap to the same plain frame) and (not gated) the volume path;
7. 'alt' and 'win' at 2160x3840, where the all-pairs volume would not fit on
   the card: init + 2 tracked frames each, peak device memory, the share of
   'win''s (tile, level) boxes that were staged, and the kernels (K3-K5)
   against their plain versions on sampled pixels at that size (K4/K5 within
   the bound, their differing outputs counted);
9. 'int8' and 'auto' at 1080x1920: init + 2 tracked frames each, their peak
   device memory ('int8' must peak lower), K6, K2 and K1 against their plain
   versions on sampled pixels at that size (K2 bit for bit, K1 within the
   bound); then phase 11's chain_select_pallas on the 'auto' tracker's next
   7 candidates;
12. the tracker configurations on the committed weights
   (``weights/raftou_synth.msgpack``): ``synth_config()``, ``fast_config()``
   and ``warm_config()``, 10 tracked frames each: launches per frame (K1
   11, K2 1, K3 1 for synth; K1 6, K2 6, K3 1 for the fast and warm
   schedules), outputs, a frame against the plain versions (the main
   path's gate), the flow's error to the clip's true shift (not gated);
   for fast, each lookup on the volume sliced to each active prefix of
   the schedule against its plain version (K2 bit for bit, K1 within the
   bound); the fast schedule on 'mixed', 'packed' and 'packed_i8' (3
   frames each, #9, K7, K8 on the sliced volumes, bit for bit); 3 frames
   of the warm config's unfused timer step (``timers_enabled``) against
   the fused step's frames (the main path's gate), the phases' ms
   printed; not gated, on the committed weights: one frame of 'alt',
   'win', 'int8', 'fold' and conv 'pallas' against the volume path,
   chain_select_pallas against K3, and the share of K1's outputs in its
   repair's window (also on the main path's random weights); K1 on the
   volume sliced to each prefix must give 0 outputs unlike its plain
   version, whose product sums in the repair's fixed order;
13. the TAP-Vid runner: ``mft_tpu_torch.eval.runner.run`` on a synthetic
   DAVIS-form pickle (2 sequences of 24 frames of 256x256 texture moving
   1 px right and down a frame, 256 query points in view throughout) with
   ``synth`` and its ``cache_delta_infinity`` twin, mode 'both', scaling
   256x256_512x512, then ``evaluate`` and ``report``: every prediction
   file, <delta_avg >= 0.9 (AJ and OA printed), the FlowCache's hits and
   misses per pass and the launches (K1 11 and K2 1 a frame through RAFT,
   K3 1 a frame, the warp 1 a conversion) as an independent model of the
   cache policy predicts, every strided forward pass hitting every valid
   finite pair, every cache write a CUDA tensor in the device tier; on
   one sequence, track_chunk against per-frame track (bit for bit), the
   plain versions' pass (the main path's frame gate, query tracks within
   0.5 px for >= 99%), a cold, an injected (batch 1), a
   cache_delta_infinity and a RAFT-free pass (K1 0, K2 0, K3 1 a frame;
   bit for bit with the pass whose entries it reads), injected frames
   against the full batch's (the frame gate) and a .flowouX16.pkl disk
   round trip within the quantisation step; frames/s by pass kind, peak
   device memory and the device tier's bytes printed;
14. training: (a) the lookup's backward kernel ``mft_corr_lookup_bwd``
   against its plain version at the training shape (6 x 46x96, 4 levels,
   r 4) and the 512x512 slice's, uniform and local coordinates, f32 and
   bf16 bit for bit (bf16 also the f32 result rounded once), timed by graph
   replay beside the plain version, the library's backward
   (``grid_sampler_2d_backward`` per level) and its bound; (b) a
   Sintel-form tree (2 scenes x 5 frames of 436x1024, ``train/synth.py``)
   and both recipes through the entry point's parser and ``train`` on the
   committed weights: official (only ``occlusion_block`` trains, running
   statistics) and full (every parameter, batch statistics, gradients
   through the backward kernel), 5 steps each of batch 6 at 368x768, 12
   iterations, bf16 compute over f32 parameters; finite losses, frozen
   parameters bit-identical, trainable ones and (full only) the batch
   statistics moved, 12 K2 and 12 (full) or 0 (official) backward launches
   a step and nothing else, the checkpoint and its msgpack export, which
   the tracker loads and tracks 2 frames with; ms a step (median after one
   warm-up) and peak memory; (c) one f32 full-recipe step through the
   kernels and through the plain versions from the same state and batch,
   deterministic cuDNN, loss and gradients within ``TRAIN_PLAIN_TOL``;
   (d) resume: 2 steps, a checkpoint, a 3rd step, against a state restored
   from the checkpoint taking the same 3rd step, bit for bit; these steps,
   timed, give a full step's ms with no batch loader beside it;
15. multi-clip streaming (``mft_tpu_torch.parallel``): (a) chain + select K3
   with its clip axis, 4 clips x 7 candidates at 512x512 in one launch, on
   uniform, local, steady and NaN maps, bit for bit with its plain version
   and with 4 single-clip launches, timed beside them and its bound; (b)
   ``StreamingTracker`` on ``default_config()`` over C = 1, 2, 4, 8, 16
   clips (the synthetic clip, texture seed c for clip c), 10 timesteps
   each: launches K1 11, K2 1, K3 1 a timestep at every C, outputs, ms a
   timestep, clip-frames/s, peak memory and, from a profiler pass of 2 more
   timesteps, the device's idle share; clip 0 and clip C - 1 (every clip at
   C = 4) each timestep against a single-clip MFT from the same state,
   printed (random bf16 weights amplify the rounding of cuDNN's
   batch-dependent algorithms), then gated by the frame gate in float32 (3
   iterations, 4 timesteps) at C = 16, clips 0 and 15; (c) fast and warm on the
   committed weights at C = 4 (launches K1 6, K2 6, K3 1; every clip gated
   from the same state; the drift from trackers that track each clip alone
   printed, not gated); (d) injection at C = 4 on the committed weights:
   rows of four FlowCaches' device tiers for every valid finite pair, the
   template pair alone through RAFT (K1 11, K2 1, K3 1), every clip gated
   against the single tracker's injected frame; (e) an NCCL
   process group of world size 1 and its mesh: a ``make_train_step(mesh=)``
   step (full recipe, batch 2 at 368x768) and a ``StreamingTracker(mesh=)``
   timestep bit for bit with no mesh (more than one card: not run);
16. the RAFT variants: (a) K2 and its backward at the small model's radius
   3 (the backward at the training and slice shapes, as 14a) and K4/K5 at
   C = 128, radius 3, against their plain versions as phases 3, 3b and 14a
   hold them at radius 4 (K2 and the backward bit for bit, K4/K5 f32 to
   ALT_TOL and bf16 within the bound), each timed beside its plain
   version, its library call where there is one and its bound; (b) the
   small RAFT (``default_config()``'s raft_params with ``small``; random
   weights) tracking 10 frames at 512x512, 'auto' (launches a frame: K1 0,
   K2 12, K3 1) and 'alt' (K4 12, K3 1), ms a frame, peak memory, busy ms
   and idle share from a profiler pass of 2 frames, a frame against the
   plain versions (the frame gate); (c) the big model's 'morelayers' heads
   (random weights), 'upsample8' heads, ``relu_uncertainty`` and
   ``normalized_features`` (the committed weights), 3 frames each, launches
   K1 11, K2 1, K3 1 a frame, a frame against the plain versions; the
   model without OU heads on a 7-pair batch: K1 on all 12 iterations, no
   K2; (d) the small model's full recipe through the entry point
   (``--small``, random weights, 5 steps of batch 6 at 368x768, bf16 over
   f32): launches a step K2 12 and the backward 12 at radius 3, every conv
   weight moved, the export tracked with; one f32 step through the kernels
   against the plain versions within ``TRAIN_PLAIN_TOL``; (e) the fused
   encoder (``fused_encoder``, one grouped-conv stack for fnet and cnet)
   against the two encoders apart in f32 within ``FUSED_ENCODER_TOL``,
   both timed.

Every bf16 launch of K1, #5, #13, K4 and K5 on the main path, conv_backend
'pallas', 'alt' and 'win' at 512x512 and 2160x3840, 'auto' at 1080x1920
and the configurations of phase 12 must go through the tensor-core entry
points.

Where one PyTorch call computes a kernel's function, its time is taken beside
the kernel's as a yardstick (``library_ms``; the port never calls it):
``F.grid_sample`` per level for the volume lookups, its backward
``grid_sampler_2d_backward`` per level for the lookup's backward,
``torch.baddbmm`` for the folded build, ``F.conv2d`` for the convolution,
``F.grid_sample`` for the warp.

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
FEATURE_FRAMES = 10  # tracked frames of each feature-lookup method at 512x512
UHD_FRAMES = 2       # tracked frames of each method at 2160x3840
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one ``fn()``, replayed from a CUDA graph of ``reps``
    calls: the wrapper's host cost leaves no idle gaps between launches, as
    it does in :func:`cuda_ms` for a kernel of a few microseconds."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=3, warmup=1) / reps


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def within(got, want, atol, rtol) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def grid_sample_lookup(torch, levels, coords, radius=None):
    """The library's yardstick for a volume lookup: ``F.grid_sample``
    (bilinear, zeros outside, align_corners=True), one call per level on the
    (B*P, 1, h_l, w_l) view of the stored level (a copy where the layout has
    no such view, as the lane-major one), sampling each pixel's (2r+1)^2
    window. The grids are made beforehand, in the levels' dtype as
    grid_sample needs. returns: (device ms of the calls by graph replay,
    (B, P, L*(2r+1)^2) samples in the reference's channel order); radius
    RADIUS unless given."""
    import torch.nn.functional as F
    radius = RADIUS if radius is None else radius
    n = 2 * radius + 1
    off = torch.arange(n, dtype=torch.float32, device=coords.device) - radius
    Bn, Pn = coords.shape[:2]
    grids = []
    for lvl, corr in enumerate(levels):
        h, w = corr.shape[2:]
        c = coords / 2.0 ** lvl
        x = (c[..., 0, None, None] + off[:, None]).expand(Bn, Pn, n, n)  # i offsets x
        y = (c[..., 1, None, None] + off[None, :]).expand(Bn, Pn, n, n)
        g = torch.stack([2.0 * x / (w - 1) - 1.0, 2.0 * y / (h - 1) - 1.0], dim=-1)
        grids.append(g.reshape(Bn * Pn, n, n, 2).to(corr.dtype))

    def run():
        return [F.grid_sample(corr.reshape(Bn * Pn, 1, *corr.shape[2:]), g,
                              mode="bilinear", padding_mode="zeros", align_corners=True)
                for corr, g in zip(levels, grids)]
    out = torch.cat([o.reshape(Bn, Pn, n * n) for o in run()], dim=-1)
    return graph_ms(run), out


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))   # 512x512 at stride 8
B, P, RADIUS, F = 7, 64 * 64, 4, 256               # 7 delta pairs


def window_tap_bytes(dims, coords, itemsize, radius=RADIUS) -> int:
    """Bytes of a pyramid of levels ``dims`` = ((h_l, w_l), ...) with values of
    ``itemsize`` bytes that the windows of these coords touch (in-bounds taps
    of each pixel's (2r+2)^2 neighbourhood per level; each read once)."""
    import torch
    n = 0
    for lvl, (h, w) in enumerate(dims):
        c = coords / 2.0 ** lvl
        lo = torch.floor(c) - radius
        x_lo, y_lo = lo[..., 0].clamp(min=0), lo[..., 1].clamp(min=0)
        x_hi = (lo[..., 0] + 2 * radius + 1).clamp(max=w - 1)
        y_hi = (lo[..., 1] + 2 * radius + 1).clamp(max=h - 1)
        nx = (x_hi - x_lo + 1).clamp(min=0)
        ny = (y_hi - y_lo + 1).clamp(min=0)
        n += int((nx * ny).sum().item())
    return n * itemsize


def check_lookups(torch, ops, dev, card):
    """K1 (corr_lookup_fused) and K2 (corr_lookup) against their plain
    versions at the 512x512 slice's shapes, on uniform coordinates (some
    windows leave the map) and on local ones (the pixel grid + U(-2, 2), the
    tracker's windows). returns: {(kind, dtype): stats of the uniform
    coordinates, with the local ones' time, bound and library time under
    ``*_local``}."""
    gen = torch.Generator(device=dev).manual_seed(1)
    coords = torch.empty((B, P, 2), device=dev)
    coords.uniform_(-10.0, 74.0, generator=gen)   # some windows leave the map
    wc32 = torch.randn((len(LEVELS) * (2 * RADIUS + 1) ** 2, F), device=dev,
                       generator=gen) / 18.0
    bias = 0.1 * torch.randn((F,), device=dev, generator=gen)
    local = lookup_coords(torch, dev, "local", torch.Generator(device=dev).manual_seed(11))
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
        # as the model passes it: bf16 the (C, F) view of the (F, C) conv
        # weight, which the tensor-core kernel reads with no copy
        wc = wc32.to(dtype) if dtype == torch.float32 else wc32.t().contiguous().to(dtype).t()
        for kind in ("lookup", "fused"):
            for where, c in (("uniform", coords), ("local", local)):
                if kind == "lookup":
                    kernel = lambda: ops.corr_lookup(pyr, c, RADIUS)
                    plain = lambda: ops.corr_lookup_ref(pyr, c, RADIUS)
                else:
                    kernel = lambda: ops.corr_lookup_fused(pyr, c, wc, bias, RADIUS)
                    plain = lambda: ops.corr_lookup_fused_ref(pyr, c, wc, bias, RADIUS)
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                err = max_err(got, want)
                atol, rtol = tol[(kind, name)]
                ok = within(got, want, atol, rtol)
                log(f"check {kind} {name} {where}: max_abs_err {err:.3e} "
                    f"(tolerance atol {atol} + rtol {rtol}) {'ok' if ok else 'FAIL'}")
                check(ok, f"{kind} {name} {where} disagrees with its plain version")
                ratio = None
                if kind == "fused" and dtype == torch.bfloat16:
                    # on the tensor cores: also every element within the bound
                    mag = ops.corr_lookup_fused_magnitude(pyr, c, wc, RADIUS)
                    _, ratio = bound_check(torch, ops, f"fused {name} {where} (tensor cores)",
                                           got, want, mag, wc.shape[0])
                    del mag
                    # not gated: the rounding repair should leave none
                    log(f"fused {name} {where}: {int((got != want).sum())} of {got.numel()} "
                        f"outputs differ from the plain version's")
                call_ms = cuda_ms(kernel, reps=20)     # with the wrapper's host cost
                ms = graph_ms(kernel)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                tap = window_tap_bytes(LEVELS, c, pyr[0].element_size())
                out_bytes = got.numel() * got.element_size()
                nbytes = tap + c.numel() * 4 + out_bytes
                ops_n = 0
                if kind == "fused":
                    nbytes += wc.numel() * wc.element_size() + bias.numel() * 4
                    ops_n = 2 * B * P * wc.shape[0] * F
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops_n / PEAK_OPS_PER_S[name] * 1e3
                bound = max(bytes_ms, ops_ms)
                log(f"time {kind} {name} {where}: kernel {ms:.4f} ms (graph replay; "
                    f"{call_ms:.4f} ms a call from Python), plain {plain_ms:.3f} ms, "
                    f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
                    f"{ops_n / 1e9:.2f} GFLOP) [{card}]")
                lib_ms = unfused_ms = None
                if kind == "fused":
                    # a yardstick, not a library call: K2, then cuBLAS's
                    # addmm and relu on its samples (the unfused pair)
                    bias_dt = bias.to(dtype)
                    unfused = lambda: torch.relu(torch.addmm(
                        bias_dt, ops.corr_lookup(pyr, c, RADIUS).reshape(B * P, -1), wc))
                    unfused_ms = graph_ms(unfused)
                    log(f"time fused {name} {where}: unfused pair (K2, torch.addmm, relu) "
                        f"{unfused_ms:.4f} ms (graph replay) against the kernel's {ms:.4f} "
                        f"ms [{card}]")
                if kind == "lookup":
                    lib_ms, lib = grid_sample_lookup(torch, pyr, c)
                    log(f"library lookup {name} {where}: F.grid_sample per level "
                        f"{lib_ms:.4f} ms (graph replay), max_abs_err to the plain "
                        f"version {max_err(lib, want):.3e} (its grid is in the volume "
                        f"dtype) [{card}]")
                    del lib
                if where == "uniform":
                    stats[(kind, name)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="bytes" if bytes_ms >= ops_ms else "operations")
                    if lib_ms is not None:
                        stats[(kind, name)]["library_ms"] = lib_ms
                    if unfused_ms is not None:
                        stats[(kind, name)]["unfused_ms"] = unfused_ms
                    if ratio is not None:
                        stats[(kind, name)]["bound_ratio"] = ratio
                else:
                    st = stats[(kind, name)]
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    st.update(ms_local=ms, bound_ms_local=bound)
                    if lib_ms is not None:
                        st["library_ms_local"] = lib_ms
                    if unfused_ms is not None:
                        st["unfused_ms_local"] = unfused_ms
                    if ratio is not None:
                        st["bound_ratio"] = max(st["bound_ratio"], ratio)
                del got, want
        del pyr
    return stats


def chain_select_inputs(torch, dev, N=7, H=512, W=512, kind="uniform", seed=2):
    """K3's candidate maps: 'uniform' draws every flow in +-20 px per pixel
    (every warp's taps scattered), 'local' gives candidate n the shift
    (n + 1)*(2, 1) px plus U(-0.5, 0.5), as tracking does; occlusions in
    [0, 0.03), sigmas in [0.1, 2); candidates 5 and 6 invalid (MFT's deltas
    16 and 32, as in frames 8-15 after the start), except in 'steady', the
    local maps with every candidate valid (frame 32 after the start on)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s, lo=0.0, hi=1.0: torch.empty(s, device=dev).uniform_(lo, hi, generator=gen)
    if kind == "uniform":
        lflow = u(N, H, W, 2, lo=-20.0, hi=20.0)
        rflow = u(N, H, W, 2, lo=-20.0, hi=20.0)
    else:
        shift = (torch.arange(N, device=dev, dtype=torch.float32)[:, None, None, None] + 1.0
                 ) * torch.tensor([2.0, 1.0], device=dev)
        lflow = shift + u(N, H, W, 2, lo=-0.5, hi=0.5)
        rflow = shift + u(N, H, W, 2, lo=-0.5, hi=0.5)
    valid = torch.tensor([True] * 5 + [kind == "steady"] * (N - 5), device=dev)
    return (lflow, u(N, H, W, hi=0.03), u(N, H, W, lo=0.1, hi=2.0),
            rflow, u(N, H, W, hi=0.03), u(N, H, W, lo=0.1, hi=2.0), valid)


def chain_select_nan_inputs(torch, dev, N=7, H=512, W=512, seed=2):
    """The uniform maps with NaN in 1% of the values of each candidate
    occlusion and sigma map (left and right): NaN scores, which argmax takes
    as the maximum, and NaN occlusions, which torch.maximum propagates."""
    maps = list(chain_select_inputs(torch, dev, N, H, W, seed=seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for k in (1, 2, 4, 5):
        hit = torch.rand(maps[k].shape, device=dev, generator=gen) < 0.01
        maps[k] = maps[k].masked_fill(hit, float("nan"))
    return tuple(maps)


def chain_select_bytes(torch, maps) -> int:
    """Compulsory bytes: valid read once; the left maps and the right
    occlusion and sigma taps of the candidates a pixel needs, which are the
    valid ones and its winner (an invalid candidate scores -inf whatever its
    maps hold, so it is needed only where it wins: candidate 0 where every
    score is -inf); the winners' right-flow taps; the outputs."""
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

    best, _, _ = select_candidates(lflow, locc, lsig, rocc, rsig, valid)
    cand = torch.arange(N, device=dev)[:, None, None].expand(N, H, W)
    needed = valid.to(dev)[:, None, None] | (cand == best)
    n_occ_sig = touched((xs + lflow[..., 0])[needed], (ys + lflow[..., 1])[needed],
                        cand[needed])
    sel = torch.gather(lflow, 0, best[None, ..., None].expand(1, H, W, 2))[0]
    n_flow = touched(xs + sel[..., 0], ys + sel[..., 1], best)
    left = int(needed.sum()) * (8 + 4 + 4) + N
    return left + n_occ_sig * 8 + n_flow * 8 + H * W * 4 * 4   # + flow, occl, sigma out


def check_chain_select(torch, ops, dev, card):
    """K3 against its plain version on the uniform, the local, the steady and
    the NaN maps, bit for bit (NaN positions equal): the same float ops in
    the same order, built with -fmad=false, and the same argmax and maximum
    on NaN; then timed on all but the NaN maps, each with its own bound."""
    stats = {}
    for kind in ("uniform", "local", "steady", "nan"):
        maps = (chain_select_nan_inputs(torch, dev) if kind == "nan"
                else chain_select_inputs(torch, dev, kind=kind))
        got = ops.chain_select(*maps)
        torch.cuda.synchronize()
        want = ops.chain_select_ref(*maps)
        n_diff = sum(differing(torch, g, w) for g, w in zip(got, want))
        n_nan = sum(int(torch.isnan(w).sum()) for w in want)
        finite = [torch.isfinite(w) for w in want]
        errs = [float((g.float() - w.float()).abs()[f].max()) for g, w, f in zip(got, want, finite)]
        log(f"check chain_select {kind}: {n_diff} of {sum(w.numel() for w in want)} outputs "
            f"differ from the plain version's (NaN positions and bits; {n_nan} NaN outputs); "
            f"max_abs_err flow {errs[0]:.3e} occlusion {errs[1]:.3e} sigma {errs[2]:.3e} "
            f"(tolerance 0) {'ok' if n_diff == 0 else 'FAIL'}")
        check(n_diff == 0, f"chain_select disagrees with its plain version on the {kind} maps")
        if kind == "nan":
            stats["nan_outputs_differing"] = n_diff
            continue
        ms = graph_ms(lambda: ops.chain_select(*maps))
        plain_ms = cuda_ms(lambda: ops.chain_select_ref(*maps), reps=5, warmup=1)
        nbytes = chain_select_bytes(torch, maps)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"time chain_select {kind}: kernel {ms:.4f} ms (graph replay), plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
            f"{ms / bound:.2f}x the bound [{card}]")
        if kind == "uniform":
            stats.update(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes")
        else:
            stats.update({f"ms_{kind}": ms, f"plain_ms_{kind}": plain_ms,
                          f"bound_ms_{kind}": bound})
        del maps, got, want
    return stats


# --------------------------------------------------------------------------- #
# phase 3b: the window-correlation kernels of corr_method 'alt' and 'win'
# --------------------------------------------------------------------------- #
FEAT_C = 256                                       # fnet channels
# stated tolerance of the float32 kernels |kernel - plain| <= atol +
# rtol*|plain|: kernels and plain version do the same float ops in the same
# order (each dot in one fixed tree order; built with -fmad=false), so
# identical results are expected and the tolerance admits last-bit
# differences only. bfloat16 sums each tap dot on the tensor cores and is
# held to ops.product_error_bound (K = C, scale 1/sqrt(C), S from
# ops.corr_window_magnitude) on every element; its outputs that differ from
# the plain version's are counted (the rounding repair expects none)
ALT_TOL = {"float32": (1e-6, 1e-6)}


def feature_inputs(torch, dev, dtype, kind, H8, W8, seed, C=FEAT_C):
    """Random (B, H8, W8, C) source features, the pooled pyramid of random
    target features, and coords: 'wild' uniform over the map and 10 px beyond
    it, 'local' the pixel grid + U(-2, 2)."""
    from mft_tpu_torch.models.raft.corr import build_feature_pyramid
    gen = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn((B, H8, W8, C), device=dev, generator=gen).to(dtype)
    f2 = torch.randn((B, C, H8, W8), device=dev, generator=gen).to(dtype)
    u = torch.empty((B, H8 * W8, 2), device=dev).uniform_(0.0, 1.0, generator=gen)
    if kind == "wild":
        lo = torch.tensor([-10.0, -10.0], device=dev)
        coords = lo + u * torch.tensor([W8 + 20.0, H8 + 20.0], device=dev)
    else:
        ys, xs = torch.meshgrid(torch.arange(H8, device=dev), torch.arange(W8, device=dev),
                                indexing="ij")
        grid = torch.stack([xs, ys], -1).reshape(1, H8 * W8, 2).float()
        coords = grid + 4.0 * u - 2.0
    return f1, build_feature_pyramid(f2, len(LEVELS)), coords.contiguous()


def feature_work(torch, f1, pyr, coords, radius=RADIUS):
    """(compulsory bytes, operations) of one window-correlation call: f1,
    coords and the output once, plus each pyramid position some window's
    taps touch once; 2*C operations per in-map tap dot (the bilinear
    combination's 7 per sample, about 1%, not counted)."""
    Bn, H8, W8, C = f1.shape
    es = f1.element_size()
    side = 2 * radius + 2
    dev = f1.device
    nbytes = f1.numel() * es + coords.numel() * 4
    nbytes += Bn * H8 * W8 * len(pyr) * (2 * radius + 1) ** 2 * es
    ops_n = 0
    pair = torch.arange(Bn, device=dev)[:, None]
    for lvl, f2 in enumerate(pyr):
        h, w = f2.shape[1:3]
        base = torch.floor(coords / 2.0 ** lvl).clamp(-1e6, 1e6).long() - radius
        nx = (base[..., 0] + side).clamp(0, w) - base[..., 0].clamp(0, w)
        ny = (base[..., 1] + side).clamp(0, h) - base[..., 1].clamp(0, h)
        ops_n += 2 * C * int((nx * ny).sum().item())
        mask = torch.zeros(Bn * h * w, dtype=torch.bool, device=dev)
        for ty in range(side):
            y = base[..., 1] + ty
            for tx in range(side):
                x = base[..., 0] + tx
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                mask[(pair * (h * w) + y * w + x)[ok]] = True
        nbytes += int(mask.sum().item()) * C * es
    return nbytes, ops_n


def check_feature_kernels(torch, ops, dev, card, C=FEAT_C, radius=RADIUS):
    """K4 (corr_lookup_alt) and K5 (corr_lookup_win) against their plain
    version at the 512x512 slice's shapes: B=7, 64x64, C channels (the big
    model's 256 by default), 4 levels, radius ``radius``; float32 bit for
    bit, bfloat16 (one tile product on the tensor cores for both) within the
    bound, its outputs differing from the plain version's counted."""
    H8, W8 = LEVELS[0]
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for kind in ("wild", "local"):
            f1, pyr, coords = feature_inputs(torch, dev, dtype, kind, H8, W8, seed=3, C=C)
            plain = lambda: ops.corr_lookup_alt_ref(f1, pyr, coords, radius)
            want = plain()
            plain_ms = cuda_ms(plain, reps=2, warmup=1)
            nbytes, ops_n = feature_work(torch, f1, pyr, coords, radius)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / PEAK_OPS_PER_S[name] * 1e3
            mag = (ops.corr_window_magnitude(f1, pyr, coords, radius) if name == "bfloat16"
                   else None)
            for kname in ("corr_lookup_alt", "corr_lookup_win"):
                kernel = lambda: getattr(ops, kname)(f1, pyr, coords, radius)
                got = kernel()
                torch.cuda.synchronize()
                label = f"{kname} {name} {kind}" + (f" C {C} r {radius}" if (C, radius) != (
                    FEAT_C, RADIUS) else "")
                staged = ""
                if kname == "corr_lookup_win":
                    counters = torch.zeros(2, dtype=torch.int32, device=dev)
                    ops.corr_lookup_win(f1, pyr, coords, radius, stats=counters)
                    n_st, n_un = counters.tolist()
                    staged = f"; staged (tile, level) boxes {n_st}/{n_st + n_un}"
                ratio = differ = None
                if mag is not None:
                    err, ratio = window_check(torch, ops, label, got, want, mag, C)
                    differ = differing(torch, got, want)
                    log(f"check {label}: {differ} of {got.numel()} outputs differ from the plain "
                        f"version's bits{staged}")
                else:
                    err = max_err(got, want)
                    atol, rtol = ALT_TOL[name]
                    ok = within(got, want, atol, rtol)
                    log(f"check {label}: max_abs_err {err:.3e} (tolerance atol {atol} + rtol "
                        f"{rtol}) {'ok' if ok else 'FAIL'}{staged}")
                    check(ok, f"{label} disagrees with its plain version")
                ms = graph_ms(kernel)
                log(f"time {label}: kernel {ms:.4f} ms (graph replay), plain "
                    f"{plain_ms:.3f} ms, "
                    f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB, "
                    f"{ops_n / 1e9:.2f} GFLOP) [{card}]")
                stats[(kname, name, kind)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    bound_ratio=ratio, outputs_differing=differ)
            del f1, pyr, coords, want, mag
    return stats


def differing(torch, got, want) -> int:
    """Outputs that differ (same dtype and shape): a NaN against a number,
    or the bits of two numbers; two NaNs count as equal."""
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    bits = (got.view(ints) != want.view(ints)) & ~nan_g & ~nan_w
    return int(((nan_g != nan_w) | bits).sum())


def window_check(torch, ops, label, got, want, magnitude, C=FEAT_C):
    """The bf16 window correlations (tensor cores) within
    ops.product_error_bound of the plain version on every element: K = C,
    scale 1/sqrt(C), S from ops.corr_window_magnitude."""
    from mft_tpu_torch.ops.product import corr_scale
    return bound_check(torch, ops, label, got, want, magnitude, C, corr_scale(C))


# --------------------------------------------------------------------------- #
# phase 3c: the lookups of the volume's other stored forms
# --------------------------------------------------------------------------- #
# corr_method -> the wrapper of its lookup kernel
VOLUME_KERNEL_OF = {"int8": "corr_lookup_q", "packed": "corr_lookup_packed",
                    "packed_i8": "corr_lookup_packed_i8", "pallas_t": "corr_lookup_t"}
# stated tolerance |kernel - plain| <= atol + rtol*|plain|: the same float ops
# in the same order (each tap dequantized, then weighted; -fmad=false), so
# identical results are expected and the tolerance admits last-bit
# differences only
VOLUME_TOL = (1e-6, 1e-6)


def lookup_coords(torch, dev, kind, gen, H8=64, W8=64, pairs=B):
    """(pairs, H8*W8, 2) coords: 'uniform' over the map and 10 px beyond it
    ([-10, 74] at 64x64, as phase 3 draws them), 'local' the pixel grid +
    U(-2, 2)."""
    u = torch.empty((pairs, H8 * W8, 2), device=dev).uniform_(0.0, 1.0, generator=gen)
    if kind == "uniform":
        span = torch.tensor([W8 + 20.0, H8 + 20.0], device=dev)
        return (-10.0 + u * span).contiguous()
    ys, xs = torch.meshgrid(torch.arange(H8, device=dev), torch.arange(W8, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(1, H8 * W8, 2).float()
    return (grid + 4.0 * u - 2.0).contiguous()


def stored_volume(torch, tcorr, method, pyr):
    """The tagged volume of ``method`` from (B, P, h, w) levels ``pyr``; the
    int8 forms quantize them."""
    if method == "int8":
        return ("i8", *tcorr.quantize_pyramid(pyr))
    if method == "packed":
        return ("packed", *tcorr.pack_corr_pyramid(pyr))
    if method == "packed_i8":
        return ("packed_i8", *tcorr.pack_corr_pyramid_i8(pyr))
    return ("t", [lvl.movedim(1, 3).contiguous() for lvl in pyr])


def check_volume_kernels(torch, ops, dev, card):
    """K6-K9 against their plain versions at the 512x512 slice's shapes:
    B=7, P=4096, levels 64^2..8^2, r=4; 'packed' and 'pallas_t' in f32 and
    bf16, 'int8' and 'packed_i8' on the int8 quantization of a bf16 pyramid."""
    from mft_tpu_torch.models.raft import corr as tcorr
    gen = torch.Generator(device=dev).manual_seed(6)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("uniform", "local")}
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(dtype)
               for h, w in LEVELS]
        for method, kname in VOLUME_KERNEL_OF.items():
            if method in ("int8", "packed_i8") and dtype != torch.bfloat16:
                continue
            stored = stored_volume(torch, tcorr, method, pyr)
            itemsize = (stored[1][0] if method in ("int8", "pallas_t") else
                        stored[1]).element_size()
            scale_bytes = B * len(LEVELS) * 4 if itemsize == 1 else 0
            label = f"{kname} {'int8 of bfloat16' if itemsize == 1 else name}"
            for kind, c in coords.items():
                kernel = lambda: tcorr.corr_lookup(stored, c, RADIUS)
                plain = lambda: tcorr.corr_lookup(stored, c, RADIUS, plain=True)
                if method == "pallas_t":
                    ops.lane_major_staged_counts(reset=True)
                got = kernel()
                torch.cuda.synchronize()
                extra = ""
                if method == "pallas_t":
                    n_st, n_pp = ops.lane_major_staged_counts(reset=True)
                    extra = (f"; staged (group, level) union boxes {n_st}/{n_st + n_pp} "
                             f"({n_st / max(n_st + n_pp, 1):.2%}), the rest read per pixel")
                want = plain()
                err = max_err(got, want)
                ok = within(got, want, *VOLUME_TOL)
                extra = (f"; {differing(torch, got, want)} of {got.numel()} outputs differ "
                         f"from the plain version's bits") + extra   # not gated: 0 expected
                log(f"check {label} {kind}: max_abs_err {err:.3e} (tolerance atol "
                    f"{VOLUME_TOL[0]} + rtol {VOLUME_TOL[1]}) {'ok' if ok else 'FAIL'}{extra}")
                check(ok, f"{label} {kind} disagrees with its plain version")
                ms = graph_ms(kernel)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                nbytes = (window_tap_bytes(LEVELS, c, itemsize) + c.numel() * 4
                          + scale_bytes + got.numel() * got.element_size())
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                log(f"time {label} {kind}: kernel {ms:.4f} ms (graph replay), plain "
                    f"{plain_ms:.3f} ms, "
                    f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB) [{card}]")
                stats[(kname, name, kind)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                  bound_ms=bound, bound_by="bytes")
                if method in ("packed", "pallas_t"):
                    views = (tcorr.unpack_levels(stored[1], stored[2]) if method == "packed"
                             else [lvl.movedim(3, 1) for lvl in stored[1]])
                    lib_ms, lib = grid_sample_lookup(torch, views, c)
                    log(f"library {label} {kind}: F.grid_sample per level {lib_ms:.4f} ms "
                        f"(graph replay), "
                        f"max_abs_err to the plain version {max_err(lib, want):.3e} [{card}]")
                    stats[(kname, name, kind)]["library_ms"] = lib_ms
                del got, want
            del stored
        del pyr
    torch.cuda.empty_cache()
    return stats


# --------------------------------------------------------------------------- #
# phase 3d: the folded volume, the mixed lookup and the convolution
# --------------------------------------------------------------------------- #
# stated tolerances of phase 3d: the folded and mixed lookups and the float32
# product kernels do the plain versions' float ops in the same order (one
# ascending float32 sum per output; built with -fmad=false), so bit-identical
# results are required; the bfloat16 product kernels sum on the tensor cores
# in their own order and are held to ops.product_error_bound on every element
EXACT_TOL = (0.0, 0.0)
# the update block's convs at the 512x512 slice: name -> (Cout, Cin, kh, kw,
# act, launches per frame of 12 iterations); convc1 reaches the conv kernel
# on the last iteration only (K1 fuses it on the others)
CONV_SHAPES = {
    "convc1": (256, 324, 1, 1, "relu", 1), "convc2": (192, 256, 3, 3, "relu", 12),
    "convf2": (64, 128, 3, 3, "relu", 12), "conv": (126, 256, 3, 3, "relu", 12),
    "gru_zr1": (256, 384, 1, 5, None, 12), "gru_q1": (128, 384, 1, 5, None, 12),
    "gru_zr2": (256, 384, 5, 1, None, 12), "gru_q2": (128, 384, 5, 1, None, 12),
    "flow_head1": (256, 128, 3, 3, "relu", 12), "flow_head2": (2, 256, 3, 3, None, 12),
}


def exact_check(torch, label, got, want):
    err = max_err(got, want)
    ok = got.dtype == want.dtype and within(got, want, *EXACT_TOL)
    log(f"check {label}: max_abs_err {err:.3e} (tolerance atol {EXACT_TOL[0]} + rtol "
        f"{EXACT_TOL[1]}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label} disagrees with its plain version")
    return err


def bound_check(torch, ops, label, got, want, magnitude, K, scale=1.0):
    """|got - want| <= K*2^-22*S*scale + 2^-7*|want| on every element
    (ops.product_error_bound); logs the largest ratio to the bound.
    returns: (max_abs_err, largest ratio)."""
    bound = ops.product_error_bound(want, magnitude, K, scale)
    diff = (got.float() - want.float()).abs()
    ratio = float((diff / bound.clamp_min(1e-30)).max())
    ok = got.dtype == want.dtype and got.shape == want.shape and bool((diff <= bound).all())
    err = float(diff.max())
    log(f"check {label}: max_abs_err {err:.3e}, largest |got - want| / bound {ratio:.4f} "
        f"(bound K*2^-22*S*scale + 2^-7*|want|, K {K}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label} exceeds its error bound against the plain version")
    return err, ratio


def check_fold_kernels(torch, ops, dev, card):
    """#5 (corr_build_folded), #4 (corr_lookup_folded) and #9
    (corr_lookup_mixed) against their plain versions at the 512x512 slice's
    shapes: features (7, 256, 64, 64), levels 64^2..8^2, r=4, in f32 and
    bf16, the lookups on uniform and local coordinates. The bf16 build runs on
    the tensor cores and is held to the error bound, the rest bit for bit."""
    from mft_tpu_torch.models.raft import corr as tcorr
    from mft_tpu_torch.ops.corr_lookup import unfold_levels
    gen = torch.Generator(device=dev).manual_seed(8)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("uniform", "local")}
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        f1 = torch.randn((B, FEAT_C, 64, 64), device=dev, generator=gen).to(dtype)
        f2 = torch.randn((B, FEAT_C, 64, 64), device=dev, generator=gen).to(dtype)
        build = lambda: tcorr.build_corr_pyramid_folded(f1, f2, len(LEVELS))
        plain = lambda: tcorr.build_corr_pyramid_folded(f1, f2, len(LEVELS), plain=True)
        (levels, dims), (want, _) = build(), plain()
        torch.cuda.synchronize()
        # inputs of the kernel: f1 (B, C, P) and the zero-padded pooled levels
        f1r, f2l, _ = tcorr.folded_operands(f1, f2, len(LEVELS))
        ratio = None
        if dtype == torch.bfloat16:
            mags = ops.corr_build_folded_magnitude(f1r, f2l)
            checked = [bound_check(torch, ops, f"corr_build_folded {name} level {l}", g, w,
                                   mags[l], FEAT_C, 1.0 / math.sqrt(FEAT_C))
                       for l, (g, w) in enumerate(zip(levels, want))]
            err, ratio = max(e for e, _ in checked), max(r for _, r in checked)
            del mags
        else:
            err = max(exact_check(torch, f"corr_build_folded {name} level {l}", g, w)
                      for l, (g, w) in enumerate(zip(levels, want)))
        del want
        kernel = lambda: ops.corr_build_folded(f1r, f2l)
        ms = graph_ms(kernel)
        plain_ms = cuda_ms(lambda: ops.corr_build_folded_ref(f1r, f2l), reps=1, warmup=0)
        f2cat = torch.cat(f2l, dim=2)
        zero = f1.new_zeros(())
        f1t = f1r.transpose(1, 2)
        scale = 1.0 / math.sqrt(FEAT_C)
        lib_ms = graph_ms(lambda: torch.baddbmm(zero, f1t, f2cat, beta=0.0, alpha=scale))
        es = f1.element_size()
        q = f2cat.shape[2]
        nbytes = (f1r.numel() + f2cat.numel() + B * P * q) * es
        ops_n = 2 * B * P * q * FEAT_C
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_n / PEAK_OPS_PER_S[name] * 1e3
        log(f"time corr_build_folded {name}: kernel {ms:.4f} ms "
            f"({ops_n / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s), plain "
            f"{plain_ms:.3f} ms, torch.baddbmm {lib_ms:.4f} ms, bound "
            f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB, {ops_n / 1e9:.2f} GFLOP) "
            f"[{card}]")
        stats[("corr_build_folded", name)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=lib_ms)
        if ratio is not None:
            stats[("corr_build_folded", name)]["bound_ratio"] = ratio
        del f2cat, f1t, f2l
        mixed = tcorr.build_corr_pyramid_mixed(f1, f2, len(LEVELS))
        log(f"mixed {name}: folded levels {[tuple(a.shape) for a in mixed[1]]}, plain "
            f"levels {[tuple(a.shape) for a in mixed[3]]}")
        forms = {"corr_lookup_folded": ("fold", levels, dims), "corr_lookup_mixed": mixed}
        views = {"corr_lookup_folded": unfold_levels(levels, dims),
                 "corr_lookup_mixed": unfold_levels(mixed[1], mixed[2]) + list(mixed[3])}
        for kname, stored in forms.items():
            for kind, c in coords.items():
                kernel = lambda: tcorr.corr_lookup(stored, c, RADIUS)
                plain = lambda: tcorr.corr_lookup(stored, c, RADIUS, plain=True)
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                err = exact_check(torch, f"{kname} {name} {kind}", got, want)
                n_diff = differing(torch, got, want)
                log(f"check {kname} {name} {kind}: {n_diff} of {got.numel()} outputs differ "
                    f"from the plain version's bits")
                ms = graph_ms(kernel)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                lib_ms, lib = grid_sample_lookup(torch, views[kname], c)
                nbytes = (window_tap_bytes(LEVELS, c, es) + c.numel() * 4
                          + got.numel() * got.element_size())
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                log(f"time {kname} {name} {kind}: kernel {ms:.4f} ms (graph replay), plain "
                    f"{plain_ms:.3f} ms, F.grid_sample per level {lib_ms:.4f} ms (max_abs_err "
                    f"{max_err(lib, want):.3e}), bound {bound:.4f} ms "
                    f"({nbytes / 1e6:.1f} MB) [{card}]")
                stats[(kname, name, kind)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes", library_ms=lib_ms, outputs_differing=n_diff)
                del got, want, lib
        del levels, mixed, views, forms, f1, f2, f1r
        torch.cuda.empty_cache()
    return stats


def conv_inputs(torch, dev, gen, dtype, Cout, Cin, kh, kw):
    """x (7, Cin, 64, 64) (channel-last in memory for the 1x1 convc1, which
    reads the lookup's samples so), nn.Conv2d-like weights and bias."""
    x = torch.randn((B, 64, 64, Cin) if kh == kw == 1 else (B, Cin, 64, 64),
                    device=dev, generator=gen).to(dtype)
    if kh == kw == 1:
        x = x.permute(0, 3, 1, 2)
    w = (torch.randn((Cout, Cin, kh, kw), device=dev, generator=gen)
         / math.sqrt(Cin * kh * kw)).to(dtype)
    bias = (0.1 * torch.randn((Cout,), device=dev, generator=gen)).to(dtype)
    return x, w, bias, ((kh // 2, kh // 2), (kw // 2, kw // 2))


def conv_check(torch, ops, label, x, w, bias, pad, act):
    """The conv kernel against its plain version: bf16 (tensor cores) within
    the error bound, f32 bit for bit. returns: (kernel output, max_abs_err,
    largest ratio to the bound or 0.0)."""
    got = ops.conv_pallas(x, w, bias, pad, act=act)
    torch.cuda.synchronize()
    want = ops.conv_pallas_ref(x, w, bias, pad, act=act)
    if x.dtype == torch.float32:
        return got, exact_check(torch, label, got, want), 0.0
    K = w.shape[1] * w.shape[2] * w.shape[3]
    err, ratio = bound_check(torch, ops, label, got, want,
                             ops.conv_pallas_magnitude(x, w, pad), K)
    return got, err, ratio


def check_conv_kernel(torch, ops, dev, card):
    """#13 (conv_pallas) against its plain version at every conv shape of
    the 512x512 frame (7 images of 64x64) in bf16 (tensor cores, within the
    error bound) and f32 (bit for bit), and each act; timed in bf16 beside
    F.conv2d (cuDNN, TF32 off), both by CUDA graph replay (device time; the
    wrapper's host work would otherwise set the time of the small convs).
    returns: per-shape stats and their means over one frame's 109 launches."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(9)
    per_shape, frame = {}, dict(n=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                                max_abs_err=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ratio=0.0)
    for cname, (Cout, Cin, kh, kw, act, n) in CONV_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x, w, bias, pad = conv_inputs(torch, dev, gen, dtype, Cout, Cin, kh, kw)
            kernel = lambda: ops.conv_pallas(x, w, bias, pad, act=act)
            plain = lambda: ops.conv_pallas_ref(x, w, bias, pad, act=act)
            got, err, ratio = conv_check(torch, ops, f"conv_pallas {cname} {Cin}->{Cout} "
                                                     f"{kh}x{kw} act {act} {name}",
                                         x, w, bias, pad, act)
            frame["max_abs_err"] = max(frame["max_abs_err"], err)
            frame["bound_ratio"] = max(frame["bound_ratio"], ratio)
            if dtype == torch.float32:
                continue
            ms = graph_ms(kernel)
            plain_ms = cuda_ms(plain, reps=1, warmup=0)
            lib = lambda: F.conv2d(x, w, bias, padding=(kh // 2, kw // 2))
            lib_ms = graph_ms(lib)
            es = x.element_size()
            nbytes = (x.numel() + w.numel() + got.numel()) * es + Cout * 4
            ops_n = 2 * B * 64 * 64 * Cout * Cin * kh * kw
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops_n / PEAK_OPS_PER_S[name] * 1e3
            log(f"time conv_pallas {cname} bfloat16 ({n}/frame): kernel {ms:.4f} ms "
                f"({ops_n / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, F.conv2d "
                f"{lib_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
                f"({nbytes / 1e6:.1f} MB, {ops_n / 1e9:.2f} GFLOP) [{card}]")
            per_shape[cname] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                    bound_ms=max(bytes_ms, ops_ms), launches=n,
                                    tflops=ops_n / ms / 1e9, bound_ratio=ratio)
            frame["n"] += n
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bound_ms", max(bytes_ms, ops_ms)), ("bytes_ms", bytes_ms),
                           ("ops_ms", ops_ms)):
                frame[key] += n * v
        del x, w, bias, got
    # each activation on one shape (the GRU's 1x5 q conv), both dtypes
    for act in ("relu", "sigmoid", "tanh"):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, bias, pad = conv_inputs(torch, dev, gen, dtype, 128, 384, 1, 5)
            _, err, ratio = conv_check(torch, ops, f"conv_pallas gru_q1 act {act} "
                                                   f"{str(dtype).split('.')[1]}",
                                       x, w, bias, pad, act)
            frame["max_abs_err"] = max(frame["max_abs_err"], err)
            frame["bound_ratio"] = max(frame["bound_ratio"], ratio)
    torch.cuda.empty_cache()
    n = frame.pop("n")
    log(f"conv_pallas over one frame ({n} launches, bf16): kernel {frame['ms']:.3f} ms, "
        f"plain {frame['plain_ms']:.3f} ms, F.conv2d {frame['library_ms']:.3f} ms, "
        f"bound {frame['bound_ms']:.3f} ms [{card}]")
    bytes_ms, ops_ms = frame.pop("bytes_ms"), frame.pop("ops_ms")
    mean = {k: (v / n if k not in ("max_abs_err", "bound_ratio") else v)
            for k, v in frame.items()}
    mean["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return mean, per_shape


# --------------------------------------------------------------------------- #
# phase 3e: the bilinear warp (#14-#16)
# --------------------------------------------------------------------------- #
# label -> (JAX entry point, mode, N, H, W, C): 'tpu' maps in bf16 (the
# chain_select_pallas maps), 'exact' maps in f32 (a packed FlowOU)
WARP_SHAPES = {
    "blocked 7x512x512x6": ("bilinear_warp_blocked", "tpu", 7, 512, 512, 6),
    "banded 7x512x480x6": ("bilinear_warp_banded", "tpu", 7, 512, 480, 6),
    "pallas 7x1080x1920x6": ("bilinear_warp_pallas", "tpu", 7, 1080, 1920, 6),
    "tiled 7x512x512x6": ("bilinear_warp_tiled", "tpu", 7, 512, 512, 6),
    "exact 1x512x512x4": ("bilinear_warp_pallas", "exact", 1, 512, 512, 4),
    "exact 1x2160x3840x4": ("bilinear_warp_pallas", "exact", 1, 2160, 3840, 4),
}


def warp_coords(torch, dev, gen, N, H, W):
    """(N, H*W, 2) raster coordinates: the grid plus a smooth flow of up to
    ~20 px (shifted by 1.25 px per image), except a band of rows at random
    positions up to 40 px beyond the map and a band at half-integer shifts
    and odd multiples of 1/512 px (where the snap rounds half to even)."""
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    fx = 12.0 * torch.sin(ys / 37.0) + 5.0 * torch.cos(xs / 23.0)
    fy = 9.0 * torch.cos(xs / 41.0) - 4.0 * torch.sin(ys / 19.0)
    shift = 1.25 * torch.arange(N, device=dev, dtype=torch.float32)[:, None, None, None]
    c = torch.stack([xs + fx, ys + fy], dim=-1)[None] + shift          # (N, H, W, 2)
    band = max(H // 16, 1)
    u = torch.rand((N, band, W, 2), device=dev, generator=gen)
    c[:, :band] = u * torch.tensor([W + 80.0, H + 80.0], device=dev) - 40.0
    g = torch.stack([xs, ys], dim=-1)[band:2 * band]
    half = torch.randint(-6, 7, (N, band, W, 2), device=dev, generator=gen) * 0.5
    odd = (torch.randint(-3, 4, (N, band, W, 2), device=dev, generator=gen)
           + (2 * torch.randint(0, 256, (N, band, W, 2), device=dev, generator=gen) + 1)
           / 512.0)
    pick = torch.rand((N, band, W, 1), device=dev, generator=gen) < 0.5
    c[:, band:2 * band] = g + torch.where(pick, half, odd)
    return c.reshape(N, H * W, 2).contiguous()


def check_warp_kernel(torch, ops, dev, card):
    """mft_warp against its plain version at WARP_SHAPES, through the JAX
    entry point whose kernel JAX runs at that shape; timed (device time, by
    graph replay) beside F.grid_sample on the same maps (bf16 values as f32
    for 'tpu') at the coordinates the kernel samples (snapped for 'tpu')."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(10)
    stats = {}
    for label, (entry, mode, N, H, W, C) in WARP_SHAPES.items():
        dtype = torch.bfloat16 if mode == "tpu" else torch.float32
        maps = (4.0 * torch.randn((N, H, W, C), device=dev, generator=gen)).to(dtype)
        coords = warp_coords(torch, dev, gen, N, H, W)
        planar = entry == "bilinear_warp_tiled"
        fn = getattr(ops, entry)
        if planar:
            sx = coords[..., 0].reshape(N, H, W).contiguous()
            sy = coords[..., 1].reshape(N, H, W).contiguous()
            kernel = lambda: fn(maps, sx, sy)          # C planes, written in place
        elif mode == "exact":
            kernel = lambda: fn(maps, coords, dot_dtype=torch.float32, snap=False)
        else:
            kernel = lambda: fn(maps, coords)
        plain = lambda: ops.bilinear_warp_ref(maps, coords, mode, planar)
        got = kernel()
        got = torch.stack(got).reshape(C, N, H * W) if planar else got
        torch.cuda.synchronize()
        want = plain()
        err = exact_check(torch, f"bilinear_warp {label} ({entry}, {mode})", got, want)
        call_ms = cuda_ms(kernel, reps=20)     # with the wrapper's host cost
        ms = graph_ms(kernel)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        # library yardstick: one F.grid_sample on (N, C, H, W) float32 maps
        snapped = ops.snap256(coords) if mode == "tpu" else coords
        grid = torch.stack([2.0 * snapped[..., 0] / (W - 1) - 1.0,
                            2.0 * snapped[..., 1] / (H - 1) - 1.0], dim=-1)[:, None]
        nchw = maps.float().permute(0, 3, 1, 2).contiguous()
        lib = lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                                    align_corners=True)
        lib_ms = graph_ms(lib)
        lib_err = max_err(lib()[:, :, 0].permute(0, 2, 1),
                          want.permute(1, 2, 0) if planar else want)
        P = H * W
        nbytes = maps.numel() * maps.element_size() + coords.numel() * 4 + N * P * C * 4
        ops_n = N * P * (9 * C + 20)   # per channel 6 row + 3 column ops; weights
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_n / PEAK_OPS_PER_S["float32"] * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"time bilinear_warp {label}: kernel {ms:.4f} ms (graph replay; {call_ms:.4f} "
            f"ms a call from Python), plain {plain_ms:.3f} ms, "
            f"F.grid_sample {lib_ms:.4f} ms (graph replay; max_abs_err to the plain version "
            f"{lib_err:.3e}), bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB, "
            f"{ops_n / 1e9:.2f} GFLOP) [{card}]")
        stats[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                            library_ms=lib_ms)
        del maps, coords, got, want, grid, nchw
        torch.cuda.empty_cache()
    return stats


# --------------------------------------------------------------------------- #
# phases 4-5: the main path
# --------------------------------------------------------------------------- #
def synthetic_clip(n_frames, H=512, W=512, seed=0, shift=SHIFT):
    """uint8 BGR frames of one multi-scale random texture, shifted by
    ``shift`` px per frame (true flow from frame 0 to frame k: -k*shift)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    rng = np.random.default_rng(seed)
    dx, dy = shift
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


def check_results(torch, results, H, W, label):
    """Shapes, finiteness and ranges of tracked FlowOU results."""
    for k, r in enumerate(results, start=1):
        check(tuple(r.flow.shape) == (H, W, 2) and tuple(r.occlusion.shape) == (H, W)
              and tuple(r.sigma.shape) == (H, W), f"{label} frame {k}: wrong shapes")
        check(bool(torch.isfinite(r.flow).all() and torch.isfinite(r.occlusion).all()
                   and torch.isfinite(r.sigma).all()), f"{label} frame {k}: non-finite output")
        check(bool(((r.occlusion >= 0) & (r.occlusion <= 1)).all()),
              f"{label} frame {k}: occlusion outside [0, 1]")
        check(bool((r.sigma > 0).all()), f"{label} frame {k}: sigma not > 0")


def median_after_warmup(frame_ms):
    steady = sorted(frame_ms[WARMUP:])
    return steady[len(steady) // 2] if len(steady) % 2 else 0.5 * (
        steady[len(steady) // 2 - 1] + steady[len(steady) // 2])


def track_frames(torch, tracker, frames):
    """init on frames[0], track the rest; (results, host ms per tracked frame)."""
    tracker.init(frames[0])
    frame_ms, results = [], []
    for img in frames[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        results.append(tracker.track(img).result)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    return results, frame_ms


def frame_gap(a, b):
    """Per-pixel differences of two FlowOU results of one frame."""
    dflow = (a.flow - b.flow).norm(dim=-1)
    docc = (a.occlusion - b.occlusion).abs()
    dsig = (a.sigma - b.sigma).abs() / b.sigma
    return dflow, docc, dsig


def gap_stats(a, b):
    """The frame gate's numbers for two FlowOU results of one frame."""
    dflow, docc, dsig = frame_gap(a, b)
    return dict(median=float(dflow.median()), max=float(dflow.max()),
                far=float((dflow > 0.5).float().mean()), occ_max=float(docc.max()),
                occ=float((docc > 0.05).float().mean()),
                sig=float((dsig > 0.05).float().mean()))


def gap_text(g):
    return (f"flow |d| median {g['median']:.3e} px, max {g['max']:.3e} px, share > 0.5 px "
            f"{g['far']:.4%}; occlusion |d| max {g['occ_max']:.3e}, share > 0.05 "
            f"{g['occ']:.4%}; sigma rel |d| share > 5% {g['sig']:.4%}")


# paths whose bf16 products run on the tensor cores: their frame is held
# against the plain versions relative to the volume path's gap (cuBLAS volume,
# cuDNN convs, TF32 off) to the same plain frame, since any re-ordered bf16
# sum already sits at the absolute line with random weights
RELATIVE_GATE = ("fold", "conv pallas")
RELATIVE_FACTOR = 1.5
RELATIVE_CEILING = dict(median=0.15, far=0.03)


def check_kernels_vs_plain(torch, tracker, nxt, label, volume_tracker=None):
    """The same next frame through the kernels and through the plain versions
    (``plain_ops``), from the same tracker state. With ``volume_tracker`` the
    gate is relative: gap(kernels, plain) <= 1.5 x gap(volume path, plain) in
    median, share over 0.5 px, occlusion and sigma shares, and median <=
    0.15 px, share over 0.5 px <= 3%; else the absolute gate."""
    snap = snapshot(tracker)
    a = tracker.track(nxt).result
    restore(tracker, snap)
    tracker.plain_ops = True
    b = tracker.track(nxt).result
    tracker.plain_ops = False
    restore(tracker, snap)
    torch.cuda.synchronize()
    g = gap_stats(a, b)
    if volume_tracker is None:
        # stated tolerance: bf16 rounding differences (the fused product's sum
        # order) may move a few pixels' selection; the bulk must agree
        ok = g["far"] <= 0.01 and g["median"] <= 0.05 and g["occ"] <= 0.01 and g["sig"] <= 0.01
        log(f"check {label} kernels vs plain, one frame: {gap_text(g)} (tolerance: share > "
            f"0.5 px <= 1%, median <= 0.05 px, occlusion/sigma shares <= 1%) "
            f"{'ok' if ok else 'FAIL'}")
    else:
        restore(volume_tracker, snap)
        v = volume_tracker.track(nxt).result
        torch.cuda.synchronize()
        gv = gap_stats(v, b)
        keys = ("median", "far", "occ", "sig")
        ok = (all(g[k] <= RELATIVE_FACTOR * gv[k] for k in keys)
              and all(g[k] <= c for k, c in RELATIVE_CEILING.items()))
        log(f"check {label} kernels vs plain, one frame: {gap_text(g)}; volume path vs plain, "
            f"same frame: {gap_text(gv)} (tolerance: median, share > 0.5 px, occlusion and "
            f"sigma shares <= {RELATIVE_FACTOR} x the volume path's; median <= "
            f"{RELATIVE_CEILING['median']} px, share > 0.5 px <= "
            f"{RELATIVE_CEILING['far']:.0%}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the path with kernels disagrees with the plain versions")


def check_tensor_cores(ops, label):
    """Every launch in this run (a bf16 model) of the kernels with a
    tensor-core path (#5, #13, K1, K4, K5) went through it."""
    counts, tc = ops.launch_counts(), ops.tensor_core_launch_counts()
    check(all(tc[k] == counts[k] for k in tc),
          f"{label}: tensor-core launches {tc} != launches "
          f"{ {k: counts[k] for k in tc} } of the bf16 kernels")


def check_sass(_build, path):
    """The tensor-core kernels' machine code holds wgmma (HGMMA): #5, #13,
    the bf16 fused lookup K1 and the bf16 window correlations K4/K5, in every
    instance."""
    from pathlib import Path
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    functions = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        functions[name.strip()] = body.count("HGMMA")
    for kernel in ("build_folded_tc_kernel", "conv_tc_kernel", "lookup_conv_tc_kernel",
                   "window_tc_kernel"):
        found = {n: c for n, c in functions.items() if kernel in n}
        log(f"sass {kernel}: {len(found)} instances, HGMMA per instance "
            f"{sorted(found.values())}")
        check(bool(found) and all(found.values()),
              f"{kernel}: no HGMMA in the SASS of some instance ({found})")


# kernel -> instances that ptxas must give a 0-byte stack frame and no
# spills: the staged gather (radius 1..4 x K2, #4, #9 and K7 in f32 and bf16,
# K6 and K8 on int8), the fused lookup K1 (radius 1..4; f32 and, on the tensor
# cores, bf16), the warp (f32, bf16 maps x 4 modes x C of 1, 2, 4, 6 and any
# other), the bf16 window correlations K4/K5 (one instance for both entry
# points), the lane-major lookup K9 (radius 1..4 x f32, bf16), chain +
# select K3 (1..8 candidates and any other count, x one clip or a clip axis)
# and the lookup's backward (radius 1..4 x f32, bf16)
FRAME_CHECKED = {"corr_gather_kernel": 12, "lookup_conv_kernel": 4,
                 "lookup_conv_tc_kernel": 4, "warp_kernel": 40, "window_tc_kernel": 1,
                 "lane_group_kernel": 8, "chain_select_kernel": 9,
                 "corr_lookup_bwd_kernel": 8}


def check_frames(_build, kernel, instances):
    """ptxas (``-Xptxas=-v`` in ``_build.build_log``) gives every instance of
    ``kernel`` a 0-byte stack frame and no spills."""
    import re
    lines = _build.build_log.splitlines()
    found = {}
    for k, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m and kernel in m.group(1):
            nums = None
            for nxt in lines[k + 1:k + 4]:   # the function's properties line
                nums = nums or re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                         r"stores, (\d+) bytes spill loads", nxt)
            found[m.group(1)] = tuple(map(int, nums.groups())) if nums else None
    log(f"ptxas {kernel}: {len(found)} instances, (stack frame, spill stores, spill "
        f"loads) bytes {sorted(set(found.values()), key=str)}")
    check(len(found) == instances and all(v == (0, 0, 0) for v in found.values()),
          f"{kernel}: want {instances} instances with 0-byte stack frames and no "
          f"spills, ptxas says {found}")


def expected_counts(ops, **counts):
    want = {name: 0 for name in ops.launch_counts()}
    want.update(counts)
    return want


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
    results, frame_ms = track_frames(torch, tracker, frames[:FRAMES + 1])
    counts = ops.launch_counts()

    log(f"launches over {FRAMES} tracked frames: {counts}")
    want = expected_counts(ops, corr_lookup_fused=FRAMES * (iters - 1),
                           corr_lookup=FRAMES, chain_select=FRAMES)
    check(counts == want, f"launch counts {counts} != {want} "
                          f"(11, 1 and 1 per tracked frame)")
    check_tensor_cores(ops, "main path")
    H, W = frames[0].shape[:2]
    check_results(torch, results, H, W, "main path")
    last = results[-1]
    log(f"frame {FRAMES}: mean flow ({float(last.flow[..., 0].mean()):.3f}, "
        f"{float(last.flow[..., 1].mean()):.3f}) px (random weights; true "
        f"{-FRAMES * SHIFT[0]}, {-FRAMES * SHIFT[1]}), mean occlusion "
        f"{float(last.occlusion.mean()):.4f}, mean sigma {float(last.sigma.mean()):.4f}")
    median = median_after_warmup(frame_ms)
    log(f"frame ms: {', '.join(f'{m:.2f}' for m in frame_ms)}")
    log(f"frame ms median after {WARMUP} warm-up frames: {median:.3f} ms "
        f"({1e3 / median:.2f} frames/s) [{card}]")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # phase 5: the same next frame through the kernels and the plain versions
    t5 = time.perf_counter()
    check_kernels_vs_plain(torch, tracker, frames[FRAMES + 1], "main path")
    log(f"phase 5 seconds {time.perf_counter() - t5:.2f}")
    return counts, median, tracker, results, frames[FRAMES + 1]


# --------------------------------------------------------------------------- #
# phase 11: point tracking, chain_results and the TPU-form chain + select
# --------------------------------------------------------------------------- #
def demo_queries(H, W, spacing=30):
    """The demo's query grid (mft_tpu/apps/demo.py get_queries): every
    ``spacing`` px from spacing // 2; 289 points at 512x512."""
    import numpy as np
    xs = np.arange(spacing // 2, W, spacing, dtype=np.float32)
    ys = np.arange(spacing // 2, H, spacing, dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    return np.stack([xg.reshape(-1), yg.reshape(-1)], axis=1)


def outputs(out):
    """The tensors of a FlowOU, or of a tuple of tensors or numpy arrays."""
    import torch
    if hasattr(out, "flow"):
        return [out.flow, out.occlusion, out.sigma]
    return [torch.as_tensor(o) for o in out]


def slice_call(torch, ops, label, call, launches, card):
    """``call(plain)`` through the kernel, with the launch counts set to 0
    just before it and read just after (``launches`` of the warp and no other
    kernel), then through the plain versions: identical outputs required.
    returns: (warp launches, the kernel run's result)."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = call(False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    counts = ops.launch_counts()
    want_counts = expected_counts(ops, bilinear_warp=launches)
    check(counts == want_counts, f"{label}: launch counts {counts} != {want_counts}")
    want = call(True)
    pairs = list(zip(outputs(got), outputs(want)))
    ok = all(g.shape == w.shape and bool(torch.isfinite(g.float()).all()) for g, w in pairs)
    err = max(max_err(g, w) for g, w in pairs)
    ok = ok and err == 0.0
    log(f"check {label}: {launches} warp launch(es), host {ms:.3f} ms, max_abs_err to the "
        f"plain versions {err:.3e} (tolerance 0) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"{label} disagrees with its plain versions")
    return counts["bilinear_warp"], got


def chain_select_pallas_on(torch, ops, card, tracker, img, label):
    """The TPU-form chain + select on the candidates of the tracker's next
    frame ``img``, kernel against plain; its gap to K3's exact chain + select
    is printed, not gated. returns: warp launches."""
    from mft_tpu_torch.tracker.fused import chain_select, chain_select_pallas
    t = tracker.current_frame_i + tracker.time_direction
    left, right, valid, _ = tracker.pairs(tracker._to_device(img), t)
    thr = tracker.occlusion_threshold
    n, got = slice_call(torch, ops, f"chain_select_pallas {label} ({len(valid)} candidates)",
                        lambda plain: chain_select_pallas(left, right, valid, thr, plain=plain),
                        1, card)
    H, W = got.occlusion.shape
    check_results(torch, [got], H, W, f"chain_select_pallas {label}")
    dflow, docc, dsig = frame_gap(got, chain_select(left, right, valid, thr))
    log(f"chain_select_pallas {label} vs K3's exact chain + select (not gated): flow |d| "
        f"median {float(dflow.median()):.3e} px, mean {float(dflow.mean()):.3e} px, max "
        f"{float(dflow.max()):.3e} px, share > 0.5 px {float((dflow > 0.5).float().mean()):.4%}; "
        f"occlusion |d| max {float(docc.max()):.3e}; sigma rel |d| share > 5% "
        f"{float((dsig > 0.05).float().mean()):.4%}")
    return n


def run_slice_path(torch, ops, card, tracker, results, nxt):
    """Phase 11 on the main path's tracked results; returns warp launches."""
    import numpy as np
    from mft_tpu_torch.core.flowou import chain_results, chain_results_packed
    from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking_batch
    H, W = results[0].occlusion.shape
    T = len(results)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    every = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)
    n = 0
    for name, q in (("the demo's grid", demo_queries(H, W)), ("every pixel", every)):
        k, (coords, occl) = slice_call(
            torch, ops, f"convert_to_point_tracking_batch, {T} results x {len(q)} queries "
                        f"({name})",
            lambda plain: convert_to_point_tracking_batch(results, q, plain=plain), 1, card)
        check(coords.shape == (T, len(q), 2) and occl.shape == (T, len(q))
              and occl.dtype == np.float32, f"point tracks of {name}: wrong shapes")
        log(f"point tracks ({name}): frame {T} mean displacement "
            f"{(coords[-1] - q).mean(axis=0).round(3).tolist()} px, mean occlusion "
            f"{float(occl[-1].mean()):.4f}")
        n += k
    k, chained = slice_call(torch, ops, "chain_results of frames 1 and 2",
                            lambda plain: chain_results(results[0], results[1], plain), 3, card)
    n += k
    k, packed = slice_call(torch, ops, "chain_results_packed of frames 1 and 2",
                           lambda plain: chain_results_packed(results[0], results[1], plain),
                           1, card)
    n += k
    check_results(torch, [chained], H, W, "chain_results")
    check(all(torch.equal(a, b) for a, b in zip(outputs(chained), outputs(packed))),
          "chain_results_packed differs from chain_results")
    n += chain_select_pallas_on(torch, ops, card, tracker, nxt, f"{H}x{W}")
    return n


# --------------------------------------------------------------------------- #
# phases 6-8: the other corr_methods at 512x512, 'alt' and 'win' at 2160x3840
# --------------------------------------------------------------------------- #
KERNEL_OF = {"alt": "corr_lookup_alt", "win": "corr_lookup_win", **VOLUME_KERNEL_OF,
             "fold": "corr_lookup_folded", "mixed": "corr_lookup_mixed"}
NEW_PATHS = ("fold", "mixed", "conv pallas")   # phase 10


def method_config(method):
    """default_config() with corr_method ``method``, or with conv_backend
    'pallas' for ``method`` 'conv pallas'."""
    from mft_tpu_torch.config import default_config
    cfg = default_config()
    if method == "conv pallas":
        cfg.flow_config.raft_params["conv_backend"] = "pallas"
    else:
        cfg.flow_config.raft_params["corr_method"] = method
    return cfg


def path_per_frame(method, iters):
    """Kernel launches per tracked frame of each path besides chain + select:
    the volume forms and feature lookups launch their lookup on every
    iteration, 'fold' also its build once; conv_backend 'pallas' runs the
    default lookups (the fused one on iterations 1..iters-1) and 9 convs an
    iteration plus convc1 on the last one."""
    if method == "conv pallas":
        return dict(corr_lookup_fused=iters - 1, corr_lookup=1, conv_pallas=9 * iters + 1)
    if method == "fold":
        return dict(corr_build_folded=1, corr_lookup_folded=iters)
    return {KERNEL_OF[method]: iters}


def run_method_path(torch, ops, dev, card, method, volume_tracker, volume_median):
    """Phases 6, 8 and 10: the default tracker at 512x512 with corr_method
    ``method``, or with conv_backend 'pallas' for ``method`` 'conv pallas'."""
    from mft_tpu_torch.tracker import MFT
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = method_config(method)
    tracker = MFT(cfg, device=dev)
    iters = tracker.flower.iters
    frames = synthetic_clip(FEATURE_FRAMES + 1)
    ops.reset_launch_counts()
    if method == "pallas_t":
        ops.lane_major_staged_counts(reset=True)
    results, frame_ms = track_frames(torch, tracker, frames[:FEATURE_FRAMES + 1])
    counts = ops.launch_counts()
    if method == "pallas_t":
        n_st, n_pp = ops.lane_major_staged_counts(reset=True)
        log(f"pallas_t: staged (group, level) union boxes over the tracked frames "
            f"{n_st}/{n_st + n_pp} ({n_st / max(n_st + n_pp, 1):.2%}); the rest read their "
            f"taps per pixel")
    peak = torch.cuda.max_memory_allocated()
    log(f"{method}: launches over {FEATURE_FRAMES} tracked frames: {counts}")
    per_frame = path_per_frame(method, iters)
    want = expected_counts(ops, **{k: FEATURE_FRAMES * v for k, v in per_frame.items()},
                           chain_select=FEATURE_FRAMES)
    check(counts == want, f"{method}: launch counts {counts} != {want} "
                          f"({per_frame} and 1 chain + select per tracked frame)")
    check_tensor_cores(ops, method)
    log(f"{method}: tensor-core launches {ops.tensor_core_launch_counts()}")
    H, W = frames[0].shape[:2]
    check_results(torch, results, H, W, method)
    median = median_after_warmup(frame_ms)
    log(f"{method} frame ms: {', '.join(f'{m:.2f}' for m in frame_ms)}")
    log(f"{method} frame ms median after {WARMUP} warm-up frames: {median:.3f} ms, "
        f"volume path (phase 4, same run) {volume_median:.3f} ms [{card}]")
    log(f"{method} peak device memory {peak / 1e9:.3f} GB, {(peak - held) / 1e9:.3f} GB "
        f"above the {held / 1e9:.3f} GB held before (the volume path's tracker)")
    check_kernels_vs_plain(torch, tracker, frames[FEATURE_FRAMES + 1], method,
                           volume_tracker if method in RELATIVE_GATE else None)

    # not gated: the volume path on the same inputs. In bf16 the volume is
    # rounded before it is sampled, the feature lookups round the samples;
    # the product kernels sum in another order than cuBLAS and cuDNN.
    snap = snapshot(tracker)
    a = tracker.track(frames[FEATURE_FRAMES + 1]).result
    restore(volume_tracker, snap)
    b = volume_tracker.track(frames[FEATURE_FRAMES + 1]).result
    torch.cuda.synchronize()
    dflow, docc, dsig = frame_gap(a, b)
    log(f"{method} vs volume path, one frame (not gated): flow |d| median "
        f"{float(dflow.median()):.3e} px, mean {float(dflow.mean()):.3e} px, max "
        f"{float(dflow.max()):.3e} px, share > 0.5 px {float((dflow > 0.5).float().mean()):.4%}; "
        f"occlusion |d| max {float(docc.max()):.3e}; sigma rel |d| share > 5% "
        f"{float((dsig > 0.05).float().mean()):.4%}")
    return counts


def volume_bytes(H8, W8, pairs=7, levels=4, itemsize=2):
    """Bytes of the bf16 all-pairs pyramid of ``pairs`` pairs (floor pooling)."""
    total, h, w = 0, H8, W8
    for _ in range(levels):
        total += h * w
        h, w = h // 2, w // 2
    return pairs * H8 * W8 * total * itemsize


def check_kernels_uhd(torch, ops, dev, card, H8, W8, n_sample=4096):
    """K4 and K5 (bf16, the tensor-core tile product) on a whole (7, H8*W8)
    call, held to the bound against the plain version on ``n_sample``
    sampled pixels of each pair, the outputs differing from the plain
    version's counted; K3 on 7 candidates at the frame size against its
    plain version at every pixel."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for kind in ("local", "wild"):
        f1, pyr, coords = feature_inputs(torch, dev, torch.bfloat16, kind, H8, W8, seed=4)
        idx = torch.randperm(H8 * W8, device=dev, generator=gen)[:n_sample]
        f1s, cs = f1.reshape(B, H8 * W8, -1)[:, idx], coords[:, idx].contiguous()
        want = ops.corr_lookup_alt_ref(f1s, pyr, cs, RADIUS)
        mag = ops.corr_window_magnitude(f1s, pyr, cs, RADIUS)
        for kname in ("corr_lookup_alt", "corr_lookup_win"):
            kernel = lambda: getattr(ops, kname)(f1, pyr, coords, RADIUS)
            got = kernel()[:, idx]
            torch.cuda.synchronize()
            label = (f"{kname} bfloat16 {kind} at {H8}x{W8} (7 pairs), {n_sample} sampled "
                     f"pixels per pair")
            window_check(torch, ops, label, got, want, mag)
            ms = cuda_ms(kernel, reps=3, warmup=1)
            counters = torch.zeros(2, dtype=torch.int32, device=dev)
            ops.corr_lookup_win(f1, pyr, coords, RADIUS, stats=counters)
            n_st, n_un = counters.tolist()
            log(f"check {label}: {differing(torch, got, want)} of {got.numel()} outputs differ "
                f"from the plain version's bits; kernel {ms:.3f} ms a call; staged (tile, level) "
                f"boxes {n_st}/{n_st + n_un} [{card}]")
        del f1, pyr, coords, want, mag, f1s, cs
    torch.cuda.empty_cache()
    maps = chain_select_inputs(torch, dev, N=7, H=8 * H8, W=8 * W8)
    got = ops.chain_select(*maps)
    torch.cuda.synchronize()
    want = ops.chain_select_ref(*maps)
    tols = (1e-4, 1e-5, 1e-5)
    errs = [max_err(g, w) for g, w in zip(got, want)]
    ok = all(within(g, w, a, 1e-6) for g, w, a in zip(got, want, tols))
    ms = cuda_ms(lambda: ops.chain_select(*maps), reps=5, warmup=1)
    log(f"check chain_select at {8 * H8}x{8 * W8} (7 candidates, every pixel): max_abs_err "
        f"flow {errs[0]:.3e} occlusion {errs[1]:.3e} sigma {errs[2]:.3e} (tolerance atol "
        f"{tols} + rtol 1e-6) {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms [{card}]")
    check(ok, "chain_select disagrees with its plain version at 2160x3840")
    del maps, got, want
    torch.cuda.empty_cache()


def run_uhd(torch, ops, dev, card, H=2160, W=3840):
    """Phase 7: both methods at 2160x3840, then the kernels at that size."""
    from mft_tpu_torch.tracker import MFT
    H8, W8 = H // 8, W // 8
    need = volume_bytes(H8, W8)
    frames = synthetic_clip(UHD_FRAMES, H=H, W=W)
    for method in ("win", "alt"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tracker = MFT(method_config(method), device=dev)
        iters = tracker.flower.iters
        ops.reset_launch_counts()
        t = time.perf_counter()
        # every launch of corr_lookup_win adds its staged and unstaged
        # (tile, level) pairs here
        staged = torch.zeros(2, dtype=torch.int32, device=dev)
        ops.corr_lookup_win.stats = staged
        try:
            results, frame_ms = track_frames(torch, tracker, frames)
        finally:
            ops.corr_lookup_win.stats = None
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
        want = expected_counts(ops, **{KERNEL_OF[method]: UHD_FRAMES * iters},
                               chain_select=UHD_FRAMES)
        check(counts == want, f"{method} {H}x{W}: launch counts {counts} != {want}")
        check_tensor_cores(ops, f"{method} {H}x{W}")
        check_results(torch, results, H, W, f"{method} {H}x{W}")
        peak = torch.cuda.max_memory_allocated()
        log(f"{method} at {H}x{W}: frame ms {', '.join(f'{m:.1f}' for m in frame_ms)} "
            f"(init + {UHD_FRAMES} frames {seconds:.2f} s); launches {counts}; peak device "
            f"memory {peak / 1e9:.2f} GB, against {need / 1e9:.1f} GB for the bf16 volume "
            f"of 7 pairs [{card}]")
        if method == "win":
            n_st, n_un = staged.tolist()
            log(f"win at {H}x{W}: staged (tile, level) boxes over the tracked frames "
                f"{n_st}/{n_st + n_un} ({n_st / max(n_st + n_un, 1):.2%}); the rest read their "
                f"taps per pixel on the CUDA cores")
        last = results[-1]
        log(f"{method} at {H}x{W}: mean flow ({float(last.flow[..., 0].mean()):.3f}, "
            f"{float(last.flow[..., 1].mean()):.3f}) px, mean occlusion "
            f"{float(last.occlusion.mean()):.4f}, mean sigma {float(last.sigma.mean()):.4f}")
        del tracker, results, last
    torch.cuda.empty_cache()
    check_kernels_uhd(torch, ops, dev, card, H8, W8)


# --------------------------------------------------------------------------- #
# phase 9: 'int8' and 'auto' at 1080x1920
# --------------------------------------------------------------------------- #
def check_q_kernel_hd(torch, ops, dev, card, H8, W8, n_sample=4096):
    """K6 on a whole (7, H8*W8) call of the int8 volume of random bf16
    features, held against its plain version on ``n_sample`` sampled pixels
    of each pair."""
    from mft_tpu_torch.models.raft import corr as tcorr
    gen = torch.Generator(device=dev).manual_seed(7)
    f1 = torch.randn((B, FEAT_C, H8, W8), device=dev, generator=gen).to(torch.bfloat16)
    f2 = torch.randn((B, FEAT_C, H8, W8), device=dev, generator=gen).to(torch.bfloat16)
    levels, scales = tcorr.build_corr_pyramid_i8(f1, f2, len(LEVELS))
    del f1, f2
    for kind in ("local", "uniform"):
        coords = lookup_coords(torch, dev, kind, gen, H8, W8)
        idx = torch.randperm(H8 * W8, device=dev, generator=gen)[:n_sample]
        kernel = lambda: ops.corr_lookup_q(levels, scales, coords, RADIUS)
        got = kernel()[:, idx]
        torch.cuda.synchronize()
        want = ops.corr_lookup_q_ref([lvl[:, idx].contiguous() for lvl in levels], scales,
                                     coords[:, idx].contiguous(), RADIUS)
        ok = within(got, want, *VOLUME_TOL)
        ms = cuda_ms(kernel, reps=3, warmup=1)
        log(f"check corr_lookup_q int8 {kind} at {H8}x{W8} (7 pairs), {n_sample} sampled "
            f"pixels per pair: max_abs_err {max_err(got, want):.3e} (tolerance atol "
            f"{VOLUME_TOL[0]} + rtol {VOLUME_TOL[1]}) {'ok' if ok else 'FAIL'}; kernel "
            f"{ms:.3f} ms [{card}]")
        check(ok, f"corr_lookup_q {kind} disagrees with its plain version at {H8}x{W8}")
        del got, want
    del levels, scales
    torch.cuda.empty_cache()


def check_lookup_hd(torch, ops, dev, card, H8, W8, n_sample=4096, pairs=B):
    """K2 (the staged gather) on a whole (pairs, H8*W8) call of the bf16
    volume of random features (at 1080x1920 its levels' rows, w = 240, 120,
    60, 30, are no multiple of 16 bytes), held bit for bit against its plain
    version on ``n_sample`` sampled pixels of each pair; K1 on the same
    calls, on the tensor cores, held to ops.product_error_bound there."""
    from mft_tpu_torch.models.raft import corr as tcorr
    gen = torch.Generator(device=dev).manual_seed(13)
    f1 = torch.randn((pairs, FEAT_C, H8, W8), device=dev, generator=gen).to(torch.bfloat16)
    f2 = torch.randn((pairs, FEAT_C, H8, W8), device=dev, generator=gen).to(torch.bfloat16)
    pyr = tcorr.build_corr_pyramid(f1, f2, len(LEVELS))
    del f1, f2
    # convc1's (F, C) weight as the model passes it, and its bias
    wc = (torch.randn((F, len(LEVELS) * (2 * RADIUS + 1) ** 2), device=dev, generator=gen)
          / 18.0).to(torch.bfloat16).t()
    bias = 0.1 * torch.randn((F,), device=dev, generator=gen)
    for kind in ("local", "uniform"):
        coords = lookup_coords(torch, dev, kind, gen, H8, W8, pairs)
        idx = torch.randperm(H8 * W8, device=dev, generator=gen)[:n_sample]
        kernel = lambda: ops.corr_lookup(pyr, coords, RADIUS)
        got = kernel()[:, idx]
        torch.cuda.synchronize()
        want = ops.corr_lookup_ref([lvl[:, idx].contiguous() for lvl in pyr],
                                   coords[:, idx].contiguous(), RADIUS)
        err = exact_check(torch, f"corr_lookup bfloat16 {kind} at {H8}x{W8} ({pairs} pairs, levels "
                                 f"{[tuple(lvl.shape[2:]) for lvl in pyr]}), {n_sample} sampled "
                                 f"pixels per pair", got, want)
        ms = graph_ms(kernel, reps=5)
        log(f"time corr_lookup bfloat16 {kind} at {H8}x{W8} ({pairs} pairs): kernel {ms:.4f} ms (graph replay), "
            f"max_abs_err {err:.3e} [{card}]")
        sub = [lvl[:, idx].contiguous() for lvl in pyr]
        fused = lambda: ops.corr_lookup_fused(pyr, coords, wc, bias, RADIUS)
        got = fused()[:, idx]
        torch.cuda.synchronize()
        want = ops.corr_lookup_fused_ref(sub, coords[:, idx].contiguous(), wc, bias, RADIUS)
        mag = ops.corr_lookup_fused_magnitude(sub, coords[:, idx].contiguous(), wc, RADIUS)
        bound_check(torch, ops, f"fused bfloat16 {kind} at {H8}x{W8} ({pairs} pairs, tensor cores), "
                                f"{n_sample} sampled pixels per pair", got, want, mag,
                    wc.shape[0])
        log(f"fused bfloat16 {kind} at {H8}x{W8}: {int((got != want).sum())} of {got.numel()} "
            f"sampled outputs differ from the plain version's (not gated)")
        ms = graph_ms(fused, reps=5)
        log(f"time fused bfloat16 {kind} at {H8}x{W8} ({pairs} pairs): kernel {ms:.4f} ms (graph replay) "
            f"[{card}]")
        del got, want, sub, mag
    del pyr
    torch.cuda.empty_cache()


def run_hd(torch, ops, dev, card, H=1080, W=1920):
    """Phase 9: 'int8' and 'auto' at 1080x1920, then K6 and K2 at that size."""
    from mft_tpu_torch.tracker import MFT
    H8, W8 = H // 8, W // 8
    frames = synthetic_clip(UHD_FRAMES + 1, H=H, W=W)   # the last: phase 11's frame
    peaks, warp_launches = {}, 0
    for method in ("int8", "auto"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tracker = MFT(method_config(method), device=dev)
        iters = tracker.flower.iters
        ops.reset_launch_counts()
        t = time.perf_counter()
        results, frame_ms = track_frames(torch, tracker, frames[:-1])
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
        if method == "auto":
            want = expected_counts(ops, corr_lookup_fused=UHD_FRAMES * (iters - 1),
                                   corr_lookup=UHD_FRAMES, chain_select=UHD_FRAMES)
        else:
            want = expected_counts(ops, **{KERNEL_OF[method]: UHD_FRAMES * iters},
                                   chain_select=UHD_FRAMES)
        check(counts == want, f"{method} {H}x{W}: launch counts {counts} != {want}")
        check_tensor_cores(ops, f"{method} {H}x{W}")
        check_results(torch, results, H, W, f"{method} {H}x{W}")
        peaks[method] = torch.cuda.max_memory_allocated()
        log(f"{method} at {H}x{W}: frame ms {', '.join(f'{m:.1f}' for m in frame_ms)} "
            f"(init + {UHD_FRAMES} frames {seconds:.2f} s); launches {counts}; peak device "
            f"memory {peaks[method] / 1e9:.2f} GB ({held / 1e9:.2f} GB held before); bf16 "
            f"volume of 7 pairs {volume_bytes(H8, W8) / 1e9:.2f} GB, int8 "
            f"{volume_bytes(H8, W8, itemsize=1) / 1e9:.2f} GB [{card}]")
        last = results[-1]
        log(f"{method} at {H}x{W}: mean flow ({float(last.flow[..., 0].mean()):.3f}, "
            f"{float(last.flow[..., 1].mean()):.3f}) px, mean occlusion "
            f"{float(last.occlusion.mean()):.4f}, mean sigma {float(last.sigma.mean()):.4f}")
        if method == "auto":
            warp_launches += chain_select_pallas_on(torch, ops, card, tracker, frames[-1],
                                                    f"{H}x{W}")
        del tracker, results, last
    check(peaks["int8"] < peaks["auto"],
          f"int8 peaks at {peaks['int8'] / 1e9:.2f} GB, not below auto's "
          f"{peaks['auto'] / 1e9:.2f} GB at {H}x{W}")
    torch.cuda.empty_cache()
    check_q_kernel_hd(torch, ops, dev, card, H8, W8)
    check_lookup_hd(torch, ops, dev, card, H8, W8)
    return warp_launches


# --------------------------------------------------------------------------- #
# phase 12: the tracker configurations of configs/ on the committed weights
# --------------------------------------------------------------------------- #
CONFIG_FRAMES = 10   # tracked frames of each configuration
SLICED_FRAMES = 3    # tracked frames of the fast schedule on each sliced volume form
TIMER_FRAMES = 3     # tracked frames of the unfused timer step
# K1 and K2 launches per tracked frame: JAX's _flow_scheduled fuses the lookup
# on every iteration after which no pair ends (fast (12, 12, 10, 8, 6, 5, 4)
# and warm (12, 10, 8, 6, 5, 5, 4), sorted, end pairs after iterations 4, 5,
# 6, 8, 10 and 12; tests/test_torch_schedule.py counts JAX's loop)
CONFIG_LAUNCHES = {"synth": dict(corr_lookup_fused=11, corr_lookup=1),
                   "fast": dict(corr_lookup_fused=6, corr_lookup=6),
                   "warm": dict(corr_lookup_fused=6, corr_lookup=6)}
SLICED_METHODS = ("mixed", "packed", "packed_i8")
TRAINED_GAP_PATHS = ("alt", "win", "int8", "fold", "conv pallas")
K1_WINDOW = 2.0 ** -20   # corr_lookup.cu kWindow, over ||a_p|| max_f ||w_f||


def trained_config(name, method=None):
    """``<name>_config()`` of ``mft_tpu_torch.config`` on the committed
    weights (``synth_flow_config()``), with corr_method ``method``, or
    conv_backend 'pallas' for 'conv pallas'."""
    from mft_tpu_torch import config
    cfg = getattr(config, f"{name}_config")()
    cfg.flow_config = config.synth_flow_config()
    if method == "conv pallas":
        cfg.flow_config.raft_params["conv_backend"] = "pallas"
    elif method is not None:
        cfg.flow_config.raft_params["corr_method"] = method
    return cfg


def true_flow_error(torch, result, k):
    """Median and mean end-point error of frame k's flow against the clip's
    true shift (-k * SHIFT), over the pixels whose source stays in the frame."""
    dx, dy = SHIFT
    inside = result.flow[k * dy:, k * dx:]
    want = torch.tensor([-k * dx, -k * dy], dtype=torch.float32, device=inside.device)
    epe = (inside - want).norm(dim=-1)
    return float(epe.median()), float(epe.mean())


def run_config(torch, ops, dev, card, name, frames, n, method=None):
    """``n`` tracked frames of ``trained_config(name, method)``: launches per
    frame, tensor-core launches, outputs, frame times. returns: (tracker,
    results, median ms, launch counts)."""
    from mft_tpu_torch.tracker import MFT
    label = name if method is None else f"{name} {method}"
    t0 = time.perf_counter()
    tracker = MFT(trained_config(name, method), device=dev)
    log(f"{label}: schedule {tracker.iters_schedule}, warm start {tracker._warm_start()}, "
        f"weights {os.path.relpath(tracker.C.flow_config.model, HERE)}, set-up "
        f"{time.perf_counter() - t0:.2f} s")
    ops.reset_launch_counts()
    results, frame_ms = track_frames(torch, tracker, frames[:n + 1])
    counts = ops.launch_counts()
    per_frame = (CONFIG_LAUNCHES[name] if method is None
                 else {KERNEL_OF[method]: max(tracker.iters_schedule)})
    want = expected_counts(ops, **{k: n * v for k, v in per_frame.items()}, chain_select=n)
    log(f"{label}: launches over {n} tracked frames: {counts}")
    check(counts == want, f"{label}: launch counts {counts} != {want} ({per_frame} and 1 "
                          f"chain + select per tracked frame)")
    check_tensor_cores(ops, label)
    H, W = frames[0].shape[:2]
    check_results(torch, results, H, W, label)
    median_epe, mean_epe = true_flow_error(torch, results[-1], n)
    log(f"{label} frame {n} (trained weights, not gated): flow end-point error to the true "
        f"shift median {median_epe:.4f} px, mean {mean_epe:.4f} px; mean occlusion "
        f"{float(results[-1].occlusion.mean()):.4f}, mean sigma "
        f"{float(results[-1].sigma.mean()):.4f}")
    median = median_after_warmup(frame_ms) if n > WARMUP else float("nan")
    log(f"{label} frame ms: {', '.join(f'{m:.2f}' for m in frame_ms)}; median after "
        f"{WARMUP} warm-up frames {median:.3f} ms [{card}]")
    return tracker, results, median, counts


def next_frame_volume(torch, tracker, img):
    """The stored volume of the tracker's next frame ``img``, its pairs sorted
    by the tracker's schedule (if any), and each pair's coords after its
    iterations of the forward, changing no state. returns: (volume, coords
    (B, P, 2), the schedule's active-prefix sizes, descending)."""
    t = tracker.current_frame_i + tracker.time_direction
    slots, _, _ = tracker._step_indices(tracker._candidates(t), t)
    sched = tracker.iters_schedule or (tracker.flower.iters,) * len(tracker.deltas)
    order = sorted(range(len(sched)), key=lambda b: -sched[b])
    idx = slots[torch.tensor(order, device=slots.device)]
    f_new, _ = tracker.flower.padded_encode(tracker._to_device(img)[None])
    fmap1 = tracker.mem_fmap.index_select(0, idx)
    fmap2 = f_new.expand(len(order), *f_new.shape[1:])
    model = tracker.flower.model
    with torch.no_grad():
        out = model.flow_from_features(fmap1, fmap2, tracker.mem_cnet.index_select(0, idx),
                                       tuple(sched[b] for b in order))
        volume = model.stored_volume(fmap1, fmap2)
    Bn, H8, W8, _ = out["coords"].shape
    ys, xs = torch.meshgrid(torch.arange(H8, device=f_new.device, dtype=torch.float32),
                            torch.arange(W8, device=f_new.device, dtype=torch.float32),
                            indexing="ij")
    coords = (torch.stack([xs, ys], -1) + out["coords"]).reshape(Bn, H8 * W8, 2).contiguous()
    prefixes = sorted({sum(s > k for s in sched) for k in range(max(sched))}, reverse=True)
    return volume, coords, prefixes


def check_sliced_lookups(torch, ops, tracker, img, label):
    """The lookups of a scheduled frame on its volume sliced to each active
    prefix (``raft.slice_pyramid``) against their plain versions, at the
    coords the pairs reach: K2, #9 bit for bit (EXACT_TOL), K7, K8 to
    VOLUME_TOL, K1 (bf16, tensor cores) within ops.product_error_bound and
    with 0 outputs unlike plain (its plain version sums in the repair's
    order); outputs differing from plain counted."""
    from mft_tpu_torch.models.raft import corr as tcorr
    from mft_tpu_torch.models.raft.raft import slice_pyramid
    volume, coords, prefixes = next_frame_volume(torch, tracker, img)
    convc1 = tracker.flower.model.update_block.encoder.convc1
    wc, bias = convc1.weight.reshape(convc1.out_channels, -1).t(), convc1.bias
    tag = volume[0] if isinstance(volume, tuple) else "volume"
    tol = EXACT_TOL if tag in ("volume", "mixed") else VOLUME_TOL
    for m in prefixes:
        sliced, c = slice_pyramid(volume, m), coords[:m]
        ops.reset_launch_counts()
        got = tcorr.corr_lookup(sliced, c, RADIUS)
        n = ops.launch_counts()
        want = tcorr.corr_lookup(sliced, c, RADIUS, plain=True)
        ok = sum(n.values()) == 1 and got.shape == want.shape and within(got, want, *tol)
        log(f"check {label} lookup on the volume sliced to {m} pairs ({tag}): max_abs_err "
            f"{max_err(got, want):.3e}, {differing(torch, got, want)} of {got.numel()} outputs "
            f"differ from plain (tolerance atol {tol[0]} + rtol {tol[1]}) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: the lookup on {m} pairs disagrees with its plain version")
        if tag == "volume":
            got = tcorr.corr_lookup_fused_conv(sliced, c, convc1.weight, bias, RADIUS)
            want = tcorr.corr_lookup_fused_conv(sliced, c, convc1.weight, bias, RADIUS,
                                                plain=True)
            if m == prefixes[0]:
                whole = got, want
            mag = ops.corr_lookup_fused_magnitude(sliced, c, wc, RADIUS)
            # the plain product sums in K1's repair order at every row count
            # (C5): 0 outputs differ, and each side's rows equal the
            # whole batch's
            n_diff = differing(torch, got, want)
            kernel_rows = differing(torch, got, whole[0][:m])
            plain_rows = differing(torch, want, whole[1][:m])
            bound_check(torch, ops, f"{label} fused lookup on {m} pairs (tensor cores, "
                                    f"{n_diff} of {got.numel()} outputs differ from plain; "
                                    f"against the {prefixes[0]}-pair call's rows: kernel "
                                    f"{kernel_rows}, plain {plain_rows})",
                        got, want, mag, wc.shape[0])
            check(n_diff == 0 and kernel_rows == 0 and plain_rows == 0,
                  f"{label}: K1 on {m} pairs: {n_diff} outputs differ from plain, rows "
                  f"unlike the whole batch's: kernel {kernel_rows}, plain {plain_rows}")


def k1_window_share(torch, ops, tracker, img, label):
    """K1's rounding repair on the tracker's next frame (not gated): the share
    of outputs whose plain f32 sum v = samples . w + b lies within the
    repair's window of a bf16 rounding boundary (relu(v - e) and relu(v + e)
    round apart, e = 2^-20 ||a_p|| max_f ||w_f||, corr_lookup.cu's test
    applied to the plain sums), at the pairs' coords after their
    iterations; and K1's outputs differing from the plain version there."""
    pyr, coords, _ = next_frame_volume(torch, tracker, img)
    convc1 = tracker.flower.model.update_block.encoder.convc1
    w = convc1.weight.reshape(convc1.out_channels, -1)
    samples = ops.corr_lookup_ref(pyr, coords, RADIUS)
    v = torch.matmul(samples.float(), w.float().t()) + convc1.bias.float()
    e = (K1_WINDOW * w.float().norm(dim=1).max()
         * samples.float().norm(dim=-1, keepdim=True).to(torch.bfloat16).float())
    near = torch.relu(v - e).to(torch.bfloat16) != torch.relu(v + e).to(torch.bfloat16)
    got = ops.corr_lookup_fused(pyr, coords, w.t(), convc1.bias, RADIUS)
    want = ops.corr_lookup_fused_ref(pyr, coords, w.t(), convc1.bias, RADIUS)
    log(f"K1 repair window, {label} (not gated): {int(near.sum())} of {near.numel()} outputs "
        f"({float(near.float().mean()):.4%}) within 2^-20 ||a|| max||w|| of a bf16 rounding "
        f"boundary on the plain sums; K1 outputs differing from plain "
        f"{differing(torch, got, want)}; max |samples| {float(samples.abs().max()):.3f}, "
        f"mean ||a_p|| {float(samples.float().norm(dim=-1).mean()):.3f}")


def trained_gaps(torch, ops, dev, card, tracker, frames, nxt):
    """Not gated, on the committed weights: one frame of each path of
    TRAINED_GAP_PATHS against the volume path (``tracker``) from the same
    state; chain_select_pallas against K3 on the next frame's candidates;
    K1's repair window."""
    from mft_tpu_torch.tracker import MFT
    snap = snapshot(tracker)
    base = tracker.track(nxt).result
    restore(tracker, snap)
    torch.cuda.synchronize()
    for method in TRAINED_GAP_PATHS:
        other = MFT(trained_config("synth", method), device=dev)
        other.init(frames[0])
        restore(other, snap)
        g = gap_stats(other.track(nxt).result, base)
        log(f"trained weights: {method} vs volume path, one frame (not gated): {gap_text(g)}")
        del other
    chain_select_pallas_on(torch, ops, card, tracker, nxt, "512x512 on the committed weights")
    k1_window_share(torch, ops, tracker, nxt, "committed weights")


def run_timer_step(torch, ops, dev, card, frames, fused_results):
    """TIMER_FRAMES frames of warm_config() with ``timers_enabled`` (the
    unfused step) against the fused warm tracker's results of the same
    frames, under the main path's absolute gate; the phases' ms printed."""
    from mft_tpu_torch.tracker import MFT
    cfg = trained_config("warm")
    cfg.timers_enabled = True
    tracker = MFT(cfg, device=dev)
    ops.reset_launch_counts()
    tracker.init(frames[0])
    for k, img in enumerate(frames[1:TIMER_FRAMES + 1]):
        meta = tracker.track(img)
        g = gap_stats(meta.result, fused_results[k])
        ok = g["far"] <= 0.01 and g["median"] <= 0.05 and g["occ"] <= 0.01 and g["sig"] <= 0.01
        log(f"check warm timer step frame {k + 1} vs the fused step: {gap_text(g)} (tolerance: "
            f"share > 0.5 px <= 1%, median <= 0.05 px, occlusion/sigma shares <= 1%) "
            f"{'ok' if ok else 'FAIL'}; phases "
            f"{', '.join(f'{n} {ms:.3f} ms' for n, ms in meta.phase_ms.items())} [{card}]")
        check(ok, f"the timer step's frame {k + 1} disagrees with the fused step's")
    counts = ops.launch_counts()
    per = CONFIG_LAUNCHES["warm"]
    want = expected_counts(ops, **{k: TIMER_FRAMES * v for k, v in per.items()},
                           chain_select=TIMER_FRAMES)
    check(counts == want, f"warm timer step: launch counts {counts} != {want}")
    check_results(torch, [meta.result], *frames[0].shape[:2], "warm timer step")


def run_configs(torch, ops, dev, card):
    """Phase 12: synth_config(), fast_config() and warm_config() on the
    committed weights, the fast schedule on the sliced volume forms, the
    timer step, and the trained-weights measurements."""
    frames = synthetic_clip(CONFIG_FRAMES + 1)
    nxt = frames[CONFIG_FRAMES + 1]
    medians = {}
    for name in CONFIG_LAUNCHES:
        tracker, results, medians[name], _ = run_config(torch, ops, dev, card, name, frames,
                                                         CONFIG_FRAMES)
        check_kernels_vs_plain(torch, tracker, nxt, f"{name} (committed weights)")
        if name == "synth":
            trained_gaps(torch, ops, dev, card, tracker, frames, nxt)
        if name == "fast":
            check_sliced_lookups(torch, ops, tracker, nxt, "fast")
        if name == "warm":
            run_timer_step(torch, ops, dev, card, frames, results)
        del tracker, results
    log(f"configurations, frame ms medians after {WARMUP} warm-up frames: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in medians.items())} [{card}]")
    for method in SLICED_METHODS:
        tracker, _, _, _ = run_config(torch, ops, dev, card, "fast", frames, SLICED_FRAMES,
                                      method)
        check_sliced_lookups(torch, ops, tracker, frames[SLICED_FRAMES + 1], f"fast {method}")
        check_kernels_vs_plain(torch, tracker, frames[SLICED_FRAMES + 1],
                               f"fast {method} (committed weights)")
        del tracker
    torch.cuda.empty_cache()
    return medians


# --------------------------------------------------------------------------- #
# phase 13: the TAP-Vid runner on the card
# --------------------------------------------------------------------------- #
TAPVID_SEQS = 2                       # sequences of the synthetic pickle
TAPVID_T = 24                         # frames a sequence
TAPVID_SIZE = 256                     # the pickle's frames, square
TAPVID_GRID = 16                      # 16 x 16 = 256 query points
TAPVID_SCALING = "256x256_512x512"    # tracked at 512x512, scored at 256x256
STRIDE = 5                            # the protocol's strided query frames
CHUNK = 8                             # runner.track_sequence's track_chunk size
CDI_NAME = "MFT_synth_cdi"
CDI_CONFIG = f"""from mft_tpu_torch.config import synth_config


def get_config():
    conf = synth_config()
    conf.cache_delta_infinity = True
    conf.name = "{CDI_NAME}"
    return conf
"""
DATASET_CONFIG = """from mft_tpu_torch.config import Config


def get_config():
    conf = Config()
    conf.pickles = [{pickle!r}]
    conf.scaling = "{scaling}"
    conf.name = "tapvid_synthetic"
    return conf
"""


def tapvid_pickle(path):
    """A DAVIS-form pickle of TAPVID_SEQS sequences: TAPVID_T square RGB
    frames of TAPVID_SIZE px, a random texture (seed: the sequence's index)
    moving 1 px right and 1 px down a frame, and TAPVID_GRID^2 query points
    on a grid of whole pixels that stays in view, visible in every frame,
    their truth exact."""
    import pickle
    import numpy as np
    step = (TAPVID_SIZE - 32 - TAPVID_T) // (TAPVID_GRID - 1)
    grid = 16.0 + step * np.arange(TAPVID_GRID)
    xy = np.stack(np.meshgrid(grid, grid, indexing="xy"), -1).reshape(-1, 1, 2)
    points = (xy + np.arange(TAPVID_T).reshape(1, -1, 1)) / TAPVID_SIZE
    data = {}
    for s in range(TAPVID_SEQS):
        clip = synthetic_clip(TAPVID_T - 1, TAPVID_SIZE, TAPVID_SIZE, seed=s,
                              shift=(1, 1))[::-1]
        data[f"synth{s}"] = {"video": np.stack([f[..., ::-1] for f in clip]),
                             "points": points,
                             "occluded": np.zeros(points.shape[:2], bool)}
    with open(path, "wb") as f:
        pickle.dump(data, f)


def expected_runner_passes(deltas, cdi_flags):
    """An independent model of the runner's cache policy over the synthetic
    pickle's protocol ('first' from frame 0; 'strided' from every STRIDE-th
    frame, forward and backward; the configs in turn, one cache a
    sequence): per pass in the runner's order its reads' hits and misses
    and, a frame, the pairs that run through RAFT (the whole batch, the
    misses of an all-finite-hit frame, 0 for a RAFT-free frame)."""
    finite = sorted(int(d) for d in deltas if math.isfinite(d))
    N = len(deltas)
    keys, passes = set(), []

    def candidates(t, start, td, cdi):
        """(key, valid, cacheable, finite) a pair; invalid pairs are never read."""
        out = [((start, t), True, cdi, False)]
        for d in finite:
            li = t - d * td
            valid = (li - start) * td >= 0
            out.append(((li, t), valid, valid, True))
        return out

    for mode in ("first", "strided"):
        for cdi in cdi_flags:
            starts = [0] if mode == "first" else list(range(0, TAPVID_T, STRIDE))
            for start in starts:
                for td in ((1,) if mode == "first" else (1, -1)):
                    frames = (list(range(start + 1, TAPVID_T)) if td > 0
                              else list(range(start - 1, -1, -1)))
                    hits = misses = 0
                    batches = []
                    for c0 in range(0, len(frames), CHUNK):
                        chunk = [candidates(t, start, td, cdi) for t in frames[c0:c0 + CHUNK]]
                        if not any(v and ca and k in keys for fc in chunk for k, v, ca, _ in fc):
                            for fc in chunk:     # cold chunk: no reads, every row written
                                batches.append(N)
                                keys |= {k for k, v, ca, _ in fc if v and ca}
                            continue
                        for fc in chunk:         # frame by frame, reads first
                            hit = [v and ca and k in keys for k, v, ca, _ in fc]
                            hits += sum(hit)
                            misses += sum(v and ca for _, v, ca, _ in fc) - sum(hit)
                            if not all(h for h, (_, v, _, f) in zip(hit, fc) if v and f):
                                batches.append(N)
                                keys |= {k for (k, v, ca, _), h in zip(fc, hit)
                                         if v and ca and not h}
                            else:
                                comp = [(k, ca) for (k, v, ca, _), h in zip(fc, hit)
                                        if v and not h]
                                batches.append(len(comp))
                                keys |= {k for k, ca in comp if ca}
                    passes.append(dict(mode=mode, cdi=cdi, start_frame=start,
                                       direction="forward" if td > 0 else "backward",
                                       hits=hits, misses=misses, batches=batches))
    return passes


def pass_kind(batches, N):
    if not batches:
        return "empty"
    kinds = {"cold full-batch" if b == N else "warm injected" if b else "RAFT-free"
             for b in batches}
    return kinds.pop() if len(kinds) == 1 else "mixed"


def tapvid_tracker_checks(torch, ops, dev, card, video, queries, tmp):
    """The runner's tracker path on one sequence ('first' from frame 0):
    track_chunk against per-frame track on a fresh tracker (bit for bit);
    the plain versions' pass against the kernels' (the main path's frame
    gate, query tracks); one FlowCache over a cold, an injected, a
    cache_delta_infinity and a RAFT-free pass (launches, RAFT batches,
    frames against the cold pass's, frames/s); a disk round trip of one
    entry. returns: {pass kind: frames/s}."""
    import numpy as np
    from mft_tpu_torch.config import synth_config
    from mft_tpu_torch.eval.runner import track_sequence
    from mft_tpu_torch.io import FlowCache
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking_batch
    T = len(video)
    same = lambda x, y: all(torch.equal(getattr(x, f), getattr(y, f))
                            for f in ("flow", "occlusion", "sigma"))

    chunked = MFT(synth_config(), device=dev)
    metas = track_sequence(chunked, video, 0)
    by_chunk = [metas[k].result for k in range(1, T)]
    del chunked, metas
    tracker = MFT(synth_config(), device=dev)
    tracker.init(video[0])
    per_frame = [tracker.track(img).result for img in video[1:]]
    unlike = [k + 1 for k, (x, y) in enumerate(zip(by_chunk, per_frame)) if not same(x, y)]
    log(f"check track_chunk (chunks of {CHUNK}) vs per-frame track on a fresh tracker, "
        f"{T - 1} frames at {video.shape[2]}x{video.shape[1]}: frames unlike {unlike} "
        f"{'ok' if not unlike else 'FAIL'}")
    check(not unlike, f"track_chunk differs from per-frame track at frames {unlike}")
    del by_chunk

    tracker.plain_ops = True
    tracker.init(video[0])
    plain = [tracker.track(img).result for img in video[1:]]
    tracker.plain_ops = False
    worst = max((gap_stats(p, k) for p, k in zip(plain, per_frame)),
                key=lambda g: (g["far"], g["median"]))
    ok = (worst["far"] <= 0.01 and worst["median"] <= 0.05 and worst["occ"] <= 0.01
          and worst["sig"] <= 0.01)
    tracks = [convert_to_point_tracking_batch(r, queries)[0] for r in (per_frame, plain)]
    dist = np.linalg.norm(tracks[0] - tracks[1], axis=-1)
    near = float((dist <= 0.5).mean())
    log(f"check plain_ops pass vs the kernels' pass, {T - 1} frames: worst frame "
        f"{gap_text(worst)}; query tracks ({queries.shape[0]} points x {T - 1} frames) "
        f"within 0.5 px {near:.4%}, max {dist.max():.3e} px (tolerance: the main path's "
        f"frame gate on every frame, >= 99% of tracks within 0.5 px) "
        f"{'ok' if ok and near >= 0.99 else 'FAIL'}")
    check(ok and near >= 0.99, "the plain versions' TAP-Vid pass disagrees with the kernels'")
    del plain

    cache = FlowCache(None)
    batches, forward = [], tracker.flower.features_forward

    def counting(fmap1, *args, **kw):
        batches.append(fmap1.shape[0])
        return forward(fmap1, *args, **kw)

    tracker.flower.features_forward = counting
    n = T - 1
    raft_free_t = {d for d in (1, 2, 4, 8, 16, 32) if d < T}   # inf (0, t) = delta t's pair
    plan = (("cold full-batch", False, [7] * n, n),
            ("warm injected", False, [1] * n, n),
            ("cache_delta_infinity, first", True, [1] * (n - len(raft_free_t)),
             n - len(raft_free_t)),
            ("RAFT-free", True, [], 0))
    results, fps = {}, {}
    for name, cdi, want_batches, raft_frames in plan:
        tracker.C.cache_delta_infinity = cdi
        batches.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metas = track_sequence(tracker, video, 0, "forward", cache)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        results[name] = [metas[k].result for k in range(1, T)]
        want = expected_counts(ops, corr_lookup_fused=11 * raft_frames,
                               corr_lookup=raft_frames, chain_select=n)
        log(f"{name} pass: {n} frames in {sec:.3f} s ({n / sec:.2f} frames/s) [{card}]; "
            f"RAFT batches {batches}; launches {counts}; cache hits {cache.hits}, misses "
            f"{cache.misses}, {len(cache.device_cache)} device-tier entries")
        check(batches == want_batches and counts == want,
              f"{name} pass: batches {batches} != {want_batches} or launches {counts} != {want}")
        fps[name] = n / sec
    del tracker.flower.features_forward
    tracker.C.cache_delta_infinity = False
    gate_gaps = [gap_stats(x, y) for x, y in zip(results["warm injected"],
                                                 results["cold full-batch"])]
    worst = max(gate_gaps, key=lambda g: (g["far"], g["median"]))
    ok = (worst["far"] <= 0.01 and worst["median"] <= 0.05 and worst["occ"] <= 0.01
          and worst["sig"] <= 0.01)
    log(f"check injected frames (the template pair alone through RAFT) vs the same frames "
        f"in the full batch: worst {gap_text(worst)} (tolerance: the main path's frame gate) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "injected frames disagree with the full batch's")
    free_same = all(same(x, y) for x, y in zip(results["RAFT-free"],
                                               results["cache_delta_infinity, first"]))
    g = max((gap_stats(x, y) for x, y in zip(results["RAFT-free"], results["cold full-batch"])),
            key=lambda g: (g["far"], g["median"]))
    log(f"check RAFT-free pass vs the cache_delta_infinity pass that filled its cache: "
        f"{'bit for bit ok' if free_same else 'FAIL'}; vs the cold pass (not gated): {gap_text(g)}")
    check(free_same, "the RAFT-free pass differs from the pass whose cache entries it read")
    on_card = (not cache.ram_cache and all(x.device.type == dev.type
                                           for v in cache.device_cache.values() for x in v))
    log(f"check cache tiers: {len(cache.device_cache)} device-tier entries, "
        f"{cache.device_bytes / 1e6:.1f} MB, all CUDA tensors, none in RAM "
        f"{'ok' if on_card else 'FAIL'}")
    check(on_card, "a cache write on the card left the device tier")

    key = min(cache.device_cache)
    fields = cache.device_cache[key]
    disk = FlowCache(tmp / "disk_cache", max_ram_mb=0, max_device_mb=0)
    disk.write(*key, *fields)
    back = disk.read(*key)
    files = sorted(p.name for p in (tmp / "disk_cache").iterdir())
    chans = [(fields[0][..., 0], back[0][..., 0]), (fields[0][..., 1], back[0][..., 1]),
             (fields[1], back[1]), (fields[2], back[2])]
    errs = [(float((torch.from_numpy(b).to(x.device) - x).abs().max()),
             float(x.max() - x.min()) / 65535) for x, b in chans]
    ok = files == [f"{key[0]}--{key[1]}.flowouX16.pkl"] and all(e <= q for e, q in errs)
    log(f"check .flowouX16.pkl disk round trip of cache entry {key}: {files}; max |error| / "
        f"quantisation step per channel (flow x, flow y, occlusion, sigma) "
        f"{', '.join(f'{e:.3e} / {q:.3e}' for e, q in errs)} {'ok' if ok else 'FAIL'}")
    check(ok, "the disk round trip of a cache entry exceeds the codec's quantisation step")
    return fps


def run_tapvid(torch, ops, dev, card):
    """Phase 13: mft_tpu_torch.eval.runner.run on a synthetic DAVIS-form
    pickle with synth (committed weights) and its cache_delta_infinity twin,
    mode 'both', scaling 256x256_512x512; then evaluate and report. Gates:
    every prediction file, <delta_avg >= 0.9, the cache's hits and misses
    per pass and the launches as the policy's model predicts, every cache
    write a CUDA tensor in the device tier; and the tracker checks above.
    returns: the run's launch counts."""
    import tempfile
    from pathlib import Path
    import numpy as np
    from mft_tpu_torch.config import synth_config
    from mft_tpu_torch.eval import evaluate, report, runner
    from mft_tpu_torch.eval.tapvid import create_tapvid_dataset
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        tapvid_pickle(tmp / "synthetic.pkl")
        (tmp / "cdi.py").write_text(CDI_CONFIG)
        (tmp / "dataset.py").write_text(DATASET_CONFIG.format(
            pickle=str(tmp / "synthetic.pkl"), scaling=TAPVID_SCALING))
        log(f"phase 13: synthetic DAVIS-form pickle, {TAPVID_SEQS} sequences x {TAPVID_T} "
            f"frames {TAPVID_SIZE}x{TAPVID_SIZE}, {TAPVID_GRID ** 2} query points, in "
            f"{time.perf_counter() - t0:.2f} s")
        common = ["--dataset", str(tmp / "dataset.py"), "--export", str(tmp / "export")]
        names = [synth_config().name, CDI_NAME]
        args = runner.get_parser().parse_args(
            ["--trackers", "synth", str(tmp / "cdi.py"), "--cache", str(tmp / "cache"),
             "--mode", "both", *common])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = runner.run(args)
        run_sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        files = sorted(p.name for name in names
                       for p in (tmp / "export" / name / "results").glob("*.pklz"))
        want_files = sorted(f"synth{s}-{m}.pklz" for _ in names for s in range(TAPVID_SEQS)
                            for m in ("first", "strided"))
        check(files == want_files, f"prediction files {files} != {want_files}")

        deltas = synth_config().deltas
        model = expected_runner_passes(deltas, (False, True))
        got = [(p["mode"], p["config"] == CDI_NAME, p["start_frame"], p["direction"],
                p["hits"], p["misses"]) for p in out["passes"]]
        want = [(m["mode"], m["cdi"], m["start_frame"], m["direction"], m["hits"],
                 m["misses"]) for m in model] * TAPVID_SEQS
        check(got == want, f"cache hits/misses per pass {got} != the policy's {want}")
        strided_fwd = [m for m in model if m["mode"] == "strided" and m["direction"] == "forward"
                       and not m["cdi"]]
        finite_valid = sum(sum(1 for d in deltas if math.isfinite(d)
                               and t - int(d) >= m["start_frame"])
                           for m in strided_fwd for t in range(m["start_frame"] + 1, TAPVID_T))
        log(f"strided forward passes of synth: {sum(m['hits'] for m in strided_fwd)} hits "
            f"(the protocol's valid finite pairs: {finite_valid}), "
            f"{sum(m['misses'] for m in strided_fwd)} misses")
        check(sum(m["hits"] for m in strided_fwd) == finite_valid
              and not any(m["misses"] for m in strided_fwd),
              "a strided forward pass missed a valid finite pair")
        raft = sum(b > 0 for m in model for b in m["batches"]) * TAPVID_SEQS
        frames = sum(len(m["batches"]) for m in model) * TAPVID_SEQS
        want_counts = expected_counts(ops, corr_lookup_fused=11 * raft, corr_lookup=raft,
                                      chain_select=frames, bilinear_warp=len(out["passes"]))
        log(f"runner launches over {frames} frames ({raft} through RAFT) and "
            f"{len(out['passes'])} conversions: {counts}")
        check(counts == want_counts, f"runner launches {counts} != {want_counts}")
        for name, state in out["caches"].items():
            ok = (state["devices"] == [str(torch.empty(0, device=dev).device)]
                  and state["ram_entries"] == 0 and state["disk_entries"] == 0)
            log(f"cache of {name}: {state} {'ok' if ok else 'FAIL'}")
            check(ok, f"{name}: cache writes left the device tier: {state}")
        kinds = {}
        for p, m in zip(out["passes"], model * TAPVID_SEQS):
            k = kinds.setdefault(pass_kind(m["batches"], len(deltas)), [0, 0.0])
            k[0] += p["frames"]
            k[1] += p["seconds"]
        log(f"runner: {len(out['passes'])} passes, {frames} frames in {run_sec:.2f} s; by pass "
            f"kind (frames, s, frames/s): "
            + "; ".join(f"{k} {n}, {sec:.3f}, {n / sec if sec else float('nan'):.2f}"
                        for k, (n, sec) in kinds.items())
            + f"; peak device memory {peak / 1e9:.3f} GB, device tier at its largest "
            f"{max(s['device_bytes'] for s in out['caches'].values()) / 1e9:.3f} GB [{card}]")

        eargs = evaluate.get_parser().parse_args(["--trackers", "synth", str(tmp / "cdi.py"),
                                                  "--mode", "both", *common])
        means = evaluate.run(eargs)
        for (name, mode), m in sorted(means.items()):
            ok = m["average_pts_within_thresh"] >= 0.9
            log(f"TAP-Vid {name} {mode} (synthetic clip, x100): AJ "
                f"{100 * m['average_jaccard']:.2f}, <delta_avg "
                f"{100 * m['average_pts_within_thresh']:.2f}, OA "
                f"{100 * m['occlusion_accuracy']:.2f} (gate: <delta_avg >= 90) "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{name} {mode}: <delta_avg {m['average_pts_within_thresh']:.4f} < 0.9")
        report.report(names, tmp / "export")

        seq = next(create_tapvid_dataset(tmp / "synthetic.pkl", ["first"], TAPVID_SCALING))
        video = np.ascontiguousarray(seq["data"]["first"]["video"][0][..., ::-1])
        queries = seq["data"]["first"]["query_points"][0][:, 1:][:, ::-1].astype(np.int64)
        fps = tapvid_tracker_checks(torch, ops, dev, card, video,
                                    queries.astype(np.float32), tmp)
        log(f"phase 13 frames/s by pass kind (one sequence, {TAPVID_T - 1} frames each): "
            + ", ".join(f"{k} {v:.2f}" for k, v in fps.items()) + f" [{card}]")
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------- #
# phase 14: training
# --------------------------------------------------------------------------- #
TRAIN_B, TRAIN_H, TRAIN_W, TRAIN_ITERS = 6, 368, 768, 12   # the recipe's batch and crop
TRAIN_STEPS = 5          # steps of each recipe through the entry point
SINTEL_FRAMES, SINTEL_H, SINTEL_W = 5, 436, 1024          # MPI-Sintel's frame size
EXPORT_SIZE = 256        # frames the tracker on the exported weights tracks
# the backward's shapes: the training batch (46x96 at level 0) and the slice's
BWD_SHAPES = {"train": (TRAIN_B, TRAIN_H // 8, TRAIN_W // 8), "slice": (B, 64, 64)}
# phase 14c's stated tolerance, kernels against plain versions on one f32
# full-recipe step with deterministic cuDNN: the same operations in the same
# order (K2 and the backward bit for bit with their plain versions), so 0 is
# expected; the bound admits last-bit differences of a library call whose
# algorithm choice could differ between two calls
TRAIN_PLAIN_TOL = dict(loss=1e-6, grad=1e-5)


def bwd_coords(torch, dev, kind, gen, Bn, H8, W8):
    """(Bn, H8*W8, 2) coords, as phase 3 draws them: 'uniform' over the map
    and 10 px beyond it, 'local' the pixel grid + U(-2, 2)."""
    u = torch.empty((Bn, H8 * W8, 2), device=dev).uniform_(0.0, 1.0, generator=gen)
    if kind == "uniform":
        return (-10.0 + u * torch.tensor([W8 + 20.0, H8 + 20.0], device=dev)).contiguous()
    ys, xs = torch.meshgrid(torch.arange(H8, device=dev), torch.arange(W8, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(1, H8 * W8, 2).float()
    return (grid + 4.0 * u - 2.0).contiguous()


def library_lookup_bwd(torch, g, coords, dims, radius=RADIUS):
    """The library's yardstick for the backward: ``grid_sampler_2d_backward``
    (what autograd runs behind an ``F.grid_sample`` lookup, bilinear, zeros,
    align_corners=True), one call per level on the (B*P, 1, h_l, w_l) view,
    the level gradient only. returns (device ms by graph replay, the level
    gradients) or (None, None) where the library refuses the dtype."""
    n = 2 * radius + 1
    Bn, Pn = coords.shape[:2]
    off = torch.arange(n, dtype=torch.float32, device=coords.device) - radius
    calls = []
    for lvl, (h, w) in enumerate(dims):
        c = coords / 2.0 ** lvl
        x = (c[..., 0, None, None] + off[:, None]).expand(Bn, Pn, n, n)   # i offsets x
        y = (c[..., 1, None, None] + off[None, :]).expand(Bn, Pn, n, n)
        grid = torch.stack([2.0 * x / max(w - 1, 1) - 1.0, 2.0 * y / max(h - 1, 1) - 1.0], -1)
        grid = grid.reshape(Bn * Pn, n, n, 2).to(g.dtype)
        go = g[..., lvl * n * n:(lvl + 1) * n * n].reshape(Bn * Pn, 1, n, n).contiguous()
        inp = torch.zeros((Bn * Pn, 1, h, w), dtype=g.dtype, device=g.device)
        calls.append((go, inp, grid))

    def run():
        return [torch.ops.aten.grid_sampler_2d_backward(go, inp, grid, 0, 0, True,
                                                        [True, False])[0]
                for go, inp, grid in calls]
    try:
        out = [o.reshape(Bn, Pn, *o.shape[2:]) for o in run()]
    except RuntimeError as e:
        log(f"library lookup backward {g.dtype}: refused ({str(e).splitlines()[0]})")
        return None, None
    return graph_ms(run, reps=10), out


def check_lookup_bwd(torch, ops, dev, card, radius=RADIUS):
    """14a (16a at radius 3): the backward kernel against its plain version
    at the training shape and the slice's, uniform and local coordinates:
    f32 bit for bit, bf16 bit for bit and equal to the f32 result of the same
    inputs rounded once; timed by graph replay beside the plain version, the
    library's backward and the bound. returns {(shape, dtype, kind): stats}."""
    stats = {}
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 2 * radius + 1
    for label, (Bn, H8, W8) in BWD_SHAPES.items():
        dims = [(H8 >> lvl, W8 >> lvl) for lvl in range(len(LEVELS))]
        for kind in ("uniform", "local"):
            coords = bwd_coords(torch, dev, kind, gen, Bn, H8, W8)
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[1]
                g = torch.randn((Bn, H8 * W8, len(dims) * n * n), device=dev,
                                generator=gen).to(dtype)
                kernel = lambda: ops.corr_lookup_bwd(g, coords, dims, radius)
                plain = lambda: ops.corr_lookup_bwd_ref(g, coords, dims, radius)
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                same = sum(int((a != b).sum()) for a, b in zip(got, want))
                err = max(max_err(a, b) for a, b in zip(got, want))
                tag = f"lookup backward {name} {label} {kind} r {radius}"
                log(f"check {tag}: {same} of {sum(a.numel() for a in got)} values differ "
                    f"from the plain version (max_abs_err {err:.3e}; tolerance: bit for bit)")
                check(same == 0, f"{tag} differs from its plain version")
                if dtype == torch.bfloat16:
                    want32 = ops.corr_lookup_bwd_ref(g.float(), coords, dims, radius)
                    check(all(torch.equal(a, b.to(dtype)) for a, b in zip(got, want32)),
                          f"{tag}: not the f32 result rounded once")
                    del want32
                del got, want
                ms = graph_ms(kernel, reps=10)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                lib_ms, lib = library_lookup_bwd(torch, g, coords, dims, radius)
                lib_note = "refused"
                if lib is not None:
                    ref = ops.corr_lookup_bwd_ref(g, coords, dims, radius)
                    lib_note = (f"{lib_ms:.4f} ms, max_abs_err to the plain version "
                                f"{max(max_err(a, b) for a, b in zip(lib, ref)):.3e}")
                    del lib, ref
                values = sum(Bn * H8 * W8 * h * w for h, w in dims)
                nbytes = (values + g.numel()) * g.element_size() + coords.numel() * 4
                ops_n = 8 * Bn * H8 * W8 * len(dims) * (n + 1) ** 2   # 4 products + 4 sums
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops_n / PEAK_OPS_PER_S["float32"] * 1e3
                bound = max(bytes_ms, ops_ms)
                log(f"time {tag}: kernel {ms:.4f} ms (graph replay), plain {plain_ms:.3f} ms, "
                    f"library (grid_sampler_2d_backward per level) {lib_note}, bound "
                    f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB written and read, every map "
                    f"value written) [{card}]")
                stats[(label, name, kind)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=lib_ms)
                del g
    return stats


def train_args(tmp, recipe):
    """The recipe's CLI arguments, as an @file the parser reads."""
    from mft_tpu_torch.config import SYNTH_WEIGHTS
    lines = ["--name", recipe, "--stage", "sintel", "--restore_ckpt", str(SYNTH_WEIGHTS),
             "--num_steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_B),
             "--image_size", str(TRAIN_H), str(TRAIN_W), "--iters", str(TRAIN_ITERS),
             "--mixed_precision", "--num_workers", "6", "--lr", "0.000125",
             "--wdecay", "0.00001", "--gamma=0.85", "--uncertainty_loss",
             "huber_non_occluded", "--checkpoint_dir", str(tmp / "checkpoints")]
    if recipe == "official":
        lines += ["--freeze_optical_flow_training", "--freeze_features_training"]
    path = tmp / f"{recipe}.txt"
    path.write_text("\n".join(lines) + "\n")
    return f"@{path}"


def run_recipe(torch, ops, dev, card, tmp, recipe):
    """14b: one recipe through the entry point's parser and ``train``.
    Gates: finite losses and metrics; frozen parameters bit-identical and
    trainable ones moved; batch statistics unchanged (official) or moved
    (full); per step 12 K2 launches and 12 (full) or 0 (official) backward
    launches and nothing else; the checkpoint and its msgpack export, which
    RAFTFlow loads and tracks 2 frames with. returns stats."""
    from pathlib import Path
    from mft_tpu_torch.config import SYNTH_WEIGHTS, synth_config
    from mft_tpu_torch.models.raft.wrapper import load_weights
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.train import loop
    official = recipe == "official"
    before = load_weights(Path(SYNTH_WEIGHTS))
    per_step, step_ms, losses = [], [], []

    def on_step(state, metrics, seconds):
        per_step.append(ops.launch_counts())
        ops.reset_launch_counts()
        step_ms.append(1e3 * seconds)
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f"{recipe} step {state['step']}: non-finite metrics {vals}")
        losses.append(vals["train/loss"])

    args = loop.get_parser().parse_args([train_args(tmp, recipe)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = loop.train(args, on_step=on_step)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(state["step"] == TRAIN_STEPS and len(per_step) == TRAIN_STEPS,
          f"{recipe}: {state['step']} steps, {len(per_step)} reported")
    bwd = 0 if official else TRAIN_ITERS
    want = expected_counts(ops, corr_lookup=TRAIN_ITERS, corr_lookup_bwd=bwd)
    for k, counts in enumerate(per_step, start=1):
        check(counts == want, f"{recipe} step {k}: launches {counts} != {want}")
    after = {k: v.detach().cpu() for k, v in state["model"].state_dict().items()}
    stats_keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    params = [k for k in after if k not in stats_keys]
    trainable = [k for k in params if not official or k.startswith("occlusion_block")]
    frozen_same = all(torch.equal(after[k], before[k]) for k in params if k not in trainable)
    moved = sum(not torch.equal(after[k], before[k]) for k in trainable)
    stats_moved = sum(not torch.equal(after[k], before[k]) for k in stats_keys)
    log(f"{recipe}: {len(params) - len(trainable)} frozen tensors bit-identical: "
        f"{frozen_same}; {moved} of {len(trainable)} trainable tensors moved; "
        f"{stats_moved} of {len(stats_keys)} batch statistics moved")
    check(frozen_same, f"{recipe}: a frozen parameter changed")
    check(moved == len(trainable), f"{recipe}: a trainable parameter did not move")
    check(stats_moved == (0 if official else len(stats_keys)),
          f"{recipe}: batch statistics {'moved' if official else 'did not all move'}")
    run = Path(args.checkpoint_dir) / args.name
    ckpts = sorted(p.name for p in run.glob("step_*"))
    export = run / f"{args.name}_step{TRAIN_STEPS}.msgpack"
    check(ckpts == [f"step_{TRAIN_STEPS:08d}"] and (run / ckpts[0] / "state.pt").is_file()
          and export.is_file(), f"{recipe}: checkpoints {ckpts}, export {export.is_file()}")
    conf = synth_config()
    conf.flow_config.model = str(export)
    tracker = MFT(conf, device=dev)
    check(all(torch.equal(tracker.flower.model.state_dict()[k].float().cpu(), after[k])
              for k in stats_keys), f"{recipe}: the export's statistics differ")
    frames = synthetic_clip(2, H=EXPORT_SIZE, W=EXPORT_SIZE)
    results, _ = track_frames(torch, tracker, frames)
    check_results(torch, results, EXPORT_SIZE, EXPORT_SIZE, f"{recipe} export")
    del tracker
    steady = sorted(step_ms[1:])
    median = steady[len(steady) // 2] if len(steady) % 2 else 0.5 * (
        steady[len(steady) // 2 - 1] + steady[len(steady) // 2])
    log(f"{recipe} recipe ({TRAIN_B}x{TRAIN_H}x{TRAIN_W}, {TRAIN_ITERS} iterations, bf16 "
        f"compute over f32 parameters): losses {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step ms {', '.join(f'{m:.1f}' for m in step_ms)}; median after 1 warm-up step "
        f"{median:.1f} ms; peak device memory {peak / 2**30:.2f} GiB; launches a step "
        f"K2 {TRAIN_ITERS}, backward {bwd}; {seconds:.1f} s with data, checkpoint and "
        f"export; the export tracks 2 frames [{card}]")
    return dict(median_ms=median, step_ms=step_ms, peak_gib=peak / 2**30,
                launches={k: sum(c[k] for c in per_step) for k in per_step[0]})


def train_batch(torch, dev, tmp, n=TRAIN_B, seed=0):
    """n samples of the tree's 'sintel' stage (augmented, seeded) on the card."""
    import numpy as np
    from mft_tpu_torch.train.datasets import fetch_dataset
    from types import SimpleNamespace
    ds = fetch_dataset("sintel", (TRAIN_H, TRAIN_W),
                       env=SimpleNamespace(sintel_dir=str(tmp / "sintel")))
    for k, part in enumerate(ds.parts):
        part.augmentor.rng = np.random.default_rng(seed + k)
    samples = [ds[i] for i in range(n)]
    return tuple(torch.from_numpy(np.stack(col)).to(dev) for col in zip(*samples))


def full_state(torch, dev, mixed, lr=1.25e-4, small=False):
    """A full-recipe train state on the committed weights (``small``: the
    small model on random weights from seed 0)."""
    from pathlib import Path
    from mft_tpu_torch.config import SYNTH_WEIGHTS
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.models.raft.raft import RAFTParams
    from mft_tpu_torch.models.raft.wrapper import load_weights, random_init
    from mft_tpu_torch.train.optim import make_optimizer
    model = RAFT(RAFTParams(small=small), train_mode=True)
    if small:
        random_init(model, 0)
    else:
        model.load_state_dict(load_weights(Path(SYNTH_WEIGHTS)))
    model.to(dev)
    if mixed:
        model.cast_per_call(torch.bfloat16)
    tx, _ = make_optimizer(lr=lr, num_steps=TRAIN_STEPS)
    return {"model": model, "opt_state": tx.init(dict(model.named_parameters())),
            "step": 0}, tx


LOSS_KW = dict(gamma=0.85, freeze_optical_flow=False,
               occlusion_module="separate_with_uncertainty",
               uncertainty_loss_type="huber_non_occluded", optical_flow_loss_type="L1",
               weighting_unc_loss=False)


def check_train_plain(torch, ops, dev, card, batch, small=False):
    """14c (16d for the ``small`` model): one f32 full-recipe step through
    the kernels and through the plain versions, from the same state and
    batch, deterministic cuDNN: the loss, every gradient and every updated
    parameter against TRAIN_PLAIN_TOL."""
    from mft_tpu_torch.train.loop import make_train_step
    out = {}
    for plain in (False, True):
        state, tx = full_state(torch, dev, mixed=False, small=small)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = make_train_step(state["model"], tx, LOSS_KW, iters=TRAIN_ITERS,
                                         plain=plain)(state, batch)
        loss = float(metrics["train/loss"])
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = (expected_counts(ops) if plain else
                expected_counts(ops, corr_lookup=TRAIN_ITERS, corr_lookup_bwd=TRAIN_ITERS))
        check(counts == want, f"f32 step plain={plain}: launches {counts} != {want}")
        model = state["model"]
        out[plain] = (loss, {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                      {k: v.detach().clone() for k, v in model.state_dict().items()}, sec)
        del state, model
        torch.cuda.empty_cache()
    (lk, gk, pk, sk), (lp, gp, pp, sp) = out[False], out[True]
    loss_gap = abs(lk - lp) / max(abs(lp), 1e-30)
    grad_gap = max(float((gk[n] - gp[n]).abs().max()) / max(float(gp[n].abs().max()), 1e-30)
                   for n in gp)
    grads_equal = sum(torch.equal(gk[n], gp[n]) for n in gp)
    state_equal = sum(torch.equal(pk[k], pp[k]) for k in pp)
    log(f"f32 full-recipe step{' of the small model' if small else ''}, kernels against "
        f"plain versions (deterministic cuDNN): loss "
        f"{lk:.6f} vs {lp:.6f} (relative gap {loss_gap:.3e}, tolerance "
        f"{TRAIN_PLAIN_TOL['loss']}); gradients: largest gap {grad_gap:.3e} of the tensor's "
        f"largest |gradient| (tolerance {TRAIN_PLAIN_TOL['grad']}), {grads_equal} of "
        f"{len(gp)} tensors bit-identical; after the update {state_equal} of {len(pp)} "
        f"tensors bit-identical; step {1e3 * sk:.0f} ms with kernels, {1e3 * sp:.0f} ms plain "
        f"(first calls, not steady) [{card}]")
    check(loss_gap <= TRAIN_PLAIN_TOL["loss"], "f32 step: loss gap beyond the tolerance")
    check(grad_gap <= TRAIN_PLAIN_TOL["grad"], "f32 step: gradient gap beyond the tolerance")
    return dict(loss_gap=loss_gap, grad_gap=grad_gap)


def check_resume(torch, ops, dev, card, tmp, batch):
    """14d: the full recipe (bf16 compute) 2 steps, a checkpoint, a 3rd step;
    a fresh state restored from the checkpoint takes the same 3rd step:
    weights, statistics and optimizer state equal bit for bit
    (deterministic cuDNN). returns the median ms of the steps after the
    first, each synchronised: a full step with no batch loader beside it."""
    from mft_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from mft_tpu_torch.train.loop import make_train_step
    step_ms = []

    def timed(step_fn, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return state

    state, tx = full_state(torch, dev, mixed=True)
    step = make_train_step(state["model"], tx, LOSS_KW, iters=TRAIN_ITERS)
    for _ in range(2):
        state = timed(step, state)
    path = save_checkpoint(tmp / "resume", state["step"], state)
    state = timed(step, state)
    fresh, tx2 = full_state(torch, dev, mixed=True)
    fresh = restore_checkpoint(path, fresh)
    fresh = timed(make_train_step(fresh["model"], tx2, LOSS_KW, iters=TRAIN_ITERS), fresh)
    a, b = state["model"].state_dict(), fresh["model"].state_dict()
    same = sum(torch.equal(a[k], b[k]) for k in a)
    opt_same = all(torch.equal(state["opt_state"][m][n], fresh["opt_state"][m][n])
                   for m in ("mu", "nu") for n in state["opt_state"][m])
    log(f"resume: after step 3, {same} of {len(a)} model tensors and the optimizer state "
        f"({opt_same}) equal to the uninterrupted run's (step {fresh['step']})")
    check(same == len(a) and opt_same and fresh["step"] == state["step"] == 3,
          "resume differs from the uninterrupted run")
    steady = sorted(step_ms[1:])
    log(f"full recipe without a batch loader (deterministic cuDNN): step ms "
        f"{', '.join(f'{m:.1f}' for m in step_ms)}; median after the first "
        f"{steady[1]:.1f} ms [{card}]")
    return steady[1]


def run_training(torch, ops, dev, card):
    """Phase 14: the backward kernel (a), the two recipes through the entry
    point on a Sintel-form tree (b), kernels against plain versions on an f32
    step (c), resume (d). returns (backward stats, full recipe's launches)."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace
    from mft_tpu_torch import environment
    from mft_tpu_torch.train import synth
    t0 = time.perf_counter()
    bwd = check_lookup_bwd(torch, ops, dev, card)
    log(f"phase 14a seconds {time.perf_counter() - t0:.2f}")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        synth.write_sintel_tree(tmp / "sintel", frames=SINTEL_FRAMES, H=SINTEL_H, W=SINTEL_W)
        log(f"phase 14: a Sintel-form tree of 2 scenes x {SINTEL_FRAMES} frames "
            f"{SINTEL_H}x{SINTEL_W} (train/synth.py) in {time.perf_counter() - t0:.2f} s")
        settings = environment.env_settings
        environment.env_settings = lambda: SimpleNamespace(sintel_dir=str(tmp / "sintel"))
        try:
            t0 = time.perf_counter()
            recipes = {r: run_recipe(torch, ops, dev, card, tmp, r) for r in ("official", "full")}
            log(f"phase 14b seconds {time.perf_counter() - t0:.2f}")
        finally:
            environment.env_settings = settings
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            t0 = time.perf_counter()
            batch = train_batch(torch, dev, tmp)
            check_train_plain(torch, ops, dev, card, batch)
            log(f"phase 14c seconds {time.perf_counter() - t0:.2f}")
            t0 = time.perf_counter()
            bare_ms = check_resume(torch, ops, dev, card, tmp, batch)
            log(f"phase 14d seconds {time.perf_counter() - t0:.2f}")
        finally:
            torch.backends.cudnn.deterministic = False
    log(f"training: ms per step (median after 1 warm-up, batch loader running) official "
        f"{recipes['official']['median_ms']:.1f}, full {recipes['full']['median_ms']:.1f}; "
        f"full without a loader {bare_ms:.1f}; peak device memory official "
        f"{recipes['official']['peak_gib']:.2f} GiB, full {recipes['full']['peak_gib']:.2f} GiB "
        f"[{card}]")
    return bwd, recipes


# --------------------------------------------------------------------------- #
# phase 15: multi-clip streaming and the data-parallel mesh
# --------------------------------------------------------------------------- #
STREAM_CLIPS = (1, 2, 4, 8, 16)   # clips tracked in lockstep
STREAM_STEPS = 10                  # timesteps of each C
STREAM_GATED = 4                   # the C at which every clip is held to its single tracker
CLIP_AXIS_C = 4                    # K3's clip-axis check and time
STREAM_SAMPLE = 1024               # pixels a pair of the K1/K2 check at the largest C
F32_ITERS, F32_STEPS = 3, 4        # the float32 gate's iterations and timesteps
MESH_B, MESH_H, MESH_W = 2, 368, 768   # the data-parallel step's batch and crop


def check_chain_select_clips(torch, ops, dev, card, C=CLIP_AXIS_C, timed=True):
    """15a: K3 over (C, 7, 512, 512) in one launch, candidate maps of their
    own seed a clip, on uniform, local and steady (every candidate valid)
    maps and NaN maps: bit for bit (NaN positions equal) with its plain
    version and with C single-clip launches; ``timed``: timed (graph replay)
    beside the C single-clip launches and its bound, the sum of the clips'
    compulsory bytes as ``chain_select_bytes`` counts them."""
    stats = {}
    for kind in ("uniform", "local", "steady", "nan"):
        per = [chain_select_nan_inputs(torch, dev, seed=2 + 10 * c) if kind == "nan"
               else chain_select_inputs(torch, dev, kind=kind, seed=2 + 10 * c)
               for c in range(C)]
        valid = per[0][6]
        maps = [torch.stack([p[k] for p in per]) for k in range(6)]
        got = ops.chain_select(*maps, valid)
        singles = [ops.chain_select(*(m[c] for m in maps), valid) for c in range(C)]
        torch.cuda.synchronize()
        want = ops.chain_select_ref(*maps, valid)
        n_plain = sum(differing(torch, g, w) for g, w in zip(got, want))
        n_single = sum(differing(torch, g, torch.stack([one[f] for one in singles]))
                       for f, g in enumerate(got))
        n_nan = sum(int(torch.isnan(w).sum()) for w in want)
        log(f"check chain_select clip axis {kind} (C {C}, 7 candidates, 512x512, one "
            f"launch): {n_plain} of {sum(w.numel() for w in want)} outputs differ from the "
            f"plain version's, {n_single} from {C} single-clip launches' ({n_nan} NaN "
            f"outputs; tolerance 0) {'ok' if n_plain == n_single == 0 else 'FAIL'}")
        check(n_plain == 0 and n_single == 0,
              f"chain_select with a clip axis disagrees on the {kind} maps")
        if timed and kind != "nan":
            ms = graph_ms(lambda: ops.chain_select(*maps, valid))
            singles_ms = graph_ms(lambda: [ops.chain_select(*(m[c] for m in maps), valid)
                                           for c in range(C)])
            plain_ms = cuda_ms(lambda: ops.chain_select_ref(*maps, valid), reps=3, warmup=1)
            nbytes = sum(chain_select_bytes(torch, p) for p in per)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"time chain_select clip axis {kind}: one launch {ms:.4f} ms, {C} single-clip "
                f"launches {singles_ms:.4f} ms ({ms / singles_ms:.3f}x; graph replay), plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB), "
                f"{ms / bound:.2f}x the bound [{card}]")
            stats.update({f"ms_clips{C}_{kind}": ms, f"singles_ms_clips{C}_{kind}": singles_ms,
                          f"bound_ms_clips{C}_{kind}": bound})
        del per, maps, got, singles, want
    return stats


def stream_frames(clips, C, n):
    """(C, H, W, 3) frames of timesteps 0..n: clip c the synthetic clip of
    texture seed c."""
    import numpy as np
    return [np.ascontiguousarray(np.stack([clips[c][k] for c in range(C)]))
            for k in range(n + 1)]


RING = ("mem_imgs", "mem_flow", "mem_occl", "mem_sigma", "mem_fmap", "mem_cnet")


def same_state_frame(single, st, c, img, cache=None):
    """Clip ``c``'s next frame through the single-clip tracker ``single``
    from the streaming tracker's state: the clip's ring copied into the
    tracker's, its frame index set; ``cache`` its FlowCache."""
    for name in RING:
        getattr(single, name).copy_(getattr(st, name)[c])
    single.current_frame_i = st.current_frame_i
    single.flow_cache = cache
    return single.track(img).result


def frame_gate(g) -> bool:
    """The main path's frame gate: <= 1% of pixels over 0.5 px, median <=
    0.05 px, occlusion and sigma shares <= 1%."""
    return g["far"] <= 0.01 and g["median"] <= 0.05 and g["occ"] <= 0.01 and g["sig"] <= 0.01


def worse(a, b):
    """The larger of two gap stats, by share over 0.5 px, median, max."""
    if a is None:
        return b
    key = lambda g: (g["far"], g["median"], g["max"])
    return b if key(b) > key(a) else a


def device_busy_ms(prof) -> float:
    """The device time of the kernels a profiler recorded (one stream)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0) / 1e3


def device_launches(prof) -> int:
    """The device kernels (and memsets, copies) a profiler recorded."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)


def run_stream(torch, ops, dev, cfg, frames, label, per_step, gated=(), gate=True,
               caches=None, injected=None):
    """``StreamingTracker`` over ``frames``: init, then a timestep a frame,
    each timed on the host (synchronised), the launch counts set to 0 just
    before each timestep and read just after. Before each timestep every
    clip of ``gated`` takes the same frame on one single-clip MFT from the
    streaming tracker's state (``same_state_frame``; ``caches`` the clips'
    FlowCaches), and the two results are held by the frame gate (``gate``
    False: the largest gap printed, not gated).
    ``per_step``: the launches of each kernel a timestep; ``injected(st,
    t)``: the timestep's injected rows. returns (host ms a timestep,
    launches, the largest gap, tracker)."""
    from mft_tpu_torch.parallel import StreamingTracker
    from mft_tpu_torch.tracker import MFT
    C = frames[0].shape[0]
    H, W = frames[0].shape[1:3]
    st = StreamingTracker(cfg, n_clips=C, device=dev)
    st.init(frames[0])
    single = None
    if gated:
        single = MFT(cfg, device=dev)
        single.flower = st.flower   # the same weights, one copy
        single.init(frames[0][0])
    counts = {k: 0 for k in ops.launch_counts()}
    step_ms, worst, where = [], None, None
    for k, f in enumerate(frames[1:], start=1):
        ones = {c: same_state_frame(single, st, c, f[c], caches and caches[c]) for c in gated}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        inj = injected(st, k) if injected is not None else None
        res = st.track(f, injected=inj)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        for name, n in ops.launch_counts().items():
            counts[name] += n
        check(tuple(res.flow.shape) == (C, H, W, 2), f"{label} timestep {k}: shape")
        per_clip = [type(res)(res.flow[c], res.occlusion[c], res.sigma[c]) for c in range(C)]
        check_results(torch, per_clip, H, W, f"{label} timestep {k}")
        for c, one in ones.items():
            g = gap_stats(per_clip[c], one)
            if worse(worst, g) is g:
                worst, where = g, (c, k)
    n = len(frames) - 1
    want = expected_counts(ops, **{k: n * v for k, v in per_step.items()}, chain_select=n)
    log(f"{label}: launches over {n} timesteps: {counts}")
    check(counts == want, f"{label}: launch counts {counts} != {want} ({per_step} and one "
                          f"chain + select a timestep)")
    if st.flower.dtype == torch.bfloat16:
        check_tensor_cores(ops, label)
    if gated:
        ok = frame_gate(worst)
        verdict = ("(tolerance: share > 0.5 px <= 1%, median <= 0.05 px, occlusion/sigma "
                   f"shares <= 1%) {'ok' if ok else 'FAIL'}" if gate else "(not gated)")
        log(f"{'check ' if gate else ''}{label}: clips {list(gated)}, each timestep against "
            f"one single-clip MFT from the same state; the largest gap (clip {where[0]}, "
            f"timestep {where[1]}): {gap_text(worst)} {verdict}")
        check(ok or not gate, f"{label}: a clip disagrees with its single-clip tracker")
    return step_ms, counts, worst, st


def free_running_gap(torch, cfg, dev, clips, C, st_results, label):
    """Not gated: each clip's results after every timestep against a
    single-clip MFT that tracked the clip on its own (no shared state), the
    largest gap printed: how far the two drift apart over the timesteps."""
    from mft_tpu_torch.tracker import MFT
    single = MFT(cfg, device=dev)
    worst, where = None, None
    for c in range(C):
        single.init(clips[c][0])
        for k, res in enumerate(st_results, start=1):
            one = single.track(clips[c][k]).result
            g = gap_stats(type(one)(res.flow[c], res.occlusion[c], res.sigma[c]), one)
            if worse(worst, g) is g:
                worst, where = g, (c, k)
    log(f"{label}, free-running (not gated): each clip against a single-clip MFT tracking "
        f"it alone, {len(st_results)} timesteps; the largest gap (clip {where[0]}, timestep "
        f"{where[1]}): {gap_text(worst)}")


def check_stream_plain(torch, st, frame, label):
    """The tracker's next timestep ``frame`` twice from the same state:
    through the kernels and through their plain versions (the flower's
    ``plain_ops``), one batch of the same shapes, so cuDNN runs the same
    algorithms in both. Every clip is held to the main path's frame gate
    (phase 5's ``check_kernels_vs_plain`` over a clip axis); the state is
    restored after. returns: the largest gap."""
    snap = snapshot(st)
    a = st.track(frame)
    restore(st, snap)
    st.flower.plain_ops = True
    try:
        b = st.track(frame)
    finally:
        st.flower.plain_ops = False
        restore(st, snap)
    torch.cuda.synchronize()
    worst, where = None, None
    for c in range(a.flow.shape[0]):
        g = gap_stats(type(a)(a.flow[c], a.occlusion[c], a.sigma[c]),
                      type(b)(b.flow[c], b.occlusion[c], b.sigma[c]))
        if worse(worst, g) is g:
            worst, where = g, c
    ok = frame_gate(worst)
    log(f"check {label} kernels vs plain, one timestep from the same state, every clip; the "
        f"largest gap (clip {where}): {gap_text(worst)} (tolerance: share > 0.5 px <= 1%, "
        f"median <= 0.05 px, occlusion/sigma shares <= 1%) {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: the timestep with kernels disagrees with the plain versions")
    return worst


def run_stream_sweep(torch, ops, dev, card, clips):
    """15b: ``default_config()`` (random weights, seed 0) over C clips in
    lockstep, C in STREAM_CLIPS, STREAM_STEPS timesteps each: launches K1
    11, K2 1, K3 1 a timestep, outputs; ms a timestep (median after
    WARMUP), clip-frames/s, peak memory, and a profiler pass of 2 more
    timesteps for the device's busy ms and idle share. At every C one
    timestep through the kernels against one through their plain versions
    from the same state, every clip held to the frame gate
    (``check_stream_plain``). Clip 0 and clip C - 1 (every clip at C =
    STREAM_GATED) against single-clip trackers from the same state, printed
    and not gated: cuDNN picks other algorithms for a batch of 7·C pairs
    than for one of 7, and with random weights in bf16 the network
    amplifies their rounding past the frame gate in one step;
    ``run_stream_f32`` and the committed weights' configs (15c, 15d) hold
    the clips to it. returns ({C: stats}, launches summed over the
    sweep)."""
    from torch.profiler import ProfilerActivity, profile
    from mft_tpu_torch.config import default_config
    cfg = default_config()
    per_step = dict(corr_lookup_fused=11, corr_lookup=1)
    sweep, launches = {}, {}
    for C in STREAM_CLIPS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        frames = stream_frames(clips, C, STREAM_STEPS + 2)
        label = f"streaming C={C}"
        gated = range(C) if C == STREAM_GATED else sorted({0, C - 1})
        step_ms, counts, worst, st = run_stream(torch, ops, dev, cfg, frames[:STREAM_STEPS + 1],
                                                label, per_step, gated=gated, gate=False)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        plain = check_stream_plain(torch, st, frames[STREAM_STEPS + 1], label)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for f in frames[STREAM_STEPS + 1:]:
                st.track(f)
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t1) / 2
        busy = device_busy_ms(prof) / 2
        median = median_after_warmup(step_ms)
        sweep[C] = dict(ms=median, clip_fps=C * 1e3 / median, peak_gb=peak, busy_ms=busy,
                        idle=1 - busy / prof_ms, gap_median=worst["median"],
                        plain_median=plain["median"])
        log(f"{label}: ms a timestep {', '.join(f'{m:.2f}' for m in step_ms)}; median after "
            f"{WARMUP} warm-ups {median:.3f} ms, {C * 1e3 / median:.2f} clip-frames/s; peak "
            f"device memory {peak:.2f} GB; profiled timesteps: wall {prof_ms:.3f} ms, device "
            f"busy {busy:.3f} ms, idle share {1 - busy / prof_ms:.1%} [{card}]")
        del st, prof
    return sweep, launches


def run_stream_f32(torch, ops, dev, card, clips):
    """15b, gated: ``default_config()`` (random weights) with float32 compute
    and F32_ITERS iterations at the largest C, clips 0 and C - 1 (the largest
    offsets into the batch's volume and maps), F32_STEPS timesteps: launches,
    and each gated clip every timestep against a single-clip MFT from the
    same state (the frame gate): float32 rounds too little for cuDNN's
    batch-dependent algorithms to move the random network past it. Fewer
    iterations and timesteps than (b): a float32 frame (no TF32) takes
    seconds at these batch sizes."""
    from mft_tpu_torch.config import default_config
    cfg = default_config()
    cfg.flow_config.raft_params["compute_dtype"] = "float32"
    cfg.flow_config.flow_iters = F32_ITERS
    C = max(STREAM_CLIPS)
    torch.cuda.empty_cache()
    frames = stream_frames(clips, C, F32_STEPS)
    step_ms, _, _, st = run_stream(torch, ops, dev, cfg, frames, f"streaming f32 C={C}",
                                   dict(corr_lookup_fused=F32_ITERS - 1, corr_lookup=1),
                                   gated=sorted({0, C - 1}))
    log(f"streaming f32 C={C}, {F32_ITERS} iterations: ms a timestep "
        f"{', '.join(f'{m:.1f}' for m in step_ms)} [{card}]")
    del st


def run_stream_trained(torch, ops, dev, card, clips, C=STREAM_GATED):
    """15c: ``fast_config()`` and ``warm_config()`` on the committed weights
    over C clips: launches K1 6, K2 6, K3 1 a timestep; every clip against
    a single-clip tracker from the same state (the frame gate), and, not
    gated, against one tracking the clip alone."""
    from mft_tpu_torch.parallel import StreamingTracker
    out = {}
    for name in ("fast", "warm"):
        cfg = trained_config(name)
        frames = stream_frames(clips, C, STREAM_STEPS)
        label = f"streaming {name} C={C}"
        step_ms, _, _, st = run_stream(torch, ops, dev, cfg, frames, label,
                                       CONFIG_LAUNCHES[name], gated=range(C))
        check(st.iters_schedule is not None and st._warm == (name == "warm"),
              f"{label}: schedule {st.iters_schedule}, warm start {st._warm}")
        median = median_after_warmup(step_ms)
        log(f"{label}: median ms a timestep after {WARMUP} warm-ups {median:.3f} "
            f"({C * 1e3 / median:.2f} clip-frames/s) [{card}]")
        out[name] = median
        free = StreamingTracker(cfg, n_clips=C, device=dev)
        free.flower = st.flower
        free.init(frames[0])
        results = [free.track(f) for f in frames[1:]]
        free_running_gap(torch, cfg, dev, clips, C, results, label)
        del results, st, free
    return out


def run_stream_injected(torch, ops, dev, card, clips, C=STREAM_GATED):
    """15d: one single-clip tracker a clip fills a FlowCache (device tier)
    in a cold pass; the streaming tracker injects every valid finite pair
    from those caches (device rows stacked over the clips): only the
    template pair runs, a batch of C pairs, K1 11, K2 1, K3 1 a timestep;
    every clip against the single-clip tracker's injected frame from the
    same state (the frame gate). ``synth_config()``: the committed weights,
    the runner's tracker."""
    import numpy as np
    from mft_tpu_torch.config import synth_config
    from mft_tpu_torch.io import FlowCache
    from mft_tpu_torch.tracker import MFT
    cfg = synth_config()
    caches = {c: FlowCache(None) for c in range(C)}
    cold = MFT(cfg, device=dev)
    for c in range(C):
        cold.init(clips[c][0], flow_cache=caches[c])
        for img in clips[c][1:STREAM_STEPS + 1]:
            cold.track(img)
    check(all(isinstance(v[0], torch.Tensor) and v[0].is_cuda
              for cache in caches.values() for v in cache.device_cache.values()),
          "the caches' entries are not device tensors")
    batches = []

    def injected(st, t):
        rows = {}
        cands = st._single._candidates(t)
        for i, cand in enumerate(cands):
            if cand.valid and np.isfinite(cand.delta):
                hits = [caches[c].read(cand.left_id, t) for c in range(C)]
                check(all(h is not None for h in hits), f"a cache misses pair {i} of frame {t}")
                rows[i] = tuple(torch.stack([h[f] for h in hits]) for f in range(3))
        batches.append(sum(1 for i, cand in enumerate(cands) if cand.valid and i not in rows))
        return rows

    frames = stream_frames(clips, C, STREAM_STEPS)
    label = f"streaming injected C={C}"
    step_ms, _, _, _ = run_stream(torch, ops, dev, cfg, frames, label,
                                  dict(corr_lookup_fused=11, corr_lookup=1), gated=range(C),
                                  caches=caches, injected=injected)
    check(batches == [1] * STREAM_STEPS, f"{label}: pairs through RAFT a clip {batches}")
    median = median_after_warmup(step_ms)
    log(f"{label}: the template pair alone through RAFT ({C} pairs a timestep); median ms "
        f"a timestep after {WARMUP} warm-ups {median:.3f} ({C * 1e3 / median:.2f} "
        f"clip-frames/s) [{card}]")
    return median


def run_mesh(torch, ops, dev, card, clips):
    """15e: an NCCL process group of world size 1 and its ``make_mesh()``:
    one ``make_train_step(mesh=)`` step (the full recipe on the committed
    weights, bf16 compute, batch MESH_B at MESH_HxMESH_W, TRAIN_ITERS
    iterations) against the same step with no mesh from the same state, and
    one ``StreamingTracker(mesh=)`` timestep of 2 clips against mesh=None,
    bit for bit (deterministic cuDNN). More than one card is not run here."""
    import socket
    import numpy as np
    import torch.distributed as dist
    from mft_tpu_torch.config import default_config
    from mft_tpu_torch.parallel import StreamingTracker, make_mesh
    from mft_tpu_torch.train import synth
    from mft_tpu_torch.train.loop import make_train_step
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        mesh = make_mesh()
        batch = tuple(torch.from_numpy(b).to(dev) for b in
                      synth.make_batch(np.random.default_rng(0), MESH_B, MESH_H, MESH_W))
        out = {}
        for use_mesh in (False, True):
            state, tx = full_state(torch, dev, mixed=True)
            model = state["model"]
            step = make_train_step(model, tx, LOSS_KW, iters=TRAIN_ITERS,
                                   mesh=mesh if use_mesh else None)
            state, metrics = step(state, batch)
            out[use_mesh] = (metrics["train/loss"].clone(),
                             {n: p.grad.detach().clone() for n, p in model.named_parameters()
                              if p.grad is not None},
                             {k: v.detach().clone() for k, v in model.state_dict().items()})
            del state, model, step
            torch.cuda.empty_cache()
        (la, ga, pa), (lb, gb, pb) = out[False], out[True]
        same_g = sum(torch.equal(ga[n], gb[n]) for n in ga) if ga.keys() == gb.keys() else -1
        same_p = sum(torch.equal(pa[k], pb[k]) for k in pa)
        ok = torch.equal(la, lb) and same_g == len(ga) and same_p == len(pa)
        log(f"check mesh (NCCL, world size 1) train step, full recipe, batch {MESH_B} at "
            f"{MESH_H}x{MESH_W}, {TRAIN_ITERS} iterations, bf16: loss {float(lb):.6f} vs "
            f"{float(la):.6f} with no mesh; {same_g} of {len(ga)} gradients and {same_p} of "
            f"{len(pa)} tensors after the update bit-identical {'ok' if ok else 'FAIL'}")
        check(ok, "the world-size-1 mesh step differs from the step with no mesh")
        frames = stream_frames(clips, 2, 1)
        res = {}
        for use_mesh in (False, True):
            st = StreamingTracker(default_config(), n_clips=2, mesh=mesh if use_mesh else None,
                                  device=dev)
            st.init(frames[0])
            res[use_mesh] = st.track(frames[1])
            del st
        ok = all(torch.equal(getattr(res[True], f), getattr(res[False], f))
                 for f in ("flow", "occlusion", "sigma"))
        log(f"check mesh (NCCL, world size 1) streaming timestep, 2 clips at 512x512: bit for "
            f"bit with mesh=None {'ok' if ok else 'FAIL'} (more than one card: not run) "
            f"[{card}]")
        check(ok, "the world-size-1 mesh streaming timestep differs from mesh=None")
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()


def run_streaming(torch, ops, dev, card):
    """Phase 15: K3's clip axis (a), the streaming sweep (b), the committed
    weights' fast and warm configs (c), injection (d), the mesh (e).
    returns (clip-axis stats, the sweep's launches)."""
    t0 = time.perf_counter()
    cs = check_chain_select_clips(torch, ops, dev, card)
    check_chain_select_clips(torch, ops, dev, card, C=max(STREAM_CLIPS), timed=False)
    log(f"phase 15a seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    clips = [synthetic_clip(STREAM_STEPS + 2, seed=c) for c in range(max(STREAM_CLIPS))]
    log(f"phase 15: {len(clips)} synthetic clips of {STREAM_STEPS + 3} frames in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sweep, launches = run_stream_sweep(torch, ops, dev, card, clips)
    torch.cuda.empty_cache()
    # K2 and K1 on the largest C's batch of 7·C pairs, sampled pixels
    check_lookup_hd(torch, ops, dev, card, 64, 64, n_sample=STREAM_SAMPLE,
                    pairs=B * max(STREAM_CLIPS))
    run_stream_f32(torch, ops, dev, card, clips)
    log(f"phase 15b seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    run_stream_trained(torch, ops, dev, card, clips)
    log(f"phase 15c seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    run_stream_injected(torch, ops, dev, card, clips)
    log(f"phase 15d seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    run_mesh(torch, ops, dev, card, clips)
    log(f"phase 15e seconds {time.perf_counter() - t0:.2f}")
    summary = "; ".join(f"C={C} {v['ms']:.2f} ms, {v['clip_fps']:.2f} clip-frames/s, idle "
                        f"{v['idle']:.1%}, peak {v['peak_gb']:.2f} GB" for C, v in sweep.items())
    log(f"streaming sweep: {summary} [{card}]")
    return cs, launches


# --------------------------------------------------------------------------- #
# phase 16: the RAFT variants
# --------------------------------------------------------------------------- #
SMALL_RADIUS, SMALL_C = 3, 128   # the small model's lookup radius and fnet width
VARIANT_FRAMES = 3               # tracked frames of each big variant
# the big model's variants: name -> raft_params; 'morelayers' has an OU tree
# of its own (random weights), the others share the committed weights' tree
BIG_VARIANTS = {
    "morelayers": {"occlusion_module": "separate_with_uncertainty_morelayers"},
    "upsample8": {"occlusion_module": "separate_with_uncertainty_upsample8"},
    "relu_uncertainty": {"relu_uncertainty": True},
    "normalized_features": {"normalized_features": True},
}
# stated tolerance of the fused encoder against the two encoders apart, f32,
# TF32 off: |fused - apart| <= atol + rtol*|apart|. cuDNN sums each grouped
# conv in an order of its own algorithm; through 17 convs and the instance
# norms (which divide by the features' spread) f32 rounding stays far below
# 1e-3 of the features' O(1) values
FUSED_ENCODER_TOL = (1e-3, 1e-3)


def small_config(method="auto"):
    """``default_config()`` with the small RAFT: its raft_params with
    ``small`` set (and ``corr_method``), random weights from seed 0."""
    from mft_tpu_torch.config import default_config
    cfg = default_config()
    cfg.flow_config.raft_params = dict(cfg.flow_config.raft_params, small=True,
                                       corr_method=method)
    return cfg


def check_small_lookup(torch, ops, dev, card):
    """16a: K2 at the small model's radius 3 on the 512x512 slice's volume
    (7 pairs x 4096 pixels, levels 64^2..8^2: the volume of C = 128 features
    has the big model's shape), uniform and local coordinates, f32 and bf16:
    bit for bit with its plain version (the same float ops in the same
    order, as at radius 4), timed by graph replay beside the plain version,
    ``F.grid_sample`` per level and the bound. returns {(dtype, kind):
    stats}."""
    r, n = SMALL_RADIUS, (2 * SMALL_RADIUS + 1) ** 2
    gen = torch.Generator(device=dev).manual_seed(31)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("uniform", "local")}
    stats = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(dtype)
               for h, w in LEVELS]
        for kind, c in coords.items():
            kernel = lambda: ops.corr_lookup(pyr, c, r)
            plain = lambda: ops.corr_lookup_ref(pyr, c, r)
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            differ = differing(torch, got, want)
            label = f"lookup r {r} {name} {kind}"
            log(f"check {label}: shape {tuple(got.shape)}, {differ} of {got.numel()} outputs "
                f"differ from the plain version's bits (tolerance: bit for bit)")
            check(tuple(got.shape) == (B, P, len(LEVELS) * n) and differ == 0,
                  f"{label} disagrees with its plain version")
            ms = graph_ms(kernel)
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
            nbytes = (window_tap_bytes(LEVELS, c, pyr[0].element_size(), r) + c.numel() * 4
                      + got.numel() * got.element_size())
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            lib_ms, lib = grid_sample_lookup(torch, pyr, c, r)
            log(f"time {label}: kernel {ms:.4f} ms (graph replay), plain {plain_ms:.3f} ms, "
                f"F.grid_sample per level {lib_ms:.4f} ms (max_abs_err to the plain version "
                f"{max_err(lib, want):.3e}), bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB) "
                f"[{card}]")
            stats[(name, kind)] = dict(max_abs_err=max_err(got, want), ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by="bytes", library_ms=lib_ms)
            del got, want, lib
        del pyr
    return stats


def run_small_path(torch, ops, dev, card, method="auto"):
    """16b: ``MFT(small_config(method))`` at 512x512 (7 deltas, 12
    iterations, bf16, random weights): FRAMES tracked frames, launches a
    frame ('auto': K1 0, K2 12, K3 1; 'alt': K4 12, K3 1), outputs, ms a
    frame, peak memory, a profiler pass of 2 more frames (device busy ms,
    idle share) and one frame through the kernels against one through the
    plain versions from the same state (the frame gate). returns (launches,
    stats)."""
    from torch.profiler import ProfilerActivity, profile
    from mft_tpu_torch.tracker import MFT
    label = f"small {method}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracker = MFT(small_config(method), device=dev)
    cfg = tracker.flower.cfg
    check(cfg.small and cfg.effective_corr_radius == SMALL_RADIUS
          and tracker.flower.model.fnet.conv2.out_channels == SMALL_C,
          f"{label}: not the small model ({cfg})")
    iters = tracker.flower.iters
    frames = synthetic_clip(FRAMES + 3)
    ops.reset_launch_counts()
    results, frame_ms = track_frames(torch, tracker, frames[:FRAMES + 1])
    counts = ops.launch_counts()
    per_frame = {"corr_lookup" if method == "auto" else KERNEL_OF[method]: iters}
    want = expected_counts(ops, **{k: FRAMES * v for k, v in per_frame.items()},
                           chain_select=FRAMES)
    log(f"{label}: launches over {FRAMES} tracked frames: {counts}")
    check(counts == want, f"{label}: launch counts {counts} != {want} ({per_frame}, no "
                          f"fused lookup, and 1 chain + select per tracked frame)")
    check_tensor_cores(ops, label)
    H, W = frames[0].shape[:2]
    check_results(torch, results, H, W, label)
    median = median_after_warmup(frame_ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for img in frames[FRAMES + 1:FRAMES + 3]:
            tracker.track(img)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t1) / 2
    busy = device_busy_ms(prof) / 2
    launches = device_launches(prof) / 2
    log(f"{label} frame ms: {', '.join(f'{m:.2f}' for m in frame_ms)}; median after "
        f"{WARMUP} warm-up frames {median:.3f} ms ({1e3 / median:.2f} frames/s); peak device "
        f"memory {peak:.3f} GB; profiled frames: wall {prof_ms:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / prof_ms:.1%}, {launches:.1f} device "
        f"launches a frame [{card}]")
    del prof
    check_kernels_vs_plain(torch, tracker, frames[FRAMES + 3], label)
    return counts, dict(ms=median, busy_ms=busy, idle=1 - busy / prof_ms, peak_gb=peak)


def run_big_variants(torch, ops, dev, card):
    """16c: ``MFT`` with each big variant of BIG_VARIANTS at 512x512,
    VARIANT_FRAMES tracked frames each: launches K1 11, K2 1, K3 1 a frame,
    outputs, a frame through the kernels against the plain versions (the
    frame gate); the variants that share the committed weights' tree on
    them, 'morelayers' on random weights. Then the RAFT without OU heads
    (occlusion_module None, random weights) on one 7-pair batch: K1 on all
    12 iterations and no K2 (convc1 is the lookup's only consumer), its flow
    against the plain versions' (the frame gate's flow terms)."""
    import numpy as np
    from mft_tpu_torch.config import default_config, synth_config
    from mft_tpu_torch.models.raft import RAFT
    from mft_tpu_torch.models.raft.raft import RAFTParams
    from mft_tpu_torch.models.raft.wrapper import random_init
    from mft_tpu_torch.tracker import MFT
    frames = synthetic_clip(VARIANT_FRAMES + 1)
    for name, params in BIG_VARIANTS.items():
        cfg = default_config() if name == "morelayers" else synth_config()
        cfg.flow_config.raft_params = dict(cfg.flow_config.raft_params, **params)
        tracker = MFT(cfg, device=dev)
        iters = tracker.flower.iters
        ops.reset_launch_counts()
        results, frame_ms = track_frames(torch, tracker, frames[:VARIANT_FRAMES + 1])
        counts = ops.launch_counts()
        n = VARIANT_FRAMES
        want = expected_counts(ops, corr_lookup_fused=n * (iters - 1), corr_lookup=n,
                               chain_select=n)
        weights = "random weights" if name == "morelayers" else "committed weights"
        log(f"{name} ({weights}): launches over {n} tracked frames: {counts}; frame ms "
            f"{', '.join(f'{m:.2f}' for m in frame_ms)} [{card}]")
        check(counts == want, f"{name}: launch counts {counts} != {want} (11, 1 and 1 per "
                              f"tracked frame)")
        check_tensor_cores(ops, name)
        H, W = frames[0].shape[:2]
        check_results(torch, results, H, W, name)
        check_kernels_vs_plain(torch, tracker, frames[VARIANT_FRAMES + 1], name)
        del tracker, results
    model = random_init(RAFT(RAFTParams(occlusion_module=None, compute_dtype="bfloat16")), 0)
    model = model.to(dev).eval().requires_grad_(False)
    model.set_compute_dtype(torch.bfloat16)
    clip = synthetic_clip(B)
    rgb = lambda ims: torch.from_numpy(np.stack(ims)[..., ::-1].copy()).to(dev).permute(
        0, 3, 1, 2).float()
    img1, img2 = rgb([clip[0]] * B), rgb(clip[1:])
    ops.reset_launch_counts()
    with torch.no_grad():
        out = model(img1, img2, iters=12)
    counts = ops.launch_counts()
    with torch.no_grad():
        ref = model(img1, img2, iters=12, plain=True)
    dflow = (out["flow"] - ref["flow"]).norm(dim=-1)
    med, far = float(dflow.median()), float((dflow > 0.5).float().mean())
    ok = (list(out) == ["flow", "coords"] and counts == expected_counts(
        ops, corr_lookup_fused=12) and bool(torch.isfinite(out["flow"]).all())
          and med <= 0.05 and far <= 0.01)
    log(f"check no OU heads (7 pairs, 12 iterations): outputs {list(out)}, launches {counts}; "
        f"flow against the plain versions: median {med:.3e} px, share > 0.5 px {far:.4%} "
        f"(tolerance: K1 12, nothing else; median <= 0.05 px, share <= 1%) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "the model without OU heads: launches or flow wrong")


def run_small_training(torch, ops, dev, card):
    """16d: the small model's full recipe through the entry point's parser
    and ``train`` (``--small``; random weights; TRAIN_STEPS steps of batch
    TRAIN_B at TRAIN_H x TRAIN_W, 12 iterations, bf16 compute over f32
    parameters) on a Sintel-form tree: finite losses, every parameter moved,
    a step 12 K2 launches and 12 backward launches at radius 3 and nothing
    else, the export, which a small tracker loads and tracks 2 frames with;
    then one f32 step through the kernels and through the plain versions
    (deterministic cuDNN) within TRAIN_PLAIN_TOL. returns (launches, ms a
    step)."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace
    from mft_tpu_torch import environment
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.train import loop, synth
    per_step, step_ms, losses = [], [], []

    def on_step(state, metrics, seconds):
        per_step.append(ops.launch_counts())
        ops.reset_launch_counts()
        step_ms.append(1e3 * seconds)
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f"small step {state['step']}: non-finite metrics {vals}")
        losses.append(vals["train/loss"])

    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        synth.write_sintel_tree(tmp / "sintel", frames=SINTEL_FRAMES, H=SINTEL_H, W=SINTEL_W)
        settings = environment.env_settings
        environment.env_settings = lambda: SimpleNamespace(sintel_dir=str(tmp / "sintel"))
        try:
            args = loop.get_parser().parse_args([
                "--name", "small", "--stage", "sintel", "--small",
                "--num_steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_B),
                "--image_size", str(TRAIN_H), str(TRAIN_W), "--iters", str(TRAIN_ITERS),
                "--mixed_precision", "--num_workers", "6", "--lr", "0.000125",
                "--wdecay", "0.00001", "--gamma=0.85", "--checkpoint_dir",
                str(tmp / "checkpoints")])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            state = loop.train(args, on_step=on_step)
        finally:
            environment.env_settings = settings
        peak = torch.cuda.max_memory_allocated() / 2**30
        model = state["model"]
        check(model.cfg.small and state["step"] == TRAIN_STEPS
              and len(per_step) == TRAIN_STEPS, f"small: {state['step']} steps")
        want = expected_counts(ops, corr_lookup=TRAIN_ITERS, corr_lookup_bwd=TRAIN_ITERS)
        for k, counts in enumerate(per_step, start=1):
            check(counts == want, f"small step {k}: launches {counts} != {want}")
        from mft_tpu_torch.models.raft.wrapper import random_init
        init = random_init(type(model)(model.cfg), 1234).state_dict()   # build_state's seed
        after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        moved = {k for k in after if not torch.equal(after[k], init[k])}
        weights = [k for k in after if k.endswith(".weight")]
        # a bias that an instance norm follows has a zero gradient in exact
        # arithmetic and starts at zero, so it may stay there: not gated
        log(f"small: {len(moved)} of {len(after)} tensors moved from the initial weights, "
            f"{sum(k in moved for k in weights)} of {len(weights)} conv weights")
        check(all(k in moved for k in weights), "small: a conv weight did not move")
        export = Path(args.checkpoint_dir) / args.name / f"small_step{TRAIN_STEPS}.msgpack"
        cfg = small_config()
        cfg.flow_config.model = str(export)
        tracker = MFT(cfg, device=dev)
        clip = synthetic_clip(2, H=EXPORT_SIZE, W=EXPORT_SIZE)
        results, _ = track_frames(torch, tracker, clip)
        check_results(torch, results, EXPORT_SIZE, EXPORT_SIZE, "small export")
        del tracker, state, model
        steady = sorted(step_ms[1:])
        median = steady[len(steady) // 2] if len(steady) % 2 else 0.5 * (
            steady[len(steady) // 2 - 1] + steady[len(steady) // 2])
        log(f"small recipe ({TRAIN_B}x{TRAIN_H}x{TRAIN_W}, {TRAIN_ITERS} iterations, bf16 "
            f"compute over f32 parameters): losses {', '.join(f'{v:.4f}' for v in losses)}; "
            f"step ms {', '.join(f'{m:.1f}' for m in step_ms)}; median after 1 warm-up step "
            f"{median:.1f} ms; peak device memory {peak:.2f} GiB; launches a step K2 "
            f"{TRAIN_ITERS}, backward {TRAIN_ITERS} at radius {SMALL_RADIUS}; the export "
            f"tracks 2 frames [{card}]")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            check_train_plain(torch, ops, dev, card, train_batch(torch, dev, tmp), small=True)
        finally:
            torch.backends.cudnn.deterministic = False
    return {k: sum(c[k] for c in per_step) for k in per_step[0]}, median


def check_fused_encoder(torch, ops, dev, card):
    """16e: the fused encoder (one grouped-conv stack, ``fused_encoder``)
    against fnet and cnet apart on the committed weights at 512x512, f32
    (TF32 off), to FUSED_ENCODER_TOL; ``padded_encode`` of a flower with
    ``fused_encoder`` equal to it bit for bit; both timed in f32 and bf16
    (CUDA events), the bf16 gap printed."""
    from mft_tpu_torch.config import synth_flow_config
    from mft_tpu_torch.models.raft import RAFTFlow
    from mft_tpu_torch.models.raft.encoder_fuse import fused_basic_encode
    img = synthetic_clip(0)[0]
    for dtype in ("float32", "bfloat16"):
        conf = synth_flow_config()
        conf.raft_params = dict(conf.raft_params, compute_dtype=dtype)
        conf.fused_encoder = True
        flower = RAFTFlow(conf, device=dev)
        check(flower.fused_encoder, "fused_encoder not taken")
        rgb = torch.from_numpy(img[..., ::-1].copy()).to(dev)[None].float()
        x = rgb.permute(0, 3, 1, 2)
        with torch.no_grad():
            fused = fused_basic_encode(flower.model, x)
            apart = flower.model.encode(x)
            via = flower.padded_encode(rgb)
            fused_ms = cuda_ms(lambda: fused_basic_encode(flower.model, x), reps=10)
            apart_ms = cuda_ms(lambda: flower.model.encode(x), reps=10)
        errs = [max_err(a, b) for a, b in zip(fused, apart)]
        same = all(torch.equal(a, b) for a, b in zip(via, fused))
        if dtype == "float32":
            atol, rtol = FUSED_ENCODER_TOL
            ok = same and all(within(a, b, atol, rtol) for a, b in zip(fused, apart))
            log(f"check fused encoder f32: fmap max_abs_err {errs[0]:.3e}, cnet {errs[1]:.3e} "
                f"(tolerance atol {atol} + rtol {rtol}); padded_encode bit for bit {same} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, "the fused encoder disagrees with fnet and cnet apart")
        else:
            log(f"fused encoder bf16 (not gated): fmap max_abs_err {errs[0]:.3e}, cnet "
                f"{errs[1]:.3e}; padded_encode bit for bit {same}")
        log(f"time encoder {dtype} 512x512: fused {fused_ms:.3f} ms, fnet + cnet apart "
            f"{apart_ms:.3f} ms (CUDA events, 10 calls) [{card}]")
        del flower


def run_variants(torch, ops, dev, card):
    """Phase 16: K2, the backward and K4/K5 at radius 3 and C = 128 (a), the
    small model tracking, 'auto' and 'alt' (b), the big variants (c), the
    small model's training (d), the fused encoder (e). returns the stats of
    (a) and the launches of (b) and (d)."""
    t0 = time.perf_counter()
    k2 = check_small_lookup(torch, ops, dev, card)
    bwd = check_lookup_bwd(torch, ops, dev, card, radius=SMALL_RADIUS)
    fk = check_feature_kernels(torch, ops, dev, card, C=SMALL_C, radius=SMALL_RADIUS)
    log(f"phase 16a seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    small_counts, small = run_small_path(torch, ops, dev, card)
    alt_counts, alt = run_small_path(torch, ops, dev, card, "alt")
    log(f"phase 16b seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    run_big_variants(torch, ops, dev, card)
    log(f"phase 16c seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    train_counts, train_ms = run_small_training(torch, ops, dev, card)
    log(f"phase 16d seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    check_fused_encoder(torch, ops, dev, card)
    log(f"phase 16e seconds {time.perf_counter() - t0:.2f}")
    log(f"small model 512x512: 'auto' {small['ms']:.3f} ms a frame (busy {small['busy_ms']:.3f} "
        f"ms, idle {small['idle']:.1%}, peak {small['peak_gb']:.3f} GB), 'alt' {alt['ms']:.3f} "
        f"ms (busy {alt['busy_ms']:.3f} ms, idle {alt['idle']:.1%}); training step "
        f"{train_ms:.1f} ms [{card}]")
    return dict(k2=k2, bwd=bwd, fk=fk, small=small_counts, alt=alt_counts, train=train_counts)


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
        f"(one nvcc per source, started together: {' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_log.splitlines():   # registers, spills per kernel
        if any(key in line for key in ("Compiling entry", "Used", "spill")):
            log(line.strip())
    log(f"phase 2 seconds {time.perf_counter() - t:.2f}")

    try:
        check_sass(_build, path)
        for kernel, instances in FRAME_CHECKED.items():
            check_frames(_build, kernel, instances)
        t = time.perf_counter()
        lk = check_lookups(torch, ops, dev, card)
        cs = check_chain_select(torch, ops, dev, card)
        log(f"phase 3 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        fk = check_feature_kernels(torch, ops, dev, card)
        log(f"phase 3b seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        vk = check_volume_kernels(torch, ops, dev, card)
        log(f"phase 3c seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        fo = check_fold_kernels(torch, ops, dev, card)
        cv, cv_shapes = check_conv_kernel(torch, ops, dev, card)
        log(f"phase 3d seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        wk = check_warp_kernel(torch, ops, dev, card)
        log(f"phase 3e seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        counts, volume_median, volume_tracker, results, nxt = run_main_path(torch, ops, dev,
                                                                            card)
        log(f"phase 4-5 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        counts["bilinear_warp"] = run_slice_path(torch, ops, card, volume_tracker, results,
                                                 nxt)
        del results
        log(f"phase 11 (512x512) seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        for method in ("alt", "win"):
            c = run_method_path(torch, ops, dev, card, method, volume_tracker,
                                volume_median)
            counts[KERNEL_OF[method]] = c[KERNEL_OF[method]]
        log(f"phase 6 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        for method in VOLUME_KERNEL_OF:
            c = run_method_path(torch, ops, dev, card, method, volume_tracker,
                                volume_median)
            counts[KERNEL_OF[method]] = c[KERNEL_OF[method]]
        log(f"phase 8 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        for method in NEW_PATHS:
            c = run_method_path(torch, ops, dev, card, method, volume_tracker,
                                volume_median)
            for kname, n in path_per_frame(method, 12).items():
                if kname not in ("corr_lookup_fused", "corr_lookup"):
                    counts[kname] = c[kname]
        log(f"phase 10 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        k1_window_share(torch, ops, volume_tracker, nxt, "main path, random weights")
        del volume_tracker
        torch.cuda.empty_cache()
        run_configs(torch, ops, dev, card)
        log(f"phase 12 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        run_uhd(torch, ops, dev, card)
        log(f"phase 7 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        counts["bilinear_warp"] += run_hd(torch, ops, dev, card)
        log(f"phase 9 (and 11 at 1080x1920) seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        tapvid_counts = run_tapvid(torch, ops, dev, card)
        log(f"phase 13 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        bw, recipes = run_training(torch, ops, dev, card)
        log(f"phase 14 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        cs_clips, stream_counts = run_streaming(torch, ops, dev, card)
        log(f"phase 15 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        var = run_variants(torch, ops, dev, card)
        log(f"phase 16 seconds {time.perf_counter() - t:.2f}")
        for stats in (*lk.values(), cs, *fk.values(), *vk.values(), *fo.values(), cv,
                      *wk.values(), *bw.values(), *var["k2"].values(), *var["bwd"].values(),
                      *var["fk"].values()):
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
        dict(name="corr_lookup", route="cuda", source=src + "corr_gather.cu",
             replaces="mft_tpu/ops/corr_lookup_pallas.py:168",
             launches=counts["corr_lookup"], **lk[("lookup", "bfloat16")]),
        dict(name="chain_select", route="cuda", source=src + "chain_select.cu",
             replaces="mft_tpu/ops/warp_pallas.py:432",
             launches=counts["chain_select"], **cs, **cs_clips, library_ms=None),
        dict(name="corr_lookup_alt", route="cuda", source=src + "corr_alt.cu",
             replaces="mft_tpu/ops/alt_corr_pallas.py:118",
             launches=counts["corr_lookup_alt"],
             **fk[("corr_lookup_alt", "bfloat16", "local")], library_ms=None),
        dict(name="corr_lookup_win", route="cuda", source=src + "corr_alt.cu",
             replaces="mft_tpu/ops/alt_corr_pallas.py:281",
             launches=counts["corr_lookup_win"],
             **fk[("corr_lookup_win", "bfloat16", "local")], library_ms=None),
    ]
    replaces = {"corr_lookup_q": 654, "corr_lookup_packed": 808,
                "corr_lookup_packed_i8": 868, "corr_lookup_t": 1151}
    for kname, line in replaces.items():
        source = "corr_volume.cu" if kname == "corr_lookup_t" else "corr_gather.cu"
        kernels.append(dict(name=kname, route="cuda", source=src + source,
                            replaces=f"mft_tpu/ops/corr_lookup_pallas.py:{line}",
                            launches=counts[kname], **{"library_ms": None,
                                                       **vk[(kname, "bfloat16", "uniform")]}))
    for kname, line, source in (("corr_lookup_folded", 456, "corr_gather.cu"),
                                ("corr_lookup_mixed", 1028, "corr_gather.cu")):
        local = fo[(kname, "bfloat16", "local")]
        kernels.append(dict(name=kname, route="cuda", source=src + source,
                            replaces=f"mft_tpu/ops/corr_lookup_pallas.py:{line}",
                            launches=counts[kname], **fo[(kname, "bfloat16", "uniform")],
                            ms_local=local["ms"], library_ms_local=local["library_ms"]))
    # the bf16 products on the tensor cores (their f32 versions, product.cu,
    # run on no path)
    kernels.append(dict(name="corr_build_folded_tc", route="cuda",
                        source=src + "product_tc.cu",
                        replaces="mft_tpu/ops/corr_lookup_pallas.py:556",
                        launches=counts["corr_build_folded"],
                        **fo[("corr_build_folded", "bfloat16")]))
    # per launch: the means over one frame's 109 convs (per shape in the log)
    kernels.append(dict(name="conv_pallas_tc", route="cuda", source=src + "product_tc.cu",
                        replaces="mft_tpu/ops/conv_pallas.py:84",
                        launches=counts["conv_pallas"], **cv))
    # the tracker's #14 shape (TPU path at 1080x1920); every shape in the log
    kernels.append(dict(name="bilinear_warp", route="cuda", source=src + "warp.cu",
                        replaces="mft_tpu/ops/warp_pallas.py:113",
                        launches=counts["bilinear_warp"], **wk["pallas 7x1080x1920x6"]))
    for k in kernels:   # the runner's path (phase 13), its counts reset before it
        if k["name"] in ("corr_lookup_fused", "corr_lookup", "chain_select", "bilinear_warp"):
            k["launches_tapvid"] = tapvid_counts[k["name"]]
    # the streaming path (phase 15b, every C of the sweep, its counts reset
    # before each C's timesteps): K1, K2 and K3 with its clip axis
    for k in kernels[:3]:
        k["launches_streaming"] = stream_counts[k["name"]]
    # the training path (phase 14b, the full recipe's steps): K2 and its
    # backward; the backward timed at the training shape in bf16
    train = recipes["full"]["launches"]
    kernels[1]["launches_train"] = train["corr_lookup"]
    local = bw[("train", "bfloat16", "local")]
    kernels.append(dict(name="corr_lookup_bwd", route="cuda", source=src + "corr_lookup_bwd.cu",
                        replaces="mft_tpu/models/raft/corr.py:236",
                        launches=train["corr_lookup_bwd"], **bw[("train", "bfloat16", "uniform")],
                        ms_local=local["ms"], bound_ms_local=local["bound_ms"],
                        library_ms_local=local["library_ms"]))
    # the small model (phase 16): its tracked frames' launches ('auto': K2, K3;
    # 'alt': K4, K3), its training steps' (K2, the backward), and the times at
    # radius 3 (C = 128 for K4/K5) beside their bounds, bf16, on the
    # coordinates of each kernel's own entry (K2, the backward: uniform;
    # K4/K5: local)
    small = {"corr_lookup": (var["small"], var["k2"][("bfloat16", "uniform")]),
             "chain_select": (var["small"], None),
             "corr_lookup_alt": (var["alt"], var["fk"][("corr_lookup_alt", "bfloat16", "local")]),
             "corr_lookup_win": (None, var["fk"][("corr_lookup_win", "bfloat16", "local")]),
             "corr_lookup_bwd": (var["train"], var["bwd"][("train", "bfloat16", "uniform")])}
    for k in kernels:
        if k["name"] in small:
            counts_small, st = small[k["name"]]
            if counts_small is not None:
                k["launches_small"] = counts_small[k["name"]]
            if st is not None:
                k.update({f"{key}_small": st[key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
                          if st.get(key) is not None})
    kernels[1]["launches_small_train"] = var["train"]["corr_lookup"]
    log(f"total seconds {time.perf_counter() - t_all:.2f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
