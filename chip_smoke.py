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
   weight's gradient finite and nonzero on some step (whether each moved is
   printed: with random weights the loss can reach 1e18-1e25, the
   gradients' float32 global norm overflows, and the clip then scales every
   update to 0, as optax's does), the export tracked with; one f32 step through the kernels
   against the plain versions within ``TRAIN_PLAIN_TOL``; (e) the fused
   encoder (``fused_encoder``, one grouped-conv stack for fnet and cnet)
   against the two encoders apart in f32 within ``FUSED_ENCODER_TOL``,
   both timed.
17. the demo apps and the submission writers: (a) ``apps.demo.run`` on 12
   frames of the synthetic clip written as PNGs, ``synth`` (the committed
   weights), grid spacing 30: ``_points.mp4`` and ``_edit.mp4`` (V3, V1 and
   V2 once a frame each a file) that the port reads back as 12 frames of
   512x512x3; launches K1 11, K2 1, K3 1 a tracked frame and the warp 1 a
   point conversion; the median error of the last frame's tracks (queries
   whose true position stays 16 px inside) <= 1 px; every frame's
   ``warp_forward`` of the edit and of its mask on the card against the
   plain splat on the CPU within ``SPLAT_ATOL`` (0-255 units), the uint8
   edit frames within 1 level, the differing pixels counted; frames/s end
   to end and the PNG decode and JPEG encode shares printed; (b)
   ``apps.flow_demo.run`` on 4 pairs with ``--show_ou``: 1536x512x3
   panels, K1 11 and K2 1 a pair, the median flow against the true
   (-2, -1) printed; (c) the Sintel writer on a ``test/final`` tree of 2
   scenes x 3 frames of 436x1024 (each .flo equal to a direct
   ``compute_flow`` with the same ``init_flow`` chain) and the KITTI writer
   on ``testing/image_2`` with 2 pairs of 375x1242 (each PNG within the
   1/64 px quantisation of a direct ``compute_flow``), committed weights;
18. the rest of training: (a) ``train.gen_synth_data`` writes 6 shards of
   256x320, T = 8, and ``train.train_synth`` trains on them at its defaults
   (batch 8, 256x320, 12 iterations, bf16 over f32, train-mode batch norm)
   for 20 steps with a checkpoint, an export and a validation every 10, then
   ``--resume`` to step 24: finite losses, the resumed step count, launches
   a step K2 12 and the backward 12 (the validation's 12 K2 counted apart),
   the export read back bit for bit with the model, ``run_val`` leaving the
   running statistics as they were; steps/s and the data-wait share; (b)
   ``python -m mft_tpu_torch.parallel.multicard --ranks 1``: a frozen-BN and
   a full-recipe step (global batch 8 at 368x768) and streaming 8 clips at
   512x512 through a mesh of one NCCL rank, bit for bit with one process,
   launches K2 12 and backward 12 a step, K1 11, K2 1, K3 1 a timestep; (c)
   ``train.generate_occlusions_ft3d`` on a FlyingThings3D-form pair at
   540x960 (PFM flows from a seed) on the card against the CPU: a pixel may
   differ only at the consistency test's margin (``MARGIN_RTOL``); (d)
   ``train.kubric_longflow.track_scene`` on a MOVi-E-form scene (24 frames,
   256x256, 10 instances) on the card against the CPU: flows within 1
   float32 ulp, occlusions equal except at the depth test's margin; the
   time a pair and a scene printed;
19. JPEG (no Pallas site: the JAX package runs cv2/PIL on the host): (a) J1
   (host entropy coding, ``jpeg_entropy.cu``), J2 and J3 (the decode and
   encode pixel stages, ``jpeg.cu``) bit for bit with their plain versions
   (0 differing coefficients, bytes and pixels) over 4:4:4, 4:2:2, 4:2:0,
   4:4:0, 4:1:1 and grey, qualities 15, 50, 95, sizes 1x1, 37x53, 127x65,
   512x512 and a 1080x1920 frame, restart intervals 0 and 3; J2 and J3 timed
   by graph replay at 512x512 and 1080x1920 (4:2:0, quality 95) beside their
   bound ((coefficient + pixel bytes) / 3.35 TB/s) and their plain versions,
   J1's native host ms a frame beside the Python plain version's and its
   host bound (the serial chain through the bitstream: cycles a Huffman
   code and a bit field of this frame's scan, at the host's clock); (b) the
   demo of 17a on the clip written as JPEGs by the port's encoder (its
   outputs ``mp4v``; then the image-directory writer writes the 12 frames
   as JPEGs, J3 and J1 once a frame): one J1
   and one J2 a frame read, K1, K2, K3 and warp launches as 17a's, frames/s
   and the decode, encode and rendering shares; (c) a Kinetics-form shard
   (2 records x 24 JPEG frames of 256x256) through ``create_tapvid_dataset``
   and the runner (synth, 'first', 512x512): one J1 a frame and one J2 a
   record, <delta_avg >= 0.9, frames/s; (d) the official recipe for 5
   steps over a Sintel-form tree without the flag, with
   ``--dashcam_augmenentation`` and without it again, one tree and one
   process: 14b's gates each time, J2 = J3 launches > 0 with the flag; ms a
   step, wall ms between steps, the loader-wait share and the loader
   threads' ms a ``jpeg_corrupt``;
20. against the committed fixtures of ``tests/data/torch_fixtures/``
   (``tools/torch_make_fixtures.py`` made them with cv2, PIL and the JAX
   package, which the card's machine lacks): (a) progressive JPEG: J1's
   progressive routine (``jpeg_entropy.cu
   mft_jpeg_huff_decode_progressive``, host code) against its plain version
   scan by scan on every committed progressive file, each decode's sha256
   against cv2's (BGR) and PIL's (RGB); its host ms a frame at 512x512 and
   1080x1920 beside its plain version, its host bound (the codes and bit
   fields of the file's scans) and the baseline file of the same pixels at
   the same quality; ``apps.demo.run`` with the default configuration (the
   big RAFT-OU, 512x512, 7 deltas, 12 iterations, bf16) on the 8 committed
   progressive frames: K1 11, K2 1, K3 1 a tracked frame, the warp 1 a
   frame, J1's progressive routine once a scan and J2 once a frame read
   (its outputs ``mp4v``: V3, V1 and V2 once a frame a file),
   and its tracks bit for bit with a fresh tracker's on the same decoded
   pixels as arrays; (b) the PNG kinds (palettes with and without tRNS,
   1/2/4-bit grey and palettes, grey+alpha at 8 and 16 bits, Adam7) against
   cv2's and PIL's decodes; a 512x512 frame tracked from a reference-named
   ``.pth`` of the committed weights bit for bit with one from the msgpack;
   ``frame_flops()`` at 512x512 and ``peak_flops()``; (c) every ported
   ``utils/vis.py`` helper on seeded inputs against the JAX module's
   outputs' sha256;
21. video files (no Pallas site: the JAX package runs cv2's libavcodec on
   the host): (a) the committed ``mp4v`` fixtures (cv2's writer through the
   JAX package: a pan past the edge, noise at high motion, a still scene
   with a moving patch, 72x40): V1 (the VLC stage, host code,
   ``mpeg4_vlc.cu``) against its plain version (syntax arrays equal), V2
   (``mpeg4.cu``: dequantization, simple IDCT, motion compensation,
   colour) on the card against its plain version bit for bit, the Y planes
   against cv2's sha256 and the BGR frames against cv2's (the gap printed
   per frame, at most 2 levels); (b) random-syntax streams of the plain
   stream writer (1MV/4MV, dquant, ac_pred, every DC threshold, vectors
   past the picture): V1's native writer's bytes and decode and V2 against
   the plain versions; (c) the encoder at 512x512 and 1080x1920 on the
   moving clip: the file written on the card (V3, V1, V2) byte for byte
   with the plain encoder's, decoded back (PSNR printed), V2 and V3 timed
   by graph replay beside their bounds ((syntax + planes + frame bytes) /
   3.35 TB/s) and plain versions, V1's host ms a frame (decode, encode)
   beside the Python plain version and the host bound of its chain of codes
   and bit fields; (d) ``apps.demo.run`` with the default configuration on
   a 12-frame ``.mp4``: V1 and V2 once a frame read, V3, V1 and V2 once a
   frame a file written, K1 11, K2 1, K3 1 a tracked frame, the warp 1 a
   frame, its tracks bit for bit with a fresh tracker's on the same decoded
   frames as arrays, ``_points.mp4`` and ``_edit.mp4`` read back, 12 frames
   each; ``apps.flow_demo --mp4`` on a 3-frame ``.mp4`` writes ``flow.mp4``.
22. Video containers and Motion JPEG: (a) every committed fixture of
   ``tests/data/torch_fixtures/video/`` (``mp4v`` in AVI under two tags and
   in Matroska; MJPEG in AVI, Matroska, MP4 (C11) and QuickTime, at 4:2:0,
   4:2:2, 4:4:4, grey and without DHT) read on the card through the entry
   point (J1 natively and J4, or V1 and V2), every frame's sha256 and the
   frame count and fps as cv2 gave them, J4 on each MJPEG file's batch of
   frames bit for bit with its plain version; (b) J4 (``mjpeg.cu``:
   dequantization with mjpegdec's DC offset, simple IDCT, swscale's
   full-range conversion) bit for bit with its plain version at 512x512
   (4:2:0, 4:2:2, 4:4:4, grey, a batch of 3) and 1080x1920 (4:2:0, 4:2:2),
   timed by graph replay beside its bytes bound ((coefficient + table + BGR
   bytes) / 3.35 TB/s) and its plain version's host time; (c) the writer
   at ``.mp4 .mov .m4v .3gp .avi .mkv``, each file read back on the card
   to the same 14 frames; (d) ``apps.demo.run`` with the default
   configuration on a 12-frame 512x512 MJPEG ``.avi``, its writers writing
   ``.avi``: J1 and J4 once a frame read, V3, V1
   and V2 once a frame a file written, K1 11, K2 1, K3 1 a tracked frame,
   its tracks bit for bit with a fresh tracker's on the same decoded frames
   as arrays, ``_points.avi`` and ``_edit.avi`` read back, 12 frames each.

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


def train_args(tmp, recipe, dashcam=False, name=None):
    """The recipe's CLI arguments, as an @file the parser reads
    (``dashcam``: with ``--dashcam_augmenentation``; ``name``: the run's,
    which names its checkpoint directory)."""
    from mft_tpu_torch.config import SYNTH_WEIGHTS
    name = name or (f"{recipe}_dashcam" if dashcam else recipe)
    lines = ["--name", name, "--stage", "sintel", "--restore_ckpt", str(SYNTH_WEIGHTS),
             "--num_steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_B),
             "--image_size", str(TRAIN_H), str(TRAIN_W), "--iters", str(TRAIN_ITERS),
             "--mixed_precision", "--num_workers", "6", "--lr", "0.000125",
             "--wdecay", "0.00001", "--gamma=0.85", "--uncertainty_loss",
             "huber_non_occluded", "--checkpoint_dir", str(tmp / "checkpoints")]
    if recipe == "official":
        lines += ["--freeze_optical_flow_training", "--freeze_features_training"]
    if dashcam:
        lines += ["--dashcam_augmenentation"]
    path = tmp / f"{name}.txt"
    path.write_text("\n".join(lines) + "\n")
    return f"@{path}"


def run_recipe(torch, ops, dev, card, tmp, recipe, dashcam=False, name=None):
    """14b (and 19d, with ``dashcam`` and without): one recipe through the
    entry point's parser and ``train``.
    Gates: finite losses and metrics; frozen parameters bit-identical and
    trainable ones moved; batch statistics unchanged (official) or moved
    (full); per step 12 K2 launches and 12 (full) or 0 (official) backward
    launches and nothing else (with ``dashcam``, J2 and J3 launches from
    the loader's threads beside them); the checkpoint and its msgpack
    export, which RAFTFlow loads and tracks 2 frames with. returns stats:
    ``step_ms`` from the batch on the card to the step's loss, ``wait_share``
    the rest of the wall time between the first step and the last (the wait
    for the loader), ``launches`` over the steps (and the loader's J2 and J3
    after the last one)."""
    from pathlib import Path
    from mft_tpu_torch.config import SYNTH_WEIGHTS, synth_config
    from mft_tpu_torch.models.raft.wrapper import load_weights
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.train import loop
    official = recipe == "official"
    before = load_weights(Path(SYNTH_WEIGHTS))
    per_step, step_ms, losses, stamps = [], [], [], []

    def on_step(state, metrics, seconds):
        stamps.append(time.perf_counter())
        per_step.append(ops.launch_counts())
        ops.reset_launch_counts()
        step_ms.append(1e3 * seconds)
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(math.isfinite(v) for v in vals.values()),
              f"{recipe} step {state['step']}: non-finite metrics {vals}")
        losses.append(vals["train/loss"])

    args = loop.get_parser().parse_args([train_args(tmp, recipe, dashcam, name)])
    recipe = args.name
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = loop.train(args, on_step=on_step)
    seconds = time.perf_counter() - t0
    tail = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(state["step"] == TRAIN_STEPS and len(per_step) == TRAIN_STEPS,
          f"{recipe}: {state['step']} steps, {len(per_step)} reported")
    bwd = 0 if official else TRAIN_ITERS
    want = expected_counts(ops, corr_lookup=TRAIN_ITERS, corr_lookup_bwd=bwd)
    # with the flag the loader's threads launch J2 and J3 during the steps
    loader = ("jpeg_decode_pixels", "jpeg_encode_pixels") if dashcam else ()
    for k, counts in enumerate(per_step, start=1):
        seen = {n: c for n, c in counts.items() if n not in loader}
        check(seen == {n: c for n, c in want.items() if n not in loader},
              f"{recipe} step {k}: launches {counts} != {want}")
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
    wall_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    wait_share = 1.0 - sum(step_ms[1:]) / sum(wall_ms)
    log(f"{recipe} recipe ({TRAIN_B}x{TRAIN_H}x{TRAIN_W}, {TRAIN_ITERS} iterations, bf16 "
        f"compute over f32 parameters): losses {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step ms {', '.join(f'{m:.1f}' for m in step_ms)}; median after 1 warm-up step "
        f"{median:.1f} ms; wall ms between steps {', '.join(f'{m:.1f}' for m in wall_ms)}, "
        f"the wait for the loader {wait_share:.1%} of it; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches a step K2 {TRAIN_ITERS}, backward {bwd}; "
        f"{seconds:.1f} s with data, checkpoint and export; the export tracks 2 frames "
        f"[{card}]")
    return dict(median_ms=median, step_ms=step_ms, wall_ms=wall_ms, wait_share=wait_share,
                peak_gib=peak / 2**30,
                launches={k: sum(c[k] for c in per_step) + (tail[k] if k in loader else 0)
                          for k in tail})


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
    parameters) on a Sintel-form tree: finite losses, every conv weight's
    gradient finite and nonzero on at least one step (whether it moved is
    printed: random weights on unseeded batches can take the gradients' global
    norm past float32's range, where the clip, as optax's, scales every
    update to 0, or near it, where a weight's clipped gradient is too small
    for AdamW's step to change it), a step 12 K2 launches and 12 backward
    launches at radius 3 and nothing else, the export, which a small tracker
    loads and tracks 2 frames with;
    then one f32 step through the kernels and through the plain versions
    (deterministic cuDNN) within TRAIN_PLAIN_TOL. returns (launches, ms a
    step)."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace
    from mft_tpu_torch import environment
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.train import loop, synth
    per_step, step_ms, losses, grad_log, norms, terms = [], [], [], {}, [], []

    def on_step(state, metrics, seconds):
        per_step.append(ops.launch_counts())
        ops.reset_launch_counts()
        step_ms.append(1e3 * seconds)
        # each conv weight's largest |gradient| this step (the step leaves
        # .grad in place until the next one clears it)
        named = [(n, p) for n, p in state["model"].named_parameters() if n.endswith(".weight")]
        amax = torch.stack([p.grad.detach().abs().max() if p.grad is not None
                            else torch.zeros((), device=p.device) for _, p in named]).tolist()
        for (n, _), g in zip(named, amax):
            grad_log.setdefault(n, []).append(g)
        # the global norm the optimizer's clip computes (float32, every
        # trainable gradient)
        grads = [p.grad.detach() for p in state["model"].parameters() if p.grad is not None]
        norms.append(float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))))
        vals = {k: float(v) for k, v in metrics.items()}
        terms.append({k: v for k, v in vals.items() if k.endswith("loss")})
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
        still = [k for k in weights if k not in moved]
        log(f"small: {len(moved)} of {len(after)} tensors moved from the initial weights, "
            f"{len(weights) - len(still)} of {len(weights)} conv weights; not moved: "
            f"{len(still)}; the gradients' global norm a step "
            f"{', '.join(f'{g:.3e}' for g in norms)}")
        smallest = sorted(weights, key=lambda k: max(grad_log[k]))[:2]
        for k in dict.fromkeys(still[:4] + smallest):
            log(f"small: {k} max |grad| a step {', '.join(f'{g:.3e}' for g in grad_log[k])}"
                f"{' (not moved)' if k in still else ''}")
        if still:
            log(f"small: loss terms a step {terms}")
        dead = [k for k in weights if not any(math.isfinite(g) and g > 0 for g in grad_log[k])]
        check(not dead, f"small: conv weights without a finite nonzero gradient on any step: "
              f"{dead}")
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


# --------------------------------------------------------------------------- #
# phase 17: the demo apps and the submission writers
# --------------------------------------------------------------------------- #
DEMO_FRAMES = 12        # frames of the demo's clip (11 tracked)
DEMO_INSIDE = 16        # px: the queries scored stay this far inside the frame
FLOW_DEMO_PAIRS = 4
SPLAT_ATOL = 1e-3       # 0-255 units: the card's splat against the CPU's
SINTEL_SHAPE, KITTI_SHAPE = (436, 1024), (375, 1242)


def write_png_dir(path, frames):
    from mft_tpu_torch.io.png import encode_png
    path.mkdir(parents=True)
    for k, img in enumerate(frames):
        (path / f"{k:05d}.png").write_bytes(encode_png(img))


def write_jpeg_dir(path, frames, dev, quality=95):
    """The frames as JPEG files, written by the port's encoder on the card."""
    from mft_tpu_torch.io.jpeg import encode_jpeg
    path.mkdir(parents=True)
    for k, img in enumerate(frames):
        (path / f"{k:05d}.jpg").write_bytes(encode_jpeg(img, quality, dev))


def check_image_dir(path, n, shape, label, dev, suffix):
    """n files named *suffix* that the port's reader decodes to ``shape``
    uint8 (a JPEG on the card)."""
    from mft_tpu_torch.io.image import imdecode
    files = sorted(path.iterdir())
    check(len(files) == n and all(f.suffix == suffix for f in files),
          f"{label}: {[f.name for f in files]} in {path.name}, want {n} {suffix} files")
    for f in files:
        img = imdecode(f.read_bytes(), dev)
        check(img is not None and img.shape == shape and img.dtype.name == "uint8",
              f"{label}: {f.name} decodes to {None if img is None else img.shape}, want "
              f"{shape} uint8")


def check_demo_splats(torch, records, label):
    """The card's warp_forward of the edit and of its mask against the plain
    splat of the same flow on the CPU; the uint8 edit frames within 1 level.
    returns: (largest float gap, pixels of the edit frames that differ)."""
    import numpy as np
    from mft_tpu_torch.apps import demo
    from mft_tpu_torch.core import FlowOU
    gap, n_diff, worst = 0.0, 0, 0
    for frame, result, edit, mask in records:
        cpu = FlowOU(result.flow.cpu(), result.occlusion.cpu(), result.sigma.cpu())
        got = result.warp_forward(edit.astype(np.float32), mask=mask, border=0.0).cpu()
        want = cpu.warp_forward(edit.astype(np.float32), mask=mask, border=0.0)
        gap = max(gap, float((got - want).abs().max()))
        got = result.warp_forward(mask.astype(np.float32)[..., None], border=0.0).cpu()
        want = cpu.warp_forward(mask.astype(np.float32)[..., None], border=0.0)
        gap = max(gap, 255.0 * float((got - want).abs().max()))
        a = demo.draw_edit(frame, result, edit, mask).astype(np.int16)
        b = demo.draw_edit(frame, cpu, edit, mask).astype(np.int16)
        n_diff += int((a != b).any(axis=2).sum())
        worst = max(worst, int(np.abs(a - b).max()))
    log(f"{label}: card splat vs CPU splat over {len(records)} frames: largest gap "
        f"{gap:.3g} (0-255 units), edit frames' pixels that differ {n_diff}, by at most "
        f"{worst} level(s)")
    check(gap <= SPLAT_ATOL, f"{label}: splat gap {gap} > {SPLAT_ATOL}")
    check(worst <= 1, f"{label}: edit frames differ by {worst} levels")
    return gap, n_diff


def check_video_file(path, n, shape, label, dev):
    """An ``.mp4`` that the port's reader decodes (V1 on the host, V2 on the
    card) to n frames of ``shape`` uint8."""
    from mft_tpu_torch.io.video import get_video_frames
    frames = list(get_video_frames(path, device=dev))
    check(len(frames) == n and all(f.shape == shape and f.dtype.name == "uint8"
                                   for f in frames),
          f"{label}: {path.name} reads back as {len(frames)} frames of "
          f"{frames[0].shape if frames else None}, want {n} of {shape} uint8")
    return frames


def run_demo(torch, ops, dev, card, tmp, fmt="png"):
    """17a (``fmt`` 'png') and 19b ('jpg'): ``apps.demo.run`` on 12 frames of
    the synthetic clip written as PNGs or as JPEGs (the port's encoder on the
    card, quality 95), synth config, grid spacing 30; the demo writes
    ``mp4v`` files (V3, V1 and V2 once a frame each a file). For 19b the
    image-directory writer then writes the 12 frames as JPEGs (J3 and J1
    once a frame), its counts reset before it and read after it. returns
    (the demo's launch counts, frames/s, the decode, encode and rendering
    shares, the writer's launch counts or None)."""
    import argparse
    import numpy as np
    from mft_tpu_torch.apps import demo
    from mft_tpu_torch.io import video as demo_video
    frames = synthetic_clip(DEMO_FRAMES - 1)
    H, W = frames[0].shape[:2]
    clip = tmp / f"clip_{fmt}"
    if fmt == "png":
        write_png_dir(clip, frames)
    else:
        write_jpeg_dir(clip, frames, dev)
    io_s = [0.0, 0.0, 0.0]                      # decode, JPEG encode, rendering
    records, tracks, stamps = [], [], []

    def timed_frames(path, reverse=False, device="cuda"):
        it = demo_video.get_video_frames(path, reverse, device)
        while True:
            t = time.perf_counter()
            frame = next(it, None)
            io_s[0] += time.perf_counter() - t
            if frame is None:
                return
            yield frame

    class TimedWriter(demo_video.VideoWriter):
        def write(self, frame):
            t = time.perf_counter()
            super().write(frame)
            io_s[1] += time.perf_counter() - t

    def recording_render(frame, result, queries, edit, edit_mask):
        t = time.perf_counter()
        out = render(frame, result, queries, edit, edit_mask)
        io_s[2] += time.perf_counter() - t
        records.append((frame, result, edit, edit_mask))
        tracks.append(out[2])
        stamps.append(time.perf_counter())
        return out

    render = demo.render_frame
    out = tmp / f"demo_{fmt}"
    args = argparse.Namespace(video=str(clip), config="synth", out=str(out),
                              grid_spacing=30, fps=25.0, max_frames=None, device=str(dev))
    saved = demo.get_video_frames, demo.VideoWriter, demo.render_frame
    demo.get_video_frames, demo.VideoWriter, demo.render_frame = (timed_frames, TimedWriter,
                                                                  recording_render)
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = demo.run(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
    finally:
        demo.get_video_frames, demo.VideoWriter, demo.render_frame = saved
    tracked = DEMO_FRAMES - 1
    steady = (len(stamps) - 2) / (stamps[-1] - stamps[1])
    shares = dict(decode=io_s[0] / seconds, encode=io_s[1] / seconds, render=io_s[2] / seconds)
    log(f"demo ({fmt.upper()} frames in, mp4v out): {n} frames in {seconds:.3f} s "
        f"({n / seconds:.2f} frames/s end to end, set-up and first frame included; "
        f"{steady:.2f} frames/s from frame 2 on), {fmt.upper()} decode {io_s[0]:.3f} s "
        f"({shares['decode']:.1%}) + mp4v encode {io_s[1]:.3f} s ({shares['encode']:.1%}); "
        f"rendering (point conversion, dots, two splats, their fetch and the blend) "
        f"{io_s[2]:.3f} s ({shares['render']:.1%}) [{card}]")
    log(f"demo ({fmt}): launches over {n} frames: {counts}")
    check(n == DEMO_FRAMES, f"demo wrote {n} frames, want {DEMO_FRAMES}")
    reads = DEMO_FRAMES if fmt == "jpg" else 0
    want = expected_counts(ops, corr_lookup_fused=11 * tracked, corr_lookup=tracked,
                           chain_select=tracked, bilinear_warp=DEMO_FRAMES,
                           jpeg_huff_decode=reads, jpeg_decode_pixels=reads,
                           mpeg4_encode_pixels=2 * DEMO_FRAMES,
                           mpeg4_vlc_encode=2 * DEMO_FRAMES,
                           mpeg4_decode_pixels=2 * DEMO_FRAMES)
    check(counts == want, f"demo launch counts {counts} != {want} (K1 11, K2 1, K3 1 a "
                          f"tracked frame, the warp 1 a point conversion; one J1 and one J2 "
                          f"a JPEG frame read; V3, V1 and V2 once a frame a file written)")
    for name in ("points", "edit"):
        check_video_file(out / f"{clip.name}_{name}.mp4", DEMO_FRAMES, (H, W, 3),
                         f"demo {name}", dev)
    if fmt == "jpg":
        ops.reset_launch_counts()
        with demo_video.VideoWriter(out / "frames_jpg", device=dev) as w:
            for frame in frames:
                w.write(frame)
        dir_counts = ops.launch_counts()
        check(dir_counts == expected_counts(ops, jpeg_huff_encode=DEMO_FRAMES,
                                            jpeg_encode_pixels=DEMO_FRAMES),
              f"image-directory writer launch counts {dir_counts}")
        check_image_dir(out / "frames_jpg", DEMO_FRAMES, (H, W, 3), "image-directory writer",
                        dev, ".jpg")
    else:
        dir_counts = None
    queries = demo.get_queries(frames[0].shape, 30)
    true = queries - tracked * np.asarray(SHIFT, np.float32)
    inside = ((true >= DEMO_INSIDE) & (true <= np.array([W, H]) - 1 - DEMO_INSIDE)).all(1)
    err = np.linalg.norm(tracks[-1][inside] - true[inside], axis=1)
    log(f"demo: frame {tracked} tracks of {int(inside.sum())} of {len(queries)} queries "
        f"{DEMO_INSIDE} px inside: error to the true position median {np.median(err):.4f} "
        f"px, largest {err.max():.4f} px")
    check(float(np.median(err)) <= 1.0, f"demo: median track error {np.median(err)} > 1 px")
    check_demo_splats(torch, records, "demo")
    return counts, n / seconds, shares, dir_counts


def run_flow_demo(torch, ops, dev, card, tmp):
    """17b: ``apps.flow_demo.run`` on 4 pairs of the clip with --show_ou."""
    import argparse
    import numpy as np
    from mft_tpu_torch.apps import flow_demo
    frames = synthetic_clip(FLOW_DEMO_PAIRS)
    H, W = frames[0].shape[:2]
    write_png_dir(tmp / "pairs", frames)
    flows = []
    panel = flow_demo.flow_panel

    def recording_panel(frame, flow, extra=None):
        flows.append(flow)
        return panel(frame, flow, extra)

    args = argparse.Namespace(video=str(tmp / "pairs"), config="synth", out=str(tmp / "flow"),
                              mp4=False, show_ou=True, fps=10.0, device=str(dev))
    flow_demo.flow_panel = recording_panel
    try:
        ops.reset_launch_counts()
        t = time.perf_counter()
        n = flow_demo.run(args)
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
    finally:
        flow_demo.flow_panel = panel
    log(f"flow demo: {n} pairs in {seconds:.3f} s; launches {counts} [{card}]")
    check(n == FLOW_DEMO_PAIRS, f"flow demo wrote {n} panels")
    check_image_dir(tmp / "flow", FLOW_DEMO_PAIRS, (3 * H, W, 3), "flow demo", dev, ".png")
    want = expected_counts(ops, corr_lookup_fused=11 * n, corr_lookup=n)
    check(counts == want, f"flow demo launch counts {counts} != {want} (K1 11, K2 1 a pair)")
    epe = np.linalg.norm(np.stack(flows) - np.asarray([-SHIFT[0], -SHIFT[1]], np.float32),
                         axis=-1)
    log(f"flow demo (not gated): flow against ({-SHIFT[0]}, {-SHIFT[1]}): median "
        f"end-point error {np.median(epe):.4f} px, median flow "
        f"({np.median(np.stack(flows)[..., 0]):.4f}, {np.median(np.stack(flows)[..., 1]):.4f})")
    return counts


def run_submissions(torch, ops, dev, card, tmp):
    """17c: the Sintel and KITTI writers on synthetic test trees, the
    committed weights, against direct ``compute_flow`` calls."""
    import numpy as np
    from mft_tpu_torch.config import synth_flow_config
    from mft_tpu_torch.eval import submissions
    from mft_tpu_torch.io.png import imread
    from mft_tpu_torch.models.raft import RAFTFlow
    from mft_tpu_torch.train.flow_readers import read_flo, read_kitti_flow
    flower = RAFTFlow(synth_flow_config(), device=dev)
    sintel = tmp / "sintel" / "test" / "final"
    for s in range(2):
        write_png_dir(sintel / f"scene_{s}", synthetic_clip(2, *SINTEL_SHAPE, seed=10 + s))
    t = time.perf_counter()
    n = submissions.create_sintel_submission(flower, tmp / "sintel", tmp / "sintel_out")
    sintel_s = time.perf_counter() - t
    out = sorted((tmp / "sintel_out" / "final").rglob("*.flo"))
    check(n == 4 and len(out) == 4, f"sintel submission: {n} flows, {len(out)} files, want 4")
    gap = 0.0
    for s in range(2):
        images = sorted((sintel / f"scene_{s}").glob("*.png"))
        prev = None
        for i in range(len(images) - 1):
            flow, _ = flower.compute_flow(imread(images[i]), imread(images[i + 1]),
                                          init_flow=prev, numpy_out=True)
            got = read_flo(tmp / "sintel_out" / "final" / f"scene_{s}" / f"frame_{i + 1:04d}.flo")
            gap = max(gap, float(np.abs(got - flow).max()))
            prev = flow
    log(f"sintel submission: 4 .flo of {SINTEL_SHAPE} in {sintel_s:.3f} s, largest gap to "
        f"direct compute_flow with the same init_flow chain {gap:.3g} px [{card}]")
    check(gap == 0.0, f"sintel submission differs from compute_flow by {gap} px")

    kitti = tmp / "kitti" / "testing" / "image_2"
    kitti.mkdir(parents=True)
    from mft_tpu_torch.io.png import encode_png
    for i in range(2):
        a, b = synthetic_clip(1, *KITTI_SHAPE, seed=20 + i)
        (kitti / f"{i:06d}_10.png").write_bytes(encode_png(a))
        (kitti / f"{i:06d}_11.png").write_bytes(encode_png(b))
    t = time.perf_counter()
    n = submissions.create_kitti_submission(flower, tmp / "kitti", tmp / "kitti_out")
    kitti_s = time.perf_counter() - t
    out = sorted((tmp / "kitti_out" / "flow").glob("*.png"))
    check(n == 2 and len(out) == 2, f"kitti submission: {n} flows, {len(out)} files, want 2")
    gap = 0.0
    for i in range(2):
        flow, _ = flower.compute_flow(imread(kitti / f"{i:06d}_10.png"),
                                      imread(kitti / f"{i:06d}_11.png"), numpy_out=True)
        got, valid = read_kitti_flow(tmp / "kitti_out" / "flow" / f"{i:06d}_10.png")
        check(bool((valid == 1).all()), "kitti submission: valid channel not 1")
        gap = max(gap, float(np.abs(got - flow).max()))
    log(f"kitti submission: 2 PNGs of {KITTI_SHAPE} in {kitti_s:.3f} s, largest gap to "
        f"direct compute_flow {gap:.4g} px (quantisation step 1/64) [{card}]")
    check(gap <= 1 / 64, f"kitti submission differs from compute_flow by {gap} px")


def run_apps(torch, ops, dev, card):
    """Phase 17: the demo (a), the flow demo (b), the submissions (c).
    returns the demo's launch counts."""
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        counts, fps, _, _ = run_demo(torch, ops, dev, card, tmp)
        log(f"phase 17a seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        run_flow_demo(torch, ops, dev, card, tmp)
        log(f"phase 17b seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        run_submissions(torch, ops, dev, card, tmp)
        log(f"phase 17c seconds {time.perf_counter() - t0:.2f}")
    return counts


# --------------------------------------------------------------------------- #
# phase 18: the synthetic-shard trainer, the multi-card check, the offline
# ground-truth generators
# --------------------------------------------------------------------------- #
SHARDS, SHARD_T, SHARD_SIZE = 6, 8, (256, 320)   # shards, frames a scene, size
SYNTH_STEPS, SYNTH_SAVE, SYNTH_RESUMED = 20, 10, 24
FT3D_SIZE = (540, 960)                           # FlyingThings3D's frame size
MOVI_T, MOVI_SIZE, MOVI_K = 24, (256, 256), 10   # a MOVi-E scene: frames, size, instances
# phases 18c and 18d's stated tolerance: the generators' float64 operations are
# the CPU's one for one (no fused kernel), so equal results are expected; an
# occlusion bit may differ only where the test's two sides lie within this
# relative distance on the CPU, flows within 1 float32 ulp
MARGIN_RTOL = 1e-9


def synth_step_counts(ops, k, val_after):
    """Launches in on_step's window of step k: 12 K2 and 12 backward, and
    12 more K2 where the validation of step k - 1 ran before it."""
    extra = TRAIN_ITERS if k - 1 in val_after else 0
    return expected_counts(ops, corr_lookup=TRAIN_ITERS + extra, corr_lookup_bwd=TRAIN_ITERS)


def run_synth_training(torch, ops, dev, card, tmp):
    """18a: 6 shards through ``gen_synth_data``, then ``train_synth`` at its
    defaults for SYNTH_STEPS steps with a checkpoint every SYNTH_SAVE, then
    ``--resume`` to SYNTH_RESUMED. Gates: the shard count, finite losses,
    the resumed step count, launches a step, the export bit for bit with the
    model, the validation leaving the running statistics as they were.
    returns the K2 and backward launches of the steps, validation aside."""
    from pathlib import Path
    from mft_tpu_torch.models.raft.wrapper import load_weights
    from mft_tpu_torch.train import gen_synth_data, train_synth
    t0 = time.perf_counter()
    pairs = gen_synth_data.generate(tmp / "shards", SHARD_SIZE, SHARD_T,
                                    count=SHARDS * (SHARD_T - 1), log=lambda msg: None)
    check(pairs == SHARDS * (SHARD_T - 1) and len(list((tmp / "shards").glob("shard_*.npz")))
          == SHARDS, f"synth shards: {pairs} pairs")
    log(f"18a: {SHARDS} shards of {SHARD_SIZE[0]}x{SHARD_SIZE[1]}, T = {SHARD_T} "
        f"(gen_synth_data) in {time.perf_counter() - t0:.2f} s")
    base = ["--data", str(tmp / "shards"), "--save_every", str(SYNTH_SAVE), "--log_every",
            str(SYNTH_SAVE), "--out", str(tmp / "synth_run"), "--export",
            str(tmp / "synth.msgpack")]
    runs = {}
    for label, extra in (("first", ["--steps", str(SYNTH_STEPS)]),
                         ("resumed", ["--steps", str(SYNTH_RESUMED), "--resume"])):
        counts, losses = [], []

        def on_step(state, metrics):
            counts.append(ops.launch_counts())
            ops.reset_launch_counts()
            losses.append(metrics["train/loss"].detach())

        args = train_synth.get_parser().parse_args(base + extra)
        check(args.batch == 8 and tuple(args.size) == SHARD_SIZE and args.iters == TRAIN_ITERS,
              "train_synth's defaults moved")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = train_synth.train(args, on_step=on_step)
        res.update(losses=[float(v) for v in losses], counts=counts,
                   peak=torch.cuda.max_memory_allocated() / 2**30)
        runs[label] = res
    first, resumed = runs["first"], runs["resumed"]
    check(first["state"]["step"] == SYNTH_STEPS and len(first["counts"]) == SYNTH_STEPS,
          f"synth training took {first['state']['step']} steps")
    check(resumed["state"]["step"] == SYNTH_RESUMED
          and resumed["steps"] == SYNTH_RESUMED - SYNTH_STEPS,
          f"resume: at step {resumed['state']['step']} after {resumed['steps']} steps")
    steps = {"corr_lookup": 0, "corr_lookup_bwd": 0}
    for label, res in runs.items():
        check(all(math.isfinite(v) for v in res["losses"]), f"synth {label}: non-finite loss")
        val_after = set(range(SYNTH_SAVE, SYNTH_RESUMED + 1, SYNTH_SAVE)) if label == "first" \
            else set()
        start = res["state"]["step"] - res["steps"]
        for k, c in enumerate(res["counts"], start=start + 1):
            want = synth_step_counts(ops, k, val_after)
            check(c == want, f"synth {label} step {k}: launches {c} != {want}")
            for name in steps:   # the step's own, the validation's aside
                steps[name] += c[name] - (want[name] - TRAIN_ITERS)
    model = resumed["state"]["model"]
    saved = load_weights(Path(tmp / "synth.msgpack"))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    same = sum(torch.equal(saved[k], state[k]) for k in state)
    check(saved.keys() == state.keys() and same == len(state),
          f"the export differs from the model: {same} of {len(state)} tensors equal")
    vbatch = train_synth.fixed_val_batch(*SHARD_SIZE)
    before = {k: v.clone() for k, v in model.named_buffers()}
    val = train_synth.run_val(model, vbatch, TRAIN_ITERS)
    kept = all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    check(kept and all(math.isfinite(v) for v in val.values()),
          f"run_val: statistics kept {kept}, figures {val}")
    for label, res in runs.items():
        log(f"18a synth trainer, {label} run (batch 8 at {SHARD_SIZE[0]}x{SHARD_SIZE[1]}, "
            f"{TRAIN_ITERS} iterations, bf16 over f32, train-mode batch norm): {res['steps']} "
            f"steps to step {res['state']['step']}, losses "
            f"{', '.join(f'{v:.3f}' for v in res['losses'])}; "
            f"{res['steps'] / res['seconds']:.3f} steps/s over {res['seconds']:.2f} s "
            f"(checkpoints, exports and validations inside it included), data-wait share "
            f"{res['data_wait'] / res['seconds']:.1%}; peak device memory {res['peak']:.2f} GiB; "
            f"launches a step K2 {TRAIN_ITERS}, backward {TRAIN_ITERS} (+{TRAIN_ITERS} K2 after "
            f"a validation) [{card}]")
    log(f"18a: resumed at step {SYNTH_STEPS}, ended at {SYNTH_RESUMED}; the export equals the "
        f"model in {same} of {len(state)} tensors; run_val kept the running statistics "
        f"({kept}): {', '.join(f'{k} {v:.4f}' for k, v in val.items())}")
    return steps


def run_multicard_one(torch, card):
    """18b: ``python -m mft_tpu_torch.parallel.multicard --ranks 1``: the
    mesh of one NCCL rank against one process, bit for bit (the full recipe
    with batch statistics included), its launches. returns its summary."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-m", "mft_tpu_torch.parallel.multicard",
                           "--ranks", "1"], cwd=HERE, capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith("multicard:"):
            log("18b " + line)
    check(proc.returncode == 0, f"multicard --ranks 1 exited {proc.returncode}: "
          f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    summary = json.loads(next(x for x in lines if x.startswith("MULTICARD "))[len("MULTICARD "):])
    for recipe in ("frozen", "full"):
        got = {k: v for k, v in summary[recipe]["launches"].items() if v}
        check(summary[recipe]["bit_for_bit"] and got == {"corr_lookup": TRAIN_ITERS,
                                                         "corr_lookup_bwd": TRAIN_ITERS},
              f"multicard {recipe}: {summary[recipe]}")
    got = {k: v for k, v in summary["stream"]["launches"].items() if v}
    check(summary["stream"]["bit_for_bit"] and got == {"corr_lookup_fused": 11,
                                                       "corr_lookup": 1, "chain_select": 1},
          f"multicard streaming: {summary['stream']}")
    return summary


def fb_flows(np, rng, H, W):
    """A forward flow of a few px (leaving the frame at the right border)
    and a backward flow that undoes it, except in a block: float32."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    fwd = np.stack([2.5 + 3 * np.sin(ys / 37) + xs / W * 6, 1.5 * np.cos(xs / 41)], -1)
    fwd += rng.normal(scale=0.2, size=(H, W, 2))
    bwd = -fwd + rng.normal(scale=0.3, size=(H, W, 2))
    h, w = H // 4, W // 4
    bwd[h:2 * h, w:2 * w] += rng.normal(scale=4.0, size=(h, w, 2))
    return fwd.astype(np.float32), bwd.astype(np.float32)


def run_occlusion_generator(torch, dev, card, tmp):
    """18c: ``generate_occlusions_ft3d.process_pair_dir`` on the card on one
    FlyingThings3D-form pair at 540x960 (PFM flows from a seed), against the
    same maps on the CPU: a pixel may differ only at the threshold's margin."""
    import numpy as np
    from mft_tpu_torch.io.png import decode_png
    from mft_tpu_torch.train import generate_occlusions_ft3d as occ
    from mft_tpu_torch.train.flow_readers import write_pfm
    H, W = FT3D_SIZE
    fwd, bwd = fb_flows(np, np.random.default_rng(18), H, W)
    dirs = {d: tmp / "ft3d" / d for d in ("fwd", "bwd", "occ_fwd", "occ_bwd")}
    for d in ("fwd", "bwd"):
        dirs[d].mkdir(parents=True)
    zero = np.zeros((H, W, 1), np.float32)
    for i in range(2):   # frames 6 and 7: into_future 6 pairs with into_past 7
        write_pfm(dirs["fwd"] / f"OpticalFlowIntoFuture_{6 + i:04d}_L.pfm",
                  np.concatenate([fwd if i == 0 else -bwd, zero], -1))
        write_pfm(dirs["bwd"] / f"OpticalFlowIntoPast_{6 + i:04d}_L.pfm",
                  np.concatenate([-fwd if i == 0 else bwd, zero], -1))
    occ.process_pair_dir(dirs["fwd"], dirs["bwd"], dirs["occ_fwd"], dirs["occ_bwd"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = occ.process_pair_dir(dirs["fwd"], dirs["bwd"], dirs["occ_fwd"], dirs["occ_bwd"],
                             device=dev)
    pair_s = time.perf_counter() - t0
    check(n == 1, f"18c: {n} pairs")
    differ = margin = 0
    shares = []
    for f, b, out in ((fwd, bwd, dirs["occ_fwd"] / "OpticalFlowIntoFuture_0006_L.png"),
                      (bwd, fwd, dirs["occ_bwd"] / "OpticalFlowIntoPast_0007_L.png")):
        card_map = decode_png(out.read_bytes()) > 127
        terms = [occ.occlusion_terms(torch.from_numpy(f).to(d), torch.from_numpy(b).to(d))
                 for d in (dev, torch.device("cpu"))]
        (rt_c, rhs_c, out_c), (rt, rhs, oof) = [[t.cpu() for t in ts] for ts in terms]
        cpu_map = ((rt > rhs) | oof).numpy()
        card_terms = ((rt_c > rhs_c) | out_c).numpy()
        check(np.array_equal(card_map, card_terms), "18c: the PNG is not the card's map")
        diff = card_map != cpu_map
        near = ((rt - rhs).abs() <= MARGIN_RTOL * rhs.abs()).numpy()
        differ += int(diff.sum())
        margin += int((diff & near).sum())
        check(not (diff & ~near).any(), f"18c: {int((diff & ~near).sum())} pixels differ "
              "from the CPU's off the threshold's margin")
        shares.append(float(cpu_map.mean()))
    t0 = time.perf_counter()
    for _ in range(3):
        occ.occlusion_terms(torch.from_numpy(fwd).to(dev), torch.from_numpy(bwd).to(dev))
    torch.cuda.synchronize()
    test_ms = 1e3 * (time.perf_counter() - t0) / 3
    log(f"18c occlusion generator, one FlyingThings3D-form pair at {H}x{W} on the card: "
        f"{differ} pixels differ from the CPU's maps, {margin} of them at the threshold's "
        f"margin ({MARGIN_RTOL:g} relative); occluded shares {shares[0]:.3f} / "
        f"{shares[1]:.3f}; {pair_s:.3f} s a pair "
        f"(two PFM reads, two maps, two PNG writes), {test_ms:.2f} ms a map's test with its "
        f"upload [{card}]")
    return differ


def movi_scene(np, rng, T, size, K):
    """A MOVi-E-form scene: smooth depth, K rectangular instances over the
    background, a camera moving a little, each instance under its own rigid
    motion."""
    H, W = size

    def quats(n, spread):
        q = rng.normal(scale=spread, size=(n, 4))
        q[:, 0] += 1.0
        return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)

    ys, xs = np.mgrid[0:H, 0:W]
    depth = np.empty((T, H, W), np.float32)
    seg = np.zeros((T, H, W), np.int32)
    for t in range(T):
        depth[t] = 6.0 + np.sin(xs / 37.0 + t / 5) + 0.5 * np.cos(ys / 29.0)
        for k in range(K):
            y0, x0 = rng.integers(0, H - H // 5), rng.integers(0, W - W // 4)
            seg[t, y0:y0 + H // 5, x0:x0 + W // 4] = k + 1
            depth[t, y0:y0 + H // 5, x0:x0 + W // 4] = 2.0 + 0.3 * k
    return {"depth": depth, "segmentation": seg,
            "camera": {"focal_length": np.float32(35.0), "sensor_width": np.float32(32.0),
                       "positions": np.cumsum(rng.normal(scale=0.03, size=(T, 3)),
                                              0).astype(np.float32),
                       "quaternions": quats(T, 0.01)},
            "instances": {"positions": np.cumsum(rng.normal(scale=0.05, size=(K, T, 3)),
                                                 1).astype(np.float32),
                          "quaternions": quats(K * T, 0.05).reshape(K, T, 4)}}


def run_kubric_generator(torch, dev, card):
    """18d: ``kubric_longflow.track_scene`` on the card on a MOVi-E-form
    scene (24 frames, 256x256, 10 instances) against the CPU: flows within 1
    float32 ulp, occlusions equal except at the depth test's margin."""
    import numpy as np
    from mft_tpu_torch.train import kubric_longflow as kub
    scene = movi_scene(np, np.random.default_rng(19), MOVI_T, MOVI_SIZE, MOVI_K)
    kub.track_scene(scene, device=dev)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_res = [t.cpu() for t in kub.track_terms(scene, device=dev)]
    scene_s = time.perf_counter() - t0
    flows_c, occl_c, marker_c, z_c, lim_c = card_res
    flows, occl, marker, z, lim = kub.track_terms(scene, device="cpu")
    a, b = flows.numpy(), flows_c.numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    flow_off = int((np.abs(a - b) > ulp).sum())
    flow_equal = int((a == b).sum())
    diff = (occl != occl_c).numpy()
    near = (((z - lim).abs() <= MARGIN_RTOL * lim.abs()) | (z.isnan() != z_c.isnan())).numpy()
    log(f"18d Kubric generator, a MOVi-E-form scene of {MOVI_T} frames at {MOVI_SIZE[0]}x"
        f"{MOVI_SIZE[1]}, {MOVI_K} instances, on the card: flows beyond 1 float32 ulp of the "
        f"CPU's {flow_off} ({flow_equal} of {a.size} equal); occlusions differing {int(diff.sum())}"
        f", {int((diff & near).sum())} of them at the margin; occluded share "
        f"{float(occl[1:].mean()):.3f}; {scene_s:.3f} s a scene [{card}]")
    check(flow_off == 0, "18d: flows beyond 1 ulp of the CPU's")
    check(torch.equal(marker, marker_c) and not (diff & ~near).any(),
          "18d: occlusions differ from the CPU's off the margin")
    return int(diff.sum())


def run_generators_and_trainer(torch, ops, dev, card):
    """Phase 18: the synthetic-shard trainer (a), the multi-card check on
    one card (b), the occlusion generator (c) and the Kubric generator (d).
    returns the trainer's launches."""
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        launches = run_synth_training(torch, ops, dev, card, tmp)
        log(f"phase 18a seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        run_multicard_one(torch, card)
        log(f"phase 18b seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        run_occlusion_generator(torch, dev, card, tmp)
        log(f"phase 18c seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        run_kubric_generator(torch, dev, card)
        log(f"phase 18d seconds {time.perf_counter() - t0:.2f}")
    return launches


# --------------------------------------------------------------------------- #
# phase 19: JPEG on the card: J1-J3, the demo on a JPEG directory, a
# Kinetics-form shard through the runner, the dashcam recipe
# --------------------------------------------------------------------------- #
JPEG_SAMPLINGS = ("444", "422", "420", "440", "411", "grey")
JPEG_QUALITIES = (15, 50, 95)
JPEG_SIZES = ((1, 1), (37, 53), (127, 65), (512, 512))
JPEG_PY_MAX = 127 * 65          # J1 against Python on every case up to this size
JPEG_TIMED = ((512, 512), (1080, 1920))
KIN_RECORDS, KIN_T, KIN_SIZE = 2, 24, 256
DASHCAM_WORKERS = 6             # the recipe's --num_workers (train_args)


def jpeg_frames(N, H, W, seed, channels=3, noise=12.0):
    """N uint8 frames: the synthetic texture plus Gaussian noise (every
    coefficient band in use), grey as (N, H, W, 1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for k in range(N):
        img = synthetic_clip(0, H, W, seed=seed + k)[0].astype(np.float32)
        out.append((img + rng.normal(0, noise, img.shape)).clip(0, 255).astype(np.uint8))
    return np.ascontiguousarray(np.stack(out)[..., :channels])


def jpeg_case(torch, dev, J, OJ, H, W, sampling, quality, restart, python_j1):
    """One geometry through J3, J2 and J1 against the plain versions.
    returns (differing J3 coefficients, J2 pixels, J1 coefficients, J1 bytes),
    and the largest absolute differences {j3, j2, dec, enc}."""
    import numpy as np
    C = 1 if sampling == "grey" else 3
    img = jpeg_frames(2, H, W, seed=H * 7 + W + quality, channels=C)
    geom = J.geometry_for(H, W, C, "420" if C == 1 else sampling)
    qtabs, recips = J._tables(geom, quality)
    coefs = OJ.jpeg_encode_pixels(torch.from_numpy(img).to(dev), torch.from_numpy(recips).to(dev),
                                  geom).cpu().numpy()
    want = J.encode_pixels_ref(img, recips, geom)
    d3 = int((coefs != want).sum())
    gap = lambda a, b: int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0
    err = dict(j3=gap(coefs, want), j2=0, dec=0, enc=0)
    q = np.ascontiguousarray(np.broadcast_to(qtabs, (2,) + qtabs.shape))
    pix = OJ.jpeg_decode_pixels(torch.from_numpy(want).to(dev), torch.from_numpy(q).to(dev),
                                geom).cpu().numpy()
    ref = J.decode_pixels_ref(want, q, geom)
    d2, err["j2"] = int((pix != ref).sum()), gap(pix, ref)
    d1c = d1b = 0
    if python_j1:
        mcux, mcuy = J.scan_mcus(geom)
        args = (want[0], J.encode_comp_info(geom), J.STD_CODE_TABLES, mcux, mcuy, restart)
        native, plain = OJ.jpeg_huff_encode(*args, dev), OJ.jpeg_huff_encode(*args, "cpu")
        d1b = int(native != plain)        # a length that differs counts here
        n = min(len(native), len(plain))
        err["enc"] = gap(np.frombuffer(native[:n], np.uint8), np.frombuffer(plain[:n], np.uint8))
        data = J.file_header(geom, qtabs, restart) + native + b"\xff\xd9"
        scan = J.parse_jpeg(data).scans[0]
        a, b = (np.zeros((geom.blocks, 64), np.int16) for _ in range(2))
        OJ.jpeg_huff_decode(scan, a, dev)
        OJ.jpeg_huff_decode(scan, b, "cpu")
        real = np.zeros_like(a)
        for c in range(geom.ncomp):      # the coded blocks inside each component
            grid = want[0, geom.boff[c]:geom.boff[c] + geom.bw[c] * geom.bh[c]].reshape(
                geom.bh[c], geom.bw[c], 64)
            out = real[geom.boff[c]:geom.boff[c] + geom.bw[c] * geom.bh[c]].reshape(grid.shape)
            out[:geom.rbh[c], :geom.rbw[c]] = grid[:geom.rbh[c], :geom.rbw[c]]
            got = a[geom.boff[c]:geom.boff[c] + geom.bw[c] * geom.bh[c]].reshape(grid.shape)
            d1c += int((got[:geom.rbh[c], :geom.rbw[c]] != grid[:geom.rbh[c], :geom.rbw[c]])
                       .sum())
            err["dec"] = max(err["dec"], gap(got[:geom.rbh[c], :geom.rbw[c]],
                                             grid[:geom.rbh[c], :geom.rbw[c]]))
        d1c += int((a != b).sum())
        err["dec"] = max(err["dec"], gap(a, b))
    return (d3, d2, d1c, d1b), err


# J1's bound is the host's, not the card's: entropy coding is one serial
# chain through the bitstream, each code's position hanging on the one
# before. The decoder's chain takes a dependent L1 load (its lookahead-table
# lookup, 4 cycles on x86 server cores) a Huffman code and a shift a bit
# field; the encoder's a shift and an OR (2 cycles) a code or field it puts.
HOST_CYCLES_CODE_DECODE = 4
HOST_CYCLES_PUT = 2


def host_clock_hz():
    """The host's highest core clock: cpufreq's cpuinfo_max_freq, else the
    largest 'cpu MHz' in /proc/cpuinfo."""
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/cpuinfo_max_freq") as f:
            return 1e3 * int(f.read())
    except (OSError, ValueError):
        with open("/proc/cpuinfo") as f:
            return 1e6 * max(float(line.split(":")[1]) for line in f
                             if line.startswith("cpu MHz"))


def entropy_symbols(J, coefs, geom):
    """(Huffman codes, AC bit fields) in the one scan of a frame's quantized
    coefficients ((blocks, 64), natural order), counted from this data: a DC
    code a block the scan codes (an interleaved scan's dummy blocks with an
    EOB each); a code and a bit field a nonzero AC coefficient, a ZRL a run
    of 16 zeros before one, an EOB where the last coefficient is zero. The
    DC differences' bit fields are left out, so the count stays a floor."""
    import numpy as np
    codes = fields = 0
    for c in range(geom.ncomp):
        grid = coefs[geom.boff[c]:geom.boff[c] + geom.bw[c] * geom.bh[c]].reshape(
            geom.bh[c], geom.bw[c], 64)
        real = grid[:geom.rbh[c], :geom.rbw[c]].reshape(-1, 64)[:, J.ZIGZAG[1:]] != 0
        if geom.ncomp > 1:
            codes += 2 * (geom.bw[c] * geom.bh[c] - len(real))     # DC + EOB a dummy block
        rows, cols = np.nonzero(real)
        prev = np.where(np.r_[False, rows[1:] == rows[:-1]], np.r_[-1, cols[:-1]], -1)
        codes += len(real) + len(rows) + int(((cols - prev - 1) // 16).sum())
        codes += int((~real[:, -1]).sum())                          # EOBs
        fields += len(rows)
    return codes, fields


def median_s(fn, reps=3):
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append(time.perf_counter() - t0)
    return sorted(t)[len(t) // 2]


def time_jpeg(torch, dev, card, J, OJ, H, W):
    """J2 and J3 by graph replay at H x W (4:2:0, quality 95, one frame),
    each with its bound and its plain version's time; J1's native host ms
    a frame beside the Python plain version's."""
    import numpy as np
    img = jpeg_frames(1, H, W, seed=5)
    geom = J.geometry_for(H, W, 3, "420")
    qtabs, recips = J._tables(geom, 95)
    img_t, rc_t = torch.from_numpy(img).to(dev), torch.from_numpy(recips).to(dev)
    coefs = OJ.jpeg_encode_pixels(img_t, rc_t, geom)
    q_t = torch.from_numpy(qtabs[None]).to(dev)
    j3_ms = graph_ms(lambda: OJ.jpeg_encode_pixels(img_t, rc_t, geom))
    j2_ms = graph_ms(lambda: OJ.jpeg_decode_pixels(coefs, q_t, geom))
    coef_np = coefs.cpu().numpy()
    j3_plain = 1e3 * median_s(lambda: J.encode_pixels_ref(img, recips, geom), 1)
    j2_plain = 1e3 * median_s(lambda: J.decode_pixels_ref(coef_np, qtabs[None], geom), 1)
    coef_bytes, pix_bytes = geom.blocks * 64 * 2, H * W * 3
    j2_bound = 1e3 * (coef_bytes + qtabs.nbytes + pix_bytes) / HBM_BYTES_PER_S
    j3_bound = 1e3 * (pix_bytes + recips.nbytes + coef_bytes) / HBM_BYTES_PER_S
    mcux, mcuy = J.scan_mcus(geom)
    args = (coef_np[0], J.encode_comp_info(geom), J.STD_CODE_TABLES, mcux, mcuy, 0)
    data = J.file_header(geom, qtabs) + OJ.jpeg_huff_encode(*args, dev) + b"\xff\xd9"
    scan = J.parse_jpeg(data).scans[0]
    out = np.zeros((geom.blocks, 64), np.int16)
    dec_ms = 1e3 * median_s(lambda: OJ.jpeg_huff_decode(scan, out, dev), 5)
    enc_ms = 1e3 * median_s(lambda: OJ.jpeg_huff_encode(*args, dev), 5)
    dec_py = 1e3 * median_s(lambda: OJ.jpeg_huff_decode(scan, np.zeros_like(out), "cpu"), 1)
    enc_py = 1e3 * median_s(lambda: OJ.jpeg_huff_encode(*args, "cpu"), 1)
    codes, fields = entropy_symbols(J, coef_np[0], geom)
    clock = host_clock_hz()
    dec_bound = 1e3 * (HOST_CYCLES_CODE_DECODE * codes + fields) / clock
    enc_bound = 1e3 * HOST_CYCLES_PUT * (codes + fields) / clock
    log(f"19a {H}x{W} 4:2:0 q95 ({len(data)} bytes): J2 {j2_ms:.4f} ms (bound {j2_bound:.4f}, "
        f"plain {j2_plain:.2f}), J3 {j3_ms:.4f} ms (bound {j3_bound:.4f}, plain {j3_plain:.2f}) "
        f"by graph replay; J1 host ms a frame: decode {dec_ms:.3f} (bound {dec_bound:.3f}, "
        f"Python {dec_py:.1f}), encode {enc_ms:.3f} (bound {enc_bound:.3f}, Python "
        f"{enc_py:.1f}); the scan's {codes} Huffman codes and {fields} AC bit fields, host "
        f"clock {clock / 1e9:.3f} GHz [{card}]")
    return dict(j2=dict(ms=j2_ms, plain_ms=j2_plain, bound_ms=j2_bound, bound_by="bytes"),
                j3=dict(ms=j3_ms, plain_ms=j3_plain, bound_ms=j3_bound, bound_by="bytes"),
                dec=dict(ms=dec_ms, plain_ms=dec_py, bound_ms=dec_bound, bound_by="operations"),
                enc=dict(ms=enc_ms, plain_ms=enc_py, bound_ms=enc_bound, bound_by="operations"))


def check_jpeg_kernels(torch, dev, card):
    """19a: J1, J2 and J3 bit for bit with their plain versions over every
    sampling and grey, qualities 15-95, odd sizes and restart intervals, and
    at 1080x1920; then the times. returns {size: stats}."""
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    totals, cases, errs = [0, 0, 0, 0], 0, dict(j3=0, j2=0, dec=0, enc=0)

    def add(case):
        nonlocal totals, cases
        d, e = case
        totals = [a + b for a, b in zip(totals, d)]
        errs.update({k: max(errs[k], v) for k, v in e.items()})
        cases += 1

    for H, W in JPEG_SIZES:
        for sampling in JPEG_SAMPLINGS:
            for quality in JPEG_QUALITIES:
                for restart in (0, 3):
                    python_j1 = H * W <= JPEG_PY_MAX or (quality == 95 and restart == 0)
                    if restart and not python_j1:
                        continue
                    add(jpeg_case(torch, dev, J, OJ, H, W, sampling, quality, restart,
                                  python_j1))
    add(jpeg_case(torch, dev, J, OJ, *JPEG_TIMED[1], "420", 95, 0, True))
    log(f"19a: {cases} cases (samplings {', '.join(JPEG_SAMPLINGS)}; qualities "
        f"{JPEG_QUALITIES}; sizes {JPEG_SIZES} and 1080x1920; restart intervals 0, 3): "
        f"differing J3 coefficients {totals[0]}, J2 pixels {totals[1]}, J1 coefficients "
        f"{totals[2]}, J1 scans {totals[3]}; largest absolute differences {errs}")
    check(totals == [0, 0, 0, 0], f"JPEG kernels differ from their plain versions: {totals}")
    stats = {hw: time_jpeg(torch, dev, card, J, OJ, *hw) for hw in JPEG_TIMED}
    for st in stats.values():
        for key, e in errs.items():
            st[key]["max_abs_err"] = float(e)
    return stats


def kinetics_shard(path, dev):
    """A Kinetics-form shard: KIN_RECORDS records of KIN_T JPEG frames of
    KIN_SIZE px (the port's encoder on the card, quality 95), the texture
    moving 1 px right and 1 px down a frame, TAPVID_GRID^2 points in view."""
    import pickle
    import numpy as np
    from mft_tpu_torch.io.jpeg import encode_jpeg
    step = (KIN_SIZE - 32 - KIN_T) // (TAPVID_GRID - 1)
    grid = 16.0 + step * np.arange(TAPVID_GRID)
    xy = np.stack(np.meshgrid(grid, grid, indexing="xy"), -1).reshape(-1, 1, 2)
    points = (xy + np.arange(KIN_T).reshape(1, -1, 1)) / KIN_SIZE
    records = []
    for s in range(KIN_RECORDS):
        clip = synthetic_clip(KIN_T - 1, KIN_SIZE, KIN_SIZE, seed=s, shift=(1, 1))[::-1]
        records.append({"video": [encode_jpeg(f, 95, dev) for f in clip], "points": points,
                        "occluded": np.zeros(points.shape[:2], bool)})
    with open(path, "wb") as f:
        pickle.dump(records, f)


def run_kinetics(torch, ops, dev, card, tmp):
    """19c: a Kinetics-form shard through ``create_tapvid_dataset`` and the
    runner (synth, mode 'first', tracked at 512x512), then evaluate. Gates:
    the prediction files, one J1 a frame and one J2 a record, <delta_avg >=
    0.9. returns (launch counts, frames/s)."""
    from mft_tpu_torch.eval import evaluate, runner
    kinetics_shard(tmp / "kinetics_synth.pkl", dev)
    (tmp / "kinetics.py").write_text(DATASET_CONFIG.format(
        pickle=str(tmp / "kinetics_synth.pkl"), scaling=TAPVID_SCALING))
    common = ["--dataset", str(tmp / "kinetics.py"), "--export", str(tmp / "kin_export")]
    args = runner.get_parser().parse_args(
        ["--trackers", "synth", "--cache", str(tmp / "kin_cache"), "--mode", "first", *common])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = runner.run(args)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    names = sorted(p.name for p in (tmp / "kin_export").rglob("*.pklz"))
    want = sorted(f"kin-kinetics_synth-{i:04d}-first.pklz" for i in range(KIN_RECORDS))
    check(names == want, f"kinetics prediction files {names} != {want}")
    frames = sum(p["frames"] for p in out["passes"])
    track_s = sum(p["seconds"] for p in out["passes"])
    log(f"19c kinetics-form shard ({KIN_RECORDS} records x {KIN_T} JPEG frames of "
        f"{KIN_SIZE}x{KIN_SIZE}, tracked at 512x512, synth, 'first'): {frames} frames tracked "
        f"in {track_s:.2f} s ({frames / track_s:.2f} frames/s), the run {seconds:.2f} s with "
        f"loading; launches {counts} [{card}]")
    check(counts["jpeg_huff_decode"] == KIN_RECORDS * KIN_T
          and counts["jpeg_decode_pixels"] == KIN_RECORDS,
          f"kinetics decode: {counts} (want one J1 a frame, one J2 a record)")
    means = evaluate.run(evaluate.get_parser().parse_args(
        ["--trackers", "synth", "--mode", "first", *common]))
    for (name, mode), m in sorted(means.items()):
        ok = m["average_pts_within_thresh"] >= 0.9
        log(f"19c TAP-Vid {name} {mode} (Kinetics-form synthetic shard, x100): AJ "
            f"{100 * m['average_jaccard']:.2f}, <delta_avg "
            f"{100 * m['average_pts_within_thresh']:.2f}, OA "
            f"{100 * m['occlusion_accuracy']:.2f} (gate: <delta_avg >= 90) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kinetics {name} {mode}: <delta_avg {m['average_pts_within_thresh']:.4f}")
    return counts, frames / track_s


def run_dashcam(torch, ops, dev, card, tmp, plain_recipe):
    """19d: the official recipe for TRAIN_STEPS steps over a Sintel-form tree
    as phase 14's, without the flag, with --dashcam_augmenentation, and
    without it again: one tree and one process, so that order, tree and
    warm-up do not tell the runs apart. run_recipe's gates each time, and
    with the flag J2 and J3 launches > 0, one J2 a J3 (each corruption one of
    each), no J1. The loader threads' time in ``jpeg_corrupt`` is summed.
    returns (the flagged run's launch counts, {run: stats})."""
    import threading
    from types import SimpleNamespace
    from mft_tpu_torch import environment
    from mft_tpu_torch.train import augment, synth
    synth.write_sintel_tree(tmp / "sintel", frames=SINTEL_FRAMES, H=SINTEL_H, W=SINTEL_W)
    settings, corrupt = environment.env_settings, augment.jpeg_corrupt
    environment.env_settings = lambda: SimpleNamespace(sintel_dir=str(tmp / "sintel"))
    lock, spent = threading.Lock(), [0, 0.0]     # corruptions, their seconds on loader threads

    def timed_corrupt(*args, **kwargs):
        t = time.perf_counter()
        out = corrupt(*args, **kwargs)
        with lock:
            spent[0] += 1
            spent[1] += time.perf_counter() - t
        return out

    augment.jpeg_corrupt = timed_corrupt
    try:
        runs = {}
        for run, dashcam in (("without", False), ("dashcam", True), ("without_again", False)):
            runs[run] = run_recipe(torch, ops, dev, card, tmp, "official", dashcam=dashcam,
                                   name=f"official_{run}")
    finally:
        environment.env_settings, augment.jpeg_corrupt = settings, corrupt
    counts = runs["dashcam"]["launches"]
    ms_each = 1e3 * spent[1] / max(spent[0], 1)
    wall = {run: sorted(st["wall_ms"])[len(st["wall_ms"]) // 2] for run, st in runs.items()}
    log(f"19d official recipe ({TRAIN_STEPS} steps of {TRAIN_B}x{TRAIN_H}x{TRAIN_W}, one tree, "
        f"one process), median ms a step after 1 warm-up step, from the batch on the card to "
        f"the loss: without the flag {runs['without']['median_ms']:.1f}, with "
        f"--dashcam_augmenentation {runs['dashcam']['median_ms']:.1f}, without it again "
        f"{runs['without_again']['median_ms']:.1f} (phase 14b: "
        f"{plain_recipe['median_ms']:.1f}); median wall ms between steps "
        f"{wall['without']:.1f} / {wall['dashcam']:.1f} / {wall['without_again']:.1f}, the "
        f"wait for the loader {runs['without']['wait_share']:.1%} / "
        f"{runs['dashcam']['wait_share']:.1%} / {runs['without_again']['wait_share']:.1%} of "
        f"it; jpeg_corrupt on the loader threads: {spent[0]} calls, {ms_each:.2f} ms each, "
        f"{spent[1]:.3f} s in all; J2/J3 launches over the flagged run (the loader's "
        f"prefetch included) {counts['jpeg_decode_pixels']} / {counts['jpeg_encode_pixels']}, "
        f"{counts['jpeg_decode_pixels'] / TRAIN_STEPS:.1f} J2 and "
        f"{counts['jpeg_encode_pixels'] / TRAIN_STEPS:.1f} J3 a step [{card}]")
    # a loader thread may sit between the J3 and the J2 of one corruption
    # when the counts are read
    gap = counts["jpeg_encode_pixels"] - counts["jpeg_decode_pixels"]
    check(counts["jpeg_decode_pixels"] > 0 and 0 <= gap <= DASHCAM_WORKERS
          and counts["jpeg_huff_decode"] == counts["jpeg_huff_encode"] == 0,
          f"dashcam launches {counts}: want J2 and J3 > 0, one J2 a J3, no J1")
    return counts, runs


def run_jpeg(torch, ops, dev, card, recipes):
    """Phase 19: J1-J3 (a), the demo on a JPEG directory (b), a Kinetics-form
    shard through the runner (c), the dashcam recipe (d)."""
    import tempfile
    from pathlib import Path
    t0 = time.perf_counter()
    stats = check_jpeg_kernels(torch, dev, card)
    log(f"phase 19a seconds {time.perf_counter() - t0:.2f}")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        demo_counts, fps, shares, writer_counts = run_demo(torch, ops, dev, card, tmp,
                                                           fmt="jpg")
        log(f"phase 19b seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        kin_counts, kin_fps = run_kinetics(torch, ops, dev, card, tmp)
        log(f"phase 19c seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        dash_counts, dash = run_dashcam(torch, ops, dev, card, tmp, recipes["official"])
        log(f"phase 19d seconds {time.perf_counter() - t0:.2f}")
    log(f"JPEG: demo on JPEG frames {fps:.2f} frames/s (decode {shares['decode']:.1%}, "
        f"encode {shares['encode']:.1%}, rendering {shares['render']:.1%}); Kinetics-form "
        f"runner {kin_fps:.2f} frames/s; official step {dash['dashcam']['median_ms']:.1f} ms "
        f"with the dashcam flag, {dash['without']['median_ms']:.1f} / "
        f"{dash['without_again']['median_ms']:.1f} without [{card}]")
    return dict(stats=stats, demo=demo_counts, writer=writer_counts, kinetics=kin_counts,
                dashcam=dash_counts)


# --------------------------------------------------------------------------- #
# phase 20: progressive JPEG (a); the PNG kinds, the reference's .pth and the
# FLOP budget (b); the vis helpers (c); each against the committed fixtures of
# tests/data/torch_fixtures/, which tools/torch_make_fixtures.py made with
# cv2, PIL and the JAX package (the card's machine has none of them)
# --------------------------------------------------------------------------- #
FIXTURES = os.path.join(HERE, "tests", "data", "torch_fixtures")
PROG_DIR = "prog_512"           # the progressive 512x512 frames of a moving scene
PROG_HD = "prog_1080.jpg"       # one progressive 1080x1920 frame
PROG_QUALITY = 90               # their quality (cv2's progression script)


def array_hash(a) -> str:
    """dtype:shape:sha256 of an array's C-order bytes (of a str's UTF-8)."""
    import hashlib
    import numpy as np
    if isinstance(a, str):
        return "str:" + hashlib.sha256(a.encode()).hexdigest()
    a = np.ascontiguousarray(a)
    return (f"{a.dtype}:{'x'.join(map(str, a.shape))}:"
            f"{hashlib.sha256(a.tobytes()).hexdigest()}")


def vis_cases(np, vis) -> dict:
    """{case: output} of every helper that ``mft_tpu_torch/utils/vis.py``
    ports from ``mft_tpu/utils/vis.py``, on inputs made from seeds; ``vis``
    is either module (the fixtures hold the JAX module's outputs' hashes)."""
    rng = np.random.default_rng(20)
    H, W = 45, 67
    img = lambda: rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    a, b = img(), img()
    flow = rng.normal(0, 4, (H, W, 2)).astype(np.float32)
    amap = rng.random((H, W)).astype(np.float32)
    mask = rng.random((H, W)) > 0.6
    scalar = rng.normal(size=(H, W)).astype(np.float32)
    small = [rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(5)]
    out = {
        "flow_to_color": vis.flow_to_color(flow),
        "flow_to_color_bgr_clip": vis.flow_to_color(flow, 3.0, True, 5.0),
        "vis_flow": vis.vis_flow(flow),
        "vis_flow_img": vis.vis_flow(flow, a, 0.3, 6.0),
        "blend": vis.blend(a, b, 0.35),
        "blend_map": vis.blend(a, b, amap),
        "checkerboard": vis.checkerboard(H, W, 5, (10, 250)),
        "image_grid": vis.image_grid(small, cols=2, pad=3, pad_value=200),
        "hatch_pattern": vis.hatch_pattern((H, W), (1, -3), 6),
        "hatch_overlay": vis.hatch_overlay(a, mask, (10, 20, 30), 0.7, 6, (1, -3)),
        "blend_mask": vis.blend_mask(a, mask, (255, 0, 9), 0.2),
        "blend_with_alpha": vis.blend_with_alpha(a, b, amap),
        "blend_with_alpha_premult": vis.blend_with_alpha_premult(a // 2, b, amap),
        "tile_images": vis.tile_images([small[:3], small[2:]], 4, 2, 128),
        "shorten_text": vis.shorten_text("a_rather_long_name.png", 12, "left"),
        "to_gray_3ch": vis.to_gray_3ch(a),
        "color_checkerboard": vis.color_checkerboard(H, W, 3),
        "color_checkerboard_wide": vis.color_checkerboard(7, 100),
        "colorbar": vis.colorbar((0, 1), 37, 5),
        "vis_scalar_map": vis.vis_scalar_map(scalar),
        "vis_scalar_map_range": vis.vis_scalar_map(scalar, -0.5, 0.5),
        "flow_to_color_matlab": vis.flow_to_color_matlab(flow, 3.0),
        "vis_flow_align": vis.vis_flow_align(flow, a, b, 0.25),
        "vis_alignment_plain": vis.vis_alignment_plain(a, b),
        "vis_alignment_plain_eq": vis.vis_alignment_plain(a, b, True),
        "overlay_background": vis.OverlayBackground(a, b).overlay(b, a, alpha=0.3)[1],
        "knn_interp": vis.make_knn_interp(rng.random((60, 2)) * 50, rng.normal(size=60))(
            rng.random((25, 2)) * 60, 5, 8.0, 3),
    }
    canvas = np.zeros((40, 50, 3), np.uint8)
    vis.place_img_at(small[0], canvas, 7, 30)
    out["place_img_at"] = canvas
    for interp, name in ((0, "nearest"), (1, "linear")):       # cv2.INTER_NEAREST, _LINEAR
        for align in (False, True):
            key = f"resize_{name}{'_align' if align else ''}"
            out[key] = vis.resize(a, (100, 80), interpolation=interp, align_corners=align)
            out[key + "_fx"] = vis.resize(a[..., 0], None, 0.5, 0.5, interp, align)
    return out


def progressive_coefs(np, J, OJ, data, device, counts=None):
    """A progressive file's coefficients, scan by scan through J1's
    progressive routine on ``device`` (the host's native code for CUDA)."""
    jf = J.parse_jpeg(data)
    out = np.zeros((jf.geom.blocks, 64), np.int16)
    for scan in jf.scans:
        if device == "cpu" and counts is not None:
            J.huff_decode_progressive_ref(scan, out, counts)
        else:
            OJ.jpeg_huff_decode_progressive(scan, out, device)
    return out


def check_progressive_fixtures(torch, dev, card, hashes):
    """20a: every committed progressive JPEG through J1's native progressive
    routines against their plain version, scan by scan, and decoded (J1 on
    the host, J2 on the card) to the sha256 that cv2 (BGR) and PIL (RGB, no
    EXIF turn) gave. returns (files, differing coefficients, largest gap)."""
    import numpy as np
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    n_diff = worst = scans = 0
    bad = []
    for name, want in hashes["jpeg"].items():
        data = open(os.path.join(FIXTURES, name), "rb").read()
        jf = J.parse_jpeg(data)
        a, b = (np.zeros((jf.geom.blocks, 64), np.int16) for _ in range(2))
        for scan in jf.scans:
            OJ.jpeg_huff_decode_progressive(scan, a, dev)
            OJ.jpeg_huff_decode_progressive(scan, b, "cpu")
            n_diff += int((a != b).sum())
            worst = max(worst, int(np.abs(a.astype(np.int64) - b).max()))
            scans += 1
        bgr = J.decode_jpeg(data, dev)
        rgb = J.decode_jpeg_frames([data], dev, orient=False, rgb=True)[0]
        if array_hash(bgr) != want["cv2"]:
            bad.append(f"{name} (cv2)")
        if array_hash(rgb) != want["pil"]:
            bad.append(f"{name} (PIL)")
    log(f"20a: {len(hashes['jpeg'])} progressive files, {scans} scans: native against plain "
        f"{n_diff} differing coefficients (largest gap {worst}); decodes whose sha256 differs "
        f"from cv2's or PIL's: {bad or 'none'}")
    check(n_diff == 0, f"J1's progressive routine differs from its plain version in {n_diff} "
                       "coefficients")
    check(not bad, f"progressive decodes differ from cv2/PIL: {bad}")
    return len(hashes["jpeg"]), n_diff, worst


def time_progressive(torch, dev, card, data, label):
    """J1's progressive routine a frame (host ms, median of 5) beside its plain
    version, its host bound (the codes and bit fields this file's scans
    hold, counted by the plain version) and the baseline file of the same
    pixels at the same quality (the port's encoder: cv2's bytes): its J1
    ms and bound, and both files' whole decode (J1 + J2)."""
    import numpy as np
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.ops import jpeg as OJ
    counts = {}
    plain_ms = 1e3 * median_s(lambda: progressive_coefs(np, J, OJ, data, "cpu", counts), 1)
    ms = 1e3 * median_s(lambda: progressive_coefs(np, J, OJ, data, dev), 5)
    pixels = J.decode_jpeg(data, dev)
    base = J.encode_jpeg(pixels, PROG_QUALITY, dev)
    jf = J.parse_jpeg(base)
    out = np.zeros((jf.geom.blocks, 64), np.int16)
    base_ms = 1e3 * median_s(lambda: OJ.jpeg_huff_decode(jf.scans[0], out, dev), 5)
    codes, fields = entropy_symbols(J, out, jf.geom)
    clock = host_clock_hz()
    bound = 1e3 * (HOST_CYCLES_CODE_DECODE * counts["codes"] + counts["fields"]) / clock
    base_bound = 1e3 * (HOST_CYCLES_CODE_DECODE * codes + fields) / clock
    whole = 1e3 * median_s(lambda: J.decode_jpeg(data, dev), 5)
    base_whole = 1e3 * median_s(lambda: J.decode_jpeg(base, dev), 5)
    log(f"20a {label} progressive ({len(data)} bytes, {len(J.parse_jpeg(data).scans)} scans, "
        f"{counts['codes']} Huffman codes and {counts['fields']} bit fields) against baseline "
        f"({len(base)} bytes, {codes} codes and {fields} AC bit fields) of the same pixels, "
        f"q{PROG_QUALITY}: J1 host ms a frame {ms:.3f} against {base_ms:.3f} (bounds "
        f"{bound:.3f} / {base_bound:.3f}; Python {plain_ms:.1f}); whole decode (J1 + J2) "
        f"{whole:.3f} against {base_whole:.3f} ms; host clock {clock / 1e9:.3f} GHz [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="operations",
                baseline_ms=base_ms, baseline_bound_ms=base_bound, decode_ms=whole,
                baseline_decode_ms=base_whole)


def run_progressive_demo(torch, ops, dev, card, tmp):
    """20a: ``apps.demo.run`` with the default configuration (the big RAFT-OU,
    512x512, 7 deltas, 12 iterations, bf16, random weights) on the committed
    directory of progressive frames; its tracks bit for bit with a fresh
    tracker's on the same decoded pixels passed as arrays (deterministic
    cuDNN for both). returns the demo's launch counts."""
    import argparse
    import numpy as np
    from mft_tpu_torch.apps import demo
    from mft_tpu_torch.config import default_config
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking
    clip = os.path.join(FIXTURES, PROG_DIR)
    files = sorted(os.listdir(clip))
    datas = [open(os.path.join(clip, f), "rb").read() for f in files]
    scans = sum(len(J.parse_jpeg(d).scans) for d in datas)
    tracks = []
    render = demo.render_frame

    def recording_render(frame, result, queries, edit, edit_mask):
        out = render(frame, result, queries, edit, edit_mask)
        tracks.append((out[2], out[3]))
        return out

    args = argparse.Namespace(video=clip, config="default", out=str(tmp / "prog_demo"),
                              grid_spacing=30, fps=25.0, max_frames=None, device=str(dev))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    demo.render_frame = recording_render
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = demo.run(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
        demo.render_frame = render
        frames = [J.decode_jpeg(d, dev) for d in datas]
        tracker = MFT(default_config(), device=dev)
        queries = demo.get_queries(frames[0].shape, 30)
        mine = []
        for i, frame in enumerate(frames):
            meta = tracker.init(frame) if i == 0 else tracker.track(frame)
            coords, occl = convert_to_point_tracking(meta.result, queries)
            mine.append((coords, occl))
    finally:
        demo.render_frame = render
        torch.backends.cudnn.deterministic = False
    tracked = len(files) - 1
    log(f"20a demo (default config, 512x512, bf16) on {len(files)} progressive frames: "
        f"{n} frames in {seconds:.3f} s ({n / seconds:.2f} frames/s, set-up and the first "
        f"frame included); launches {counts} [{card}]")
    check(n == len(files), f"progressive demo wrote {n} frames, want {len(files)}")
    want = expected_counts(ops, corr_lookup_fused=11 * tracked, corr_lookup=tracked,
                           chain_select=tracked, bilinear_warp=len(files),
                           jpeg_huff_decode_progressive=scans, jpeg_decode_pixels=len(files),
                           mpeg4_encode_pixels=2 * len(files), mpeg4_vlc_encode=2 * len(files),
                           mpeg4_decode_pixels=2 * len(files))
    check(counts == want, f"progressive demo launch counts {counts} != {want}")
    diff = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum()) for a, b in zip(tracks, mine))
    finite = all(np.isfinite(c).all() and np.isfinite(o).all() for c, o in tracks)
    log(f"20a: the demo's tracks of {len(queries)} queries over {len(files)} frames against "
        f"the same decoded pixels as arrays: {diff} values differ; finite {finite}")
    check(len(tracks) == len(mine) and diff == 0 and finite,
          f"progressive demo tracks differ from the arrays' in {diff} values")
    return counts


def check_png_fixtures(hashes):
    """20b: the committed PNG kinds (palettes with and without tRNS, 1/2/4-bit
    grey and palettes, grey+alpha at 8 and 16 bits, Adam7) decoded to the
    sha256 that cv2 (IMREAD_UNCHANGED, IMREAD_COLOR) and PIL's
    convert('RGB') gave."""
    from pathlib import Path
    from mft_tpu_torch.eval.tapvid import _read_rgb
    from mft_tpu_torch.io.png import decode_png, to_bgr
    bad = []
    for name, want in hashes["png"].items():
        path = Path(FIXTURES) / name
        img = decode_png(path.read_bytes())
        for key, got in (("cv2_unchanged", img), ("cv2_color", to_bgr(img)),
                         ("pil_rgb", _read_rgb(path))):
            if array_hash(got) != want[key]:
                bad.append(f"{name} ({key})")
    log(f"20b: {len(hashes['png'])} PNG files against cv2's and PIL's decodes: differing "
        f"{bad or 'none'}")
    check(not bad, f"PNG decodes differ: {bad}")


def check_reference_pth(torch, dev, card, tmp):
    """20b: the committed weights written as a reference-named ``.pth``
    (``module.`` prefixed) and read back by the tracker: a tracked 512x512
    frame bit for bit with the tracker on the msgpack itself."""
    from mft_tpu_torch.config import synth_config
    from mft_tpu_torch.models.raft import convert
    from mft_tpu_torch.models.raft.flax_msgpack import read_variables
    from mft_tpu_torch.tracker import MFT
    cfg = synth_config()
    pth = tmp / "raftou_synth_reference.pth"
    convert.export_torch_checkpoint(convert.params_from_flax(read_variables(
        cfg.flow_config.model)), pth)
    clip = synthetic_clip(1)
    results = []
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for model in (cfg.flow_config.model, str(pth)):
            c = synth_config()
            c.flow_config.model = model
            results.append(track_frames(torch, MFT(c, device=dev), clip)[0][0])
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = results
    same = all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("flow", "occlusion", "sigma"))
    log(f"20b: a 512x512 frame tracked on the reference-named .pth of the committed weights "
        f"({pth.stat().st_size} bytes) against the msgpack: bit for bit {same} [{card}]")
    check(same, "the .pth tracker's frame differs from the msgpack tracker's")


def check_flops(torch, card):
    """20b: the FLOP budget of a 512x512 frame and the card's bf16 peak."""
    from mft_tpu_torch.utils.flops import PEAK_BF16_FLOPS, frame_flops, peak_flops
    flops, peak = frame_flops(512, 512), peak_flops()
    name = torch.cuda.get_device_name(0)
    log(f"20b: frame_flops() at 512x512, 7 pairs, 12 iterations: {flops} ({flops / 1e12:.4f} "
        f"TFLOP); peak_flops() on {name}: {peak} [{card}]")
    check(peak == PEAK_BF16_FLOPS.get(name), f"peak_flops() {peak} on {name}")
    check(flops > 0, "frame_flops")


def check_vis(hashes):
    """20c: every ported vis helper on its seeded inputs, each output's
    sha256 against the JAX module's."""
    import numpy as np
    from mft_tpu_torch.utils import vis
    out = vis_cases(np, vis)
    bad = [k for k, v in out.items() if array_hash(v) != hashes["vis"].get(k)]
    missing = sorted(set(hashes["vis"]) - set(out))
    log(f"20c: {len(out)} vis outputs against JAX's: differing {bad or 'none'}, "
        f"missing {missing or 'none'}")
    check(not bad and not missing, f"vis outputs differ from JAX's: {bad}, missing {missing}")


def run_fixtures(torch, ops, dev, card):
    """Phase 20: progressive JPEG (a); PNG kinds, the reference .pth, the FLOP
    budget (b); the vis helpers (c). returns the stats of (a)."""
    import tempfile
    from pathlib import Path
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    t0 = time.perf_counter()
    files, n_diff, worst = check_progressive_fixtures(torch, dev, card, hashes)
    frame = open(os.path.join(FIXTURES, PROG_DIR, sorted(os.listdir(
        os.path.join(FIXTURES, PROG_DIR)))[0]), "rb").read()
    sd = time_progressive(torch, dev, card, frame, "512x512")
    hd = time_progressive(torch, dev, card, open(os.path.join(FIXTURES, PROG_HD), "rb").read(),
                          "1080x1920")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        counts = run_progressive_demo(torch, ops, dev, card, tmp)
        log(f"phase 20a seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        check_png_fixtures(hashes)
        check_reference_pth(torch, dev, card, tmp)
        check_flops(torch, card)
        log(f"phase 20b seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    check_vis(hashes)
    log(f"phase 20c seconds {time.perf_counter() - t0:.2f}")
    return dict(demo=counts, sd=sd, hd=hd, max_abs_err=worst, files=files)


# --------------------------------------------------------------------------- #
# phase 21: video files: the MPEG-4 Part 2 (mp4v) codec, V1 on the host, V2
# and V3 on the card, against the committed cv2 fixtures (a), random-syntax
# streams of the plain stream writer (b), the encoder at 512x512 and
# 1080x1920 (c) and the default-config demo on an .mp4 (d)
# --------------------------------------------------------------------------- #
MP4V_NAMES = ("pan", "noise", "still", "odd")
MP4V_STREAMS = ((31, 128, 96, "0111101"), (32, 72, 40, "0111111"), (33, 48, 32, "0101"))
# 21c: (H, W, frames the plain encoder writes too, VOPs of the GOP the plain
# V1 is timed on); the card encoder writes a whole GOP (12 frames) for V1's
# times, where fewer VOPs than a GOP are timed in Python the plain time and
# the bound weigh the I-VOP 1/12 and the P-VOPs' mean 11/12
MP4V_ENCODE = ((512, 512, 3, 12), (1080, 1920, 2, 2))
MP4V_MOTION_SEED = 41   # 21c's random-syntax P-VOP at 512x512: V2 timed with motion


def syntax_gap(np, a, b) -> int:
    """The largest absolute difference between two VOPs' syntax arrays."""
    return max(int(np.abs(x.astype(np.int64) - y).max()) if x.size else 0
               for x, y in zip(a.arrays(), b.arrays()))


def bytes_gap(np, a, b) -> int:
    """The largest absolute difference between the bytes of two strings;
    255, the most a byte can differ, where their lengths differ."""
    if len(a) != len(b):
        return 255
    return int(np.abs(np.frombuffer(a, np.uint8).astype(np.int64)
                      - np.frombuffer(b, np.uint8)).max()) if a else 0


def array_gap(np, a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - b).max()) if np.size(a) else 0


def vlc_symbols(counts):
    """(codes, bit fields) a VOP's V1 walks, from the plain decoder's
    counters: every code of a table, and the bit field beside it (a TCOEF's
    sign, a nonzero DC size's difference, a nonzero MVD's sign and residue);
    an escape's fixed fields count as one field."""
    codes = sum(v for k, v in counts.items() if k[0] != "escape")
    fields = sum(v for k, v in counts.items()
                 if k[0].startswith("tcoef") or (k[0] in ("dc_lum", "dc_chrom", "mvd")
                                                 and k[1] > 0))
    return codes, fields + sum(v for k, v in counts.items() if k[0] == "escape")


def mp4v_syntax_tensors(torch, syn, dev):
    return [torch.from_numpy(a).to(dev) for a in (syn.levels, syn.mode, syn.qp, syn.mv)]


def check_mp4v_fixtures(torch, dev, card, hashes):
    """21a: every committed fixture (cv2's writer through the JAX package):
    V1 natively against its plain version (syntax arrays equal), V2 on the
    card against its plain version (planes and BGR bit for bit), V3 on
    cv2's frames against its plain version (levels, I-VOP or the residual
    against the decoded reference), the Y planes against cv2's sha256 and
    the BGR frames against cv2's (the gap printed per frame). returns (VOPs,
    the largest gaps to the plain versions {dec, v2, v3}, the largest BGR
    gap to cv2)."""
    import numpy as np
    from mft_tpu_torch.io import mpeg4 as M
    from mft_tpu_torch.io.mp4 import read_mp4
    from mft_tpu_torch.ops import mpeg4 as OM
    vops = worst_bgr = 0
    err = dict(dec=0, v2=0, v3=0)
    for name in MP4V_NAMES:
        key = f"mp4v/{name}.mp4"
        want = hashes["mp4v"][key]
        video = read_mp4(os.path.join(FIXTURES, key))
        cv2_bgr = np.load(os.path.join(FIXTURES, "mp4v", f"{name}.npz"))["bgr"]
        vol = M.parse_config(video.config)
        geom = M.Geometry(vol.width, vol.height)
        ref = ref_t = None
        n_syn = n_pix = n_v3 = 0
        y_bad, gaps = [], []
        k = 0
        for data in video.read_samples():
            payload = data[M.find_vop(data, vol)[0]:]
            syn = OM.mpeg4_vlc_decode(payload, vol, dev)
            plain = M.vlc_decode_ref(payload, vol)
            n_syn += 0 if syn.equal(plain) else 1
            err["dec"] = max(err["dec"], syntax_gap(np, syn, plain))
            if not syn.coded:
                continue
            p = syn.kind == M.P_VOP
            levels = OM.mpeg4_encode_pixels(torch.from_numpy(cv2_bgr[k]).to(dev),
                                            ref_t if p else None, M.ENCODER_QP, geom)
            want_levels = M.encode_pixels_ref(cv2_bgr[k], ref if p else None, M.ENCODER_QP,
                                              geom)
            n_v3 += int((levels.cpu().numpy() != want_levels).sum())
            err["v3"] = max(err["v3"], array_gap(np, levels.cpu().numpy(), want_levels))
            planes = M.decode_pixels_ref(plain.levels, plain.mode, plain.qp, plain.mv,
                                         ref if p else None, geom, plain.rounding)
            ref_t, img = OM.mpeg4_decode_pixels(*mp4v_syntax_tensors(torch, syn, dev),
                                                ref_t if p else None, geom, syn.rounding)
            got, img = ref_t.cpu().numpy(), img.cpu().numpy()
            bgr = M.yuv_to_bgr_ref(planes, geom)
            n_pix += int((got != planes).sum()) + int((img != bgr).sum())
            err["v2"] = max(err["v2"], array_gap(np, got, planes), array_gap(np, img, bgr))
            if array_hash(geom.split(got)[0][:geom.H, :geom.W]) != want["y"][k]:
                y_bad.append(k)
            gap = int(np.abs(img.astype(np.int64) - cv2_bgr[k]).max())
            gaps.append(gap)
            worst_bgr = max(worst_bgr, gap)
            ref = planes
            k += 1
            vops += 1
        log(f"21a {key} ({geom.W}x{geom.H}): {k} frames (cv2 {want['frames']}); V1 native "
            f"against plain: {n_syn} VOPs differ; V2 against plain: {n_pix} bytes differ; V3 "
            f"on cv2's frames against plain: {n_v3} levels differ; Y "
            f"planes whose sha256 differs from cv2's: {y_bad or 'none'}; BGR gap to cv2 per "
            f"frame: {gaps}")
        check(k == want["frames"], f"{key}: {k} frames, cv2 {want['frames']}")
        check(n_syn == n_pix == n_v3 == 0, f"{key}: V1/V2/V3 differ from their plain versions")
        check(not y_bad, f"{key}: Y planes differ from cv2's in frames {y_bad}")
        check(max(gaps) <= 2, f"{key}: BGR gap to cv2 {max(gaps)} > 2")
    return vops, err, worst_bgr


def check_mp4v_streams(torch, dev, card):
    """21b: seeded random-syntax streams of the plain stream writer (1MV and
    4MV, not_coded, dquant, forced and decided ac_pred, every DC threshold,
    vectors past the picture, stuffing), V1's native writer's bytes and its
    decode against the plain versions, V2 on the card against the plain
    decode. returns (the VOPs checked, the largest gaps {dec, enc, v2})."""
    import numpy as np
    from mft_tpu_torch.io import mpeg4 as M
    from mft_tpu_torch.ops import mpeg4 as OM
    vops = n_bytes = n_syn = n_pix = 0
    err = dict(dec=0, enc=0, v2=0)
    for seed, W, H, kinds in MP4V_STREAMS:
        rng = np.random.default_rng(seed)
        vol = M.Vol(W, H, 25)
        geom = M.Geometry(W, H)
        ref = ref_t = None
        for i, kind in enumerate(kinds):
            syn = M.random_syntax(rng, vol, int(kind), 0, i)
            data = M.vlc_encode_ref(syn, vol, (0, 2))
            native = OM.mpeg4_vlc_encode(syn, vol, dev, (0, 2))
            n_bytes += int(native != data)
            err["enc"] = max(err["enc"], bytes_gap(np, native, data))
            got = OM.mpeg4_vlc_decode(data[4:], vol, dev)
            plain = M.vlc_decode_ref(data[4:], vol)
            n_syn += 0 if got.equal(plain) else 1
            err["dec"] = max(err["dec"], syntax_gap(np, got, plain))
            p = got.kind == M.P_VOP
            planes = M.decode_pixels_ref(plain.levels, plain.mode, plain.qp, plain.mv,
                                         ref if p else None, geom, plain.rounding)
            ref_t, img = OM.mpeg4_decode_pixels(*mp4v_syntax_tensors(torch, got, dev),
                                                ref_t if p else None, geom, got.rounding)
            bgr = M.yuv_to_bgr_ref(planes, geom)
            n_pix += int((ref_t.cpu().numpy() != planes).sum())
            n_pix += int((img.cpu().numpy() != bgr).sum())
            err["v2"] = max(err["v2"], array_gap(np, ref_t.cpu().numpy(), planes),
                            array_gap(np, img.cpu().numpy(), bgr))
            ref = planes
            vops += 1
    log(f"21b: {vops} random-syntax VOPs ({len(MP4V_STREAMS)} streams): V1 writer bytes "
        f"differing in {n_bytes} VOPs, V1 decode in {n_syn}, V2 planes/BGR bytes {n_pix} [{card}]")
    check(n_bytes == n_syn == n_pix == 0, "V1/V2 differ from their plain versions on the "
                                          "random-syntax streams")
    return vops, err


def psnr(np, a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def gop_weighted(values):
    """A frame's mean over a GOP from the values of its first VOPs (an
    I-VOP, then P-VOPs): the I-VOP weighs 1/GOP, the P-VOPs' mean the rest;
    over a whole GOP the plain mean."""
    from mft_tpu_torch.io.mpeg4 import GOP
    if len(values) == 1:
        return values[0]
    return (values[0] + (GOP - 1) * sum(values[1:]) / (len(values) - 1)) / GOP


def check_mp4v_encoder(torch, dev, card, H, W, n, n_plain, tmp):
    """21c: the encoder at H x W on the moving synthetic clip: its first n
    frames written on the card (V3, V1's writer, V2 for the closed loop)
    byte for byte with the plain encoder's, V3's levels along the closed
    loop against its plain version, the file decoded back by V1 and V2
    (frames equal to the plain decode); then a whole GOP (12 frames)
    written on the card and decoded back (PSNR printed) for the times: V2
    and V3 by graph replay on its first P-VOP beside their bounds ((syntax
    + plane + frame bytes) / 3.35 TB/s) and plain versions, V2 also on a
    random-syntax P-VOP at 512x512 (1MV/4MV, half-pel, vectors past the
    edge); V1's native host ms a frame over the GOP (decode, encode) beside
    the Python plain versions and the host bound of its serial chain of
    codes and bit fields, as J1's, both from the GOP's first ``n_plain``
    VOPs weighted as a GOP. returns the stats {v2, v3, dec, enc} and the
    largest gaps to the plain versions {enc, v2, v3}."""
    import numpy as np
    from mft_tpu_torch.io import mpeg4 as M
    from mft_tpu_torch.io.mp4 import read_mp4
    from mft_tpu_torch.io.video import get_video_frames
    from mft_tpu_torch.ops import mpeg4 as OM
    frames = synthetic_clip(M.GOP - 1, H, W, seed=7)
    geom = M.Geometry(W, H)
    qp = M.ENCODER_QP
    paths = {}
    for d, count, name in ((dev, n, "card"), ("cpu", n, "plain"), (dev, M.GOP, "gop")):
        paths[name] = tmp / f"enc_{H}_{name}.mp4"
        enc = M.Mp4vEncoder(paths[name], 25.0, W, H, device=d)
        for f in frames[:count]:
            enc.write(f)
        enc.close()
    card_bytes, plain_bytes = (paths[k].read_bytes() for k in ("card", "plain"))
    err = dict(enc=max(bytes_gap(np, a, b) for a, b in zip(
        read_mp4(paths["card"]).read_samples(), read_mp4(paths["plain"]).read_samples())),
        v2=0, v3=0)
    # V3 along the plain encoder's closed loop, from the same references
    ref = ref_t = None
    zero_mv = np.zeros((geom.nmb, 5, 2), np.int16)
    n_v3 = 0
    for i, f in enumerate(frames[:n]):
        kind = M.I_VOP if i % M.GOP == 0 else M.P_VOP
        p = kind == M.P_VOP
        got = OM.mpeg4_encode_pixels(torch.from_numpy(f).to(dev), ref_t if p else None, qp,
                                     geom).cpu().numpy()
        want = M.encode_pixels_ref(f, ref if p else None, qp, geom)
        n_v3 += int((got != want).sum())
        err["v3"] = max(err["v3"], array_gap(np, got, want))
        syn = M.encoder_syntax(want, kind, qp, 0, 0)
        ref = M.decode_pixels_ref(want, syn.mode, syn.qp, zero_mv, ref if p else None, geom, 0)
        ref_t = torch.from_numpy(ref).to(dev)
    got = list(get_video_frames(paths["card"], device=dev))
    want = list(get_video_frames(paths["card"], device="cpu"))
    n_diff = sum(int((a != b).sum()) for a, b in zip(got, want))
    for a, b in zip(got, want):
        err["v2"] = max(err["v2"], array_gap(np, a, b))
    gop = list(get_video_frames(paths["gop"], device=dev))
    quality = psnr(np, np.stack(gop), np.stack(frames))
    log(f"21c {H}x{W}: {n} frames, qp {qp}: card file {len(card_bytes)} bytes, equal to the "
        f"plain encoder's: {card_bytes == plain_bytes}; V3 along the closed loop against "
        f"plain: {n_v3} levels differ; decoded back on the card ({len(got)} frames) against "
        f"the plain decode: {n_diff} bytes differ; a GOP of {len(gop)} frames written on the "
        f"card, PSNR {quality:.2f} dB [{card}]")
    check(card_bytes == plain_bytes, f"21c {H}x{W}: the card's file differs from the plain "
                                     "encoder's")
    check(n_v3 == 0, f"21c {H}x{W}: V3 differs from its plain version in {n_v3} levels")
    check(len(got) == n and n_diff == 0, f"21c {H}x{W}: the decode differs from the plain one")
    check(len(gop) == M.GOP, f"21c {H}x{W}: the GOP file decodes to {len(gop)} frames")
    # V2 and V3 on the GOP's first P-VOP (its reference the decoded I-VOP)
    video = read_mp4(paths["gop"])
    vol = M.parse_config(video.config)
    samples = [s[M.find_vop(s, vol)[0]:] for s in video.read_samples()]
    syn_i, syn_p = (M.vlc_decode_ref(s, vol) for s in samples[:2])
    ref = M.decode_pixels_ref(syn_i.levels, syn_i.mode, syn_i.qp, syn_i.mv, None, geom, 0)
    ref_t = torch.from_numpy(ref).to(dev)
    t = mp4v_syntax_tensors(torch, syn_p, dev)
    img_t = torch.from_numpy(frames[1]).to(dev)
    v2_ms = graph_ms(lambda: OM.mpeg4_decode_pixels(*t, ref_t, geom, 0))
    v3_ms = graph_ms(lambda: OM.mpeg4_encode_pixels(img_t, ref_t, qp, geom))
    v2_plain = 1e3 * median_s(lambda: M.yuv_to_bgr_ref(M.decode_pixels_ref(
        syn_p.levels, syn_p.mode, syn_p.qp, syn_p.mv, ref, geom, 0), geom), 1)
    v3_plain = 1e3 * median_s(lambda: M.encode_pixels_ref(frames[1], ref, qp, geom), 1)

    def v2_bound(syn):
        syntax_bytes = sum(a.nbytes for a in (syn.levels, syn.mode, syn.qp, syn.mv))
        return 1e3 * (syntax_bytes + 2 * geom.size + H * W * 3) / HBM_BYTES_PER_S

    v3_bound = 1e3 * (H * W * 3 + geom.size + syn_p.levels.nbytes) / HBM_BYTES_PER_S
    stats = dict(v2=dict(ms=v2_ms, plain_ms=v2_plain, bound_ms=v2_bound(syn_p), bound_by="bytes"),
                 v3=dict(ms=v3_ms, plain_ms=v3_plain, bound_ms=v3_bound, bound_by="bytes"))
    mv_log = ""
    if (H, W) == (512, 512):
        # V2 with motion: a random-syntax P-VOP of the plain writer, decoded
        syn_m = M.random_syntax(np.random.default_rng(MP4V_MOTION_SEED), vol, M.P_VOP, 0, 1)
        syn_m = M.vlc_decode_ref(M.vlc_encode_ref(syn_m, vol)[4:], vol)
        tm = mp4v_syntax_tensors(torch, syn_m, dev)
        planes_t, img_m = OM.mpeg4_decode_pixels(*tm, ref_t, geom, syn_m.rounding)
        planes = M.decode_pixels_ref(syn_m.levels, syn_m.mode, syn_m.qp, syn_m.mv, ref, geom,
                                     syn_m.rounding)
        bgr = M.yuv_to_bgr_ref(planes, geom)
        n_mv = int((planes_t.cpu().numpy() != planes).sum() + (img_m.cpu().numpy() != bgr).sum())
        err["v2"] = max(err["v2"], array_gap(np, planes_t.cpu().numpy(), planes),
                        array_gap(np, img_m.cpu().numpy(), bgr))
        check(n_mv == 0, f"21c: V2 differs from its plain version on the P-VOP with motion "
                         f"in {n_mv} bytes")
        ms_mv = graph_ms(lambda: OM.mpeg4_decode_pixels(*tm, ref_t, geom, syn_m.rounding))
        plain_mv = 1e3 * median_s(lambda: M.yuv_to_bgr_ref(M.decode_pixels_ref(
            syn_m.levels, syn_m.mode, syn_m.qp, syn_m.mv, ref, geom, syn_m.rounding), geom), 1)
        modes = np.bincount(syn_m.mode.astype(np.int64), minlength=4)
        stats["v2"].update(ms_mv=ms_mv, plain_ms_mv=plain_mv, bound_ms_mv=v2_bound(syn_m))
        mv_log = (f"; V2 on a random-syntax P-VOP (MBs not_coded/1MV/4MV/intra "
                  f"{'/'.join(str(int(c)) for c in modes)}, fcode "
                  f"{int(syn_m.header[4])}, rounding {syn_m.rounding}): {ms_mv:.4f} ms (bound "
                  f"{v2_bound(syn_m):.4f}, plain {plain_mv:.2f}), 0 bytes from plain")
    # V1 over the GOP natively; the plain versions and the bound from its
    # first n_plain VOPs, weighted as a GOP
    syns = [OM.vlc_decode_native(s, vol) for s in samples]    # bit for bit with plain (21a)
    dec_t = sorted(median_s(lambda: [OM.mpeg4_vlc_decode(s, vol, dev) for s in samples], 1)
                   for _ in range(5))
    enc_t = sorted(median_s(lambda: [OM.mpeg4_vlc_encode(s, vol, dev) for s in syns], 1)
                   for _ in range(5))
    dec_ms, enc_ms = (1e3 * ts[2] / len(samples) for ts in (dec_t, enc_t))
    spread = lambda ts: f"{1e3 * ts[0] / len(samples):.3f}-{1e3 * ts[-1] / len(samples):.3f}"
    dec_py, enc_py, symbols = [], [], []
    for s, syn in zip(samples[:n_plain], syns):
        counts = {}
        dec_py.append(1e3 * median_s(lambda: M.vlc_decode_ref(s, vol, counts), 1))
        enc_py.append(1e3 * median_s(lambda: M.vlc_encode_ref(syn, vol), 1))
        symbols.append(vlc_symbols(counts))
    dec_py, enc_py = gop_weighted(dec_py), gop_weighted(enc_py)
    codes = gop_weighted([c for c, _ in symbols])
    fields = gop_weighted([f for _, f in symbols])
    clock = host_clock_hz()
    dec_bound = 1e3 * (HOST_CYCLES_CODE_DECODE * codes + fields) / clock
    enc_bound = 1e3 * HOST_CYCLES_PUT * (codes + fields) / clock
    log(f"21c {H}x{W}: V2 {v2_ms:.4f} ms (bound {stats['v2']['bound_ms']:.4f}, plain "
        f"{v2_plain:.2f}), V3 {v3_ms:.4f} ms (bound {v3_bound:.4f}, plain {v3_plain:.2f}) by "
        f"graph replay (the first P-VOP){mv_log}; V1 host ms a frame over a GOP of "
        f"{len(samples)} VOPs: decode {dec_ms:.3f} (5 runs {spread(dec_t)}; bound "
        f"{dec_bound:.3f}, Python {dec_py:.1f}), encode {enc_ms:.3f} (5 runs {spread(enc_t)}; "
        f"bound {enc_bound:.3f}, Python {enc_py:.1f}); {codes:.0f} codes and {fields:.0f} bit "
        f"fields a frame (Python and the bounds from {n_plain} VOPs, weighted as a GOP), host "
        f"clock {clock / 1e9:.3f} GHz [{card}]")
    stats.update(dec=dict(ms=dec_ms, plain_ms=dec_py, bound_ms=dec_bound, bound_by="operations"),
                 enc=dict(ms=enc_ms, plain_ms=enc_py, bound_ms=enc_bound, bound_by="operations"))
    return stats, err


def run_mp4v_demo(torch, ops, dev, card, tmp):
    """21d: ``apps.demo.run`` with the default configuration (512x512, random
    weights) on a 12-frame ``.mp4`` the port's encoder wrote on the card:
    its tracks bit for bit with a fresh tracker's on the same decoded frames
    as arrays (deterministic cuDNN), ``_points.mp4`` and ``_edit.mp4`` read
    back by the port, 12 frames each, V1/V2 once a frame read and V3/V1/V2
    once a frame a file written; then ``apps.flow_demo`` with ``--mp4``
    writes ``flow.mp4``. returns (the demo's launch counts, frames/s, the
    codec, model and rendering shares)."""
    import argparse
    import numpy as np
    from mft_tpu_torch.apps import demo, flow_demo
    from mft_tpu_torch.config import default_config
    from mft_tpu_torch.io import video as demo_video
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking
    frames = synthetic_clip(DEMO_FRAMES - 1)
    clip = tmp / "clip.mp4"
    with demo_video.VideoWriter(clip, fps=25.0, device=dev) as w:
        for f in frames:
            w.write(f)
    io_s = [0.0, 0.0, 0.0]                       # decode, encode, rendering
    tracks = []
    render = demo.render_frame

    def timed_frames(path, reverse=False, device="cuda"):
        it = demo_video.get_video_frames(path, reverse, device)
        while True:
            t = time.perf_counter()
            frame = next(it, None)
            io_s[0] += time.perf_counter() - t
            if frame is None:
                return
            yield frame

    class TimedWriter(demo_video.VideoWriter):
        def write(self, frame):
            t = time.perf_counter()
            super().write(frame)
            io_s[1] += time.perf_counter() - t

    def recording_render(frame, result, queries, edit, edit_mask):
        t = time.perf_counter()
        out = render(frame, result, queries, edit, edit_mask)
        io_s[2] += time.perf_counter() - t
        tracks.append((out[2], out[3]))
        return out

    out = tmp / "mp4_demo"
    args = argparse.Namespace(video=str(clip), config="default", out=str(out), grid_spacing=30,
                              fps=25.0, max_frames=None, device=str(dev))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    saved = demo.get_video_frames, demo.VideoWriter, demo.render_frame
    demo.get_video_frames, demo.VideoWriter, demo.render_frame = (timed_frames, TimedWriter,
                                                                  recording_render)
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = demo.run(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
        demo.get_video_frames, demo.VideoWriter, demo.render_frame = saved
        decoded = list(demo_video.get_video_frames(clip, device=dev))
        tracker = MFT(default_config(), device=dev)
        queries = demo.get_queries(decoded[0].shape, 30)
        mine = []
        for i, frame in enumerate(decoded):
            meta = tracker.init(frame) if i == 0 else tracker.track(frame)
            mine.append(convert_to_point_tracking(meta.result, queries))
    finally:
        demo.get_video_frames, demo.VideoWriter, demo.render_frame = saved
        torch.backends.cudnn.deterministic = False
    tracked = DEMO_FRAMES - 1
    model = seconds - sum(io_s)
    shares = dict(codec=(io_s[0] + io_s[1]) / seconds, decode=io_s[0] / seconds,
                  encode=io_s[1] / seconds, render=io_s[2] / seconds, model=model / seconds)
    log(f"21d demo (default config, 512x512, bf16) on a {DEMO_FRAMES}-frame .mp4: {n} frames "
        f"in {seconds:.3f} s ({n / seconds:.2f} frames/s, set-up and the first frame "
        f"included); codec {io_s[0] + io_s[1]:.3f} s ({shares['codec']:.1%}: decode "
        f"{io_s[0]:.3f} s, two writers {io_s[1]:.3f} s), rendering {io_s[2]:.3f} s "
        f"({shares['render']:.1%}), model and the rest {model:.3f} s ({shares['model']:.1%}); "
        f"launches {counts} [{card}]")
    want = expected_counts(ops, corr_lookup_fused=11 * tracked, corr_lookup=tracked,
                           chain_select=tracked, bilinear_warp=DEMO_FRAMES,
                           mpeg4_vlc_decode=DEMO_FRAMES, mpeg4_vlc_encode=2 * DEMO_FRAMES,
                           mpeg4_encode_pixels=2 * DEMO_FRAMES,
                           mpeg4_decode_pixels=3 * DEMO_FRAMES)
    check(n == DEMO_FRAMES, f"mp4 demo wrote {n} frames, want {DEMO_FRAMES}")
    check(counts == want, f"mp4 demo launch counts {counts} != {want} (V1 and V2 a frame "
                          f"read, V3, V1 and V2 a frame a file written)")
    diff = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum()) for a, b in zip(tracks, mine))
    finite = all(np.isfinite(c).all() and np.isfinite(o).all() for c, o in tracks)
    log(f"21d: the demo's tracks of {len(queries)} queries over {n} frames against the same "
        f"decoded frames as arrays: {diff} values differ; finite {finite}; V2 "
        f"{counts['mpeg4_decode_pixels'] / n:.0f} and V3 {counts['mpeg4_encode_pixels'] / n:.0f} "
        f"launches a frame")
    check(len(tracks) == len(mine) and diff == 0 and finite,
          f"mp4 demo tracks differ from the arrays' in {diff} values")
    H, W = frames[0].shape[:2]
    for name in ("points", "edit"):
        check_video_file(out / f"clip_{name}.mp4", DEMO_FRAMES, (H, W, 3),
                         f"mp4 demo {name}", dev)
    pairs = tmp / "pairs.mp4"
    with demo_video.VideoWriter(pairs, fps=25.0, device=dev) as w:
        for f in frames[:3]:
            w.write(f)
    fargs = argparse.Namespace(video=str(pairs), config="synth", out=str(tmp / "flow_mp4"),
                               mp4=True, show_ou=False, fps=10.0, device=str(dev))
    m = flow_demo.run(fargs)
    check(m == 2, f"flow demo on an .mp4 wrote {m} panels")
    check_video_file(tmp / "flow_mp4" / "flow.mp4", 2, (2 * H, W, 3), "flow.mp4", dev)
    log(f"21d: flow_demo --mp4 on a 3-frame .mp4 wrote flow.mp4 (2 panels of {2 * H}x{W})")
    return counts, n / seconds, shares


def run_video(torch, ops, dev, card):
    """Phase 21: the mp4v codec against the fixtures (a), random syntax (b),
    the encoder (c), the demos on .mp4 (d)."""
    import tempfile
    from pathlib import Path
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    t0 = time.perf_counter()
    vops, err_a, worst_bgr = check_mp4v_fixtures(torch, dev, card, hashes)
    log(f"phase 21a seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    vops_b, err_b = check_mp4v_streams(torch, dev, card)
    vops += vops_b
    log(f"phase 21b seconds {time.perf_counter() - t0:.2f}")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        enc, errs = {}, [err_a, err_b]
        for H, W, n, n_plain in MP4V_ENCODE:
            enc[(H, W)], e = check_mp4v_encoder(torch, dev, card, H, W, n, n_plain, tmp)
            errs.append(e)
        log(f"phase 21c seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        counts, fps, shares = run_mp4v_demo(torch, ops, dev, card, tmp)
        log(f"phase 21d seconds {time.perf_counter() - t0:.2f}")
    # each kernel's largest gap to its plain version over 21a-21c
    err = {k: max(e.get(k, 0) for e in errs) for k in ("dec", "enc", "v2", "v3")}
    log(f"21: largest gaps to the plain versions: V1 decode (syntax arrays) {err['dec']}, V1 "
        f"encode (bytes) {err['enc']}, V2 (planes, BGR) {err['v2']}, V3 (levels) {err['v3']}")
    return dict(enc=enc, demo=counts, fps=fps, shares=shares, max_abs_err=err,
                bgr_gap=worst_bgr, vops=vops)


# --------------------------------------------------------------------------- #
# phase 22: video containers: the committed AVI, Matroska, MP4 and QuickTime
# fixtures (mp4v and Motion JPEG) against cv2's recorded frames (a), J4 against
# its plain version and timed at 512x512 and 1080x1920 (b), the writer at every
# suffix (c), the default-config demo on a Motion JPEG .avi (d)
# --------------------------------------------------------------------------- #
MJPEG_SIZES = ((512, 512), (1080, 1920))
MJPEG_SAMPLINGS = ("420", "422")        # timed; 4:4:4 and grey checked at MJPEG_KINDS
MJPEG_KINDS = 512                       # px: the frames of 22b's other conversion paths
WRITER_SUFFIXES = (".mp4", ".mov", ".m4v", ".3gp", ".avi", ".mkv")


def mjpeg_coefs(J, MJ, path):
    """(JpegFile, quantized coefficients) of every frame of an MJPEG file,
    J1's plain version (the native one runs in the entry point)."""
    import numpy as np
    from mft_tpu_torch.io.container import open_track
    huff, qt, out = MJ.default_tables(), {}, []
    for data in open_track(path).read_samples():
        if not data:
            continue
        jf = MJ.parse_frame(data, huff, qt)
        co = np.zeros((jf.geom.blocks, 64), np.int16)
        for scan in jf.scans:
            J.huff_decode_ref(scan, co)
        out.append((jf, co))
    return out


def check_container_fixtures(torch, ops, dev, card, hashes):
    """22a: every committed container fixture read on the card through the
    port's entry point (J1 natively + J4, or V1 + V2): each frame's hash
    equal to the one recorded from cv2, the frame count and fps cv2 gave;
    for the MJPEG ones J4 on the batch of the file's frames against its
    plain version. returns (frames, J4's differing values, J4's largest gap)."""
    import numpy as np
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.io import mjpeg as MJ
    from mft_tpu_torch.io import video
    from mft_tpu_torch.io.container import open_track
    from mft_tpu_torch.ops.mjpeg import mjpeg_decode_pixels
    frames = n_diff = worst = 0
    for key, want in sorted(hashes["video"].items()):
        path = os.path.join(FIXTURES, key)
        track = open_track(path)
        ops.reset_launch_counts()
        got = list(video.get_video_frames(path, device=dev))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        bad = [k for k, f in enumerate(got) if array_hash(f) != want["bgr"][k]] \
            if len(got) == want["frames"] else list(range(len(got)))
        diff = ""
        if track.codec == "mjpeg":
            files = mjpeg_coefs(J, MJ, path)
            co = np.stack([c for _, c in files])
            q = np.stack([jf.qtabs for jf, _ in files]).astype(np.int32)
            out = mjpeg_decode_pixels(torch.from_numpy(co).to(dev), torch.from_numpy(q).to(dev),
                                      files[0][0].geom).cpu().numpy()
            plain = MJ.decode_pixels_ref(co, q, files[0][0].geom)
            d = int((out != plain).sum())
            n_diff += d
            worst = max(worst, array_gap(np, out, plain))
            diff = f"; J4 on the batch against plain: {d} values differ"
        log(f"22a {key} ({track.codec} '{track.fourcc}', {track.width}x{track.height}, "
            f"{track.fps:g} fps): {len(got)} frames (cv2 {want['frames']}, {want['fps']:g} fps); "
            f"frames whose sha256 differs from cv2's: {bad or 'none'}; launches {counts}{diff}")
        check(len(got) == want["frames"] and not bad, f"{key}: frames differ from cv2's")
        check(track.fps == want["fps"], f"{key}: fps {track.fps}, cv2 {want['fps']}")
        frames += len(got)
    check(n_diff == 0, f"J4 differs from its plain version in {n_diff} values on the fixtures")
    return frames, n_diff, worst


def time_mjpeg(torch, dev, card, J, MJ, H, W, sampling):
    """22b: J4 on one frame of the moving clip (quantized by J3 at quality
    95, 4:2:0 or 4:2:2) against its plain version, by graph replay, beside
    its bytes bound ((coefficient + table + BGR bytes) / 3.35 TB/s) and the
    plain version's host time."""
    import numpy as np
    from mft_tpu_torch.ops.jpeg import jpeg_encode_pixels
    from mft_tpu_torch.ops.mjpeg import mjpeg_decode_pixels
    img = jpeg_frames(1, H, W, seed=7)
    geom = J.geometry_for(H, W, 3, sampling)
    qtabs, recips = J._tables(geom, 95)
    coefs = jpeg_encode_pixels(torch.from_numpy(img).to(dev), torch.from_numpy(recips).to(dev),
                               geom)
    q_t = torch.from_numpy(qtabs[None]).to(dev)
    got = mjpeg_decode_pixels(coefs, q_t, geom).cpu().numpy()
    coef_np = coefs.cpu().numpy()
    t0 = time.perf_counter()
    plain = MJ.decode_pixels_ref(coef_np, qtabs[None], geom)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    diff = int((got != plain).sum())
    ms = graph_ms(lambda: mjpeg_decode_pixels(coefs, q_t, geom))
    nbytes = geom.blocks * 64 * 2 + qtabs.nbytes + H * W * 3
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    gap = int(np.abs(got.astype(np.int64) - img[0]).max())
    log(f"22b J4 {H}x{W} {sampling} q95: {ms:.4f} ms by graph replay (bound {bound:.4f} ms, "
        f"{bound / ms:.1%} of it; {nbytes} bytes), plain {plain_ms:.2f} ms; values differing "
        f"from plain {diff}; largest gap to the source frame {gap} [{card}]")
    check(diff == 0, f"J4 {H}x{W} {sampling}: {diff} values differ from its plain version")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                max_abs_err=float(array_gap(np, got, plain)))


def check_mjpeg_kinds(torch, dev, card, J, MJ):
    """22b: J4 against its plain version on 4:4:4 and grey frames of
    MJPEG_KINDS x MJPEG_KINDS (the other two conversion paths) and on a
    batch of 3 frames of 4:2:0."""
    import numpy as np
    from mft_tpu_torch.ops.jpeg import jpeg_encode_pixels
    from mft_tpu_torch.ops.mjpeg import mjpeg_decode_pixels
    worst = 0
    for sampling, channels, n in (("444", 3, 1), ("420", 1, 1), ("420", 3, 3)):
        img = jpeg_frames(n, MJPEG_KINDS, MJPEG_KINDS, seed=8, channels=channels)
        geom = J.geometry_for(MJPEG_KINDS, MJPEG_KINDS, channels, sampling)
        qtabs, recips = J._tables(geom, 80)
        coefs = jpeg_encode_pixels(torch.from_numpy(img).to(dev),
                                   torch.from_numpy(recips).to(dev), geom)
        q = np.repeat(qtabs[None], n, 0)
        got = mjpeg_decode_pixels(coefs, torch.from_numpy(q).to(dev), geom).cpu().numpy()
        plain = MJ.decode_pixels_ref(coefs.cpu().numpy(), q, geom)
        diff = int((got != plain).sum())
        worst = max(worst, array_gap(np, got, plain))
        kind = "grey" if channels == 1 else sampling
        log(f"22b J4 {MJPEG_KINDS}x{MJPEG_KINDS} {kind} x{n}: values differing from plain "
            f"{diff}")
        check(diff == 0, f"J4 {kind}: {diff} values differ from its plain version")
    return worst


def check_writers(torch, ops, dev, card, tmp):
    """22c: the writer at every suffix on 14 frames (an I-VOP, 11 P-VOPs, an
    I-VOP, a P-VOP), read back by the port on the card: 14 frames each, the
    same frames from every container (one encoder, one bitstream)."""
    import numpy as np
    from mft_tpu_torch.io import video
    frames = synthetic_clip(13, 128, 160, seed=4)
    decoded = {}
    for suffix in WRITER_SUFFIXES:
        path = tmp / f"w{suffix}"
        with video.VideoWriter(path, fps=29.97, device=dev) as w:
            for f in frames:
                w.write(f)
        decoded[suffix] = list(video.get_video_frames(path, device=dev))
        n = video.get_video_length(path, device=dev)
        check(len(decoded[suffix]) == n == len(frames), f"writer {suffix}: {n} frames")
    ref = decoded[".mp4"]
    differ = {s: sum(int((a != b).sum()) for a, b in zip(d, ref)) for s, d in decoded.items()}
    psnr_db = psnr(np, np.stack(frames), np.stack(ref))
    log(f"22c writer at {', '.join(WRITER_SUFFIXES)}: {len(frames)} frames each read back on "
        f"the card; values differing from the .mp4's frames {differ}; PSNR to the source "
        f"{psnr_db:.2f} dB")
    check(not any(differ.values()), f"containers decode to different frames: {differ}")


def run_mjpeg_demo(torch, ops, dev, card, tmp):
    """22d: ``apps.demo.run`` with the default configuration (512x512, random
    weights) on a 12-frame Motion JPEG ``.avi`` (J3 + J1's encoder on the
    card's machine, the port's AVI muxer), its writers patched to write
    ``.avi``: tracks bit for bit with a fresh tracker's on the same decoded
    frames as arrays, J1 and J4 once a frame read, V3, V1 and V2 once a
    frame a file written. returns (its launch counts,
    frames/s)."""
    import argparse
    import numpy as np
    from mft_tpu_torch.apps import demo
    from mft_tpu_torch.config import default_config
    from mft_tpu_torch.io import video as demo_video
    from mft_tpu_torch.io.avi import AviWriter
    from mft_tpu_torch.io.jpeg import encode_jpeg
    from mft_tpu_torch.tracker import MFT
    from mft_tpu_torch.tracker.point_tracking import convert_to_point_tracking
    frames = synthetic_clip(DEMO_FRAMES - 1)
    clip = tmp / "clip.avi"
    H, W = frames[0].shape[:2]
    with AviWriter(clip, 25.0, W, H, b"MJPG") as w:
        for f in frames:
            w.add(encode_jpeg(f, 95, dev), True)
    tracks = []
    render = demo.render_frame

    class AviWriterOut(demo_video.VideoWriter):
        def __init__(self, path, fps=25.0, device="cuda"):
            super().__init__(os.path.splitext(str(path))[0] + ".avi", fps, device)

    def recording_render(frame, result, queries, edit, edit_mask):
        out = render(frame, result, queries, edit, edit_mask)
        tracks.append((out[2], out[3]))
        return out

    out = tmp / "mjpeg_demo"
    args = argparse.Namespace(video=str(clip), config="default", out=str(out), grid_spacing=30,
                              fps=25.0, max_frames=None, device=str(dev))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    saved = demo.VideoWriter, demo.render_frame
    demo.VideoWriter, demo.render_frame = AviWriterOut, recording_render
    try:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = demo.run(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = ops.launch_counts()
        demo.VideoWriter, demo.render_frame = saved
        decoded = list(demo_video.get_video_frames(clip, device=dev))
        tracker = MFT(default_config(), device=dev)
        queries = demo.get_queries(decoded[0].shape, 30)
        mine = []
        for i, frame in enumerate(decoded):
            meta = tracker.init(frame) if i == 0 else tracker.track(frame)
            mine.append(convert_to_point_tracking(meta.result, queries))
    finally:
        demo.VideoWriter, demo.render_frame = saved
        torch.backends.cudnn.deterministic = False
    tracked = DEMO_FRAMES - 1
    want = expected_counts(ops, corr_lookup_fused=11 * tracked, corr_lookup=tracked,
                           chain_select=tracked, bilinear_warp=DEMO_FRAMES,
                           jpeg_huff_decode=DEMO_FRAMES, mjpeg_decode_pixels=DEMO_FRAMES,
                           mpeg4_vlc_encode=2 * DEMO_FRAMES,
                           mpeg4_encode_pixels=2 * DEMO_FRAMES,
                           mpeg4_decode_pixels=2 * DEMO_FRAMES)
    diff = sum(int((a[0] != b[0]).sum() + (a[1] != b[1]).sum()) for a, b in zip(tracks, mine))
    finite = all(np.isfinite(c).all() and np.isfinite(o).all() for c, o in tracks)
    log(f"22d demo (default config, 512x512, bf16) on a {DEMO_FRAMES}-frame MJPEG .avi "
        f"({clip.stat().st_size} bytes): {n} frames in {seconds:.3f} s "
        f"({n / seconds:.2f} frames/s, set-up and the first frame included); launches "
        f"{counts}; its tracks of {len(queries)} queries against the same decoded frames as "
        f"arrays: {diff} values differ; finite {finite} [{card}]")
    check(n == DEMO_FRAMES, f"mjpeg demo wrote {n} frames, want {DEMO_FRAMES}")
    check(counts == want, f"mjpeg demo launch counts {counts} != {want}")
    check(len(tracks) == len(mine) and diff == 0 and finite,
          f"mjpeg demo tracks differ from the arrays' in {diff} values")
    for name in ("points", "edit"):
        check_video_file(out / f"clip_{name}.avi", DEMO_FRAMES, (H, W, 3),
                         f"mjpeg demo {name}", dev)
    return counts, n / seconds


def run_containers(torch, ops, dev, card):
    """Phase 22: the container fixtures (a), J4 (b), the writers (c), the
    demo on an MJPEG .avi (d)."""
    import tempfile
    from pathlib import Path
    from mft_tpu_torch.io import jpeg as J
    from mft_tpu_torch.io import mjpeg as MJ
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    t0 = time.perf_counter()
    frames, _, worst = check_container_fixtures(torch, ops, dev, card, hashes)
    log(f"phase 22a seconds {time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    stats = {(H, W, s): time_mjpeg(torch, dev, card, J, MJ, H, W, s)
             for H, W in MJPEG_SIZES for s in MJPEG_SAMPLINGS}
    worst = max([worst, check_mjpeg_kinds(torch, dev, card, J, MJ)]
                + [st["max_abs_err"] for st in stats.values()])
    log(f"phase 22b seconds {time.perf_counter() - t0:.2f}")
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        check_writers(torch, ops, dev, card, tmp)
        log(f"phase 22c seconds {time.perf_counter() - t0:.2f}")
        t0 = time.perf_counter()
        counts, fps = run_mjpeg_demo(torch, ops, dev, card, tmp)
        log(f"phase 22d seconds {time.perf_counter() - t0:.2f}")
    log(f"22: {frames} fixture frames at cv2's hashes; J4's largest gap to its plain "
        f"version {worst}")
    return dict(stats=stats, demo=counts, fps=fps, max_abs_err=float(worst))


def main() -> int:
    # a hang exits non-zero with a traceback instead of running out the clock
    faulthandler.dump_traceback_later(1100, exit=True)
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
        t = time.perf_counter()
        demo_counts = run_apps(torch, ops, dev, card)
        log(f"phase 17 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        synth_counts = run_generators_and_trainer(torch, ops, dev, card)
        log(f"phase 18 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        jp = run_jpeg(torch, ops, dev, card, recipes)
        for name in ("corr_lookup_fused", "corr_lookup", "chain_select", "bilinear_warp"):
            check(jp["demo"][name] == demo_counts[name],
                  f"{name}: the JPEG demo's launches {jp['demo'][name]} differ from the PNG "
                  f"demo's {demo_counts[name]}")
        log(f"phase 19 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        pj = run_fixtures(torch, ops, dev, card)
        log(f"phase 20 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        vid = run_video(torch, ops, dev, card)
        log(f"phase 21 seconds {time.perf_counter() - t:.2f}")
        t = time.perf_counter()
        con = run_containers(torch, ops, dev, card)
        log(f"phase 22 seconds {time.perf_counter() - t:.2f}")
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
    for k in kernels:   # the demo's 12 frames (phase 17a): 11 tracked, 12 conversions
        if k["name"] in ("corr_lookup_fused", "corr_lookup", "chain_select", "bilinear_warp"):
            k["launches_demo"] = demo_counts[k["name"]]
    # the synthetic-shard trainer's steps (phase 18a, 24 steps, validation aside)
    for k in kernels:
        if k["name"] in synth_counts:
            k["launches_synth_train"] = synth_counts[k["name"]]
    # JPEG (phase 19): no Pallas site, cv2/PIL on the host in JAX; launches
    # from the demo on a JPEG directory (19b: J1's decoder and J2 a frame
    # read; it writes mp4v, so J1's encoder and J3 stay at 0), the
    # image-directory writer on the same 12 frames after it (19b, its counts
    # reset before it), the Kinetics-form runner (19c) and the dashcam recipe
    # (19d); times at 512x512, "_hd" at 1080x1920
    jpeg_rows = (("jpeg_huff_decode", "jpeg_entropy.cu", "mft_tpu/io/video.py:37", "dec"),
                 ("jpeg_huff_encode", "jpeg_entropy.cu", "mft_tpu/io/video.py:82", "enc"),
                 ("jpeg_decode_pixels", "jpeg.cu", "mft_tpu/train/augment.py:68", "j2"),
                 ("jpeg_encode_pixels", "jpeg.cu", "mft_tpu/train/augment.py:65", "j3"))
    for kname, source, where, key in jpeg_rows:
        st, hd = jp["stats"][(512, 512)][key], jp["stats"][(1080, 1920)][key]
        kernels.append(dict(name=kname, route="cuda", source=src + source, replaces=where,
                            launches=jp["demo"][kname], **st, library_ms=None,
                            launches_jpeg_writer=jp["writer"][kname],
                            ms_hd=hd["ms"], plain_ms_hd=hd["plain_ms"],
                            bound_ms_hd=hd["bound_ms"],
                            launches_kinetics=jp["kinetics"][kname],
                            launches_dashcam=jp["dashcam"][kname],
                            runs_on="host" if key in ("dec", "enc") else "card"))
    for k in kernels:   # the demo on JPEG frames (phase 19b): as on PNG frames
        if k["name"] in ("corr_lookup_fused", "corr_lookup", "chain_select", "bilinear_warp"):
            k["launches_demo_jpeg"] = jp["demo"][k["name"]]
    # progressive JPEG (phase 20a): J1's progressive routine on the host (its
    # times a frame at 512x512, "_hd" at 1080x1920, beside the baseline file
    # of the same pixels); the default-config demo on progressive frames,
    # its counts reset before it, through K1, K2, K3, the warp and J1-J3
    sd, hd = pj["sd"], pj["hd"]
    kernels.append(dict(name="jpeg_huff_decode_progressive", route="cuda",
                        source=src + "jpeg_entropy.cu", replaces="mft_tpu/io/video.py:37",
                        launches=pj["demo"]["jpeg_huff_decode_progressive"],
                        max_abs_err=pj["max_abs_err"],
                        **{k: sd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                        library_ms=None, ms_hd=hd["ms"], plain_ms_hd=hd["plain_ms"],
                        bound_ms_hd=hd["bound_ms"], baseline_ms=sd["baseline_ms"],
                        baseline_ms_hd=hd["baseline_ms"], decode_ms_hd=hd["decode_ms"],
                        baseline_decode_ms_hd=hd["baseline_decode_ms"], runs_on="host"))
    for k in kernels:
        if k["name"] in pj["demo"]:
            k["launches_progressive_demo"] = pj["demo"][k["name"]]
    # video files (phase 21): no Pallas site, cv2 (libavcodec) on the host in
    # JAX; launches from the default-config demo on a 12-frame .mp4 (21d, its
    # counts reset before it); times at 512x512, "_hd" at 1080x1920 (21c; V2
    # also "_mv" on a P-VOP with motion at 512x512); each row's max_abs_err
    # its own kernel's largest gap to its plain version over 21a-21c
    video_rows = (("mpeg4_vlc_decode", "mpeg4_vlc.cu", "mft_tpu/io/video.py:40", "dec"),
                  ("mpeg4_vlc_encode", "mpeg4_vlc.cu", "mft_tpu/io/video.py:86", "enc"),
                  ("mpeg4_decode_pixels", "mpeg4.cu", "mft_tpu/io/video.py:40", "v2"),
                  ("mpeg4_encode_pixels", "mpeg4.cu", "mft_tpu/io/video.py:86", "v3"))
    for kname, source, where, key in video_rows:
        st, hd = vid["enc"][(512, 512)][key], vid["enc"][(1080, 1920)][key]
        kernels.append(dict(name=kname, route="cuda", source=src + source, replaces=where,
                            launches=vid["demo"][kname],
                            max_abs_err=float(vid["max_abs_err"][key]), **st,
                            library_ms=None, ms_hd=hd["ms"], plain_ms_hd=hd["plain_ms"],
                            bound_ms_hd=hd["bound_ms"],
                            runs_on="host" if key in ("dec", "enc") else "card"))
    for k in kernels:   # the mp4 demo (phase 21d): as the demo on PNG frames
        if k["name"] in ("corr_lookup_fused", "corr_lookup", "chain_select", "bilinear_warp"):
            k["launches_demo_mp4"] = vid["demo"][k["name"]]
    # Motion JPEG (phase 22): no Pallas site, cv2 (libavcodec's mjpegdec,
    # swscale) on the host in JAX; J4's launches from the default-config demo
    # on a 12-frame MJPEG .avi (22d, its counts reset before it: one launch a
    # frame); times at 512x512, "_hd" at 1080x1920, 4:2:0
    # ("_422": 4:2:2); max_abs_err J4's largest gap to its plain version
    # over 22a-22b
    st = con["stats"]
    kernels.append(dict(name="mjpeg_decode_pixels", route="cuda", source=src + "mjpeg.cu",
                        replaces="mft_tpu/io/video.py:30",
                        launches=con["demo"]["mjpeg_decode_pixels"],
                        max_abs_err=con["max_abs_err"],
                        **{k: st[(512, 512, "420")][k] for k in
                           ("ms", "plain_ms", "bound_ms", "bound_by")},
                        library_ms=None, ms_hd=st[(1080, 1920, "420")]["ms"],
                        plain_ms_hd=st[(1080, 1920, "420")]["plain_ms"],
                        bound_ms_hd=st[(1080, 1920, "420")]["bound_ms"],
                        ms_422=st[(512, 512, "422")]["ms"],
                        bound_ms_422=st[(512, 512, "422")]["bound_ms"],
                        ms_hd_422=st[(1080, 1920, "422")]["ms"],
                        bound_ms_hd_422=st[(1080, 1920, "422")]["bound_ms"],
                        runs_on="card"))
    for k in kernels:   # the MJPEG .avi demo (phase 22d): as the demo on PNG frames
        if k["name"] in con["demo"]:
            k["launches_demo_mjpeg"] = con["demo"][k["name"]]
    log(f"total seconds {time.perf_counter() - t_all:.2f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
