#!/usr/bin/env python3
"""Where the bf16 K4/K5 kernel spends its time, and the room its rounding repair has, on one card.

K4 and K5 in bfloat16 (``mft_tpu_torch/ops/csrc/corr_alt.cu``,
``window_tc_kernel``) compute each tap dot on the tensor cores, then
recompute in the plain version's tree order the taps of every sample within
e = 2^-21 * scale * ||f1_p|| * max_q ||f2_q|| (over the tile's box) of a bf16
rounding boundary. This tool builds two variants of this checkout's
``corr_alt.cu`` with nvcc (into ``mft_tpu_torch/ops/_build/window_probe/``):

- 'probed': the kernel as it is, plus clock64() probes read by thread 0 at
  the phase boundaries of each block, counters of the chunks staged, the
  samples flagged and the taps recomputed, and a hook that records each
  staged tile's tensor-core tap dots before the repair;
- 'no repair': the window test switched off, the tensor cores' samples alone;

then, at the 512x512 slice's shapes on chip_smoke.py's phase 3b inputs
(local and wild coordinates, ``--seeds`` draws of each), prints:

- cycles per block of each phase (the prologue, the box, the sweep over
  the box's chunks with its waits, pass 1, the repair, pass 2), the chunks
  per tile, and the shares of samples flagged and of tap dots recomputed;
- the largest |tensor-core dot - tree-order dot| / (scale ||f1_p|| ||f2_q||)
  over the staged tiles' in-map taps, as a power of two: the window 2^-21
  stands that far above it;
- the outputs that differ from the plain version's, with and without the
  repair;
- the time of one call (CUDA graph replay) through ``ops.corr_lookup_win``
  and of the variant without the repair.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_window_probe.py [--seeds 2]
"""

import argparse
import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CSRC = os.path.join(REPO, "mft_tpu_torch", "ops", "csrc")
OUT = os.path.join(REPO, "mft_tpu_torch", "ops", "_build", "window_probe")

PHASES = ("prologue", "box", "sweep", "pass 1", "repair", "pass 2")
# counters after the phases: sweep waits, chunks, flagged samples, recomputed taps
WAIT, CHUNKS, FLAGGED, MARKED = 6, 7, 8, 9


def probe(k: int) -> str:
    """Thread 0 adds the cycles since its last probe to phase k."""
    return (f"    if (tid == 0) {{ long long _n = clock64(); atomicAdd(&g_probe[{k}], "
            f"(unsigned long long)(_n - _t)); _t = _n; }}\n")


def insert(src: str, anchor: str, code: str, before: bool = True) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"corr_alt.cu has changed: anchor {anchor!r} found "
                           f"{src.count(anchor)} times")
    return src.replace(anchor, code + anchor if before else anchor + code)


def variants(src: str) -> dict:
    """Source text of each variant; the edits touch window_tc_kernel only."""
    cut = src.index("window_tc_kernel(Features f2")
    head, body = src[:cut], src[cut:]
    head = insert(head, '#include "tensor_core.cuh"\n',
                  "__device__ unsigned long long g_probe[16];\n__device__ float* g_dots;\n",
                  before=False)
    tail = ('\nextern "C" int probe_read(unsigned long long* h) {\n'
            "  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n}\n"
            'extern "C" int probe_reset(float* dots) {\n'
            "  unsigned long long z[16] = {};\n"
            "  cudaError_t e = cudaMemcpyToSymbol(g_probe, z, sizeof(z));\n"
            "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_dots, &dots, sizeof(dots));\n"
            "  return (int)e;\n}\n")
    b = body
    b = insert(b, "  // A: the tile's f1 rows; zeros past C",
               "  long long _t = clock64();\n  unsigned long long _f = 0;\n")
    b = insert(b, "  const uint32_t a0 = smem_u32(a_s);\n", probe(0), before=False)
    b = insert(b, "    if (stats != nullptr && tid == 0) atomicAdd(&stats[staged ? 0 : 1], 1);\n",
               probe(1), before=False)
    b = insert(b, "      const int nchunks = (nbox + kChunk - 1) / kChunk;\n",
               f"      if (tid == 0) atomicAdd(&g_probe[{CHUNKS}], (unsigned long long)nchunks);\n",
               before=False)
    wait = "        cp_async_wait_group<kStages - 2>();   // this thread's part of chunk j\n"
    b = insert(b, wait, "        long long _w = clock64();\n")
    arrived = ("        __syncthreads();   // chunk j is in; every thread is done with chunk "
               "j - 1\n")
    b = insert(b, arrived, f"        if (tid == 0) atomicAdd(&g_probe[{WAIT}], "
               "(unsigned long long)(clock64() - _w));\n", before=False)
    b = insert(b, "      __syncthreads();   // every dot is in; the ring is free\n",
               "      if (g_dots != nullptr)\n"
               "        for (int e = tid; e < kTileP * kMaxTaps; e += kThreads)\n"
               "          g_dots[((long)blockIdx.x * L + l) * (kTileP * kMaxTaps) + e] =\n"
               "              sdots[e];\n",
               before=False)
    b = insert(b, "    // pass 1, a warp per row of the tile", probe(2))
    b = insert(b, "        if (lane == 0) {\n          s_flag[pl][s] = fb;\n",
               "          _f += __popc(fb);\n", before=False)
    b = insert(b, "    // the repair: the marked taps as a list in box order", probe(3))
    b = insert(b, "      const int count = s_count;\n",
               f"      if (tid == 0) atomicAdd(&g_probe[{MARKED}], (unsigned long long)count);\n",
               before=False)
    b = insert(b, "    // pass 2: the flagged samples from the repaired dots", probe(4))
    end = "\n  }\n}\n\nFeatures make_features"
    b = insert(b, end, "\n" + probe(5))
    b = b.replace(end, "\n  }\n  if (lane == 0) atomicAdd(&g_probe[%d], _f);\n}\n\nFeatures "
                  "make_features" % FLAGGED)
    test = "flagged = nbox > 0 && in_map != 0u &&"
    insert(src, test, "")   # the window test is there, once
    return {"probed": head + b + tail, "no_repair": src.replace(test, "flagged = false &&")}


def build(nvcc, flags, sources: dict) -> dict:
    """One shared library per variant, built in parallel."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, code in sources.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(code)
        so = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (subprocess.Popen([nvcc, *flags, "-I", CSRC, "-shared", "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (p, so) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-4000:]}")
        libs[name] = ctypes.CDLL(so)
    return libs


def tree_gaps(torch, dots, f1, pyr, coords, H8, W8, B, radius, scale):
    """Largest |tensor-core dot - tree dot| / (scale ||f1_p|| ||f2_q||) over
    the in-map taps of the staged (tile, level) pairs in ``dots`` (blocks,
    levels, 64 pixels, 100 slots; NaN where not staged)."""
    from mft_tpu_torch.ops.corr_alt import _tree_dots
    side = 2 * radius + 2
    C = f1.shape[-1]
    # dots[(b, ty, tx), l, (dy, dx), slot] -> [(b, y, x), l, slot]
    d = dots.view(B, H8 // 8, W8 // 8, len(pyr), 8, 8, side * side)
    d = d.permute(0, 1, 4, 2, 5, 3, 6).reshape(B * H8 * W8, len(pyr), side * side)
    f1r, cr = f1.reshape(-1, C), coords.reshape(-1, 2)
    worst = 0.0
    for lvl, f2 in enumerate(pyr):
        h, w = f2.shape[1:3]
        c = cr / 2.0 ** lvl
        taps = torch.arange(side, device=f1.device) - radius
        xs = torch.floor(c[:, 0]).long()[:, None] + taps
        ys = torch.floor(c[:, 1]).long()[:, None] + taps
        valid = (((xs >= 0) & (xs < w))[:, :, None]
                 & ((ys >= 0) & (ys < h))[:, None, :]).reshape(-1, side * side)
        pix = torch.arange(len(cr), device=f1.device)
        idx = ((pix // (H8 * W8))[:, None, None] * (h * w) + ys.clamp(0, h - 1)[:, None, :] * w
               + xs.clamp(0, w - 1)[:, :, None]).reshape(len(cr), -1)
        rows = torch.nonzero(~torch.isnan(d[:, lvl, 0])).squeeze(1)
        for s in range(0, len(rows), 2048):
            r = rows[s:s + 2048]
            g = f2.reshape(-1, C)[idx[r]]
            tree = _tree_dots(g, f1r[r]) * scale
            norm = scale * f1r[r].float().norm(dim=1)[:, None] * g.float().norm(dim=2)
            ok = valid[r]
            gap = (d[r, lvl] - tree).abs()[ok] / norm[ok].clamp_min(1e-30)
            if gap.numel():
                worst = max(worst, float(gap.max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2, help="draws of each coordinate kind")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("torch_window_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    from chip_smoke import B, LEVELS, RADIUS, card_line, feature_inputs, graph_ms
    from mft_tpu_torch import ops
    from mft_tpu_torch.ops import _build
    from mft_tpu_torch.ops.product import corr_scale

    card = card_line()
    print(card, flush=True)
    with open(os.path.join(CSRC, "corr_alt.cu")) as f:
        libs = build(_build.find_nvcc(), _build.NVCC_FLAGS, variants(f.read()))
    for lib in libs.values():
        lib.mft_corr_win.argtypes = _build.SIGNATURES["mft_corr_win"]
        lib.mft_corr_win.restype = ctypes.c_int
    probed = libs["probed"]
    probed.probe_read.argtypes = [ctypes.c_void_p]
    probed.probe_reset.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    H8, W8 = LEVELS[0]
    C = 256
    scale = corr_scale(C)
    tiles = B * (H8 // 8) * (W8 // 8)
    for kind in ("local", "wild"):
        for seed in range(3, 3 + args.seeds):
            f1, pyr, coords = feature_inputs(torch, dev, torch.bfloat16, kind, H8, W8, seed=seed)
            args_ = (f1.data_ptr(), coords.data_ptr(), *[t.data_ptr() for t in pyr],
                     *[v for t in pyr for v in t.shape[1:3]], len(pyr), B, H8, W8, C, RADIUS,
                     scale, 1)
            want = ops.corr_lookup_alt_ref(f1, pyr, coords, RADIUS)
            outs = {}
            dots = torch.full((tiles, len(pyr), 64, (2 * RADIUS + 2) ** 2), float("nan"),
                              device=dev)
            for name, lib in libs.items():
                out = torch.empty_like(want)
                if name == "probed" and probed.probe_reset(dots.data_ptr()) != 0:
                    raise RuntimeError("probe_reset failed")
                err = lib.mft_corr_win(out.data_ptr(), *args_, None,
                                       torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: cudaError {err}")
                torch.cuda.synchronize()
                outs[name] = out
            h = (ctypes.c_ulonglong * 16)()
            if probed.probe_read(h) != 0:
                raise RuntimeError("probe_read failed")
            differ = {k: int((o.view(torch.int16) != want.view(torch.int16)).sum())
                      for k, o in outs.items()}
            worst = tree_gaps(torch, dots, f1, pyr, coords, H8, W8, B, RADIUS, scale)
            ms = graph_ms(lambda: ops.corr_lookup_win(f1, pyr, coords, RADIUS))
            nr_out = outs["no_repair"]
            ms_nr = graph_ms(lambda: libs["no_repair"].mft_corr_win(
                nr_out.data_ptr(), *args_, None, torch.cuda.current_stream().cuda_stream))
            print(f"{kind} seed {seed}: cycles per block "
                  + ", ".join(f"{p} {h[i] / tiles:.0f}" for i, p in enumerate(PHASES))
                  + f" (sweep waits {h[WAIT] / tiles:.0f}); chunks per tile "
                  f"{h[CHUNKS] / tiles:.1f}", flush=True)
            print(f"  samples flagged {h[FLAGGED] / want.numel():.3%}, tap dots recomputed "
                  f"{h[MARKED] / (tiles * len(pyr) * 64 * (2 * RADIUS + 2) ** 2):.3%}; "
                  f"largest |tensor-core dot - tree dot| / (scale ||f1|| ||f2||) = "
                  f"2^{math.log2(worst) if worst > 0 else float('-inf'):.2f}", flush=True)
            print(f"  outputs differing from the plain version: {differ['probed']} with the "
                  f"repair, {differ['no_repair']} without; kernel {ms:.4f} ms, without the "
                  f"repair {ms_nr:.4f} ms (graph replay) [{card}]", flush=True)
            del f1, pyr, coords, want, outs, dots
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
