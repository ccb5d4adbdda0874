#!/usr/bin/env python3
"""What the bf16 fused lookup K1's rounding repair costs, and the room its window has, on one card.

K1 in bfloat16 (``mft_tpu_torch/ops/csrc/corr_lookup.cu``,
``mft_corr_lookup_conv_tc``) sums on the tensor cores, then recomputes in
the plain version's sequential order every output within
e = 2^-20 ||a_p|| max_f ||w_f|| of a bf16 rounding boundary. This tool
builds two variants of this checkout's ``corr_lookup.cu`` with nvcc (into
``mft_tpu_torch/ops/_build/k1_repair/``):

- 'hooked': the kernel as it is, plus a hook that records each output's
  float32 value before its rounding and counts the outputs recomputed;
- 'no repair': the window test switched off, the tensor cores' sums alone;

then, at the 512x512 slice's shapes on chip_smoke.py's K1 inputs (uniform
and local coordinates, ``--seeds`` draws of each), prints:

- the share of outputs that the repair recomputes;
- the largest |tensor-core sum - plain sum| / (||a_p|| max_f ||w_f||), as a
  power of two: the window 2^-20 stands that far above it;
- the outputs that differ from the plain version's, with and without the
  repair;
- the time of one call (CUDA graph replay) of the kernel through
  ``ops.corr_lookup_fused`` and of the variant without the repair.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_k1_repair.py [--seeds 2]
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
OUT = os.path.join(REPO, "mft_tpu_torch", "ops", "_build", "k1_repair")

INCLUDE = '#include "tensor_core.cuh"\n'
TEST = "          if (acc_row(i) < rows) near |= pair << i;\n"
LISTED = "    const int listed = min(st.listed, list_cap);\n"
HOOK = """__device__ float* g_values;
__device__ unsigned long long g_listed;
"""
RECORD = """          if (g_values != nullptr && acc_row(i) < rows) {
            g_values[(p0 + acc_row(i)) * F + col] = acc[i];
            g_values[(p0 + acc_row(i)) * F + col + 1] = acc[i + 1];
          }
"""
COUNT = "    if (g_values != nullptr && tid == 0) atomicAdd(&g_listed, (unsigned long long)listed);\n"
ACCESS = """
extern "C" int k1_hook(float* values) {
  unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyToSymbol(g_values, &values, sizeof(values));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_listed, &zero, sizeof(zero));
  return (int)err;
}
extern "C" unsigned long long k1_listed() {
  unsigned long long n = 0;
  cudaMemcpyFromSymbol(&n, g_listed, sizeof(n));
  return n;
}
"""


def variants(src: str) -> dict:
    """The two variants' sources."""
    for part in (INCLUDE, TEST, LISTED):
        if src.count(part) != 1:
            raise RuntimeError(f"corr_lookup.cu changed: {part.strip()!r} not found once")
    hooked = (src.replace(INCLUDE, INCLUDE + HOOK).replace(TEST, TEST + RECORD)
              .replace(LISTED, LISTED + COUNT) + ACCESS)
    return {"hooked": hooked, "no repair": src.replace(TEST, "          (void)pair;\n")}


def build(_build) -> dict:
    """The variants' libraries, compiled together with the port's flags."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in variants(open(os.path.join(CSRC, "corr_lookup.cu")).read()).items():
        stem = os.path.join(OUT, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
               stem + ".so", stem + ".cu"]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), stem)
    libs = {}
    for name, (proc, stem) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for '{name}':\n{log}")
        lib = ctypes.CDLL(stem + ".so")
        lib.mft_corr_lookup_conv_tc.argtypes = _build.SIGNATURES["mft_corr_lookup_conv_tc"]
        libs[name] = lib
    libs["hooked"].k1_hook.argtypes = [ctypes.c_void_p]
    libs["hooked"].k1_listed.restype = ctypes.c_ulonglong
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2, help="draws of K1's inputs")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_repair: needs an NVIDIA card", file=sys.stderr)
        return 2
    from chip_smoke import B, F, LEVELS, P, RADIUS, card_line, graph_ms, lookup_coords
    from mft_tpu_torch import ops
    from mft_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    libs = build(_build)
    dev = torch.device("cuda")
    hw = [v for d in LEVELS for v in d]
    C = len(LEVELS) * (2 * RADIUS + 1) ** 2
    worst = 0.0
    for seed in range(args.seeds):
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(torch.bfloat16)
               for h, w in LEVELS]
        wt = (torch.randn((F, C), device=dev, generator=gen) / 18.0).to(torch.bfloat16)
        bias = 0.1 * torch.randn((F,), device=dev, generator=gen)
        wmax = float(wt.float().norm(dim=1).max())
        for kind in ("uniform", "local"):
            c = lookup_coords(torch, dev, kind, gen)

            def call(lib, out):
                err = lib.mft_corr_lookup_conv_tc(
                    out.data_ptr(), c.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                    *[t.data_ptr() for t in pyr], *hw, len(LEVELS), B * P, RADIUS, F,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"mft_corr_lookup_conv_tc: cudaError {err}")

            want = ops.corr_lookup_fused_ref(pyr, c, wt.t(), bias, RADIUS)
            samples = ops.corr_lookup_ref(pyr, c, RADIUS).float().reshape(B * P, C)
            plain = torch.matmul(samples, wt.float().t()) + bias   # cuBLAS: the plain order
            values = torch.zeros((B * P, F), device=dev)
            out = {k: torch.empty((B, P, F), dtype=torch.bfloat16, device=dev) for k in libs}
            hooked = libs["hooked"]
            if hooked.k1_hook(values.data_ptr()) != 0:
                raise RuntimeError("k1_hook failed")
            call(hooked, out["hooked"])
            call(libs["no repair"], out["no repair"])
            torch.cuda.synchronize()
            listed = hooked.k1_listed()
            hooked.k1_hook(None)
            gap = ((values - plain).abs() / (samples.norm(dim=1, keepdim=True) * wmax)).max()
            worst = max(worst, float(gap))
            differ = {k: int((o != want).sum()) for k, o in out.items()}
            ms = graph_ms(lambda: ops.corr_lookup_fused(pyr, c, wt.t(), bias, RADIUS))
            ms_bare = graph_ms(lambda: call(libs["no repair"], out["no repair"]))
            print(f"seed {seed} {kind}: recomputed {listed} of {want.numel()} outputs "
                  f"({listed / want.numel():.4%}); largest gap / (||a|| max||w||) "
                  f"2^{math.log2(float(gap)):.2f}; outputs differing from the plain version: "
                  f"{differ['hooked']} with the repair, {differ['no repair']} without; "
                  f"kernel {ms:.4f} ms, without the repair {ms_bare:.4f} ms "
                  f"(graph replay) [{card}]", flush=True)
    print(f"largest gap over all draws: 2^{math.log2(worst):.2f}, window 2^-20", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
