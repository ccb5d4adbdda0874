#!/usr/bin/env python3
"""Where the staged volume lookups K9 and K6 spend their time, on one card.

Builds variants of this checkout's kernels with nvcc (into
``mft_tpu_torch/ops/_build/lookup_probe/``), each with a part taken out:

- K9 ``mft_corr_lookup_t`` (``corr_volume.cu``, ``lane_group_kernel``):
  'no sampling' stages each (group, level) union box and writes the output
  tile unsampled; 'no staging' samples shared memory that nothing copied
  into (the levels read per pixel still read device memory);
- K6 ``mft_corr_lookup_q`` (``corr_gather.cu`` on ``corr_gather.cuh``):
  'no multiply' stages the int8 taps as float(q), without the scale.

The variants' outputs are wrong by design: only their times are read. At
the 512x512 slice's shapes on chip_smoke.py's inputs (K9 in bfloat16 and
float32, K6 on the int8 quantization of a bfloat16 pyramid; local and
uniform coordinates), each variant and the whole kernel are timed by CUDA
graph replay in the order whole, variant, variant, whole.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_lookup_probe.py
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CSRC = os.path.join(REPO, "mft_tpu_torch", "ops", "csrc")
OUT = os.path.join(REPO, "mft_tpu_torch", "ops", "_build", "lookup_probe")


def replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor not found once in the source: {old!r}")
    return src.replace(old, new)


def variants() -> dict:
    """{name: (entry point, {file name: source})}, each built on its own."""
    read = lambda name: open(os.path.join(CSRC, name)).read()
    volume, gather, header = read("corr_volume.cu"), read("corr_gather.cu"), read("corr_gather.cuh")
    sampling = "      if (mine) {\n        const int h = lay.h[l], w = lay.w[l];"
    no_sampling = replace(volume, sampling, sampling.replace("(mine)", "(mine && false)"))
    no_staging = replace(volume, "  if (staged(0)) stage_union", "  if (false) stage_union")
    no_staging = replace(no_staging, "      if (l + 1 < kMaxLevels && l + 1 < L && staged(l + 1))",
                         "      if (false)")
    no_multiply = replace(header, "        return sizeof(T) == 1 ? v * sc : v;",
                          "        return v;")
    t, q = "mft_corr_lookup_t", "mft_corr_lookup_q"
    return {"K9 whole": (t, {"corr_volume.cu": volume}),
            "K9 no sampling": (t, {"corr_volume.cu": no_sampling}),
            "K9 no staging": (t, {"corr_volume.cu": no_staging}),
            "K6 whole": (q, {"corr_gather.cu": gather, "corr_gather.cuh": header}),
            "K6 no multiply": (q, {"corr_gather.cu": gather, "corr_gather.cuh": no_multiply})}


def build(nvcc, flags, signatures) -> dict:
    """{name: the variant's entry point}, all variants compiled at once."""
    procs = {}
    for k, (name, (entry, files)) in enumerate(variants().items()):
        d = os.path.join(OUT, str(k))
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        cu = os.path.join(d, next(f for f in files if f.endswith(".cu")))
        so = os.path.join(d, "probe.so")
        # the directory's own copy of corr_gather.cuh comes before -I's
        procs[name] = (entry, so, subprocess.Popen(
            [nvcc, *flags, "-I", CSRC, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (entry, so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-4000:]}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = signatures[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("torch_lookup_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    from chip_smoke import B, LEVELS, P, RADIUS, card_line, graph_ms, lookup_coords
    from mft_tpu_torch.models.raft import corr as tcorr
    from mft_tpu_torch.ops import _build
    card = card_line()
    print(card, flush=True)
    fns = build(_build.find_nvcc(), _build.NVCC_FLAGS, _build.SIGNATURES)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("local", "uniform")}
    hw = [v for d in LEVELS for v in d]
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def report(what, whole, variant, call):
        ms = {whole: [], variant: []}
        for name in (whole, variant, variant, whole):
            ms[name].append(graph_ms(lambda: call(fns[name])))
        a, b = (sum(ms[k]) / 2 for k in (whole, variant))
        print(f"{what}: {whole} {a:.4f} ms, {variant} {b:.4f} ms (graph replay) [{card}]",
              flush=True)

    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        name = str(dtype).split(".")[1]
        levels = [torch.randn((B, h, w, P), device=dev, generator=gen).to(dtype)
                  for h, w in LEVELS]
        out = torch.empty((B, P, len(LEVELS) * (2 * RADIUS + 1) ** 2), dtype=dtype, device=dev)
        for kind, c in coords.items():
            call = lambda fn: fn(out.data_ptr(), c.data_ptr(), *[t.data_ptr() for t in levels],
                                 *hw, len(LEVELS), B, P, RADIUS, code, stream())
            for variant in ("K9 no sampling", "K9 no staging"):
                report(f"K9 {name} {kind}", "K9 whole", variant, call)
        del levels, out
    pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(torch.bfloat16)
           for h, w in LEVELS]
    levels, scales = tcorr.quantize_pyramid(pyr)
    del pyr
    out = torch.empty((B, P, len(LEVELS) * (2 * RADIUS + 1) ** 2), dtype=torch.bfloat16,
                      device=dev)
    for kind, c in coords.items():
        call = lambda fn: fn(out.data_ptr(), c.data_ptr(), scales.data_ptr(),
                             *[t.data_ptr() for t in levels], *hw, len(LEVELS), B, P, RADIUS,
                             stream())
        report(f"K6 int8 of bfloat16 {kind}", "K6 whole", "K6 no multiply", call)
    return 0


if __name__ == "__main__":
    sys.exit(main())
