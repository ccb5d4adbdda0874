#!/usr/bin/env python3
"""Where the lookups K9 and K6 and the lookup's backward spend their time, on one card.

Builds variants of this checkout's kernels with nvcc (into
``mft_tpu_torch/ops/_build/lookup_probe/``), each with a part taken out:

- K9 ``mft_corr_lookup_t`` (``corr_volume.cu``, ``lane_group_kernel``):
  'no sampling' stages each (group, level) union box and writes the output
  tile unsampled; 'no staging' samples shared memory that nothing copied
  into (the levels read per pixel still read device memory);
- K6 ``mft_corr_lookup_q`` (``corr_gather.cu`` on ``corr_gather.cuh``):
  'no multiply' stages the int8 taps as float(q), without the scale;
- the backward ``mft_corr_lookup_bwd`` (``corr_lookup_bwd.cu``): 'no box
  values' reads the group's g, weights and origins but computes no box
  values (box chunks read shared memory that nothing wrote); 'zeros' also
  writes zeros where a chunk meets a box; 'walk alone' reads nothing either
  (the walk and its stores alone); 'per chunk' reads no g into shared
  memory and computes each box value from g and the coords where a chunk
  meets the box, in the store loop (the design that stages no box values).
  Beside them, ``Tensor.zero_()`` of the same level maps: the card's own
  write rate for the bytes the backward must store.

The variants' outputs are wrong by design ('per chunk' excepted: its bits
are checked against the whole kernel's): only their times are read. At the
512x512 slice's shapes on chip_smoke.py's inputs (K9 in bfloat16 and
float32, K6 on the int8 quantization of a bfloat16 pyramid; local and
uniform coordinates) and, for the backward, at chip_smoke.py's training
shape (``BWD_SHAPES['train']``) in both dtypes and coordinate kinds, each
variant and the whole kernel are timed by CUDA graph replay in the order
whole, variant, variant, whole.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_lookup_probe.py [--only k9|k6|backward ...]
"""

import argparse
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
    bwd = read("corr_lookup_bwd.cu")
    no_boxes = replace(bwd, "    if (p >= np) continue;\n", "    if (true) continue;\n")
    zeros = replace(no_boxes, "if ((unsigned)b < (unsigned)side && a > -kChunk && a < side) {",
                    "if (false) {")
    no_g = ("    if (k < gn) sg[k] = gg[k];", "    if (false) sg[k] = gg[k];")
    walk = replace(replace(zeros, *no_g),
                   "  if (tid < num_levels * kGroup && tid % kGroup < np) {", "  if (false) {")
    per_chunk = replace(replace(no_boxes, *no_g), "template <typename T, int R>\n__global__",
                        BOX_DIRECT + "template <typename T, int R>\n__global__")
    per_chunk = replace(per_chunk, "? row[a + k] : Bits(0);",
                        "? box_direct<T, R>(g, coords, bp0 + p, l, num_levels, a + k, b)"
                        " : Bits(0);")
    per_chunk = replace(per_chunk, "              val = boxes[pk * box + b * side + a];",
                        "              val = box_direct<T, R>(g, coords, bp0 + pk, l, "
                        "num_levels, a, b);")
    t, q, d = "mft_corr_lookup_t", "mft_corr_lookup_q", "mft_corr_lookup_bwd"
    return {"K9 whole": (t, {"corr_volume.cu": volume}),
            "K9 no sampling": (t, {"corr_volume.cu": no_sampling}),
            "K9 no staging": (t, {"corr_volume.cu": no_staging}),
            "K6 whole": (q, {"corr_gather.cu": gather, "corr_gather.cuh": header}),
            "K6 no multiply": (q, {"corr_gather.cu": gather, "corr_gather.cuh": no_multiply}),
            "backward whole": (d, {"corr_lookup_bwd.cu": bwd}),
            "backward no box values": (d, {"corr_lookup_bwd.cu": no_boxes}),
            "backward zeros": (d, {"corr_lookup_bwd.cu": zeros}),
            "backward walk alone": (d, {"corr_lookup_bwd.cu": walk}),
            "backward per chunk": (d, {"corr_lookup_bwd.cu": per_chunk})}


# the 'per chunk' variant's box value: the kernel's arithmetic for one
# (pixel, level, a, b), from g and the coords through L1
BOX_DIRECT = """
template <typename T, int R>
__device__ __forceinline__ typename Word<T>::type box_direct(
    const T* __restrict__ g, const float* __restrict__ coords, long bp, int l,
    int num_levels, int a, int b) {
  constexpr int n = 2 * R + 1, nn = n * n;
  const float scale = __int_as_float((127 - l) << 23);
  const float cx = __fmul_rn(coords[2 * bp], scale);
  const float cy = __fmul_rn(coords[2 * bp + 1], scale);
  const float fx = floorf(cx), fy = floorf(cy);
  const float wx = __fsub_rn(cx, fx), wy = __fsub_rn(cy, fy);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  const auto* gl = reinterpret_cast<const typename Word<T>::type*>(g) +
                   bp * (long)(num_levels * nn) + l * nn;
  const bool a0 = a < n, a1 = a >= 1, b0 = b < n, b1 = b >= 1;
  const float g00 = (a0 && b0) ? to_float(gl[a * n + b]) : 0.f;
  const float g10 = (a1 && b0) ? to_float(gl[(a - 1) * n + b]) : 0.f;
  const float g01 = (a0 && b1) ? to_float(gl[a * n + b - 1]) : 0.f;
  const float g11 = (a1 && b1) ? to_float(gl[(a - 1) * n + b - 1]) : 0.f;
  float acc = 0.f;
  acc = __fadd_rn(acc, __fmul_rn(g00, __fmul_rn(ux, uy)));
  acc = __fadd_rn(acc, __fmul_rn(g10, __fmul_rn(wx, uy)));
  acc = __fadd_rn(acc, __fmul_rn(g01, __fmul_rn(ux, wy)));
  acc = __fadd_rn(acc, __fmul_rn(g11, __fmul_rn(wx, wy)));
  return to_bits(acc, (T*)nullptr);
}

"""


def build(nvcc, flags, signatures, groups) -> dict:
    """{name: the variant's entry point} of ``groups``, all compiled at once."""
    procs = {}
    for k, (name, (entry, files)) in enumerate(variants().items()):
        if GROUP_OF[name.split()[0]] not in groups:
            continue
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


GROUP_OF = {"K9": "k9", "K6": "k6", "backward": "backward"}


def probe_backward(torch, fns, dev, report, stream, card):
    """The backward's variants at the training shape, both dtypes and
    coordinate kinds; the 'per chunk' variant's bits against the whole
    kernel's; ``zero_()`` of the same maps."""
    from chip_smoke import BWD_SHAPES, LEVELS, RADIUS, bwd_coords, graph_ms
    Bn, H8, W8 = BWD_SHAPES["train"]
    dims = [(H8 >> lvl, W8 >> lvl) for lvl in range(len(LEVELS))]
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 2 * RADIUS + 1
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        name = str(dtype).split(".")[1]
        outs = [torch.empty((Bn, H8 * W8, h, w), dtype=dtype, device=dev) for h, w in dims]
        for kind in ("uniform", "local"):
            c = bwd_coords(torch, dev, kind, gen, Bn, H8, W8)
            g = torch.randn((Bn, H8 * W8, len(dims) * n * n), device=dev,
                            generator=gen).to(dtype)

            def call(fn, outs=outs, g=g, c=c):
                err = fn(*[o.data_ptr() for o in outs], g.data_ptr(), c.data_ptr(),
                         *(v for d in dims for v in d), len(dims), Bn * H8 * W8, RADIUS, code,
                         stream())
                if err != 0:
                    raise RuntimeError(f"mft_corr_lookup_bwd variant: cudaError {err}")

            call(fns["backward whole"])
            want = [o.clone() for o in outs]
            call(fns["backward per chunk"])
            same = all(torch.equal(a, b) for a, b in zip(outs, want))
            print(f"backward per chunk {name} {kind}: bits "
                  f"{'identical to' if same else 'DIFFER from'} the whole kernel's", flush=True)
            del want
            for variant in ("backward no box values", "backward zeros", "backward walk alone",
                            "backward per chunk"):
                report(f"backward {name} {kind} ({Bn} x {H8}x{W8})", "backward whole",
                       variant, call)
            del g
        zero_ms = graph_ms(lambda: [o.zero_() for o in outs])
        nbytes = sum(o.numel() for o in outs) * outs[0].element_size()
        print(f"backward {name}: zero_() of the 4 maps {zero_ms:.4f} ms, "
              f"{nbytes / zero_ms / 1e9:.3f} TB/s ({nbytes / 1e6:.1f} MB) [{card}]", flush=True)
        del outs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", choices=sorted(set(GROUP_OF.values())),
                    help="a kernel to probe (repeatable; default all)")
    groups = ap.parse_args(argv).only or sorted(set(GROUP_OF.values()))
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
    fns = build(_build.find_nvcc(), _build.NVCC_FLAGS, _build.SIGNATURES, groups)
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

    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)) if "k9" in groups else ():
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
    if "backward" in groups:
        probe_backward(torch, fns, dev, report, stream, card)
    if "k6" not in groups:
        return 0
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
