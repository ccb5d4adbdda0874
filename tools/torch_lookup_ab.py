#!/usr/bin/env python3
"""The dense window lookups of two checkouts of the port, side by side on one card.

Builds the kernel library of this checkout and of ``--other`` (each with its
own ``mft_tpu_torch/ops/_build.py``, into its own build directory), then, at
the 512x512 slice's shapes (7 pairs, 4096 pixels, levels 64^2..8^2, radius
4), in float32 and bfloat16, on uniform coordinates (some windows leave the
maps) and on local ones (the pixel grid + U(-2, 2)):

- calls ``mft_corr_lookup`` (K2), ``mft_corr_lookup_mixed`` (#9, on the same
  dense levels) and ``mft_corr_lookup_conv`` (K1) of both libraries on the
  same inputs and requires identical bits between them;
- times each by CUDA graph replay, in the order other, this, this, other,
  and prints both checkouts' times and their ratio.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_lookup_ab.py --other PATH_TO_OTHER_CHECKOUT
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def load_build(root: str, name: str):
    """The ``_build`` module of the checkout at ``root``, under ``name``."""
    path = os.path.join(root, "mft_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("torch_lookup_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    from chip_smoke import B, F, LEVELS, P, RADIUS, card_line, graph_ms, lookup_coords
    card = card_line()
    print(card, flush=True)
    libs = {}
    for label, root in (("other", os.path.abspath(args.other)), ("this", REPO)):
        mod = load_build(root, f"_build_{label}")
        libs[label] = mod.library()
        print(f"{label}: {root}, built in {mod.build_seconds:.2f} s", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("uniform", "local")}
    wc32 = torch.randn((len(LEVELS) * (2 * RADIUS + 1) ** 2, F), device=dev,
                       generator=gen) / 18.0
    bias = 0.1 * torch.randn((F,), device=dev, generator=gen)
    stream = torch.cuda.current_stream
    C = len(LEVELS) * (2 * RADIUS + 1) ** 2
    hw = [v for d in LEVELS for v in d]
    failed = False
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(dtype)
               for h, w in LEVELS]
        ptrs = [t.data_ptr() for t in pyr]
        wc = wc32.to(dtype)
        for kind, c in coords.items():
            outs = {}

            def call(label, kernel, out):
                lib = libs[label]
                s = stream().cuda_stream
                if kernel == "mft_corr_lookup":
                    err = lib.mft_corr_lookup(out.data_ptr(), c.data_ptr(), *ptrs, *hw, 4,
                                              B * P, RADIUS, code, s)
                elif kernel == "mft_corr_lookup_mixed":
                    err = lib.mft_corr_lookup_mixed(out.data_ptr(), c.data_ptr(), *ptrs, *hw,
                                                    4, B, P, RADIUS, code, s)
                else:
                    err = lib.mft_corr_lookup_conv(out.data_ptr(), c.data_ptr(),
                                                   wc.data_ptr(), bias.data_ptr(), *ptrs,
                                                   *hw, 4, B * P, RADIUS, F, code, s)
                if err != 0:
                    raise RuntimeError(f"{label} {kernel}: cudaError {err}")

            for kernel in ("mft_corr_lookup", "mft_corr_lookup_mixed", "mft_corr_lookup_conv"):
                width = F if kernel == "mft_corr_lookup_conv" else C
                for label in ("other", "this"):
                    outs[label] = torch.empty((B, P, width), dtype=dtype, device=dev)
                    call(label, kernel, outs[label])
                torch.cuda.synchronize()
                same = torch.equal(outs["other"].view(torch.int16 if code else torch.int32),
                                   outs["this"].view(torch.int16 if code else torch.int32))
                failed |= not same
                ms = {"other": [], "this": []}
                for label in ("other", "this", "this", "other"):
                    out = outs[label]
                    ms[label].append(graph_ms(lambda: call(label, kernel, out)))
                other, this = (sum(ms[k]) / 2 for k in ("other", "this"))
                print(f"{kernel} {str(dtype).split('.')[1]} {kind}: other {other:.4f} ms "
                      f"({ms['other'][0]:.4f}, {ms['other'][1]:.4f}), this {this:.4f} ms "
                      f"({ms['this'][0]:.4f}, {ms['this'][1]:.4f}), this/other "
                      f"{this / other:.3f}; bits {'identical' if same else 'DIFFER'} "
                      f"[{card}]", flush=True)
        del pyr
    print("ok" if not failed else "FAILED: outputs differ between the checkouts")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
