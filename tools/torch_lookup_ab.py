#!/usr/bin/env python3
"""The window lookups and the warp of two checkouts of the port, side by side on one card.

Builds the kernel library of this checkout and of ``--other`` (each with its
own ``mft_tpu_torch/ops/_build.py``, into its own build directory), then,
for the groups ``--only`` names (default: all three):

- at the 512x512 slice's shapes (7 pairs, 4096 pixels, levels 64^2..8^2,
  radius 4), in float32 and bfloat16, on uniform coordinates (some windows
  leave the maps) and on local ones (the pixel grid + U(-2, 2)), calls
  ``mft_corr_lookup`` (K2), ``mft_corr_lookup_mixed`` (#9, on the same dense
  levels) and the fused lookup K1 of both libraries on the same inputs. K2,
  #9 and the float32 K1 must give identical bits; the bfloat16 K1, whose
  sum order may differ between checkouts (a checkout with
  ``mft_corr_lookup_conv_tc`` sums on the tensor cores), must stay within
  ``ops.product_error_bound`` (K = 324) of the other's on every element
  ('dense');
- at chip_smoke.py's ``WARP_SHAPES``, calls ``mft_warp`` of both libraries
  through the arguments of the JAX entry point of each shape and requires
  identical bits ('warp');
- at the 512x512 slice's shapes of chip_smoke.py's phase 3b (7 pairs, 64x64,
  C = 256, 4 levels, radius 4), in float32 and bfloat16, on wild and local
  coordinates, calls the window correlations ``mft_corr_alt`` (K4) and
  ``mft_corr_win`` (K5) of both libraries: float32 must give identical
  bits; bfloat16, which a checkout may sum on the tensor cores, must stay
  within ``ops.product_error_bound`` (K = C, S from
  ``ops.corr_window_magnitude``) of the other's, and the outputs whose bits
  differ are counted ('window');
- at the 512x512 slice's shapes, on uniform and local coordinates, calls
  the lookups of the volume's other stored forms of both libraries on the
  same inputs: ``mft_corr_lookup_q`` (K6) and ``mft_corr_lookup_packed_i8``
  (K8) on the int8 quantization of a bfloat16 pyramid,
  ``mft_corr_lookup_packed`` (K7), ``mft_corr_lookup_t`` (K9) and
  ``mft_corr_lookup_folded`` (#4) in float32 and bfloat16; all must give
  identical bits ('volume'; #4 runs the staged gather since it left
  ``corr_volume.cu``);
- at the 512x512 slice's shapes of chip_smoke.py's phase 3 (7 candidates,
  512x512), calls chain + select ``mft_chain_select`` (K3) of both libraries
  on the uniform, the local, the steady and the NaN maps (``chain_select_inputs``,
  ``chain_select_nan_inputs``) and counts, for each checkout, the outputs
  that differ from the plain version's (NaN positions and bits); this
  checkout must have none ('chain_select');
- at chip_smoke.py's ``BWD_SHAPES`` (the training batch, 6 x 46x96 at
  level 0, and the slice's, 7 x 64x64; 4 levels, radius 4), in float32 and
  bfloat16, on uniform and local coordinates (``bwd_coords``), calls the
  lookup's backward ``mft_corr_lookup_bwd`` of both libraries on the same
  gradient and requires identical bits in every level map ('backward');
- times each by CUDA graph replay, in the order other, this, this, other,
  and prints both checkouts' times and their ratio.

Imports nothing of JAX. Usage (on the card):

    python3 tools/torch_lookup_ab.py --other PATH_TO_OTHER_CHECKOUT
        [--only dense] [--only warp] [--only window] [--only volume]
        [--only chain_select] [--only backward]
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


GROUPS = ("dense", "warp", "window", "volume", "chain_select", "backward")


def load_build(root: str, name: str):
    """The ``_build`` module of the checkout at ``root``, under ``name``."""
    path = os.path.join(root, "mft_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def volume_calls(torch, stored, coords):
    """{entry point: (args before the stream, out shape, out dtype)} of the
    lookups of one stored volume, as the wrappers of ops/corr_lookup.py
    pass them (the same C signatures in both checkouts)."""
    from chip_smoke import RADIUS
    cl = importlib.import_module("mft_tpu_torch.ops.corr_lookup")
    tag, c = stored[0], coords.data_ptr()
    code = {torch.float32: 0, torch.bfloat16: 1}
    if tag == "i8":
        levels, scales = stored[1], stored[2]
        _, B, P, ptrs, hw = cl._check_levels(levels, coords, (torch.int8,))
        return "mft_corr_lookup_q", (c, scales.data_ptr(), *ptrs, *hw, len(levels), B, P,
                                     RADIUS), torch.bfloat16, len(levels)
    if tag == "t":
        dt, B, P, ptrs, hw = cl._check_levels(stored[1], coords, tuple(code), lane_major=True)
        return "mft_corr_lookup_t", (c, *ptrs, *hw, len(stored[1]), B, P, RADIUS,
                                     code[dt]), dt, len(stored[1])
    if tag == "fold":
        levels, dims = stored[1], stored[2]
        dt, B, P, rows, hw = cl._check_folded(levels, dims, coords, tuple(code))
        ptrs = [t.data_ptr() for t in levels]
        return "mft_corr_lookup_folded", (c, *ptrs, *hw, *rows, len(levels), B, P, RADIUS,
                                          code[dt]), dt, len(levels)
    if tag == "packed":
        packed, dims = stored[1], stored[2]
        dt, B, P, H0, Wp, hw = cl._check_packed(packed, dims, coords, tuple(code))
        return "mft_corr_lookup_packed", (c, packed.data_ptr(), H0, Wp, *hw, len(dims), B, P,
                                          RADIUS, code[dt]), dt, len(dims)
    packed, scales, dims = stored[1], stored[2], stored[3]
    _, B, P, H0, Wp, hw = cl._check_packed(packed, dims, coords, (torch.int8,))
    return "mft_corr_lookup_packed_i8", (c, scales.data_ptr(), packed.data_ptr(), H0, Wp, *hw,
                                         len(dims), B, P, RADIUS), torch.bfloat16, len(dims)


def compare_volume(torch, dev, libs, side_by_side, identical) -> bool:
    """The 'volume' group: K6-K9 and #4 of both checkouts on the same stored
    volumes. returns: False if any comparison failed."""
    from chip_smoke import B, FEAT_C, LEVELS, P, RADIUS, lookup_coords, stored_volume
    from mft_tpu_torch.models.raft import corr as tcorr
    gen = torch.Generator(device=dev).manual_seed(14)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("uniform", "local")}
    n = (2 * RADIUS + 1) ** 2
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(dtype)
               for h, w in LEVELS]
        f1 = torch.randn((B, FEAT_C, *LEVELS[0]), device=dev, generator=gen).to(dtype)
        f2 = torch.randn((B, FEAT_C, *LEVELS[0]), device=dev, generator=gen).to(dtype)
        stores = {m: stored_volume(torch, tcorr, m, pyr) for m in ("packed", "pallas_t")}
        if dtype == torch.bfloat16:
            stores.update({m: stored_volume(torch, tcorr, m, pyr) for m in ("int8", "packed_i8")})
        stores["fold"] = ("fold", *tcorr.build_corr_pyramid_folded(f1, f2, len(LEVELS)))
        del f1, f2
        for method, stored in stores.items():
            for kind, c in coords.items():
                entry, args, out_dt, L = volume_calls(torch, stored, c)

                def call(label, out, entry=entry, args=args):
                    err = getattr(libs[label], entry)(
                        out.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{label} {entry}: cudaError {err}")

                outs = {k: torch.empty((B, P, L * n), dtype=out_dt, device=dev)
                        for k in ("other", "this")}
                what = f"{entry} {'int8 of bfloat16' if out_dt != dtype else name} {kind}"
                ok &= side_by_side(what, call, outs, identical)
                del outs
        del pyr, stores
        torch.cuda.empty_cache()
    return ok


def compare_chain_select(torch, dev, libs, side_by_side) -> bool:
    """The 'chain_select' group: K3 of both checkouts on the same candidate
    maps, each against the plain version. returns: False if this checkout's
    outputs differ from the plain version's."""
    from chip_smoke import chain_select_inputs, chain_select_nan_inputs, differing
    from mft_tpu_torch import ops
    ok = True
    for kind in ("uniform", "local", "steady", "nan"):
        maps = (chain_select_nan_inputs(torch, dev) if kind == "nan"
                else chain_select_inputs(torch, dev, kind=kind))
        want = ops.chain_select_ref(*maps)
        valid = maps[6].to(torch.uint8)
        N, H, W = maps[1].shape
        HW = H * W

        def views(buf, H=H, W=W, HW=HW):   # one buffer: flow (H, W, 2), occlusion, sigma
            return (buf[:2 * HW].view(H, W, 2), buf[2 * HW:3 * HW].view(H, W),
                    buf[3 * HW:].view(H, W))

        def call(label, buf, maps=maps, valid=valid, N=N, H=H, W=W):
            flow, occ, sig = views(buf)
            entry = libs[label].mft_chain_select
            # the entry point with a clip count takes one argument more
            clips = (1,) if len(entry.argtypes) == 16 else ()
            err = entry(flow.data_ptr(), occ.data_ptr(), sig.data_ptr(),
                        *(m.data_ptr() for m in maps[:6]), valid.data_ptr(), 0.02, *clips,
                        N, H, W, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{label} mft_chain_select: cudaError {err}")

        def against_plain(a, b, want=want):
            count = lambda buf: sum(differing(torch, g, w)
                                    for g, w in zip(views(buf), want))
            n_other, n_this = count(a), count(b)
            return n_this == 0, (f"outputs differing from the plain version's: other "
                                 f"{n_other}, this {n_this} of {4 * HW}")

        outs = {k: torch.empty(4 * HW, device=dev) for k in ("other", "this")}
        ok &= side_by_side(f"mft_chain_select {kind} (7 candidates, {H}x{W})", call, outs,
                           against_plain)
        del maps, want, outs
    return ok


def compare_backward(torch, dev, libs, side_by_side, identical) -> bool:
    """The 'backward' group: ``mft_corr_lookup_bwd`` of both checkouts on the
    same gradient and coordinates, the 4 level maps in one buffer (each
    level at a 256-byte aligned offset, as the allocator places separate
    tensors; the gaps zero in both). returns: False if any bits differ."""
    from chip_smoke import BWD_SHAPES, LEVELS, RADIUS, bwd_coords
    gen = torch.Generator(device=dev).manual_seed(21)
    n = 2 * RADIUS + 1
    ok = True
    for label, (Bn, H8, W8) in BWD_SHAPES.items():
        dims = [(H8 >> lvl, W8 >> lvl) for lvl in range(len(LEVELS))]
        sizes = [Bn * H8 * W8 * h * w for h, w in dims]
        for kind in ("uniform", "local"):
            coords = bwd_coords(torch, dev, kind, gen, Bn, H8, W8)
            for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
                g = torch.randn((Bn, H8 * W8, len(dims) * n * n), device=dev,
                                generator=gen).to(dtype)
                step = 256 // g.element_size()
                offsets = [sum(-(-v // step) * step for v in sizes[:k])
                           for k in range(len(sizes) + 1)]

                def call(lib_label, buf, g=g, coords=coords, dims=dims, code=code,
                         offsets=offsets):
                    ptrs = [buf[o:].data_ptr() for o in offsets[:-1]]
                    err = libs[lib_label].mft_corr_lookup_bwd(
                        *ptrs, g.data_ptr(), coords.data_ptr(),
                        *(v for d in dims for v in d), len(dims), Bn * H8 * W8, RADIUS,
                        code, torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{lib_label} mft_corr_lookup_bwd: cudaError {err}")

                outs = {k: torch.zeros(offsets[-1], dtype=dtype, device=dev)
                        for k in ("other", "this")}
                name = str(dtype).split(".")[1]
                ok &= side_by_side(f"mft_corr_lookup_bwd {name} {label} {kind} "
                                   f"({Bn} x {H8}x{W8})", call, outs, identical)
                del g, outs
            torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--only", action="append", choices=GROUPS,
                    help="a group of kernels to compare (repeatable; default all)")
    args = ap.parse_args(argv)
    groups = args.only or GROUPS
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        print("torch_lookup_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    from chip_smoke import (B, F, LEVELS, P, RADIUS, card_line, feature_inputs, graph_ms,
                            lookup_coords, WARP_SHAPES, warp_coords)
    from mft_tpu_torch import ops
    card = card_line()
    print(card, flush=True)
    libs = {}
    for label, root in (("other", os.path.abspath(args.other)), ("this", REPO)):
        mod = load_build(root, f"_build_{label}")
        libs[label] = mod.library()
        print(f"{label}: {root}, built in {mod.build_seconds:.2f} s", flush=True)

    def side_by_side(what, call, outs, compare):
        """Both checkouts' outputs compared, then timed: other, this, this,
        other. returns: False if the comparison failed."""
        for label in ("other", "this"):
            call(label, outs[label])
        torch.cuda.synchronize()
        ok, how = compare(outs["other"], outs["this"])
        ms = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            out = outs[label]
            ms[label].append(graph_ms(lambda: call(label, out)))
        other, this = (sum(ms[k]) / 2 for k in ("other", "this"))
        print(f"{what}: other {other:.4f} ms ({ms['other'][0]:.4f}, {ms['other'][1]:.4f}), "
              f"this {this:.4f} ms ({ms['this'][0]:.4f}, {ms['this'][1]:.4f}), this/other "
              f"{this / other:.3f}; {how} [{card}]", flush=True)
        return ok

    def differing(a, b):
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return int((a.view(ints) != b.view(ints)).sum())

    def identical(a, b):
        n = differing(a, b)
        return n == 0, "bits identical" if n == 0 else f"bits DIFFER in {n} outputs"

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    coords = {kind: lookup_coords(torch, dev, kind, gen) for kind in ("uniform", "local")}
    C = len(LEVELS) * (2 * RADIUS + 1) ** 2
    wt32 = torch.randn((F, C), device=dev, generator=gen) / 18.0   # convc1's (F, C) weight
    bias = 0.1 * torch.randn((F,), device=dev, generator=gen)
    stream = torch.cuda.current_stream
    hw = [v for d in LEVELS for v in d]
    failed = False
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)) if "dense" in groups else ():
        pyr = [torch.randn((B, P, h, w), device=dev, generator=gen).to(dtype)
               for h, w in LEVELS]
        ptrs = [t.data_ptr() for t in pyr]
        wt = wt32.to(dtype)                 # (F, C), the tensor-core kernel's
        wc = wt.t().contiguous()            # (C, F), the CUDA-core kernels'
        for kind, c in coords.items():
            def fused(label, out):
                lib = libs[label]
                s = stream().cuda_stream
                common = (*ptrs, *hw, 4, B * P, RADIUS, F)
                if code == 1:
                    err = lib.mft_corr_lookup_conv_tc(out.data_ptr(), c.data_ptr(),
                                                      wt.data_ptr(), bias.data_ptr(), *common, s)
                else:
                    err = lib.mft_corr_lookup_conv(out.data_ptr(), c.data_ptr(), wc.data_ptr(),
                                                   bias.data_ptr(), *common, s)
                if err != 0:
                    raise RuntimeError(f"{label} fused lookup: cudaError {err}")

            def lookup(kernel):
                def call(label, out):
                    lib = libs[label]
                    s = stream().cuda_stream
                    if kernel == "mft_corr_lookup":
                        err = lib.mft_corr_lookup(out.data_ptr(), c.data_ptr(), *ptrs, *hw, 4,
                                                  B * P, RADIUS, code, s)
                    else:
                        err = lib.mft_corr_lookup_mixed(out.data_ptr(), c.data_ptr(), *ptrs,
                                                        *hw, 4, B, P, RADIUS, code, s)
                    if err != 0:
                        raise RuntimeError(f"{label} {kernel}: cudaError {err}")
                return call

            name = str(dtype).split(".")[1]
            for kernel in ("mft_corr_lookup", "mft_corr_lookup_mixed"):
                outs = {k: torch.empty((B, P, C), dtype=dtype, device=dev)
                        for k in ("other", "this")}
                failed |= not side_by_side(f"{kernel} {name} {kind}", lookup(kernel), outs,
                                           identical)
            outs = {k: torch.empty((B, P, F), dtype=dtype, device=dev) for k in ("other", "this")}
            if code == 1:
                mag = ops.corr_lookup_fused_magnitude(pyr, c, wc, RADIUS)

                def within_bound(a, b):
                    bound = ops.product_error_bound(a, mag, C)
                    diff = (b.float() - a.float()).abs()
                    ratio = float((diff / bound.clamp_min(1e-30)).max())
                    ok = bool((diff <= bound).all())
                    return ok, (f"largest |this - other| / bound {ratio:.4f} "
                                f"{'within' if ok else 'OUTSIDE'} ops.product_error_bound")
                failed |= not side_by_side(f"fused lookup (K1) {name} {kind}", fused, outs,
                                           within_bound)
            else:
                failed |= not side_by_side(f"fused lookup (K1) {name} {kind}", fused, outs,
                                           identical)
        del pyr

    # the warp (#14-#16): mft_warp as each JAX entry point calls it
    wgen = torch.Generator(device=dev).manual_seed(10)
    for label, (entry, mode, N, H, W, Cw) in WARP_SHAPES.items() if "warp" in groups else ():
        dtype = torch.bfloat16 if mode == "tpu" else torch.float32
        maps = (4.0 * torch.randn((N, H, W, Cw), device=dev, generator=wgen)).to(dtype)
        xy = warp_coords(torch, dev, wgen, N, H, W)
        Pw = H * W
        if entry == "bilinear_warp_tiled":   # x and y planes, C output planes
            sx, sy = xy[..., 0].contiguous(), xy[..., 1].contiguous()
            shape, c_strides, o_strides = (Cw, N, Pw), (Pw, 1), (Pw, 1, N * Pw)
        else:
            sx, sy = xy[..., 0], xy[..., 1]
            shape, c_strides, o_strides = (N, Pw, Cw), (2 * Pw, 2), (Pw * Cw, Cw, 1)
        snap, bf16 = ops.warp.MODES[mode]

        def warp(lib_label, out):
            err = libs[lib_label].mft_warp(
                out.data_ptr(), maps.data_ptr(), sx.data_ptr(), sy.data_ptr(), N, H, W, Cw, Pw,
                *c_strides, *o_strides, int(dtype == torch.bfloat16), int(snap), int(bf16),
                stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{lib_label} mft_warp: cudaError {err}")

        outs = {k: torch.empty(shape, dtype=torch.float32, device=dev) for k in ("other", "this")}
        failed |= not side_by_side(f"mft_warp {label} ({entry}, {mode})", warp, outs, identical)
        del maps, xy, sx, sy, outs
        torch.cuda.empty_cache()
    # the window correlations K4 and K5: the arguments of mft_corr_alt and
    # mft_corr_win, the same in both checkouts
    H8, W8 = LEVELS[0]
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)) if "window" in groups else ():
        name = str(dtype).split(".")[1]
        for kind in ("wild", "local"):
            f1, pyr, c = feature_inputs(torch, dev, dtype, kind, H8, W8, seed=3)
            C = f1.shape[-1]
            ptrs = [t.data_ptr() for t in pyr]
            hw = [v for t in pyr for v in t.shape[1:3]]
            args = (f1.data_ptr(), c.data_ptr(), *ptrs, *hw, len(pyr), B, H8, W8, C, RADIUS,
                    ops.product.corr_scale(C), code)
            mag = ops.corr_window_magnitude(f1, pyr, c, RADIUS) if code == 1 else None

            def within_window_bound(a, b):
                bound = ops.product_error_bound(a, mag, C, ops.product.corr_scale(C))
                diff = (b.float() - a.float()).abs()
                ratio = float((diff / bound.clamp_min(1e-30)).max())
                ok = bool((diff <= bound).all())
                return ok, (f"largest |this - other| / bound {ratio:.4f} "
                            f"{'within' if ok else 'OUTSIDE'} ops.product_error_bound; "
                            f"{differing(a, b)} outputs differ")

            for kernel in ("mft_corr_alt", "mft_corr_win"):
                def call(label, out, kernel=kernel):
                    lib = libs[label]
                    s = stream().cuda_stream
                    if kernel == "mft_corr_alt":
                        err = lib.mft_corr_alt(out.data_ptr(), *args, s)
                    else:
                        err = lib.mft_corr_win(out.data_ptr(), *args, None, s)
                    if err != 0:
                        raise RuntimeError(f"{label} {kernel}: cudaError {err}")

                outs = {k: torch.empty((B, H8 * W8, len(pyr) * (2 * RADIUS + 1) ** 2),
                                       dtype=dtype, device=dev) for k in ("other", "this")}
                failed |= not side_by_side(f"{kernel} {name} {kind}", call, outs,
                                           within_window_bound if code == 1 else identical)
            del f1, pyr, c, mag
            torch.cuda.empty_cache()
    if "volume" in groups:
        failed |= not compare_volume(torch, dev, libs, side_by_side, identical)
    if "chain_select" in groups:
        failed |= not compare_chain_select(torch, dev, libs, side_by_side)
    if "backward" in groups:
        failed |= not compare_backward(torch, dev, libs, side_by_side, identical)
    print("ok" if not failed else "FAILED: outputs differ between the checkouts")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
