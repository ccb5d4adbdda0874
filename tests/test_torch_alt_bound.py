"""The error bound and the rounding repair of the bfloat16 window correlations.

On the card, ``corr_lookup_alt`` and ``corr_lookup_win`` in bfloat16 run one
tile product on the tensor cores (``csrc/corr_alt.cu window_tc_kernel``),
which sum each tap dot in an order of their own; they are held to
``ops.product_error_bound`` (K = C, scale 1/sqrt(C), S from
``ops.corr_window_magnitude``) against the plain version on every element,
and a rounding repair recomputes in the plain order the taps of every
sample near a bf16 rounding boundary (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Here, on the CPU:
- ``ops.corr_window_magnitude`` against a numpy loop;
- the bound covers an independent implementation: JAX's Pallas kernels in
  interpret mode (an MXU-order dot, then tent contractions) on the same
  bf16 values;
- it covers the port's samples with each tap dot summed in another order
  (in blocks of 16 as wgmma's k16 steps sum, or reversed), and breaks with
  one channel dropped;
- the repair's premise: a blocked-by-16 dot differs from the tree-order dot
  by less than a quarter of the window, and the repaired samples equal the
  plain version's bits.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mft_tpu.ops.alt_corr_pallas import (build_feature_pyramid as jax_feature_pyramid,
                                         build_feature_pyramid_slab, corr_lookup_alt,
                                         corr_lookup_win)
from mft_tpu_torch import ops
from mft_tpu_torch.models.raft.corr import build_feature_pyramid
from mft_tpu_torch.ops.corr_alt import _tree_dots, window_samples
from mft_tpu_torch.ops.product import corr_scale

R = 4
# csrc/corr_alt.cu kWindow: the repair recomputes the taps of a sample whose
# value v has bf16(v - e) != bf16(v + e), e = REPAIR_WINDOW * scale *
# ||f1_p|| * (the largest ||f2_q|| of its four taps)
REPAIR_WINDOW = 2.0 ** -21


def _inputs(rng, kind, B=2, H8=13, W8=21, C=64, levels=4):
    """bf16 (B, H8, W8, C) source features, the pooled pyramid of bf16 target
    features, and coords: 'wild' past every edge, 'local' the pixel grid +
    U(-2, 2) (tests/test_torch_kernels_cuda.py's _alt_inputs)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    f1 = t(rng.standard_normal((B, H8, W8, C))).bfloat16()
    f2 = t(rng.standard_normal((B, C, H8, W8))).bfloat16()
    if kind == "wild":
        coords = rng.uniform(-8, W8 + 8, (B, H8 * W8, 2))
    else:
        g = np.mgrid[0:H8, 0:W8].transpose(1, 2, 0)[..., ::-1].reshape(1, H8 * W8, 2)
        coords = g + rng.uniform(-2, 2, (B, H8 * W8, 2))
    return f1, build_feature_pyramid(f2, levels), t(coords).contiguous()


def _violations(got, want, magnitude, C) -> int:
    """Elements with |got - want| above the bound (K = C, scale 1/sqrt(C))."""
    bound = ops.product_error_bound(want, magnitude, C, corr_scale(C))
    return int(((got.float() - want.float()).abs() > bound).sum())


def test_window_magnitude_matches_numpy(rng):
    """S = the bilinear sample, zeros outside the map, of q -> sum_c
    |f1[p, c]| |f2_l[q, c]|, unscaled, at r = 2 on 3 levels of a 5x6 map."""
    B, H8, W8, C, r = 2, 5, 6, 16, 2
    f1, pyr, coords = _inputs(rng, "wild", B, H8, W8, C, levels=3)
    got = ops.corr_window_magnitude(f1, pyr, coords, r)
    n = 2 * r + 1
    a = np.abs(f1.float().numpy().astype(np.float64)).reshape(B, H8 * W8, C)
    want = np.zeros((B, H8 * W8, len(pyr) * n * n))
    for lvl, f2 in enumerate(pyr):
        m = np.abs(f2.float().numpy().astype(np.float64))
        h, w = m.shape[1:3]
        for b in range(B):
            for p in range(H8 * W8):
                x, y = (coords[b, p].double().numpy() / 2.0 ** lvl)
                x0, y0 = math.floor(x), math.floor(y)
                wx, wy = x - x0, y - y0

                def tap(xi, yi):
                    inside = 0 <= xi < w and 0 <= yi < h
                    return float(a[b, p] @ m[b, yi, xi]) if inside else 0.0
                for i in range(n):
                    for j in range(n):
                        xi, yi = x0 - r + i, y0 - r + j
                        want[b, p, lvl * n * n + i * n + j] = (
                            tap(xi, yi) * (1 - wx) * (1 - wy) + tap(xi + 1, yi) * wx * (1 - wy)
                            + tap(xi, yi + 1) * (1 - wx) * wy + tap(xi + 1, yi + 1) * wx * wy)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_levels(pyr):
    """The port's bf16 pyramid levels as float32 numpy (B, h, w, C) arrays:
    the same values for both packages."""
    return [lvl.float().numpy() for lvl in pyr]


def test_bound_covers_jax_alt_kernel(rng):
    """JAX's corr_lookup_alt (interpret mode: one MXU-order f32 dot of the
    tile against each level, then tent contractions; output f32) against the
    port's plain version in bf16, on the same bf16 values, coordinates
    leaving the map on every side: within the bound on every element."""
    B, H8, W8, C = 1, 8, 16, 40
    f1, pyr, coords = _inputs(rng, "wild", B, H8, W8, C)
    jpyr = [jax_feature_pyramid(jnp.asarray(lvl), 1, dtype=jnp.bfloat16)[0]
            for lvl in _jax_levels(pyr)]
    got = corr_lookup_alt(jnp.asarray(f1.float().numpy().reshape(B, H8 * W8, C), jnp.bfloat16),
                          jpyr, jnp.asarray(coords.numpy()), R, tile_p=128)
    got = torch.from_numpy(np.array(got))
    want = ops.corr_lookup_alt_ref(f1, pyr, coords, R)
    assert got.shape == want.shape == (B, H8 * W8, 4 * 81)
    mag = ops.corr_window_magnitude(f1, pyr, coords, R)
    assert _violations(got, want, mag, C) == 0


def test_bound_covers_jax_win_kernel(rng):
    """JAX's corr_lookup_win (interpret mode, 64-pixel tiles of a 32x16 map:
    level 0 recomputes a fold-aligned window of rows for local tiles, all
    rows for wild ones) against the port's plain version in bf16: within the
    bound on every element."""
    B, H8, W8, C = 1, 32, 16, 40
    f1, pyr, coords = _inputs(rng, "local", B, H8, W8, C)
    wild = _inputs(rng, "wild", B, H8, W8, C)[2]
    coords[:, 256:] = wild[:, 256:]
    slabs = [build_feature_pyramid_slab(jnp.asarray(lvl), 1, dtype=jnp.bfloat16)[0]
             for lvl in _jax_levels(pyr)]
    got = corr_lookup_win(jnp.asarray(f1.float().numpy().reshape(B, H8 * W8, C), jnp.bfloat16),
                          slabs, jnp.asarray(coords.numpy()), R, tile_p=64)
    got = torch.from_numpy(np.array(got))
    want = ops.corr_lookup_alt_ref(f1, pyr, coords, R)
    mag = ops.corr_window_magnitude(f1, pyr, coords, R)
    assert _violations(got, want, mag, C) == 0


def _blocked_dots(g, f):
    """Each dot as the tensor cores' k16 steps take it: a float32 partial sum
    over each block of 16 channels, the partials added in order."""
    prod = g.float() * f.float()[:, None, :]
    acc = torch.zeros(prod.shape[:2])
    for k0 in range(0, prod.shape[-1], 16):
        part = torch.zeros(prod.shape[:2])
        for k in range(k0, min(k0 + 16, prod.shape[-1])):
            part = part + prod[..., k]
        acc = acc + part
    return acc


def _reversed_dots(g, f):
    prod = g.float() * f.float()[:, None, :]
    acc = torch.zeros(prod.shape[:2])
    for k in reversed(range(prod.shape[-1])):
        acc = acc + prod[..., k]
    return acc


def _dropped_dots(g, f):
    """The plain tree order with the middle channel dropped."""
    f = f.clone()
    f[:, f.shape[1] // 2] = 0
    return _tree_dots(g, f)


ORDERS = {"blocked by 16": _blocked_dots, "reversed": _reversed_dots, "dropped": _dropped_dots}


@pytest.mark.parametrize("kind", ["local", "wild"])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_bound_covers_dot_orders(rng, order, kind):
    """The port's samples with each tap dot summed in blocks of 16 (wgmma's
    k16 steps) or reversed, rounded once to bf16, stay within the bound of
    the plain version on every element, at the cuda tests' shapes (2 pairs,
    13x21, C = 64); with one channel dropped the bound breaks."""
    f1, pyr, coords = _inputs(rng, kind)
    want = ops.corr_lookup_alt_ref(f1, pyr, coords, R)
    got = window_samples(f1, pyr, coords, R, dot=ORDERS[order]).bfloat16()
    mag = ops.corr_window_magnitude(f1, pyr, coords, R)
    assert got.shape == want.shape
    if order == "dropped":
        assert _violations(got, want, mag, 64) > 0
    else:
        assert _violations(got, want, mag, 64) == 0


def _bilinear(d, wx, wy):
    """The plain version's combination of tap dots d[r, tx, ty]."""
    return (d[:, :-1, :-1] * ((1.0 - wx) * (1.0 - wy)) + d[:, 1:, :-1] * (wx * (1.0 - wy))
            + d[:, :-1, 1:] * ((1.0 - wx) * wy) + d[:, 1:, 1:] * (wx * wy))


def _bits(v):
    return v.bfloat16().view(torch.int16)


def _box_max_norms(f2, bx, by, B, H8, W8, side):
    """Per pixel, the largest ||f2_q|| over the tap box of its 8x8 tile (the
    union of the tile's windows, clipped to the map), as the bf16 kernel takes
    it. args: f2 (B, h, w, C); bx, by (B * H8 * W8,) window origins."""
    h, w = f2.shape[1:3]
    norms = f2.double().norm(dim=-1)                             # (B, h, w)
    out = torch.empty(B, H8, W8, dtype=torch.float64)
    bx, by = bx.view(B, H8, W8), by.view(B, H8, W8)
    for b in range(B):
        for t0 in range(0, H8, 8):
            for s0 in range(0, W8, 8):
                x, y = bx[b, t0:t0 + 8, s0:s0 + 8], by[b, t0:t0 + 8, s0:s0 + 8]
                x_lo, x_hi = max(int(x.min()), 0), min(int(x.max()) + side - 1, w - 1)
                y_lo, y_hi = max(int(y.min()), 0), min(int(y.max()) + side - 1, h - 1)
                box = norms[b, y_lo:y_hi + 1, x_lo:x_hi + 1]
                out[b, t0:t0 + 8, s0:s0 + 8] = box.max() if box.numel() else 0.0
    return out.reshape(-1)


@pytest.mark.parametrize("kind", ["local", "wild"])
def test_repair_window_covers_blocked_dots(rng, kind):
    """The premise of the bf16 kernel's rounding repair, at C = 256 on 4
    levels: every in-map tap dot summed in blocks of 16 differs from the
    plain tree-order dot by less than a quarter of e_t = REPAIR_WINDOW *
    ||f1_p|| * ||f2_t|| (room for the tensor cores' sums). A sample is a
    convex combination of four such dots, so the samples the kernel's window
    passes (bf16(v - e) == bf16(v + e), e = REPAIR_WINDOW * scale * ||f1_p||
    * the largest ||f2_q|| of the pixel's 8x8 tile's box, at least the e_t of
    its taps; 0 for a sample with no tap in the map, an exact 0) round as the
    plain version's. Recomputing the four taps of
    every other sample in the tree order and combining those samples again
    gives the plain version's bits; the window flags under 3% of the
    samples."""
    B, H8, W8, C = 2, 12, 12, 256
    f1, pyr, coords = _inputs(rng, kind, B, H8, W8, C)
    want = ops.corr_lookup_alt_ref(f1, pyr, coords, R)
    scale = corr_scale(C)
    n, side = 2 * R + 1, 2 * R + 2
    f1r = f1.reshape(B * H8 * W8, C)
    n1 = f1r.double().norm(dim=1)
    c0 = coords.reshape(-1, 2)
    flagged = total = 0
    for lvl, f2 in enumerate(pyr):
        h, w = f2.shape[1:3]
        c = c0 * (1.0 / 2.0 ** lvl)
        x0f, y0f = torch.floor(c[:, 0]), torch.floor(c[:, 1])
        wx, wy = (c[:, 0] - x0f)[:, None, None], (c[:, 1] - y0f)[:, None, None]
        taps = torch.arange(side) - R
        xs, ys = x0f.long()[:, None] + taps, y0f.long()[:, None] + taps
        valid = ((xs >= 0) & (xs < w))[:, :, None] & ((ys >= 0) & (ys < h))[:, None, :]
        b = torch.arange(B * H8 * W8) // (H8 * W8)
        idx = (b[:, None, None] * (h * w) + ys.clamp(0, h - 1)[:, None, :] * w
               + xs.clamp(0, w - 1)[:, :, None]).reshape(len(b), -1)
        g = f2.reshape(-1, C)[idx]                               # (r, taps, C) [tx, ty]
        valid = valid.reshape(len(b), -1)
        tree, blocked = _tree_dots(g, f1r), _blocked_dots(g, f1r)
        e_tap = (REPAIR_WINDOW * n1[:, None] * g.double().norm(dim=2)).where(valid, 0.0)
        assert bool(((blocked.double() - tree.double()).abs() < e_tap / 4)[valid].all())
        shape = (len(b), side, side)
        d_plain = torch.where(valid, tree * scale, 0.0).view(shape)
        d_tc = torch.where(valid, blocked * scale, 0.0).view(shape)
        v = _bilinear(d_tc, wx, wy)
        n2 = _box_max_norms(f2, xs[:, 0], ys[:, 0], B, H8, W8, side)
        in_map = valid.view(shape)
        in_map = (in_map[:, :-1, :-1] | in_map[:, 1:, :-1] | in_map[:, :-1, 1:]
                  | in_map[:, 1:, 1:])
        e = (REPAIR_WINDOW * scale * n1 * n2).float()[:, None, None] * in_map
        flag = _bits(v - e) != _bits(v + e)
        mark = torch.zeros(shape, dtype=torch.bool)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            mark[:, dx:dx + n, dy:dy + n] |= flag
        repaired = torch.where(flag, _bilinear(torch.where(mark, d_plain, d_tc), wx, wy), v)
        got = want.reshape(len(b), -1)[:, lvl * n * n:(lvl + 1) * n * n]
        assert torch.equal(_bits(repaired.reshape(len(b), n * n)), got.view(torch.int16))
        flagged += int(flag.sum())
        total += flag.numel()
    assert flagged / total < 0.03


def test_window_probe_tool_finds_its_anchors():
    """tools/torch_window_probe.py edits corr_alt.cu's text into its two
    variants: each anchor it edits at is in window_tc_kernel once, the
    probed variant times its phases and records the tensor-core dots, and
    the other has no window test left."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("torch_window_probe",
                                                  root / "tools" / "torch_window_probe.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (root / "mft_tpu_torch" / "ops" / "csrc" / "corr_alt.cu").read_text()
    out = tool.variants(src)
    assert set(out) == {"probed", "no_repair"}
    probed = out["probed"]
    assert probed.count("atomicAdd(&g_probe[") == len(tool.PHASES) + 4
    assert "g_dots[" in probed and 'extern "C" int probe_read' in probed
    test = "flagged = nbox > 0 && in_map != 0u &&"
    assert test in src and test not in out["no_repair"]
