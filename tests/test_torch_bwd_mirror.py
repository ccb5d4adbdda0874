"""A numpy mirror of the lookup backward kernel's walk against its plain version.

On the card, ``mft_corr_lookup_bwd`` (``mft_tpu_torch/ops/csrc/corr_lookup_bwd.cu``)
gives a block of 256 threads a group of 8 consecutive pixels. The block
first reads the group's g into shared memory with each (pixel, level)'s
weights and box origin floor(c / 2^l) - r, floor clamped to [-side, 2^30],
and computes the group's box values ((2r+2)^2 a pixel and level, the four
window terms summed in float32 in the plain order, rounded to the volume
dtype). Then it walks each level's run of the group's 8*h*w values in
16-byte chunks (8 bfloat16 or 4 float32 values): thread t starts at chunk t,
finds its (pixel, row, column) by two divisions through a float32
reciprocal with one correction (``div_small``), and steps 256 chunks at a
time by a (pixels, rows, columns) carry step from the host. A chunk inside
one map row is a 16-byte store of zeros or, where the box's row meets it,
of box values; a chunk across rows or pixels, or at the run's tail, goes
value by value, and the tail's last chunk is stored value by value.

Here the same steps run in numpy, chunk by chunk as the threads do them,
over each level's flat buffer. Every value of every map must be written
exactly once, every 16-byte store must be aligned and inside its group's
run (so none leaves the buffer), only the box values the group computed may
be read, and the result must equal ``ops.corr_lookup_bwd_ref`` bit for bit.
"""

import numpy as np
import pytest
import torch

from mft_tpu_torch import ops

THREADS, GROUP = 256, 8       # corr_lookup_bwd.cu kThreads, kGroup
FAR = np.float32(2.0 ** 30)   # the box origin's clamp, kFar
DIMS = {"training 46x96": [(46, 96), (23, 48), (11, 24), (5, 12)],
        "odd 5x7": [(5, 7), (2, 3), (1, 1), (1, 1)]}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def div_small(e, d, inv):
    """corr_lookup_bwd.cu div_small: trunc(float32(e) * inv), one correction."""
    q = np.trunc(e.astype(np.float32) * np.float32(inv)).astype(np.int64)
    r = e - q * d
    return np.where(r < 0, q - 1, np.where(r >= d, q + 1, q))


def steps(h, w, chunk):
    """The host's carry step of 256 chunks: (pixels, rows, columns)."""
    p, rest = divmod(THREADS * chunk, h * w)
    return p, rest // w, rest % w


def _bits(x: torch.Tensor) -> np.ndarray:
    ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.contiguous().view(ints).numpy().reshape(-1)


def stage(g, coords, dims, radius, dtype):
    """Step 1 of every group: the box values' bits (BP, L, side, side)
    [pixel, level, b, a] and the boxes' origins (BP, L, 2) (x0, y0)."""
    BP = coords.shape[0]
    n = 2 * radius + 1
    side = n + 1
    L = len(dims)
    gw = g.float().numpy().reshape(BP, L, n, n)   # [i, j]: i offsets x
    gp = np.zeros((BP, L, n + 2, n + 2), np.float32)
    gp[:, :, 1:-1, 1:-1] = gw
    acc = np.zeros((BP, L, side, side), np.float32)   # [pixel, level, a, b]
    org = np.zeros((BP, L, 2), np.int64)
    for lvl in range(L):
        c = coords * np.float32(2.0 ** -lvl)
        f = np.floor(c)
        wx, wy = (c - f)[:, 0, None, None], (c - f)[:, 1, None, None]
        ux, uy = np.float32(1) - wx, np.float32(1) - wy
        gl = gp[:, lvl]
        a = np.float32(0) + gl[:, 1:, 1:] * (ux * uy)   # g[a, b]
        a = a + gl[:, :-1, 1:] * (wx * uy)              # g[a-1, b]
        a = a + gl[:, 1:, :-1] * (ux * wy)              # g[a, b-1]
        a = a + gl[:, :-1, :-1] * (wx * wy)             # g[a-1, b-1]
        acc[:, lvl] = a
        clamped = np.where(np.isnan(f), np.float32(-side), np.clip(f, -side, FAR))
        org[:, lvl] = clamped.astype(np.int64) - radius
    assert acc.dtype == np.float32
    boxes = _bits(torch.from_numpy(acc.transpose(0, 1, 3, 2).copy()).to(dtype))
    return boxes.reshape(BP, L, side, side), org


def walk(boxes, org, dims, BP, radius, itemsize):
    """Step 2 of every group, as its 256 threads walk each level: the level
    maps' bits and how often each value was written."""
    side = 2 * radius + 2
    chunk = 16 // itemsize
    outs = [np.zeros(BP * h * w, boxes.dtype) for h, w in dims]
    writes = [np.zeros(BP * h * w, np.int64) for h, w in dims]
    for bp0 in range(0, BP, GROUP):
        npx = min(GROUP, BP - bp0)
        for lvl, (h, w) in enumerate(dims):
            hw = h * w
            nv, base = npx * hw, bp0 * hw
            sp, sy, sx = steps(h, w, chunk)
            e = np.arange(THREADS) * chunk
            p = div_small(e, hw, np.float32(1) / np.float32(hw))
            o = e - p * hw
            y = div_small(o, w, np.float32(1) / np.float32(w))
            x = o - y * w
            assert (p == e // hw).all() and (y == o // w).all()
            out, count = outs[lvl], writes[lvl]

            def box_value(pk, yk, xk):
                """The value at (pixel, row, column): from the group's boxes
                where the box covers it (pixels of the group only), else 0."""
                assert ((0 <= pk) & (pk < npx)).all(), "a box of no pixel of the group"
                x0, y0 = org[bp0 + pk, lvl, 0], org[bp0 + pk, lvl, 1]
                b, a = yk - y0, xk - x0
                inside = (b >= 0) & (b < side) & (a >= 0) & (a < side)
                v = np.zeros(len(pk), boxes.dtype)
                v[inside] = boxes[bp0 + pk[inside], lvl, b[inside], a[inside]]
                return v

            def store(at, values):
                at = at + base
                assert ((at >= base) & (at < base + nv)).all(), "a store outside the run"
                out[at] = values
                np.add.at(count, at, 1)

            while (e < nv).any():
                live = e < nv
                fast = live & (x + chunk <= w) & (e + chunk <= nv)
                if fast.any():   # one row of one pixel: a 16-byte store
                    ef, pf, yf, xf = e[fast], p[fast], y[fast], x[fast]
                    assert (((base + ef) * itemsize) % 16 == 0).all()
                    x0, y0 = org[bp0 + pf, lvl, 0], org[bp0 + pf, lvl, 1]
                    b, a = yf - y0, xf - x0
                    meets = (b >= 0) & (b < side) & (a > -chunk) & (a < side)
                    for k in range(chunk):
                        v = np.zeros(len(ef), boxes.dtype)
                        ok = meets & (a + k >= 0) & (a + k < side)
                        v[ok] = boxes[bp0 + pf[ok], lvl, b[ok], a[ok] + k]
                        store(ef + k, v)
                slow = live & ~fast
                if slow.any():   # value by value
                    es, pk, yk, xk = e[slow], p[slow].copy(), y[slow].copy(), x[slow].copy()
                    full = es + chunk <= nv
                    assert (((base + es[full]) * itemsize) % 16 == 0).all()
                    for k in range(chunk):
                        inside = es + k < nv
                        v = box_value(pk[inside], yk[inside], xk[inside])
                        store(es[inside] + k, v)
                        xk += 1
                        wrap = xk == w
                        xk[wrap] = 0
                        yk[wrap] += 1
                        wrap = yk == h
                        yk[wrap] = 0
                        pk[wrap] += 1
                e = e + THREADS * chunk
                x = x + sx
                carry = x >= w
                x = np.where(carry, x - w, x)
                y = y + sy + carry
                carry = y >= h
                y = np.where(carry, y - h, y)
                p = p + sp + carry
                assert (p * hw + y * w + x == e).all()
    return outs, writes


def _coords(rng, BP, dims, radius):
    """(BP, 2) float32: uniform over the level-0 map and past it, the pixel
    grid + U(-2, 2), integers, and positions far off the map."""
    h0, w0 = dims[0]
    span = (radius + 3) * 2 ** len(dims)
    c = rng.uniform((-span, -span), (w0 + span, h0 + span), (BP, 2)).astype(np.float32)
    c[1::4] = np.round(c[1::4])
    c[2::4] = (rng.integers(0, (w0, h0), (len(c[2::4]), 2))
               + rng.uniform(-2, 2, (len(c[2::4]), 2))).astype(np.float32)
    c[3] = (-1e6, 3.5)
    c[7] = (2.5, 4e9)
    return c


@pytest.mark.parametrize("shape", sorted(DIMS))
@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_mirror_matches_plain(dtype, radius, shape):
    """The mirrored walk writes every value of every map once, inside its
    group's run, and equals the plain version bit for bit (21 pixels: two
    full groups and a tail of 5)."""
    rng = np.random.default_rng(radius)
    dims = DIMS[shape]
    B, P = 1, 21
    n = 2 * radius + 1
    g = torch.from_numpy(rng.standard_normal((B, P, len(dims) * n * n)).astype(np.float32))
    g = g.to(DT[dtype])
    coords = _coords(rng, B * P, dims, radius)
    boxes, org = stage(g, coords, dims, radius, DT[dtype])
    outs, writes = walk(boxes, org, dims, B * P, radius, g.element_size())
    want = ops.corr_lookup_bwd_ref(g, torch.from_numpy(coords).view(B, P, 2), dims, radius)
    for lvl, (out, count, ref) in enumerate(zip(outs, writes, want)):
        assert (count == 1).all(), f"level {lvl}: values written {np.unique(count)} times"
        differ = int((out != _bits(ref)).sum())
        assert differ == 0, f"level {lvl}: {differ} of {out.size} values differ"
    assert any(bool((_bits(r) != 0).any()) for r in want)


def test_div_small_is_exact():
    """div_small equals integer division for every dividend a first chunk can
    have (0 <= e < 256 * 8) and divisors up to 70,000 (every map side and
    pixel size of the shapes above, the 512x512 slice's 64x64 = 4096, and
    beyond)."""
    e = np.arange(THREADS * 8)
    for d in (*range(1, 5000), 5840, 8192, 40000, 65535, 70000):
        assert (div_small(e, d, np.float32(1) / np.float32(d)) == e // d).all(), d


@pytest.mark.parametrize("shape", sorted(DIMS))
@pytest.mark.parametrize("chunk", [4, 8])
def test_carry_steps(shape, chunk):
    """The host's step decomposes 256 chunks into pixels, rows < h and
    columns < w, so each carry adds at most one."""
    for h, w in DIMS[shape]:
        sp, sy, sx = steps(h, w, chunk)
        assert sp * h * w + sy * w + sx == THREADS * chunk
        assert 0 <= sy < h and 0 <= sx < w
