"""A numpy mirror of the staged gather's addressing against the plain versions.

On the card, K2 ``mft_corr_lookup``, #4 ``mft_corr_lookup_folded``, K6
``mft_corr_lookup_q``, K7 ``mft_corr_lookup_packed`` and K8
``mft_corr_lookup_packed_i8`` run one gather
(``mft_tpu_torch/ops/csrc/corr_gather.cuh``): per pixel and level, ``load_rows``
reads the rows of a box of (2r+3)^2 taps with aligned 8-byte loads from the
level table's address, row y of pixel bp at value bp*pixel + y*stride from the
level's base; ``store_rows`` shifts each row to its first column, keeps the
columns and rows inside the level's own h x w map (zeros elsewhere) and
dequantizes int8 taps; ``sample`` weights four taps of the box per window
position. Separate levels have pixel = h*w and stride = w; the packed map has
pixel = H0*sum w_l and stride = sum w_l for every level, and a level's base is
the map's plus its column offset; a folded (B, P, rows, 128) level has pixel =
rows*128 and stride = w, whatever w is (a small level's h*w values fill the
first lanes of its one zero-padded row).

Here the same steps run in numpy, word by word as the kernel does them, over
flat byte buffers laid out as on the card (each separate or folded level
256-byte aligned; the packed map one buffer). Each byte a kept tap uses must
have been loaded, no load may leave its buffer's aligned extent, and shared
memory that is never written reads as NaN. Sampled in the plain order, the
mirror must equal the plain versions (``ops.corr_lookup_ref``,
``corr_lookup_q_ref``, ``corr_lookup_packed_ref``, ``corr_lookup_packed_i8_ref``,
``corr_lookup_folded_ref``) bit for bit.
"""

import numpy as np
import pytest
import torch

from mft_tpu_torch import ops
from mft_tpu_torch.models.raft import corr as tcorr

CHUNK = 8                     # corr_gather.cuh kChunk: bytes a staging load
ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _distinct_banks(pitch, n, rows, groups):
    for a in range(groups):
        for b in range(a + 1, groups):
            for i in range(n):
                for k in range(n):
                    if (a * rows * pitch + i) % 32 == (b * rows * pitch + k) % 32:
                        return False
    return True


def geometry(radius, itemsize):
    """corr_gather.cuh Geometry<R, T> with float32 boxes: (side, pitch, loads)."""
    n = 2 * radius + 1
    side = n + 2
    rows = (n + 32 // n - 1) // (32 // n)
    groups = (n + rows - 1) // rows
    pitch = next((p for p in range(side + (side & 1), side + 64, 2)
                  if _distinct_banks(p, n, rows, groups)), side + (side & 1))
    per_load = CHUNK // itemsize
    return side, pitch, (side + 2 * (per_load - 1)) // per_load


def box_origin(o, extent, side):
    """(int)fminf(fmaxf(o, -side), extent) for finite o."""
    return np.minimum(np.maximum(o, np.float32(-side)), np.float32(extent)).astype(np.int64)


def box_index(d, radius):
    """(int)min((unsigned)(int)d, 2r+1): negative d clamps to 2r+1."""
    i = np.clip(d, -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64) & 0xFFFFFFFF
    return np.minimum(i, 2 * radius + 1)


def _funnel_right(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): the low 32 bits of (hi:lo) >> sh."""
    return ((hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64))
            >> sh.astype(np.uint64)) & np.uint64(0xFFFFFFFF)


def stage_boxes(buf, ends, table, itemsize, coords, radius, scales=None, P=1):
    """load_rows + store_rows of every pixel: (BP, L, side, pitch) float32
    boxes, NaN where nothing is written.

    args: buf, the flat uint8 buffer; ends, per level the end of its
      allocation's aligned extent in buf (no load may pass it); table, per
      level (base byte, h, w, pixel, stride); coords (BP, 2) float32; scales
      (B, L) float32 for int8 taps, P pixels a pair.
    """
    side, pitch, loads = geometry(radius, itemsize)
    words = 2 * loads
    BP = coords.shape[0]
    bp = np.arange(BP, dtype=np.int64)
    boxes = np.full((BP, len(table), side, pitch), np.nan, np.float32)
    cols = np.arange(side)
    q = np.arange(words)
    for l, (base, h, w, pixel, stride) in enumerate(table):
        inv = np.float32(2.0 ** -l)
        ox = box_origin(np.floor(coords[:, 0] * inv + np.float32(-radius)), w, side)
        oy = box_origin(np.floor(coords[:, 1] * inv + np.float32(-radius)), h, side)
        lo, hi = np.maximum(0, -ox), np.minimum(side, w - ox)
        for by in range(side):
            gy = oy + by
            start = base + (bp * pixel + gy * stride + ox) * itemsize
            sb = start & (CHUNK - 1)
            row_in = (gy >= 0) & (gy < h)
            # load_rows: load k holds bytes [8k, 8k + 8) of the row from start - sb
            wd = np.zeros((BP, words), np.uint32)
            valid = np.zeros((BP, words), np.uint32)        # loaded bytes, 4 bits a word
            first, last = lo * itemsize + sb - CHUNK, hi * itemsize + sb
            for k in range(loads):
                do = row_in & (lo < hi) & (CHUNK * k > first) & (CHUNK * k < last)
                addr = (start - sb + CHUNK * k)[do]
                assert (addr >= 0).all() and (addr + CHUNK <= ends[l]).all()
                chunk = buf[addr[:, None] + np.arange(CHUNK)].copy().view(np.uint32)
                wd[do, 2 * k:2 * k + 2] = chunk
                valid[do, 2 * k:2 * k + 2] = 0xF
            # store_rows: the row shifted so that word 0 starts at box column 0
            shift = ((sb & 4) != 0)[:, None] & (q + 1 < words)
            take = np.where(shift, np.minimum(q + 1, words - 1), q)
            a = np.take_along_axis(wd, take, 1)
            v = np.take_along_axis(valid, take, 1)
            if itemsize < 4:
                sh = (sb & (2 if itemsize == 2 else 3)) * 8
                a = a.astype(np.uint64)
                a[:, :-1] = _funnel_right(a[:, :-1], a[:, 1:], sh[:, None])
                v[:, :-1] = (v[:, :-1] | v[:, 1:] << 4) >> (sh[:, None] // 8) & 0xF
                a = a.astype(np.uint32)
            keep = row_in[:, None] & (cols >= lo[:, None]) & (cols < hi[:, None])
            if itemsize == 4:
                val = a[:, cols].view(np.float32)
                used = v[:, cols] == 0xF
            elif itemsize == 2:
                word = a[:, cols >> 1]
                bits = np.where(cols & 1, word & 0xFFFF0000, word << 16).astype(np.uint32)
                val = bits.view(np.float32)
                used = (v[:, cols >> 1] >> (2 * (cols & 1)) & 3) == 3
            else:
                byte = (a[:, cols >> 2] >> (8 * (cols & 3)).astype(np.uint32)) & 0xFF
                val = byte.astype(np.uint8).view(np.int8).astype(np.float32)
                val = val * scales[bp // P, l][:, None]
                used = (v[:, cols >> 2] >> (cols & 3) & 1) == 1
            assert used[keep].all(), "a kept tap uses a byte that was not loaded"
            boxes[:, l, by, :side] = np.where(keep, val, np.float32(0.0))
    return boxes


def sample_boxes(boxes, coords, radius):
    """corr_gather.cuh sample: (BP, L*(2r+1)^2) float32 in the plain order."""
    n = 2 * radius + 1
    BP, L = boxes.shape[:2]
    out = np.empty((BP, L * n * n), np.float32)
    pix = np.arange(BP)
    one = np.float32(1.0)
    for l in range(L):
        inv = np.float32(1.0) / np.float32(2 ** l)
        ax, ay = coords[:, 0] * inv, coords[:, 1] * inv
        oxf = np.floor(ax + np.float32(-radius))
        oyf = np.floor(ay + np.float32(-radius))
        for i in range(n):
            x = ax + np.float32(i - radius)
            x0f = np.floor(x)
            wx = x - x0f
            w0x = one - wx
            cxi = box_index(x0f - oxf, radius)
            for j in range(n):
                y = ay + np.float32(j - radius)
                y0f = np.floor(y)
                wy = y - y0f
                w0y = one - wy
                cyi = box_index(y0f - oyf, radius)
                box = boxes[pix, l]
                acc = box[pix, cyi, cxi] * (w0x * w0y)
                acc = acc + box[pix, cyi, cxi + 1] * (wx * w0y)
                acc = acc + box[pix, cyi + 1, cxi] * (w0x * wy)
                acc = acc + box[pix, cyi + 1, cxi + 1] * (wx * wy)
                out[:, l * n * n + i * n + j] = acc
    return out


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's values as the card holds them, little-endian bytes."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint8).reshape(-1)
    return t.contiguous().numpy().view(np.uint8).reshape(-1)


def _aligned(n, a=256):
    return -(-n // a) * a


def dense_table(levels):
    """Separate levels in one buffer, each at a 256-byte aligned base, as the
    card's allocator places them: (buf, ends, table)."""
    parts, ends, table, off = [], [], [], 0
    for lvl in levels:
        raw = _bytes(lvl)
        _, _, h, w = lvl.shape
        table.append((off, h, w, h * w, w))
        ends.append(off + _aligned(raw.size, CHUNK))
        size = _aligned(raw.size)
        parts.append(np.concatenate([raw, np.full(size - raw.size, 0xAB, np.uint8)]))
        off += size
    return np.concatenate(parts), ends, table


def packed_table(packed, dims):
    """The packed map as one buffer: level l at the map's base plus its column
    offset, pixel stride H0*Wp and row stride Wp for every level."""
    raw = _bytes(packed)
    _, _, H0, Wp = packed.shape
    buf = np.concatenate([raw, np.full(_aligned(raw.size) - raw.size, 0xAB, np.uint8)])
    isz = packed.element_size()
    table, off = [], 0
    for h, w in dims:
        table.append((off * isz, h, w, H0 * Wp, Wp))
        off += w
    return buf, [_aligned(raw.size, CHUNK)] * len(dims), table


def folded_table(levels, dims):
    """Folded (B, P, rows, 128) levels, each at a 256-byte aligned base as
    dense_table places them: pixel stride rows*128, row stride w."""
    parts, ends, table, off = [], [], [], 0
    for lvl, (h, w) in zip(levels, dims):
        raw = _bytes(lvl)
        table.append((off, h, w, lvl.shape[2] * 128, w))
        ends.append(off + _aligned(raw.size, CHUNK))
        size = _aligned(raw.size)
        parts.append(np.concatenate([raw, np.full(size - raw.size, 0xAB, np.uint8)]))
        off += size
    return np.concatenate(parts), ends, table


def _coords(rng, B, P, dims, radius):
    """(B*P, 2) float32: a third uniform over the map and well past it, a
    third the pixel grid + U(-2, 2), a third positions that round up to an
    integer at some level (c/2^l just below an integer)."""
    h0, w0 = dims[0]
    span = (radius + 3) * 2 ** len(dims)
    k = np.arange(B * P) % 3
    c = np.empty((B * P, 2), np.float32)
    c[k == 0] = rng.uniform((-span, -span), (w0 + span, h0 + span), (int((k == 0).sum()), 2))
    n1 = int((k == 1).sum())
    c[k == 1] = (np.stack([rng.integers(0, w0, n1), rng.integers(0, h0, n1)], -1)
                 + rng.uniform(-2, 2, (n1, 2)))
    n2 = int((k == 2).sum())
    m = rng.integers(1, 12, (n2, 2)).astype(np.float32)
    lvl = rng.integers(0, len(dims), (n2, 1))
    c[k == 2] = np.nextafter(m, np.float32(-np.inf)) * np.float32(2.0) ** lvl
    return c


def _levels(rng, form, B, P, dims):
    """Random levels of ``form``; int8 ones with -128 and 127 at every level
    and (B, L) scales that are no powers of two."""
    if form == "int8":
        levels = []
        for h, w in dims:
            qv = rng.integers(-128, 128, (B, P, h, w))
            flat = qv.reshape(-1)
            flat[rng.integers(0, flat.size, 4)] = -128
            flat[rng.integers(0, flat.size, 4)] = 127
            levels.append(torch.from_numpy(qv.astype(np.int8)))
        scales = torch.from_numpy(rng.uniform(0.011, 0.093, (B, len(dims))).astype(np.float32))
        return levels, scales
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[form]
    return [torch.from_numpy(rng.standard_normal((B, P, h, w)).astype(np.float32)).to(dt)
            for h, w in dims], None


def _as_output(samples, dtype, shape):
    return torch.from_numpy(samples).reshape(shape).to(dtype)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    differ = int((got.view(ints) != want.view(ints)).sum())
    assert differ == 0, f"{differ} of {got.numel()} samples differ from the plain version's"


# pyramids of a 12x20 map (packed rows of 37 values: 148, 74, 37 bytes) and a
# 13x21 map (38 values), and 3 levels of rows of 30, 15 and 7 values
DIMS = {
    "12x20": [(12, 20), (6, 10), (3, 5), (1, 2)],
    "13x21": [(13, 21), (6, 10), (3, 5), (1, 2)],
    "3 levels w30 w15 w7": [(12, 30), (6, 15), (3, 7)],
}


@pytest.mark.parametrize("shape", sorted(DIMS))
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_gather_mirror_matches_plain(layout, form, radius, shape):
    """The mirrored gather, on the dense level table (K2, K6) and on the
    packed one (K7, K8), equals the plain version bit for bit."""
    rng = np.random.default_rng(radius)
    dims = DIMS[shape]
    B, P = 2, dims[0][0] * dims[0][1]
    levels, scales = _levels(rng, form, B, P, dims)
    coords = _coords(rng, B, P, dims, radius)
    tc = torch.from_numpy(coords.reshape(B, P, 2))
    if layout == "dense":
        buf, ends, table = dense_table(levels)
        want = (ops.corr_lookup_q_ref(levels, scales, tc, radius) if form == "int8"
                else ops.corr_lookup_ref(levels, tc, radius))
    else:
        packed, pdims = tcorr.pack_corr_pyramid(levels)
        buf, ends, table = packed_table(packed, pdims)
        want = (ops.corr_lookup_packed_i8_ref(packed, scales, pdims, tc, radius)
                if form == "int8" else ops.corr_lookup_packed_ref(packed, pdims, tc, radius))
    isz = ITEMSIZE[form]
    boxes = stage_boxes(buf, ends, table, isz, coords, radius,
                        None if scales is None else scales.numpy(), P)
    got = _as_output(sample_boxes(boxes, coords, radius), want.dtype, want.shape)
    _same_bits(got, want)


def test_gather_mirror_finds_a_neighbouring_level():
    """The mirror sees what the masks prevent: with the column mask widened
    to the box (a tap may read the next level's columns of the packed map),
    filling level 1 with 1e3 changes level 0's samples near its right edge."""
    rng = np.random.default_rng(5)
    dims = DIMS["12x20"]
    B, P = 1, 240
    levels, _ = _levels(rng, "float32", B, P, dims)
    packed, pdims = tcorr.pack_corr_pyramid(levels)
    for view in tcorr.unpack_levels(packed, pdims)[1:]:
        view.fill_(1e3)
    coords = np.stack([np.full(P, 19.5, np.float32), np.linspace(0, 11, P, dtype=np.float32)], -1)
    buf, ends, table = packed_table(packed, pdims)
    honest = sample_boxes(stage_boxes(buf, ends, table, 4, coords, 4), coords, 4)
    widened = [(base, h, Wp - base // 4, pixel, Wp) for base, h, w, pixel, Wp in table]
    leaky = sample_boxes(stage_boxes(buf, ends, widened, 4, coords, 4), coords, 4)
    want = ops.corr_lookup_packed_ref(packed, pdims, torch.from_numpy(coords)[None], 4)
    _same_bits(torch.from_numpy(honest)[None], want)
    assert float(np.abs(leaky[:, :81] - honest[:, :81]).max()) > 100.0


# folded pyramids (#4): the 512x512 slice's levels (64x64 in 32 rows of 128
# values, 32x32 in 8, 16x16 in 2, 8x8 one zero-padded row) and pyramids whose
# level 0 fits one row, with small levels whose w does not divide 128
FOLDED = {
    "slice 64x64": [(64, 64), (32, 32), (16, 16), (8, 8)],
    "8x12": [(8, 12), (4, 6), (2, 3), (1, 1)],
    "11x11": [(11, 11), (5, 5), (2, 2), (1, 1)],
}


def _random_folded_levels(rng, form, B, P, dims, pad=1e3):
    """Random folded (B, P, rows, 128) levels, rows*128 = h*w or one row for
    fewer than 128 values; the padding lanes past h*w hold ``pad``."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[form]
    levels = []
    for h, w in dims:
        rows = max(h * w, 128) // 128
        v = rng.standard_normal((B, P, rows * 128)).astype(np.float32)
        v[..., h * w:] = pad
        levels.append(torch.from_numpy(v.reshape(B, P, rows, 128)).to(dt))
    return levels


@pytest.mark.parametrize("shape", sorted(FOLDED))
@pytest.mark.parametrize("radius", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["float32", "bfloat16"])
def test_gather_mirror_matches_folded_plain(form, radius, shape):
    """The mirrored gather on the folded level table (#4: pixel stride
    rows*128, row stride w) equals corr_lookup_folded_ref bit for bit; the
    small levels' padding lanes hold 1e3 and change nothing."""
    rng = np.random.default_rng(40 + radius)
    dims = FOLDED[shape]
    B, P = 2, 12 if dims[0] == (64, 64) else 40
    levels = _random_folded_levels(rng, form, B, P, dims)
    coords = _coords(rng, B, P, dims, radius)
    tc = torch.from_numpy(coords.reshape(B, P, 2))
    want = ops.corr_lookup_folded_ref(levels, dims, tc, radius)
    buf, ends, table = folded_table(levels, dims)
    boxes = stage_boxes(buf, ends, table, ITEMSIZE[form], coords, radius)
    _same_bits(_as_output(sample_boxes(boxes, coords, radius), want.dtype, want.shape), want)


@pytest.mark.parametrize("shape", ["8x12", "11x11"])
def test_gather_mirror_never_reads_folded_padding(shape):
    """Level 0 of one row holds h*w < 128 values and 1e3 in its padding
    lanes: the mirror with the folded table equals the plain version at the
    bottom left corner, while a table that extends the map by the rows the
    128 lanes would begin samples the padding (a change over 100; the
    windows' columns stay within the row's 128 lanes)."""
    rng = np.random.default_rng(7)
    dims = FOLDED[shape]
    B, P = 1, 64
    levels = _random_folded_levels(rng, "float32", B, P, dims)
    h0, w0 = dims[0]
    coords = np.stack([rng.uniform(0, 0.5, P), rng.uniform(h0 - 1.5, h0 - 0.5, P)],
                      -1).astype(np.float32)
    buf, ends, table = folded_table(levels, dims)
    honest = sample_boxes(stage_boxes(buf, ends, table, 4, coords, 4), coords, 4)
    want = ops.corr_lookup_folded_ref(levels, dims, torch.from_numpy(coords)[None], 4)
    _same_bits(torch.from_numpy(honest)[None], want)
    base, h, w, pixel, stride = table[0]
    widened = [(base, -(-128 // w), w, pixel, stride)] + table[1:]
    leaky = sample_boxes(stage_boxes(buf, ends, widened, 4, coords, 4), coords, 4)
    assert float(np.abs(leaky[:, :81] - honest[:, :81]).max()) > 100.0
