"""The port's PNG codec, flowou codecs and FlowCache against OpenCV and the
JAX package.

The port encodes PNGs with numpy + zlib (``mft_tpu_torch.io.png``); OpenCV
and the JAX codecs (``mft_tpu/io``) are the reference here. Files written by
either package decode in the other to the same arrays, bit for bit.
"""

import io
import os
import pickle
import struct
import tempfile
import zlib

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io import flowou_codecs as jax_codecs
from mft_tpu.io.cache import FlowCache as JaxFlowCache
from mft_tpu_torch.core.flowou import FlowOU
from mft_tpu_torch.io import FlowCache, flowou_codecs
from mft_tpu_torch.io.png import decode_png, encode_png, read_text

EXTS = [".flowou.png", ".flowou2.png", ".flowouX16.pkl", ".flowouX32.pkl"]
PNG_FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


def make_fou(rng, H=24, W=30, max_flow=50.0):
    flow = rng.uniform(-max_flow, max_flow, (H, W, 2)).astype(np.float32)
    occl = rng.uniform(0, 1, (H, W)).astype(np.float32)
    sigma = rng.uniform(0, 30, (H, W)).astype(np.float32)
    return flow, occl, sigma


def _image(rng, dtype, channels, H=19, W=23):
    hi = np.iinfo(dtype).max
    shape = (H, W) if channels == 1 else (H, W, channels)
    smooth = np.add.outer(np.arange(H), 3 * np.arange(W)) * (hi // 200)
    noise = rng.integers(0, hi // 16, shape)
    img = (smooth[..., None] if channels > 1 else smooth) + noise
    return (img % (hi + 1)).astype(dtype)


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 1), (np.uint16, 3), (np.uint16, 4)])
def test_png_matches_opencv_both_ways(rng, dtype, channels):
    """The port's file decodes through cv2 to the array it was given (BGR(A)
    order kept), and cv2's file decodes through the port to cv2's array."""
    img = _image(rng, dtype, channels)
    ours = encode_png(img, texts={"key": 1.5})
    got = cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_UNCHANGED)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    assert read_text(ours) == {"key": "1.5"}
    ok, theirs = cv2.imencode(".png", img)
    assert ok
    back = decode_png(theirs)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("name", PNG_FILTERS)
def test_png_reads_every_opencv_filter(rng, name):
    """cv2 writing every row with one filter type, 8- and 16-bit."""
    for img in (_image(rng, np.uint8, 3, 33, 41), _image(rng, np.uint16, 4, 17, 9)):
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER,
                                             getattr(cv2, f"IMWRITE_PNG_FILTER_{name}")])
        assert ok
        np.testing.assert_array_equal(decode_png(buf), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _hand_made_png(img, filters, idat_pieces=3):
    """A PNG of an (H, W, 3) uint8 BGR array whose row y uses filter
    filters[y % len(filters)], written byte by byte by the PNG
    specification, its zlib stream split over several IDAT chunks."""
    H, W, C = img.shape
    raw = img[..., ::-1].reshape(H, W * C).astype(np.int64)
    out = []
    for y in range(H):
        f = filters[y % len(filters)]
        row = [f]
        for i in range(W * C):
            a = raw[y, i - C] if i >= C else 0
            b = raw[y - 1, i] if y else 0
            c = raw[y - 1, i - C] if y and i >= C else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            row.append((raw[y, i] - pred) % 256)
        out.append(bytes(row))
    data = zlib.compress(b"".join(out), 9)
    chunk = lambda kind, d: (struct.pack(">I", len(d)) + kind + d
                             + struct.pack(">I", zlib.crc32(kind + d) & 0xFFFFFFFF))
    step = -(-len(data) // idat_pieces)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[k:k + step]) for k in range(0, len(data), step))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=PNG_FILTERS + ["mixed"])
def test_png_reads_hand_made_filters(rng, filters):
    """Files filtered by the specification's formulas, over several IDAT
    chunks: the port decodes what cv2 decodes."""
    img = _image(rng, np.uint8, 3, 11, 13)
    png = _hand_made_png(img, filters)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(png, np.uint8),
                                               cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(decode_png(png), img)


def test_png_refuses_corrupt_files(rng):
    png = encode_png(_image(rng, np.uint8, 3))
    for bad, match in ((png[:-20], "truncated"), (b"GIF89a" + png[6:], "signature"),
                       (png[:40] + bytes([png[40] ^ 1]) + png[41:], "CRC")):
        with pytest.raises(ValueError, match=match):
            decode_png(bad)


def _pack_samples(samples, depth):
    """(h, n) samples -> (h, rowbytes) uint8 rows at ``depth`` bits a sample
    (big-endian 16-bit, low depths most significant first, zero-padded)."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples.astype(np.int64), ((0, 0), (0, -n % per))).reshape(h, -1, per)
    out = np.zeros(s.shape[:2], np.int64)
    for k in range(per):
        out |= s[:, :, k] << (8 - depth * (k + 1))
    return out.astype(np.uint8)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _kind_png(samples, ctype, depth, interlace, rng, plte=None, trns=None):
    """A PNG of (H, W, samples a pixel) file-order samples of colour type
    ``ctype`` at ``depth`` bits, non-interlaced or Adam7 (each pass's rows
    packed and filtered on their own), every row with a random filter by the
    specification's formulas."""
    H, W, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_samples(sub.reshape(sub.shape[0], -1), depth).astype(np.int64)
        prev = np.zeros(rows.shape[1], np.int64)
        for r in rows:
            f = int(rng.integers(0, 5))
            line = [f]
            for i in range(len(r)):
                a = r[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                pred = [0, a, prev[i], (a + prev[i]) // 2, _paeth(a, prev[i], c)][f]
                line.append((r[i] - pred) % 256)
            raw.append(bytes(line))
            prev = r
    chunk = lambda kind, d: (struct.pack(">I", len(d)) + kind + d
                             + struct.pack(">I", zlib.crc32(kind + d) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                                              0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b"")


# name -> (colour type, depth, samples a pixel, palette, tRNS)
PNG_KINDS = {**{f"grey{d}": (0, d, 1, False, False) for d in (1, 2, 4, 8, 16)},
             **{f"palette{d}": (3, d, 1, True, False) for d in (1, 2, 4, 8)},
             **{f"palette{d}_trns": (3, d, 1, True, True) for d in (1, 2, 4, 8)},
             "grey_alpha8": (4, 8, 2, False, False), "grey_alpha16": (4, 16, 2, False, False),
             "rgb8": (2, 8, 3, False, False), "rgb8_trns": (2, 8, 3, False, True),
             "rgb16": (2, 16, 3, False, False), "rgba8": (6, 8, 4, False, False),
             "rgba16": (6, 16, 4, False, False)}


@pytest.mark.parametrize("interlace", [0, 1], ids=["non_interlaced", "adam7"])
@pytest.mark.parametrize("kind", list(PNG_KINDS))
def test_png_kinds_match_opencv_and_pil(kind, interlace):
    """Every PNG kind that libpng expands for OpenCV (palettes with and
    without tRNS, grey+alpha, 1/2/4-bit grey and palettes, Adam7) decodes bit
    for bit as ``cv2.imdecode`` gives it under IMREAD_UNCHANGED (decode_png)
    and under IMREAD_COLOR (to_bgr, what ``cv2.imread`` and ``io.image.imread``
    give), and as PIL's ``convert("RGB")`` (the JHMDB reader's form, JAX
    ``eval/tapvid.py:243``; the port's ``eval/tapvid.py _read_rgb``).

    cv2 and PIL disagree on 16-bit grey only: cv2 keeps the high byte, PIL
    clips at 255. Each reader follows the oracle its JAX call site uses:
    ``to_bgr``/``imread`` cv2 (every ``cv2.imread`` site), ``_read_rgb`` PIL
    (``Image.open`` at the JHMDB site)."""
    from PIL import Image

    from mft_tpu_torch.eval.tapvid import _read_rgb
    from mft_tpu_torch.io.png import to_bgr
    ctype, depth, spp, palette, trns = PNG_KINDS[kind]
    rng = np.random.default_rng(len(kind) * 2 + interlace)
    H, W = 13, 21
    samples = rng.integers(0, 1 << depth, (H, W, spp))
    plte = tr = None
    if palette:
        plte = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8).tobytes()
        if trns:
            tr = rng.integers(0, 256, max(1, (1 << depth) // 2)).astype(np.uint8).tobytes()
    elif trns:                              # an RGB key colour that some pixels have
        samples = rng.integers(0, 4, (H, W, spp))
        tr = struct.pack(">HHH", *map(int, samples[3, 5]))
    png = _kind_png(samples, ctype, depth, interlace, rng, plte, tr)
    buf = np.frombuffer(png, np.uint8)
    got = decode_png(png)
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_bgr(got), cv2.imdecode(buf, cv2.IMREAD_COLOR))
    pil = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    if kind == "grey16":
        assert not np.array_equal(pil[..., ::-1], to_bgr(got))     # the one disagreement
    else:
        np.testing.assert_array_equal(pil[..., ::-1], to_bgr(got))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.png")
        with open(path, "wb") as f:
            f.write(png)
        np.testing.assert_array_equal(_read_rgb(path), pil)


@pytest.mark.parametrize("mode", ["P", "P_transparency", "P1", "P2", "P4", "LA", "1", "L"])
def test_pil_written_png_kinds_match_opencv(rng, mode):
    """Files that PIL writes (palettes at 8 bits and packed into 1/2/4 bits,
    a palette with a transparent index, grey+alpha, 1-bit) decode as cv2 and
    PIL decode them."""
    from PIL import Image

    from mft_tpu_torch.io.png import to_bgr
    rgb = _image(rng, np.uint8, 3, 17, 29)
    kw = {}
    if mode.startswith("P"):
        colors = {"P1": 2, "P2": 4, "P4": 16}.get(mode, 256)
        im = Image.fromarray(rgb).quantize(colors)
        if mode in ("P1", "P2", "P4"):
            kw["bits"] = int(mode[1])
        if mode == "P_transparency":
            kw["transparency"] = 3
    elif mode == "LA":
        im = Image.fromarray(np.stack([rgb[..., 0], rgb[..., 1]], -1), "LA")
    else:
        im = Image.fromarray(rgb[..., 0]).convert(mode)
    out = io.BytesIO()
    im.save(out, "PNG", **kw)
    png = out.getvalue()
    buf = np.frombuffer(png, np.uint8)
    np.testing.assert_array_equal(decode_png(png), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(to_bgr(decode_png(png)), cv2.imdecode(buf, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(
        to_bgr(decode_png(png)), np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))[..., ::-1])


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_codec_files_decode_alike(tmp_path, rng, ext, writer):
    """A file either package writes decodes in both to the same arrays, bit
    for bit, within the format's quantisation of what was written."""
    flow, occl, sigma = make_fou(rng)
    path = tmp_path / f"pair{ext}"
    (jax_codecs if writer == "jax" else flowou_codecs).write_flowou(path, flow, occl, sigma)
    want = jax_codecs.read_flowou(path)
    got = flowou_codecs.read_flowou(path)
    for g, w, x in zip(got, want, (flow, occl, sigma)):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        step = 1 / 32 if ext == ".flowou.png" else 2e-4 * (x.max() - x.min()) + 2 ** -9
        np.testing.assert_allclose(g, x, atol=step)
    if ext.endswith(".pkl"):
        with open(path, "rb") as f:
            entry = pickle.load(f)["flow_x"]
        assert isinstance(entry["data"], np.ndarray) and entry["data"].dtype == np.uint8


def test_codec_takes_tensors_and_channel_first(tmp_path, rng):
    """Torch tensors and the reference's (2, H, W) / (1, H, W) layouts write
    the same file content as numpy channel-last arrays."""
    flow, occl, sigma = make_fou(rng)
    flowou_codecs.write_flowou(tmp_path / "a.flowouX16.pkl", flow, occl, sigma)
    flowou_codecs.write_flowou(tmp_path / "b.flowouX16.pkl",
                               torch.from_numpy(flow).permute(2, 0, 1),
                               torch.from_numpy(occl)[None], torch.from_numpy(sigma)[None])
    for x, y in zip(flowou_codecs.read_flowou(tmp_path / "a.flowouX16.pkl"),
                    flowou_codecs.read_flowou(tmp_path / "b.flowouX16.pkl")):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="suffix"):
        flowou_codecs.write_flowou(tmp_path / "c.flo", flow, occl, sigma)
    with pytest.raises(ValueError, match="range"):
        flowou_codecs.write_flowou(tmp_path / "d.flowou.png", flow * 100, occl, sigma)


def test_stepan16_export_matches_jax(tmp_path, rng):
    """The .stepan16 export: an N x 1 grey PNG of the inner PNG's bytes per
    flow channel (decoded twice, as its consumers do) and the limits."""
    flow, occl, sigma = make_fou(rng)
    jax_codecs.write_flowou(tmp_path / "j.stepan16", flow, occl, sigma)
    flowou_codecs.write_flowou(tmp_path / "t.stepan16", flow, occl, sigma)
    assert (tmp_path / "j_limits.txt").read_text() == (tmp_path / "t_limits.txt").read_text()
    for axis in ("x", "y"):
        outer = [cv2.imread(str(tmp_path / f"{w}_flow_{axis}.png"), cv2.IMREAD_UNCHANGED)
                 for w in "jt"]
        assert outer[1].shape[1] == 1 and outer[1].dtype == np.uint8
        inner = [cv2.imdecode(o.reshape(-1), cv2.IMREAD_UNCHANGED) for o in outer]
        np.testing.assert_array_equal(inner[1], inner[0])


def test_flowou_write_read(tmp_path, rng):
    """FlowOU.write / FlowOU.read through the codecs (float32 tensors)."""
    flow, occl, sigma = make_fou(rng)
    FlowOU(*(torch.from_numpy(x) for x in (flow, occl, sigma))).write(tmp_path / "r.flowouX32.pkl")
    back = FlowOU.read(tmp_path / "r.flowouX32.pkl")
    for got, want in zip((back.flow, back.occlusion, back.sigma),
                         jax_codecs.read_flowou(tmp_path / "r.flowouX32.pkl")):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# FlowCache
# --------------------------------------------------------------------------- #
def _fill(cache, rng, n=12, H=16, W=16, tensor=False):
    flow, occl, sigma = make_fou(rng, H=H, W=W)
    conv = torch.from_numpy if tensor else np.asarray
    for i in range(n):
        cache.write(i, i + 1, conv(flow + i), conv(occl), conv(sigma))
    return flow


def _state(cache):
    return (cache.hits, cache.misses, sorted(cache.device_cache), sorted(cache.ram_cache),
            cache.ram_bytes, sorted(p.name for p in cache.cache_dir.glob("*")))


def test_flow_cache_tiers_match_jax(tmp_path):
    """tests/test_io.py's tier sequence on both caches: RAM fills, the rest
    spills to disk, every entry reads back (disk reads promote into RAM),
    a missing pair misses; same counters, tiers and files."""
    caches = [cls(tmp_path / name, max_ram_mb=0.02, max_device_mb=0)
              for cls, name in ((JaxFlowCache, "jax"), (FlowCache, "port"))]
    reads = []
    for cache in caches:
        flow = _fill(cache, np.random.default_rng(3))
        assert cache.ram_bytes <= cache.max_ram_bytes
        before = _state(cache)
        got = [cache.read(i, i + 1) for i in range(12)]
        assert all(g is not None for g in got)
        np.testing.assert_allclose(got[7][0], flow + 7, atol=0.02)
        assert cache.read(99, 100) is None
        reads.append((before, _state(cache), [np.asarray(g[0]) for g in got]))
    (jb, ja, jr), (tb, ta, tr) = reads
    assert tb == jb and ta == ja and tb[5], "expected a disk spill"
    for x, y in zip(jr, tr):
        np.testing.assert_array_equal(x, y)


def test_flow_cache_contains_matches_jax(tmp_path):
    """contains() sees every tier without reading or promoting anything."""
    for cls, name in ((JaxFlowCache, "jax"), (FlowCache, "port")):
        cache = cls(tmp_path / name, max_ram_mb=0.02, max_device_mb=0)
        _fill(cache, np.random.default_rng(3))
        ram_before = list(cache.ram_cache)
        assert all(cache.contains(i, i + 1) for i in range(12))
        assert not cache.contains(99, 100)
        assert list(cache.ram_cache) == ram_before
        assert cache.hits == 0 and cache.misses == 0


def test_flow_cache_backup_and_reload_match_jax(tmp_path, rng):
    """backup_to_disk / load_from_disk / clear(remove_disk): each package
    reloads the other's backup to the same arrays."""
    flow, occl, sigma = make_fou(rng, H=8, W=8)
    j1, t1 = JaxFlowCache(tmp_path / "j", max_ram_mb=10), FlowCache(tmp_path / "t", max_ram_mb=10)
    j1.write(0, 1, flow, occl, sigma)
    t1.write(0, 1, torch.from_numpy(flow), torch.from_numpy(occl), torch.from_numpy(sigma))
    j1.backup_to_disk()
    t1.backup_to_disk()
    for src in ("j", "t"):
        j2, t2 = JaxFlowCache(tmp_path / src), FlowCache(tmp_path / src)
        j2.load_from_disk()
        t2.load_from_disk()
        for x, y in zip(j2.read(0, 1), t2.read(0, 1)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(t2.read(0, 1)[0], flow, atol=0.02)
    t2.clear(remove_disk=True)
    assert FlowCache(tmp_path / "t").read(0, 1) is None


def test_flow_cache_device_tier_holds_tensors(tmp_path):
    """Tensors fill the device tier (jax arrays do in the JAX cache) and read
    back as the same objects, with no copy; numpy values skip it."""
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    jc, tc = JaxFlowCache(None, max_device_mb=0.01), FlowCache(None, max_device_mb=0.01)
    flow, occl, sigma = make_fou(rng, H=16, W=16)
    for i in range(4):
        jc.write(i, i + 1, *(jnp.asarray(x) for x in (flow, occl, sigma)))
        tc.write(i, i + 1, *(torch.from_numpy(x) for x in (flow, occl, sigma)))
    jc.write(9, 10, flow, occl, sigma)
    tc.write(9, 10, flow, occl, sigma)
    assert sorted(tc.device_cache) == sorted(jc.device_cache) == [(0, 1), (1, 2)]
    assert sorted(tc.ram_cache) == sorted(jc.ram_cache) == [(2, 3), (3, 4), (9, 10)]
    assert tc.device_bytes == jc.device_bytes
    row = tc.read(0, 1)
    assert row is tc.device_cache[(0, 1)] and isinstance(row[0], torch.Tensor)
    assert isinstance(tc.read(3, 4)[0], np.ndarray)


def test_flow_cache_drops_undecodable_disk_entries(tmp_path, rng):
    """A disk entry that does not decode: contains() sees the file, read()
    misses and deletes it, so contains() agrees afterwards and a later
    write replaces it (the JAX cache keeps reporting such a file)."""
    cache = FlowCache(tmp_path / "c", max_ram_mb=0, max_device_mb=0)
    flow, occl, sigma = make_fou(rng, H=8, W=8)
    cache.write(0, 1, flow, occl, sigma)
    path = tmp_path / "c" / "0--1.flowouX16.pkl"
    path.write_bytes(path.read_bytes()[:60])
    assert cache.contains(0, 1)
    assert cache.read(0, 1) is None and (cache.hits, cache.misses) == (0, 1)
    assert not path.exists() and not cache.contains(0, 1)
    cache.write(0, 1, flow, occl, sigma)
    np.testing.assert_allclose(cache.read(0, 1)[0], flow, atol=0.02)
    jc = JaxFlowCache(tmp_path / "j", max_ram_mb=0, max_device_mb=0)
    jc.write(0, 1, flow, occl, sigma)
    jpath = tmp_path / "j" / "0--1.flowouX16.pkl"
    jpath.write_bytes(jpath.read_bytes()[:60])
    assert jc.read(0, 1) is None and jc.contains(0, 1)
