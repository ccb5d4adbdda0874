"""The port's Motion JPEG decoder, ``mft_tpu_torch/io/mjpeg.py``, against
``cv2.VideoCapture`` (libavcodec's mjpegdec and swscale) on the CPU.

- The committed MJPEG fixtures (cv2's writer in AVI, Matroska, MP4 and
  QuickTime; the port's AVI muxer over ``cv2.imencode`` frames at 4:2:2,
  4:4:4, grey, and without DHT) decode to cv2's frames with a gap of 0, and
  to the hashes recorded for the card's machine.
- C11: cv2's ``MJPG`` writer into ``.mp4`` stores JPEG under an ``mp4v``
  entry of object type 0x6C; the port reads it as cv2 does.
- Samplings, sizes, qualities, restart intervals, tables kept from frame to
  frame, camera frames (AVI1, no JFIF, no DHT), EXIF orientation (not
  applied, as cv2 here), dropped frames and the AVI tags of MJPEG,
  each against cv2; the kinds the port does not match raise ``ValueError``
  naming their ROADMAP item.
- J4's plain version, and a host mirror of its arithmetic
  (``ops/csrc/mjpeg.cuh``) compiled with g++, bit for bit with each other
  on the fixtures and on random coefficients at int16's edges.
"""

import ctypes
import json
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mft_tpu.io import video as jax_video
from mft_tpu_torch.io import jpeg as J
from mft_tpu_torch.io import mjpeg as MJ
from mft_tpu_torch.io import video
from mft_tpu_torch.io.avi import AviWriter
from mft_tpu_torch.io.container import open_track
from mft_tpu_torch.ops import mjpeg as OMJ

DATA = Path(__file__).parent / "data" / "torch_fixtures"
CSRC = Path(__file__).resolve().parents[1] / "mft_tpu_torch" / "ops" / "csrc"
MJPEG_FIXTURES = ("mjpg.avi", "mjpg.mkv", "mjpg.mp4", "mjpg.mov", "mjpg422.avi",
                  "mjpg444.avi", "grey.avi", "nodht.avi")
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


def port_frames(path):
    return list(video.get_video_frames(path, device="cpu"))


def assert_equal_cv2(path, n=None):
    want, got = cv2_frames(path), port_frames(path)
    assert len(got) == len(want) > 0 and (n is None or len(got) == n)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), f"frame {k}: gap " \
            f"{int(np.abs(a.astype(int) - b).max()) if a.shape == b.shape else 'shape'}"
    assert video.get_video_length(path, device="cpu") == len(want)


def scene(H, W, n=3, seed=0, noise=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(n):
        f = np.stack([(2 * xx + 9 * t) % 256, (yy + xx) % 256, (255 - xx - yy + 5 * t) % 256], -1)
        out.append(np.clip(f + rng.integers(-noise, noise + 1, f.shape), 0, 255)
                   .astype(np.uint8))
    return out


def encode(frame, sampling="420", quality=90, extra=()):
    if sampling == "grey":
        return cv2.imencode(".jpg", cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
                            [cv2.IMWRITE_JPEG_QUALITY, quality, *extra])[1].tobytes()
    return cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                        *extra])[1].tobytes()


def mjpeg_avi(path, jpegs, W, H, fourcc=b"MJPG"):
    with AviWriter(path, 25.0, W, H, fourcc) as w:
        for data in jpegs:
            w.add(data, True)
    return path


def strip_dht(jpeg: bytes) -> bytes:
    out, pos = bytearray(jpeg[:2]), 2
    while jpeg[pos + 1] != 0xDA:
        size = 2 + struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        if jpeg[pos + 1] != 0xC4:
            out += jpeg[pos:pos + size]
        pos += size
    return bytes(out + jpeg[pos:])


# --------------------------------------------------------------------------- #
# fixtures and C11
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", MJPEG_FIXTURES)
def test_fixture_frames_equal_cv2(name):
    import chip_smoke
    path = DATA / "video" / name
    assert_equal_cv2(path, 6)
    want = json.loads((DATA / "hashes.json").read_text())["video"][f"video/{name}"]
    assert [chip_smoke.array_hash(f) for f in port_frames(path)] == want["bgr"]
    track = open_track(path)
    assert track.codec == "mjpeg" and track.fps == want["fps"]
    assert [track.width, track.height] == want["size"]


def test_mjpeg_in_mp4_reads_as_cv2(tmp_path):
    """C11: cv2 writes MJPG into .mp4 under an 'mp4v' sample entry whose esds
    objectTypeIndication is 0x6C (JPEG); the port decoded it as MPEG-4 Part 2
    and raised 'MPEG-4 sample without a VOP'."""
    frames = scene(48, 64, 4, seed=3)
    path = tmp_path / "c11.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (64, 48))
    for f in frames:
        w.write(f)
    w.release()
    data = path.read_bytes()
    assert b"mp4v" in data and b"jpeg" not in data
    track = open_track(path)
    assert (track.codec, track.fourcc) == ("mjpeg", "mp4v")
    cap = video.GeneralVideoCapture(path, device="cpu")
    ok, first = cap.read()
    cap.release()
    assert ok and np.array_equal(first, cv2_frames(path)[0])
    assert_equal_cv2(path, 4)
    assert all(np.array_equal(a, b) for a, b in zip(port_frames(path),
                                                     jax_video.get_video_frames(path)))


def test_other_mp4_object_types_and_mjpb_raise(tmp_path):
    data = (DATA / "video" / "mjpg.mp4").read_bytes()
    i = data.index(b"esds")
    j = data.index(bytes([0x04]), i + 12)          # DecoderConfigDescriptor
    k = j + 1
    while data[k] & 0x80:
        k += 1
    assert data[k + 1] == 0x6C
    (tmp_path / "h264.mp4").write_bytes(data[:k + 1] + b"\x21" + data[k + 2:])
    with pytest.raises(NotImplementedError, match="A11, other codecs"):
        video.GeneralVideoCapture(tmp_path / "h264.mp4", device="cpu")
    mov = (DATA / "video" / "mjpg.mov").read_bytes()
    i = mov.index(b"jpeg", mov.index(b"stsd"))
    (tmp_path / "b.mov").write_bytes(mov[:i] + b"mjpb" + mov[i + 4:])
    with pytest.raises(NotImplementedError, match="A11, other codecs"):
        video.GeneralVideoCapture(tmp_path / "b.mov", device="cpu")
    (tmp_path / "a.mov").write_bytes(mov[:i] + b"mjpa" + mov[i + 4:])
    assert all(np.array_equal(a, b) for a, b in zip(port_frames(tmp_path / "a.mov"),
                                                     cv2_frames(DATA / "video" / "mjpg.mov")))


# --------------------------------------------------------------------------- #
# samplings, sizes, tables against cv2
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sampling", ["420", "422", "444", "grey"])
@pytest.mark.parametrize("H,W", [(48, 64), (40, 70), (34, 118), (8, 8), (48, 63), (34, 117)])
def test_samplings_equal_cv2(tmp_path, sampling, H, W):
    frames = scene(H, W, 2, seed=H + W)
    path = mjpeg_avi(tmp_path / "s.avi", [encode(f, sampling) for f in frames], W, H)
    assert_equal_cv2(path, 2)


@pytest.mark.parametrize("sampling,H,W", [("444", 37, 53), ("grey", 45, 61), ("444", 9, 7)])
def test_odd_heights_of_full_chroma_and_grey_equal_cv2(tmp_path, sampling, H, W):
    frames = scene(H, W, 2, seed=5)
    assert_equal_cv2(mjpeg_avi(tmp_path / "o.avi", [encode(f, sampling) for f in frames], W, H))


@pytest.mark.parametrize("quality", [10, 50, 95, 100])
def test_qualities_equal_cv2(tmp_path, quality):
    frames = scene(48, 64, 2, seed=quality, noise=90)
    assert_equal_cv2(mjpeg_avi(tmp_path / "q.avi", [encode(f, "420", quality) for f in frames],
                               64, 48))


def test_restart_intervals_and_optimized_tables_equal_cv2(tmp_path):
    frames = scene(48, 64, 3, seed=7)
    jpegs = [encode(frames[0], "420", 80, (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)),
             encode(frames[1], "422", 80, (cv2.IMWRITE_JPEG_OPTIMIZE, 1)),
             encode(frames[2], "420", 80, (cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
                                           cv2.IMWRITE_JPEG_OPTIMIZE, 1))]
    assert_equal_cv2(mjpeg_avi(tmp_path / "r.avi", jpegs, 64, 48), 3)


def test_tables_are_kept_from_frame_to_frame(tmp_path):
    """A frame without DHT decodes with the tables of the last DHT before it
    (optimized ones here, which Annex K's would not decode), as mjpegdec
    keeps them; a first frame without DHT takes Annex K's."""
    f = scene(48, 64, 1, seed=8)[0]
    opt = encode(f, "420", 75, (cv2.IMWRITE_JPEG_OPTIMIZE, 1))
    std = encode(f, "420", 75)
    path = mjpeg_avi(tmp_path / "t.avi", [strip_dht(std), opt, strip_dht(opt)], 64, 48)
    got = port_frames(path)
    assert_equal_cv2(path, 3)
    assert np.array_equal(got[1], got[2])
    try:            # alone, the optimized frame meets Annex K's tables
        alone = port_frames(mjpeg_avi(tmp_path / "u.avi", [strip_dht(opt)], 64, 48))[0]
    except ValueError:
        alone = None
    assert alone is None or not np.array_equal(alone, got[2])


def camera(jpeg: bytes, polarity=0) -> bytes:
    """A frame as UVC cameras write it: an AVI1 APP0 (polarity, field
    sizes) in place of JFIF's, no DHT."""
    j = strip_dht(jpeg)
    avi1 = b"AVI1" + bytes([polarity, 0]) + struct.pack(">II", len(j), len(j))
    out, pos = bytearray(j[:2] + b"\xff\xe0" + struct.pack(">H", len(avi1) + 2) + avi1), 2
    while j[pos + 1] != 0xDA:
        size = 2 + struct.unpack(">H", j[pos + 2:pos + 4])[0]
        if j[pos + 1] != 0xE0:
            out += j[pos:pos + size]
        pos += size
    return bytes(out + j[pos:])


@pytest.mark.parametrize("sampling,restart", [("420", 0), ("422", 0), ("422", 3)])
def test_camera_frames_equal_cv2(tmp_path, sampling, restart):
    frames = scene(48, 64, 3, seed=14)
    jpegs = [camera(encode(f, sampling, 80, (cv2.IMWRITE_JPEG_RST_INTERVAL, restart)))
             for f in frames]
    assert b"AVI1" in jpegs[0] and b"JFIF" not in jpegs[0] and b"\xff\xc4" not in jpegs[0]
    assert_equal_cv2(mjpeg_avi(tmp_path / "c.avi", jpegs, 64, 48), 3)


def test_exif_orientation_is_not_applied(tmp_path):
    f = scene(48, 64, 1, seed=9)[0]
    data = encode(f)
    exif = (b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08" + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0) + bytes(4))
    turned = data[:2] + b"\xff\xe1" + struct.pack(">H", len(exif) + 2) + exif + data[2:]
    assert J.parse_jpeg(turned).orientation == 6
    path = mjpeg_avi(tmp_path / "e.avi", [turned], 64, 48)
    assert port_frames(path)[0].shape == (48, 64, 3)
    assert_equal_cv2(path, 1)


def test_dropped_frames_give_no_frame(tmp_path):
    frames = scene(48, 64, 3, seed=10)
    jpegs = [encode(f) for f in frames]
    path = mjpeg_avi(tmp_path / "d.avi", [jpegs[0], b"", jpegs[1], b"", jpegs[2]], 64, 48)
    assert_equal_cv2(path, 3)


@pytest.mark.parametrize("tag", [b"MJPG", b"mjpg", b"AVRn", b"dmb1", b"AVDJ", b"MJPA", b"jpeg",
                                 b"JPGL", b"LJPG", b"SLMJ", b"CJPG", b"IJPG", b"ACDV", b"QIVG"])
def test_avi_mjpeg_tags_equal_cv2(tmp_path, tag):
    frames = scene(32, 48, 2, seed=11)
    assert_equal_cv2(mjpeg_avi(tmp_path / "g.avi", [encode(f) for f in frames], 48, 32, tag), 2)


# --------------------------------------------------------------------------- #
# kinds that raise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sampling,H", [("420", 47), ("422", 33), ("411", 48), ("440", 48)])
def test_unmatched_samplings_raise(tmp_path, sampling, H):
    frames = scene(H, 64, 1, seed=12)
    path = mjpeg_avi(tmp_path / "x.avi", [encode(f, sampling) for f in frames], 64, H)
    with pytest.raises(ValueError, match="A11, other MJPEG kinds"):
        port_frames(path)


def test_progressive_interlaced_and_arithmetic_raise(tmp_path):
    f = scene(48, 64, 1, seed=13)[0]
    prog = encode(f, "420", 90, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    with pytest.raises(ValueError, match="progressive MJPEG.*A11, other MJPEG kinds"):
        port_frames(mjpeg_avi(tmp_path / "p.avi", [prog], 64, 48))
    field = encode(f[::2])                              # 24 rows in a 48-row stream
    with pytest.raises(ValueError, match="interlaced MJPEG.*A11, other MJPEG kinds"):
        port_frames(mjpeg_avi(tmp_path / "i.avi", [field], 64, 48))
    base = encode(f)
    sof = base.index(b"\xff\xc0")
    arith = base[:sof + 1] + b"\xc9" + base[sof + 2:]
    with pytest.raises(ValueError, match="arithmetic-coded MJPEG.*A11, other MJPEG kinds"):
        port_frames(mjpeg_avi(tmp_path / "a.avi", [arith], 64, 48))


# --------------------------------------------------------------------------- #
# J4: its plain version and a host mirror of its arithmetic
# --------------------------------------------------------------------------- #
def _coefs(path):
    """(JpegFile, coefficients) of every frame of a fixture."""
    huff, qt = MJ.default_tables(), {}
    out = []
    for data in open_track(path).read_samples():
        jf = MJ.parse_frame(data, huff, qt)
        co = np.zeros((jf.geom.blocks, 64), np.int16)
        for scan in jf.scans:
            J.huff_decode_ref(scan, co)
        out.append((jf, co))
    return out


def test_wrapper_on_cpu_is_the_plain_version():
    for jf, co in _coefs(DATA / "video" / "mjpg422.avi")[:2]:
        got = OMJ.mjpeg_decode_pixels(torch.from_numpy(co[None]),
                                      torch.from_numpy(jf.qtabs[None].astype(np.int32)), jf.geom)
        assert np.array_equal(got.numpy(), MJ.decode_pixels_ref(co[None], jf.qtabs[None],
                                                                jf.geom))
    assert OMJ.mjpeg_decode_pixels.launches == 0


_MIRROR = r'''
#include "mjpeg.cuh"
extern "C" void run(const long* gv, int N, const int16_t* coefs, const int32_t* q,
                    uint8_t* planes, uint8_t* bgr) {
  mjpg::Geom g = mjpg::read_geom(gv);
  for (long t = 0; t < N * g.blocks; ++t) mjpg::block_samples(g, coefs, q, planes, t);
  for (long t = 0; t < (long)N * g.H * g.W; ++t) mjpg::bgr_pixel(g, planes, bgr, t);
}
'''


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic for the host")
    tmp = tmp_path_factory.mktemp("mjpeg_mirror")
    (tmp / "mirror.cpp").write_text(_MIRROR)
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-I", str(CSRC), str(tmp / "mirror.cpp"),
                    "-o", str(tmp / "m.so")], check=True)
    lib = ctypes.CDLL(str(tmp / "m.so"))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    return lib


def _mirror_run(lib, co, q, geom):
    N = co.shape[0]
    gv = MJ.geometry_vector(geom)
    co, q = np.ascontiguousarray(co, np.int16), np.ascontiguousarray(q, np.int32)
    planes = np.zeros((N, geom.samples), np.uint8)
    bgr = np.zeros((N, geom.H, geom.W, 3), np.uint8)
    lib.run(gv.ctypes.data, N, co.ctypes.data, q.ctypes.data, planes.ctypes.data,
            bgr.ctypes.data)
    return planes, bgr


@pytest.mark.parametrize("name", MJPEG_FIXTURES)
def test_kernel_mirror_matches_plain_on_fixtures(mirror, name):
    """csrc/mjpeg.cuh driven thread by thread as J4's kernels drive it, over
    a batch of every frame of the fixture: planes and BGR bit for bit."""
    frames = _coefs(DATA / "video" / name)
    geom = frames[0][0].geom
    co = np.stack([c for _, c in frames])
    q = np.stack([jf.qtabs for jf, _ in frames])
    planes, bgr = _mirror_run(mirror, co, q, geom)
    assert np.array_equal(planes, MJ.samples_ref(co, q, geom))
    assert np.array_equal(bgr, MJ.decode_pixels_ref(co, q, geom))
    assert np.array_equal(bgr, np.stack(cv2_frames(DATA / "video" / name)))


@pytest.mark.parametrize("kind", ["420", "422", "444", "grey"])
@pytest.mark.parametrize("W", [42, 41])
def test_kernel_mirror_matches_plain_at_int16_edges(mirror, kind, W):
    """Random coefficients up to int16's edges and tables up to 16 bits: the
    DC clip, the AC wrap and the IDCT's wrapping arithmetic as the plain
    version has them; an odd width's last chroma column too."""
    factors = {"420": [(2, 2), (1, 1), (1, 1)], "422": [(2, 1), (1, 1), (1, 1)],
               "444": [(1, 1)] * 3, "grey": [(1, 1)]}[kind]
    geom = J.Geometry(30, W, factors, J.GREY if kind == "grey" else J.YCC)
    rng = np.random.default_rng(len(kind))
    co = rng.integers(-40, 41, (3, geom.blocks, 64)).astype(np.int16)
    co[0, :, 0] = rng.integers(-32768, 32768, geom.blocks)
    co[1, rng.random((geom.blocks, 64)) < 0.05] = 32767
    q = rng.integers(1, 256, (3, geom.ncomp, 64)).astype(np.int32)
    q[2] = rng.integers(1, 65536, (geom.ncomp, 64))
    planes, bgr = _mirror_run(mirror, co, q, geom)
    assert np.array_equal(planes, MJ.samples_ref(co, q, geom))
    assert np.array_equal(bgr, MJ.decode_pixels_ref(co, q, geom))
