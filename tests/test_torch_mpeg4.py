"""The port's MPEG-4 Part 2 (mp4v) codec, ``mft_tpu_torch/io/mpeg4.py``,
against cv2's (libavcodec's) decoder on the CPU.

- The committed fixtures (written by the JAX package's ``VideoWriter``):
  every frame's Y plane (``CAP_PROP_CONVERT_RGB`` 0) and BGR frame equal
  cv2's, bit for bit, so the BGR gap is 0 and cannot grow across a GOP.
- Streams of seeded random syntax from the port's stream writer (1MV/4MV,
  not_coded, dquant, forced and decided ``ac_pred``, vectors past the
  picture, both rounding types, every DC threshold, 72x40 and 128x96)
  decode to cv2's Y planes and BGR frames; the plain decoder's counters
  show every code of every table used, and every escape mode of both
  TCOEF tables; DC sizes past 9, which libavcodec rejects for 8-bit
  video, raise.
- The syntax round trip, ``vop_coded`` 0 (no frame, as libavcodec), and
  each unsupported tool raising with its ROADMAP item.
- V1's native routines (``ops/csrc/mpeg4_vlc.cu``, host C++) compiled with
  g++ and a host mirror of the kernels' arithmetic (``ops/csrc/mpeg4.cuh``)
  bit for bit with the plain versions.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from mft_tpu_torch.io import mpeg4 as M
from mft_tpu_torch.io.mp4 import Mp4Writer, read_mp4
from mft_tpu_torch.ops import _build
from mft_tpu_torch.ops import mpeg4 as OM

FIXTURES = Path(__file__).parent / "data" / "torch_fixtures" / "mp4v"
CSRC = Path(__file__).resolve().parents[1] / "mft_tpu_torch" / "ops" / "csrc"
NAMES = ("pan", "noise", "still", "odd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def decode_planes(path, counts=None):
    """The plain decoder's packed planes of every coded VOP, and the geometry."""
    video = read_mp4(path)
    vol = M.parse_config(video.config)
    geom = M.Geometry(vol.width, vol.height)
    ref, out = None, []
    for data in video.read_samples():
        pos, _ = M.find_vop(data, vol)
        syn = M.vlc_decode_ref(data[pos:], vol, counts)
        if syn.coded:
            ref = M.decode_pixels_ref(syn.levels, syn.mode, syn.qp, syn.mv,
                                      ref if syn.kind == M.P_VOP else None, geom, syn.rounding)
            out.append(ref)
    return out, geom


def cv2_frames(path):
    """(Y planes, BGR frames) as cv2 decodes them."""
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    ys = []
    while True:
        ok, y = cap.read()
        if not ok:
            break
        ys.append(y.copy())
    cap = cv2.VideoCapture(str(path))
    bgr = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        bgr.append(f)
    return ys, bgr


def write_stream(path, vol, syns, stuffing=()):
    """VOPs of the port's stream writer in an MP4 file."""
    with Mp4Writer(path, 25.0, vol.width, vol.height, M.write_config(vol)) as w:
        for s in syns:
            w.add(M.vlc_encode_ref(s, vol, stuffing), s.kind == M.I_VOP)


def assert_frames_equal_cv2(path):
    planes, geom = decode_planes(path)
    ys, bgr = cv2_frames(path)
    assert len(planes) == len(ys) == len(bgr) > 0
    for k, (p, y, b) in enumerate(zip(planes, ys, bgr)):
        assert np.array_equal(geom.split(p)[0][:geom.H, :geom.W], y), f"Y of frame {k}"
        assert np.array_equal(M.yuv_to_bgr_ref(p, geom), b), f"BGR of frame {k}"


@pytest.mark.parametrize("name", NAMES)
def test_fixture_frames_equal_cv2(name):
    """Y planes and BGR frames bit for bit with cv2 over two GOP boundaries
    (26 frames): the pan's half-pel vectors of both rounding types and past
    the edge, the noise's escapes and quantisers 3-25, the still scene's
    not_coded MBs, and 72x40's MB cropping and edge (the coded size)."""
    assert_frames_equal_cv2(FIXTURES / f"{name}.mp4")


# (seed, width, height, VOP kinds, wild DC)
STREAMS = [(11, 128, 96, "0111111111", False), (12, 72, 40, "0111111111", False),
           (13, 72, 40, "000", True), (14, 128, 96, "0101111111", False),
           (15, 48, 32, "0111111", False)]


def _syntax(seed, W, H, kinds, wild):
    rng = np.random.default_rng(seed)
    vol = M.Vol(W, H, 25)
    return vol, [M.random_syntax(rng, vol, int(k), 0, i, wild_dc=wild)
                 for i, k in enumerate(kinds)]


@pytest.fixture(scope="module")
def coverage(tmp_path_factory):
    """Every random stream written and decoded by the plain decoder, its
    counters summed."""
    tmp = tmp_path_factory.mktemp("mpeg4")
    counts, paths = {}, []
    for seed, W, H, kinds, wild in STREAMS:
        vol, syns = _syntax(seed, W, H, kinds, wild)
        path = tmp / f"r{seed}.mp4"
        write_stream(path, vol, syns, stuffing=(0, 5))
        decode_planes(path, counts)
        paths.append(path)
    return counts, paths


@pytest.mark.parametrize("k", range(len(STREAMS)))
def test_random_streams_equal_cv2(coverage, k):
    assert_frames_equal_cv2(coverage[1][k])


def test_every_table_entry_is_covered(coverage):
    """Each code of MCBPC (I and P, stuffing included), CBPY, the DC sizes
    libavcodec takes (0-9), MVD and both TCOEF tables, and the three escapes
    of each TCOEF table, in the streams cv2 decodes as the port does."""
    counts = coverage[0]
    for name, codes, _ in M.TABLES:
        values = [v for v in codes if not (name.startswith("dc_") and v > 9)]
        missing = [v for v in values if (name, v) not in counts]
        assert not missing, (name, missing)
    for intra in (False, True):
        for mode in (1, 2, 3):
            assert counts.get(("escape", intra, mode), 0) > 0, (intra, mode)


def test_syntax_round_trip():
    """The writer's bytes decode to the syntax written (AC prediction as
    decided where it was -1; the chroma vector derived)."""
    for seed, W, H, kinds, wild in STREAMS[:2]:
        vol, syns = _syntax(seed, W, H, kinds, wild)
        for s in syns:
            got = M.vlc_decode_ref(M.vlc_encode_ref(s, vol)[4:], vol)
            assert np.array_equal(got.levels, s.levels) and np.array_equal(got.mode, s.mode)
            assert np.array_equal(got.qp, s.qp) and np.array_equal(got.mv, s.mv)
            forced = s.acpred >= 0
            assert np.array_equal(got.acpred[forced], s.acpred[forced])


def test_dc_sizes_past_nine_raise():
    """A DC difference of 10 or more bits: libavcodec's "illegal dc vlc"."""
    vol = M.Vol(16, 16, 25)
    syn = M.VopSyntax(1, [M.I_VOP, 1, 0, 2, 1, 0, 0, 0])
    syn.mode[:], syn.qp[:] = M.INTRA, 2
    syn.levels[0, :, 0] = 128
    syn.levels[0, 1, 0] = 128 + 700      # a difference of 10 bits
    data = M.vlc_encode_ref(syn, vol)
    with pytest.raises(ValueError, match="DC size 10"):
        M.vlc_decode_ref(data[4:], vol)


def test_not_coded_vop_gives_no_frame(tmp_path):
    rng = np.random.default_rng(3)
    vol = M.Vol(64, 48, 25)
    syns = [M.random_syntax(rng, vol, M.I_VOP), M.random_syntax(rng, vol, M.P_VOP, 0, 1),
            M.VopSyntax(12, [M.P_VOP, 0, 0, 0, 1, 0, 0, 2]),
            M.random_syntax(rng, vol, M.P_VOP, 0, 3)]
    write_stream(tmp_path / "s.mp4", vol, syns)
    assert_frames_equal_cv2(tmp_path / "s.mp4")
    from mft_tpu_torch.io import video
    assert video.get_video_length(tmp_path / "s.mp4", device="cpu") == 3


def _vol_bits(**over):
    """A VOL header's bytes with fields overridden (the fields this reader
    looks at, in order)."""
    f = dict(verid=1, shape=0, interlaced=0, sprite=0, not_8_bit=0, quant_type=0,
             quarter=0, complexity_disable=1, resync_disable=1, partitioned=0, scalability=0)
    f.update(over)
    bw = M.BitWriter()
    bw.put(32, 0x120)
    bw.put(1, 0)
    bw.put(8, 1)
    bw.put(1, 1)
    bw.put(4, f["verid"])
    bw.put(3, 1)
    bw.put(4, 1)
    bw.put(1, 0)
    bw.put(2, f["shape"])
    bw.put(1, 1)
    bw.put(16, 25)
    bw.put(1, 1)
    bw.put(1, 0)
    for v in (1, 64, 1, 48, 1):
        bw.put(13 if v > 1 else 1, v)
    bw.put(1, f["interlaced"])
    bw.put(1, 1)
    bw.put(1 if f["verid"] == 1 else 2, f["sprite"])
    bw.put(1, f["not_8_bit"])
    if f["not_8_bit"]:
        bw.put(4, 5)
        bw.put(4, 10)
    bw.put(1, f["quant_type"])
    if f["verid"] != 1:
        bw.put(1, f["quarter"])
    bw.put(1, f["complexity_disable"])
    bw.put(1, f["resync_disable"])
    bw.put(1, f["partitioned"])
    if f["verid"] != 1:
        bw.put(2, 0)
    bw.put(1, f["scalability"])
    bw.stuff()
    return bw.getvalue()


@pytest.mark.parametrize("field,value,match", [
    ("interlaced", 1, "interlaced.*Advanced Simple"),
    ("shape", 2, "non-rectangular.*error resilience"),
    ("not_8_bit", 1, "bits a sample.*error resilience"),
    ("quant_type", 1, "MPEG quantization.*error resilience"),
    ("sprite", 1, "GMC.*Advanced Simple"),
    ("partitioned", 1, "data partitioning.*error resilience"),
    ("scalability", 1, "scalability.*error resilience"),
    ("complexity_disable", 0, "complexity.*error resilience"),
])
def test_unsupported_vol_tools_raise(field, value, match):
    assert M.parse_config(_vol_bits()).width == 64
    with pytest.raises(ValueError, match=match):
        M.parse_config(_vol_bits(**{field: value}))


def test_quarter_pel_raises():
    with pytest.raises(ValueError, match="quarter-pel.*Advanced Simple"):
        M.parse_config(_vol_bits(verid=2, quarter=1))


@pytest.mark.parametrize("kind,match", [(2, "B-VOPs.*Advanced Simple"),
                                        (3, "S-VOPs.*Advanced Simple")])
def test_b_and_s_vops_raise(kind, match):
    vol = M.Vol(64, 48, 25)
    bw = M.BitWriter()
    M.write_vop_header(bw, vol, [kind, 1, 0, 4, 1, 0, 0, 0])
    bw.stuff()
    with pytest.raises(ValueError, match=match):
        M.vlc_decode_ref(bw.getvalue()[4:], vol)


def test_short_header_and_resync_markers_raise():
    vol = M.Vol(64, 48, 25)
    with pytest.raises(ValueError, match="short header.*error resilience"):
        M.find_vop(b"\x00\x00\x80\x02" + bytes(8), vol)
    # a VOL with resync markers on, and a VOP with a video packet after MB 0
    vol_r = M.parse_config(_vol_bits(resync_disable=0))
    assert vol_r.resync
    syn = M.VopSyntax(12, [M.I_VOP, 1, 0, 4, 1, 0, 0, 0])
    syn.mode[:], syn.qp[:] = M.INTRA, 4
    syn.levels[:, :, 0] = 128
    bw = M.BitWriter()
    M.write_vop_header(bw, vol_r, syn.header)
    bw.code(M.MCBPC_I[12])
    bw.put(1, 0)
    bw.code(M.CBPY[0])
    for n in range(6):
        bw.code((M.DC_LUM if n < 4 else M.DC_CHROM)[0])
    bw.stuff()
    bw.put(17, 1)                        # resync_marker
    bw.stuff()
    with pytest.raises(ValueError, match="resync markers.*error resilience"):
        M.vlc_decode_ref(bw.getvalue()[4:] + bytes(16), vol_r)


# --------------------------------------------------------------------------- #
# the native code, compiled for the host
# --------------------------------------------------------------------------- #
def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the native code for the host")
    return gxx


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """csrc/mpeg4_vlc.cu (host-only C++) compiled with g++, in the place of
    the nvcc-built library for V1's native routines."""
    tmp = tmp_path_factory.mktemp("native")
    lib_path = tmp / "vlc.so"
    subprocess.run([_gxx(), "-O2", "-shared", "-fPIC", "-x", "c++",
                    str(CSRC / "mpeg4_vlc.cu"), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("mft_mpeg4_vlc_decode", "mft_mpeg4_vlc_encode"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture()
def native_v1(native, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: native)


def _streams(coverage):
    for path in [FIXTURES / f"{n}.mp4" for n in NAMES] + list(coverage[1]):
        video = read_mp4(path)
        vol = M.parse_config(video.config)
        for data in video.read_samples():
            yield vol, data[M.find_vop(data, vol)[0]:]


def test_native_vlc_matches_plain(native_v1, coverage):
    """V1's native decoder gives the plain version's syntax arrays and its
    writer the plain writer's bytes, on the fixtures and the random streams;
    the encoder's syntax (AC prediction decided) too."""
    n = 0
    for vol, data in _streams(coverage):
        want = M.vlc_decode_ref(data, vol)
        got = OM.vlc_decode_native(data, vol)
        assert want.equal(got)
        assert OM.vlc_encode_native(want, vol, (0, 3)) == M.vlc_encode_ref(want, vol, (0, 3))
        n += 1
    assert n > 100
    geom = M.Geometry(72, 40)
    rng = np.random.default_rng(9)
    frame = (rng.random((40, 72, 3)) * 255).astype(np.uint8)
    for kind in (M.I_VOP, M.P_VOP):
        ref = None if kind == M.I_VOP else M.decode_pixels_ref(
            M.encode_pixels_ref(frame, None, 2, geom), np.full(geom.nmb, M.INTRA),
            np.full(geom.nmb, 2), np.zeros((geom.nmb, 5, 2)), None, geom, 0)
        syn = M.encoder_syntax(M.encode_pixels_ref(frame[::-1].copy(), ref, 2, geom), kind, 2,
                               1, 0)
        vol = M.Vol(72, 40, 25)
        assert OM.vlc_encode_native(syn, vol) == M.vlc_encode_ref(syn, vol)


def test_native_errors_match_plain(native_v1):
    vol = M.Vol(16, 16, 25)
    syn = M.VopSyntax(1, [M.I_VOP, 1, 0, 2, 1, 0, 0, 0])
    syn.mode[:], syn.qp[:] = M.INTRA, 2
    syn.levels[0, :, 0] = 128
    syn.levels[0, 1, 0] = 828
    data = M.vlc_encode_ref(syn, vol)[4:]
    for decode in (M.vlc_decode_ref, OM.vlc_decode_native):
        with pytest.raises(ValueError, match="DC size"):
            decode(data, vol)
    bw = M.BitWriter()
    M.write_vop_header(bw, vol, [2, 1, 0, 4, 1, 0, 0, 0])
    bw.stuff()
    for decode in (M.vlc_decode_ref, OM.vlc_decode_native):
        with pytest.raises(ValueError, match="B-VOPs"):
            decode(bw.getvalue()[4:], vol)


_MIRROR = r'''
#include "mpeg4.cuh"
extern "C" {
void reconstruct(const int* geom, const int16_t* levels, const int8_t* mode, const int8_t* qp,
                 const int16_t* mv, const uint8_t* ref, int rounding, uint8_t* out, uint8_t* bgr) {
  mp4v::Geom g{geom[0], geom[1], geom[2], geom[3]};
  for (long t = 0; t < 6L * g.mbw * g.mbh; ++t)
    mp4v::reconstruct_block(g, levels, mode, qp, mv, ref ? ref : out, rounding, out, t);
  for (long t = 0; t < (long)g.W * g.H; ++t) mp4v::colour_pixel(g, out, bgr, t);
}
void encode(const int* geom, const uint8_t* bgr, const uint8_t* ref, int qp, int16_t* levels) {
  mp4v::Geom g{geom[0], geom[1], geom[2], geom[3]};
  for (long t = 0; t < 6L * g.mbw * g.mbh; ++t) mp4v::encode_block(g, bgr, ref, qp, levels, t);
}
}
'''


def test_kernel_mirror_matches_plain(tmp_path, coverage):
    """csrc/mpeg4.cuh compiled for the host and driven thread by thread, as
    the kernels drive it: V2's planes and BGR frames and V3's levels (intra,
    and inter against the previous planes) bit for bit with the plain
    versions over the fixtures and the random streams."""
    (tmp_path / "mirror.cpp").write_text(_MIRROR)
    subprocess.run([_gxx(), "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                    str(tmp_path / "mirror.cpp"), "-o", str(tmp_path / "m.so")], check=True)
    lib = ctypes.CDLL(str(tmp_path / "m.so"))
    P = ctypes.c_void_p
    lib.reconstruct.argtypes = [P] * 6 + [ctypes.c_int, P, P]
    lib.encode.argtypes = [P, P, P, ctypes.c_int, P]
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    paths = [FIXTURES / f"{n}.mp4" for n in NAMES] + list(coverage[1])
    for path in paths:
        video = read_mp4(path)
        vol = M.parse_config(video.config)
        geom = M.Geometry(vol.width, vol.height)
        ref = None
        for data in video.read_samples():
            syn = M.vlc_decode_ref(data[M.find_vop(data, vol)[0]:], vol)
            if not syn.coded:
                continue
            r = ref if syn.kind == M.P_VOP else None
            want = M.decode_pixels_ref(syn.levels, syn.mode, syn.qp, syn.mv, r, geom,
                                       syn.rounding)
            got = np.zeros(geom.size, np.uint8)
            bgr = np.zeros((geom.H, geom.W, 3), np.uint8)
            lib.reconstruct(ptr(geom.vector()), ptr(syn.levels), ptr(syn.mode), ptr(syn.qp),
                            ptr(syn.mv), ptr(r), syn.rounding, ptr(got), ptr(bgr))
            assert np.array_equal(got, want), path.name
            assert np.array_equal(bgr, M.yuv_to_bgr_ref(want, geom)), path.name
            img = np.ascontiguousarray(bgr)
            for rr, qp in ((None, 2), (ref, 5), (ref, 31)):
                lv = np.zeros((geom.nmb, 6, 64), np.int16)
                lib.encode(ptr(geom.vector()), ptr(img), ptr(rr), qp, ptr(lv))
                assert np.array_equal(lv, M.encode_pixels_ref(img, rr, qp, geom)), path.name
            ref = want


def test_encoder_closed_loop(tmp_path):
    """The encoder's reconstruction is V2's decode of what it wrote: cv2 and
    the port read back equal frames, and an I-VOP every 12 frames."""
    rng = np.random.default_rng(5)
    tex = cv2.GaussianBlur((rng.random((80, 120, 3)) * 255).astype(np.uint8), (0, 0), 2)
    frames = [np.ascontiguousarray(tex[k:k + 48, 2 * k:2 * k + 72]) for k in range(14)]
    enc = M.Mp4vEncoder(tmp_path / "e.mp4", 25.0, 72, 48, device="cpu")
    recon = []
    for f in frames:
        enc.write(f)
        recon.append(M.yuv_to_bgr_ref(enc.ref.numpy(), enc.geom))
    enc.close()
    video = read_mp4(tmp_path / "e.mp4")
    assert video.samples[:, 2].tolist() == [1] + [0] * 11 + [1, 0]
    _, bgr = cv2_frames(tmp_path / "e.mp4")
    assert len(bgr) == 14
    assert all(np.array_equal(a, b) for a, b in zip(recon, bgr))
    assert_frames_equal_cv2(tmp_path / "e.mp4")
