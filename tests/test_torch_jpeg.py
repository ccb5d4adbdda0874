"""The port's JPEG codec (``mft_tpu_torch/io/jpeg.py``) and what stands on it,
against the JAX package's OpenCV and PIL readers, on the CPU (plain versions).

- decode: ``decode_jpeg(device="cpu")`` and ``flow_readers.read_image`` bit
  for bit with ``cv2.imdecode`` / JAX's ``read_image`` (``cv2.imread``) over
  qualities x samplings x sizes x restart intervals, PIL's optimized
  Huffman tables, EXIF orientation, several scans;
- encode: the port's bytes equal ``cv2.imencode``'s (``encode_jpeg`` at
  cv2's default 4:2:0, its steps at every other sampling and with restarts),
  and ``cv2.imdecode`` of them equals the port's decode and
  ``jpeg_roundtrip``;
- refusals: arithmetic-coded, CMYK and corrupt files (a DC Huffman symbol over
  15 among them, which cv2 refuses too) raise ``ValueError``;
- ``jpeg_corrupt``, the jpeg-transform augmenters and ``BlendAugmenter``
  against JAX's; Kinetics shards and mixed PNG/JPEG directories against
  JAX's loaders;
- the native code's arithmetic compiled for the host with g++ (where the
  machine has one): the entropy coder J1 and the pixel kernels' per-thread
  steps (``csrc/jpeg.cuh``) in the kernels' order, bit for bit with the
  plain versions.
"""

import ctypes
import io
import os
import pickle
import shutil
import subprocess

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mft_tpu.eval import tapvid as jax_tapvid
from mft_tpu.io import video as jax_video
from mft_tpu.train import augment as jaug
from mft_tpu.train import flow_readers as jfr
from mft_tpu_torch.eval import tapvid
from mft_tpu_torch.io import jpeg as J
from mft_tpu_torch.io import video
from mft_tpu_torch.io.image import imread
from mft_tpu_torch.ops import _build
from mft_tpu_torch.ops import jpeg as OJ
from mft_tpu_torch.train import augment as taug
from mft_tpu_torch.train import flow_readers as tfr

CSRC = os.path.join(os.path.dirname(_build.__file__), "csrc")
SAMPLING = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(1, 1), (7, 9), (37, 53), (127, 65), (96, 128)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops: the suite runs 6
    xdist workers, and each one's default thread pool (every core)
    oversubscribes the CPU; at these sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(rng, H, W, grey=False):
    """Blurred noise: smooth areas and edges, every coefficient band used."""
    img = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    if H > 2 and W > 2:
        img = cv2.GaussianBlur(img, (5, 5), 1.2)
    return np.ascontiguousarray(img[..., 0]) if grey else img


def _cv2_encode(img, quality, sampling, rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if sampling != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _encode(img, quality, sampling, rst=0):
    """encode_jpeg's steps (J3, J1, the header) at any sampling and restart
    interval, plain versions; the entry point writes cv2's default, 4:2:0
    without restarts."""
    img = img[..., None] if img.ndim == 2 else img
    geom = J.geometry_for(*img.shape, sampling)
    qtabs, recips = J._tables(geom, quality)
    coefs = OJ.jpeg_encode_pixels(torch.from_numpy(img[None]), torch.from_numpy(recips),
                                  geom)[0].numpy()
    mcux, mcuy = J.scan_mcus(geom)
    body = OJ.jpeg_huff_encode(coefs, J.encode_comp_info(geom), J.STD_CODE_TABLES, mcux, mcuy,
                               rst, "cpu")
    return J.file_header(geom, qtabs, rst) + body + b"\xff\xd9"


def _roundtrip(img, quality, sampling):
    """jpeg_roundtrip's steps (J3 then J2) at any sampling, plain versions."""
    geom = J.geometry_for(*img.shape, sampling)
    qtabs, recips = J._tables(geom, quality)
    coefs = OJ.jpeg_encode_pixels(torch.from_numpy(img[None]), torch.from_numpy(recips), geom)
    return OJ.jpeg_decode_pixels(coefs, torch.from_numpy(qtabs[None]), geom)[0].numpy()


@pytest.mark.parametrize("quality", [15, 18, 25, 50, 75, 95])
@pytest.mark.parametrize("sampling", ["411", "420", "422", "440", "444", "grey"])
def test_decode_and_encode_match_opencv(tmp_path, quality, sampling):
    """Every size and restart interval: the port's decode of cv2's file
    equals cv2.imdecode and JAX's read_image (cv2.imread, RGB); the port's
    encoder writes cv2's bytes; jpeg_roundtrip gives the decoded pixels."""
    rng = np.random.default_rng(quality * 7 + len(sampling))
    for H, W in SIZES:
        for rst in (0, 3):
            img = _image(rng, H, W, grey=sampling == "grey")
            data = _cv2_encode(img, quality, sampling, rst)
            want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            got = J.decode_jpeg(data, device="cpu")
            assert got.dtype == np.uint8 and np.array_equal(got, want), (H, W, rst)
            path = tmp_path / f"{H}x{W}_{rst}.jpg"
            path.write_bytes(data)
            assert np.array_equal(tfr.read_image(path, device="cpu"), jfr.read_image(path))
            mine = _encode(img, quality, "420" if sampling == "grey" else sampling, rst)
            assert mine == data, (H, W, rst)
            if sampling in ("420", "grey") and rst == 0:     # the entry point's own
                assert J.encode_jpeg(img, quality, device="cpu") == data, (H, W)
            if sampling != "grey":
                assert np.array_equal(_roundtrip(img, quality, sampling), want), (H, W, rst)
            if sampling == "420":
                assert np.array_equal(J.jpeg_roundtrip(img, quality, device="cpu"), want)


def test_pil_files_and_several_scans():
    """PIL's optimized Huffman tables and its 4:4:4 and 4:2:2 files; a
    sequential file written one scan a component (libjpeg's jpegtran
    layout, built here from the port's own scans)."""
    rng = np.random.default_rng(3)
    img = _image(rng, 61, 77)
    for kw in (dict(quality=80, optimize=True), dict(quality=60, subsampling=0, optimize=True),
               dict(quality=90, subsampling=1)):
        buf = io.BytesIO()
        Image.fromarray(img[..., ::-1]).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        assert np.array_equal(J.decode_jpeg(data, device="cpu"), want), kw
    # three single-component scans of a 4:4:4 file, cv2 decodes it too
    data = _encode(img, 85, "444")
    jf = J.parse_jpeg(data)
    coefs = np.zeros((jf.geom.blocks, 64), np.int16)
    J.huff_decode_ref(jf.scans[0], coefs)
    head = data[:data.index(b"\xff\xda")]
    scans = b""
    for c in range(3):
        info = J.encode_comp_info(jf.geom)[c:c + 1].copy()
        info[0, :2] = 1
        body = J.huff_encode_ref(coefs, info, J.STD_CODE_TABLES, jf.geom.rbw[c], jf.geom.rbh[c])
        sos = bytes([1, c + 1, 0x11 * min(c, 1), 0, 63, 0])
        scans += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos + body
    multi = head + scans + b"\xff\xd9"
    want = cv2.imdecode(np.frombuffer(multi, np.uint8), cv2.IMREAD_COLOR)
    assert len(J.parse_jpeg(multi).scans) == 3
    assert np.array_equal(J.decode_jpeg(multi, device="cpu"), want)
    assert np.array_equal(want, J.decode_jpeg(data, device="cpu"))


@pytest.mark.parametrize("marker", ["adobe", "ids"])
def test_rgb_coded_files_as_opencv(marker):
    """A 3-component file coded as R, G, B (no colour transform), known by
    an Adobe marker with transform 0 or by the component ids 'R', 'G', 'B'
    (libjpeg's rule): the port's decode equals cv2's."""
    rng = np.random.default_rng(12)
    img = _image(rng, 29, 45)[..., ::-1]                    # RGB
    grey = J.geometry_for(29, 45, 1)
    qtabs, recips = J._tables(grey, 60)
    planes = [J.encode_pixels_ref(np.ascontiguousarray(img[None, ..., c:c + 1]), recips, grey)[0]
              for c in range(3)]
    geom = J.Geometry(29, 45, [(1, 1)] * 3, J.RGB)
    info = np.array([[1, 1, 0, 4, geom.bw[c], geom.boff[c], geom.rbw[c], geom.rbh[c]]
                     for c in range(3)], np.int32)
    body = J.huff_encode_ref(np.concatenate(planes), info, J.STD_CODE_TABLES, geom.mcux, geom.mcuy)
    seg = lambda m, p: bytes((0xFF, m)) + (len(p) + 2).to_bytes(2, "big") + p
    ids = (82, 71, 66) if marker == "ids" else (1, 2, 3)
    head = b"\xff\xd8"
    if marker == "adobe":
        head += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    head += seg(0xDB, b"\x00" + qtabs[0][J.ZIGZAG].astype(np.uint8).tobytes())
    head += seg(0xC0, bytes((8, 0, 29, 0, 45, 3)) + b"".join(bytes((i, 0x11, 0)) for i in ids))
    for cls in (0, 1):
        bits, vals = J.STD_HUFF[(cls, 0)]
        head += seg(0xC4, bytes([cls << 4]) + bytes(bits) + bytes(vals))
    head += seg(0xDA, bytes([3]) + b"".join(bytes((i, 0)) for i in ids) + b"\x00\x3f\x00")
    data = head + body + b"\xff\xd9"
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = J.decode_jpeg(data, device="cpu")
    assert J.parse_jpeg(data).geom.color == J.RGB
    assert np.array_equal(got, want)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_opencv(tmp_path, orientation):
    """cv2.imread turns by the EXIF tag; the PIL role (Kinetics) does not."""
    img = _image(np.random.default_rng(orientation), 20, 40)
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(buf, "JPEG", exif=exif, quality=85)
    path = tmp_path / "o.jpg"
    path.write_bytes(buf.getvalue())
    got = imread(path, device="cpu")
    assert np.array_equal(got, cv2.imread(str(path)))
    assert np.array_equal(tfr.read_image(path, device="cpu"), jfr.read_image(path))
    pil = np.asarray(Image.open(path))
    assert np.array_equal(J.decode_jpeg_frames([buf.getvalue()], "cpu", orient=False,
                                               rgb=True)[0], pil)


def test_opencv_reads_the_port_encoder(tmp_path):
    """cv2.imdecode of the port's bytes equals the port's decode of them,
    grey and every sampling, at odd sizes."""
    rng = np.random.default_rng(11)
    for sampling in SAMPLING:
        for H, W in ((33, 47), (64, 80)):
            img = _image(rng, H, W)
            data = _encode(img, 70, sampling)
            want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            assert np.array_equal(J.decode_jpeg(data, device="cpu"), want)
    grey = _image(rng, 30, 50, grey=True)
    data = J.encode_jpeg(grey, 40, device="cpu")
    assert np.array_equal(J.decode_jpeg(data, device="cpu"),
                          cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def test_unsupported_files_raise():
    img = _image(np.random.default_rng(2), 24, 32)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    # progressive files decode (tests/test_torch_jpeg_progressive.py); an
    # arithmetic-coded one (its SOF2 made SOF10) is refused
    with pytest.raises(ValueError, match="arithmetic progressive"):
        J.decode_jpeg(buf.getvalue().replace(b"\xff\xc2", b"\xff\xca", 1), device="cpu")
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="4-component"):
        J.decode_jpeg(buf.getvalue(), device="cpu")
    with pytest.raises(ValueError, match="not a JPEG"):
        J.decode_jpeg(b"\x89PNG....", device="cpu")
    data = _cv2_encode(img, 90, "420")
    sof = data.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="truncated"):
        J.decode_jpeg(data[:sof + 8], device="cpu")
    with pytest.raises(ValueError, match="cut short"):       # a SOF too short for its comps
        J.decode_jpeg(data[:sof + 2] + b"\x00\x08" + data[sof + 4:sof + 10], device="cpu")
    with pytest.raises(ValueError, match="12-bit"):
        J.decode_jpeg(data.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c"), "cpu")
    with pytest.raises(ValueError, match="bad DHT"):          # a DC symbol over 15
        J.decode_jpeg(_bad_dc_table(data), device="cpu")
    assert cv2.imdecode(np.frombuffer(_bad_dc_table(data), np.uint8), cv2.IMREAD_COLOR) is None
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            J.decode_jpeg(data)


def _bad_dc_table(data):
    """The file with the first DHT's last DC symbol (a bit count, at most
    15) raised to 200."""
    at = data.index(b"\xff\xc4")
    assert data[at + 4] == 0                              # class 0 (DC), slot 0
    end = at + 21 + sum(data[at + 5:at + 21])
    return data[:end - 1] + bytes([200]) + data[end:]


@pytest.mark.parametrize("severity", [1, 2, 3])
def test_jpeg_corrupt_matches_jax(severity):
    rng = np.random.default_rng(severity)
    for H, W in ((37, 53), (64, 96), (50, 71), (16, 16)):
        img = _image(rng, H, W)
        want = jaug.jpeg_corrupt(img, severity)
        got = taug.jpeg_corrupt(img, severity, device="cpu")
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_jpeg_transform_augmenters_match_jax(seed):
    """FlowAugmenter and SparseFlowAugmenter with do_jpeg_transform: the
    same draws and the same images, bit for bit."""
    rng = np.random.default_rng(100 + seed)
    img1, img2 = _image(rng, 60, 90), _image(rng, 60, 90)
    flow = (rng.standard_normal((60, 90, 2)) * 3).astype(np.float32)
    for jcls, tcls in ((jaug.FlowAugmenter, taug.FlowAugmenter),
                       (jaug.SparseFlowAugmenter, taug.SparseFlowAugmenter)):
        ja = jcls((40, 64), seed=seed, do_jpeg_transform=True, jpeg_prop=0.8)
        ta = tcls((40, 64), seed=seed, do_jpeg_transform=True, jpeg_prop=0.8, device="cpu")
        want = ja(img1.copy(), img2.copy(), flow.copy())
        got = ta(img1.copy(), img2.copy(), flow.copy())
        for w, g in zip(want[:2], got[:2]):
            assert np.array_equal(w, g)
        np.testing.assert_allclose(got[2], want[2], atol=1e-4)
        assert ja.rng.random() == ta.rng.random()


@pytest.fixture(scope="module")
def blend_dir(tmp_path_factory):
    """A larger PNG and a smaller JPEG source (in a subdirectory), and a file
    that is no image."""
    d = tmp_path_factory.mktemp("blend")
    rng = np.random.default_rng(7)
    (d / "sub").mkdir()
    cv2.imwrite(str(d / "big.png"), (rng.random((150, 220, 3)) * 255).astype(np.uint8))
    cv2.imwrite(str(d / "sub" / "small.jpg"), _image(rng, 30, 40))
    (d / "notes.txt").write_text("not an image")
    return d


@pytest.mark.parametrize("seed", range(8))
def test_blend_augmenter_matches_jax(blend_dir, seed):
    """Within 1 level on at most 0.1% of the values (the float32 resize and
    blend may round apart); the following draw equal."""
    rng = np.random.default_rng(seed)
    img1, img2 = _image(rng, 64, 96), _image(rng, 64, 96)
    j = jaug.BlendAugmenter(str(blend_dir), blend_prop=0.9, rng=np.random.default_rng(seed))
    t = taug.BlendAugmenter(str(blend_dir), blend_prop=0.9, rng=np.random.default_rng(seed),
                            device="cpu")
    assert j.image_list == t.image_list and len(t.image_list) == 3
    for w, g in zip(j(img1, img2), t(img1, img2)):
        d = np.abs(w.astype(np.int16) - g)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert j.rng.random() == t.rng.random()


@pytest.mark.parametrize("src,dst", [((150, 220), (64, 96)), ((128, 192), (64, 96)),
                                     ((30, 40), (64, 96)), ((80, 50), (64, 96)),
                                     ((64, 96), (64, 96))])
def test_area_resize_of_floats_matches_opencv(src, dst):
    a = (np.random.default_rng(1).random((*src, 3)) * 255).astype(np.float32)
    want = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(taug._resize_area_float(a, *dst), want)


def _kinetics_shard(path, rng):
    """Two records of JPEG frames as PIL writes them: colour frames with an
    EXIF-tagged one among them, and an all-grey record."""
    colour, grey = [], []
    for k in range(3):
        img = _image(rng, 36, 48)
        buf = io.BytesIO()
        kw = {"exif": Image.Exif()} if k == 1 else {}
        if k == 1:
            kw["exif"][0x0112] = 6
        Image.fromarray(img).save(buf, "JPEG", quality=80, **kw)
        colour.append(buf.getvalue())
        buf = io.BytesIO()
        Image.fromarray(img[..., 1]).save(buf, "JPEG", quality=70)
        grey.append(buf.getvalue())
    pts = rng.random((5, 3, 2))
    occ = rng.random((5, 3)) > 0.7
    with open(path, "wb") as f:
        pickle.dump([{"video": colour, "points": pts, "occluded": occ},
                     {"video": grey, "points": pts, "occluded": occ}], f)


def test_kinetics_shard_matches_jax(tmp_path):
    _kinetics_shard(tmp_path / "shard7.pkl", np.random.default_rng(5))
    want = jax_tapvid.load_pickle_sequences(tmp_path / "shard7.pkl")
    got = tapvid.load_pickle_sequences(tmp_path / "shard7.pkl", device="cpu")
    assert list(got) == list(want) == ["kin-shard7-0000", "kin-shard7-0001"]
    for name in want:
        assert got[name]["video"].shape == want[name]["video"].shape
        assert np.array_equal(got[name]["video"], want[name]["video"])
        assert np.array_equal(got[name]["points"], want[name]["points"])


def test_mixed_image_directory_matches_jax(tmp_path):
    """PNG and JPEG frames (cv2-written, EXIF-tagged among them) in one
    directory: the frames JAX's reader gives, in its order."""
    rng = np.random.default_rng(9)
    d = tmp_path / "frames"
    d.mkdir()
    cv2.imwrite(str(d / "00.png"), _image(rng, 24, 32))
    cv2.imwrite(str(d / "01.jpg"), _image(rng, 24, 32), [cv2.IMWRITE_JPEG_QUALITY, 60])
    exif = Image.Exif()
    exif[0x0112] = 3
    Image.fromarray(_image(rng, 24, 32)).save(d / "02.JPEG", "JPEG", exif=exif)
    for reverse in (False, True):
        want = list(jax_video.get_video_frames(d, reverse=reverse))
        got = list(video.get_video_frames(d, reverse=reverse, device="cpu"))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the native code for the host")
    return gxx


def test_entropy_host_code_matches_plain(tmp_path):
    """csrc/jpeg_entropy.cu (host-only C++) compiled with g++: the same
    coefficients from cv2's files (restarts, every sampling, truncated data)
    and the same bytes from them as the Python plain versions."""
    lib_path = tmp_path / "libj1.so"
    subprocess.run([_gxx(), "-O2", "-shared", "-fPIC", "-x", "c++",
                    os.path.join(CSRC, "jpeg_entropy.cu"), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("mft_jpeg_huff_decode", "mft_jpeg_huff_encode"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    saved = _build._lib
    _build._lib = lib
    try:
        rng = np.random.default_rng(4)
        for sampling in list(SAMPLING) + ["grey"]:
            for rst in (0, 2):
                img = _image(rng, 37, 53, grey=sampling == "grey")
                data = _cv2_encode(img, 30, sampling, rst)
                jf = J.parse_jpeg(data)
                scan = jf.scans[0]
                for cut in (len(scan.data) // 3, len(scan.data)):   # the full scan last
                    part = J.Scan(scan.data[:cut], scan.comp_info, scan.luts, scan.mcux,
                                  scan.mcuy, scan.restart)
                    a = np.zeros((jf.geom.blocks, 64), np.int16)
                    b = a.copy()
                    OJ.jpeg_huff_decode(part, a, "cpu")
                    OJ.jpeg_huff_decode(part, b, "cuda")
                    assert np.array_equal(a, b), (sampling, rst, cut)
                mcux, mcuy = J.scan_mcus(jf.geom)
                args = (a, J.encode_comp_info(jf.geom), J.STD_CODE_TABLES, mcux, mcuy, rst)
                assert OJ.jpeg_huff_encode(*args, "cuda") == OJ.jpeg_huff_encode(*args, "cpu") \
                    == scan.data
        # a DC table whose symbols are over 15: both refuse it
        luts = scan.luts.copy()
        luts[0] = np.where(luts[0] > 0, (luts[0] & 0xFF00) | 200, 0)
        bad = J.Scan(scan.data, scan.comp_info, luts, scan.mcux, scan.mcuy, scan.restart)
        for device in ("cuda", "cpu"):
            with pytest.raises(ValueError, match="bad Huffman code"):
                OJ.jpeg_huff_decode(bad, np.zeros_like(a), device)
    finally:
        _build._lib = saved


MIRROR = r"""
#include "jpeg.cuh"
using jpeg::Geom;
// the kernels' two passes, thread by thread, in their order (jpeg.cu)
extern "C" void dec(const long long* geom, int N, const int16_t* coefs, const int32_t* qtabs,
                    uint8_t* planes, uint8_t* out) {
  Geom g = jpeg::read_geom(geom);
  for (long long blk = 0; blk < N * g.blocks; blk++) {
    int ws[64];
    long long n = blk / g.blocks, b = blk - n * g.blocks;
    int c = jpeg::component_of(g, b);
    const int16_t* in = coefs + blk * 64;
    const int32_t* q = qtabs + (n * g.ncomp + c) * 64;
    for (int lane = 0; lane < 8; lane++) {
      long long x[8]; int o[8];
      for (int k = 0; k < 8; k++) x[k] = (long long)in[k * 8 + lane] * q[k * 8 + lane];
      jpeg::idct_1d(x, 11, o);
      for (int k = 0; k < 8; k++) ws[k * 8 + lane] = o[k];
    }
    for (int lane = 0; lane < 8; lane++) {
      long long x[8]; int o[8];
      for (int k = 0; k < 8; k++) x[k] = ws[lane * 8 + k];
      jpeg::idct_1d(x, 18, o);
      long long lb = b - g.boff[c], by = lb / g.bw[c], bx = lb - by * g.bw[c];
      uint8_t* dst = planes + n * g.samples + g.poff[c] + (by * 8 + lane) * (g.bw[c] * 8LL) + bx * 8;
      for (int k = 0; k < 8; k++) dst[k] = jpeg::range_limit(o[k]);
    }
  }
  long long hw = (long long)g.H * g.W;
  for (long long t = 0; t < N * hw; t++) {
    long long n = t / hw, rem = t - n * hw;
    int y = rem / g.W, x = rem - (long long)y * g.W, v[3], bgr[3];
    for (int c = 0; c < g.ncomp; c++)
      v[c] = jpeg::upsample(planes + n * g.samples + g.poff[c], g.bw[c] * 8, g, c, y, x);
    if (g.color == jpeg::GREY) bgr[0] = bgr[1] = bgr[2] = v[0];
    else if (g.color == jpeg::RGB) { bgr[0] = v[2]; bgr[1] = v[1]; bgr[2] = v[0]; }
    else jpeg::ycc_to_bgr(v[0], v[1], v[2], bgr);
    for (int k = 0; k < 3; k++) out[t * 3 + k] = bgr[k];
  }
}
extern "C" void enc(const long long* geom, int N, int C, const uint8_t* img,
                    const int32_t* recips, int16_t* coefs) {
  Geom g = jpeg::read_geom(geom);
  for (long long blk = 0; blk < N * g.blocks; blk++) {
    int ws[64];
    long long n = blk / g.blocks, b = blk - n * g.blocks;
    int c = jpeg::component_of(g, b);
    long long lb = b - g.boff[c];
    int by = lb / g.bw[c], bx = lb - (long long)by * g.bw[c];
    const uint8_t* frame = img + n * g.H * (long long)g.W * C;
    for (int lane = 0; lane < 8; lane++) {
      int d[8], o[8];
      for (int k = 0; k < 8; k++) d[k] = jpeg::downsample(frame, C, g, c, by * 8 + lane, bx * 8 + k) - 128;
      jpeg::fdct_1d(d, true, o);
      for (int k = 0; k < 8; k++) ws[lane * 8 + k] = o[k];
    }
    for (int lane = 0; lane < 8; lane++) {
      int d[8], o[8];
      for (int k = 0; k < 8; k++) d[k] = ws[k * 8 + lane];
      jpeg::fdct_1d(d, false, o);
      const int32_t* r = recips + c * 192;
      for (int k = 0; k < 8; k++) {
        int i = k * 8 + lane;
        coefs[blk * 64 + i] = (int16_t)jpeg::quantize(o[k], r[i], r[64 + i], r[128 + i]);
      }
    }
  }
}
"""


def test_pixel_kernel_arithmetic_matches_plain(tmp_path):
    """csrc/jpeg.cuh compiled for the host, driven thread by thread in the
    kernels' order: J3's coefficients and J2's pixels equal the plain
    versions' at every sampling, grey, odd sizes and 1 x 1, and on wild
    coefficients and 16-bit tables (the range limit's wrap, the casts)."""
    (tmp_path / "mirror.cpp").write_text(MIRROR)
    lib_path = tmp_path / "libmirror.so"
    subprocess.run([_gxx(), "-O2", "-shared", "-fPIC", "-I", CSRC, str(tmp_path / "mirror.cpp"),
                    "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P = lambda a: ctypes.c_void_p(a.ctypes.data)
    rng = np.random.default_rng(6)
    for H, W in ((1, 1), (2, 3), (17, 40), (37, 53)):
        for sampling in list(SAMPLING) + ["grey"]:
            N, C = 2, 1 if sampling == "grey" else 3
            img = np.ascontiguousarray((rng.random((N, H, W, 3)) * 255).astype(np.uint8)[..., :C])
            geom = J.geometry_for(H, W, C, sampling if C == 3 else "420")
            qtabs, recips = J._tables(geom, 35)
            gv = geom.vector()
            want = J.encode_pixels_ref(img, recips, geom)
            got = np.zeros_like(want)
            lib.enc(P(gv), N, C, P(img), P(np.ascontiguousarray(recips)), P(got))
            assert np.array_equal(got, want), (H, W, sampling)
            coefs = want.copy()
            coefs[1] += rng.integers(-3, 4, coefs[1].shape).astype(np.int16)
            q = np.ascontiguousarray(np.broadcast_to(qtabs, (N,) + qtabs.shape))
            want = J.decode_pixels_ref(coefs, q, geom)
            planes = np.zeros((N, geom.samples), np.uint8)
            got = np.zeros((N, H, W, 3), np.uint8)
            lib.dec(P(gv), N, P(coefs), P(q), P(planes), P(got))
            assert np.array_equal(got, want), (H, W, sampling)
    geom = J.geometry_for(16, 16, 3, "444")
    coefs = rng.integers(-32768, 32768, (1, geom.blocks, 64)).astype(np.int16)
    q = rng.integers(1, 65536, (1, 3, 64)).astype(np.int32)
    planes, got = np.zeros((1, geom.samples), np.uint8), np.zeros((1, 16, 16, 3), np.uint8)
    lib.dec(P(geom.vector()), 1, P(coefs), P(q), P(planes), P(got))
    assert np.array_equal(got, J.decode_pixels_ref(coefs, q, geom))
