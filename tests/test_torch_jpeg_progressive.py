"""Progressive (SOF2) JPEG in the port's codec (``mft_tpu_torch/io/jpeg.py``)
against OpenCV, PIL and the JAX package's readers, on the CPU (plain
versions), and the native progressive entropy decoder
(``ops/csrc/jpeg_entropy.cu mft_jpeg_huff_decode_progressive``) compiled
for the host with g++ against its plain version.

- decode: ``decode_jpeg(device="cpu")`` bit for bit with ``cv2.imdecode``
  and with PIL over 4:2:0, 4:2:2, 4:4:4 and grey, odd sizes, a restart
  interval, a flat image (long EOB runs), qualities 50 and 95, files that
  cv2 and PIL write (libjpeg's progression scripts: DC first and
  refinement, AC first and refinement scans);
- refusals: a scan whose parameters break T.81 G.1.1.1, a scan whose data
  runs out, a truncated file and one whose scans leave bits unsent (block
  smoothing) raise ``ValueError``;
- batching: ``decode_jpeg_frames`` over baseline and progressive frames of
  one geometry equals decoding each alone; JAX's frame-directory reader
  (``cv2.imread``) and the port's give the same frames.
"""

import ctypes
import io
import os
import shutil
import subprocess

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mft_tpu.io import video as jax_video
from mft_tpu_torch.io import jpeg as J
from mft_tpu_torch.io import video
from mft_tpu_torch.io.image import imread
from mft_tpu_torch.ops import _build
from mft_tpu_torch.ops import jpeg as OJ

CSRC = os.path.join(os.path.dirname(_build.__file__), "csrc")
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's CPU torch ops (6 xdist workers
    share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(rng, H, W, grey=False, flat=False):
    """Blurred noise (every coefficient band used), or one flat colour."""
    if flat:
        img = np.empty((H, W, 3), np.uint8)
        img[:] = (90, 140, 200)
    else:
        img = cv2.GaussianBlur((rng.random((H, W, 3)) * 255).astype(np.uint8), (5, 5), 1.2)
    return np.ascontiguousarray(img[..., 0]) if grey else img


def _cv2_progressive(img, quality=90, sampling="420", rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _pil_progressive(img, quality=90, sampling="420"):
    out = io.BytesIO()
    kw = {"subsampling": PIL_SUBSAMPLING[sampling]} if img.ndim == 3 else {}
    Image.fromarray(img[..., ::-1] if img.ndim == 3 else img).save(
        out, "JPEG", quality=quality, progressive=True, **kw)
    return out.getvalue()


def _assert_decodes_as_oracles(data):
    jf = J.parse_jpeg(data)
    assert all(scan.progressive for scan in jf.scans) and len(jf.scans) > 1
    got = J.decode_jpeg(data, device="cpu")
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert got.shape == want.shape and np.array_equal(got, want)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]
    assert np.array_equal(got, pil)


@pytest.mark.parametrize("size", [(37, 53), (96, 128)], ids=["37x53", "96x128"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["420", "422", "444", "grey"])
@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_progressive_decodes_as_opencv_and_pil(writer, sampling, quality, size):
    img = _image(np.random.default_rng(quality + size[0]), *size, grey=sampling == "grey")
    make = _cv2_progressive if writer == "cv2" else _pil_progressive
    _assert_decodes_as_oracles(make(img, quality, sampling))


@pytest.mark.parametrize("rst", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["420", "444", "grey"])
def test_progressive_restart_intervals(sampling, rst):
    """A restart interval clears the DC predictions and the EOB run of every
    kind of scan; single-component scans count blocks, interleaved ones
    MCUs."""
    img = _image(np.random.default_rng(rst), 45, 61, grey=sampling == "grey")
    _assert_decodes_as_oracles(_cv2_progressive(img, 75, sampling, rst))


@pytest.mark.parametrize("rst", [0, 2])
def test_progressive_flat_image_long_eob_runs(rst):
    """A flat image: after the DC scans every AC band is one long EOB run
    (EOBn symbols with appended bits) over the component's blocks."""
    img = _image(None, 128, 128, flat=True)
    data = _cv2_progressive(img, 95, "420", rst)
    _assert_decodes_as_oracles(data)
    scan = next(s for s in J.parse_jpeg(data).scans if s.ss > 0)
    intervals = -(-scan.mcux * scan.mcuy // rst) if rst else 1
    # the band of the component's 16x16 blocks: one EOB run, a code of a
    # byte or two, each restart interval (a restart marker after each)
    assert len(scan.data) <= 3 * intervals + 2


def _entropy_lib(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the native code for the host")
    lib_path = tmp_path / "libj1.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-x", "c++",
                    os.path.join(CSRC, "jpeg_entropy.cu"), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("mft_jpeg_huff_decode", "mft_jpeg_huff_decode_progressive"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def test_progressive_host_code_matches_plain(tmp_path):
    """csrc/jpeg_entropy.cu's progressive routine compiled with g++: the
    same coefficients as the Python plain version, scan by scan, over every
    sampling, restart intervals, a flat image and PIL's files; both refuse a
    scan whose data runs out and a code the table does not hold."""
    saved = _build._lib
    _build._lib = _entropy_lib(tmp_path)
    try:
        rng = np.random.default_rng(8)
        files = [_cv2_progressive(_image(rng, 37, 53, grey=s == "grey"), 60, s, rst)
                 for s in ("420", "422", "444", "grey") for rst in (0, 2)]
        files += [_cv2_progressive(_image(rng, 64, 64, flat=True), 95, "420", 0),
                  _pil_progressive(_image(rng, 40, 24), 80, "420")]
        for data in files:
            jf = J.parse_jpeg(data)
            a = np.zeros((jf.geom.blocks, 64), np.int16)
            b = a.copy()
            for scan in jf.scans:        # every intermediate state, not only the last
                OJ.jpeg_huff_decode_progressive(scan, a, "cpu")
                OJ.jpeg_huff_decode_progressive(scan, b, "cuda")
                assert np.array_equal(a, b), (scan.ss, scan.se, scan.ah, scan.al)
        # a DC refinement (raw bits, one a block) cut to a quarter; an AC
        # scan whose tables hold no code
        scan = next(s for s in jf.scans if s.ss == 0 and s.ah > 0)
        short = J.Scan(scan.data[:len(scan.data) // 4], scan.comp_info, scan.luts, scan.mcux,
                       scan.mcuy, scan.restart, True, scan.ss, scan.se, scan.ah, scan.al)
        scan = next(s for s in jf.scans if s.ss > 0)
        bad = J.Scan(scan.data, scan.comp_info, np.zeros_like(scan.luts), scan.mcux, scan.mcuy,
                     scan.restart, True, scan.ss, scan.se, scan.ah, scan.al)
        for device in ("cpu", "cuda"):
            out = np.zeros((jf.geom.blocks, 64), np.int16)
            with pytest.raises(ValueError, match="ran out"):
                OJ.jpeg_huff_decode_progressive(short, out, device)
            with pytest.raises(ValueError, match="bad Huffman code"):
                OJ.jpeg_huff_decode_progressive(bad, out, device)
    finally:
        _build._lib = saved


def _segments(data):
    """[(marker, payload)] of a file's marker segments up to the first SOS,
    then the SOS segments with their entropy-coded data, then EOI."""
    out, pos = [], 2
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            break
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        body = b""
        if m == 0xDA:
            end = J._scan_end(data, pos)
            body, pos = data[pos:end], end
        out.append((m, seg, body))
    return out


def _join(segments):
    return b"\xff\xd8" + b"".join(bytes((0xFF, m)) + (len(seg) + 2).to_bytes(2, "big") + seg
                                  + body for m, seg, body in segments) + b"\xff\xd9"


def test_progressive_refusals():
    data = _cv2_progressive(_image(np.random.default_rng(3), 40, 56), 85, "420")
    segs = _segments(data)
    assert _join(segs) == data
    sos = [i for i, (m, _, _) in enumerate(segs) if m == 0xDA]
    # truncated: cut inside the last scan (cv2 gives None for it)
    for cut in (len(data) // 2, len(data) - 2):
        assert cv2.imdecode(np.frombuffer(data[:cut], np.uint8), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="truncated"):
            J.decode_jpeg(data[:cut], device="cpu")
    # incompletely refined: without the last scan (luma's lowest AC bit), so
    # libjpeg would smooth the blocks
    with pytest.raises(ValueError, match="leave coefficient bits unsent"):
        J.decode_jpeg(_join(segs[:sos[-1]] + segs[sos[-1] + 1:]), device="cpu")
    with pytest.raises(ValueError, match="leave coefficient bits unsent"):   # DC only
        J.decode_jpeg(_join(segs[:sos[0] + 1]), device="cpu")
    # corrupt: scan parameters that break G.1.1.1, and a scan whose data runs out

    def with_params(i, ss=None, se=None, ahal=None, ns=None):
        m, seg, body = segs[i]
        seg = bytearray(seg)
        k = 1 + 2 * seg[0]
        for off, val in ((0, ss), (1, se), (2, ahal)):
            if val is not None:
                seg[k + off] = val
        return _join(segs[:i] + [(m, bytes(seg), body)] + segs[i + 1:])

    ac = next(i for i in sos if segs[i][1][1 + 2 * segs[i][1][0]] > 0)
    for bad in (with_params(sos[0], se=5),            # a DC band with Se > 0
                with_params(ac, ss=9, se=3),          # Ss > Se
                with_params(ac, se=64),               # Se past the block
                with_params(ac, ahal=0x20),           # refinement with Al != Ah - 1
                with_params(sos[0], ahal=0x0E)):      # Al over 13
        with pytest.raises(ValueError, match="invalid progressive scan"):
            J.decode_jpeg(bad, device="cpu")
    with pytest.raises(ValueError, match="out of order"):        # a band sent twice
        J.decode_jpeg(_join(segs[:ac + 1] + [segs[ac]] + segs[ac + 1:]), device="cpu")
    with pytest.raises(ValueError, match="before its first DC scan"):
        J.decode_jpeg(_join(segs[:sos[0]] + segs[sos[0] + 1:]), device="cpu")
    m, seg, body = segs[sos[0]]
    with pytest.raises(ValueError, match="ran out"):
        J.decode_jpeg(_join(segs[:sos[0]] + [(m, seg, body[:3])] + segs[sos[0] + 1:]),
                      device="cpu")


def test_mixed_baseline_and_progressive_frames_batch():
    """Baseline and progressive frames of one geometry go through J2 in one
    batch; each equals its decode alone, and cv2's."""
    rng = np.random.default_rng(11)
    frames = [_image(rng, 48, 64) for _ in range(4)]
    datas = []
    for k, img in enumerate(frames):
        if k % 2:
            datas.append(_cv2_progressive(img, 80, "420"))
        else:
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80])
            datas.append(buf.tobytes())
    geoms = {J.parse_jpeg(d).geom for d in datas}
    assert len(geoms) == 1
    batch = J.decode_jpeg_frames(datas, device="cpu")
    for d, got in zip(datas, batch):
        assert np.array_equal(got, J.decode_jpeg(d, device="cpu"))
        assert np.array_equal(got, cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR))


def test_progressive_directory_matches_jax(tmp_path):
    """A directory of progressive JPEG frames (cv2's and PIL's) through JAX's
    reader (``cv2.imread``) and the port's, and ``imread`` alone."""
    rng = np.random.default_rng(12)
    d = tmp_path / "frames"
    d.mkdir()
    for k in range(3):
        img = _image(rng, 32, 40)
        data = _cv2_progressive(img, 90) if k != 1 else _pil_progressive(img, 70, "444")
        (d / f"{k:05d}.jpg").write_bytes(data)
    want = list(jax_video.get_video_frames(d))
    got = list(video.get_video_frames(d, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(imread(d / "00001.jpg", device="cpu"), cv2.imread(str(d / "00001.jpg")))
