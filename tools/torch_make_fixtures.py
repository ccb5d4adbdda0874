"""Write the fixtures that ``chip_smoke.py`` phases 20-22 check the port
against on the card's machine, which has neither OpenCV nor PIL nor JAX:

    python tools/torch_make_fixtures.py [--out tests/data/torch_fixtures] [--only video]

(``--only video`` rewrites ``video/`` and its entry of ``hashes.json`` and
leaves the other fixtures as they are.)

- ``prog_512/0000k.jpg``: 8 progressive 512x512 frames of a moving
  synthetic scene (``chip_smoke.synthetic_clip``, 2 px right and 1 px down
  a frame), cv2 at quality 90;
- ``prog_1080.jpg``: one progressive 1080x1920 frame (cv2, quality 90);
- ``jpeg/*.jpg``: small progressive files of every kind the tests cover
  (4:2:0, 4:2:2, 4:4:4, grey, odd sizes, a restart interval, a flat image,
  qualities 50 and 95, cv2's and PIL's progression scripts);
- ``png/*.png``: one file of each PNG kind that libpng expands for OpenCV
  (palettes with and without tRNS, 1/2/4-bit grey and palettes,
  grey+alpha at 8 and 16 bits, Adam7);
- ``mp4v/*.mp4``: 26-frame scenes written by the JAX package's
  ``mft_tpu.io.video.VideoWriter`` (cv2, fourcc ``mp4v``, 25 fps): a smooth
  texture panning by fractional and diagonal amounts past the frame edge
  (``pan``, 96x64), noise at high motion (``noise``, 48x32), a still
  scene with a small moving patch (``still``, 96x64) and a pan at 72x40,
  a size that is not a multiple of 16 (``odd``); beside each, ``.npz``
  (``savez_compressed``) of cv2's BGR frames;
- ``video/*``: 6-frame scenes in the other containers: the JAX package's
  ``VideoWriter`` (cv2, ``mp4v``) into ``.avi`` and ``.mkv``, cv2's writer
  with fourcc ``XVID`` (``.avi``) and ``MJPG`` (``.avi``, ``.mkv``, and
  ``.mp4``/``.mov``, which cv2 writes under an ``mp4v`` entry of object
  type 0x6C and a ``jpeg`` entry), and MJPEG AVIs that the port's muxer
  packs from ``cv2.imencode`` frames: 4:2:2, 4:4:4, grey, and 4:2:0 with
  its DHT segments removed (as camera MJPEG comes);
- ``hashes.json``: ``chip_smoke.array_hash`` (dtype, shape, sha256) of
  every file's decode by cv2 (BGR; for a PNG ``IMREAD_UNCHANGED`` and
  ``IMREAD_COLOR``) and PIL (``convert('RGB')``), of every output of
  ``chip_smoke.vis_cases`` under the JAX package's ``mft_tpu/utils/vis.py``,
  and of each ``mp4v`` file's frames: cv2's Y planes
  (``CAP_PROP_CONVERT_RGB`` 0) and BGR frames, its frame count, fps and
  size; and under ``video`` each container fixture's BGR frames as cv2
  decodes them, its frame count, fps and size.

Needs cv2, PIL and the JAX package (``mft_tpu``); runs on the CPU.
"""

import argparse
import io
import json
import os
import shutil
import struct
import sys
import zlib
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import cv2  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def cv2_progressive(img, quality, sampling="420", rst=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil_progressive(img, quality, subsampling):
    out = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(out, "JPEG", quality=quality, progressive=True,
                                         subsampling=subsampling)
    return out.getvalue()


def blurred(rng, H, W):
    return cv2.GaussianBlur((rng.random((H, W, 3)) * 255).astype(np.uint8), (5, 5), 1.2)


def png_bytes(samples, ctype, depth, interlace, plte=None, trns=None):
    """A PNG of file-order samples (H, W, samples a pixel), every row with
    the Paeth filter (None for the first rows of a pass), Adam7 passes packed
    and filtered apart."""
    H, W, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.reshape(sub.shape[0], -1)
        if depth == 16:
            packed = rows.astype(">u2").view(np.uint8).reshape(len(rows), -1)
        elif depth == 8:
            packed = rows.astype(np.uint8)
        else:
            per = 8 // depth
            s = np.pad(rows.astype(np.int64), ((0, 0), (0, -rows.shape[1] % per)))
            s = s.reshape(len(rows), -1, per)
            packed = sum(s[:, :, k] << (8 - depth * (k + 1)) for k in range(per)).astype(np.uint8)
        prev = np.zeros(packed.shape[1], np.int64)
        for y, r in enumerate(packed.astype(np.int64)):
            if y == 0:
                raw.append(bytes([0]) + bytes(r.astype(np.uint8)))
            else:
                a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
                c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
                p = a + prev - c
                pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
                pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
                raw.append(bytes([4]) + bytes(((r - pred) % 256).astype(np.uint8)))
            prev = r
    chunk = lambda kind, d: (struct.pack(">I", len(d)) + kind + d
                             + struct.pack(">I", zlib.crc32(kind + d) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                                              0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(raw), 9)) + chunk(b"IEND", b"")


def png_kinds(rng):
    """{name: PNG bytes} of every kind, 13 x 21 (Adam7 files 19 x 23)."""
    out = {}

    def palette(depth, trns, interlace, H=13, W=21):
        n = 1 << depth
        plte = rng.integers(0, 256, (n, 3)).astype(np.uint8).tobytes()
        tr = rng.integers(0, 256, max(1, n // 2)).astype(np.uint8).tobytes() if trns else None
        return png_bytes(rng.integers(0, n, (H, W, 1)), 3, depth, interlace, plte, tr)

    for depth in (1, 2, 4, 8):
        out[f"palette{depth}.png"] = palette(depth, False, 0)
        out[f"palette{depth}_trns.png"] = palette(depth, True, 0)
    for depth in (1, 2, 4, 16):
        out[f"grey{depth}.png"] = png_bytes(rng.integers(0, 1 << depth, (13, 21, 1)), 0,
                                            depth, 0)
    for depth in (8, 16):
        out[f"grey_alpha{depth}.png"] = png_bytes(rng.integers(0, 1 << depth, (13, 21, 2)), 4,
                                                  depth, 0)
    key = rng.integers(0, 4, (13, 21, 3))
    out["rgb8_trns.png"] = png_bytes(key, 2, 8, 0, trns=struct.pack(">HHH", *map(int, key[3, 5])))
    out["adam7_rgb8.png"] = png_bytes(rng.integers(0, 256, (19, 23, 3)), 2, 8, 1)
    out["adam7_palette2_trns.png"] = palette(2, True, 1, 19, 23)
    out["adam7_grey16.png"] = png_bytes(rng.integers(0, 1 << 16, (19, 23, 1)), 0, 16, 1)
    out["adam7_grey_alpha8.png"] = png_bytes(rng.integers(0, 256, (19, 23, 2)), 4, 8, 1)
    return out


def video_scenes(rng):
    """{name: 26 frames (H, W, 3) uint8} of the ``mp4v`` fixtures."""
    n = 26

    def pan(H, W, seed):
        big = cv2.GaussianBlur((np.random.default_rng(seed).random((3 * H, 3 * W, 3)) * 255)
                               .astype(np.uint8), (0, 0), 3.0).astype(np.float32)
        out = []
        for t in range(n):
            dx, dy = 0.2 * W + 0.5 + 1.37 * t, 0.3 * H + 0.75 * t - 0.3 * (t % 3)
            m = np.float32([[1, 0, dx], [0, 1, dy]])
            out.append(cv2.warpAffine(big, m, (W, H), flags=cv2.INTER_LINEAR,
                                      borderMode=cv2.BORDER_REPLICATE).clip(0, 255)
                       .astype(np.uint8))
        return out

    noise = (rng.random((96, 144, 3)) * 255).astype(np.uint8)
    still = blurred(rng, 64, 96)
    patch = (rng.random((12, 12, 3)) * 255).astype(np.uint8)
    stills = []
    for t in range(n):
        f = still.copy()
        f[20 + t:32 + t, 10 + 2 * t:22 + 2 * t] = patch
        stills.append(f)
    return {"pan": pan(64, 96, 1),
            "noise": [np.ascontiguousarray(noise[(7 * t) % 64:(7 * t) % 64 + 32,
                                                 (11 * t) % 96:(11 * t) % 96 + 48])
                      for t in range(n)],
            "still": stills,
            "odd": pan(40, 72, 2)}


def write_mp4v(out, rng):
    """The ``mp4v`` fixtures through the JAX package's writer (cv2), and
    {name: cv2's frame count, fps, size, Y plane and BGR hashes}."""
    from mft_tpu.io.video import VideoWriter as JaxVideoWriter
    (out / "mp4v").mkdir()
    info = {}
    for name, frames in video_scenes(rng).items():
        path = out / "mp4v" / f"{name}.mp4"
        with JaxVideoWriter(path, fps=25.0) as w:
            for f in frames:
                w.write(f)
        cap = cv2.VideoCapture(str(path))
        fps = cap.get(cv2.CAP_PROP_FPS)
        bgr = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            bgr.append(f)
        cap = cv2.VideoCapture(str(path))
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        ys = []
        while True:
            ok, y = cap.read()
            if not ok:
                break
            ys.append(y.copy())
        np.savez_compressed(out / "mp4v" / f"{name}.npz", bgr=np.stack(bgr))
        info[f"mp4v/{name}.mp4"] = {
            "frames": len(bgr), "fps": fps, "size": [frames[0].shape[1], frames[0].shape[0]],
            "y": [chip_smoke.array_hash(y) for y in ys],
            "bgr": [chip_smoke.array_hash(f) for f in bgr]}
    return info


def strip_dht(jpeg: bytes) -> bytes:
    """A JPEG without its DHT segments (a decoder then takes Annex K's tables)."""
    out, pos = bytearray(jpeg[:2]), 2
    while jpeg[pos + 1] != 0xDA:
        size = 2 + struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        if jpeg[pos + 1] != 0xC4:
            out += jpeg[pos:pos + size]
        pos += size
    return bytes(out + jpeg[pos:])


VIDEO_FRAMES = 6


def container_scenes():
    """{name: (writer, W, H, frames)} of the ``video/`` fixtures; writer:
    'jax' (the JAX package's VideoWriter), a cv2 fourcc, or ('avi', sampling
    or 'grey', strip DHT) for the port's AVI muxer over cv2.imencode."""
    def pan(H, W, seed):
        big = cv2.GaussianBlur((np.random.default_rng(seed).random((2 * H, 2 * W, 3)) * 255)
                               .astype(np.uint8), (0, 0), 2.0)
        return [np.ascontiguousarray(big[3 * t:3 * t + H, 5 * t:5 * t + W])
                for t in range(VIDEO_FRAMES)]

    return {"mp4v.avi": ("jax", pan(64, 96, 11)), "mp4v.mkv": ("jax", pan(64, 96, 12)),
            "xvid.avi": ("XVID", pan(48, 80, 13)), "mjpg.avi": ("MJPG", pan(64, 96, 14)),
            "mjpg.mkv": ("MJPG", pan(48, 64, 15)), "mjpg.mp4": ("MJPG", pan(48, 64, 16)),
            "mjpg.mov": ("MJPG", pan(40, 56, 17)),
            "mjpg422.avi": (("422", False), pan(48, 88, 18)),
            "mjpg444.avi": (("444", False), pan(40, 72, 19)),
            "grey.avi": (("grey", False), pan(48, 64, 20)),
            "nodht.avi": (("420", True), pan(64, 96, 21))}


def write_containers(out):
    """The ``video/`` fixtures, and {name: cv2's frame count, fps, size and
    BGR hashes}."""
    from mft_tpu.io.video import VideoWriter as JaxVideoWriter
    from mft_tpu_torch.io.avi import AviWriter
    (out / "video").mkdir()
    info = {}
    for name, (writer, frames) in container_scenes().items():
        path = out / "video" / name
        H, W = frames[0].shape[:2]
        if writer == "jax":
            with JaxVideoWriter(path, fps=25.0) as w:
                for f in frames:
                    w.write(f)
        elif isinstance(writer, str):
            w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*writer), 25.0, (W, H))
            for f in frames:
                w.write(f)
            w.release()
        else:
            sampling, no_dht = writer
            with AviWriter(path, 25.0, W, H, b"MJPG") as w:
                for f in frames:
                    if sampling == "grey":
                        img, params = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY), []
                    else:
                        img, params = f, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
                    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90] + params)[1]
                    w.add(strip_dht(data.tobytes()) if no_dht else data.tobytes(), True)
        cap = cv2.VideoCapture(str(path))
        fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
        bgr = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            bgr.append(f)
        assert len(bgr) == count == VIDEO_FRAMES, (name, len(bgr), count)
        info[f"video/{name}"] = {"frames": len(bgr), "fps": fps, "size": [W, H],
                                 "bgr": [chip_smoke.array_hash(f) for f in bgr]}
    return info


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(REPO / "tests" / "data" / "torch_fixtures"))
    parser.add_argument("--only", choices=["video"], default=None)
    args = parser.parse_args(argv)
    out = Path(args.out)
    if args.only == "video":
        shutil.rmtree(out / "video", ignore_errors=True)
        hashes = json.loads((out / "hashes.json").read_text())
        hashes["video"] = write_containers(out)
        (out / "hashes.json").write_text(json.dumps(hashes, indent=1, sort_keys=True) + "\n")
        print(f"wrote {len(hashes['video'])} video files to {out / 'video'}")
        return 0
    if out.exists():
        shutil.rmtree(out)
    for sub in (chip_smoke.PROG_DIR, "jpeg", "png"):
        (out / sub).mkdir(parents=True)
    rng = np.random.default_rng(26)
    files = {}
    for k, frame in enumerate(chip_smoke.synthetic_clip(7, 512, 512)):
        files[f"{chip_smoke.PROG_DIR}/{k:05d}.jpg"] = cv2_progressive(
            frame, chip_smoke.PROG_QUALITY)
    files[chip_smoke.PROG_HD] = cv2_progressive(
        chip_smoke.synthetic_clip(0, 1080, 1920, seed=3)[0], chip_smoke.PROG_QUALITY)
    for s in SAMPLING:
        for q in (50, 95):
            files[f"jpeg/{s}_q{q}_37x53.jpg"] = cv2_progressive(blurred(rng, 37, 53), q, s)
    files["jpeg/grey_q80_64x48.jpg"] = cv2_progressive(blurred(rng, 64, 48)[..., 0], 80)
    files["jpeg/420_rst3_45x61.jpg"] = cv2_progressive(blurred(rng, 45, 61), 75, "420", 3)
    flat = np.empty((128, 128, 3), np.uint8)
    flat[:] = (90, 140, 200)
    files["jpeg/flat_q95_128.jpg"] = cv2_progressive(flat, 95)
    files["jpeg/pil_444_q80_40x24.jpg"] = pil_progressive(blurred(rng, 40, 24), 80, 0)
    files["jpeg/pil_420_q60_33x47.jpg"] = pil_progressive(blurred(rng, 33, 47), 60, 2)
    pngs = {f"png/{k}": v for k, v in png_kinds(rng).items()}
    hashes = {"jpeg": {}, "png": {}, "vis": {}}
    for name, data in {**files, **pngs}.items():
        (out / name).write_bytes(data)
        buf = np.frombuffer(data, np.uint8)
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        colour = chip_smoke.array_hash(cv2.imdecode(buf, cv2.IMREAD_COLOR))
        if name.endswith(".png"):
            hashes["png"][name] = {
                "cv2_unchanged": chip_smoke.array_hash(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)),
                "cv2_color": colour, "pil_rgb": chip_smoke.array_hash(pil)}
        else:
            hashes["jpeg"][name] = {"cv2": colour, "pil": chip_smoke.array_hash(pil)}
    from mft_tpu.utils import vis as jax_vis
    hashes["vis"] = {k: chip_smoke.array_hash(v)
                     for k, v in chip_smoke.vis_cases(np, jax_vis).items()}
    hashes["mp4v"] = write_mp4v(out, rng)
    hashes["video"] = write_containers(out)
    (out / "hashes.json").write_text(json.dumps(hashes, indent=1, sort_keys=True) + "\n")
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {len(files) + len(pngs)} image files and hashes.json to {out}: "
          f"{size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
