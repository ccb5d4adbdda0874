"""Compressed flow + occlusion + sigma files.

A copy of ``mft_tpu/io/flowou_codecs.py`` (reference MFT/utils/io.py:174-563)
that encodes its PNGs with :mod:`mft_tpu_torch.io.png` instead of OpenCV.
The files are the JAX package's: a file either package writes decodes in the
other to the same arrays, and the pickled ``data`` entries stay numpy uint8
arrays of PNG bytes, so the two share caches and exports (the bytes may
differ: the zlib streams and row filters are each encoder's own).

In memory: flow (H, W, 2), occlusion (H, W), sigma (H, W), float32 numpy
(torch tensors are accepted and fetched to the host). Formats, by the
path's first suffix:

- ``.flowou.png``    fixed-point 4 x uint16 PNG: flow 2^15 + 32*x (|flow|
  < 1024, step 1/32), occlusion * 2^15, sigma * 2^9;
- ``.flowou2.png``   min/max-scaled uint16 PNG, the ranges in ``tEXt`` chunks;
- ``.flowouX16.pkl`` per-channel min/max uint16 packed into a 3 x uint8 PNG,
  in a pickled dict;
- ``.flowouX32.pkl`` the uint32 variant, a 4 x uint8 PNG;
- ``.stepan16``      export only: flow_x / flow_y PNGs and a limits text file.
"""

from pathlib import Path
import pickle

import numpy as np

from mft_tpu_torch.io.png import decode_png, encode_png, read_text
from mft_tpu_torch.utils.misc import ensure_numpy

FLOW_MULT = 2 ** 5          # signed around 2^15: max |flow| = 1024, step 1/32
OCCLUSION_MULT = 2 ** 15    # unsigned: max 2, step 3e-5
SIGMA_MULT = 2 ** 9         # unsigned: max 128, step 2e-3


def write_flowou(path, flow, occlusion, sigma):
    """Write flow (H, W, 2), occlusion (H, W), sigma (H, W) to ``path``.

    Accepts the reference's channel-first layouts too ((2, H, W), (1, H, W)).
    """
    flow, occlusion, sigma = _normalize_layout(flow, occlusion, sigma)
    path = Path(path)
    suf = path.suffixes[0] if path.suffixes else ""
    writers = {
        ".flowou": _write_flowou1_png,
        ".flowou2": _write_flowou2_png,
        ".flowouX16": _write_packed(np.uint16),
        ".flowouX32": _write_packed(np.uint32),
        ".stepan16": _write_stepan16,
    }
    if suf not in writers:
        raise ValueError(f"unknown flowou suffix: {path.suffixes}")
    path.parent.mkdir(parents=True, exist_ok=True)
    writers[suf](path, flow, occlusion, sigma)


def read_flowou(path):
    """Read a flowou file -> (flow (H, W, 2), occlusion (H, W), sigma (H, W))."""
    path = Path(path)
    suf = path.suffixes[0] if path.suffixes else ""
    readers = {
        ".flowou": _read_flowou1_png,
        ".flowou2": _read_flowou2_png,
        ".flowouX16": _read_packed(np.uint16),
        ".flowouX32": _read_packed(np.uint32),
    }
    if suf not in readers:
        raise ValueError(f"unknown flowou suffix: {path.suffixes}")
    return readers[suf](path)


def _normalize_layout(flow, occlusion, sigma):
    flow = np.asarray(ensure_numpy(flow), np.float32)
    occlusion = np.asarray(ensure_numpy(occlusion), np.float32)
    sigma = np.asarray(ensure_numpy(sigma), np.float32)
    if flow.ndim == 3 and flow.shape[0] == 2 and flow.shape[-1] != 2:
        flow = np.transpose(flow, (1, 2, 0))  # (2,H,W) -> (H,W,2)
    if occlusion.ndim == 3:
        occlusion = occlusion[0] if occlusion.shape[0] == 1 else occlusion[..., 0]
    if sigma.ndim == 3:
        sigma = sigma[0] if sigma.shape[0] == 1 else sigma[..., 0]
    return flow, occlusion, sigma


# -- .flowou.png: fixed point --------------------------------------------- #

def _write_flowou1_png(path, flow, occlusion, sigma):
    if not np.all(np.abs(flow) < 2 ** 15 / FLOW_MULT):
        raise ValueError(f"flow out of the .flowou.png range (|flow| < {2 ** 15 / FLOW_MULT})")
    enc_flow = 2 ** 15 + FLOW_MULT * flow
    enc_occl = OCCLUSION_MULT * np.clip(occlusion, 0, 1)
    enc_sigma = SIGMA_MULT * np.clip(sigma, 0, 127)
    data = np.concatenate(
        [enc_flow, enc_occl[..., None], enc_sigma[..., None]], axis=2
    ).astype(np.uint16)
    Path(path).write_bytes(encode_png(data))


def _read_flowou1_png(path):
    data = decode_png(Path(path).read_bytes())
    if data.ndim != 3 or data.shape[2] != 4 or data.dtype != np.uint16:
        raise ValueError(f"bad flowou png {path}")
    flow = (data[..., :2].astype(np.float32) - 2 ** 15) / FLOW_MULT
    occl = data[..., 2].astype(np.float32) / OCCLUSION_MULT
    sigma = data[..., 3].astype(np.float32) / SIGMA_MULT
    return flow, occl, sigma


# -- .flowou2.png: min/max scaled with PNG metadata ------------------------ #

def _minmax_encode(xs, dtype):
    lb, ub = float(xs.min()), float(xs.max())
    if abs(ub - lb) < 1e-8:
        xs01 = np.zeros_like(xs, np.float32)
    else:
        xs01 = (xs - lb) / (ub - lb)
    limit = np.iinfo(dtype).max
    if dtype == np.uint16:
        q = dtype(np.round(xs01 * limit))
    else:
        # the reference casts float32(x*(2^32-1)) directly (io.py:383), which
        # overflows to zero at the max pixel: quantize in float64 with a clip
        q = dtype(np.clip(xs01.astype(np.float64) * limit, 0, limit))
    return q, lb, ub


def _minmax_decode(q, lb, ub, dtype):
    xs01 = q.astype(np.float32) / np.iinfo(dtype).max
    return xs01 * (ub - lb) + lb


def _write_flowou2_png(path, flow, occlusion, sigma):
    def enc(xs):
        lb, ub = float(xs.min()), float(xs.max())
        xs01 = np.zeros_like(xs, np.float32) if abs(ub - lb) < 1e-8 else (xs - lb) / (ub - lb)
        return np.uint16(xs01 * (2 ** 16 - 1)), lb, ub

    f_q, f_lo, f_hi = enc(flow)
    o_q, o_lo, o_hi = enc(occlusion[..., None])
    s_q, s_lo, s_hi = enc(sigma[..., None])
    data = np.concatenate([f_q, o_q, s_q], axis=2)
    # the file's RGBA samples are our channels in order (a BGRA array)
    png = encode_png(data[..., [2, 1, 0, 3]], texts={
        "flow_min": f_lo, "flow_max": f_hi, "occl_min": o_lo,
        "occl_max": o_hi, "unc_min": s_lo, "unc_max": s_hi,
    })
    Path(path).write_bytes(png)


def _read_flowou2_png(path):
    png = Path(path).read_bytes()
    meta = read_text(png)
    data = decode_png(png)[..., [2, 1, 0, 3]]  # back to our channel order

    def dec(q, lo, hi):
        return q.astype(np.float32) / (2 ** 16 - 1) * (hi - lo) + lo

    flow = dec(data[..., :2], float(meta["flow_min"]), float(meta["flow_max"]))
    occl = dec(data[..., 2], float(meta["occl_min"]), float(meta["occl_max"]))
    sigma = dec(data[..., 3], float(meta["unc_min"]), float(meta["unc_max"]))
    return flow, occl, sigma


# -- .flowouX16 / .flowouX32: per-channel packed PNG in pickle ------------- #

def _pack_bytes(q):
    """uint16 -> HxWx3 uint8 (0, hi, lo); uint32 -> HxWx4 uint8 (b4..b1)."""
    if q.dtype == np.uint16:
        return np.dstack([np.zeros_like(q, np.uint8),
                          np.uint8((q >> 8) & 0xFF), np.uint8(q & 0xFF)])
    return np.dstack([np.uint8((q >> 24) & 0xFF), np.uint8((q >> 16) & 0xFF),
                      np.uint8((q >> 8) & 0xFF), np.uint8(q & 0xFF)])


def _unpack_bytes(planes, dtype):
    if dtype == np.uint16:
        _, hi, lo = np.dsplit(planes.astype(np.uint16), 3)
        return ((hi << 8) | lo)[..., 0]
    b4, b3, b2, b1 = np.dsplit(planes.astype(np.uint32), 4)
    return ((b4 << 24) | (b3 << 16) | (b2 << 8) | b1)[..., 0]


def _encode_channel(xs, dtype):
    q, lb, ub = _minmax_encode(np.float32(xs), dtype)
    buf = np.frombuffer(encode_png(_pack_bytes(q)), np.uint8).copy()
    return {"data": buf, "min": lb, "max": ub}


def _decode_channel(entry, dtype):
    planes = decode_png(entry["data"])
    want = 3 if dtype == np.uint16 else 4
    if planes.ndim != 3 or planes.shape[2] != want or planes.dtype != np.uint8:
        raise ValueError(f"packed flowou channel: expected (H, W, {want}) uint8 planes, "
                         f"got {planes.shape} {planes.dtype}")
    q = _unpack_bytes(planes, dtype)
    return _minmax_decode(q, entry["min"], entry["max"], dtype)


def _write_packed(dtype):
    def write(path, flow, occlusion, sigma):
        result = {
            "flow_x": _encode_channel(flow[..., 0], dtype),
            "flow_y": _encode_channel(flow[..., 1], dtype),
            "occlusion": _encode_channel(occlusion, dtype),
            "sigma": _encode_channel(sigma, dtype),
        }
        with open(path, "wb") as f:
            pickle.dump(result, f)
    return write


def _read_packed(dtype):
    def read(path):
        with open(path, "rb") as f:
            data = pickle.load(f)
        flow = np.stack([_decode_channel(data["flow_x"], dtype),
                         _decode_channel(data["flow_y"], dtype)], axis=-1)
        occl = _decode_channel(data["occlusion"], dtype)
        sigma = _decode_channel(data["sigma"], dtype)
        return flow, occl, sigma
    return read


# -- .stepan16 export ------------------------------------------------------ #

def _write_stepan16(path, flow, occlusion, sigma):
    # the reference's layout (io.py:487-489): the PNG-ENCODED buffer itself is
    # written as an N x 1 grey PNG whose pixels are the bytes of the inner
    # (H, W, 3) packed-plane PNG; consumers decode twice
    base = str(path)[: -len(".stepan16")]
    fx = _encode_channel(flow[..., 0], np.uint16)
    fy = _encode_channel(flow[..., 1], np.uint16)
    Path(base + "_flow_x.png").write_bytes(encode_png(fx["data"].reshape(-1, 1)))
    Path(base + "_flow_y.png").write_bytes(encode_png(fy["data"].reshape(-1, 1)))
    with open(base + "_limits.txt", "w") as f:
        f.write(f"{fx['min']} {fx['max']} {fy['min']} {fy['max']}")
