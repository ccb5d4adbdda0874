"""The MPEG-4 Part 2 (mp4v) codec's native stages: the VLC stage on the host
(V1) and the pixel stages on the card (V2, V3), each beside its plain version.

- ``mpeg4_vlc_decode`` / ``mpeg4_vlc_encode`` (V1): host routines
  ``mft_mpeg4_vlc_decode`` / ``mft_mpeg4_vlc_encode``, ``csrc/mpeg4_vlc.cu``
  (a VOP's header, MB syntax, codes, DC/AC and MV prediction);
- ``mpeg4_decode_pixels`` (V2): ``mft_mpeg4_decode_pixels``,
  ``csrc/mpeg4.cu`` (dequantization + simple IDCT + motion compensation +
  reconstruction, then, where asked, colour conversion to BGR);
- ``mpeg4_encode_pixels`` (V3): ``mft_mpeg4_encode_pixels``,
  ``csrc/mpeg4.cu`` (colour conversion + 2x2 chroma means + FDCT + H.263
  quantization of the source or of its residual).

None replaces a Pallas site. The JAX package reads and writes video files
through OpenCV (libavcodec) on the host (``mft_tpu/io/video.py:29-30, 40,
83-86``); the card's machine has none, so these came with the port's own
codec (:mod:`mft_tpu_torch.io.mpeg4`, which holds the plain versions and
the tables).

V1 is serial bit-level work: it runs natively on the host for a CUDA
``device``; with ``device="cpu"`` the Python
plain versions run. V2 and V3 are integer code, bit for bit with the plain
versions: they launch on CUDA tensors and use the plain versions on CPU
tensors. Each wrapper counts its native calls in ``launches``, read with the
other kernels' counts by :func:`mft_tpu_torch.ops.launch_counts`; a V2 call
is one or two kernels (reconstruction, then colour conversion) and counts
once.
"""

import ctypes

import numpy as np
import torch

from mft_tpu_torch.io import mpeg4 as _m
from mft_tpu_torch.ops import _build

vlc_decode_ref = _m.vlc_decode_ref
vlc_encode_ref = _m.vlc_encode_ref
decode_pixels_ref = _m.decode_pixels_ref
yuv_to_bgr_ref = _m.yuv_to_bgr_ref
encode_pixels_ref = _m.encode_pixels_ref

# the native routines' error codes (csrc/mpeg4_vlc.cu)
ERRORS = {
    1: "corrupt MPEG-4 stream: no code of the table at the read position",
    2: f"MPEG-4 B-VOPs are not supported ({_m.ROADMAP_ASP})",
    3: f"MPEG-4 S-VOPs (GMC) are not supported ({_m.ROADMAP_ASP})",
    4: f"MPEG-4 video packets (resync markers) are not supported ({_m.ROADMAP_ER})",
    5: "corrupt MPEG-4 VOP: truncated",
    6: "corrupt MPEG-4 stream: a run past the block's end",
    7: "corrupt MPEG-4 stream: forbidden escape-3 level",
    8: "corrupt MPEG-4 stream: an escape inside an escape",
    9: "corrupt MPEG-4 VOP: vop_quant or vop_fcode_forward 0",
    10: "corrupt MPEG-4 stream: a DC size of more than 9 bits (illegal for 8-bit video, "
        "as libavcodec rules)",
    11: "corrupt MPEG-4 stream: a negative intra DC (libavcodec rejects it)",
    12: "MPEG-4 syntax the stream writer cannot code",
    13: "MPEG-4 stream writer: out of memory or buffer",
}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


_TABLES = None


def native_tables():
    """(decode lookahead tables, their offsets and bits, escape maxima,
    encode code tables, their offsets) as int32 arrays, from the Python
    module's tables (one source for both routines)."""
    global _TABLES
    if _TABLES is None:
        luts = [lut.astype(np.int32) for lut in _m.LUTS]
        offs = np.cumsum([0] + [len(lut) for lut in luts[:-1]])
        lut_off = np.array(list(offs) + _m.LUT_BITS, np.int32)
        maxima = np.stack([np.stack(_m.MAXIMA[intra]) for intra in (False, True)])
        enc = []
        for _, codes, _ in _m.TABLES[:6]:
            t = np.zeros(max(codes) + 1, np.int32)
            for value, (code, bits) in codes.items():
                t[value] = (code << 8) | bits
            enc.append(t)
        for table in (_m.TCOEF_INTRA, _m.TCOEF_INTER):
            t = np.zeros((2, 64, 64), np.int32)
            for (last, run, level), (code, bits) in table.items():
                t[last, run, level] = (code << 8) | bits
            enc.append(t.ravel())
        enc.append(np.array([(_m.ESCAPE[0] << 8) | _m.ESCAPE[1]], np.int32))
        enc_off = np.cumsum([0] + [len(t) for t in enc[:-1]]).astype(np.int32)
        _TABLES = (np.ascontiguousarray(np.concatenate(luts)), lut_off,
                   np.ascontiguousarray(maxima.astype(np.int32)),
                   np.ascontiguousarray(np.concatenate(enc)), enc_off)
    return _TABLES


def _raise(err: int):
    raise ValueError(ERRORS.get(err, f"MPEG-4 native routine failed ({err})"))


def mpeg4_vlc_decode(data, vol, device) -> "_m.VopSyntax":
    """V1: the bytes of one VOP (after its start code) -> its
    :class:`mft_tpu_torch.io.mpeg4.VopSyntax`: natively for a CUDA
    ``device``, in Python for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return vlc_decode_ref(data, vol)
    if device.type != "cuda":
        raise ValueError(f"mpeg4_vlc_decode: unsupported device {device}")
    syn = vlc_decode_native(data, vol)
    mpeg4_vlc_decode.launches += 1
    return syn


mpeg4_vlc_decode.launches = 0


def vlc_decode_native(data, vol) -> "_m.VopSyntax":
    """``mft_mpeg4_vlc_decode`` on the host (uncounted; the wrapper counts)."""
    luts, lut_off, maxima, _, _ = native_tables()
    nmb = ((vol.width + 15) // 16) * ((vol.height + 15) // 16)
    syn = _m.VopSyntax(nmb)
    buf = np.frombuffer(bytes(data), np.uint8) if len(data) else np.zeros(1, np.uint8)
    v = vol.vector()
    err = _build.library().mft_mpeg4_vlc_decode(
        _ptr(buf), len(data), _ptr(v), _ptr(luts), _ptr(lut_off), _ptr(maxima),
        _ptr(syn.header), _ptr(syn.mode), _ptr(syn.qp), _ptr(syn.acpred), _ptr(syn.mv),
        _ptr(syn.levels))
    if err:
        _raise(err)
    return syn


def mpeg4_vlc_encode(syn, vol, device, stuffing=()) -> bytes:
    """V1's stream writer: a :class:`VopSyntax` -> the VOP's bytes (see
    :func:`mft_tpu_torch.io.mpeg4.vlc_encode_ref`): natively for a CUDA
    ``device``, in Python for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return vlc_encode_ref(syn, vol, stuffing)
    if device.type != "cuda":
        raise ValueError(f"mpeg4_vlc_encode: unsupported device {device}")
    data = vlc_encode_native(syn, vol, stuffing)
    mpeg4_vlc_encode.launches += 1
    return data


mpeg4_vlc_encode.launches = 0


def vlc_encode_native(syn, vol, stuffing=()) -> bytes:
    """``mft_mpeg4_vlc_encode`` on the host (uncounted; the wrapper counts)."""
    _, _, maxima, enc, enc_off = native_tables()
    nmb = len(syn.mode)
    arrays = [np.ascontiguousarray(a, dt) for a, dt in (
        (syn.header, np.int32), (syn.mode, np.int8), (syn.qp, np.int8),
        (syn.acpred, np.int8), (syn.mv, np.int16), (syn.levels, np.int16))]
    flags = np.zeros(nmb, np.int8)
    flags[list(stuffing)] = 1
    # every block at most 64 escape-3 codes of 30 bits, plus headers
    cap = nmb * (6 * 64 * 4 + 64) + 64
    out = np.empty(cap, np.uint8)
    written = ctypes.c_long(0)
    v = vol.vector()
    err = _build.library().mft_mpeg4_vlc_encode(
        _ptr(v), _ptr(enc), _ptr(enc_off), _ptr(maxima), *(_ptr(a) for a in arrays),
        _ptr(flags), _ptr(out), cap, ctypes.byref(written))
    if err:
        _raise(err)
    return out[:written.value].tobytes()


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def mpeg4_decode_pixels(levels, mode, qp, mv, ref, geom, rounding: int, bgr: bool = True):
    """V2: one VOP's syntax tensors (levels (nmb, 6, 64) int16, mode and qp
    (nmb,) int8, mv (nmb, 5, 2) int16) and the reference planes ((size,)
    uint8, None for an I-VOP) -> (the VOP's planes (size,) uint8, its
    (H, W, 3) uint8 BGR frame or None)."""
    if levels.device.type == "cpu":
        planes = decode_pixels_ref(levels.numpy(), mode.numpy(), qp.numpy(), mv.numpy(),
                                   None if ref is None else ref.numpy(), geom, rounding)
        img = torch.from_numpy(yuv_to_bgr_ref(planes, geom)) if bgr else None
        return torch.from_numpy(planes), img
    dev = levels.device
    if dev.type != "cuda" or any(t.device != dev for t in (mode, qp, mv)) or (
            ref is not None and ref.device != dev):
        raise ValueError(f"mpeg4_decode_pixels: unsupported devices {levels.device}")
    n = geom.nmb
    _check("levels", levels, torch.int16, (n, 6, 64))
    _check("mode", mode, torch.int8, (n,))
    _check("qp", qp, torch.int8, (n,))
    _check("mv", mv, torch.int16, (n, 5, 2))
    if ref is not None:
        _check("ref", ref, torch.uint8, (geom.size,))
    elif bool((mode != _m.INTRA).any()):
        raise ValueError("a P-VOP needs a reference")
    out = torch.empty(geom.size, dtype=torch.uint8, device=dev)
    img = torch.empty((geom.H, geom.W, 3), dtype=torch.uint8, device=dev) if bgr else None
    g = geom.vector()
    err = _build.library().mft_mpeg4_decode_pixels(
        _ptr(g), levels.data_ptr(), mode.data_ptr(), qp.data_ptr(), mv.data_ptr(),
        None if ref is None else ref.data_ptr(), int(rounding), out.data_ptr(),
        None if img is None else img.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mft_mpeg4_decode_pixels")
    mpeg4_decode_pixels.launches += 1
    return out, img


mpeg4_decode_pixels.launches = 0


def mpeg4_encode_pixels(img, ref, qp: int, geom):
    """V3: one (H, W, 3) uint8 BGR frame and the reference planes ((size,)
    uint8, None: intra) -> (nmb, 6, 64) int16 levels."""
    if img.device.type == "cpu":
        return torch.from_numpy(encode_pixels_ref(img.numpy(), None if ref is None else
                                                  ref.numpy(), qp, geom))
    dev = img.device
    if dev.type != "cuda" or (ref is not None and ref.device != dev):
        raise ValueError(f"mpeg4_encode_pixels: unsupported device {img.device}")
    _check("img", img, torch.uint8, (geom.H, geom.W, 3))
    if ref is not None:
        _check("ref", ref, torch.uint8, (geom.size,))
    if not 1 <= qp <= 31:
        raise ValueError(f"quantiser {qp} outside 1..31")
    out = torch.empty((geom.nmb, 6, 64), dtype=torch.int16, device=dev)
    g = geom.vector()
    err = _build.library().mft_mpeg4_encode_pixels(
        _ptr(g), img.data_ptr(), None if ref is None else ref.data_ptr(), int(qp),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mft_mpeg4_encode_pixels")
    mpeg4_encode_pixels.launches += 1
    return out


mpeg4_encode_pixels.launches = 0
