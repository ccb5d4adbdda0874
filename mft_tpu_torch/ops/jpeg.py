"""JPEG's native stages: entropy coding on the host (J1) and the pixel stages
on the card (J2, J3), each beside its plain version.

- ``jpeg_huff_decode`` / ``jpeg_huff_encode`` (J1): host routines
  ``mft_jpeg_huff_decode`` / ``mft_jpeg_huff_encode``,
  ``csrc/jpeg_entropy.cu``; ``jpeg_huff_decode_progressive`` (J1, a
  progressive file's scans): ``mft_jpeg_huff_decode_progressive``, one
  routine for the four kinds of scan, accumulating into one coefficient
  array, which J2 then takes as it takes a baseline file's;
- ``jpeg_decode_pixels`` (J2): ``mft_jpeg_decode_pixels``, ``csrc/jpeg.cu``
  (dequantize + IDCT, then upsampling + colour conversion);
- ``jpeg_encode_pixels`` (J3): ``mft_jpeg_encode_pixels``, ``csrc/jpeg.cu``
  (colour conversion + downsampling + FDCT + quantization).

None replaces a Pallas site. The JAX package decodes and encodes JPEG
through OpenCV and PIL on the host (``mft_tpu/train/augment.py:57-68``,
``io/video.py:37``, ``eval/tapvid.py:107-113``); the card's machine has
neither, so these were added with the port's own codec
(:mod:`mft_tpu_torch.io.jpeg`, which holds the plain versions and the
layouts).

J1 is serial bit-level work: it runs natively on the host, where ctypes
releases the GIL, so the files of a shard or a batch decode on host threads.
It is used whenever the caller's device is CUDA; with ``device="cpu"`` the
Python plain versions run. J2 and J3 are integer code, bit for bit with the
plain versions, over a batch of frames of one geometry: they launch on CUDA
tensors and use the plain versions on CPU tensors. Each wrapper counts its
native calls in ``launches``, read with the other kernels' counts by
:func:`mft_tpu_torch.ops.launch_counts`; a J2 call is two kernels (IDCT into
component planes, then upsampling and colour conversion) and counts once.
"""

import ctypes

import numpy as np
import torch

from mft_tpu_torch.io import jpeg as _jpeg
from mft_tpu_torch.ops import _build

huff_decode_ref = _jpeg.huff_decode_ref
huff_decode_progressive_ref = _jpeg.huff_decode_progressive_ref
huff_encode_ref = _jpeg.huff_encode_ref
decode_pixels_ref = _jpeg.decode_pixels_ref
encode_pixels_ref = _jpeg.encode_pixels_ref


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def jpeg_huff_decode(scan, out: np.ndarray, device) -> np.ndarray:
    """Decode one scan (:class:`mft_tpu_torch.io.jpeg.Scan`) into ``out``
    ((blocks, 64) int16, zero where nothing is coded): natively for a CUDA
    ``device``, in Python for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return huff_decode_ref(scan, out)
    if device.type != "cuda":
        raise ValueError(f"jpeg_huff_decode: unsupported device {device}")
    if out.dtype != np.int16 or not out.flags.c_contiguous or out.shape[-1] != 64:
        raise ValueError("out must be a contiguous (blocks, 64) int16 array")
    info = np.ascontiguousarray(scan.comp_info, np.int32)
    last = info[:, 5] + ((scan.mcuy * info[:, 1] - 1) * info[:, 4] + scan.mcux * info[:, 0])
    if last.max() > out.shape[0]:
        raise ValueError("the scan's blocks do not fit in out")
    luts = np.ascontiguousarray(scan.luts, np.uint16)
    data = np.frombuffer(scan.data, np.uint8) if len(scan.data) else np.zeros(1, np.uint8)
    err = _build.library().mft_jpeg_huff_decode(
        _ptr(data), len(scan.data), len(info), _ptr(info), _ptr(luts), scan.mcux, scan.mcuy,
        scan.restart, _ptr(out))
    if err:
        raise ValueError("corrupt JPEG: bad Huffman code")
    jpeg_huff_decode.launches += 1
    return out


jpeg_huff_decode.launches = 0


def jpeg_huff_decode_progressive(scan, out: np.ndarray, device) -> np.ndarray:
    """Decode one progressive scan into ``out`` ((blocks, 64) int16),
    accumulating into what the file's earlier scans left there: natively for
    a CUDA ``device``, in Python (``huff_decode_progressive_ref``) for the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return huff_decode_progressive_ref(scan, out)
    if device.type != "cuda":
        raise ValueError(f"jpeg_huff_decode_progressive: unsupported device {device}")
    if out.dtype != np.int16 or not out.flags.c_contiguous or out.shape[-1] != 64:
        raise ValueError("out must be a contiguous (blocks, 64) int16 array")
    info = np.ascontiguousarray(scan.comp_info, np.int32)
    last = info[:, 5] + ((scan.mcuy * info[:, 1] - 1) * info[:, 4] + scan.mcux * info[:, 0])
    if last.max() > out.shape[0]:
        raise ValueError("the scan's blocks do not fit in out")
    if not (0 <= scan.ss <= scan.se <= 63 and 0 <= scan.al <= 13):
        raise ValueError(f"invalid progressive scan (Ss {scan.ss}, Se {scan.se}, Al {scan.al})")
    luts = np.ascontiguousarray(scan.luts, np.uint16)
    data = np.frombuffer(scan.data, np.uint8) if len(scan.data) else np.zeros(1, np.uint8)
    err = _build.library().mft_jpeg_huff_decode_progressive(
        _ptr(data), len(scan.data), len(info), _ptr(info), _ptr(luts), scan.mcux, scan.mcuy,
        scan.restart, scan.ss, scan.se, scan.ah, scan.al, _ptr(out))
    if err == -2:
        raise ValueError("corrupt JPEG: a progressive scan's data ran out")
    if err:
        raise ValueError("corrupt JPEG: bad Huffman code")
    jpeg_huff_decode_progressive.launches += 1
    return out


jpeg_huff_decode_progressive.launches = 0


def jpeg_huff_encode(coefs: np.ndarray, comp_info, codes, mcux: int, mcuy: int,
                     restart: int, device) -> bytes:
    """Entropy-code one scan of quantized coefficients (see
    :func:`mft_tpu_torch.io.jpeg.huff_encode_ref`): natively for a CUDA
    ``device``, in Python for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return huff_encode_ref(coefs, comp_info, codes, mcux, mcuy, restart)
    if device.type != "cuda":
        raise ValueError(f"jpeg_huff_encode: unsupported device {device}")
    coefs = np.ascontiguousarray(coefs, np.int16)
    info = np.ascontiguousarray(comp_info, np.int32)
    codes = np.ascontiguousarray(codes, np.int32)
    # every block at most 64 codes of 16 + 11 bits, each byte perhaps stuffed
    cap = coefs.shape[0] * 64 * 8 + (mcux * mcuy // max(restart, 1) + 1) * 2 + 64
    out = np.empty(cap, np.uint8)
    written = ctypes.c_long(0)
    err = _build.library().mft_jpeg_huff_encode(
        _ptr(coefs), len(info), _ptr(info), _ptr(codes), mcux, mcuy, restart, _ptr(out), cap,
        ctypes.byref(written))
    if err:
        raise ValueError(f"mft_jpeg_huff_encode failed ({err})")
    jpeg_huff_encode.launches += 1
    return out[:written.value].tobytes()


jpeg_huff_encode.launches = 0


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def jpeg_decode_pixels(coefs: torch.Tensor, qtabs: torch.Tensor, geom) -> torch.Tensor:
    """J2: (N, blocks, 64) int16 coefficients and (N, ncomp, 64) int32
    quantization tables of N frames of one :class:`Geometry` -> (N, H, W, 3)
    uint8 BGR (grey replicated). One call launches the IDCT kernel and the
    colour kernel."""
    if coefs.device.type == "cpu":
        return torch.from_numpy(decode_pixels_ref(coefs.numpy(), qtabs.numpy(), geom))
    if coefs.device.type != "cuda" or qtabs.device != coefs.device:
        raise ValueError(f"jpeg_decode_pixels: unsupported devices {coefs.device}, "
                         f"{qtabs.device}")
    N = coefs.shape[0]
    _check("coefs", coefs, torch.int16, (N, geom.blocks, 64))
    _check("qtabs", qtabs, torch.int32, (N, geom.ncomp, 64))
    planes = torch.empty((N, geom.samples), dtype=torch.uint8, device=coefs.device)
    out = torch.empty((N, geom.H, geom.W, 3), dtype=torch.uint8, device=coefs.device)
    g = geom.vector()
    err = _build.library().mft_jpeg_decode_pixels(
        _ptr(g), N, coefs.data_ptr(), qtabs.data_ptr(), planes.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(coefs.device).cuda_stream)
    _build.check(err, "mft_jpeg_decode_pixels")
    jpeg_decode_pixels.launches += 1
    return out


jpeg_decode_pixels.launches = 0


def jpeg_encode_pixels(img: torch.Tensor, recips: torch.Tensor, geom) -> torch.Tensor:
    """J3: (N, H, W, 3) uint8 BGR (or (N, H, W, 1) grey) and (ncomp, 3, 64)
    int32 reciprocal tables -> (N, blocks, 64) int16 quantized coefficients."""
    if img.device.type == "cpu":
        return torch.from_numpy(encode_pixels_ref(img.numpy(), recips.numpy(), geom))
    if img.device.type != "cuda" or recips.device != img.device:
        raise ValueError(f"jpeg_encode_pixels: unsupported devices {img.device}, "
                         f"{recips.device}")
    N, C = img.shape[0], img.shape[-1]
    _check("img", img, torch.uint8, (N, geom.H, geom.W, 1 if geom.ncomp == 1 else 3))
    _check("recips", recips, torch.int32, (geom.ncomp, 3, 64))
    out = torch.empty((N, geom.blocks, 64), dtype=torch.int16, device=img.device)
    g = geom.vector()
    err = _build.library().mft_jpeg_encode_pixels(
        _ptr(g), N, C, img.data_ptr(), recips.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(img.device).cuda_stream)
    _build.check(err, "mft_jpeg_encode_pixels")
    jpeg_encode_pixels.launches += 1
    return out


jpeg_encode_pixels.launches = 0
