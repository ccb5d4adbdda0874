"""J4, the Motion JPEG pixel stage on the card, beside its plain version.

``mjpeg_decode_pixels`` -> ``mft_mjpeg_decode_pixels`` (``csrc/mjpeg.cu``):
dequantization + libavcodec's simple IDCT into the component planes, then
swscale's full-range YUV -> BGR24 conversion, for a batch of frames of one
geometry; bit for bit with :func:`mft_tpu_torch.io.mjpeg.decode_pixels_ref`.

It replaces no Pallas site. The JAX package reads MJPEG video through
``cv2.VideoCapture`` (libavcodec, swscale) on the host
(``mft_tpu/io/video.py:30``); the card's machine has no OpenCV, and J2
follows libjpeg-turbo, whose pixels differ from libavcodec's. The entropy
stage is J1's (:func:`mft_tpu_torch.ops.jpeg.jpeg_huff_decode`).

The wrapper launches on CUDA tensors and uses the plain version on CPU
tensors; it counts its calls in ``launches`` (two kernels a call, counted
once), read with the other kernels' counts by
:func:`mft_tpu_torch.ops.launch_counts`.
"""

import torch

from mft_tpu_torch.io import mjpeg as _m
from mft_tpu_torch.ops import _build

decode_pixels_ref = _m.decode_pixels_ref


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def mjpeg_decode_pixels(coefs: torch.Tensor, qtabs: torch.Tensor, geom) -> torch.Tensor:
    """J4: (N, blocks, 64) int16 quantized coefficients and (N, ncomp, 64)
    int32 quantization tables of N frames of one
    :class:`mft_tpu_torch.io.jpeg.Geometry` -> (N, H, W, 3) uint8 BGR."""
    if coefs.device.type == "cpu":
        return torch.from_numpy(decode_pixels_ref(coefs.numpy(), qtabs.numpy(), geom))
    if coefs.device.type != "cuda" or qtabs.device != coefs.device:
        raise ValueError(f"mjpeg_decode_pixels: unsupported devices {coefs.device}, "
                         f"{qtabs.device}")
    N = coefs.shape[0]
    _check("coefs", coefs, torch.int16, (N, geom.blocks, 64))
    _check("qtabs", qtabs, torch.int32, (N, geom.ncomp, 64))
    g = _m.geometry_vector(geom)
    planes = torch.empty((N, geom.samples), dtype=torch.uint8, device=coefs.device)
    out = torch.empty((N, geom.H, geom.W, 3), dtype=torch.uint8, device=coefs.device)
    err = _build.library().mft_mjpeg_decode_pixels(
        g.ctypes.data, N, coefs.data_ptr(), qtabs.data_ptr(), planes.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(coefs.device).cuda_stream)
    _build.check(err, "mft_mjpeg_decode_pixels")
    mjpeg_decode_pixels.launches += 1
    return out


mjpeg_decode_pixels.launches = 0
