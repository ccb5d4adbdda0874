"""``cv2.imread`` without OpenCV: a reader that dispatches on the file's
signature.

PNG goes through :mod:`mft_tpu_torch.io.png`, JPEG through
:mod:`mft_tpu_torch.io.jpeg` (turned by its EXIF orientation, as
``cv2.imread`` turns it), binary 8-bit PPM is read in numpy. A file of any
other kind, or none, gives ``None``, as ``cv2.imread`` does.
"""

from pathlib import Path

import numpy as np

from mft_tpu_torch.io.jpeg import decode_jpeg, is_jpeg
from mft_tpu_torch.io.png import SIGNATURE as PNG_SIGNATURE
from mft_tpu_torch.io.png import decode_png, to_bgr


def read_ppm(data: bytes) -> np.ndarray:
    """Binary (P6) 8-bit PPM -> (H, W, 3) uint8 RGB."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    W, H, maxval = fields
    if maxval > 255:
        raise ValueError("16-bit PPM is not read")
    return np.frombuffer(data, np.uint8, count=H * W * 3, offset=pos + 1).reshape(H, W, 3).copy()


def imdecode(data: bytes, device="cuda"):
    """(H, W, 3) uint8 BGR of PNG, JPEG or P6 PPM bytes, as ``cv2.imdecode(buf,
    IMREAD_COLOR)`` gives it, or ``None`` for another kind of file. Only a
    JPEG uses ``device`` (J1 on host threads and J2 on the card for CUDA,
    the plain versions for the CPU)."""
    if data[:8] == PNG_SIGNATURE:
        return to_bgr(decode_png(data))
    if is_jpeg(data):
        return decode_jpeg(data, device)
    if data[:2] == b"P6":
        return np.ascontiguousarray(read_ppm(data)[:, :, ::-1])
    return None


def imread(path, device="cuda"):
    """``cv2.imread(path)`` (``IMREAD_COLOR``): (H, W, 3) uint8 BGR, or
    ``None`` for a missing file or one of another kind."""
    path = Path(path)
    if not path.is_file():
        return None
    return imdecode(path.read_bytes(), device)
