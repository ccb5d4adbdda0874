"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video: the ``mp4v`` of
ISO-BMFF files, in libavcodec's arithmetic.

The JAX package reads and writes video files through ``cv2.VideoCapture`` /
``cv2.VideoWriter`` (fourcc ``mp4v``, ``mft_tpu/io/video.py:29-30, 40,
83-86``), i.e. libavcodec's MPEG-4 codec on the host. The card's machine has
no OpenCV, so the port carries its own codec, split into three stages:

- V1, the VLC stage (host): a VOP's header, macroblock (MB) syntax,
  variable-length codes, DC/AC prediction and motion-vector prediction.
  :func:`vlc_decode_ref` turns a VOP's bytes into the syntax arrays of a
  :class:`VopSyntax` (MB modes, quantisers, motion vectors, quantized
  levels); :func:`vlc_encode_ref` is the stream writer that turns any such
  syntax (1MV/4MV, dquant, ``ac_pred``, ...) back into a VOP. The native
  versions are ``ops/csrc/mpeg4_vlc.cu`` (:mod:`mft_tpu_torch.ops.mpeg4`).
- V2, the decode pixel stage (card): H.263 dequantization, libavcodec's
  8-bit integer simple IDCT (``simple_idct_template.c``), half-pel motion
  compensation with rounding control from the reference clamped to the
  picture (the edge padding of unrestricted MVs), reconstruction, then
  YUV 4:2:0 -> BGR as swscale's x86 yuv2rgb does. Plain version:
  :func:`decode_pixels_ref` and :func:`yuv_to_bgr_ref`.
- V3, the encode pixel stage (card): BGR -> limited-range BT.601 YUV 4:2:0,
  libjpeg's islow FDCT (:func:`mft_tpu_torch.io.jpeg._fdct_1d`) and H.263
  quantization of the source (I-VOP) or of its residual against V2's
  reconstruction (P-VOP, zero motion). Plain version:
  :func:`encode_pixels_ref`.

Supported: rectangular progressive 8-bit video, I- and P-VOPs (a VOP with
``vop_coded`` 0 gives no frame, as libavcodec gives none), H.263
quantization, unrestricted MVs, 1MV and 4MV, every intra DC threshold, all
three TCOEF escapes. Everything else raises ``ValueError`` naming its
ROADMAP item: video packets (resync markers), data partitioning and RVLC,
short header, interlaced, non-rectangular shape, other bit depths, MPEG
quantization, B-VOPs, quarter-pel and GMC (Advanced Simple Profile).

Syntax arrays of a VOP with ``nmb`` MBs in raster order: ``mode`` (nmb,)
int8 (:data:`NOT_CODED`, :data:`INTER`, :data:`INTER4V`, :data:`INTRA`),
``qp`` (nmb,) int8, ``acpred`` (nmb,) int8, ``mv`` (nmb, 5, 2) int16 (the
four luma blocks' vectors and the chroma vector, half-pel, x then y) and
``levels`` (nmb, 6, 64) int16 (quantized levels in natural order; an intra
block's DC is its quantized DC level).
"""


import numpy as np

from mft_tpu_torch.io.container import MPEG4
from mft_tpu_torch.io.jpeg import _fdct_1d

# ROADMAP items named by what raises
ROADMAP_ER = "ROADMAP A11, MPEG-4 error resilience and MPEG quantization"
ROADMAP_ASP = "ROADMAP A11, MPEG-4 Advanced Simple Profile"

NOT_CODED, INTER, INTER4V, INTRA = 0, 1, 2, 3
I_VOP, P_VOP = 0, 1
GOP = 12                   # an I-VOP every 12 frames, as cv2's writer
ENCODER_QP = 2             # the encoder's fixed quantiser

# --------------------------------------------------------------------------- #
# tables (ISO/IEC 14496-2 Annex B; libavcodec h263data.c, mpeg4data.h)
# --------------------------------------------------------------------------- #
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
ALT_H = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63], np.int64)
ALT_V = (ALT_H % 8) * 8 + ALT_H // 8          # the transpose of ALT_H
SCANS = np.stack([ZIGZAG, ALT_V, ALT_H])      # by: no ac_pred, left, top

Y_DC_SCALE = np.array([0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
                       27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46], np.int64)
C_DC_SCALE = np.array([0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
                       16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25], np.int64)
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
DQUANT = (-1, -2, 1, 2)
CHROMA_ROUND = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)

# (code, bits) by value; MCBPC values are type * 4 + cbpc, type 0 inter,
# 1 inter+q, 2 inter4v, 3 intra, 4 intra+q; STUFFING the stuffing code
STUFFING = 20
MCBPC_I = {12: (1, 1), 13: (1, 3), 14: (2, 3), 15: (3, 3),
           16: (1, 4), 17: (1, 6), 18: (2, 6), 19: (3, 6), STUFFING: (1, 9)}
MCBPC_P = {0: (1, 1), 1: (3, 4), 2: (2, 4), 3: (5, 6),
           4: (3, 3), 5: (7, 7), 6: (6, 7), 7: (5, 9),
           8: (2, 3), 9: (5, 7), 10: (4, 7), 11: (5, 8),
           12: (3, 5), 13: (4, 8), 14: (3, 8), 15: (3, 7),
           16: (4, 6), 17: (4, 9), 18: (3, 9), 19: (2, 9), STUFFING: (1, 9)}
CBPY = {i: cb for i, cb in enumerate([
    (3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
    (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)])}
DC_LUM = {i: cb for i, cb in enumerate([
    (3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
    (1, 10), (1, 11)])}
DC_CHROM = {i: cb for i, cb in enumerate([
    (3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10),
    (1, 11), (1, 12)])}
MVD = {i: cb for i, cb in enumerate([
    (1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
    (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10),
    (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10),
    (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12)])}

_INTER_VLC = [
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
    (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
    (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
    (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
    (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
    (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
    (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12),
    (0x59, 12), (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12)]
_INTER_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5,
    5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26,
    0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
_INTRA_VLC = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
    (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9),
    (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9),
    (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
    (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12), (0x14, 7),
    (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9),
    (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
    (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6), (0x4, 10),
    (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12),
    (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12)]
_INTRA_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8,
    9, 9, 10, 11, 12, 13, 14,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13,
    14, 15, 16, 17, 18, 19, 20]
ESCAPE = (0x3, 7)


def _levels(runs, n_first):
    """Each code's level: the tables list the levels of a (last, run) from 1 up."""
    out = []
    for i, run in enumerate(runs):
        same = i > 0 and runs[i - 1] == run and (i >= n_first) == (i - 1 >= n_first)
        out.append(out[-1] + 1 if same else 1)
    return out


_INTER_LEVEL = _levels(_INTER_RUN, 58)
_INTRA_LEVEL = _levels(_INTRA_RUN, 67)


def _tcoef(vlc, level, run, n_first):
    """{(last, run, level): (code, bits)} of a TCOEF table."""
    return {(int(i >= n_first), r, lv): cb
            for i, (cb, r, lv) in enumerate(zip(vlc, run, level))}


TCOEF_INTRA = _tcoef(_INTRA_VLC, _INTRA_LEVEL, _INTRA_RUN, 67)
TCOEF_INTER = _tcoef(_INTER_VLC, _INTER_LEVEL, _INTER_RUN, 58)


def _maxima(table):
    """(max_level[last][run], max_run[last][level]) of a TCOEF table; 0 and
    -1 where the table has no such code."""
    max_level = np.zeros((2, 64), np.int64)
    max_run = np.full((2, 64), -1, np.int64)
    for last, run, level in table:
        max_level[last, run] = max(max_level[last, run], level)
        max_run[last, level] = max(max_run[last, level], run)
    return max_level, max_run


MAXIMA = {False: _maxima(TCOEF_INTER), True: _maxima(TCOEF_INTRA)}

# table id -> (name, {value: (code, bits)}, lookahead bits); TCOEF values are
# last << 12 | run << 6 | level, the escape 0x7fff
TC_ESCAPE = 0x7FFF
T_MCBPC_I, T_MCBPC_P, T_CBPY, T_DC_LUM, T_DC_CHROM, T_MVD, T_INTRA, T_INTER = range(8)


def _tc_values(table):
    out = {(last << 12) | (run << 6) | level: cb for (last, run, level), cb in table.items()}
    out[TC_ESCAPE] = ESCAPE
    return out


TABLES = (("mcbpc_i", MCBPC_I, 9), ("mcbpc_p", MCBPC_P, 9), ("cbpy", CBPY, 6),
          ("dc_lum", DC_LUM, 11), ("dc_chrom", DC_CHROM, 12), ("mvd", MVD, 12),
          ("tcoef_intra", _tc_values(TCOEF_INTRA), 12),
          ("tcoef_inter", _tc_values(TCOEF_INTER), 12))


def _lookahead(codes: dict, nbits: int) -> np.ndarray:
    """Lookahead table of ``nbits``: entry value << 8 | length, -1 where no
    code starts."""
    lut = np.full(1 << nbits, -1, np.int64)
    for value, (code, bits) in codes.items():
        lo = code << (nbits - bits)
        if (lut[lo:lo + (1 << (nbits - bits))] != -1).any():
            raise AssertionError("not a prefix code")
        lut[lo:lo + (1 << (nbits - bits))] = (value << 8) | bits
    return lut


LUTS = [_lookahead(codes, nbits) for _, codes, nbits in TABLES]
LUT_BITS = [nbits for _, _, nbits in TABLES]

# --------------------------------------------------------------------------- #
# bits
# --------------------------------------------------------------------------- #


class BitReader:
    """MSB-first reader; zeros past the end."""

    def __init__(self, data, pos: int = 0):
        self.d = bytes(data) + bytes(8)
        self.n = len(data) * 8
        self.p = pos

    def peek(self, k: int) -> int:
        p = self.p
        v = int.from_bytes(self.d[p >> 3:(p >> 3) + 5], "big")
        return (v >> (40 - (p & 7) - k)) & ((1 << k) - 1)

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        v = self.peek(k)
        self.p += k
        return v

    def vlc(self, t: int, counts=None) -> int:
        e = int(LUTS[t][self.peek(LUT_BITS[t])])
        if e < 0:
            raise ValueError(f"corrupt MPEG-4 stream: no {TABLES[t][0]} code at bit {self.p}")
        self.p += e & 0xFF
        if counts is not None:
            key = (TABLES[t][0], e >> 8)
            counts[key] = counts.get(key, 0) + 1
        return e >> 8


class BitWriter:
    """MSB-first writer."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, k: int, v: int):
        if k == 0:
            return
        self.acc = (self.acc << k) | (v & ((1 << k) - 1))
        self.nbits += k
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def code(self, cb):
        self.put(cb[1], cb[0])

    def stuff(self):
        """next_start_code(): a zero bit, then ones to the byte boundary."""
        self.put(1, 0)
        while self.nbits:
            self.put(1, 1)

    def getvalue(self) -> bytes:
        return bytes(self.out)


def start_codes(data: bytes):
    """[(code byte, offset of the payload)] of the start codes 00 00 01 xx."""
    out = []
    i = data.find(b"\x00\x00\x01")
    while 0 <= i < len(data) - 3:
        out.append((data[i + 3], i + 4))
        i = data.find(b"\x00\x00\x01", i + 3)
    return out


# --------------------------------------------------------------------------- #
# headers
# --------------------------------------------------------------------------- #
class Vol:
    """The video object layer's header fields the decoder uses."""

    def __init__(self, width, height, time_res, fixed_incr=0, verid=1, resync=False):
        self.width, self.height = int(width), int(height)
        self.time_res = int(time_res)
        self.time_bits = max(1, (self.time_res - 1).bit_length())
        self.fixed_incr = int(fixed_incr)
        self.verid = verid
        self.resync = resync        # resync markers may appear (resync_marker_disable 0)

    def vector(self) -> np.ndarray:
        """int32 descriptor for the native VLC stage."""
        return np.array([self.width, self.height, self.time_bits, int(self.resync)], np.int32)

    def __repr__(self):
        return f"Vol({self.width}x{self.height}, time_res {self.time_res})"


def _marker(br):
    br.read(1)   # libavcodec does not require it


def parse_vol(data: bytes, pos: int) -> Vol:
    """The VOL header whose payload starts at byte ``pos``."""
    br = BitReader(data, pos * 8)
    br.read(1)                                   # random_accessible_vol
    br.read(8)                                   # video_object_type_indication
    verid = 1
    if br.read(1):                               # is_object_layer_identifier
        verid = br.read(4)
        br.read(3)
    if br.read(4) == 15:                         # aspect_ratio_info: extended PAR
        br.read(16)
    if br.read(1):                               # vol_control_parameters
        if br.read(2) != 1:
            raise ValueError(f"MPEG-4 chroma format other than 4:2:0 ({ROADMAP_ASP})")
        br.read(1)                               # low_delay
        if br.read(1):                           # vbv_parameters
            br.read(79)
    shape = br.read(2)
    if shape != 0:
        raise ValueError(f"MPEG-4 non-rectangular shape {shape} is not supported ({ROADMAP_ER})")
    _marker(br)
    time_res = br.read(16)
    if time_res == 0:
        raise ValueError("corrupt MPEG-4 VOL: vop_time_increment_resolution 0")
    _marker(br)
    fixed_incr = 0
    if br.read(1):                               # fixed_vop_rate
        fixed_incr = br.read(max(1, (time_res - 1).bit_length()))
    _marker(br)
    width = br.read(13)
    _marker(br)
    height = br.read(13)
    _marker(br)
    if br.read(1):
        raise ValueError(f"interlaced MPEG-4 video is not supported ({ROADMAP_ASP})")
    br.read(1)                                   # obmc_disable
    sprite = br.read(1 if verid == 1 else 2)
    if sprite:
        raise ValueError(f"MPEG-4 sprites / GMC are not supported ({ROADMAP_ASP})")
    if br.read(1):                               # not_8_bit
        quant_precision, bits = br.read(4), br.read(4)
        if bits != 8 or quant_precision != 5:
            raise ValueError(f"MPEG-4 video of {bits} bits a sample (quant precision "
                             f"{quant_precision}) is not supported ({ROADMAP_ER})")
    if br.read(1):
        raise ValueError(f"MPEG-4 MPEG quantization (quant_type 1) is not supported "
                         f"({ROADMAP_ER})")
    if verid != 1 and br.read(1):
        raise ValueError(f"MPEG-4 quarter-pel motion is not supported ({ROADMAP_ASP})")
    if not br.read(1):
        raise ValueError(f"MPEG-4 complexity estimation headers are not supported "
                         f"({ROADMAP_ER})")
    resync = not br.read(1)
    if br.read(1):
        raise ValueError(f"MPEG-4 data partitioning (and RVLC) is not supported ({ROADMAP_ER})")
    if verid != 1:
        if br.read(1):
            raise ValueError(f"MPEG-4 NEWPRED is not supported ({ROADMAP_ER})")
        if br.read(1):
            raise ValueError(f"MPEG-4 reduced-resolution VOPs are not supported "
                             f"({ROADMAP_ER})")
    if br.read(1):
        raise ValueError(f"MPEG-4 scalability is not supported ({ROADMAP_ER})")
    if width == 0 or height == 0 or width % 2 or height % 2:
        raise ValueError(f"MPEG-4 frame size {width}x{height}: width and height must be even")
    return Vol(width, height, time_res, fixed_incr, verid, resync)


def write_config(vol: Vol) -> bytes:
    """VOS + VO + VOL headers (the ``esds`` decoder-specific info)."""
    bw = BitWriter()
    bw.put(32, 0x1B0)
    bw.put(8, 1)                                 # profile_and_level_indication
    bw.put(32, 0x1B5)
    bw.put(8, 0x89)                              # identifier, verid 1, priority 1
    bw.put(4, 1)                                 # video
    bw.put(1, 0)                                 # no video_signal_type
    bw.stuff()
    bw.put(32, 0x100)                            # video_object_start_code
    bw.put(32, 0x120)                            # video_object_layer_start_code
    bw.put(1, 0)
    bw.put(8, 1)                                 # simple object
    bw.put(1, 1)
    bw.put(4, 1)
    bw.put(3, 1)
    bw.put(4, 1)                                 # square pixels
    bw.put(1, 1)                                 # vol_control_parameters
    bw.put(2, 1)                                 # 4:2:0
    bw.put(1, 1)                                 # low_delay
    bw.put(1, 0)                                 # no vbv_parameters
    bw.put(2, 0)                                 # rectangular
    bw.put(1, 1)
    bw.put(16, vol.time_res)
    bw.put(1, 1)
    bw.put(1, 0)                                 # fixed_vop_rate
    bw.put(1, 1)
    bw.put(13, vol.width)
    bw.put(1, 1)
    bw.put(13, vol.height)
    bw.put(1, 1)
    bw.put(1, 0)                                 # progressive
    bw.put(1, 1)                                 # obmc_disable
    bw.put(1, 0)                                 # no sprite
    bw.put(1, 0)                                 # 8 bits
    bw.put(1, 0)                                 # H.263 quantization
    bw.put(1, 1)                                 # complexity_estimation_disable
    bw.put(1, 1)                                 # resync_marker_disable
    bw.put(1, 0)                                 # no data partitioning
    bw.put(1, 0)                                 # no scalability
    bw.stuff()
    return bw.getvalue()


def parse_config(data: bytes) -> Vol:
    """The VOL of a decoder-specific info (or of a sample) holding one."""
    for code, pos in start_codes(data):
        if 0x20 <= code <= 0x2F:
            return parse_vol(data, pos)
    raise ValueError("MPEG-4 stream without a VOL header")


def find_vop(data: bytes, vol: Vol):
    """(offset of the VOP payload, a VOL found before it or None) in a
    sample; a short-header or second VOP raises."""
    new_vol, vop = None, None
    if len(data) > 2 and data[:2] == b"\x00\x00" and (data[2] & 0xFC) == 0x80:
        raise ValueError(f"MPEG-4 short header (H.263) VOPs are not supported ({ROADMAP_ER})")
    for code, pos in start_codes(data):
        if 0x20 <= code <= 0x2F:
            new_vol = parse_vol(data, pos)
        elif code == 0xB6:
            if vop is not None:
                raise ValueError(f"an MPEG-4 sample with two VOPs (packed B-VOPs) is not "
                                 f"supported ({ROADMAP_ASP})")
            vop = pos
    if vop is None:
        raise ValueError("MPEG-4 sample without a VOP")
    return vop, new_vol


# --------------------------------------------------------------------------- #
# V1: the VLC stage (plain version)
# --------------------------------------------------------------------------- #
class VopSyntax:
    """A VOP's header values and syntax arrays (see the module docstring).
    ``header``: [coding type, vop_coded, rounding type, vop_quant, fcode,
    intra_dc_vlc_thr, modulo_time_base ones, vop_time_increment]."""

    def __init__(self, nmb, header=None):
        self.header = np.zeros(8, np.int32) if header is None else np.asarray(header, np.int32)
        self.mode = np.zeros(nmb, np.int8)
        self.qp = np.zeros(nmb, np.int8)
        self.acpred = np.zeros(nmb, np.int8)
        self.mv = np.zeros((nmb, 5, 2), np.int16)
        self.levels = np.zeros((nmb, 6, 64), np.int16)

    kind = property(lambda self: int(self.header[0]))
    coded = property(lambda self: bool(self.header[1]))
    rounding = property(lambda self: int(self.header[2]))

    def arrays(self):
        return (self.header, self.mode, self.qp, self.acpred, self.mv, self.levels)

    def equal(self, other) -> bool:
        return all(np.array_equal(a, b) for a, b in zip(self.arrays(), other.arrays()))


def _wrap16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def _rounded_div(a: int, b: int) -> int:
    n = a + (b >> 1) if a >= 0 else a - (b >> 1)
    return int(n / b) if n >= 0 else -((-n) // b)


def mid_pred(a, b, c):
    return max(min(a, b), min(max(a, b), c))


def chroma_mv(mode, mv4):
    """The chroma vector (half-pel of the chroma planes) of an MB's luma
    vectors ``mv4`` (4, 2): for 1MV (l >> 1) | (l & 1); for 4MV the sum of
    the four through H.263's sixteenth-pel rounding table."""
    out = [0, 0]
    for k in range(2):
        if mode == INTER4V:
            s = int(sum(int(v[k]) for v in mv4))
            out[k] = CHROMA_ROUND[s & 15] + ((s >> 3) & ~1)
        else:
            v = int(mv4[0][k])
            out[k] = (v >> 1) | (v & 1)
    return out


class _Pred:
    """The per-VOP prediction state of V1 (both directions): DC values, AC
    rows/columns and quantisers of intra blocks, and the MV grid, as
    libavcodec keeps them (outside the picture or in a non-intra MB: DC
    1024, AC 0, MV 0)."""

    def __init__(self, mbw, mbh):
        self.mbw, self.mbh = mbw, mbh
        self.dc = [np.full((2 * mbh, 2 * mbw), 1024, np.int64),
                   np.full((mbh, mbw), 1024, np.int64), np.full((mbh, mbw), 1024, np.int64)]
        self.ac = [np.zeros((2 * mbh, 2 * mbw, 2, 8), np.int64),
                   np.zeros((mbh, mbw, 2, 8), np.int64), np.zeros((mbh, mbw, 2, 8), np.int64)]
        self.mbqp = np.zeros((mbh, mbw), np.int64)
        self.mvg = np.zeros((2 * mbh, 2 * mbw, 2), np.int64)

    @staticmethod
    def where(n, mbx, mby):
        """(plane, row, column) of block n of an MB in the DC/AC grids."""
        if n < 4:
            return 0, 2 * mby + (n >> 1), 2 * mbx + (n & 1)
        return n - 3, mby, mbx

    def dc_pred(self, n, mbx, mby, qscale):
        """(prediction of the quantized DC, direction: 0 left, 1 top, scale)"""
        c, y, x = self.where(n, mbx, mby)
        g = self.dc[c]
        a = int(g[y, x - 1]) if x > 0 else 1024
        b = int(g[y - 1, x - 1]) if x > 0 and y > 0 else 1024
        cc = int(g[y - 1, x]) if y > 0 else 1024
        scale = int(Y_DC_SCALE[qscale] if n < 4 else C_DC_SCALE[qscale])
        if abs(a - b) < abs(b - cc):
            pred, direction = cc, 1
        else:
            pred, direction = a, 0
        return (pred + (scale >> 1)) // scale, direction, scale

    def store_dc(self, n, mbx, mby, level, scale):
        c, y, x = self.where(n, mbx, mby)
        v = level * scale
        if v & ~2047:
            v = 0 if v < 0 else 2047
        self.dc[c][y, x] = v

    def ac_pred(self, n, mbx, mby, direction, qscale):
        """The seven predicted levels (first column for left, first row for
        top) from the neighbour, rescaled to ``qscale``."""
        c, y, x = self.where(n, mbx, mby)
        if direction == 0:
            if x == 0:
                return [0] * 7
            vals = self.ac[c][y, x - 1, 0, 1:]
            same = mbx == 0 or n in (1, 3) or self.mbqp[mby, mbx - 1] == qscale
            q = int(self.mbqp[mby, mbx - 1]) if mbx > 0 else qscale
        else:
            if y == 0:
                return [0] * 7
            vals = self.ac[c][y - 1, x, 1, 1:]
            same = mby == 0 or n in (2, 3) or self.mbqp[mby - 1, mbx] == qscale
            q = int(self.mbqp[mby - 1, mbx]) if mby > 0 else qscale
        if same:
            return [int(v) for v in vals]
        return [_rounded_div(int(v) * q, qscale) for v in vals]

    def store_ac(self, n, mbx, mby, block):
        c, y, x = self.where(n, mbx, mby)
        self.ac[c][y, x, 0, 1:] = block[8:64:8][:7]
        self.ac[c][y, x, 1, 1:] = block[1:8]

    def mv_pred(self, block, mbx, mby):
        """libavcodec's ff_h263_pred_motion (no resync markers)."""
        g = self.mvg
        by, bx = 2 * mby + (block >> 1), 2 * mbx + (block & 1)
        W2 = 2 * self.mbw

        def at(y, x):
            if y < 0 or x < 0 or x >= W2:
                return (0, 0)
            return (int(g[y, x, 0]), int(g[y, x, 1]))

        A = at(by, bx - 1)
        if mby == 0 and block < 3:
            if block == 0:
                return (0, 0) if mbx == 0 else A
            if block == 1:
                return A
            B, C = at(by - 1, bx), at(by - 1, bx + 1)   # blocks 0 and 1 of this MB
            return (mid_pred(A[0], B[0], C[0]), mid_pred(A[1], B[1], C[1]))
        off = (2, 1, 1, -1)[block]
        B, C = at(by - 1, bx), at(by - 1, bx + off)
        return (mid_pred(A[0], B[0], C[0]), mid_pred(A[1], B[1], C[1]))


def _sign_extend(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _decode_motion(br, pred, fcode, counts):
    code = br.vlc(T_MVD, counts)
    if code == 0:
        return pred
    sign = br.read(1)
    shift = fcode - 1
    val = code
    if shift:
        val = ((val - 1) << shift) | br.read(shift)
        val += 1
    if sign:
        val = -val
    return _sign_extend(val + pred, 5 + fcode)


def _read_tcoef(br, intra, counts):
    """(last, run, signed level) of one TCOEF, escapes included."""
    t = T_INTRA if intra else T_INTER
    v = br.vlc(t, counts)
    if v != TC_ESCAPE:
        sign = br.read(1)
        last, run, level = v >> 12, (v >> 6) & 63, v & 63
        return last, run, -level if sign else level
    max_level, max_run = MAXIMA[intra]
    if not br.read(1):
        mode = 1
    elif not br.read(1):
        mode = 2
    else:
        last, run = br.read(1), br.read(6)
        _marker(br)
        level = _sign_extend(br.read(12), 12)
        _marker(br)
        if level == 0 or level == -2048:
            raise ValueError(f"corrupt MPEG-4 stream: forbidden escape-3 level {level}")
        if counts is not None:
            counts[("escape", intra, 3)] = counts.get(("escape", intra, 3), 0) + 1
        return last, run, level
    v = br.vlc(t, counts)
    if v == TC_ESCAPE:
        raise ValueError("corrupt MPEG-4 stream: an escape inside an escape")
    last, run, level = v >> 12, (v >> 6) & 63, v & 63
    if mode == 1:
        level += int(max_level[last, run])
    else:
        run += int(max_run[last, level]) + 1
    sign = br.read(1)
    if counts is not None:
        counts[("escape", intra, mode)] = counts.get(("escape", intra, mode), 0) + 1
    return last, run, -level if sign else level


def _read_block(br, block, start, scan, intra, counts):
    """Run-level codes into ``block`` (natural order) from scan position
    ``start`` (-1: the DC too)."""
    i = start
    while True:
        last, run, level = _read_tcoef(br, intra, counts)
        i += run + 1
        if i > 63:
            raise ValueError("corrupt MPEG-4 stream: a run past the block's end")
        block[scan[i]] = level
        if last:
            return


def _resync_marker(br, kind, fcode) -> bool:
    """Whether a resync marker (after stuffing) starts here."""
    p = br.p
    pad = 8 - (p & 7) if p & 7 else 8
    stuff = br.peek(pad)
    if stuff != (1 << (pad - 1)) - 1:
        return False
    n = 16 + (fcode - 1 if kind == P_VOP else 0)
    br.p += pad
    hit = br.peek(n + 1) == 1
    br.p = p
    return hit


def vlc_decode_ref(data, vol: Vol, counts: dict = None) -> VopSyntax:
    """V1's plain version: the bytes of one VOP, from after its start code
    (00 00 01 B6), to its :class:`VopSyntax`. ``counts`` (a dict) receives
    {(table, value): uses} and {("escape", intra, mode): uses}."""
    mbw, mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
    nmb = mbw * mbh
    br = BitReader(data)
    kind = br.read(2)
    if kind == 2:
        raise ValueError(f"MPEG-4 B-VOPs are not supported ({ROADMAP_ASP})")
    if kind == 3:
        raise ValueError(f"MPEG-4 S-VOPs (GMC) are not supported ({ROADMAP_ASP})")
    ones = 0
    while br.read(1):
        ones += 1
    _marker(br)
    incr = br.read(vol.time_bits)
    _marker(br)
    out = VopSyntax(nmb)
    h = out.header
    h[0], h[6], h[7] = kind, ones, incr
    if not br.read(1):
        return out
    h[1] = 1
    h[2] = br.read(1) if kind == P_VOP else 0
    h[5] = br.read(3)
    h[3] = quant = br.read(5)
    if quant == 0:
        raise ValueError("corrupt MPEG-4 VOP: vop_quant 0")
    h[4] = fcode = br.read(3) if kind == P_VOP else 1
    if fcode == 0:
        raise ValueError("corrupt MPEG-4 VOP: vop_fcode_forward 0")
    thr = DC_THRESHOLD[h[5]]
    st = _Pred(mbw, mbh)
    qscale = quant
    for mb in range(nmb):
        mby, mbx = divmod(mb, mbw)
        if mb and vol.resync and _resync_marker(br, kind, fcode):
            raise ValueError(f"MPEG-4 video packets (resync markers) are not supported "
                             f"({ROADMAP_ER})")
        if kind == P_VOP:
            while True:
                if br.read(1):
                    cbpc = -1
                    break
                cbpc = br.vlc(T_MCBPC_P, counts)
                if cbpc != STUFFING:
                    break
            if cbpc < 0:                          # not_coded
                out.mode[mb], out.qp[mb] = NOT_CODED, qscale
                st.mbqp[mby, mbx] = qscale
                continue
        else:
            while True:
                cbpc = br.vlc(T_MCBPC_I, counts)
                if cbpc != STUFFING:
                    break
        mtype, cbpc = cbpc >> 2, cbpc & 3
        intra = mtype >= 3
        dquant = mtype in (1, 4)
        acp = br.read(1) if intra else 0
        cbpy = br.vlc(T_CBPY, counts)
        if not intra:
            cbpy ^= 15
        cbp = (cbpy << 2) | cbpc
        use_dc_vlc = qscale < thr
        if dquant:
            qscale = min(31, max(1, qscale + DQUANT[br.read(2)]))
        out.qp[mb], out.acpred[mb] = qscale, acp
        st.mbqp[mby, mbx] = qscale
        if intra:
            out.mode[mb] = INTRA
            for n in range(6):
                block = [0] * 64
                pred, direction, scale = st.dc_pred(n, mbx, mby, qscale)
                if use_dc_vlc:
                    size = br.vlc(T_DC_LUM if n < 4 else T_DC_CHROM, counts)
                    if size > 9:
                        raise ValueError(f"corrupt MPEG-4 stream: DC size {size} (more than "
                                         "9 bits is illegal for 8-bit video, as libavcodec "
                                         "rules)")
                    diff = 0
                    if size:
                        diff = br.read(size)
                        if not diff >> (size - 1):
                            diff -= (1 << size) - 1
                        if size > 8:
                            _marker(br)
                    block[0] = diff
                    start = 0
                else:
                    start = -1
                scan = SCANS[(1 + direction) if acp else 0]
                if cbp & (32 >> n):
                    _read_block(br, block, start, scan, True, counts)
                level = block[0] + pred
                if level < 0:
                    raise ValueError("corrupt MPEG-4 stream: a negative intra DC (libavcodec "
                                     "rejects it)")
                st.store_dc(n, mbx, mby, level, scale)
                block[0] = _wrap16(level)
                if acp:
                    p = st.ac_pred(n, mbx, mby, direction, qscale)
                    for k in range(1, 8):
                        idx = k * 8 if direction == 0 else k
                        block[idx] = _wrap16(block[idx] + p[k - 1])
                st.store_ac(n, mbx, mby, block)
                out.levels[mb, n] = block
            continue
        # inter MB
        if mtype == 2:
            out.mode[mb] = INTER4V
            for b in range(4):
                px, py = st.mv_pred(b, mbx, mby)
                mx = _decode_motion(br, px, fcode, counts)
                my = _decode_motion(br, py, fcode, counts)
                st.mvg[2 * mby + (b >> 1), 2 * mbx + (b & 1)] = (mx, my)
                out.mv[mb, b] = (mx, my)
        else:
            out.mode[mb] = INTER
            px, py = st.mv_pred(0, mbx, mby)
            mx = _decode_motion(br, px, fcode, counts)
            my = _decode_motion(br, py, fcode, counts)
            st.mvg[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = (mx, my)
            out.mv[mb, :4] = (mx, my)
        out.mv[mb, 4] = chroma_mv(out.mode[mb], out.mv[mb, :4])
        for n in range(6):
            if cbp & (32 >> n):
                block = [0] * 64
                _read_block(br, block, -1, ZIGZAG, False, counts)
                out.levels[mb, n] = block
    if br.p > br.n:
        raise ValueError("corrupt MPEG-4 VOP: truncated")
    return out


# --------------------------------------------------------------------------- #
# V1: the stream writer (plain version)
# --------------------------------------------------------------------------- #
def _write_motion(bw, val, fcode):
    if val == 0:
        bw.code(MVD[0])
        return
    bit_size = fcode - 1
    val = _sign_extend(val, 6 + bit_size)
    sign = int(val < 0)
    val = abs(val) - 1
    code = (val >> bit_size) + 1
    bw.code(MVD[code])
    bw.put(1, sign)
    bw.put(bit_size, val & ((1 << bit_size) - 1))


def _write_tcoef(bw, last, run, level, intra):
    table = TCOEF_INTRA if intra else TCOEF_INTER
    a, sign = abs(level), int(level < 0)
    cb = table.get((last, run, a))
    if cb is not None:
        bw.code(cb)
        bw.put(1, sign)
        return
    max_level, max_run = MAXIMA[intra]
    l1 = a - int(max_level[last, run])
    if max_level[last, run] and (last, run, l1) in table:
        bw.code(ESCAPE)
        bw.put(1, 0)
        bw.code(table[(last, run, l1)])
        bw.put(1, sign)
        return
    if a < 64 and max_run[last, a] >= 0:
        r2 = run - int(max_run[last, a]) - 1
        if r2 >= 0 and (last, r2, a) in table:
            bw.code(ESCAPE)
            bw.put(2, 2)
            bw.code(table[(last, r2, a)])
            bw.put(1, sign)
            return
    if not 0 < a <= 2047:
        raise ValueError(f"MPEG-4 level {level} cannot be coded")
    bw.code(ESCAPE)
    bw.put(2, 3)
    bw.put(1, last)
    bw.put(6, run)
    bw.put(1, 1)
    bw.put(12, level & 0xFFF)
    bw.put(1, 1)


def _write_block(bw, block, start, scan, intra):
    coefs = [(i, int(block[scan[i]])) for i in range(start, 64) if block[scan[i]]]
    prev = start - 1
    for k, (i, level) in enumerate(coefs):
        _write_tcoef(bw, int(k == len(coefs) - 1), i - prev - 1, level, intra)
        prev = i


def write_vop_header(bw, vol: Vol, header):
    kind, coded, rounding, quant, fcode, dc_thr, ones, incr = (int(v) for v in header)
    bw.put(32, 0x1B6)
    bw.put(2, kind)
    for _ in range(ones):
        bw.put(1, 1)
    bw.put(1, 0)
    bw.put(1, 1)
    bw.put(vol.time_bits, incr)
    bw.put(1, 1)
    bw.put(1, coded)
    if not coded:
        return
    if kind == P_VOP:
        bw.put(1, rounding)
    bw.put(3, dc_thr)
    bw.put(5, quant)
    if kind == P_VOP:
        bw.put(3, fcode)


def vlc_encode_ref(syn: VopSyntax, vol: Vol, stuffing=()) -> bytes:
    """V1's stream writer (plain version): a :class:`VopSyntax` -> the VOP's
    bytes, start code included. ``acpred`` -1 decides AC prediction per MB
    by the coefficient-magnitude rule (libavcodec's ``decide_ac_pred``); 0
    and 1 force it. An MB's quantiser may differ from the previous MB's by
    at most 2 (dquant); a not_coded MB keeps it. ``mv[:, 4]`` is not read
    (V1 derives the chroma vector). Levels are the decoded ones: the writer
    codes the DC and AC prediction differences. A stuffing code goes before
    each MB listed in ``stuffing``."""
    mbw, mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
    bw = BitWriter()
    write_vop_header(bw, vol, syn.header)
    kind, coded, _, quant, fcode, dc_thr = (int(v) for v in syn.header[:6])
    if not coded:
        bw.stuff()
        return bw.getvalue()
    thr = DC_THRESHOLD[dc_thr]
    st = _Pred(mbw, mbh)
    qscale = quant
    lim = 32 << (fcode - 1)
    for mb in range(mbw * mbh):
        mby, mbx = divmod(mb, mbw)
        mode, qp = int(syn.mode[mb]), int(syn.qp[mb])
        levels = syn.levels[mb].astype(np.int64)
        if kind == I_VOP and mode != INTRA:
            raise ValueError("an I-VOP holds intra MBs only")
        if mb in stuffing:
            if kind == P_VOP:
                bw.put(1, 0)
            bw.code((MCBPC_I if kind == I_VOP else MCBPC_P)[STUFFING])
        if mode == NOT_CODED:
            if qp != qscale:
                raise ValueError("a not_coded MB keeps the quantiser")
            bw.put(1, 1)
            st.mbqp[mby, mbx] = qscale
            continue
        dq = qp - qscale
        if dq not in (0, -1, -2, 1, 2):
            raise ValueError(f"MB {mb}: quantiser step {dq} is not a dquant")
        if mode == INTER4V and dq:
            raise ValueError(f"MB {mb}: 4MV with dquant is not MPEG-4 syntax")
        if kind == P_VOP:
            bw.put(1, 0)
        use_dc_vlc = qscale < thr
        qscale = qp
        st.mbqp[mby, mbx] = qscale
        if mode == INTRA:
            blocks, dirs, preds = [], [], []
            for n in range(6):       # predictions in block order, as the decoder's
                b = [int(v) for v in levels[n]]
                pred, direction, scale = st.dc_pred(n, mbx, mby, qscale)
                st.store_dc(n, mbx, mby, b[0], scale)
                dirs.append(direction)
                preds.append(st.ac_pred(n, mbx, mby, direction, qscale))
                st.store_ac(n, mbx, mby, b)
                b[0] -= pred
                blocks.append(b)
            acp = int(syn.acpred[mb])
            if acp < 0:        # decide_ac_pred: sum |level - pred| < sum |level|
                score = 0
                for n in range(6):
                    for k in range(1, 8):
                        idx = k * 8 if dirs[n] == 0 else k
                        lv = blocks[n][idx]
                        score += abs(lv - preds[n][k - 1]) - abs(lv)
                acp = int(score < 0)
            for n in range(6):
                if acp:
                    for k in range(1, 8):
                        idx = k * 8 if dirs[n] == 0 else k
                        blocks[n][idx] -= preds[n][k - 1]
            first = 1 if use_dc_vlc else 0
            cbp = 0
            for n in range(6):
                if any(blocks[n][first:]):
                    cbp |= 32 >> n
            value = (16 if dq else 12) + (cbp & 3)
            bw.code((MCBPC_I if kind == I_VOP else MCBPC_P)[value])
            bw.put(1, acp)
            bw.code(CBPY[cbp >> 2])
            if dq:
                bw.put(2, DQUANT.index(dq))
            for n in range(6):
                scan = SCANS[(1 + dirs[n]) if acp else 0]
                if use_dc_vlc:
                    diff = blocks[n][0]
                    size = abs(diff).bit_length()
                    if size > 12:
                        raise ValueError(f"MB {mb}: DC difference {diff} cannot be coded")
                    bw.code((DC_LUM if n < 4 else DC_CHROM)[size])
                    if size:
                        bw.put(size, diff if diff > 0 else diff + (1 << size) - 1)
                        if size > 8:
                            bw.put(1, 1)
                if cbp & (32 >> n):
                    _write_block(bw, blocks[n], first, scan, True)
            continue
        # inter
        mv = syn.mv[mb, :4].astype(np.int64)
        if (mv < -lim).any() or (mv >= lim).any():
            raise ValueError(f"MB {mb}: a vector outside fcode {fcode}'s range")
        cbp = 0
        for n in range(6):
            if levels[n].any():
                cbp |= 32 >> n
        value = (8 if mode == INTER4V else (4 if dq else 0)) + (cbp & 3)
        bw.code(MCBPC_P[value])
        bw.code(CBPY[(cbp >> 2) ^ 15])
        if dq:
            bw.put(2, DQUANT.index(dq))
        if mode == INTER4V:
            for b in range(4):
                px, py = st.mv_pred(b, mbx, mby)
                _write_motion(bw, int(mv[b, 0]) - px, fcode)
                _write_motion(bw, int(mv[b, 1]) - py, fcode)
                st.mvg[2 * mby + (b >> 1), 2 * mbx + (b & 1)] = mv[b]
        else:
            px, py = st.mv_pred(0, mbx, mby)
            _write_motion(bw, int(mv[0, 0]) - px, fcode)
            _write_motion(bw, int(mv[0, 1]) - py, fcode)
            st.mvg[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = mv[0]
        for n in range(6):
            if cbp & (32 >> n):
                _write_block(bw, levels[n], 0, ZIGZAG, False)
    bw.stuff()
    return bw.getvalue()


# --------------------------------------------------------------------------- #
# V2: the decode pixel stage (plain version)
# --------------------------------------------------------------------------- #
class Geometry:
    """A frame's planes: the visible ``W`` x ``H``, MB-aligned Y (``YW`` x
    ``YH``) and chroma planes, packed Y, Cb, Cr in one uint8 buffer of
    ``size`` bytes. Motion compensation clamps reference coordinates to the
    MB-aligned planes (libavcodec's ``h_edge_pos`` / ``v_edge_pos`` are the
    coded size); a 4MV block's start is first clipped to [-16, W] x
    [-16, H] (chroma [-8, W/2] x [-8, H/2]), its half-pel step dropped at
    the clip's far end, as ``hpel_motion`` / ``chroma_4mv_motion`` do."""

    def __init__(self, W, H):
        self.W, self.H = int(W), int(H)
        self.mbw, self.mbh = (self.W + 15) // 16, (self.H + 15) // 16
        self.nmb = self.mbw * self.mbh
        self.YW, self.YH = 16 * self.mbw, 16 * self.mbh
        self.CW, self.CH = 8 * self.mbw, 8 * self.mbh
        self.size = self.YW * self.YH + 2 * self.CW * self.CH

    def vector(self) -> np.ndarray:
        return np.array([self.W, self.H, self.mbw, self.mbh], np.int32)

    def split(self, planes):
        """(Y, Cb, Cr) views of a packed buffer (..., size)."""
        ys = self.YW * self.YH
        cs = self.CW * self.CH
        lead = planes.shape[:-1]
        return (planes[..., :ys].reshape(lead + (self.YH, self.YW)),
                planes[..., ys:ys + cs].reshape(lead + (self.CH, self.CW)),
                planes[..., ys + cs:].reshape(lead + (self.CH, self.CW)))

    def __eq__(self, other):
        return isinstance(other, Geometry) and (self.W, self.H) == (other.W, other.H)

    def __hash__(self):
        return hash((self.W, self.H))


W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def dequantize_ref(levels, mode, qp) -> np.ndarray:
    """H.263 dequantization of (nmb, 6, 64) levels -> int16 coefficients:
    intra DC times the DC scaler, other levels |L| * 2qp + ((qp - 1) | 1);
    inter ones clipped to [-2048, 2047] (libavcodec's escape-3 rule; no
    other code reaches it); intra ones wrapped to int16 as libavcodec
    stores them."""
    L = np.asarray(levels).astype(np.int32)
    q = np.asarray(qp).astype(np.int32)[:, None, None]
    intra = (np.asarray(mode) == INTRA)[:, None, None]
    qmul, qadd = 2 * q, (q - 1) | 1
    v = np.where(L > 0, L * qmul + qadd, np.where(L < 0, L * qmul - qadd, 0))
    inter = np.clip(v, -2048, 2047)
    qi = np.asarray(qp).astype(np.int64)
    dcs = np.stack([Y_DC_SCALE[qi]] * 4 + [C_DC_SCALE[qi]] * 2, axis=1).astype(np.int32)
    intra_v = v.copy()
    intra_v[:, :, 0] = L[:, :, 0] * dcs
    out = np.where(intra, intra_v, inter)
    return out.astype(np.int16)    # wraps as libavcodec's int16_t block


def idct_ref(coefs) -> np.ndarray:
    """libavcodec's 8-bit simple IDCT (``simple_idct_template.c``): (..., 64)
    int16 coefficients in natural order -> (..., 64) int32 outputs before
    the put/add clamp (row pass with the DC-only shortcut, int16 row
    results, column pass in 32-bit wrapping arithmetic)."""
    c = np.asarray(coefs, np.int16).reshape(-1, 8, 8).astype(np.int32)
    r = [c[:, :, k] for k in range(8)]
    a0 = W4 * r[0] + (1 << 10)
    a1, a2, a3 = a0.copy(), a0.copy(), a0.copy()
    a0 = a0 + W2 * r[2]
    a1 = a1 + W6 * r[2]
    a2 = a2 - W6 * r[2]
    a3 = a3 - W2 * r[2]
    b0 = W1 * r[1] + W3 * r[3]
    b1 = W3 * r[1] - W7 * r[3]
    b2 = W5 * r[1] - W1 * r[3]
    b3 = W7 * r[1] - W5 * r[3]
    a0 = a0 + W4 * r[4] + W6 * r[6]
    a1 = a1 - W4 * r[4] - W2 * r[6]
    a2 = a2 - W4 * r[4] + W2 * r[6]
    a3 = a3 + W4 * r[4] - W6 * r[6]
    b0 = b0 + W5 * r[5] + W7 * r[7]
    b1 = b1 - W1 * r[5] - W5 * r[7]
    b2 = b2 + W7 * r[5] + W3 * r[7]
    b3 = b3 + W3 * r[5] - W1 * r[7]
    rows = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                     a3 - b3, a2 - b2, a1 - b1, a0 - b0], axis=-1) >> 11
    dc_only = ~(c[:, :, 1:] != 0).any(axis=-1)
    rows = np.where(dc_only[..., None], (r[0] * 8)[..., None], rows)
    rows = rows.astype(np.int16).astype(np.int32)     # int16 row results
    k = [rows[:, j, :] for j in range(8)]
    a0 = W4 * (k[0] + 32)
    a1, a2, a3 = a0.copy(), a0.copy(), a0.copy()
    a0 = a0 + W2 * k[2]
    a1 = a1 + W6 * k[2]
    a2 = a2 - W6 * k[2]
    a3 = a3 - W2 * k[2]
    b0 = W1 * k[1] + W3 * k[3]
    b1 = W3 * k[1] - W7 * k[3]
    b2 = W5 * k[1] - W1 * k[3]
    b3 = W7 * k[1] - W5 * k[3]
    a0 = a0 + W4 * k[4]
    a1 = a1 - W4 * k[4]
    a2 = a2 - W4 * k[4]
    a3 = a3 + W4 * k[4]
    b0 = b0 + W5 * k[5]
    b1 = b1 - W1 * k[5]
    b2 = b2 + W7 * k[5]
    b3 = b3 + W3 * k[5]
    a0 = a0 + W6 * k[6]
    a1 = a1 - W2 * k[6]
    a2 = a2 + W2 * k[6]
    a3 = a3 - W6 * k[6]
    b0 = b0 + W7 * k[7]
    b1 = b1 - W5 * k[7]
    b2 = b2 + W3 * k[7]
    b3 = b3 - W1 * k[7]
    out = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                    a3 - b3, a2 - b2, a1 - b1, a0 - b0], axis=1) >> 20
    return out.reshape(np.shape(coefs)[:-1] + (64,))


def _mc(ref, y0, x0, hy, hx, rounding, approx):
    """Half-pel 8x8 prediction from ``ref`` (2-D uint8) at block starts y0,
    x0 (nmb,) with half flags hy, hx (nmb,), coordinates clamped into the
    plane. Where ``approx`` (nmb,), a one-direction half-pel step without
    rounding is libavcodec's x86 8-wide ``put_no_rnd_pixels8_x2/_y2``
    (hpeldsp.asm, not bit-exact): x2 is pavgb(max(a - 1, 0), b) of a pixel
    a and its right neighbour b; y2 takes 1 off (saturating) the source
    rows at odd offsets in the block, then pavgb of the two rows."""
    eh, ew = ref.shape
    j = np.arange(8)
    ys = y0[:, None, None] + j[None, :, None]
    xs = x0[:, None, None] + j[None, None, :]
    hy, hx = hy[:, None, None].astype(bool), hx[:, None, None].astype(bool)
    ya, yb = np.clip(ys, 0, eh - 1), np.clip(ys + 1, 0, eh - 1)
    xa, xb = np.clip(xs, 0, ew - 1), np.clip(xs + 1, 0, ew - 1)
    a = ref[ya, xa].astype(np.int32)
    b = ref[ya, xb].astype(np.int32)
    c = ref[yb, xa].astype(np.int32)
    d = ref[yb, xb].astype(np.int32)
    rnd = 1 - rounding
    both = (a + b + c + d + 1 + rnd) >> 2
    if rounding:
        ap = approx[:, None, None]
        odd = (np.arange(8) & 1).astype(bool)[None, :, None]
        h = np.where(ap, (np.maximum(a - 1, 0) + b + 1) >> 1, (a + b) >> 1)
        v = np.where(ap, np.where(odd, (np.maximum(a - 1, 0) + c + 1) >> 1,
                                  (a + np.maximum(c - 1, 0) + 1) >> 1), (a + c) >> 1)
    else:
        h, v = (a + b + 1) >> 1, (a + c + 1) >> 1
    return np.where(hy & hx, both, np.where(hx, h, np.where(hy, v, a)))


def _clip_start(p, half, lo, hi, clip):
    """A 4MV block's start clipped to [lo, hi], its half step dropped at hi."""
    q = np.where(clip, np.clip(p, lo, hi), p)
    return q, np.where(clip & (q == hi), 0, half)


def predict_ref(ref_planes, mv, mode, geom: Geometry, rounding: int):
    """Motion-compensated prediction (nmb, 6, 64) int32 of every MB from
    the packed reference planes, with each MB's vectors ``mv`` (nmb, 5, 2)
    and ``mode`` (4MV clips its block starts)."""
    Y, Cb, Cr = geom.split(np.asarray(ref_planes))
    mv = np.asarray(mv).astype(np.int64)
    four = np.asarray(mode) == INTER4V
    n = np.arange(geom.nmb)
    mby, mbx = n // geom.mbw, n % geom.mbw
    out = np.zeros((geom.nmb, 6, 8, 8), np.int32)
    for b in range(4):
        mx, my = mv[:, b, 0], mv[:, b, 1]
        x, hx = _clip_start(mbx * 16 + (b & 1) * 8 + (mx >> 1), mx & 1, -16, geom.W, four)
        y, hy = _clip_start(mby * 16 + (b >> 1) * 8 + (my >> 1), my & 1, -16, geom.H, four)
        out[:, b] = _mc(Y, y, x, hy, hx, rounding, four)
    cx, cy = mv[:, 4, 0], mv[:, 4, 1]
    x, hx = _clip_start(mbx * 8 + (cx >> 1), cx & 1, -8, geom.W // 2, four)
    y, hy = _clip_start(mby * 8 + (cy >> 1), cy & 1, -8, geom.H // 2, four)
    eight = np.ones(geom.nmb, bool)
    out[:, 4] = _mc(Cb, y, x, hy, hx, rounding, eight)
    out[:, 5] = _mc(Cr, y, x, hy, hx, rounding, eight)
    return out.reshape(geom.nmb, 6, 64)


def decode_pixels_ref(levels, mode, qp, mv, ref_planes, geom: Geometry,
                      rounding: int) -> np.ndarray:
    """V2's reconstruction (plain version): one VOP's syntax arrays and the
    packed reference planes (None for an I-VOP) -> the packed planes of
    the decoded VOP, uint8 (size,)."""
    mode = np.asarray(mode)
    res = idct_ref(dequantize_ref(levels, mode, qp))            # (nmb, 6, 64)
    if ref_planes is None:
        if (mode != INTRA).any():
            raise ValueError("a P-VOP needs a reference")
        pred = np.zeros_like(res)
    else:
        pred = predict_ref(ref_planes, mv, mode, geom, rounding)
    intra = (mode == INTRA)[:, None, None]
    pix = np.clip(np.where(intra, res, pred + res), 0, 255).astype(np.uint8)
    pix = pix.reshape(geom.mbh, geom.mbw, 6, 8, 8)
    out = np.zeros(geom.size, np.uint8)
    Y, Cb, Cr = geom.split(out)
    Y[...] = pix[:, :, :4].reshape(geom.mbh, geom.mbw, 2, 2, 8, 8).transpose(
        0, 2, 4, 1, 3, 5).reshape(geom.YH, geom.YW)
    Cb[...] = pix[:, :, 4].transpose(0, 2, 1, 3).reshape(geom.CH, geom.CW)
    Cr[...] = pix[:, :, 5].transpose(0, 2, 1, 3).reshape(geom.CH, geom.CW)
    return out


# swscale's yuv2rgb for BT.601 limited-range input, as its x86 SIMD path
# computes it: 16-bit fixed point, pmulhw products (floor of x * c / 65536)
YUV2RGB_Y = 9539          # roundToInt16(76309 << 13): 255/219 in 2.13
YUV2RGB_Y_OFFSET = 128    # 16 << 3
YUV2RGB_UB = 16525        # roundToInt16(132201 << 13)
YUV2RGB_UG = -3209        # roundToInt16(-25675 << 13)
YUV2RGB_VG = -6660        # roundToInt16(-53279 << 13)
YUV2RGB_VR = 13075        # roundToInt16(104597 << 13)


def yuv_to_bgr_ref(planes, geom: Geometry) -> np.ndarray:
    """V2's colour conversion (plain version): packed planes (..., size) ->
    (..., H, W, 3) uint8 BGR, each chroma sample over its 2x2 pixels."""
    Y, Cb, Cr = geom.split(np.asarray(planes))
    y = Y[..., :geom.H, :geom.W].astype(np.int32)
    u = np.repeat(np.repeat(Cb, 2, -2), 2, -1)[..., :geom.H, :geom.W].astype(np.int32)
    v = np.repeat(np.repeat(Cr, 2, -2), 2, -1)[..., :geom.H, :geom.W].astype(np.int32)
    yc = ((y * 8 - YUV2RGB_Y_OFFSET) * YUV2RGB_Y) >> 16
    uc, vc = u * 8 - 1024, v * 8 - 1024
    b = yc + ((uc * YUV2RGB_UB) >> 16)
    g = yc + ((uc * YUV2RGB_UG) >> 16) + ((vc * YUV2RGB_VG) >> 16)
    r = yc + ((vc * YUV2RGB_VR) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# V3: the encode pixel stage (plain version)
# --------------------------------------------------------------------------- #
def bgr_to_yuv_ref(bgr, geom: Geometry):
    """BGR (H, W, 3) uint8 -> MB-aligned Y (YH, YW), Cb, Cr (CH, CW) int32:
    the frame edge-replicated to whole MBs, limited-range BT.601 in 8-bit
    fixed point, chroma as the rounded mean of each 2x2 pixels' values."""
    bgr = np.asarray(bgr)
    yy = np.minimum(np.arange(geom.YH), geom.H - 1)
    xx = np.minimum(np.arange(geom.YW), geom.W - 1)
    p = bgr[yy][:, xx].astype(np.int32)
    b, g, r = p[..., 0], p[..., 1], p[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128

    def sub(c):
        return (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + 2) >> 2

    return y, sub(u), sub(v)


def fdct_ref(blocks) -> np.ndarray:
    """libjpeg's islow FDCT (8 times the orthonormal DCT) of (..., 8, 8)
    int64 samples -> (..., 64) int64 in natural order."""
    s = np.asarray(blocks, np.int64)
    rows = _fdct_1d([s[..., :, k] for k in range(8)], 11, True)
    ws = np.stack(rows, axis=-1)
    cols = _fdct_1d([ws[..., k, :] for k in range(8)], 15, False)
    return np.stack(cols, axis=-2).reshape(s.shape[:-2] + (64,))


def quantize_intra_ref(coef, qp: int, chroma) -> np.ndarray:
    """islow coefficients of (sample - 128) -> intra levels: DC the rounded
    quotient of the true DC by the DC scaler, AC |F| / 2qp (F = coef / 8)."""
    dcs = np.where(chroma, C_DC_SCALE[qp], Y_DC_SCALE[qp])[..., None]
    a = np.abs(coef)
    lv = np.where(coef < 0, -(a // (16 * qp)), a // (16 * qp))
    dc = (coef[..., :1] + 8192 + 4 * dcs) // (8 * dcs)
    return np.concatenate([dc, lv[..., 1:]], axis=-1)


def quantize_inter_ref(coef, qp: int) -> np.ndarray:
    """islow coefficients of a residual -> inter levels (|F| - qp/2) / 2qp."""
    a = np.maximum(np.abs(coef) - 4 * qp, 0) // (16 * qp)
    return np.where(coef < 0, -a, a)


def encode_pixels_ref(bgr, ref_planes, qp: int, geom: Geometry) -> np.ndarray:
    """V3's plain version: one (H, W, 3) uint8 BGR frame -> (nmb, 6, 64) int16
    levels: intra levels of the source (``ref_planes`` None) or inter
    levels of its residual against the zero-motion prediction from the
    packed reference planes (V2's reconstruction)."""
    y, u, v = bgr_to_yuv_ref(bgr, geom)
    mbh, mbw = geom.mbh, geom.mbw
    yb = y.reshape(mbh, 2, 8, mbw, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(geom.nmb, 4, 8, 8)
    cb = [c.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(geom.nmb, 1, 8, 8)
          for c in (u, v)]
    src = np.concatenate([yb] + cb, axis=1).astype(np.int64)      # (nmb, 6, 8, 8)
    chroma = np.array([False] * 4 + [True] * 2)[None, :]
    if ref_planes is None:
        lv = quantize_intra_ref(fdct_ref(src - 128), qp, chroma)
    else:
        pred = predict_ref(ref_planes, np.zeros((geom.nmb, 5, 2), np.int16),
                           np.full(geom.nmb, INTER), geom, 0)
        lv = quantize_inter_ref(fdct_ref(src - pred.reshape(src.shape)), qp)
    return np.clip(lv, -2047, 2047).astype(np.int16)


# --------------------------------------------------------------------------- #
# whole frames
# --------------------------------------------------------------------------- #
def encoder_syntax(levels, kind: int, qp: int, incr: int, ones: int) -> VopSyntax:
    """The syntax the encoder writes for V3's levels: intra MBs with AC
    prediction decided per MB (I-VOP), or per MB inter with a zero vector,
    not_coded where every level is 0 (P-VOP)."""
    levels = np.asarray(levels)
    nmb = levels.shape[0]
    syn = VopSyntax(nmb, [kind, 1, 0, qp, 1, 0, ones, incr])
    syn.levels[...] = levels
    syn.qp[:] = qp
    if kind == I_VOP:
        syn.mode[:] = INTRA
        syn.acpred[:] = -1
    else:
        syn.mode[:] = np.where(levels.reshape(nmb, -1).any(axis=1), INTER, NOT_CODED)
    return syn


def frame_times(n: int, time_res: int, incr: int):
    """(modulo_time_base ones, vop_time_increment) of frame ``n`` at one
    frame every ``incr`` ticks of ``time_res``."""
    t, t0 = n * incr, max(n - 1, 0) * incr
    return t // time_res - (t0 // time_res if n else 0), t % time_res


# --------------------------------------------------------------------------- #
# seeded random syntax (the stream writer's test streams)
# --------------------------------------------------------------------------- #
def _events(rng, intra, escape3):
    """Run-level events of one block: table entries drawn at random, some
    made into escapes (1: a level past the run's largest; 2: a run past the
    level's longest; 3: a level of ``escape3`` (lo, hi))."""
    table = TCOEF_INTRA if intra else TCOEF_INTER
    max_level, max_run = MAXIMA[intra]
    keys = [sorted(k for k in table if k[0] == last) for last in (0, 1)]
    n = int(rng.integers(1, 6))
    out = []
    for k in range(n):
        last = int(k == n - 1)
        _, run, level = keys[last][rng.integers(len(keys[last]))]
        r = rng.random()
        if r < 0.1:
            level += int(max_level[last, run])
        elif r < 0.2 and max_run[last, level] >= 0:
            run += int(max_run[last, level]) + 1
        elif r < 0.25:
            level = int(rng.integers(*escape3))
        out.append((run, level if rng.random() < 0.5 else -level))
    return out


def _dequant_sum(block, intra, qp, n):
    q = np.abs(np.asarray(block, np.int64))
    v = np.where(q > 0, q * 2 * qp + ((qp - 1) | 1), 0)
    if intra:
        v[0] = q[0] * (Y_DC_SCALE[qp] if n < 4 else C_DC_SCALE[qp])
    else:
        v = np.minimum(v, 2048)
    return int(v.sum())


def random_syntax(rng, vol: Vol, kind: int, ones: int = 0, incr: int = 0,
                  wild_dc: bool = False, escape3=(28, 48)) -> VopSyntax:
    """A VOP of seeded random syntax for the stream writer: every MB mode
    (P-VOP: not_coded, 1MV, 4MV, intra), dquant steps, ``ac_pred`` forced
    on or off or decided, vectors up to the fcode's range (pointing past
    the picture), every intra DC threshold, run-level events drawn from
    every table entry and escape. Each block's dequantized magnitudes sum
    below 2800, so that no IDCT row leaves 16 bits (libavcodec's x86 IDCT
    saturates where its C IDCT wraps). With ``wild_dc`` (an I-VOP) the
    quantiser stays in 1..4 (DC scaler 8), every DC goes through the DC
    size tables and a third of the blocks are a lone DC level drawn from
    [0, 511], to reach DC sizes up to 9, the largest libavcodec takes."""
    mbw, mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
    nmb = mbw * mbh
    fcode = int(rng.integers(1, 4)) if kind == P_VOP else 1
    quant = int(rng.integers(1, 5 if wild_dc else 32))
    syn = VopSyntax(nmb, [kind, 1, int(rng.integers(0, 2)) if kind == P_VOP else 0, quant,
                          fcode, int(rng.integers(0, 8)), ones, incr])
    if wild_dc:
        syn.header[5] = 0          # every DC through the DC size tables
    q, lim = quant, 32 << (fcode - 1)
    for mb in range(nmb):
        mode = INTRA if kind == I_VOP else int(rng.choice([NOT_CODED, INTER, INTER4V, INTRA],
                                                          p=[0.15, 0.4, 0.25, 0.2]))
        if mode in (INTER, INTRA) and not wild_dc and rng.random() < 0.3:
            q = int(np.clip(q + rng.choice([-2, -1, 1, 2]), 1, 31))
        syn.mode[mb], syn.qp[mb] = mode, q
        if mode == NOT_CODED:
            continue
        if mode == INTRA:
            syn.acpred[mb] = int(rng.choice([-1, 0, 1]))
        else:
            far = rng.random() < 0.3
            mv = rng.integers(-lim, lim, (4, 2)) if far else rng.integers(-6, 7, (4, 2))
            if mode == INTER:
                mv[:] = mv[0]
            syn.mv[mb, :4] = mv
            syn.mv[mb, 4] = chroma_mv(mode, mv)
        for n in range(6):
            block = np.zeros(64, np.int64)
            intra = mode == INTRA
            if intra:
                dcs = int((Y_DC_SCALE if n < 4 else C_DC_SCALE)[q])
                block[0] = rng.integers(0, 2047 // dcs + 1)
            if rng.random() < 0.7:
                pos = 1 if intra else 0
                for run, level in _events(rng, intra, escape3):
                    pos += run
                    if pos > 63:
                        break
                    block[ZIGZAG[pos]] = level
                    pos += 1
            while _dequant_sum(block, intra, q, n) >= 2800:
                nz = np.nonzero(block[1:] if intra else block)[0] + (1 if intra else 0)
                block[nz[np.argmax(np.abs(block[nz]))]] //= 2
            if intra and wild_dc and rng.random() < 0.3:
                block[:] = 0
                block[0] = int(rng.integers(0, 512))
            syn.levels[mb, n] = block
    return syn


# --------------------------------------------------------------------------- #
# files: decoding and encoding through V1-V3
# --------------------------------------------------------------------------- #
def vop_coded(data: bytes, vol: Vol) -> bool:
    """Whether a sample's VOP is coded (libavcodec outputs no frame for a
    VOP with ``vop_coded`` 0)."""
    pos, new_vol = find_vop(data, vol)
    vol = new_vol or vol
    br = BitReader(data[pos:pos + 16 + vol.time_bits // 8])
    br.read(2)
    while br.read(1):
        pass
    br.read(2 + vol.time_bits)
    return bool(br.read(1))


def _to(dev, *arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def decode_frames(video, device="cuda"):
    """Generator of the (H, W, 3) uint8 BGR frames of an ``mp4v`` track
    (:class:`mft_tpu_torch.io.container.VideoTrack`), as ``cv2.VideoCapture.read``
    gives them: V1 on the host (natively for a CUDA ``device``), then V2 on
    ``device``, a VOP after the other. A VOP with ``vop_coded`` 0 gives no
    frame, as libavcodec here."""
    from mft_tpu_torch.core.device import resolve_device
    from mft_tpu_torch.ops.mpeg4 import mpeg4_decode_pixels, mpeg4_vlc_decode
    dev = resolve_device(device)
    if video.codec != MPEG4:
        raise ValueError(f"decode_frames: a '{video.codec}' track is not MPEG-4 Part 2")
    vol = parse_config(video.config) if video.config else None
    shown = video.shown()

    def vlc(data):
        nonlocal vol
        pos, new_vol = find_vop(data, vol)
        if new_vol is not None:
            vol = new_vol
        if vol is None:
            raise ValueError("MPEG-4 stream without a VOL header")
        return vol, mpeg4_vlc_decode(data[pos:], vol, dev)

    ref, geom = None, None
    for k, data in enumerate(video.read_samples()):
        if not data:            # an AVI's dropped frame: no packet, no frame
            continue
        v, syn = vlc(data)
        if geom is None or (geom.W, geom.H) != (v.width, v.height):
            geom, ref = Geometry(v.width, v.height), None
        if not syn.coded:
            continue
        if syn.kind == P_VOP and ref is None:
            raise ValueError("MPEG-4 stream starts with a P-VOP")
        levels, mode, qp, mv = _to(dev, syn.levels, syn.mode, syn.qp, syn.mv)
        ref, img = mpeg4_decode_pixels(levels, mode, qp, mv, ref if syn.kind == P_VOP else None,
                                       geom, syn.rounding)
        if shown[k]:
            yield img.cpu().numpy()


class Mp4vEncoder:
    """A file with one ``mp4v`` track, in the container that its suffix names
    (:func:`mft_tpu_torch.io.container.open_writer`), written through V3 (card), V1
    (host) and V2 (card, the closed loop's reconstruction): an I-VOP every
    :data:`GOP` frames, between them P-VOPs of zero motion (each MB inter
    against the previous reconstruction, or not_coded where its residual
    quantizes to 0), the fixed quantiser :data:`ENCODER_QP`, AC prediction
    decided per MB by the coefficient-magnitude rule."""

    def __init__(self, path, fps, width, height, device="cuda"):
        from mft_tpu_torch.core.device import resolve_device
        from mft_tpu_torch.io.container import open_writer
        from mft_tpu_torch.io.mp4 import frame_rate
        self.dev = resolve_device(device)
        self.time_res, self.incr = frame_rate(fps)
        self.vol = Vol(width, height, self.time_res)
        self.geom = Geometry(width, height)
        self.writer = open_writer(path, fps, width, height, write_config(self.vol))
        self.ref = None
        self.n = 0
        self._mv = None

    def encode(self, frame):
        """One (H, W, 3) uint8 BGR frame -> the VOP's bytes (and the new
        reference planes kept)."""
        import torch

        from mft_tpu_torch.ops.mpeg4 import (mpeg4_decode_pixels, mpeg4_encode_pixels,
                                             mpeg4_vlc_encode)
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.shape != (self.geom.H, self.geom.W, 3):
            raise ValueError(f"frame of shape {frame.shape}, the file is "
                             f"{self.geom.H}x{self.geom.W}x3")
        kind = I_VOP if self.n % GOP == 0 else P_VOP
        img = torch.from_numpy(frame).to(self.dev)
        levels = mpeg4_encode_pixels(img, None if kind == I_VOP else self.ref, ENCODER_QP,
                                     self.geom)
        ones, incr = frame_times(self.n, self.time_res, self.incr)
        syn = encoder_syntax(levels.cpu().numpy(), kind, ENCODER_QP, incr, ones)
        if self._mv is None:
            self._mv = torch.zeros((self.geom.nmb, 5, 2), dtype=torch.int16, device=self.dev)
        mode, qp = _to(self.dev, syn.mode, syn.qp)
        self.ref, _ = mpeg4_decode_pixels(levels, mode, qp, self._mv,
                                          None if kind == I_VOP else self.ref, self.geom, 0,
                                          bgr=False)
        self.n += 1
        return mpeg4_vlc_encode(syn, self.vol, self.dev), kind == I_VOP

    def write(self, frame):
        self.writer.add(*self.encode(frame))

    def close(self):
        self.writer.close()
