"""Baseline JPEG decode and encode without OpenCV or PIL, and their plain
versions.

The JAX package reads and writes JPEG on the host through OpenCV and PIL
(``cv2.imread``/``cv2.imdecode``/``cv2.imencode``, ``PIL.Image.open``), which
run libjpeg-turbo's default algorithms. The card's machine has neither, so
the port carries its own codec, with those algorithms step for step, so that
it gives the same pixels bit for bit:

- decode: the islow IDCT (``jidctint.c``: CONST_BITS 13, PASS1_BITS 2, the
  range-limit table's 10-bit masking), ``jdsample.c``'s upsampling ("fancy"
  triangle filters h2v1/h1v2/h2v2 with their alternating biases, fancy h2v1
  and h2v2 only where a component is wider than 2 samples, replication for
  every other integral factor, 4:1:1 among them) and ``jdcolor.c``'s
  YCbCr -> RGB tables (16-bit fixed point);
- encode: ``jccolor.c``'s RGB -> YCbCr, ``jcsample.c``'s box downsampling
  (alternating bias, right edge expanded from the image, bottom rows from
  the last downsampled row), the islow FDCT (``jfdctint.c``) and
  ``jcdctmgr.c``'s quantization by reciprocal multiplication; IJG quality
  scaling of the Annex K tables (clamped to 1..255) and the standard Huffman
  tables, as ``cv2.imencode`` writes them without ``IMWRITE_JPEG_OPTIMIZE``;
  the bytes equal ``cv2.imencode``'s for the same image, quality, sampling
  and restart interval (:func:`encode_jpeg` writes cv2's default, 4:2:0
  without restarts; :func:`geometry_for` and :func:`file_header` with the
  stages below make the others).

A file is parsed here (SOI, APPn: JFIF, Adobe and the EXIF orientation,
DQT, SOF0/SOF1/SOF2, DHT, DRI, SOS with restart markers, EOI; several scans
of a sequential file are read). A progressive (SOF2) file's scans (DC first
and refinement, AC first and refinement, ``jdphuff.c``) accumulate into the
same coefficient array as a baseline file's, which the pixel stage takes
unchanged; its scans must bring every coefficient to its last bit, as the
progression scripts of cv2 and PIL do: a file that leaves bits unsent
(which libjpeg would smooth, ``jdcoefct.c``), a scan that breaks the
progression rules of ITU T.81 G.1.1.1 and a truncated file raise
``ValueError``. Lossless, arithmetic-coded, 12-bit, 2- and 4-component
files raise ``ValueError`` naming what they are.

Three stages, each with a plain version here and a native one in
:mod:`mft_tpu_torch.ops.jpeg`:

- entropy coding (J1): :func:`huff_decode_ref` / :func:`huff_encode_ref`
  (and :func:`huff_decode_progressive_ref` for a progressive scan), Python
  over a bit reader with byte unstuffing, restarts, DC prediction and
  zig-zag order; natively a host routine (``mft_jpeg_huff_decode`` /
  ``mft_jpeg_huff_decode_progressive`` / ``mft_jpeg_huff_encode``);
- decode pixels (J2): :func:`decode_pixels_ref`, dequantization + IDCT +
  upsampling + colour conversion of a batch of frames of one geometry;
- encode pixels (J3): :func:`encode_pixels_ref`, colour conversion +
  downsampling + FDCT + quantization.

Entry points (:func:`decode_jpeg`, :func:`decode_jpeg_frames`,
:func:`encode_jpeg`, :func:`jpeg_roundtrip`) take ``device="cuda"`` by
default: J1 natively on host threads, J2 and J3 on the card. With
``device="cpu"`` they run the plain versions.

Coefficient layout: a frame's quantized coefficients are one (blocks, 64)
int16 array in natural (row-major) order; component c's blocks start at
``Geometry.boff[c]`` as a row-major grid of ``bh[c] x bw[c]`` blocks (the
grid of whole MCUs; blocks outside the image's components are the
encoder's dummy blocks).
"""

import contextlib
import re
import struct
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# --------------------------------------------------------------------------- #
# tables
# --------------------------------------------------------------------------- #


def _natural_order():
    """jpeg_natural_order: the natural index of each zig-zag position, with
    16 extra entries of 63 that catch a run past the block's end."""
    order = []
    for s in range(15):
        rows = range(min(s, 7), max(0, s - 7) - 1, -1) if s % 2 == 0 else \
            range(max(0, s - 7), min(s, 7) + 1)
        order += [i * 8 + (s - i) for i in rows]
    return np.array(order + [63] * 16, np.int64)


NATURAL = _natural_order()
ZIGZAG = NATURAL[:64]

STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# Annex K.3 Huffman tables: (code counts per length 1..16, symbols)
STD_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
STD_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
STD_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
STD_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# cv2's IMWRITE_JPEG_SAMPLING_FACTOR names -> luma (h, v); chroma is 1 x 1
SAMPLINGS = {"411": (4, 1), "420": (2, 2), "422": (2, 1), "440": (1, 2), "444": (1, 1)}

# colour transforms of a frame
YCC, RGB, GREY = 0, 1, 2
# upsampling methods of a component (decode)
UP_FULL, UP_H2V1, UP_H1V2, UP_H2V2, UP_REPLICATE = range(5)

_SOF_NAMES = {0xC3: "lossless (SOF3)",
              0xC5: "differential sequential (SOF5)", 0xC6: "differential progressive (SOF6)",
              0xC7: "differential lossless (SOF7)", 0xC9: "arithmetic sequential (SOF9)",
              0xCA: "arithmetic progressive (SOF10)", 0xCB: "arithmetic lossless (SOF11)",
              0xCD: "arithmetic differential sequential (SOF13)",
              0xCE: "arithmetic differential progressive (SOF14)",
              0xCF: "arithmetic differential lossless (SOF15)"}


def quality_scaling(quality: int) -> int:
    """jcparam.c jpeg_quality_scaling: a quality 1..100 as a percentage."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - quality * 2


def quant_tables(quality: int):
    """(luma, chroma) int64 quantization tables in natural order, as
    ``jpeg_set_quality(quality, force_baseline=TRUE)`` makes them."""
    scale = quality_scaling(quality)
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMA_QT, STD_CHROMA_QT))


def reciprocals(qtab) -> np.ndarray:
    """jcdctmgr.c compute_reciprocal of each divisor ``q << 3`` (16-bit
    DCTELEM, as libjpeg-turbo builds it with its SIMD code): (..., 3, 64)
    int32 of (reciprocal, correction, shift), so that a coefficient x is
    quantized to sign(x) * (((|x| + correction) * reciprocal) >> shift)."""
    d = np.asarray(qtab, np.int64) << 3
    b = np.floor(np.log2(d)).astype(np.int64)          # flss(d) - 1
    r = 16 + b
    fq = (np.int64(1) << r) // d
    fr = (np.int64(1) << r) % d
    c = d // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, fq)
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= d // 2), c + 1, c)
    fq = np.where(~pow2 & (fr > d // 2), fq + 1, fq)
    return np.stack([fq, c, r], axis=-2).astype(np.int32)


# --------------------------------------------------------------------------- #
# Huffman tables
# --------------------------------------------------------------------------- #
def _codes(bits, vals):
    """Canonical codes: [(length, code, symbol)] of a DHT table."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((length, code, vals[k]))
            code += 1
            k += 1
        code <<= 1
    return out


def lookahead_table(bits, vals) -> np.ndarray:
    """A decoding table over every 16-bit window: (length << 8) | symbol of
    the code the window starts with, 0 where no code matches."""
    lut = np.zeros(1 << 16, np.uint16)
    for length, code, sym in _codes(bits, vals):
        if code >= 1 << length:
            raise ValueError("corrupt JPEG: bad Huffman table")
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = (length << 8) | sym
    return lut


def code_table(bits, vals) -> np.ndarray:
    """An encoding table: (length << 16) | code of every symbol, 0 where the
    table has none."""
    tab = np.zeros(256, np.int32)
    for length, code, sym in _codes(bits, vals):
        tab[sym] = (length << 16) | code
    return tab


STD_HUFF = {(0, 0): STD_DC_LUMA, (1, 0): STD_AC_LUMA, (0, 1): STD_DC_CHROMA,
            (1, 1): STD_AC_CHROMA}


def _std_code_tables():
    """(8, 256) encoding tables: DC slots 0-3, AC slots 4-7 (slots 0, 1 and
    4, 5 hold the standard luma and chroma tables)."""
    tabs = np.zeros((8, 256), np.int32)
    for (cls, slot), (bits, vals) in STD_HUFF.items():
        tabs[cls * 4 + slot] = code_table(bits, vals)
    return tabs


STD_CODE_TABLES = _std_code_tables()


# --------------------------------------------------------------------------- #
# geometry of a frame
# --------------------------------------------------------------------------- #
class Geometry:
    """Sizes and layouts of one frame: image size, components' sampling
    factors and colour transform (:data:`YCC`, :data:`RGB`, :data:`GREY`).

    Per component c: ``fh``/``fv`` the upsampling factors, ``dw``/``dh`` the
    downsampled size, ``bw``/``bh`` the block grid (whole MCUs when the
    frame has several components), ``rbw``/``rbh`` its blocks inside the
    component, ``boff`` its first block, ``poff`` its first sample in the
    planes of the decode, ``up`` its upsampling method, ``rows`` the rows
    the encoder's downsampling makes (later rows repeat the last).
    """

    def __init__(self, H: int, W: int, factors, color: int):
        if H < 1 or W < 1:
            raise ValueError(f"JPEG image size {H}x{W}")
        if len(factors) not in (1, 3):
            raise ValueError(f"{len(factors)}-component JPEGs are not supported")
        self.H, self.W, self.color = int(H), int(W), int(color)
        self.factors = tuple((int(h), int(v)) for h, v in factors)
        self.ncomp = len(factors)
        self.max_h = max(h for h, _ in self.factors)
        self.max_v = max(v for _, v in self.factors)
        self.mcux = -(-W // (8 * self.max_h))
        self.mcuy = -(-H // (8 * self.max_v))
        names = ("fh", "fv", "dw", "dh", "bw", "bh", "rbw", "rbh", "boff", "poff", "up", "rows")
        for n in names:
            setattr(self, n, [])
        boff = poff = 0
        for h, v in self.factors:
            if self.max_h % h or self.max_v % v:
                raise ValueError(f"fractional JPEG sampling factors {self.factors}")
            fh, fv = self.max_h // h, self.max_v // v
            dw, dh = -(-W * h // self.max_h), -(-H * v // self.max_v)
            rbw, rbh = -(-dw // 8), -(-dh // 8)
            bw, bh = (self.mcux * h, self.mcuy * v) if self.ncomp > 1 else (rbw, rbh)
            if fh == 1 and fv == 1:
                up = UP_FULL
            elif fh == 2 and fv == 1:
                up = UP_H2V1 if dw > 2 else UP_REPLICATE
            elif fh == 1 and fv == 2:
                up = UP_H1V2
            elif fh == 2 and fv == 2:
                up = UP_H2V2 if dw > 2 else UP_REPLICATE
            else:
                up = UP_REPLICATE
            for n, val in zip(names, (fh, fv, dw, dh, bw, bh, rbw, rbh, boff, poff, up,
                                      -(-H // self.max_v) * v)):
                getattr(self, n).append(val)
            boff += bw * bh
            poff += bw * bh * 64
        self.blocks, self.samples = boff, poff

    def key(self):
        return (self.H, self.W, self.factors, self.color)

    def __eq__(self, other):
        return isinstance(other, Geometry) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def vector(self) -> np.ndarray:
        """The int64 descriptor the kernels read: H, W, ncomp, color, max_h,
        max_v, blocks, samples, then per component (3 slots) h, v, fh, fv,
        dw, dh, bw, bh, boff, poff, up, rows."""
        out = [self.H, self.W, self.ncomp, self.color, self.max_h, self.max_v,
               self.blocks, self.samples]
        for c in range(3):
            if c < self.ncomp:
                out += [*self.factors[c], self.fh[c], self.fv[c], self.dw[c], self.dh[c],
                        self.bw[c], self.bh[c], self.boff[c], self.poff[c], self.up[c],
                        self.rows[c]]
            else:
                out += [0] * 12
        return np.array(out, np.int64)


def geometry_for(H: int, W: int, channels: int, sampling: str = "420") -> Geometry:
    """The encoder's geometry: grey for one channel, else YCbCr at
    ``sampling`` (a key of :data:`SAMPLINGS`)."""
    if channels == 1:
        return Geometry(H, W, [(1, 1)], GREY)
    if sampling not in SAMPLINGS:
        raise ValueError(f"sampling must be one of {sorted(SAMPLINGS)}, got {sampling!r}")
    return Geometry(H, W, [SAMPLINGS[sampling], (1, 1), (1, 1)], YCC)


# --------------------------------------------------------------------------- #
# parsing
# --------------------------------------------------------------------------- #
class Scan:
    """One scan: its entropy-coded bytes (stuffing and restart markers
    included) and what the entropy coder needs to place its blocks.

    A progressive file's scan (``progressive``) codes the band ``ss..se`` of
    zig-zag positions at successive-approximation bits ``ah``/``al``: a DC
    scan (``ss == 0``, first ``ah == 0`` or refinement), or an AC scan of one
    component (first or refinement)."""

    def __init__(self, data, comp_info, luts, mcux, mcuy, restart, progressive=False,
                 ss=0, se=63, ah=0, al=0):
        self.data = data              # bytes
        self.comp_info = comp_info    # (ns, 6) int32: h, v, dc slot, ac slot, bw, boff
        self.luts = luts              # (8, 65536) uint16 lookahead tables (DC 0-3, AC 4-7)
        self.mcux, self.mcuy, self.restart = mcux, mcuy, restart
        self.progressive = progressive
        self.ss, self.se, self.ah, self.al = ss, se, ah, al


class JpegFile:
    """A parsed file: :attr:`geom`, :attr:`qtabs` ((ncomp, 64) int32 in
    natural order, each component's table as its first scan latched it),
    :attr:`scans` and the EXIF :attr:`orientation` (1 when absent)."""

    def __init__(self, geom, qtabs, scans, orientation):
        self.geom, self.qtabs, self.scans, self.orientation = geom, qtabs, scans, orientation


def _exif_orientation(payload: bytes) -> int:
    """The orientation tag (0x0112) of an EXIF block's first IFD, 1 when
    absent or unreadable."""
    try:
        e = {b"II": "<", b"MM": ">"}[payload[:2]]
        ifd = struct.unpack(e + "I", payload[4:8])[0]
        n = struct.unpack(e + "H", payload[ifd:ifd + 2])[0]
        for i in range(n):
            entry = payload[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
            tag, kind = struct.unpack(e + "HH", entry[:4])
            if tag == 0x0112 and kind == 3:
                return struct.unpack(e + "H", entry[8:10])[0]
    except (KeyError, struct.error):
        pass
    return 1


def _scan_end(data: bytes, pos: int) -> int:
    """Offset of the first marker after ``pos`` that is neither a stuffed
    0xFF00 nor a restart marker (the end of the file if none)."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return n
        end = pos + 1
        while end < n and data[end] == 0xFF:           # fill bytes
            end += 1
        if end >= n:
            return pos
        if data[end] == 0 or 0xD0 <= data[end] <= 0xD7:
            pos = end + 1
            continue
        return pos


def parse_jpeg(data, huff: dict = None, qt: dict = None) -> JpegFile:
    """Parse a baseline, extended sequential (8-bit Huffman) or progressive
    (SOF2) JPEG file; ``ValueError`` for a file it cannot decode.

    ``huff`` ({(class, slot): (bits, values)}) and ``qt`` ({slot: (64,)
    natural-order table}), where given, are the tables in force before the
    file's own DHT and DQT segments, which update them in place: a video
    decoder keeps its tables from frame to frame (a Motion JPEG frame may
    carry none)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    try:
        return _parse(data, {} if huff is None else huff, {} if qt is None else qt)
    except (IndexError, struct.error):
        raise ValueError("corrupt JPEG: a marker segment is cut short") from None


def _parse(data: bytes, huff: dict, qt: dict) -> JpegFile:
    pos, n = 2, len(data)
    restart = 0
    sof, jfif, adobe, orientation = None, False, None, 1
    scans, latched, progressive, coef_bits = [], {}, False, None
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"corrupt JPEG: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:          # fill bytes
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:                                  # EOI
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG marker")
        length = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + length]
        pos += length
        if len(seg) != length - 2:
            raise ValueError(f"truncated JPEG segment 0x{m:02X}")
        if m in _SOF_NAMES:
            raise ValueError(f"{_SOF_NAMES[m]} JPEG files are not supported "
                             "(baseline, extended sequential and progressive Huffman only)")
        if m in (0xC0, 0xC1, 0xC2):
            if sof is not None:
                raise ValueError("corrupt JPEG: a second SOF marker")
            progressive = m == 0xC2
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG files are not supported (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{nc}-component JPEG files are not supported "
                                 "(grey and 3-component only)")
            if H == 0:
                raise ValueError("JPEG files whose height comes in a DNL marker are "
                                 "not supported")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
                      seg[8 + 3 * i]) for i in range(nc)]
            sof = (H, W, comps)
            coef_bits = np.full((nc, 64), -1, np.int64)   # jdinput.c's coef_bits
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = tuple(seg[i + 1:i + 17])
                cnt = sum(bits)
                vals = seg[i + 17:i + 17 + cnt]
                # a DC symbol is a bit count of at most 15 (jdhuff.c refuses more)
                if tc > 1 or th > 3 or len(vals) != cnt or (tc == 0 and max(vals, default=0) > 15):
                    raise ValueError("corrupt JPEG: bad DHT segment")
                huff[(tc, th)] = (bits, vals)
                i += 17 + cnt
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = seg[i + 1:i + 1 + size]
                if tq > 3 or len(raw) != size:
                    raise ValueError("corrupt JPEG: bad DQT segment")
                vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int32)
                tab = np.zeros(64, np.int32)
                tab[ZIGZAG] = vals
                qt[tq] = tab
                i += 1 + size
        elif m == 0xDD:
            restart = (seg[0] << 8) | seg[1]
        elif m == 0xE0:
            jfif = jfif or seg[:5] == b"JFIF\x00"
        elif m == 0xE1 and seg[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(seg[6:])
        elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif m == 0xDA:
            if sof is None:
                raise ValueError("corrupt JPEG: SOS before SOF")
            H, W, comps = sof
            geom = _geometry(H, W, comps, jfif, adobe)
            ns = seg[0]
            ids = [c[0] for c in comps]
            ss, se, ah, al = 0, 63, 0, 0
            if progressive:
                ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, \
                    seg[3 + 2 * ns] & 15
                _check_progression(coef_bits, [ids.index(seg[1 + 2 * j]) if seg[1 + 2 * j]
                                               in ids else -1 for j in range(ns)],
                                   ss, se, ah, al)
            info, luts, used = [], np.zeros((8, 1 << 16), np.uint16), set()
            for j in range(ns):
                cid, tables = seg[1 + 2 * j], seg[2 + 2 * j]
                if cid not in ids:
                    raise ValueError(f"corrupt JPEG: scan names component {cid}")
                ci = ids.index(cid)
                if ci not in latched:
                    tq = comps[ci][3]
                    if tq not in qt:
                        raise ValueError(f"corrupt JPEG: no quantization table {tq}")
                    latched[ci] = qt[tq].copy()
                td, ta = tables >> 4, tables & 15
                # a progressive scan reads the DC table in a first DC scan, the
                # AC table in an AC scan and neither in a DC refinement
                need = ((0, td), (1, ta)) if not progressive else \
                    (((0, td),) if ah == 0 else ()) if ss == 0 else ((1, ta),)
                td, ta = (td, ta) if not progressive else (
                    td if ss == 0 and ah == 0 else 0, ta if ss else 0)
                for cls, slot in need:
                    if (cls, slot) not in huff:
                        raise ValueError(f"corrupt JPEG: no Huffman table {cls}/{slot}")
                    if (cls, slot) not in used:
                        luts[cls * 4 + slot] = lookahead_table(*huff[(cls, slot)])
                        used.add((cls, slot))
                h, v = geom.factors[ci] if ns > 1 else (1, 1)
                info.append([h, v, td, 4 + ta, geom.bw[ci], geom.boff[ci]])
            if ns > 1:
                mcux, mcuy = geom.mcux, geom.mcuy
            else:
                ci = ids.index(seg[1])
                mcux, mcuy = geom.rbw[ci], geom.rbh[ci]
            end = _scan_end(data, pos)
            if progressive and end == n:
                raise ValueError("truncated progressive JPEG: a scan runs to the end of "
                                 "the file")
            scans.append(Scan(data[pos:end], np.array(info, np.int32), luts, mcux, mcuy,
                              restart, progressive, ss, se, ah, al))
            pos = end
    if sof is None or not scans:
        raise ValueError("corrupt JPEG: no frame or no scan")
    if progressive and np.any(coef_bits != 0):
        comp, k = (int(v[0]) for v in np.nonzero(coef_bits))
        raise ValueError(
            "progressive JPEG files whose scans leave coefficient bits unsent are not "
            f"supported (libjpeg smooths their blocks; component {comp}, coefficient {k} "
            f"at {int(coef_bits[comp, k])} bits unsent, -1 never sent)")
    geom = _geometry(sof[0], sof[1], sof[2], jfif, adobe)
    for c in range(geom.ncomp):              # a component no scan coded stays 0
        latched.setdefault(c, np.ones(64, np.int32))
    qtabs = np.stack([latched[c] for c in range(geom.ncomp)])
    return JpegFile(geom, qtabs, scans, orientation)


def _check_progression(coef_bits, comps, ss, se, ah, al):
    """Refuse a progressive scan whose parameters break ITU T.81 G.1.1.1, as
    libjpeg's ``start_pass_phuff_decoder`` refuses them (a DC band with
    Se > 0, an AC band out of order or over several components, a refinement
    whose Al is not Ah - 1, Al over 13) or only warns about them (an AC scan
    before the component's first DC scan, a band whose Ah is not the bits
    that earlier scans left unsent); then record the band's new Al in
    ``coef_bits`` (components x 64, -1 where nothing was sent yet)."""
    bad = se != 0 if ss == 0 else (ss > se or se > 63 or len(comps) != 1)
    if bad or (ah != 0 and al != ah - 1) or al > 13 or -1 in comps:
        raise ValueError(f"corrupt JPEG: invalid progressive scan (Ss {ss}, Se {se}, Ah {ah}, "
                         f"Al {al}, {len(comps)} components)")
    for ci in comps:
        bits = coef_bits[ci]
        if ss > 0 and bits[0] < 0:
            raise ValueError(f"corrupt JPEG: an AC scan of component {ci} before its first "
                             "DC scan")
        expected = np.maximum(bits[ss:se + 1], 0)
        if np.any(expected != ah) or (ah == 0 and np.any(bits[ss:se + 1] >= 0)):
            raise ValueError(f"corrupt JPEG: progressive scan of component {ci} out of order "
                             f"(Ss {ss}, Se {se}, Ah {ah})")
        bits[ss:se + 1] = al


def _geometry(H, W, comps, jfif, adobe) -> Geometry:
    factors = [(h, v) for _, h, v, _ in comps]
    if any(not (1 <= f <= 4) for hv in factors for f in hv):
        raise ValueError(f"corrupt JPEG: sampling factors {factors}")
    if len(comps) == 1:
        return Geometry(H, W, factors, GREY)
    # libjpeg's colour-space guess (jdapimin.c default_decompress_parms)
    if jfif:
        color = YCC
    elif adobe is not None:
        color = RGB if adobe == 0 else YCC
    else:
        color = RGB if [c[0] for c in comps] == [82, 71, 66] else YCC
    return Geometry(H, W, factors, color)


# --------------------------------------------------------------------------- #
# J1 plain: entropy decode and encode
# --------------------------------------------------------------------------- #
_RST = re.compile(rb"\xff+[\xd0-\xd7]")
_STUFFED = re.compile(rb"\xff+\x00")
_TAIL = re.compile(rb"\xff+$")


def _segments(data: bytes):
    """The scan's restart intervals, each unstuffed as libjpeg reads it
    (0xFF, any fill 0xFFs, 0x00 -> one 0xFF byte; 0xFFs that end the data
    start no byte)."""
    return [_STUFFED.sub(b"\xff", _TAIL.sub(b"", s)) for s in _RST.split(data)]


def _windows(seg: bytes) -> list:
    """Big-endian 32-bit windows starting at every byte (zeros past the
    end, as libjpeg feeds a truncated scan)."""
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.int64)
    n = len(seg) + 4
    return ((b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8) | b[3:n + 3]).tolist()


def huff_decode_ref(scan: Scan, out: np.ndarray):
    """Decode one scan's coefficients into ``out`` ((blocks, 64) int16,
    natural order), in Python: the plain version of J1's decoder."""
    segs = _segments(scan.data)
    info = scan.comp_info.tolist()
    luts = [scan.luts[k].tolist() if scan.luts[k].any() else None for k in range(8)]
    nat = NATURAL.tolist()
    flat = out.reshape(-1)
    vals = {}
    nmcu = scan.mcux * scan.mcuy
    restart = scan.restart
    preds = [0] * len(info)
    seg_i, W, pos = -1, None, 0
    for m in range(nmcu):
        if W is None or (restart and m % restart == 0):
            seg_i += 1
            W = _windows(segs[seg_i]) if seg_i < len(segs) else [0]
            pos, preds = 0, [0] * len(info)
        mx, my = m % scan.mcux, m // scan.mcux
        for ci, (h, v, dcs, acs, bw, boff) in enumerate(info):
            dclut, aclut = luts[dcs], luts[acs]
            for yy in range(v):
                base = boff + (my * v + yy) * bw + mx * h
                for xx in range(h):
                    blk = (base + xx) * 64
                    w = W[pos >> 3] if (pos >> 3) < len(W) else 0
                    e = dclut[(w >> (16 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    pos += e >> 8
                    s = e & 255
                    if s > 15:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    if s:
                        w = W[pos >> 3] if (pos >> 3) < len(W) else 0
                        r = (w >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                        pos += s
                        if r < (1 << (s - 1)):
                            r -= (1 << s) - 1
                        preds[ci] += r
                    vals[blk] = preds[ci]
                    k = 1
                    while k < 64:
                        w = W[pos >> 3] if (pos >> 3) < len(W) else 0
                        e = aclut[(w >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("corrupt JPEG: bad Huffman code")
                        pos += e >> 8
                        rs = e & 255
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            w = W[pos >> 3] if (pos >> 3) < len(W) else 0
                            r = (w >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if r < (1 << (s - 1)):
                                r -= (1 << s) - 1
                            vals[blk + nat[k]] = r
                            k += 1
                        elif rs == 0xF0:
                            k += 16
                        else:
                            break
    if vals:
        idx = np.fromiter(vals.keys(), np.int64, len(vals))
        flat[idx] = np.fromiter(vals.values(), np.int64, len(vals)).astype(np.int16)
    return out


def huff_decode_progressive_ref(scan: Scan, out: np.ndarray, counts: dict = None):
    """Decode one progressive scan into ``out`` ((blocks, 64) int16, natural
    order), accumulating into what earlier scans left there, in Python: the
    plain version of J1's progressive decoder, ``jdphuff.c``'s four routines
    step for step:

    - DC first (``ss == 0, ah == 0``; interleaved or one component): the
      difference-coded DC value, shifted left by ``al``;
    - DC refinement: one bit a block, or-ed in at bit ``al``;
    - AC first (one component): the band's values shifted left by ``al``,
      with EOB runs (EOBn: 2**n plus n appended bits blocks end their band)
      that cross blocks, not restart intervals;
    - AC refinement: a correction bit for every coefficient of the band that
      is already nonzero (its magnitude grows by 2**al when the bit is 1 and
      that bit is not set yet), newly nonzero coefficients of +-2**al after
      a run of still-zero ones (ZRL skips 16 of them), and EOB runs over the
      rest of the band.

    A restart clears the DC predictions and the EOB run. A code that the
    table does not hold raises, and so does a restart interval whose codes
    need more bits than its data holds (libjpeg reads zeros there and warns;
    such a file is truncated or corrupt). ``counts``, if given, gains the
    scan's Huffman codes (``"codes"``) and raw bit fields (``"fields"``:
    value bits, EOB run lengths, refinement and correction bits)."""
    segs = _segments(scan.data)
    info = scan.comp_info.tolist()
    luts = [scan.luts[k].tolist() if scan.luts[k].any() else None for k in range(8)]
    nat = NATURAL.tolist()
    flat = out.reshape(-1)
    blocks = sorted({boff + by * bw + bx for h, v, _, _, bw, boff in info
                     for by in range(scan.mcuy * v) for bx in range(scan.mcux * h)})
    coef = {b: flat[b * 64:b * 64 + 64].tolist() for b in blocks}
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -(1 << al)
    nmcu = scan.mcux * scan.mcuy
    restart = scan.restart
    preds, eobrun = [0] * len(info), 0
    seg_i, W, pos, avail = -1, None, 0, 0
    n_codes = n_fields = 0

    def bits(n):
        nonlocal pos, n_fields
        n_fields += 1
        w = W[pos >> 3] if (pos >> 3) < len(W) else 0
        r = (w >> (32 - (pos & 7) - n)) & ((1 << n) - 1)
        pos += n
        return r

    def symbol(lut):
        nonlocal pos, n_codes
        n_codes += 1
        w = W[pos >> 3] if (pos >> 3) < len(W) else 0
        e = lut[(w >> (16 - (pos & 7))) & 0xFFFF] if lut is not None else 0
        if not e:
            raise ValueError("corrupt JPEG: bad Huffman code")
        pos += e >> 8
        return e & 255

    def extend(r, n):
        return r - (1 << n) + 1 if r < (1 << (n - 1)) else r

    def wrap(x):                       # the int16 store of a JCOEF
        return ((x + 0x8000) & 0xFFFF) - 0x8000

    for m in range(nmcu):
        if W is None or (restart and m % restart == 0):
            if pos > avail:
                raise ValueError("corrupt JPEG: a progressive scan's data ran out")
            seg_i += 1
            seg = segs[seg_i] if seg_i < len(segs) else b""
            W, pos, avail = _windows(seg), 0, 8 * len(seg)
            preds, eobrun = [0] * len(info), 0
        mx, my = m % scan.mcux, m // scan.mcux
        for ci, (h, v, dcs, acs, bw, boff) in enumerate(info):
            for yy in range(v):
                for xx in range(h):
                    blk = coef[boff + (my * v + yy) * bw + mx * h + xx]
                    if ss == 0:
                        if ah == 0:                          # DC first
                            n = symbol(luts[dcs])
                            if n > 15:
                                raise ValueError("corrupt JPEG: bad Huffman code")
                            if n:
                                preds[ci] += extend(bits(n), n)
                            blk[0] = wrap(preds[ci] << al)
                        elif bits(1):                        # DC refinement
                            blk[0] |= p1
                        continue
                    if ah == 0:                              # AC first
                        if eobrun:
                            eobrun -= 1
                            continue
                        k = ss
                        while k <= se:
                            rs = symbol(luts[acs])
                            r, n = rs >> 4, rs & 15
                            if n:
                                k += r
                                blk[nat[k]] = wrap(extend(bits(n), n) << al)
                            elif r == 15:
                                k += 15
                            else:
                                eobrun = (1 << r) + (bits(r) if r else 0) - 1
                                break
                            k += 1
                        continue
                    k = ss                                   # AC refinement
                    if not eobrun:
                        while k <= se:
                            rs = symbol(luts[acs])
                            r, n = rs >> 4, rs & 15
                            if n:
                                n = p1 if bits(1) else m1
                            elif r != 15:
                                eobrun = (1 << r) + (bits(r) if r else 0)
                                break
                            while k <= se:
                                z = nat[k]
                                c = blk[z]
                                if c:
                                    if bits(1) and not c & p1:
                                        blk[z] = wrap(c + (p1 if c >= 0 else m1))
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if n:
                                blk[nat[k]] = n
                            k += 1
                    if eobrun:
                        while k <= se:
                            z = nat[k]
                            c = blk[z]
                            if c and bits(1) and not c & p1:
                                blk[z] = wrap(c + (p1 if c >= 0 else m1))
                            k += 1
                        eobrun -= 1
    if pos > avail:
        raise ValueError("corrupt JPEG: a progressive scan's data ran out")
    for b, vals in coef.items():
        flat[b * 64:b * 64 + 64] = vals
    if counts is not None:
        counts["codes"] = counts.get("codes", 0) + n_codes
        counts["fields"] = counts.get("fields", 0) + n_fields
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        """Pad the last byte with 1-bits (jchuff.c flush_bits)."""
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def huff_encode_ref(coefs: np.ndarray, comp_info, codes, mcux: int, mcuy: int,
                    restart: int = 0) -> bytes:
    """Entropy-code one interleaved (or single-component) scan of quantized
    coefficients ((blocks, 64) int16, natural order), in Python: the plain
    version of J1's encoder. ``comp_info`` (ns, 8) int32: h, v, DC slot, AC
    slot (4-7), bw, boff, rbw, rbh; blocks outside ``rbw x rbh`` are coded
    as the encoder's dummy blocks (DC difference 0, no AC). ``codes`` (8,
    256) int32 from :func:`code_table`. Returns the stuffed bytes with
    restart markers, the last byte padded with 1-bits."""
    bw_ = _BitWriter()
    flat = np.asarray(coefs, np.int64).reshape(-1, 64)
    zz = flat[:, ZIGZAG].tolist()
    codes = np.asarray(codes).tolist()
    info = np.asarray(comp_info).tolist()
    preds = [0] * len(info)
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            bw_.flush()
            bw_.out += bytes((0xFF, 0xD0 + (m // restart - 1) % 8))
            preds = [0] * len(info)
        mx, my = m % mcux, m // mcux
        for ci, (h, v, dcs, acs, bw, boff, rbw, rbh) in enumerate(info):
            dct, act = codes[dcs], codes[acs]
            for yy in range(v):
                by = my * v + yy
                for xx in range(h):
                    bx = mx * h + xx
                    if by >= rbh or bx >= rbw:           # dummy block
                        e = dct[0]
                        bw_.put(e & 0xFFFF, e >> 16)
                        e = act[0]
                        bw_.put(e & 0xFFFF, e >> 16)
                        continue
                    blk = zz[boff + by * bw + bx]
                    diff = blk[0] - preds[ci]
                    preds[ci] = blk[0]
                    mag = -diff if diff < 0 else diff
                    nb = mag.bit_length()
                    e = dct[nb]
                    bw_.put(e & 0xFFFF, e >> 16)
                    if nb:
                        bw_.put((diff - 1 if diff < 0 else diff) & ((1 << nb) - 1), nb)
                    run = 0
                    for k in range(1, 64):
                        a = blk[k]
                        if a == 0:
                            run += 1
                            continue
                        while run > 15:
                            e = act[0xF0]
                            bw_.put(e & 0xFFFF, e >> 16)
                            run -= 16
                        mag = -a if a < 0 else a
                        nb = mag.bit_length()
                        e = act[(run << 4) + nb]
                        bw_.put(e & 0xFFFF, e >> 16)
                        bw_.put((a - 1 if a < 0 else a) & ((1 << nb) - 1), nb)
                        run = 0
                    if run:
                        e = act[0]
                        bw_.put(e & 0xFFFF, e >> 16)
    bw_.flush()
    return bytes(bw_.out)


# --------------------------------------------------------------------------- #
# J2 plain: dequantize + IDCT + upsampling + colour conversion
# --------------------------------------------------------------------------- #
F0298, F0390, F0541, F0765, F0899, F1175 = 2446, 3196, 4433, 6270, 7373, 9633
F1501, F1847, F1961, F2053, F2562, F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _idct_1d(x, shift):
    """jidctint.c's even/odd butterflies over 8 int64 arrays; the outputs
    descaled by ``shift`` bits."""
    z1 = (x[2] + x[6]) * F0541
    tmp2 = z1 - x[6] * F1847
    tmp3 = z1 + x[2] * F0765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1175
    t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                                          t13 - t0, t12 - t1, t11 - t2, t10 - t3)]


def _range_limit(x):
    """The post-IDCT range-limit table indexed by x & 1023: x + 128 on
    -128..127, 255 above, 0 below, wrapping beyond +-512."""
    j = x & 1023
    return np.where(j < 128, j + 128, np.where(j < 512, 255, np.where(j < 896, 0, j - 896)))


def idct_islow(coefs, qtab) -> np.ndarray:
    """(..., 64) int16 coefficients and (..., 64) quantization tables ->
    (..., 8, 8) uint8 samples, jpeg_idct_islow bit for bit."""
    c = np.asarray(coefs, np.int64) * np.asarray(qtab, np.int64)
    c = c.reshape(c.shape[:-1] + (8, 8))
    # pass 1 over columns: inputs are the rows of the block; results are
    # stored as int, as the workspace holds them
    ws = _idct_1d([c[..., k, :] for k in range(8)], 11)
    ws = [v.astype(np.int32).astype(np.int64) for v in ws]        # rows of the workspace
    ws = np.stack(ws, axis=-2)                                     # (..., 8 rows, 8 cols)
    out = _idct_1d([ws[..., :, k] for k in range(8)], 18)          # per row
    out = np.stack([v.astype(np.int32).astype(np.int64) for v in out], axis=-1)
    return _range_limit(out).astype(np.uint8)


def _upsample(plane, geom: Geometry, c: int) -> np.ndarray:
    """Component c's (N, bh*8, bw*8) samples -> (N, H, W) int64 at full
    resolution, jdsample.c's method for it."""
    H, W = geom.H, geom.W
    dw, dh, fh, fv = geom.dw[c], geom.dh[c], geom.fh[c], geom.fv[c]
    p = plane[:, :dh, :dw].astype(np.int64)
    up = geom.up[c]
    y, x = np.arange(H), np.arange(W)
    if up == UP_FULL:
        return p[:, :H, :W]
    if up == UP_REPLICATE:
        return p[:, y // fv][:, :, x // fh]
    if up == UP_H2V1:
        i = x >> 1
        nb = np.where(x & 1, np.minimum(i + 1, dw - 1), np.maximum(i - 1, 0))
        return (3 * p[:, :, i] + p[:, :, nb] + 1 + (x & 1)) >> 2
    j = y >> 1
    nbr = np.where(y & 1, np.minimum(j + 1, dh - 1), np.maximum(j - 1, 0))
    if up == UP_H1V2:
        return (3 * p[:, j] + p[:, nbr] + 1 + (y & 1)[:, None]) >> 2
    cs = 3 * p[:, j] + p[:, nbr]                                      # (N, H, dw) column sums
    i = x >> 1
    nb = np.where(x & 1, np.minimum(i + 1, dw - 1), np.maximum(i - 1, 0))
    return (3 * cs[:, :, i] + cs[:, :, nb] + 8 - (x & 1)) >> 4


def ycc_to_bgr(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert on int64 arrays -> (..., 3) uint8 BGR."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def decode_pixels_ref(coefs, qtabs, geom: Geometry) -> np.ndarray:
    """J2's plain version: (N, blocks, 64) int16 coefficients and (N, ncomp,
    64) int32 tables of N frames of one geometry -> (N, H, W, 3) uint8 BGR
    (grey replicated)."""
    coefs = np.asarray(coefs)
    qtabs = np.asarray(qtabs)
    N = coefs.shape[0]
    full = []
    for c in range(geom.ncomp):
        blocks = coefs[:, geom.boff[c]:geom.boff[c] + geom.bw[c] * geom.bh[c]]
        pix = idct_islow(blocks, qtabs[:, c, None, :])               # (N, nb, 8, 8)
        plane = (pix.reshape(N, geom.bh[c], geom.bw[c], 8, 8).transpose(0, 1, 3, 2, 4)
                 .reshape(N, geom.bh[c] * 8, geom.bw[c] * 8))
        full.append(_upsample(plane, geom, c))
    if geom.color == GREY:
        return np.repeat(full[0].astype(np.uint8)[..., None], 3, axis=-1)
    if geom.color == RGB:
        return np.stack(full[::-1], axis=-1).astype(np.uint8)
    return ycc_to_bgr(*full)


# --------------------------------------------------------------------------- #
# J3 plain: colour conversion + downsampling + FDCT + quantization
# --------------------------------------------------------------------------- #
def bgr_to_ycc(img) -> list:
    """jccolor.c rgb_ycc_convert of (..., 3) uint8 BGR -> [Y, Cb, Cr] int64."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    return [y, cb, cr]


def _downsample(full, geom: Geometry, c: int) -> np.ndarray:
    """Component c's (N, H, W) full-resolution samples -> its (N, bh*8,
    bw*8) plane as jcsample.c and jcprepct.c make it: columns from the
    image's right edge repeated, rows past the last downsampled one
    repeated."""
    fh, fv = geom.fh[c], geom.fv[c]
    rows = np.minimum(np.arange(geom.bh[c] * 8), geom.rows[c] - 1)
    cols = np.arange(geom.bw[c] * 8)
    acc = 0
    for dy in range(fv):
        sy = np.minimum(rows * fv + dy, geom.H - 1)
        for dx in range(fh):
            sx = np.minimum(cols * fh + dx, geom.W - 1)
            acc = acc + full[:, sy][:, :, sx]
    if fh == 1 and fv == 1:
        return acc
    if fh == 2 and fv == 1:
        return (acc + (cols & 1)) >> 1
    if fh == 2 and fv == 2:
        return (acc + 1 + (cols & 1)) >> 2
    n = fh * fv
    return (acc + n // 2) // n


def _fdct_1d(d, shift_odd, left):
    """jfdctint.c's butterflies over 8 int64 arrays."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if left:
        out[0], out[4] = (t10 + t11) << 2, (t10 - t11) << 2
    else:
        out[0], out[4] = (t10 + t11 + 2) >> 2, (t10 - t11 + 2) >> 2
    hs = 1 << (shift_odd - 1)
    z1 = (t12 + t13) * F0541
    out[2] = (z1 + t13 * F0765 + hs) >> shift_odd
    out[6] = (z1 - t12 * F1847 + hs) >> shift_odd
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0298, tmp5 * F2053, tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = (tmp4 + z1 + z3 + hs) >> shift_odd
    out[5] = (tmp5 + z2 + z4 + hs) >> shift_odd
    out[3] = (tmp6 + z2 + z3 + hs) >> shift_odd
    out[1] = (tmp7 + z1 + z4 + hs) >> shift_odd
    return out


def fdct_quantize(samples, recip) -> np.ndarray:
    """(..., 8, 8) int64 samples (already minus 128) and (..., 3, 64)
    reciprocal tables -> (..., 64) int16 quantized coefficients in natural
    order: jpeg_fdct_islow and jcdctmgr.c quantize bit for bit."""
    s = np.asarray(samples, np.int64)
    rows = _fdct_1d([s[..., :, k] for k in range(8)], 11, True)    # per row
    ws = np.stack(rows, axis=-1)                                        # (..., 8 rows, 8 freq)
    cols = _fdct_1d([ws[..., k, :] for k in range(8)], 15, False)  # per column
    coef = np.stack(cols, axis=-2).reshape(s.shape[:-2] + (64,))        # (..., v, u)
    recip = np.asarray(recip, np.int64)
    fq, corr, shift = recip[..., 0, :], recip[..., 1, :], recip[..., 2, :]
    mag = ((np.abs(coef) + corr) * fq) >> shift
    return np.where(coef < 0, -mag, mag).astype(np.int16)


def encode_pixels_ref(img, recips, geom: Geometry) -> np.ndarray:
    """J3's plain version: (N, H, W, 3) uint8 BGR (or (N, H, W, 1) grey)
    and (ncomp, 3, 64) reciprocal tables -> (N, blocks, 64) int16 quantized
    coefficients of every block of the MCU grid."""
    img = np.asarray(img)
    N = img.shape[0]
    comps = [img[..., 0].astype(np.int64)] if geom.ncomp == 1 else bgr_to_ycc(img)
    out = np.zeros((N, geom.blocks, 64), np.int16)
    for c in range(geom.ncomp):
        plane = _downsample(comps[c], geom, c) - 128                  # (N, bh*8, bw*8)
        bh, bw = geom.bh[c], geom.bw[c]
        blocks = plane.reshape(N, bh, 8, bw, 8).transpose(0, 1, 3, 2, 4).reshape(N, bh * bw, 8, 8)
        out[:, geom.boff[c]:geom.boff[c] + bh * bw] = fdct_quantize(blocks, recips[c][None, None])
    return out


# --------------------------------------------------------------------------- #
# writing a file
# --------------------------------------------------------------------------- #
def _segment(marker: int, payload: bytes) -> bytes:
    return bytes((0xFF, marker)) + struct.pack(">H", len(payload) + 2) + payload


def file_header(geom: Geometry, qtabs, restart: int = 0) -> bytes:
    """SOI .. SOS of a baseline file as libjpeg writes it with the standard
    Huffman tables (JFIF 1.01 APP0, one DQT and one DHT segment per table,
    component ids 1..3, DRI when restarting)."""
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    ntab = 1 if geom.ncomp == 1 else 2
    for t in range(ntab):
        out.append(_segment(0xDB, bytes([t]) + np.asarray(qtabs[t])[ZIGZAG].astype(np.uint8)
                            .tobytes()))
    comps = b"".join(bytes((c + 1, (h << 4) | v, min(c, 1)))
                     for c, (h, v) in enumerate(geom.factors))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, geom.H, geom.W, geom.ncomp) + comps))
    for t in range(ntab):
        for cls in (0, 1):
            bits, vals = STD_HUFF[(cls, t)]
            out.append(_segment(0xC4, bytes([(cls << 4) | t]) + bytes(bits) + bytes(vals)))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    sos = bytes([geom.ncomp]) + b"".join(bytes((c + 1, 0x11 * min(c, 1)))
                                         for c in range(geom.ncomp)) + b"\x00\x3f\x00"
    out.append(_segment(0xDA, sos))
    return b"".join(out)


def encode_comp_info(geom: Geometry) -> np.ndarray:
    """(ncomp, 8) int32 for the entropy encoder: h, v, DC slot, AC slot, bw,
    boff, rbw, rbh (the single-component scan of a grey frame has 1 x 1 MCUs)."""
    rows = []
    for c in range(geom.ncomp):
        h, v = geom.factors[c] if geom.ncomp > 1 else (1, 1)
        slot = min(c, 1)
        rows.append([h, v, slot, 4 + slot, geom.bw[c], geom.boff[c], geom.rbw[c], geom.rbh[c]])
    return np.array(rows, np.int32)


def scan_mcus(geom: Geometry):
    """MCUs per row and column of the frame's one scan."""
    if geom.ncomp > 1:
        return geom.mcux, geom.mcuy
    return geom.rbw[0], geom.rbh[0]


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
_ORIENT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1), 6: lambda a: a.swapaxes(0, 1)[:, ::-1],
    7: lambda a: a.swapaxes(0, 1)[::-1, ::-1], 8: lambda a: a.swapaxes(0, 1)[::-1],
}


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The image as cv2's ExifTransform turns it for an EXIF orientation."""
    f = _ORIENT.get(int(orientation))
    return np.ascontiguousarray(f(img)) if f else img


def _entropy_decode(jf: JpegFile, device) -> np.ndarray:
    from mft_tpu_torch.ops.jpeg import jpeg_huff_decode, jpeg_huff_decode_progressive
    coefs = np.zeros((jf.geom.blocks, 64), np.int16)
    for scan in jf.scans:
        (jpeg_huff_decode_progressive if scan.progressive else jpeg_huff_decode)(
            scan, coefs, device)
    return coefs


_POOL = None
_LOCAL = threading.local()


def _device_work(dev):
    """A context that runs the codec's device work on a CUDA stream of the
    calling thread's own: a loader thread's JPEG calls then do not wait for
    the work queued on the default stream (a training step's)."""
    import torch
    if dev.type != "cuda":
        return contextlib.nullcontext()
    stream = getattr(_LOCAL, "stream", None)
    if stream is None:
        stream = _LOCAL.stream = torch.cuda.Stream(dev)
    return torch.cuda.stream(stream)


def _pool():
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="jpeg")
    return _POOL


def decode_pixel_groups(files, dev, decode_pixels) -> list:
    """J1 on each parsed file (natively on host threads for a CUDA ``dev``
    when there is more than one file), then ``decode_pixels(coefs, qtabs,
    geom)`` on ``dev`` once for the files of each geometry. returns one
    uint8 array of its pixel stage per file, in order."""
    import torch
    if dev.type == "cuda" and len(files) > 1:
        coefs = list(_pool().map(lambda jf: _entropy_decode(jf, dev), files))
    else:
        coefs = [_entropy_decode(jf, dev) for jf in files]
    groups = {}
    for i, jf in enumerate(files):
        groups.setdefault(jf.geom, []).append(i)
    out = [None] * len(files)
    for geom, idx in groups.items():
        with _device_work(dev):
            c = torch.from_numpy(np.stack([coefs[i] for i in idx])).to(dev)
            q = torch.from_numpy(np.stack([files[i].qtabs for i in idx])).to(dev)
            pix = decode_pixels(c, q, geom).cpu().numpy()
        for k, i in enumerate(idx):
            out[i] = pix[k]
    return out


def decode_jpeg_frames(datas, device="cuda", orient: bool = True, rgb: bool = False,
                       keep_grey: bool = False) -> list:
    """Decode JPEG files (bytes). On CUDA each file's scans are
    entropy-decoded natively on host threads and the files of one geometry
    go through J2 in one launch; on the CPU the plain versions run.

    returns: one uint8 array per file: (H, W, 3) BGR (``rgb``: RGB), grey
    replicated, or (H, W) for a grey file with ``keep_grey``; turned by its
    EXIF orientation with ``orient`` (``cv2.imdecode``'s rule; PIL's
    ``Image.open`` does not turn)."""
    from mft_tpu_torch.core.device import resolve_device
    from mft_tpu_torch.ops.jpeg import jpeg_decode_pixels
    files = [parse_jpeg(d) for d in datas]
    out = []
    for jf, img in zip(files, decode_pixel_groups(files, resolve_device(device),
                                                  jpeg_decode_pixels)):
        if keep_grey and jf.geom.color == GREY:
            img = img[..., 0]
        elif rgb:
            img = img[..., ::-1]
        if orient:
            img = apply_orientation(img, jf.orientation)
        out.append(np.ascontiguousarray(img))
    return out


def decode_jpeg(data, device="cuda", orient: bool = True) -> np.ndarray:
    """(H, W, 3) uint8 BGR of JPEG bytes, as ``cv2.imdecode(buf,
    IMREAD_COLOR)`` gives it (grey replicated; EXIF orientation applied
    unless ``orient`` is False)."""
    return decode_jpeg_frames([data], device, orient=orient)[0]


def _prepare(img):
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"JPEG samples must be uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"cannot write a {img.shape} array as JPEG")
    return np.ascontiguousarray(img)


def _tables(geom: Geometry, quality: int):
    luma, chroma = quant_tables(quality)
    qtabs = np.stack([luma] + [chroma] * (geom.ncomp - 1)).astype(np.int32)
    return qtabs, reciprocals(qtabs)


def encode_jpeg(bgr, quality: int = 95, device="cuda") -> bytes:
    """JPEG bytes of a (H, W, 3) uint8 BGR or (H, W) grey image, as
    ``cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY, quality])`` writes
    them (4:2:0, no restart interval): J3 on the card, then J1's encoder on
    the host."""
    import torch

    from mft_tpu_torch.core.device import resolve_device
    from mft_tpu_torch.ops.jpeg import jpeg_encode_pixels, jpeg_huff_encode
    dev = resolve_device(device)
    img = _prepare(bgr)
    geom = geometry_for(img.shape[0], img.shape[1], img.shape[2])
    qtabs, recips = _tables(geom, quality)
    with _device_work(dev):
        coefs = jpeg_encode_pixels(torch.from_numpy(img[None]).to(dev),
                                   torch.from_numpy(recips).to(dev), geom)[0].cpu().numpy()
    mcux, mcuy = scan_mcus(geom)
    body = jpeg_huff_encode(coefs, encode_comp_info(geom), STD_CODE_TABLES, mcux, mcuy, 0, dev)
    return file_header(geom, qtabs) + body + b"\xff\xd9"


def jpeg_roundtrip(bgr, quality: int, device="cuda") -> np.ndarray:
    """``decode_jpeg(encode_jpeg(bgr, quality))`` without the entropy stage,
    which is lossless: J3 then J2. ``bgr`` (H, W, 3) or a batch (N, H, W, 3)
    of uint8 BGR; returns the same shape."""
    import torch

    from mft_tpu_torch.core.device import resolve_device
    from mft_tpu_torch.ops.jpeg import jpeg_decode_pixels, jpeg_encode_pixels
    dev = resolve_device(device)
    img = np.asarray(bgr)
    single = img.ndim == 3
    batch = np.ascontiguousarray(img[None] if single else img)
    if batch.dtype != np.uint8 or batch.ndim != 4 or batch.shape[3] != 3:
        raise ValueError(f"jpeg_roundtrip takes uint8 (H, W, 3) or (N, H, W, 3), got "
                         f"{img.shape} {img.dtype}")
    geom = geometry_for(batch.shape[1], batch.shape[2], 3)
    qtabs, recips = _tables(geom, quality)
    with _device_work(dev):
        coefs = jpeg_encode_pixels(torch.from_numpy(batch).to(dev),
                                   torch.from_numpy(recips).to(dev), geom)
        q = torch.from_numpy(qtabs).to(dev).expand(batch.shape[0], -1, -1).contiguous()
        out = jpeg_decode_pixels(coefs, q, geom).cpu().numpy()
    return out[0] if single else out


def is_jpeg(data: bytes) -> bool:
    return bytes(data[:3]) == b"\xff\xd8\xff"


__all__ = ["decode_jpeg", "decode_jpeg_frames", "encode_jpeg", "jpeg_roundtrip", "parse_jpeg",
           "Geometry", "geometry_for", "huff_decode_ref", "huff_decode_progressive_ref",
           "huff_encode_ref",
           "decode_pixels_ref", "encode_pixels_ref", "quant_tables", "reciprocals",
           "apply_orientation", "is_jpeg"]
