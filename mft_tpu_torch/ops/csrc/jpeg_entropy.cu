// J1: JPEG entropy coding (baseline Huffman) on the host.
//
// Replaces no Pallas site: the JAX package decodes and encodes JPEG through
// OpenCV and PIL (libjpeg-turbo) on the host (mft_tpu/train/augment.py:57-68,
// io/video.py:37, eval/tapvid.py:107-113). Entropy coding is serial
// bit-level work with a data-dependent position, so it stays on the host;
// the parallel pixel stages run on the card (jpeg.cu). Bound: the bits of
// the scan, read or written once; per symbol a 16-bit lookahead table
// (decode) or a code table (encode) gives the code in one load.
//
// Host-only code with plain C entry points (no CUDA call), loaded with ctypes,
// which releases the GIL, so that several files decode on host threads. Bit
// for bit with the Python plain versions (mft_tpu_torch/io/jpeg.py
// huff_decode_ref / huff_encode_ref): the same coefficients from the same
// bytes and the same bytes from the same coefficients, truncated and
// restart-interval data included (past the data, zeros are read, as libjpeg
// feeds them).

#include <cstdint>

namespace {

// zig-zag position -> natural index; 16 extra entries catch a run past 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Reads the entropy-coded bytes of a scan: 0xFF (0xFF...) 0x00 is one 0xFF
// byte; 0xFF (0xFF...) RSTn stops the reader until restart(); past a marker
// or the end, zero bytes.
struct Reader {
  const uint8_t* d;
  long n, p;
  uint64_t acc;
  int bits;
  bool stop;

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!stop && p < n) {
        c = d[p];
        if (c == 0xFF) {
          long q = p + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0) {
            p = q + 1;
          } else {
            stop = true;
            c = 0;
          }
        } else {
          p++;
        }
      }
      acc = (acc << 8) | c;
      bits += 8;
    }
  }
  uint32_t peek16() const { return (uint32_t)(acc >> (bits - 16)) & 0xFFFF; }
  int get(int s) {
    bits -= s;
    return (int)((acc >> bits) & ((1u << s) - 1));
  }
  // Move past the next restart marker (not past any other).
  void restart() {
    long q = p;
    while (q < n) {
      if (d[q] != 0xFF) {
        q++;
        continue;
      }
      long r = q + 1;
      while (r < n && d[r] == 0xFF) r++;
      if (r < n && d[r] >= 0xD0 && d[r] <= 0xD7) {
        q = r + 1;
        break;
      }
      q = r + 1;
    }
    p = q < n ? q : n;
    acc = 0;
    bits = 0;
    stop = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Writer {
  uint8_t* out;
  long cap, len;
  uint64_t acc;
  int bits;
  bool overflow;

  void put(uint32_t code, int size) {
    acc = (acc << size) | code;
    bits += size;
    while (bits >= 8) {
      bits -= 8;
      uint8_t c = (uint8_t)(acc >> bits);
      byte(c);
      if (c == 0xFF) byte(0);
    }
  }
  void byte(uint8_t c) {
    if (len < cap)
      out[len++] = c;
    else
      overflow = true;
  }
  void flush() {  // pad the last byte with 1-bits (jchuff.c flush_bits)
    if (bits) put((1u << (8 - bits)) - 1, 8 - bits);
  }
};

inline int bit_length(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

}  // namespace

// Decode one scan into out (blocks x 64 int16, natural order).
// info: ns rows of (h, v, dc slot, ac slot, bw, boff); luts: 8 tables of
// 65536 uint16 entries (length << 8 | symbol, 0 = no code), DC slots 0-3, AC
// 4-7. Returns 0, or -1 for a window that starts no code or a DC bit count
// over 15.
extern "C" int mft_jpeg_huff_decode(const uint8_t* data, long len, int ns, const int* info,
                                    const uint16_t* luts, int mcux, int mcuy, int restart,
                                    int16_t* out) {
  Reader rd{data, len, 0, 0, 0, false};
  int preds[4] = {0, 0, 0, 0};
  long nmcu = (long)mcux * mcuy;
  for (long m = 0; m < nmcu; m++) {
    if (restart && m && m % restart == 0) {
      rd.restart();
      for (int c = 0; c < 4; c++) preds[c] = 0;
    }
    long mx = m % mcux, my = m / mcux;
    for (int ci = 0; ci < ns; ci++) {
      const int* f = info + 6 * ci;
      int h = f[0], v = f[1], bw = f[4];
      long boff = f[5];
      const uint16_t* dc = luts + ((long)f[2] << 16);
      const uint16_t* ac = luts + ((long)f[3] << 16);
      for (int yy = 0; yy < v; yy++) {
        for (int xx = 0; xx < h; xx++) {
          int16_t* blk = out + (boff + (my * v + yy) * (long)bw + mx * h + xx) * 64;
          rd.fill();
          uint32_t e = dc[rd.peek16()];
          if (!e) return -1;
          rd.bits -= (int)(e >> 8);
          int s = e & 255;
          if (s > 15) return -1;
          // wraps as the plain version's int16 store does, never overflows
          if (s) preds[ci] = (int)((unsigned)preds[ci] + (unsigned)extend(rd.get(s), s));
          blk[0] = (int16_t)preds[ci];
          for (int k = 1; k < 64;) {
            rd.fill();
            e = ac[rd.peek16()];
            if (!e) return -1;
            rd.bits -= (int)(e >> 8);
            int rs = e & 255;
            s = rs & 15;
            if (s) {
              k += rs >> 4;
              blk[kNatural[k]] = (int16_t)extend(rd.get(s), s);
              k++;
            } else if (rs == 0xF0) {
              k += 16;
            } else {
              break;
            }
          }
        }
      }
    }
  }
  return 0;
}

// Decode one progressive scan into out (blocks x 64 int16, natural order),
// accumulating into what earlier scans left there: jdphuff.c's DC first, DC
// refinement, AC first and AC refinement routines, chosen by ss and ah (bit
// for bit with mft_tpu_torch/io/jpeg.py huff_decode_progressive_ref). info,
// luts as for mft_jpeg_huff_decode (an AC scan has one component, one block
// an MCU). Returns 0, -1 for a window that starts no code or a DC bit count
// over 15, -2 for a restart interval whose codes need more bits than it
// holds.
extern "C" int mft_jpeg_huff_decode_progressive(const uint8_t* data, long len, int ns,
                                                const int* info, const uint16_t* luts, int mcux,
                                                int mcuy, int restart, int ss, int se, int ah,
                                                int al, int16_t* out) {
  Reader rd{data, len, 0, 0, 0, false};
  long consumed = 0, real = -1;  // bits taken; real bits of the interval (-1: not ended yet)
  auto fill = [&]() {
    while (rd.bits <= 56) {
      bool ended = rd.stop || rd.p >= rd.n;
      if (!ended) {
        uint32_t c = rd.d[rd.p];
        if (c == 0xFF) {
          long q = rd.p + 1;
          while (q < rd.n && rd.d[q] == 0xFF) q++;
          if (q < rd.n && rd.d[q] == 0) {
            rd.p = q + 1;
          } else {
            rd.stop = true;
            ended = true;
          }
        } else {
          rd.p++;
        }
        if (!ended) {
          rd.acc = (rd.acc << 8) | c;
          rd.bits += 8;
          continue;
        }
      }
      if (real < 0) real = consumed + rd.bits;  // the interval's data ends here
      rd.acc <<= 8;
      rd.bits += 8;
    }
  };
  auto take = [&](int s) {
    consumed += s;
    return rd.get(s);
  };
  auto symbol = [&](const uint16_t* lut) -> int {
    fill();
    uint32_t e = lut[rd.peek16()];
    if (!e) return -1;
    rd.bits -= (int)(e >> 8);
    consumed += e >> 8;
    return (int)(e & 255);
  };
  auto overrun = [&]() { return real >= 0 && consumed > real; };
  const int p1 = 1 << al, m1 = -(1 << al);
  int preds[4] = {0, 0, 0, 0};
  long eobrun = 0;
  long nmcu = (long)mcux * mcuy;
  for (long m = 0; m < nmcu; m++) {
    if (restart && m && m % restart == 0) {
      if (overrun()) return -2;
      rd.restart();
      consumed = 0;
      real = -1;
      eobrun = 0;
      for (int c = 0; c < 4; c++) preds[c] = 0;
    }
    long mx = m % mcux, my = m / mcux;
    for (int ci = 0; ci < ns; ci++) {
      const int* f = info + 6 * ci;
      int h = f[0], v = f[1], bw = f[4];
      long boff = f[5];
      const uint16_t* dc = luts + ((long)f[2] << 16);
      const uint16_t* ac = luts + ((long)f[3] << 16);
      for (int yy = 0; yy < v; yy++) {
        for (int xx = 0; xx < h; xx++) {
          int16_t* blk = out + (boff + (my * v + yy) * (long)bw + mx * h + xx) * 64;
          if (ss == 0) {
            if (ah == 0) {  // DC first
              int s = symbol(dc);
              if (s < 0 || s > 15) return -1;
              if (s) {
                fill();
                preds[ci] = (int)((unsigned)preds[ci] + (unsigned)extend(take(s), s));
              }
              blk[0] = (int16_t)((unsigned)preds[ci] << al);
            } else {  // DC refinement
              fill();
              if (take(1)) blk[0] = (int16_t)(blk[0] | p1);
            }
            continue;
          }
          if (ah == 0) {  // AC first
            if (eobrun) {
              eobrun--;
              continue;
            }
            for (int k = ss; k <= se; k++) {
              int rs = symbol(ac);
              if (rs < 0) return -1;
              int r = rs >> 4, s = rs & 15;
              if (s) {
                k += r;
                fill();
                blk[kNatural[k]] = (int16_t)((unsigned)extend(take(s), s) << al);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun = 1L << r;
                if (r) {
                  fill();
                  eobrun += take(r);
                }
                eobrun--;
                break;
              }
            }
            continue;
          }
          int k = ss;  // AC refinement
          if (!eobrun) {
            for (; k <= se; k++) {
              int rs = symbol(ac);
              if (rs < 0) return -1;
              int r = rs >> 4, s = rs & 15;
              if (s) {
                fill();
                s = take(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1L << r;
                if (r) {
                  fill();
                  eobrun += take(r);
                }
                break;
              }
              do {
                int16_t* c = blk + kNatural[k];
                if (*c) {
                  fill();
                  if (take(1) && !(*c & p1)) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
                } else if (--r < 0) {
                  break;
                }
                k++;
              } while (k <= se);
              if (s) blk[kNatural[k]] = (int16_t)s;
            }
          }
          if (eobrun) {
            for (; k <= se; k++) {
              int16_t* c = blk + kNatural[k];
              if (*c) {
                fill();
                if (take(1) && !(*c & p1)) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
              }
            }
            eobrun--;
          }
        }
      }
    }
  }
  return overrun() ? -2 : 0;
}

// Entropy-code one scan of quantized coefficients (blocks x 64 int16,
// natural order). info: ns rows of (h, v, dc slot, ac slot, bw, boff, rbw,
// rbh); blocks outside rbw x rbh are dummy blocks (DC difference 0, EOB).
// codes: 8 tables of 256 entries (length << 16 | code). Writes the stuffed
// bytes with restart markers, the last byte padded with 1-bits, and their
// count to *written. Returns 0, or -1 if cap bytes did not suffice.
extern "C" int mft_jpeg_huff_encode(const int16_t* coefs, int ns, const int* info,
                                    const int* codes, int mcux, int mcuy, int restart,
                                    uint8_t* out, long cap, long* written) {
  Writer wr{out, cap, 0, 0, 0, false};
  int preds[4] = {0, 0, 0, 0};
  long nmcu = (long)mcux * mcuy;
  for (long m = 0; m < nmcu; m++) {
    if (restart && m && m % restart == 0) {
      wr.flush();
      wr.byte(0xFF);
      wr.byte((uint8_t)(0xD0 + (m / restart - 1) % 8));
      for (int c = 0; c < 4; c++) preds[c] = 0;
    }
    long mx = m % mcux, my = m / mcux;
    for (int ci = 0; ci < ns; ci++) {
      const int* f = info + 8 * ci;
      int h = f[0], v = f[1], bw = f[4], rbw = f[6], rbh = f[7];
      long boff = f[5];
      const int* dct = codes + 256 * f[2];
      const int* act = codes + 256 * f[3];
      for (int yy = 0; yy < v; yy++) {
        long by = my * v + yy;
        for (int xx = 0; xx < h; xx++) {
          long bx = mx * h + xx;
          if (by >= rbh || bx >= rbw) {
            wr.put(dct[0] & 0xFFFF, dct[0] >> 16);
            wr.put(act[0] & 0xFFFF, act[0] >> 16);
            continue;
          }
          const int16_t* blk = coefs + (boff + by * bw + bx) * 64;
          int diff = blk[0] - preds[ci];
          preds[ci] = blk[0];
          int nb = bit_length(diff < 0 ? -diff : diff);
          wr.put(dct[nb] & 0xFFFF, dct[nb] >> 16);
          if (nb) wr.put((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << nb) - 1), nb);
          int run = 0;
          for (int k = 1; k < 64; k++) {
            int a = blk[kNatural[k]];
            if (a == 0) {
              run++;
              continue;
            }
            while (run > 15) {
              wr.put(act[0xF0] & 0xFFFF, act[0xF0] >> 16);
              run -= 16;
            }
            nb = bit_length(a < 0 ? -a : a);
            int e = act[(run << 4) + nb];
            wr.put(e & 0xFFFF, e >> 16);
            wr.put((uint32_t)(a < 0 ? a - 1 : a) & ((1u << nb) - 1), nb);
            run = 0;
          }
          if (run) wr.put(act[0] & 0xFFFF, act[0] >> 16);
        }
      }
    }
  }
  wr.flush();
  *written = wr.len;
  return wr.overflow ? -1 : 0;
}
