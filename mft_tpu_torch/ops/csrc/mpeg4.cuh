// The per-thread integer arithmetic of the MPEG-4 pixel kernels (mpeg4.cu),
// as functions that compile for the device and for the host alike, each bit
// for bit with the plain versions in mft_tpu_torch/io/mpeg4.py: H.263
// dequantization, libavcodec's 8-bit simple IDCT (simple_idct_template.c),
// half-pel motion compensation with libavcodec's clips and its x86
// put_no_rnd x2/y2 rounding, swscale's x86 yuv2rgb (BT.601 limited range),
// and the encoder's BGR -> YUV 4:2:0, islow FDCT (jpeg.cuh) and H.263
// quantization. One thread does one 8x8 block (reconstruct_block,
// encode_block) or one pixel (colour_pixel); the kernels and the host
// mirror of the tests call these with the thread's index.
#pragma once

#include <cstdint>

#include "jpeg.cuh"

#ifdef __CUDACC__
#define MP4V_HD __host__ __device__ __forceinline__
#else
#define MP4V_HD inline
#endif

namespace mp4v {

enum { NOT_CODED = 0, INTER = 1, INTER4V = 2, INTRA = 3 };

// geometry: visible W x H, MB columns and rows; packed planes Y (16 mbh x
// 16 mbw), Cb, Cr (8 mbh x 8 mbw)
struct Geom {
  int W, H, mbw, mbh;
  MP4V_HD int YW() const { return 16 * mbw; }
  MP4V_HD int YH() const { return 16 * mbh; }
  MP4V_HD int CW() const { return 8 * mbw; }
  MP4V_HD int CH() const { return 8 * mbh; }
  MP4V_HD long ysize() const { return (long)YW() * YH(); }
  MP4V_HD long csize() const { return (long)CW() * CH(); }
};

MP4V_HD int y_dc_scale(int q) {
  return q < 5 ? 8 : (q < 9 ? 2 * q : (q < 25 ? q + 8 : 2 * q - 16));
}
MP4V_HD int c_dc_scale(int q) { return q < 5 ? 8 : (q < 25 ? (q + 13) / 2 : q - 6); }
MP4V_HD int clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// H.263 dequantization of one block's levels (natural order)
MP4V_HD void dequantize(const int16_t* L, int intra, int qp, int chroma, int16_t* c) {
  int qmul = 2 * qp, qadd = (qp - 1) | 1;
  for (int k = 0; k < 64; ++k) {
    int l = L[k];
    int v = l > 0 ? l * qmul + qadd : (l < 0 ? l * qmul - qadd : 0);
    if (!intra) v = clamp(v, -2048, 2047);
    c[k] = (int16_t)v;
  }
  if (intra) c[0] = (int16_t)(L[0] * (chroma ? c_dc_scale(qp) : y_dc_scale(qp)));
}

#define MP4V_W1 22725
#define MP4V_W2 21407
#define MP4V_W3 19266
#define MP4V_W4 16383
#define MP4V_W5 12873
#define MP4V_W6 8867
#define MP4V_W7 4520

// libavcodec's 8-bit simple IDCT: coefficients (natural order) -> the 64
// outputs before the put/add clamp. 32-bit arithmetic wraps (unsigned), as
// libavcodec's SUINT; row results are stored as int16.
MP4V_HD void simple_idct(const int16_t* in, int* out) {
  int16_t rows[64];
  for (int r = 0; r < 8; ++r) {
    const int16_t* row = in + 8 * r;
    int16_t* o = rows + 8 * r;
    bool dc_only = true;
    for (int k = 1; k < 8; ++k) dc_only = dc_only && row[k] == 0;
    if (dc_only) {
      int16_t v = (int16_t)(uint16_t)((unsigned)row[0] * 8u);
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    unsigned a0 = (unsigned)MP4V_W4 * row[0] + (1u << 10);
    unsigned a1 = a0, a2 = a0, a3 = a0;
    a0 += (unsigned)MP4V_W2 * row[2];
    a1 += (unsigned)MP4V_W6 * row[2];
    a2 -= (unsigned)MP4V_W6 * row[2];
    a3 -= (unsigned)MP4V_W2 * row[2];
    unsigned b0 = (unsigned)MP4V_W1 * row[1] + (unsigned)MP4V_W3 * row[3];
    unsigned b1 = (unsigned)MP4V_W3 * row[1] - (unsigned)MP4V_W7 * row[3];
    unsigned b2 = (unsigned)MP4V_W5 * row[1] - (unsigned)MP4V_W1 * row[3];
    unsigned b3 = (unsigned)MP4V_W7 * row[1] - (unsigned)MP4V_W5 * row[3];
    a0 += (unsigned)MP4V_W4 * row[4] + (unsigned)MP4V_W6 * row[6];
    a1 += -(unsigned)MP4V_W4 * row[4] - (unsigned)MP4V_W2 * row[6];
    a2 += -(unsigned)MP4V_W4 * row[4] + (unsigned)MP4V_W2 * row[6];
    a3 += (unsigned)MP4V_W4 * row[4] - (unsigned)MP4V_W6 * row[6];
    b0 += (unsigned)MP4V_W5 * row[5] + (unsigned)MP4V_W7 * row[7];
    b1 += -(unsigned)MP4V_W1 * row[5] - (unsigned)MP4V_W5 * row[7];
    b2 += (unsigned)MP4V_W7 * row[5] + (unsigned)MP4V_W3 * row[7];
    b3 += (unsigned)MP4V_W3 * row[5] - (unsigned)MP4V_W1 * row[7];
    o[0] = (int16_t)((int)(a0 + b0) >> 11);
    o[7] = (int16_t)((int)(a0 - b0) >> 11);
    o[1] = (int16_t)((int)(a1 + b1) >> 11);
    o[6] = (int16_t)((int)(a1 - b1) >> 11);
    o[2] = (int16_t)((int)(a2 + b2) >> 11);
    o[5] = (int16_t)((int)(a2 - b2) >> 11);
    o[3] = (int16_t)((int)(a3 + b3) >> 11);
    o[4] = (int16_t)((int)(a3 - b3) >> 11);
  }
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = rows + c;
    unsigned a0 = (unsigned)MP4V_W4 * (unsigned)(col[0] + 32);
    unsigned a1 = a0, a2 = a0, a3 = a0;
    a0 += (unsigned)MP4V_W2 * col[16];
    a1 += (unsigned)MP4V_W6 * col[16];
    a2 -= (unsigned)MP4V_W6 * col[16];
    a3 -= (unsigned)MP4V_W2 * col[16];
    unsigned b0 = (unsigned)MP4V_W1 * col[8] + (unsigned)MP4V_W3 * col[24];
    unsigned b1 = (unsigned)MP4V_W3 * col[8] - (unsigned)MP4V_W7 * col[24];
    unsigned b2 = (unsigned)MP4V_W5 * col[8] - (unsigned)MP4V_W1 * col[24];
    unsigned b3 = (unsigned)MP4V_W7 * col[8] - (unsigned)MP4V_W5 * col[24];
    a0 += (unsigned)MP4V_W4 * col[32];
    a1 -= (unsigned)MP4V_W4 * col[32];
    a2 -= (unsigned)MP4V_W4 * col[32];
    a3 += (unsigned)MP4V_W4 * col[32];
    b0 += (unsigned)MP4V_W5 * col[40];
    b1 -= (unsigned)MP4V_W1 * col[40];
    b2 += (unsigned)MP4V_W7 * col[40];
    b3 += (unsigned)MP4V_W3 * col[40];
    a0 += (unsigned)MP4V_W6 * col[48];
    a1 -= (unsigned)MP4V_W2 * col[48];
    a2 += (unsigned)MP4V_W2 * col[48];
    a3 -= (unsigned)MP4V_W6 * col[48];
    b0 += (unsigned)MP4V_W7 * col[56];
    b1 -= (unsigned)MP4V_W5 * col[56];
    b2 += (unsigned)MP4V_W3 * col[56];
    b3 -= (unsigned)MP4V_W1 * col[56];
    out[0 * 8 + c] = (int)(a0 + b0) >> 20;
    out[1 * 8 + c] = (int)(a1 + b1) >> 20;
    out[2 * 8 + c] = (int)(a2 + b2) >> 20;
    out[3 * 8 + c] = (int)(a3 + b3) >> 20;
    out[4 * 8 + c] = (int)(a3 - b3) >> 20;
    out[5 * 8 + c] = (int)(a2 - b2) >> 20;
    out[6 * 8 + c] = (int)(a1 - b1) >> 20;
    out[7 * 8 + c] = (int)(a0 - b0) >> 20;
  }
}

// One predicted pixel at row j of a block: half-pel from the plane (eh x
// ew, stride ew), coordinates clamped into it; ``approx``: libavcodec's x86
// 8-wide put_no_rnd x2/y2 (see io/mpeg4.py _mc)
MP4V_HD int mc_pixel(const uint8_t* p, int eh, int ew, int y, int x, int hy, int hx,
                     int rounding, int approx, int j) {
  int y0 = clamp(y, 0, eh - 1), y1 = clamp(y + 1, 0, eh - 1);
  int x0 = clamp(x, 0, ew - 1), x1 = clamp(x + 1, 0, ew - 1);
  int a = p[(long)y0 * ew + x0];
  if (!hx && !hy) return a;
  int b = p[(long)y0 * ew + x1];
  int c = p[(long)y1 * ew + x0];
  if (hx && hy) {
    int d = p[(long)y1 * ew + x1];
    return (a + b + c + d + 2 - rounding) >> 2;
  }
  int o = hx ? b : c;
  if (!rounding) return (a + o + 1) >> 1;
  if (!approx) return (a + o) >> 1;
  // x2: the left pixel less 1; y2: the source row at an odd offset less 1
  if (hx || (j & 1)) return ((a > 0 ? a - 1 : 0) + o + 1) >> 1;
  return (a + (o > 0 ? o - 1 : 0) + 1) >> 1;
}

// a 4MV block's start clipped to [lo, hi], its half step dropped at hi
MP4V_HD void clip_start(int& p, int& half, int lo, int hi, int clip) {
  if (!clip) return;
  p = clamp(p, lo, hi);
  if (p == hi) half = 0;
}

// V2, one thread a block: dequantize, IDCT, predict, reconstruct into out
MP4V_HD void reconstruct_block(const Geom& g, const int16_t* levels, const int8_t* mode,
                               const int8_t* qp, const int16_t* mv, const uint8_t* ref,
                               int rounding, uint8_t* out, long tid) {
  long mb = tid / 6;
  int n = (int)(tid % 6);
  int mbx = (int)(mb % g.mbw), mby = (int)(mb / g.mbw);
  int md = mode[mb], q = qp[mb];
  int16_t c[64];
  int r[64];
  dequantize(levels + tid * 64, md == INTRA, q, n >= 4, c);
  simple_idct(c, r);
  const uint8_t* plane;
  uint8_t* dst;
  int ew, eh, x0, y0, hx, hy, approx, four = md == INTER4V;
  const int16_t* v;
  if (n < 4) {
    ew = g.YW(); eh = g.YH();
    x0 = mbx * 16 + (n & 1) * 8;
    y0 = mby * 16 + (n >> 1) * 8;
    plane = ref;
    dst = out;
    v = mv + mb * 10 + 2 * n;
    approx = four;
  } else {
    ew = g.CW(); eh = g.CH();
    x0 = mbx * 8;
    y0 = mby * 8;
    long off = g.ysize() + (n == 5 ? g.csize() : 0);
    plane = ref + off;
    dst = out + off;
    v = mv + mb * 10 + 8;
    approx = 1;
  }
  if (md == INTRA) {
    for (int j = 0; j < 8; ++j)
      for (int i = 0; i < 8; ++i)
        dst[(long)(y0 + j) * ew + x0 + i] = (uint8_t)clamp(r[8 * j + i], 0, 255);
    return;
  }
  int mx = v[0], my = v[1];
  int sx = x0 + (mx >> 1), sy = y0 + (my >> 1);
  hx = mx & 1;
  hy = my & 1;
  if (n < 4) {
    clip_start(sx, hx, -16, g.W, four);
    clip_start(sy, hy, -16, g.H, four);
  } else {
    clip_start(sx, hx, -8, g.W / 2, four);
    clip_start(sy, hy, -8, g.H / 2, four);
  }
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 8; ++i) {
      int p = mc_pixel(plane, eh, ew, sy + j, sx + i, hy, hx, rounding, approx, j);
      dst[(long)(y0 + j) * ew + x0 + i] = (uint8_t)clamp(p + r[8 * j + i], 0, 255);
    }
}

// V2's colour conversion, one thread a pixel: swscale's x86 yuv2rgb
MP4V_HD void colour_pixel(const Geom& g, const uint8_t* planes, uint8_t* bgr, long tid) {
  int y = (int)(tid / g.W), x = (int)(tid % g.W);
  int Y = planes[(long)y * g.YW() + x];
  long c = (long)(y >> 1) * g.CW() + (x >> 1);
  int U = planes[g.ysize() + c], V = planes[g.ysize() + g.csize() + c];
  int yc = ((Y * 8 - 128) * 9539) >> 16;
  int uc = U * 8 - 1024, vc = V * 8 - 1024;
  int b = yc + ((uc * 16525) >> 16);
  int gg = yc + ((uc * -3209) >> 16) + ((vc * -6660) >> 16);
  int r = yc + ((vc * 13075) >> 16);
  uint8_t* o = bgr + tid * 3;
  o[0] = (uint8_t)clamp(b, 0, 255);
  o[1] = (uint8_t)clamp(gg, 0, 255);
  o[2] = (uint8_t)clamp(r, 0, 255);
}

// limited-range BT.601 in 8-bit fixed point of the frame's pixel (y, x),
// edge-replicated past the frame: component 0 Y, 1 Cb, 2 Cr
MP4V_HD int yuv_of(const Geom& g, const uint8_t* bgr, int y, int x, int comp) {
  y = y < g.H ? y : g.H - 1;
  x = x < g.W ? x : g.W - 1;
  const uint8_t* p = bgr + ((long)y * g.W + x) * 3;
  int b = p[0], gg = p[1], r = p[2];
  if (comp == 0) return ((66 * r + 129 * gg + 25 * b + 128) >> 8) + 16;
  if (comp == 1) return ((-38 * r - 74 * gg + 112 * b + 128) >> 8) + 128;
  return ((112 * r - 94 * gg - 18 * b + 128) >> 8) + 128;
}

// V3, one thread a block: source (minus 128, or minus the zero-motion
// prediction from ref), islow FDCT, H.263 quantization
MP4V_HD void encode_block(const Geom& g, const uint8_t* bgr, const uint8_t* ref, int qp,
                          int16_t* levels, long tid) {
  long mb = tid / 6;
  int n = (int)(tid % 6);
  int mbx = (int)(mb % g.mbw), mby = (int)(mb / g.mbw);
  int s[64];
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 8; ++i) {
      int v, pred;
      if (n < 4) {
        int y = mby * 16 + (n >> 1) * 8 + j, x = mbx * 16 + (n & 1) * 8 + i;
        v = yuv_of(g, bgr, y, x, 0);
        pred = ref ? ref[(long)y * g.YW() + x] : 128;
      } else {
        int y = mby * 8 + j, x = mbx * 8 + i;
        v = (yuv_of(g, bgr, 2 * y, 2 * x, n - 3) + yuv_of(g, bgr, 2 * y, 2 * x + 1, n - 3) +
             yuv_of(g, bgr, 2 * y + 1, 2 * x, n - 3) +
             yuv_of(g, bgr, 2 * y + 1, 2 * x + 1, n - 3) + 2) >> 2;
        long off = g.ysize() + (n == 5 ? g.csize() : 0);
        pred = ref ? ref[off + (long)y * g.CW() + x] : 128;
      }
      s[8 * j + i] = v - pred;
    }
  int ws[64], coef[64], d[8], o[8];
  for (int j = 0; j < 8; ++j) {
    jpeg::fdct_1d(s + 8 * j, true, o);
    for (int u = 0; u < 8; ++u) ws[8 * j + u] = o[u];
  }
  for (int u = 0; u < 8; ++u) {
    for (int j = 0; j < 8; ++j) d[j] = ws[8 * j + u];
    jpeg::fdct_1d(d, false, o);
    for (int v = 0; v < 8; ++v) coef[8 * v + u] = o[v];
  }
  int16_t* out = levels + tid * 64;
  for (int k = 0; k < 64; ++k) {
    int cv = coef[k], a = cv < 0 ? -cv : cv, l;
    if (ref) {
      l = (a - 4 * qp > 0 ? a - 4 * qp : 0) / (16 * qp);
    } else if (k == 0) {
      int dcs = n < 4 ? y_dc_scale(qp) : c_dc_scale(qp);
      l = (cv + 8192 + 4 * dcs) / (8 * dcs);
      a = 0;
    } else {
      l = a / (16 * qp);
    }
    if (cv < 0 && !(k == 0 && !ref)) l = -l;
    out[k] = (int16_t)clamp(l, -2047, 2047);
  }
}

}  // namespace mp4v
