// The per-thread integer arithmetic of the JPEG pixel kernels (jpeg.cu), as
// functions that compile for the device and for the host alike. Each is
// libjpeg-turbo's default algorithm step for step, as the plain versions in
// mft_tpu_torch/io/jpeg.py are: jidctint.c (islow IDCT), jdsample.c (fancy
// upsampling), jdcolor.c (YCbCr -> RGB), jccolor.c (RGB -> YCbCr),
// jcsample.c (downsampling), jfdctint.c (islow FDCT), jcdctmgr.c
// (quantization by reciprocal).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define JPEG_HD __host__ __device__ __forceinline__
#else
#define JPEG_HD inline
#endif

namespace jpeg {

enum { YCC = 0, RGB = 1, GREY = 2 };
enum { UP_FULL = 0, UP_H2V1 = 1, UP_H1V2 = 2, UP_H2V2 = 3, UP_REPLICATE = 4 };

// A frame's geometry, from the int64 descriptor of io/jpeg.py Geometry.vector.
struct Geom {
  int H, W, ncomp, color, max_h, max_v;
  long long blocks, samples;
  int h[3], v[3], fh[3], fv[3], dw[3], dh[3], bw[3], bh[3];
  long long boff[3], poff[3];
  int up[3], rows[3];
};

inline Geom read_geom(const long long* g) {
  Geom o;
  o.H = (int)g[0];
  o.W = (int)g[1];
  o.ncomp = (int)g[2];
  o.color = (int)g[3];
  o.max_h = (int)g[4];
  o.max_v = (int)g[5];
  o.blocks = g[6];
  o.samples = g[7];
  for (int c = 0; c < 3; c++) {
    const long long* f = g + 8 + 12 * c;
    o.h[c] = (int)f[0];
    o.v[c] = (int)f[1];
    o.fh[c] = (int)f[2];
    o.fv[c] = (int)f[3];
    o.dw[c] = (int)f[4];
    o.dh[c] = (int)f[5];
    o.bw[c] = (int)f[6];
    o.bh[c] = (int)f[7];
    o.boff[c] = f[8];
    o.poff[c] = f[9];
    o.up[c] = (int)f[10];
    o.rows[c] = (int)f[11];
  }
  return o;
}

// The component of block b (of a frame's blocks).
JPEG_HD int component_of(const Geom& g, long long b) {
  return (g.ncomp > 1 && b >= g.boff[1]) + (g.ncomp > 2 && b >= g.boff[2]);
}

// jidctint.c / jfdctint.c constants (CONST_BITS 13)
constexpr long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                     F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                     F2562 = 20995, F3072 = 25172;

// One 1-D pass of jpeg_idct_islow over x[0..7] (64-bit products, as JLONG),
// outputs descaled by `shift` bits and stored as int (the workspace's type).
JPEG_HD void idct_1d(const long long* x, int shift, int* out) {
  long long z1 = (x[2] + x[6]) * F0541;
  long long tmp2 = z1 - x[6] * F1847;
  long long tmp3 = z1 + x[2] * F0765;
  long long tmp0 = (x[0] + x[4]) * 8192;
  long long tmp1 = (x[0] - x[4]) * 8192;
  long long t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  long long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  long long za = t0 + t3, zb = t1 + t2, zc = t0 + t2, zd = t1 + t3;
  long long z5 = (zc + zd) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  za *= -F0899;
  zb *= -F2562;
  zc = zc * -F1961 + z5;
  zd = zd * -F0390 + z5;
  t0 += za + zc;
  t1 += zb + zd;
  t2 += zb + zc;
  t3 += za + zd;
  long long half = 1LL << (shift - 1);
  out[0] = (int)((t10 + t3 + half) >> shift);
  out[1] = (int)((t11 + t2 + half) >> shift);
  out[2] = (int)((t12 + t1 + half) >> shift);
  out[3] = (int)((t13 + t0 + half) >> shift);
  out[4] = (int)((t13 - t0 + half) >> shift);
  out[5] = (int)((t12 - t1 + half) >> shift);
  out[6] = (int)((t11 - t2 + half) >> shift);
  out[7] = (int)((t10 - t3 + half) >> shift);
}

// The post-IDCT range-limit table, indexed by x & 1023.
JPEG_HD int range_limit(int x) {
  int j = x & 1023;
  return j < 128 ? j + 128 : j < 512 ? 255 : j < 896 ? 0 : j - 896;
}

JPEG_HD int imin(int a, int b) { return a < b ? a : b; }
JPEG_HD int imax(int a, int b) { return a > b ? a : b; }

// Component c's upsampled sample at full-resolution (y, x); p is the
// component's plane (rows of `stride` samples).
JPEG_HD int upsample(const uint8_t* p, int stride, const Geom& g, int c, int y, int x) {
  int dw = g.dw[c], dh = g.dh[c];
  switch (g.up[c]) {
    case UP_FULL:
      return p[(long long)y * stride + x];
    case UP_H2V1: {
      int i = x >> 1, odd = x & 1;
      int nb = odd ? imin(i + 1, dw - 1) : imax(i - 1, 0);
      const uint8_t* row = p + (long long)y * stride;
      return (3 * row[i] + row[nb] + 1 + odd) >> 2;
    }
    case UP_H1V2: {
      int j = y >> 1, odd = y & 1;
      int nb = odd ? imin(j + 1, dh - 1) : imax(j - 1, 0);
      return (3 * p[(long long)j * stride + x] + p[(long long)nb * stride + x] + 1 + odd) >> 2;
    }
    case UP_H2V2: {
      int j = y >> 1, oddy = y & 1;
      int nbr = oddy ? imin(j + 1, dh - 1) : imax(j - 1, 0);
      int i = x >> 1, oddx = x & 1;
      int nbc = oddx ? imin(i + 1, dw - 1) : imax(i - 1, 0);
      const uint8_t* r0 = p + (long long)j * stride;
      const uint8_t* r1 = p + (long long)nbr * stride;
      int cs = 3 * r0[i] + r1[i];
      int cn = 3 * r0[nbc] + r1[nbc];
      return (3 * cs + cn + 8 - oddx) >> 4;
    }
    default:
      return p[(long long)(y / g.fv[c]) * stride + x / g.fh[c]];
  }
}

JPEG_HD int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// jdcolor.c ycc_rgb_convert of one pixel -> b, g, r
JPEG_HD void ycc_to_bgr(int y, int cb, int cr, int* bgr) {
  cb -= 128;
  cr -= 128;
  bgr[2] = clamp255(y + ((91881 * cr + 32768) >> 16));
  bgr[1] = clamp255(y + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  bgr[0] = clamp255(y + ((116130 * cb + 32768) >> 16));
}

// jccolor.c rgb_ycc_convert: component c (0 Y, 1 Cb, 2 Cr) of a BGR pixel
JPEG_HD int bgr_to_ycc(const uint8_t* px, int c) {
  int b = px[0], g = px[1], r = px[2];
  if (c == 0) return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16;
  if (c == 1) return (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16;
  return (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16;
}

// Component c's sample (i, j) of its plane, as jcsample.c and jcprepct.c
// make it from an (H, W, C) uint8 image: columns from the image's right edge
// repeated, rows past the last downsampled one repeated.
JPEG_HD int downsample(const uint8_t* img, int C, const Geom& g, int c, int i, int j) {
  int fh = g.fh[c], fv = g.fv[c];
  i = imin(i, g.rows[c] - 1);
  int acc = 0;
  for (int dy = 0; dy < fv; dy++) {
    int sy = imin(i * fv + dy, g.H - 1);
    for (int dx = 0; dx < fh; dx++) {
      int sx = imin(j * fh + dx, g.W - 1);
      const uint8_t* px = img + ((long long)sy * g.W + sx) * C;
      acc += C == 1 ? px[0] : bgr_to_ycc(px, c);
    }
  }
  if (fh == 1 && fv == 1) return acc;
  if (fh == 2 && fv == 1) return (acc + (j & 1)) >> 1;
  if (fh == 2 && fv == 2) return (acc + 1 + (j & 1)) >> 2;
  int n = fh * fv;
  return (acc + n / 2) / n;
}

// One 1-D pass of jpeg_fdct_islow over d[0..7]: pass 1 (rows) keeps
// PASS1_BITS of scale, pass 2 (columns) removes it.
JPEG_HD void fdct_1d(const int* d, bool pass1, int* out) {
  long long tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  long long tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  long long tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  long long tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  long long t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  int shift = pass1 ? 11 : 15;
  long long hs = 1LL << (shift - 1);
  if (pass1) {
    out[0] = (int)((t10 + t11) * 4);
    out[4] = (int)((t10 - t11) * 4);
  } else {
    out[0] = (int)((t10 + t11 + 2) >> 2);
    out[4] = (int)((t10 - t11 + 2) >> 2);
  }
  long long z1 = (t12 + t13) * F0541;
  out[2] = (int)((z1 + t13 * F0765 + hs) >> shift);
  out[6] = (int)((z1 - t12 * F1847 + hs) >> shift);
  long long za = tmp4 + tmp7, zb = tmp5 + tmp6, zc = tmp4 + tmp6, zd = tmp5 + tmp7;
  long long z5 = (zc + zd) * F1175;
  tmp4 *= F0298;
  tmp5 *= F2053;
  tmp6 *= F3072;
  tmp7 *= F1501;
  za *= -F0899;
  zb *= -F2562;
  zc = zc * -F1961 + z5;
  zd = zd * -F0390 + z5;
  out[7] = (int)((tmp4 + za + zc + hs) >> shift);
  out[5] = (int)((tmp5 + zb + zd + hs) >> shift);
  out[3] = (int)((tmp6 + zb + zc + hs) >> shift);
  out[1] = (int)((tmp7 + za + zd + hs) >> shift);
}

// jcdctmgr.c quantize with (reciprocal, correction, shift)
JPEG_HD int quantize(int x, int recip, int corr, int shift) {
  long long mag = ((long long)(x < 0 ? -x : x) + corr) * recip >> shift;
  return x < 0 ? (int)-mag : (int)mag;
}

}  // namespace jpeg
