// The per-thread integer arithmetic of J4, the Motion JPEG pixel stage
// (mjpeg.cu), as functions that compile for the device and for the host
// alike, each bit for bit with the plain versions in
// mft_tpu_torch/io/mjpeg.py. They follow what cv2.VideoCapture runs for an
// MJPEG frame: libavcodec's mjpegdec (dequantization with the DC offset
// 4 << 8 folded into its prediction, the 8-bit simple IDCT of
// simple_idct_template.c, mpeg4.cuh, and the planes kept at their coded
// sampling), then swscale's YUVJ -> BGR24 conversion, full-range BT.601:
// - 4:2:0 and 4:2:2 (even height): the x86 yuv2rgb special converter,
//   16-bit fixed point, each chroma sample over the pixels it covers;
// - 4:4:4: the generic scaler's full-chroma output (yuv2rgb_write_full,
//   30-bit fixed point with 1 << 21 rounding);
// - grey: Y in all three channels.
// One thread does one 8x8 block (block_samples) or one pixel (bgr_pixel);
// the kernels and the host mirror of the tests call these with the
// thread's index.
#pragma once

#include <cstdint>

#include "mpeg4.cuh"

#ifdef __CUDACC__
#define MJPG_HD __host__ __device__ __forceinline__
#else
#define MJPG_HD inline
#endif

namespace mjpg {

enum { GREY = 0, SUBSAMPLED = 1, FULL = 2 };

// full-range BT.601: ff_yuv2rgb_c_init_tables' roundToInt16(c << 13) with
// the chroma coefficients scaled by 224 / 255
constexpr int kY = 8192, kUB = 14516, kUG = -2819, kVG = -5850, kVR = 11485;

// a frame geometry: size, conversion kind, blocks and samples a frame, and
// per component its block grid (bw x bh), first block and first sample;
// vshift: chroma row = pixel row >> vshift (4:2:0 1, 4:2:2 0)
struct Geom {
  int H, W, ncomp, kind, vshift;
  long blocks, samples;
  int bw[3], bh[3];
  long boff[3], poff[3];
};

MJPG_HD Geom read_geom(const long* v) {
  Geom g;
  g.H = (int)v[0];
  g.W = (int)v[1];
  g.ncomp = (int)v[2];
  g.kind = (int)v[3];
  g.vshift = (int)v[4];
  g.blocks = v[5];
  g.samples = v[6];
  for (int c = 0; c < 3; ++c) {
    g.bw[c] = (int)v[7 + 4 * c];
    g.bh[c] = (int)v[8 + 4 * c];
    g.boff[c] = v[9 + 4 * c];
    g.poff[c] = v[10 + 4 * c];
  }
  return g;
}

MJPG_HD int clip_int16(int v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : v); }

// one 8x8 block of frame n: dequantize (DC + 1024 clipped to int16, AC
// wrapped to int16 as mjpegdec stores them), simple IDCT, clamp, store into
// the component's plane (row stride 8 bw)
MJPG_HD void block_samples(const Geom& g, const int16_t* coefs, const int32_t* qtabs,
                           uint8_t* planes, long tid) {
  long n = tid / g.blocks, b = tid % g.blocks;
  int c = 0;
  while (c + 1 < g.ncomp && b >= g.boff[c + 1]) ++c;
  const int16_t* in = coefs + tid * 64;
  const int32_t* q = qtabs + (n * g.ncomp + c) * 64;
  int16_t blk[64];
  blk[0] = (int16_t)clip_int16(in[0] * q[0] + 1024);
  for (int k = 1; k < 64; ++k) blk[k] = (int16_t)(uint16_t)(unsigned)(in[k] * q[k]);
  int r[64];
  mp4v::simple_idct(blk, r);
  long local = b - g.boff[c];
  int bx = (int)(local % g.bw[c]), by = (int)(local / g.bw[c]);
  long stride = 8L * g.bw[c];
  uint8_t* dst = planes + n * g.samples + g.poff[c] + (long)by * 8 * stride + bx * 8;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 8; ++i) dst[j * stride + i] = (uint8_t)mp4v::clamp(r[8 * j + i], 0, 255);
}

// one pixel of frame n (tid over N x H x W) -> 3 bytes of BGR
MJPG_HD void bgr_pixel(const Geom& g, const uint8_t* planes, uint8_t* bgr, long tid) {
  long hw = (long)g.H * g.W;
  long n = tid / hw, p = tid % hw;
  int y = (int)(p / g.W), x = (int)(p % g.W);
  const uint8_t* f = planes + n * g.samples;
  int Y = f[g.poff[0] + (long)y * 8 * g.bw[0] + x];
  uint8_t* o = bgr + tid * 3;
  if (g.kind == GREY) {
    o[0] = o[1] = o[2] = (uint8_t)Y;
    return;
  }
  long cy = g.kind == FULL ? y : (y >> g.vshift), cx = g.kind == FULL ? x : (x >> 1);
  int U = f[g.poff[1] + cy * 8 * g.bw[1] + cx];
  int V = f[g.poff[2] + cy * 8 * g.bw[2] + cx];
  int b, gg, r;
  if (g.kind == SUBSAMPLED) {
    // pmulhw products: the floor of x * c / 65536
    int yc = (Y * 8 * kY) >> 16;
    int uc = U * 8 - 1024, vc = V * 8 - 1024;
    b = yc + ((uc * kUB) >> 16);
    gg = yc + ((uc * kUG) >> 16) + ((vc * kVG) >> 16);
    r = yc + ((vc * kVR) >> 16);
  } else {
    int yv = (Y << 9) * kY + (1 << 21);
    int uv = (U - 128) << 9, vv = (V - 128) << 9;
    int R = yv + vv * kVR, G = yv + vv * kVG + uv * kUG, B = yv + uv * kUB;
    const int top = (1 << 30) - 1;
    b = (B < 0 ? 0 : (B > top ? top : B)) >> 22;
    gg = (G < 0 ? 0 : (G > top ? top : G)) >> 22;
    r = (R < 0 ? 0 : (R > top ? top : R)) >> 22;
  }
  o[0] = (uint8_t)mp4v::clamp(b, 0, 255);
  o[1] = (uint8_t)mp4v::clamp(gg, 0, 255);
  o[2] = (uint8_t)mp4v::clamp(r, 0, 255);
}

}  // namespace mjpg
