// V1: MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile VLC stage on the host.
//
// Replaces no Pallas site: the JAX package decodes and encodes video files
// through OpenCV (libavcodec) on the host (mft_tpu/io/video.py:29-30, 40,
// 83-86). A VOP's header, macroblock syntax, variable-length codes and the
// DC/AC and motion-vector predictions are serial bit-level work with a
// data-dependent position, so they stay on the host; the pixel stages run
// on the card (mpeg4.cu). Bound: the bits of the VOP, read or written once;
// per code one lookahead-table load (decode) or one code-table load (encode).
//
// Host-only code with plain C entry points (no CUDA call), loaded with
// ctypes and called a VOP after the other, before that VOP's V2 launch.
// Bit for bit with the Python
// plain versions (mft_tpu_torch/io/mpeg4.py vlc_decode_ref /
// vlc_encode_ref): the same syntax arrays from the same bytes, the same
// bytes from the same syntax. The code tables come from the Python module
// (one source for both): lookahead tables for decoding, code tables for
// encoding, and the escapes' largest level / longest run.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

enum { NOT_CODED = 0, INTER = 1, INTER4V = 2, INTRA = 3 };
enum { T_MCBPC_I, T_MCBPC_P, T_CBPY, T_DC_LUM, T_DC_CHROM, T_MVD, T_INTRA, T_INTER, N_TABLES };
enum { STUFFING = 20, TC_ESCAPE = 0x7FFF };
// error codes, mapped to messages by ops/mpeg4.py
enum {
  E_OK = 0, E_CODE = 1, E_BVOP = 2, E_SVOP = 3, E_RESYNC = 4, E_TRUNCATED = 5, E_RUN = 6,
  E_ESC3_LEVEL = 7, E_ESC_ESC = 8, E_QUANT = 9, E_DC_SIZE = 10, E_DC_NEG = 11,
  E_SYNTAX = 12, E_OVERFLOW = 13
};

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const int kAltH[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const int kAltV[64] = {  // the transpose of kAltH
     0,  8, 16, 24,  1,  9,  2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18,  3, 11,  4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28,  5, 13,  6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30,  7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const int* scan_table(int which) {   // 0 zigzag, 1 left (alternate vertical), 2 top
  return which == 1 ? kAltV : (which == 2 ? kAltH : kZigzag);
}

const int kYDC[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                      24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const int kCDC[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                      14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDCThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};
const int kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};

int16_t wrap16(int v) { return (int16_t)(uint16_t)(unsigned)v; }
int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }
int mid_pred(int a, int b, int c) {
  int lo = a < b ? a : b, hi = a < b ? b : a;
  return c < lo ? lo : (c > hi ? hi : c);
}
int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v >> (bits - 1)) ? v - (1 << bits) : v;
}

// MSB-first reader; zeros past the end
struct Reader {
  const uint8_t* d;
  long n;     // bits
  long p;
  uint32_t peek(int k) const {
    uint64_t v = 0;
    long byte = p >> 3;
    for (int i = 0; i < 5; ++i) {
      long q = byte + i;
      v = (v << 8) | (q < (n >> 3) ? d[q] : 0);
    }
    return (uint32_t)((v >> (40 - (p & 7) - k)) & ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    p += k;
    return v;
  }
};

struct Tables {
  const int* luts;
  const int* off;    // N_TABLES offsets into luts, then N_TABLES lookahead bits
  const int* maxima; // [intra][0: max_level, 1: max_run][last][64]
  int max_level(int intra, int last, int run) const {
    return maxima[((intra * 2 + 0) * 2 + last) * 64 + run];
  }
  int max_run(int intra, int last, int level) const {
    return maxima[((intra * 2 + 1) * 2 + last) * 64 + level];
  }
};

// one VLC: value, or -1 where no code starts
int vlc(Reader& r, const Tables& t, int table) {
  int bits = t.off[N_TABLES + table];
  int e = t.luts[t.off[table] + r.peek(bits)];
  if (e < 0) return -1;
  r.p += e & 0xFF;
  return e >> 8;
}

// The per-VOP prediction state (as io/mpeg4.py _Pred): DC values, AC first
// columns/rows of intra blocks, MB quantisers, the MV grid.
struct Pred {
  int mbw, mbh;
  int* dc[3];
  int16_t* ac[3];   // [y][x][2][8]: 0 first column, 1 first row
  int* mbqp;
  int* mvg;         // [2 mbh][2 mbw][2]
  int* store;
  Pred(int w, int h) : mbw(w), mbh(h) {
    long nl = 4L * w * h, nc = (long)w * h;
    store = (int*)calloc(nl + 2 * nc + nc + nl * 2, sizeof(int));
    dc[0] = store;
    dc[1] = dc[0] + nl;
    dc[2] = dc[1] + nc;
    mbqp = dc[2] + nc;
    mvg = mbqp + nc;
    for (long i = 0; i < nl + 2 * nc; ++i) store[i] = 1024;
    ac[0] = (int16_t*)calloc((nl + 2 * nc) * 16, sizeof(int16_t));
    ac[1] = ac[0] + nl * 16;
    ac[2] = ac[1] + nc * 16;
  }
  ~Pred() {
    free(store);
    free(ac[0]);
  }
  bool ok() const { return store != nullptr && ac[0] != nullptr; }
  void where(int n, int mbx, int mby, int& c, int& y, int& x, int& w) const {
    if (n < 4) {
      c = 0; y = 2 * mby + (n >> 1); x = 2 * mbx + (n & 1); w = 2 * mbw;
    } else {
      c = n - 3; y = mby; x = mbx; w = mbw;
    }
  }
  // prediction of the quantized DC, direction (0 left, 1 top), scale
  int dc_pred(int n, int mbx, int mby, int qscale, int& dir, int& scale) const {
    int c, y, x, w;
    where(n, mbx, mby, c, y, x, w);
    const int* g = dc[c];
    int a = x > 0 ? g[y * w + x - 1] : 1024;
    int b = (x > 0 && y > 0) ? g[(y - 1) * w + x - 1] : 1024;
    int cc = y > 0 ? g[(y - 1) * w + x] : 1024;
    scale = n < 4 ? kYDC[qscale] : kCDC[qscale];
    int pred;
    if (abs(a - b) < abs(b - cc)) {
      pred = cc; dir = 1;
    } else {
      pred = a; dir = 0;
    }
    return (pred + (scale >> 1)) / scale;
  }
  void store_dc(int n, int mbx, int mby, int level, int scale) {
    int c, y, x, w;
    where(n, mbx, mby, c, y, x, w);
    int v = level * scale;
    if (v & ~2047) v = v < 0 ? 0 : 2047;
    dc[c][y * w + x] = v;
  }
  void ac_pred(int n, int mbx, int mby, int dir, int qscale, int* out) const {
    int c, y, x, w;
    where(n, mbx, mby, c, y, x, w);
    const int16_t* vals;
    bool same;
    int q;
    if (dir == 0) {
      if (x == 0) { for (int k = 0; k < 7; ++k) out[k] = 0; return; }
      vals = ac[c] + ((long)y * w + x - 1) * 16 + 0 * 8;
      q = mbx > 0 ? mbqp[mby * mbw + mbx - 1] : qscale;
      same = mbx == 0 || n == 1 || n == 3 || q == qscale;
    } else {
      if (y == 0) { for (int k = 0; k < 7; ++k) out[k] = 0; return; }
      vals = ac[c] + ((long)(y - 1) * w + x) * 16 + 1 * 8;
      q = mby > 0 ? mbqp[(mby - 1) * mbw + mbx] : qscale;
      same = mby == 0 || n == 2 || n == 3 || q == qscale;
    }
    for (int k = 0; k < 7; ++k) out[k] = same ? vals[k + 1] : rounded_div(vals[k + 1] * q, qscale);
  }
  void store_ac(int n, int mbx, int mby, const int16_t* block) {
    int c, y, x, w;
    where(n, mbx, mby, c, y, x, w);
    int16_t* a = ac[c] + ((long)y * w + x) * 16;
    for (int k = 1; k < 8; ++k) {
      a[k] = block[k * 8];
      a[8 + k] = block[k];
    }
  }
  void mv_at(int y, int x, int& vx, int& vy) const {
    if (y < 0 || x < 0 || x >= 2 * mbw) { vx = vy = 0; return; }
    vx = mvg[((long)y * 2 * mbw + x) * 2];
    vy = mvg[((long)y * 2 * mbw + x) * 2 + 1];
  }
  void set_mv(int y, int x, int vx, int vy) {
    mvg[((long)y * 2 * mbw + x) * 2] = vx;
    mvg[((long)y * 2 * mbw + x) * 2 + 1] = vy;
  }
  // libavcodec's ff_h263_pred_motion without resync markers
  void mv_pred(int block, int mbx, int mby, int& px, int& py) const {
    int by = 2 * mby + (block >> 1), bx = 2 * mbx + (block & 1);
    int ax, ay, bxv, byv, cx, cy;
    mv_at(by, bx - 1, ax, ay);
    if (mby == 0 && block < 3) {
      if (block == 0) {
        if (mbx == 0) { px = py = 0; } else { px = ax; py = ay; }
        return;
      }
      if (block == 1) { px = ax; py = ay; return; }
      mv_at(by - 1, bx, bxv, byv);
      mv_at(by - 1, bx + 1, cx, cy);
    } else {
      const int off[4] = {2, 1, 1, -1};
      mv_at(by - 1, bx, bxv, byv);
      mv_at(by - 1, bx + off[block], cx, cy);
    }
    px = mid_pred(ax, bxv, cx);
    py = mid_pred(ay, byv, cy);
  }
};

void chroma_mv(int mode, const int16_t* mv4, int16_t* out) {
  for (int k = 0; k < 2; ++k) {
    if (mode == INTER4V) {
      int s = mv4[k] + mv4[2 + k] + mv4[4 + k] + mv4[6 + k];
      out[k] = (int16_t)(kChromaRound[s & 15] + ((s >> 3) & ~1));
    } else {
      int v = mv4[k];
      out[k] = (int16_t)((v >> 1) | (v & 1));
    }
  }
}

int decode_motion(Reader& r, const Tables& t, int pred, int fcode, int& err) {
  int code = vlc(r, t, T_MVD);
  if (code < 0) { err = E_CODE; return 0; }
  if (code == 0) return pred;
  int sign = r.read(1);
  int shift = fcode - 1;
  int val = code;
  if (shift) {
    val = ((val - 1) << shift) | (int)r.read(shift);
    val += 1;
  }
  if (sign) val = -val;
  return sign_extend(val + pred, 5 + fcode);
}

// (last, run, signed level) of one TCOEF, escapes included
int read_tcoef(Reader& r, const Tables& t, int intra, int& last, int& run, int& level) {
  int table = intra ? T_INTRA : T_INTER;
  int v = vlc(r, t, table);
  if (v < 0) return E_CODE;
  if (v != TC_ESCAPE) {
    int sign = r.read(1);
    last = v >> 12; run = (v >> 6) & 63; level = v & 63;
    if (sign) level = -level;
    return E_OK;
  }
  int mode;
  if (!r.read(1)) {
    mode = 1;
  } else if (!r.read(1)) {
    mode = 2;
  } else {
    last = r.read(1);
    run = r.read(6);
    r.read(1);
    level = sign_extend(r.read(12), 12);
    r.read(1);
    if (level == 0 || level == -2048) return E_ESC3_LEVEL;
    return E_OK;
  }
  v = vlc(r, t, table);
  if (v < 0) return E_CODE;
  if (v == TC_ESCAPE) return E_ESC_ESC;
  last = v >> 12; run = (v >> 6) & 63; level = v & 63;
  if (mode == 1)
    level += t.max_level(intra, last, run);
  else
    run += t.max_run(intra, last, level) + 1;
  if (r.read(1)) level = -level;
  return E_OK;
}

int read_block(Reader& r, const Tables& t, int16_t* block, int start, const int* scan, int intra) {
  int i = start;
  for (;;) {
    int last, run, level;
    int e = read_tcoef(r, t, intra, last, run, level);
    if (e) return e;
    i += run + 1;
    if (i > 63) return E_RUN;
    block[scan[i]] = (int16_t)level;
    if (last) return E_OK;
  }
}

bool resync_marker(Reader& r, int kind, int fcode) {
  long p = r.p;
  int pad = (p & 7) ? 8 - (int)(p & 7) : 8;
  if (r.peek(pad) != (1u << (pad - 1)) - 1) return false;
  int n = 16 + (kind == 1 ? fcode - 1 : 0);
  r.p += pad;
  bool hit = r.peek(n + 1) == 1;
  r.p = p;
  return hit;
}

// MSB-first writer into a caller's buffer
struct Writer {
  uint8_t* out;
  long cap, n;
  uint64_t acc;
  int bits;
  bool overflow;
  void put(int k, uint32_t v) {
    if (k == 0) return;
    acc = (acc << k) | (v & ((1ull << k) - 1));
    bits += k;
    while (bits >= 8) {
      bits -= 8;
      if (n < cap) out[n] = (uint8_t)(acc >> bits); else overflow = true;
      ++n;
    }
    acc &= (1ull << bits) - 1;
  }
  void code(int cb) { put(cb & 0xFF, (uint32_t)(cb >> 8)); }
  void stuff() {
    put(1, 0);
    while (bits) put(1, 1);
  }
};

struct EncTables {
  const int* tabs;
  const int* off;  // offsets: MCBPC_I, MCBPC_P, CBPY, DC_LUM, DC_CHROM, MVD, TCOEF_INTRA,
                   // TCOEF_INTER, ESCAPE; entries code << 8 | bits, 0 where none
  int get(int table, int value) const { return tabs[off[table] + value]; }
  int tcoef(int intra, int last, int run, int level) const {
    if (run > 63 || level > 63) return 0;
    return tabs[off[intra ? T_INTRA : T_INTER] + (last * 64 + run) * 64 + level];
  }
  int escape() const { return tabs[off[N_TABLES]]; }
};

void write_motion(Writer& w, const EncTables& t, int val, int fcode) {
  if (val == 0) { w.code(t.get(T_MVD, 0)); return; }
  int bit_size = fcode - 1;
  val = sign_extend(val, 6 + bit_size);
  int sign = val < 0;
  val = abs(val) - 1;
  int code = (val >> bit_size) + 1;
  w.code(t.get(T_MVD, code));
  w.put(1, sign);
  w.put(bit_size, val & ((1 << bit_size) - 1));
}

int write_tcoef(Writer& w, const EncTables& t, const Tables& dt, int last, int run, int level,
                int intra) {
  int a = abs(level), sign = level < 0;
  int cb = t.tcoef(intra, last, run, a);
  if (cb) { w.code(cb); w.put(1, sign); return E_OK; }
  int ml = run < 64 ? dt.max_level(intra, last, run) : 0;
  if (ml && a - ml > 0) {
    cb = t.tcoef(intra, last, run, a - ml);
    if (cb) {
      w.code(t.escape()); w.put(1, 0); w.code(cb); w.put(1, sign);
      return E_OK;
    }
  }
  if (a < 64 && dt.max_run(intra, last, a) >= 0) {
    int r2 = run - dt.max_run(intra, last, a) - 1;
    cb = r2 >= 0 ? t.tcoef(intra, last, r2, a) : 0;
    if (cb) {
      w.code(t.escape()); w.put(2, 2); w.code(cb); w.put(1, sign);
      return E_OK;
    }
  }
  if (!(a > 0 && a <= 2047)) return E_SYNTAX;
  w.code(t.escape());
  w.put(2, 3);
  w.put(1, last);
  w.put(6, run);
  w.put(1, 1);
  w.put(12, (uint32_t)level & 0xFFF);
  w.put(1, 1);
  return E_OK;
}

int write_block(Writer& w, const EncTables& t, const Tables& dt, const int* block, int start,
                const int* scan, int intra) {
  int last_i = -1;
  for (int i = start; i < 64; ++i)
    if (block[scan[i]]) last_i = i;
  int prev = start - 1;
  for (int i = start; i < 64; ++i) {
    int v = block[scan[i]];
    if (!v) continue;
    int e = write_tcoef(w, t, dt, i == last_i, i - prev - 1, v, intra);
    if (e) return e;
    prev = i;
  }
  return E_OK;
}

}  // namespace

extern "C" {

// Decode one VOP (the bytes after its start code 00 00 01 B6) into its
// syntax arrays; see io/mpeg4.py vlc_decode_ref. vol: width, height,
// time_increment bits, resync markers possible. header (8 ints): coding
// type, vop_coded, rounding type, quant, fcode, intra_dc_vlc_thr,
// modulo_time_base ones, time increment. The arrays must hold nmb MBs and
// be zeroed by the caller. Returns 0 or an error code.
int mft_mpeg4_vlc_decode(const uint8_t* data, long nbytes, const int* vol, const int* luts,
                         const int* lut_off, const int* maxima, int* header, int8_t* mode,
                         int8_t* qp, int8_t* acpred, int16_t* mv, int16_t* levels) {
  Tables t{luts, lut_off, maxima};
  Reader r{data, nbytes * 8, 0};
  int width = vol[0], height = vol[1], time_bits = vol[2], resync = vol[3];
  int mbw = (width + 15) / 16, mbh = (height + 15) / 16, nmb = mbw * mbh;
  int kind = r.read(2);
  if (kind == 2) return E_BVOP;
  if (kind == 3) return E_SVOP;
  int ones = 0;
  while (r.read(1)) {
    ++ones;
    if (r.p > r.n) return E_TRUNCATED;
  }
  r.read(1);
  int incr = r.read(time_bits);
  r.read(1);
  for (int i = 0; i < 8; ++i) header[i] = 0;
  header[0] = kind; header[6] = ones; header[7] = incr;
  header[4] = 1;
  if (!r.read(1)) return E_OK;
  header[1] = 1;
  header[2] = kind == 1 ? (int)r.read(1) : 0;
  header[5] = r.read(3);
  int quant = r.read(5);
  header[3] = quant;
  if (quant == 0) return E_QUANT;
  int fcode = kind == 1 ? (int)r.read(3) : 1;
  header[4] = fcode;
  if (fcode == 0) return E_QUANT;
  int thr = kDCThreshold[header[5]];
  Pred st(mbw, mbh);
  if (!st.ok()) return E_OVERFLOW;
  int qscale = quant;
  for (int mb = 0; mb < nmb; ++mb) {
    int mby = mb / mbw, mbx = mb % mbw;
    if (mb && resync && resync_marker(r, kind, fcode)) return E_RESYNC;
    int cbpc;
    if (kind == 1) {
      for (;;) {
        if (r.read(1)) { cbpc = -1; break; }
        cbpc = vlc(r, t, T_MCBPC_P);
        if (cbpc < 0) return E_CODE;
        if (cbpc != STUFFING) break;
      }
      if (cbpc < 0) {
        mode[mb] = NOT_CODED;
        qp[mb] = (int8_t)qscale;
        st.mbqp[mb] = qscale;
        continue;
      }
    } else {
      for (;;) {
        cbpc = vlc(r, t, T_MCBPC_I);
        if (cbpc < 0) return E_CODE;
        if (cbpc != STUFFING) break;
      }
    }
    int mtype = cbpc >> 2;
    cbpc &= 3;
    bool intra = mtype >= 3, dquant = mtype == 1 || mtype == 4;
    int acp = intra ? (int)r.read(1) : 0;
    int cbpy = vlc(r, t, T_CBPY);
    if (cbpy < 0) return E_CODE;
    if (!intra) cbpy ^= 15;
    int cbp = (cbpy << 2) | cbpc;
    bool use_dc_vlc = qscale < thr;
    if (dquant) {
      qscale += kDquant[r.read(2)];
      qscale = qscale < 1 ? 1 : (qscale > 31 ? 31 : qscale);
    }
    qp[mb] = (int8_t)qscale;
    acpred[mb] = (int8_t)acp;
    st.mbqp[mb] = qscale;
    int16_t* lv = levels + (long)mb * 6 * 64;
    int16_t* mvo = mv + (long)mb * 10;
    if (intra) {
      mode[mb] = INTRA;
      for (int n = 0; n < 6; ++n) {
        int16_t block[64];
        int diff0 = 0;
        int dir, scale;
        int pred = st.dc_pred(n, mbx, mby, qscale, dir, scale);
        int start;
        if (use_dc_vlc) {
          int size = vlc(r, t, n < 4 ? T_DC_LUM : T_DC_CHROM);
          if (size < 0) return E_CODE;
          if (size > 9) return E_DC_SIZE;
          int diff = 0;
          if (size) {
            diff = r.read(size);
            if (!(diff >> (size - 1))) diff -= (1 << size) - 1;
            if (size > 8) r.read(1);
          }
          diff0 = diff;
          start = 0;
        } else {
          start = -1;
        }
        const int* scan = scan_table(acp ? 1 + dir : 0);
        memset(block, 0, sizeof(block));
        if (cbp & (32 >> n)) {
          int e = read_block(r, t, block, start, scan, 1);
          if (e) return e;
        }
        int level = (use_dc_vlc ? diff0 : block[0]) + pred;
        if (level < 0) return E_DC_NEG;
        st.store_dc(n, mbx, mby, level, scale);
        block[0] = wrap16(level);
        if (acp) {
          int p[7];
          st.ac_pred(n, mbx, mby, dir, qscale, p);
          for (int k = 1; k < 8; ++k) {
            int idx = dir == 0 ? k * 8 : k;
            block[idx] = wrap16(block[idx] + p[k - 1]);
          }
        }
        st.store_ac(n, mbx, mby, block);
        memcpy(lv + n * 64, block, sizeof(block));
      }
      continue;
    }
    if (mtype == 2) {
      mode[mb] = INTER4V;
      for (int b = 0; b < 4; ++b) {
        int px, py, err = 0;
        st.mv_pred(b, mbx, mby, px, py);
        int mx = decode_motion(r, t, px, fcode, err);
        int my = decode_motion(r, t, py, fcode, err);
        if (err) return err;
        st.set_mv(2 * mby + (b >> 1), 2 * mbx + (b & 1), mx, my);
        mvo[2 * b] = (int16_t)mx;
        mvo[2 * b + 1] = (int16_t)my;
      }
    } else {
      mode[mb] = INTER;
      int px, py, err = 0;
      st.mv_pred(0, mbx, mby, px, py);
      int mx = decode_motion(r, t, px, fcode, err);
      int my = decode_motion(r, t, py, fcode, err);
      if (err) return err;
      for (int b = 0; b < 4; ++b) {
        st.set_mv(2 * mby + (b >> 1), 2 * mbx + (b & 1), mx, my);
        mvo[2 * b] = (int16_t)mx;
        mvo[2 * b + 1] = (int16_t)my;
      }
    }
    chroma_mv(mode[mb], mvo, mvo + 8);
    for (int n = 0; n < 6; ++n) {
      if (cbp & (32 >> n)) {
        int e = read_block(r, t, lv + n * 64, -1, kZigzag, 0);
        if (e) return e;
      }
    }
  }
  if (r.p > r.n) return E_TRUNCATED;
  return E_OK;
}

// Write one VOP (start code included) from its syntax arrays; see
// io/mpeg4.py vlc_encode_ref. stuffing: nmb flags (a stuffing code before
// the MB) or null. Returns 0 or an error code; *written the bytes.
int mft_mpeg4_vlc_encode(const int* vol, const int* enc, const int* enc_off, const int* maxima,
                         const int* header, const int8_t* mode, const int8_t* qp,
                         const int8_t* acpred, const int16_t* mv, const int16_t* levels,
                         const int8_t* stuffing, uint8_t* out, long cap, long* written) {
  EncTables t{enc, enc_off};
  Tables dt{nullptr, nullptr, maxima};
  Writer w{out, cap, 0, 0, 0, false};
  int width = vol[0], height = vol[1], time_bits = vol[2];
  int mbw = (width + 15) / 16, mbh = (height + 15) / 16, nmb = mbw * mbh;
  int kind = header[0], coded = header[1], quant = header[3], fcode = header[4];
  w.put(32, 0x1B6);
  w.put(2, kind);
  for (int i = 0; i < header[6]; ++i) w.put(1, 1);
  w.put(1, 0);
  w.put(1, 1);
  w.put(time_bits, header[7]);
  w.put(1, 1);
  w.put(1, coded);
  *written = 0;
  if (coded) {
    if (kind == 1) w.put(1, header[2]);
    w.put(3, header[5]);
    w.put(5, quant);
    if (kind == 1) w.put(3, fcode);
    int thr = kDCThreshold[header[5]];
    Pred st(mbw, mbh);
    if (!st.ok()) return E_OVERFLOW;
    int qscale = quant;
    int lim = 32 << (fcode - 1);
    for (int mb = 0; mb < nmb; ++mb) {
      int mby = mb / mbw, mbx = mb % mbw;
      int md = mode[mb], q = qp[mb];
      const int16_t* lv = levels + (long)mb * 6 * 64;
      if (kind == 0 && md != INTRA) return E_SYNTAX;
      if (stuffing && stuffing[mb]) {
        if (kind == 1) w.put(1, 0);
        w.code(t.get(kind == 0 ? T_MCBPC_I : T_MCBPC_P, STUFFING));
      }
      if (md == NOT_CODED) {
        if (q != qscale) return E_SYNTAX;
        w.put(1, 1);
        st.mbqp[mb] = qscale;
        continue;
      }
      int dq = q - qscale;
      if (dq < -2 || dq > 2) return E_SYNTAX;
      if (md == INTER4V && dq) return E_SYNTAX;
      if (kind == 1) w.put(1, 0);
      bool use_dc_vlc = qscale < thr;
      qscale = q;
      st.mbqp[mb] = qscale;
      int dq_code = dq == -1 ? 0 : dq == -2 ? 1 : dq == 1 ? 2 : 3;
      if (md == INTRA) {
        int blocks[6][64], dirs[6], preds[6][7];
        for (int n = 0; n < 6; ++n) {
          int16_t b16[64];
          for (int k = 0; k < 64; ++k) {
            blocks[n][k] = lv[n * 64 + k];
            b16[k] = lv[n * 64 + k];
          }
          int dir, scale;
          int pred = st.dc_pred(n, mbx, mby, qscale, dir, scale);
          st.store_dc(n, mbx, mby, blocks[n][0], scale);
          dirs[n] = dir;
          st.ac_pred(n, mbx, mby, dir, qscale, preds[n]);
          st.store_ac(n, mbx, mby, b16);
          blocks[n][0] -= pred;
        }
        int acp = acpred[mb];
        if (acp < 0) {   // decide_ac_pred: sum |level - pred| < sum |level|
          long score = 0;
          for (int n = 0; n < 6; ++n)
            for (int k = 1; k < 8; ++k) {
              int idx = dirs[n] == 0 ? k * 8 : k;
              int l = blocks[n][idx];
              score += abs(l - preds[n][k - 1]) - abs(l);
            }
          acp = score < 0;
        }
        if (acp)
          for (int n = 0; n < 6; ++n)
            for (int k = 1; k < 8; ++k) blocks[n][dirs[n] == 0 ? k * 8 : k] -= preds[n][k - 1];
        int first = use_dc_vlc ? 1 : 0;
        int cbp = 0;
        for (int n = 0; n < 6; ++n)
          for (int k = first; k < 64; ++k)
            if (blocks[n][k]) { cbp |= 32 >> n; break; }
        int value = (dq ? 16 : 12) + (cbp & 3);
        w.code(t.get(kind == 0 ? T_MCBPC_I : T_MCBPC_P, value));
        w.put(1, acp);
        w.code(t.get(T_CBPY, cbp >> 2));
        if (dq) w.put(2, dq_code);
        for (int n = 0; n < 6; ++n) {
          const int* scan = scan_table(acp ? 1 + dirs[n] : 0);
          if (use_dc_vlc) {
            int diff = blocks[n][0];
            int a = abs(diff), size = 0;
            while (a >> size) ++size;
            if (size > 12) return E_SYNTAX;
            w.code(t.get(n < 4 ? T_DC_LUM : T_DC_CHROM, size));
            if (size) {
              w.put(size, (uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1));
              if (size > 8) w.put(1, 1);
            }
          }
          if (cbp & (32 >> n)) {
            int e = write_block(w, t, dt, blocks[n], first, scan, 1);
            if (e) return e;
          }
        }
        continue;
      }
      const int16_t* mvi = mv + (long)mb * 10;
      for (int k = 0; k < 8; ++k)
        if (mvi[k] < -lim || mvi[k] >= lim) return E_SYNTAX;
      int cbp = 0;
      for (int n = 0; n < 6; ++n)
        for (int k = 0; k < 64; ++k)
          if (lv[n * 64 + k]) { cbp |= 32 >> n; break; }
      int value = (md == INTER4V ? 8 : (dq ? 4 : 0)) + (cbp & 3);
      w.code(t.get(T_MCBPC_P, value));
      w.code(t.get(T_CBPY, (cbp >> 2) ^ 15));
      if (dq) w.put(2, dq_code);
      if (md == INTER4V) {
        for (int b = 0; b < 4; ++b) {
          int px, py;
          st.mv_pred(b, mbx, mby, px, py);
          write_motion(w, t, mvi[2 * b] - px, fcode);
          write_motion(w, t, mvi[2 * b + 1] - py, fcode);
          st.set_mv(2 * mby + (b >> 1), 2 * mbx + (b & 1), mvi[2 * b], mvi[2 * b + 1]);
        }
      } else {
        int px, py;
        st.mv_pred(0, mbx, mby, px, py);
        write_motion(w, t, mvi[0] - px, fcode);
        write_motion(w, t, mvi[1] - py, fcode);
        for (int b = 0; b < 4; ++b)
          st.set_mv(2 * mby + (b >> 1), 2 * mbx + (b & 1), mvi[0], mvi[1]);
      }
      for (int n = 0; n < 6; ++n) {
        if (cbp & (32 >> n)) {
          int block[64];
          for (int k = 0; k < 64; ++k) block[k] = lv[n * 64 + k];
          int e = write_block(w, t, dt, block, 0, kZigzag, 0);
          if (e) return e;
        }
      }
    }
  }
  w.stuff();
  *written = w.n;
  return w.overflow ? E_OVERFLOW : E_OK;
}

}  // extern "C"
