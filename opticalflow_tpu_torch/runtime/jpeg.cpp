// jpeg — the PyTorch port's JPEG decoder (C ABI, loaded with ctypes by
// jpeg.py, built with g++ at first use into opticalflow_tpu_torch/_build/).
//
// The JAX package decodes JPEG images through PIL, imageio or OpenCV, all of
// which run libjpeg-turbo 3.1 at its defaults, and JPEG video (Motion JPEG,
// image sequences) through cv2.VideoCapture, that is FFmpeg's mjpeg decoder
// and swscale; the GPU machine has none of them.  One entropy decoder
// serves two flavours.  The libjpeg flavour decodes libjpeg-turbo's pixels
// bit for bit:
//   * markers SOI, APPn (APP1's EXIF orientation is read), COM, DQT (8- and
//     16-bit tables), DHT, SOF0/SOF1 (8-bit sequential), SOF2 (8-bit
//     progressive, Huffman), DRI and RSTn, SOS, EOI;
//   * sequential scans, interleaved or one component a scan, and the four
//     progressive scan kinds (DC first/refine, AC first/refine with EOB
//     runs) into a coefficient buffer (jdhuff.c, jdphuff.c);
//   * the islow IDCT (jidctint.c), its output clamped as libjpeg-turbo's
//     SIMD IDCT clamps it;
//   * fancy upsampling for h2v1, h1v2 and h2v2 (jdsample.c's triangle
//     filters; h2v1/h2v2 replicate where the chroma is 1-2 samples wide),
//     replication for other integral factors (4:1:1);
//   * jdcolor.c's fixed-point YCbCr -> RGB; grey replicated to RGB.
// The FFmpeg flavour (ojpeg_decode_ff) decodes cv2.VideoCapture's pixels
// bit for bit, as OpenCV 5.0 runs FFmpeg 8:
//   * mjpegdec.c's dequantisation into int16 (the DC predictor starting at
//     1024 = 4 << bits, the level shift), FFmpeg's simple IDCT, no block
//     smoothing; a frame without DHT takes the standard tables (Annex K.3);
//   * the planes at FFmpeg's sizes (yuvj420p, yuvj422p, yuvj444p, yuvj440p,
//     yuvj411p, gray) converted to BGR24 as swscale converts them for
//     OpenCV (ffmpeg_dsp.h's yuv_to_bgr at full range; grey is replicated, as swscale's
//     gray8 -> bgr24 is);
//   * declined besides what the libjpeg flavour declines: RGB (Adobe
//     transform 0, components 'R' 'G' 'B') and other chroma layouts.
// Everything else is declined ("not mine": the caller may hand the file to
// another decoder): arithmetic coding, lossless and hierarchical JPEG,
// samples of more than 8 bits, CMYK/YCCK, height given by DNL, fractional
// sampling, and a progressive file whose scans leave the low coefficients
// unrefined (libjpeg's block smoothing would apply).  Corrupt or truncated
// data is an error naming the marker or the MCU: every read is bounds-
// checked, a Huffman code that cannot occur is an error, images are limited
// to 2^30 pixels (OpenCV's CV_IO_MAX_IMAGE_PIXELS) and 65500 a side.
//
// Exposed functions (return 0 done, 1 declined, 2 corrupt; msg says why):
//   ojpeg_info      : height, width, components, progressive, EXIF orientation
//   ojpeg_decode    : (H, W, 3) uint8 RGB into a caller's buffer (libjpeg)
//   ojpeg_decode_ff : (H, W, 3) uint8 BGR into a caller's buffer (FFmpeg)

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <new>
#include <string>

#include "ffmpeg_dsp.h"

namespace {

struct Declined {
  std::string why;
};
struct Corrupt {
  std::string why;
};

std::string format(const char* fmt, va_list ap) {
  char buf[256];
  vsnprintf(buf, sizeof buf, fmt, ap);
  return buf;
}

[[noreturn]] void fail(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string s = format(fmt, ap);
  va_end(ap);
  throw Corrupt{s};
}

[[noreturn]] void decline(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::string s = format(fmt, ap);
  va_end(ap);
  throw Declined{s};
}

// zigzag -> natural order, with libjpeg's 16 extra entries so that a run
// past the end of a corrupt block lands on coefficient 63
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;
constexpr size_t kNone = ~size_t(0);

struct Huffman {
  bool defined = false;
  int nsym = 0;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer code

  // jpeg_make_d_derived_tbl: canonical codes from the counts per length
  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    uint8_t size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l - 1]; i++) size[p++] = uint8_t(l);
    size[p] = 0;
    uint32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1u << si)) fail("bad Huffman table in DHT");
      c <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - int32_t(code[p]);
        p += counts[l - 1];
        maxcode[l] = int32_t(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memcpy(vals, symbols, n);
    memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < counts[l - 1]; i++, p++) {
        int first = int(code[p]) << (kLookBits - l);
        for (int k = 0; k < (1 << (kLookBits - l)); k++)
          look[first + k] = uint16_t((l << 8) | vals[p]);
      }
    }
    nsym = n;
    defined = true;
  }
};

// ITU T.81 Annex K.3's tables, which FFmpeg's decoder starts every frame
// with (camera Motion JPEG carries no DHT)
constexpr uint8_t kStdDcCounts[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                         {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcCounts[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
                                         {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
constexpr uint8_t kStdAcValues[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// Entropy-coded data, MSB first, FF00 unstuffed.  Reading stops at a
// marker (or the end of the data) and supplies zero bits from there, as
// libjpeg does; consuming one of those zero bits is an error.
struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;       // next byte to read
  uint64_t buf = 0;     // cnt valid bits from the top
  int cnt = 0;
  int pad = 0;          // zero bits appended past the segment's end
  size_t marker = kNone;  // where the segment ended (its marker's FF, or n)

  void start(size_t p) {
    pos = p;
    buf = 0;
    cnt = 0;
    pad = 0;
    marker = kNone;
  }

  void fill() {
    while (cnt <= 56) {
      if (marker != kNone) {
        cnt += 8;
        pad += 8;
        continue;
      }
      if (pos >= n) {
        marker = n;
        continue;
      }
      uint64_t b = d[pos];
      if (b == 0xFF) {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] == 0) {
          pos = q + 1;
        } else {
          marker = pos;
          continue;
        }
      } else {
        pos++;
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }

  void skip(int k) {
    buf <<= k;
    cnt -= k;
    if (cnt < pad)
      fail("entropy-coded data ends early (truncated or corrupt JPEG)");
  }

  int get(int k) {  // 1 <= k <= 16
    if (cnt < k) fill();
    int v = int(buf >> (64 - k));
    skip(k);
    return v;
  }

  int bit() { return get(1); }

  int decode(const Huffman& t) {
    if (cnt < 16) fill();
    int look = t.look[buf >> (64 - kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 255;
    }
    int l = kLookBits + 1;
    int32_t code = int32_t(buf >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = int32_t(buf >> (64 - l));
    }
    if (l > 16) fail("bad Huffman code in the entropy-coded data");
    skip(l);
    int idx = code + t.valoffset[l];
    if (idx < 0 || idx >= t.nsym) fail("bad Huffman code in the entropy-coded data");
    return t.vals[idx];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

inline uint8_t clamp255(int x) { return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x)); }

// jidctint.c's jpeg_idct_islow; dequantization included
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, size_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dc = int32_t(int64_t(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = int32_t(descale(tmp10 + tmp3, s));
    wp[56] = int32_t(descale(tmp10 - tmp3, s));
    wp[8] = int32_t(descale(tmp11 + tmp2, s));
    wp[48] = int32_t(descale(tmp11 - tmp2, s));
    wp[16] = int32_t(descale(tmp12 + tmp1, s));
    wp[40] = int32_t(descale(tmp12 - tmp1, s));
    wp[24] = int32_t(descale(tmp13 + tmp0, s));
    wp[32] = int32_t(descale(tmp13 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = clamp255(int(descale(wp[0], kPass1Bits + 3)) + 128);
      memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp255(int(descale(tmp10 + tmp3, s2)) + 128);
    op[7] = clamp255(int(descale(tmp10 - tmp3, s2)) + 128);
    op[1] = clamp255(int(descale(tmp11 + tmp2, s2)) + 128);
    op[6] = clamp255(int(descale(tmp11 - tmp2, s2)) + 128);
    op[2] = clamp255(int(descale(tmp12 + tmp1, s2)) + 128);
    op[5] = clamp255(int(descale(tmp12 - tmp1, s2)) + 128);
    op[3] = clamp255(int(descale(tmp13 + tmp0, s2)) + 128);
    op[4] = clamp255(int(descale(tmp13 - tmp0, s2)) + 128);
  }
}

// jdcolor.c's tables for YCbCr -> RGB, 16 fraction bits
struct ColorTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  ColorTables() {
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int32_t((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = int32_t((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = int32_t(-fix(0.71414) * x);
      cb_g[i] = int32_t(-fix(0.34414) * x + 32768);
    }
  }
};
const ColorTables kColor;

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // blocks a row/column in whole interleaved MCUs
  int wb = 0, hb = 0;  // blocks that hold samples (a non-interleaved scan's)
  int dw = 0, dh = 0;  // samples a row/column
  int16_t q[64] = {};  // quantization table latched at the first scan
  bool latched = false;
  int dc_pred = 0;
  int coef_bits[64];
  int td = 0, ta = 0;  // this scan's DC and AC tables
  std::unique_ptr<int16_t, void (*)(void*)> coef{nullptr, free};
  std::unique_ptr<uint8_t[]> plane;
  size_t stride = 0;

  int16_t* block(int bx, int by) { return coef.get() + (size_t(by) * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  bool ff;  // the FFmpeg flavour
  int width = 0, height = 0, ncomp = 0;
  bool sof = false, progressive = false, scanned = false, direct = false;
  bool jfif = false, adobe = false, app1 = false;
  int adobe_transform = 0, orientation = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool qdefined[4] = {false, false, false, false};
  uint16_t qt[4][64];
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  Component comp[3];

  Decoder(const uint8_t* data, size_t size, bool ffmpeg = false)
      : d(data), n(size), ff(ffmpeg) {
    if (ff)
      for (int t = 0; t < 2; t++) {
        dc[t].build(kStdDcCounts[t], kStdDcValues, 12);
        ac[t].build(kStdAcCounts[t], kStdAcValues[t], 162);
      }
  }

  // -------------------------------------------------------------- markers

  size_t segment(size_t p, const char* what) {  // p: at the length field
    if (p + 2 > n) fail("truncated JPEG in %s", what);
    size_t len = size_t(d[p]) << 8 | d[p + 1];
    if (len < 2 || p + len > n) fail("truncated JPEG in %s", what);
    return len;
  }

  int next_marker(size_t& p) {  // libjpeg's next_marker: garbage skipped
    for (;;) {
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) return -1;
      int m = d[p++];
      if (m != 0) return m;
    }
  }

  void read_app(int m, size_t p, size_t len) {
    const uint8_t* s = d + p + 2;
    size_t k = len - 2;
    if (m == 0xE0 && k >= 14 && !memcmp(s, "JFIF", 5)) jfif = true;
    if (m == 0xEE && k >= 12 && !memcmp(s, "Adobe", 5)) {
      adobe = true;
      adobe_transform = s[11];
    }
    if (m == 0xE1 && !app1) {  // OpenCV reads the first APP1 only
      app1 = true;
      if (k > 6) orientation = exif_orientation(s + 6, k - 6);
    }
  }

  // OpenCV's ExifReader: TIFF header, IFD0's first orientation tag
  static int exif_orientation(const uint8_t* t, size_t len) {
    if (len < 2 || t[0] != t[1] || (t[0] != 'I' && t[0] != 'M')) return 0;
    bool le = t[0] == 'I';
    auto u16 = [&](size_t o, uint32_t* v) {
      if (o + 1 >= len) return false;
      *v = le ? uint32_t(t[o]) | uint32_t(t[o + 1]) << 8 : uint32_t(t[o]) << 8 | t[o + 1];
      return true;
    };
    uint32_t mark, lo, hi, count, tag, val;
    if (!u16(2, &mark) || mark != 0x2A) return 0;
    if (!u16(4, &lo) || !u16(6, &hi)) return 0;
    uint64_t off = le ? (uint64_t(hi) << 16 | lo) : (uint64_t(lo) << 16 | hi);
    if (off >= len || !u16(size_t(off), &count)) return 0;
    off += 2;
    for (uint32_t e = 0; e < count && off < len; e++, off += 12) {
      if (!u16(size_t(off), &tag)) return 0;
      if (tag == 0x0112) return u16(size_t(off) + 8, &val) ? int(val) : 0;
    }
    return 0;
  }

  void read_dqt(size_t p, size_t len) {
    size_t end = p + len;
    p += 2;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (pq > 1 || tq > 3) fail("bad DQT (precision %d, table %d)", pq, tq);
      size_t need = 1 + 64 * size_t(pq + 1);
      if (p + need > end) fail("truncated DQT");
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = pq ? uint16_t(d[p + 1 + 2 * k] << 8 | d[p + 2 + 2 * k])
                                 : d[p + 1 + k];
      qdefined[tq] = true;
      p += need;
    }
  }

  void read_dht(size_t p, size_t len) {
    size_t end = p + len;
    p += 2;
    while (p < end) {
      if (p + 17 > end) fail("truncated DHT");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("bad DHT (class %d, table %d)", tc, th);
      int total = 0;
      for (int i = 0; i < 16; i++) total += d[p + 1 + i];
      if (total > 256 || p + 17 + total > end) fail("bad DHT (%d codes)", total);
      (tc ? ac : dc)[th].build(d + p + 1, d + p + 17, total);
      p += 17 + total;
    }
  }

  void read_sof(int m, size_t p, size_t len) {
    if (sof) fail("two SOF markers");
    if (len < 8) fail("truncated SOF%d", m - 0xC0);
    int precision = d[p + 2];
    height = d[p + 3] << 8 | d[p + 4];
    width = d[p + 5] << 8 | d[p + 6];
    ncomp = d[p + 7];
    if (len != 8 + 3 * size_t(ncomp)) fail("bad SOF%d length", m - 0xC0);
    if (precision != 8) decline("%d-bit JPEG (the decoder reads 8-bit samples)", precision);
    if (height == 0) decline("JPEG whose height is given by a DNL marker");
    if (width == 0) fail("JPEG of width 0");
    if (width > 65500 || height > 65500 || uint64_t(width) * height > (uint64_t(1) << 30))
      fail("JPEG of %dx%d exceeds the limit of 2^30 pixels, 65500 a side", width, height);
    if (ncomp != 1 && ncomp != 3)
      decline("%d-component JPEG (CMYK, YCCK or other; the decoder reads grey and "
              "3-component)", ncomp);
    progressive = m == 0xC2;
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      const uint8_t* s = d + p + 8 + 3 * c;
      k.id = s[0];
      k.h = s[1] >> 4;
      k.v = s[1] & 15;
      k.tq = s[2];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) fail("bad sampling factors in SOF");
      if (k.tq > 3) fail("bad quantization table number in SOF");
      for (int o = 0; o < c; o++)
        if (comp[o].id == k.id) decline("JPEG with duplicate component ids");
      hmax = k.h > hmax ? k.h : hmax;
      vmax = k.v > vmax ? k.v : vmax;
      for (int i = 0; i < 64; i++) k.coef_bits[i] = -1;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      if (hmax % k.h || vmax % k.v) decline("JPEG with fractional sampling factors");
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = int((int64_t(width) * k.h + hmax - 1) / hmax);
      k.dh = int((int64_t(height) * k.v + vmax - 1) / vmax);
      k.wb = (k.dw + 7) / 8;
      k.hb = (k.dh + 7) / 8;
    }
    sof = true;
  }

  // --------------------------------------------------------------- scans

  struct Scan {
    int ns = 0;
    Component* c[4];
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  Scan read_sos(size_t p, size_t len) {
    if (!sof) fail("SOS before SOF");
    Scan sc;
    if (len < 3) fail("truncated SOS");
    sc.ns = d[p + 2];
    if (sc.ns < 1 || sc.ns > ncomp || len != 6 + 2 * size_t(sc.ns)) fail("bad SOS header");
    for (int i = 0; i < sc.ns; i++) {
      int id = d[p + 3 + 2 * i], t = d[p + 4 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) k = &comp[c];
      if (!k) fail("SOS names component %d, which SOF does not", id);
      for (int o = 0; o < i; o++)
        if (sc.c[o] == k) fail("SOS names component %d twice", id);
      k->td = t >> 4;
      k->ta = t & 15;
      if (k->td > 3 || k->ta > 3) fail("bad Huffman table number in SOS");
      sc.c[i] = k;
    }
    const uint8_t* s = d + p + 3 + 2 * sc.ns;
    sc.ss = s[0];
    sc.se = s[1];
    sc.ah = s[2] >> 4;
    sc.al = s[2] & 15;
    int blocks = 0;
    for (int i = 0; i < sc.ns; i++) blocks += sc.ns > 1 ? sc.c[i]->h * sc.c[i]->v : 1;
    if (blocks > 10) fail("SOS: %d blocks an MCU (at most 10)", blocks);
    if (progressive) {
      bool dcband = sc.ss == 0;
      bool bad = dcband ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
      if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
      if (sc.al > 13) bad = true;
      if (bad)
        fail("bad progressive scan (Ss=%d, Se=%d, Ah=%d, Al=%d)", sc.ss, sc.se, sc.ah, sc.al);
      for (int i = 0; i < sc.ns; i++) {
        Component* k = sc.c[i];
        if (dcband && sc.ah == 0 && !dc[k->td].defined) fail("SOS uses an undefined DC table");
        if (!dcband && !ac[k->ta].defined) fail("SOS uses an undefined AC table");
        for (int j = sc.ss; j <= sc.se; j++) k->coef_bits[j] = sc.al;
      }
    } else {
      for (int i = 0; i < sc.ns; i++)
        if (!dc[sc.c[i]->td].defined || !ac[sc.c[i]->ta].defined)
          fail("SOS uses an undefined Huffman table");
    }
    for (int i = 0; i < sc.ns; i++) {  // latch_quant_tables
      Component* k = sc.c[i];
      if (k->latched) continue;
      if (!qdefined[k->tq]) fail("quantization table %d is not defined", k->tq);
      for (int j = 0; j < 64; j++) k->q[j] = int16_t(qt[k->tq][j]);
      k->latched = true;
    }
    return sc;
  }

  void allocate(bool buffered) {
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.stride = size_t(k.bw) * 8;
      k.plane.reset(new uint8_t[k.stride * size_t(k.bh) * 8]);
      if (buffered) {
        k.coef.reset(static_cast<int16_t*>(calloc(size_t(k.bw) * k.bh * 64, sizeof(int16_t))));
        if (!k.coef) throw std::bad_alloc();
      }
    }
  }

  void restart(Bits& br, int& next, long mcu) {
    size_t q = br.marker != kNone ? br.marker : br.pos;
    if (q >= n || d[q] != 0xFF) fail("RST%d marker missing before MCU %ld", next, mcu);
    while (q < n && d[q] == 0xFF) q++;
    if (q >= n || d[q] != 0xD0 + next) fail("RST%d marker missing before MCU %ld", next, mcu);
    br.start(q + 1);
    next = (next + 1) & 7;
  }

  void seq_block(Bits& br, Component& k, int16_t* blk) {
    int s = br.decode(dc[k.td]);
    if (s > 15) fail("bad DC Huffman table");
    int diff = s ? extend(br.get(s), s) : 0;
    k.dc_pred = int(uint32_t(k.dc_pred) + uint32_t(diff));
    blk[0] = int16_t(k.dc_pred);
    const Huffman& t = ac[k.ta];
    for (int i = 1; i < 64; i++) {
      int rs = br.decode(t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void dc_first(Bits& br, Component& k, int16_t* blk, int al) {
    int s = br.decode(dc[k.td]);
    if (s > 15) fail("bad DC Huffman table");
    int diff = s ? extend(br.get(s), s) : 0;
    k.dc_pred = int(uint32_t(k.dc_pred) + uint32_t(diff));
    blk[0] = int16_t(uint32_t(k.dc_pred) << al);
  }

  void ac_first(Bits& br, Component& k, int16_t* blk, const Scan& sc, int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman& t = ac[k.ta];
    for (int i = sc.ss; i <= sc.se; i++) {
      int rs = br.decode(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = int16_t(uint32_t(extend(br.get(s), s)) << sc.al);
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  static void refine(Bits& br, int16_t* c, int p1, int m1) {
    if (br.bit() && (*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
  }

  void ac_refine(Bits& br, Component& k, int16_t* blk, const Scan& sc, int& eobrun) {
    int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    int i = sc.ss;
    if (eobrun == 0) {
      const Huffman& t = ac[k.ta];
      for (; i <= sc.se; i++) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            refine(br, c, p1, m1);
          } else if (--r < 0) {
            break;
          }
          i++;
        } while (i <= sc.se);
        if (s) blk[kNatural[i]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; i <= sc.se; i++) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0) refine(br, c, p1, m1);
      }
      eobrun--;
    }
  }

  void idct_block(Component& k, const int16_t* blk, int bx, int by) {
    uint8_t* out = k.plane.get() + size_t(by) * 8 * k.stride + size_t(bx) * 8;
    if (!ff) {
      idct_islow(blk, k.q, out, k.stride);
      return;
    }
    // mjpegdec.c: level * quant into int16, the DC on top of 4 << 8
    int16_t deq[64];
    for (int j = 1; j < 64; j++) deq[j] = int16_t(int32_t(blk[j]) * uint16_t(k.q[j]));
    int32_t dc = 1024 + int32_t(blk[0]) * uint16_t(k.q[0]);
    deq[0] = int16_t(dc < -32768 ? -32768 : dc > 32767 ? 32767 : dc);
    ffdsp::idct(deq, out, int(k.stride), false);
  }

  // decodes the scan's entropy-coded data from p; returns where it ended
  size_t decode_scan(const Scan& sc, size_t p) {
    Bits br;
    br.d = d;
    br.n = n;
    br.start(p);
    for (int i = 0; i < sc.ns; i++) sc.c[i]->dc_pred = 0;
    int eobrun = 0, next_rst = 0;
    Component& k0 = *sc.c[0];
    long total = sc.ns == 1 ? long(k0.wb) * k0.hb : long(mcux) * mcuy;
    alignas(16) int16_t scratch[64];
    for (long m = 0; m < total; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        restart(br, next_rst, m);
        for (int i = 0; i < sc.ns; i++) sc.c[i]->dc_pred = 0;
        eobrun = 0;
      }
      if (sc.ns == 1) {
        unit(br, sc, k0, int(m % k0.wb), int(m / k0.wb), eobrun, scratch);
        continue;
      }
      int mx = int(m % mcux), my = int(m / mcux);
      for (int i = 0; i < sc.ns; i++) {
        Component& k = *sc.c[i];
        for (int v = 0; v < k.v; v++)
          for (int h = 0; h < k.h; h++)
            unit(br, sc, k, mx * k.h + h, my * k.v + v, eobrun, scratch);
      }
    }
    return br.marker != kNone ? br.marker : br.pos;
  }

  void unit(Bits& br, const Scan& sc, Component& k, int bx, int by, int& eobrun,
            int16_t* scratch) {
    if (direct) {
      memset(scratch, 0, 64 * sizeof(int16_t));
      seq_block(br, k, scratch);
      idct_block(k, scratch, bx, by);
      return;
    }
    int16_t* blk = k.block(bx, by);
    if (!progressive) {
      seq_block(br, k, blk);
    } else if (sc.ss == 0) {
      if (sc.ah == 0)
        dc_first(br, k, blk, sc.al);
      else if (br.bit())
        blk[0] = int16_t(blk[0] | (1 << sc.al));
    } else if (sc.ah == 0) {
      ac_first(br, k, blk, sc, eobrun);
    } else {
      ac_refine(br, k, blk, sc, eobrun);
    }
  }

  // ------------------------------------------------------------ parsing

  // Parses (and with decode, decodes) the stream.  header_only stops at the
  // first SOS.  Returns when every scan has been read.
  void run(bool header_only) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) decline("not a JPEG");
    size_t p = 2;
    for (;;) {
      int m = next_marker(p);
      if (m < 0) {
        if (header_only || !scanned) fail("truncated JPEG: no scan");
        fail("truncated JPEG: no EOI after the last scan");
      }
      if (m == 0xD9) {
        if (!scanned) fail("EOI before any scan");
        return;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // stray RSTn, TEM
      if (m == 0xD8) fail("second SOI marker");
      if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
        decline("lossless JPEG (SOF%d)", m - 0xC0);
      if (m == 0xC5 || m == 0xC6 || m == 0xCD || m == 0xCE)
        decline("hierarchical JPEG (SOF%d)", m - 0xC0);
      if (m == 0xC9 || m == 0xCA || m == 0xCC)
        decline("arithmetic-coded JPEG (%s)", m == 0xCC ? "DAC" : m == 0xC9 ? "SOF9" : "SOF10");
      size_t len = segment(p, "a marker segment");
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m, p, len);
          break;
        case 0xC4:
          read_dht(p, len);
          break;
        case 0xDB:
          read_dqt(p, len);
          break;
        case 0xDD:
          if (len != 4) fail("bad DRI length");
          restart_interval = d[p + 2] << 8 | d[p + 3];
          break;
        case 0xDA: {
          if (header_only) {
            if (!sof) fail("SOS before SOF");
            return;
          }
          Scan sc = read_sos(p, len);
          if (!scanned) {
            direct = !progressive && sc.ns == ncomp;
            allocate(!direct);
          }
          scanned = true;
          p = decode_scan(sc, p + len);
          if (direct) return;  // that scan carried every block
          continue;
        }
        default:
          if (m >= 0xE0 && m <= 0xEF)
            read_app(m, p, len);
          else if (m != 0xFE && m != 0xDC)  // COM; DNL is ignored, as libjpeg does
            fail("unknown JPEG marker 0x%02X", m);
      }
      p += len;
    }
  }

  // libjpeg-turbo's smoothing_ok: would block smoothing apply?
  bool needs_smoothing() const {
    if (!progressive) return false;
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp; c++) {
      const Component& k = comp[c];
      if (!k.latched) return false;
      for (int i : pos)
        if (k.q[i] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; i++)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  // --------------------------------------------------------------- output

  // one row (y) of component k at full resolution; returns a pointer to W
  // samples (into the plane itself where there is no upsampling)
  const uint8_t* upsampled_row(const Component& k, int y, uint8_t* tmp) const {
    int hf = hmax / k.h, vf = vmax / k.v;
    const uint8_t* base = k.plane.get();
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= k.dh ? k.dh - 1 : r);
      return base + size_t(r) * k.stride;
    };
    int dw = k.dw;
    if (hf == 1 && vf == 1) return row(y);
    if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      tmp[0] = in[0];
      tmp[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; c++) {
        int v = in[c] * 3;
        tmp[2 * c] = uint8_t((v + in[c - 1] + 1) >> 2);
        tmp[2 * c + 1] = uint8_t((v + in[c + 1] + 2) >> 2);
      }
      tmp[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      tmp[2 * dw - 1] = in[dw - 1];
      return tmp;
    }
    if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      int cy = y >> 1, below = y & 1;
      const uint8_t* in0 = row(cy);
      const uint8_t* in1 = row(below ? cy + 1 : cy - 1);
      int bias = below ? 2 : 1;
      for (int c = 0; c < dw; c++) tmp[c] = uint8_t((in0[c] * 3 + in1[c] + bias) >> 2);
      return tmp;
    }
    if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
      int cy = y >> 1, below = y & 1;
      const uint8_t* in0 = row(cy);
      const uint8_t* in1 = row(below ? cy + 1 : cy - 1);
      int last = in0[0] * 3 + in1[0];
      int cur = in0[1] * 3 + in1[1];
      tmp[0] = uint8_t((last * 4 + 8) >> 4);
      tmp[1] = uint8_t((last * 3 + cur + 7) >> 4);
      for (int c = 1; c < dw - 1; c++) {
        int next = in0[c + 1] * 3 + in1[c + 1];
        tmp[2 * c] = uint8_t((cur * 3 + last + 8) >> 4);
        tmp[2 * c + 1] = uint8_t((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
      tmp[2 * dw - 2] = uint8_t((cur * 3 + last + 8) >> 4);
      tmp[2 * dw - 1] = uint8_t((cur * 4 + 7) >> 4);
      return tmp;
    }
    const uint8_t* in = row(y / vf);  // int_upsample (and h2v1/h2v2 when narrow)
    for (int x = 0; x < width; x++) tmp[x] = in[x / hf];
    return tmp;
  }

  void emit(uint8_t* out) {
    if (!direct) {
      for (int c = 0; c < ncomp; c++) {
        Component& k = comp[c];
        for (int by = 0; by < k.hb; by++)
          for (int bx = 0; bx < k.wb; bx++) idct_block(k, k.block(bx, by), bx, by);
      }
    }
    size_t tmp_len = size_t(width) + 2 * 8 * 4 + 16;
    std::unique_ptr<uint8_t[]> tmp(new uint8_t[3 * tmp_len]);
    bool rgb = ncomp == 3 && !jfif &&
               (adobe ? adobe_transform == 0
                      : comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
    for (int y = 0; y < height; y++) {
      uint8_t* o = out + size_t(y) * width * 3;
      if (ncomp == 1) {
        const uint8_t* g = upsampled_row(comp[0], y, tmp.get());
        for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
        continue;
      }
      const uint8_t* c0 = upsampled_row(comp[0], y, tmp.get());
      const uint8_t* c1 = upsampled_row(comp[1], y, tmp.get() + tmp_len);
      const uint8_t* c2 = upsampled_row(comp[2], y, tmp.get() + 2 * tmp_len);
      if (rgb) {
        for (int x = 0; x < width; x++) {
          o[3 * x] = c0[x];
          o[3 * x + 1] = c1[x];
          o[3 * x + 2] = c2[x];
        }
        continue;
      }
      for (int x = 0; x < width; x++) {  // ycc_rgb_convert
        int yy = c0[x], cb = c1[x], cr = c2[x];
        o[3 * x] = clamp255(yy + kColor.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + ((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + kColor.cb_b[cb]);
      }
    }
  }
};

// the FFmpeg flavour's output: the planes as swscale converts them to BGR24
void emit_ff(Decoder& dec, uint8_t* bgr) {
  const Component* c = dec.comp;
  if (dec.ncomp == 3) {
    if ((dec.adobe && dec.adobe_transform == 0) ||
        (c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B'))
      decline("RGB JPEG (FFmpeg decodes it to planar GBR)");
    int hf = dec.hmax / c[1].h, vf = dec.vmax / c[1].v;
    bool layout = c[0].h == dec.hmax && c[0].v == dec.vmax && c[1].h == c[2].h &&
                  c[1].v == c[2].v &&
                  ((hf <= 2 && vf <= 2) || (hf == 4 && vf == 1));
    if (!layout)
      decline("JPEG chroma layout Y %dx%d, Cb %dx%d, Cr %dx%d (the FFmpeg flavour reads "
              "4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1)",
              c[0].h, c[0].v, c[1].h, c[1].v, c[2].h, c[2].v);
  }
  if (!dec.direct)
    for (int i = 0; i < dec.ncomp; i++) {
      Component& k = dec.comp[i];
      for (int by = 0; by < k.hb; by++)
        for (int bx = 0; bx < k.wb; bx++) dec.idct_block(k, k.block(bx, by), bx, by);
    }
  const int w = dec.width, h = dec.height;
  if (dec.ncomp == 1) {  // gray8 -> bgr24 replicates the sample
    for (int y = 0; y < h; y++) {
      const uint8_t* g = c[0].plane.get() + size_t(y) * c[0].stride;
      uint8_t* o = bgr + size_t(y) * w * 3;
      for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
    }
    return;
  }
  int hshift = dec.hmax / c[1].h == 4 ? 2 : dec.hmax / c[1].h - 1;
  int vshift = dec.vmax / c[1].v - 1;
  ffdsp::yuv_to_bgr(c[0].plane.get(), int(c[0].stride), c[1].plane.get(), c[2].plane.get(),
                    int(c[1].stride), w, h, hshift, vshift, ffdsp::kFullRange, bgr);
}

int finish(const std::string& why, char* msg, int64_t msg_len, int code) {
  if (msg && msg_len > 0) snprintf(msg, size_t(msg_len), "%s", why.c_str());
  return code;
}

template <class F>
int guarded(char* msg, int64_t msg_len, F&& body) {
  try {
    body();
    return finish("", msg, msg_len, 0);
  } catch (const Declined& e) {
    return finish(e.why, msg, msg_len, 1);
  } catch (const Corrupt& e) {
    return finish(e.why, msg, msg_len, 2);
  } catch (const std::bad_alloc&) {
    return finish("out of memory decoding the JPEG", msg, msg_len, 2);
  } catch (const std::exception& e) {
    return finish(e.what(), msg, msg_len, 2);
  }
}

}  // namespace

extern "C" {

// info: height, width, components, progressive, EXIF orientation (0: none)
int ojpeg_info(const uint8_t* data, int64_t n, int64_t* info, char* msg, int64_t msg_len) {
  return guarded(msg, msg_len, [&] {
    Decoder dec(data, size_t(n));
    dec.run(true);
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = dec.ncomp;
    info[3] = dec.progressive;
    info[4] = dec.orientation;
  });
}

// out: height x width x 3 uint8 RGB, C order
int ojpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t height, int64_t width,
                 char* msg, int64_t msg_len) {
  return guarded(msg, msg_len, [&] {
    Decoder dec(data, size_t(n));
    dec.run(false);
    if (dec.height != height || dec.width != width)
      fail("JPEG is %dx%d, not the %ldx%ld asked for", dec.height, dec.width, long(height),
           long(width));
    if (dec.needs_smoothing())
      decline("progressive JPEG whose scans leave low coefficients unrefined (libjpeg "
              "would smooth its blocks)");
    dec.emit(out);
  });
}

// out: height x width x 3 uint8 BGR, C order: cv2.VideoCapture's frame
int ojpeg_decode_ff(const uint8_t* data, int64_t n, uint8_t* out, int64_t height,
                    int64_t width, char* msg, int64_t msg_len) {
  return guarded(msg, msg_len, [&] {
    Decoder dec(data, size_t(n), true);
    dec.run(false);
    if (dec.height != height || dec.width != width)
      fail("JPEG is %dx%d, not the %ldx%ld asked for", dec.height, dec.width, long(height),
           long(width));
    emit_ff(dec, out);
  });
}

}  // extern "C"
