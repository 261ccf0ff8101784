// The parts of an MPEG video decoder that MPEG-1/2 (mpeg12.cpp), MPEG-4
// Part 2 (mpeg4.cpp) and H.263 (h263.cpp) share, as FFmpeg 8's decoders run
// them: errors as C++ exceptions with a message, VLC tables over a bit
// reader, the scans, macroblock-aligned planes and half-pel block
// prediction; and what MPEG-4 Part 2 took from H.263: the MCBPC, CBPY, MVD
// and inter TCOEF codes, motion-vector prediction (ff_h263_pred_motion) and
// decoding, and 16x16 and 8x8 half-pel motion compensation with H.263's
// chroma vector.
//
// Header only; each including source is one shared library.

#pragma once

#include <algorithm>
#include <climits>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace mpegc {

// a decoder call's result codes, as both libraries return them
enum { kOk = 0, kNoFrame = 1, kUnsupported = 2, kCorrupt = 3 };

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] inline void fail(int kind, const char* fmt, ...) {
    char buf[400];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof buf, fmt, ap);
    va_end(ap);
    throw Failure{kind, buf};
}

#define CORRUPT(...) ::mpegc::fail(::mpegc::kCorrupt, __VA_ARGS__)
#define UNSUPPORTED(...) ::mpegc::fail(::mpegc::kUnsupported, __VA_ARGS__)

inline void put_msg(char* msg, int64_t cap, const std::string& s) {
    if (!msg || cap <= 0) return;
    size_t n = std::min<size_t>(s.size(), (size_t)cap - 1);
    memcpy(msg, s.data(), n);
    msg[n] = 0;
}

struct Code {
    uint16_t code;
    uint8_t bits;
};

// the scans: zigzag, the alternate vertical scan (MPEG-2's alternate_scan,
// MPEG-4's AC prediction from the left, H.263's Annex I from the left) and
// the alternate horizontal scan (prediction from above)
inline const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
inline const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
inline const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};

// A VLC as a table over the next ``bits`` bits of the stream.
struct Vlc {
    int bits = 0;
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;
    void build(const Code* codes, int n, int maxbits) {
        bits = maxbits;
        sym.assign(1u << maxbits, -1);
        len.assign(1u << maxbits, 0);
        for (int i = 0; i < n; i++) {
            int l = codes[i].bits;
            if (!l) continue;
            uint32_t lo = (uint32_t)codes[i].code << (maxbits - l);
            uint32_t hi = lo + (1u << (maxbits - l));
            for (uint32_t j = lo; j < hi; j++) {
                if (sym[j] >= 0) {
                    fprintf(stderr, "VLC table conflict\n");
                    abort();
                }
                sym[j] = (int16_t)i;
                len[j] = (uint8_t)l;
            }
        }
    }
};


// ------------------------------------------------------------- bit input

struct BitReader {
    std::vector<uint8_t> buf;   // the data and 8 zero bytes
    int64_t size = 0, pos = 0;  // in bits
    // past the end, read zeros instead of failing (FFmpeg's padded reader
    // on a packet cut short; its decoder fails only on what it decodes)
    bool zeros_past_end = false;
    void reset(const uint8_t* d, int64_t n) {
        buf.assign(d, d + n);
        buf.resize(n + 8, 0);
        size = n * 8;
        pos = 0;
        zeros_past_end = false;
    }
    uint32_t peek32() const {
        if (pos >= size) return 0;
        const uint8_t* p = buf.data() + (pos >> 3);
        uint64_t v = 0;
        for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
        return (uint32_t)((v << (pos & 7)) >> 32);
    }
    uint32_t show(int n) const { return n ? peek32() >> (32 - n) : 0; }
    void skip(int n) { pos += n; }
    uint32_t get(int n) {
        uint32_t v = show(n);
        pos += n;
        return v;
    }
    int get1() { return (int)get(1); }
    int64_t left() const { return size - pos; }
    void check() const {
        if (pos > size && !zeros_past_end) CORRUPT("bitstream overread (truncated picture)");
    }
    int vlc(const Vlc& v) {
        int i = (int)show(v.bits);
        int s = v.sym[i];
        if (s < 0 || (pos >= size && !zeros_past_end)) CORRUPT("invalid VLC at bit %lld", (long long)pos);
        pos += v.len[i];
        return s;
    }
    // get_vlc2 unchecked, as FFmpeg reads some codes: -1 for an invalid
    // code, which consumes no bits
    int vlc_or_invalid(const Vlc& v) {
        if (pos >= size && !zeros_past_end) CORRUPT("invalid VLC at bit %lld", (long long)pos);
        int i = (int)show(v.bits);
        int s = v.sym[i];
        if (s >= 0) pos += v.len[i];
        return s;
    }
    void align() { pos = (pos + 7) & ~(int64_t)7; }
    void marker(const char* what) {
        if (!get1()) CORRUPT("missing marker bit %s", what);
    }
};


// --------------------------------------------------------------- planes

struct Plane {
    int w = 0, h = 0;   // allocated (macroblock-aligned) size
    std::vector<uint8_t> d;
    void alloc(int w_, int h_) {
        w = w_;
        h = h_;
        d.assign((size_t)w * h, 0);
    }
    uint8_t* at(int x, int y) { return d.data() + (size_t)y * w + x; }
    const uint8_t* at(int x, int y) const { return d.data() + (size_t)y * w + x; }
};

struct Picture {
    Plane p[3];
    void alloc(int mbw, int mbh) {
        p[0].alloc(mbw * 16, mbh * 16);
        p[1].alloc(mbw * 8, mbh * 8);
        p[2].alloc(mbw * 8, mbh * 8);
    }
};

// Half-pel prediction of a bw x bh block whose integer source position is
// (sx, sy), read with coordinates clamped to [0, ew) x [0, eh) (FFmpeg's
// emulated edge); dxy bit 0 = horizontal half, bit 1 = vertical half.
// ``no_rnd`` is vop_rounding_type.  With it, FFmpeg's x86 build averages
// 8-wide blocks' x2/y2 half-pels with its mmxext approximations,
// pavgb(max(a - 1, 0), b), where the decremented operand is the left pixel
// or the odd row of the block (they differ from (a + b) >> 1 where that
// pixel is 0); its 16-wide ones are exact.
inline void mc_block(const Plane& ref, int ew, int eh, int sx, int sy, int dxy,
              int bw, int bh, bool no_rnd, uint8_t* dst, int dstride) {
    const bool approx = bw == 8;
    uint8_t src[17 * 17];
    const int sw = bw + 1;
    if (sx >= 0 && sy >= 0 && sx + bw < ew && sy + bh < eh) {
        for (int y = 0; y <= bh; y++)
            memcpy(src + y * sw, ref.at(sx, sy + y), sw);
    } else {
        for (int y = 0; y <= bh; y++) {
            int yy = std::min(std::max(sy + y, 0), eh - 1);
            const uint8_t* row = ref.at(0, yy);
            for (int x = 0; x <= bw; x++)
                src[y * sw + x] = row[std::min(std::max(sx + x, 0), ew - 1)];
        }
    }
    for (int y = 0; y < bh; y++) {
        const uint8_t* s0 = src + y * sw;
        const uint8_t* s1 = s0 + sw;
        uint8_t* d = dst + y * dstride;
        switch (dxy) {
            case 0:
                memcpy(d, s0, bw);
                break;
            case 1:
                for (int x = 0; x < bw; x++) {
                    int a = s0[x], b = s0[x + 1];
                    if (!no_rnd) d[x] = (uint8_t)((a + b + 1) >> 1);
                    else if (approx) d[x] = (uint8_t)((std::max(a - 1, 0) + b + 1) >> 1);
                    else d[x] = (uint8_t)((a + b) >> 1);
                }
                break;
            case 2:
                for (int x = 0; x < bw; x++) {
                    int a = s0[x], b = s1[x];
                    if (!no_rnd) d[x] = (uint8_t)((a + b + 1) >> 1);
                    else if (approx) {
                        if (y & 1) a = std::max(a - 1, 0);
                        else b = std::max(b - 1, 0);
                        d[x] = (uint8_t)((a + b + 1) >> 1);
                    } else d[x] = (uint8_t)((a + b) >> 1);
                }
                break;
            default:
                for (int x = 0; x < bw; x++) {
                    int s = s0[x] + s0[x + 1] + s1[x] + s1[x + 1];
                    d[x] = (uint8_t)((s + (no_rnd ? 1 : 2)) >> 2);
                }
        }
    }
}

// ------------------------------------------- H.263's macroblock layer

// MCBPC of I-VOPs: index = cbpc | 4 * (intra+q); 8 = stuffing
inline const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                             {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of P-VOPs: index = cbpc | 4 * type, type 0 inter, 1 intra,
// 2 inter+q, 3 intra+q, 4 inter4v, 6 inter4v+q; 20 = stuffing, 21-23
// unused (FFmpeg's order and its 28 codes: the inter4v+q ones come from
// H.263's Annex F with DQUANT, which FFmpeg's VLC reads for both codecs)
inline const Code kInterMcbpc[28] = {
    {1, 1},   {3, 4},   {2, 4},   {5, 6},   {3, 5},   {4, 8},   {3, 8},
    {3, 7},   {3, 3},   {7, 7},   {6, 7},   {5, 9},   {4, 6},   {4, 9},
    {3, 9},   {2, 9},   {2, 3},   {5, 7},   {4, 7},   {5, 8},   {1, 9},
    {0, 0},   {0, 0},   {0, 0},   {2, 11},  {12, 13}, {14, 13}, {15, 13}};
inline const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                        {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                        {4, 4}, {8, 4}, {6, 4}, {3, 2}};
inline const Code kMvd[33] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
    {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
    {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
    {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};

// TCOEF: 102 (last, run, level) codes in (last, run, level) order, then
// the escape.  The run/level of each code follow from the largest level
// of each (last, run), listed per table below.
inline const Code kInterTcoef[103] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},
    {0x24, 9},  {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11},
    {0x6, 3},   {0x14, 6},  {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12},
    {0xe, 4},   {0x1d, 8},  {0xe, 10},  {0x51, 12}, {0xd, 5},   {0x23, 9},
    {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12}, {0xb, 5},   {0xc, 10},
    {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},  {0xa, 10},
    {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},
    {0x1f, 9},  {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},
    {0x5, 11},  {0xf, 6},   {0x4, 11},  {0xe, 6},   {0xd, 6},   {0xc, 6},
    {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},  {0x1a, 8},  {0x19, 8},
    {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},  {0x13, 8},
    {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7}};
inline const int kInterMaxLevel0[] = {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1,
                               1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
inline const int kInterMaxLevel1[] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};


// MPEG-1/2's dct_dc_size_luminance / _chrominance 0..11 (tables B-12,
// B-13), which SpeedHQ reads too (from each byte's lowest bit)
inline const Code kDcLuma[12] = {{0x4, 3}, {0x0, 2}, {0x1, 2}, {0x5, 3}, {0x6, 3}, {0xe, 4},
                                 {0x1e, 5}, {0x3e, 6}, {0x7e, 7}, {0xfe, 8}, {0x1fe, 9}, {0x1ff, 9}};
inline const Code kDcChroma[12] = {{0x0, 2}, {0x1, 2}, {0x2, 2}, {0x6, 3}, {0xe, 4}, {0x1e, 5},
                                   {0x3e, 6}, {0x7e, 7}, {0xfe, 8}, {0x1fe, 9}, {0x3fe, 10},
                                   {0x3ff, 10}};

// MPEG-1's default intra matrix, raster order (SpeedHQ's, its first entry
// 16: unscaled_quant_matrix)
inline const uint8_t kDefaultIntra[64] = {
    8,  16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};

// MPEG-4's DC size codes (MS-MPEG4 v2 reads them with every bit inverted)
inline const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                         {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                         {1, 9}, {1, 10}, {1, 11}};
inline const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                           {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                           {1, 10}, {1, 11}, {1, 12}};

// MPEG-4's intra TCOEF (MS-MPEG4's RL table 2 too) and the largest level of
// each run
inline const Code kIntraTcoef[103] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},
    {0x13, 6},  {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},
    {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
    {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},   {0x14, 6},  {0x16, 7},
    {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},
    {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
    {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},
    {0x18, 8},  {0x23, 11}, {0x17, 8},  {0x19, 9},  {0x18, 9},  {0x7, 10},
    {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
    {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},
    {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
    {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7}};
inline const int kIntraMaxLevel0[] = {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1};
inline const int kIntraMaxLevel1[] = {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

inline constexpr int kDquant[4] = {-1, -2, 1, 2};

// A TCOEF table with its run/level bookkeeping (for the escapes).
struct RunLevel {
    Vlc vlc;
    const Code* codes;
    uint8_t last[102], run[102], level[102];
    int max_level[2][64];     // by run
    int max_run[2][64];       // by level
    int index[2][64][28];     // (last, run, level) -> code, -1 if none
    void build(const Code* c, const int* ml0, int n0, const int* ml1, int n1) {
        codes = c;
        vlc.build(c, 103, 12);
        memset(max_level, 0, sizeof max_level);
        memset(max_run, 0, sizeof max_run);
        memset(index, -1, sizeof index);
        int k = 0;
        for (int l = 0; l < 2; l++) {
            const int* ml = l ? ml1 : ml0;
            int n = l ? n1 : n0;
            for (int r = 0; r < n; r++) {
                max_level[l][r] = ml[r];
                for (int v = 1; v <= ml[r]; v++) {
                    last[k] = (uint8_t)l;
                    run[k] = (uint8_t)r;
                    level[k] = (uint8_t)v;
                    index[l][r][v] = k;
                    max_run[l][v] = std::max(max_run[l][v], r);
                    k++;
                }
            }
        }
        if (k != 102) {
            fprintf(stderr, "TCOEF table has %d codes\n", k);
            abort();
        }
    }
};


inline int mid_pred(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ff_h263_decode_motion: one vector component from its MVD code and the
// prediction, wrapped to 5 + fcode bits (no long vectors)
inline int read_motion(BitReader& br, const Vlc& mvd, int pred, int fcode) {
    int code = br.vlc(mvd);
    if (code == 0) return pred;
    int sign = br.get1();
    int shift = fcode - 1;
    int val = code;
    if (shift) {
        val = (val - 1) << shift;
        val |= (int)br.get(shift);
        val++;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;   // sign_extend(val, 5 + f_code)
    return (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
}

// The motion vectors of a picture's luma blocks, on an 8x8 grid with a
// border row on top and a border column on either side that is never
// written (0), and the slice the current macroblock belongs to.
struct MvPred {
    int mb_w = 0, mb_h = 0, ls = 0;
    std::vector<int16_t> mv;        // 2 a luma block
    int resync_x = 0, resync_y = 0;
    bool first_line = true;

    void init_mv(int w, int h) {
        mb_w = w;
        mb_h = h;
        ls = 2 * w + 2;
        mv.assign((size_t)ls * (2 * h + 1) * 2, 0);
    }
    // the grid index of luma block n of macroblock (x, y)
    int block(int n, int x, int y) const { return (2 * y + (n >> 1) + 1) * ls + 2 * x + (n & 1) + 1; }
    int16_t* mv_at(int n, int x, int y) { return &mv[(size_t)block(n, x, y) * 2]; }
    // ff_h263_pred_motion; h263_pred (MPEG-4's, not H.263's) takes the
    // above-right vector into the first line's prediction before a resync
    void pred_mv(int n, int x, int y, int* px, int* py, bool h263_pred = true) {
        static const int off[4] = {2, 1, 1, -1};
        int16_t* m = mv_at(n, x, y);
        const int w2 = ls * 2;
        int16_t* A = m - 2;
        auto mid = mid_pred;
        if (first_line && n < 3) {
            if (n == 0) {
                if (x == resync_x) {
                    *px = *py = 0;
                } else if (x + 1 == resync_x && h263_pred) {
                    const int16_t* C = m + off[n] * 2 - w2;
                    if (x == 0) {
                        *px = C[0];
                        *py = C[1];
                    } else {
                        *px = mid(A[0], 0, C[0]);
                        *py = mid(A[1], 0, C[1]);
                    }
                } else {
                    *px = A[0];
                    *py = A[1];
                }
            } else if (n == 1) {
                if (x + 1 == resync_x && h263_pred) {
                    const int16_t* C = m + off[n] * 2 - w2;
                    *px = mid(A[0], 0, C[0]);
                    *py = mid(A[1], 0, C[1]);
                } else {
                    *px = A[0];
                    *py = A[1];
                }
            } else {
                const int16_t* B = m - w2;
                const int16_t* C = m + off[n] * 2 - w2;
                if (x == resync_x) A[0] = A[1] = 0;
                *px = mid(A[0], B[0], C[0]);
                *py = mid(A[1], B[1], C[1]);
            }
        } else {
            const int16_t* B = m - w2;
            const int16_t* C = m + off[n] * 2 - w2;
            *px = mid(A[0], B[0], C[0]);
            *py = mid(A[1], B[1], C[1]);
        }
    }
    void set_mv16(int x, int y, int mx, int my) {
        for (int n = 0; n < 4; n++) {
            int16_t* m = mv_at(n, x, y);
            m[0] = (int16_t)mx;
            m[1] = (int16_t)my;
        }
    }
};

// ----------------------------------------- H.263-family motion compensation
// FFmpeg's mpegvideo_motion.c for progressive H.263-family pictures: the
// reference's edges (ew x eh, FFmpeg's h_edge_pos/v_edge_pos) and the
// coded size (w x h), which 8x8 vectors are clipped to.

struct Edges {
    int ew, eh, w, h;
};

// mpeg_motion_internal, 16x16: luma, and chroma at the halved vector with
// H.263's rounding of its half-pel bit
inline void mpeg_motion(const Picture& ref, const Edges& e, int x, int y, int mx, int my, bool no_rnd,
                        uint8_t* dy, uint8_t* du, uint8_t* dv, int ls, int cs) {
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int sx = x * 16 + (mx >> 1), sy = y * 16 + (my >> 1);
    mc_block(ref.p[0], e.ew, e.eh, sx, sy, dxy, 16, 16, no_rnd, dy, ls);
    const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
    const int ux = sx >> 1, uy = sy >> 1;
    mc_block(ref.p[1], e.ew >> 1, e.eh >> 1, ux, uy, uvdxy, 8, 8, no_rnd, du, cs);
    mc_block(ref.p[2], e.ew >> 1, e.eh >> 1, ux, uy, uvdxy, 8, 8, no_rnd, dv, cs);
}

// hpel_motion: an 8x8 luma block at (x0, y0) moved by (mx, my)
inline void hpel_motion(const Plane& ref, const Edges& e, int x0, int y0, int mx, int my, bool no_rnd,
                        uint8_t* dst, int stride) {
    int sx = x0 + (mx >> 1), sy = y0 + (my >> 1), dxy = 0;
    sx = std::min(std::max(sx, -16), e.w);
    if (sx != e.w) dxy |= mx & 1;
    sy = std::min(std::max(sy, -16), e.h);
    if (sy != e.h) dxy |= (my & 1) << 1;
    mc_block(ref, e.ew, e.eh, sx, sy, dxy, 8, 8, no_rnd, dst, stride);
}

// chroma_4mv_motion: macroblock (x, y)'s chroma from the sum of its four
// luma vectors, rounded as H.263 rounds it (ff_h263_round_chroma)
inline void chroma_4mv_motion(const Picture& ref, const Edges& e, int x, int y, int sumx, int sumy,
                              bool no_rnd, uint8_t* du, uint8_t* dv, int cs) {
    static const int round16[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    int mx = 2 * (sumx >> 4) + round16[sumx & 15];
    int my = 2 * (sumy >> 4) + round16[sumy & 15];
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int sx = x * 8 + mx, sy = y * 8 + my;
    sx = std::min(std::max(sx, -8), e.w >> 1);
    if (sx == (e.w >> 1)) dxy &= ~1;
    sy = std::min(std::max(sy, -8), e.h >> 1);
    if (sy == (e.h >> 1)) dxy &= ~2;
    mc_block(ref.p[1], e.ew >> 1, e.eh >> 1, sx, sy, dxy, 8, 8, no_rnd, du, cs);
    mc_block(ref.p[2], e.ew >> 1, e.eh >> 1, sx, sy, dxy, 8, 8, no_rnd, dv, cs);
}

// ---- error resilience: error_resilience.c's ff_er_frame_end as FFmpeg
// runs it for the MPEG video decoders (error_concealment 3: guess
// vectors, deblock), over one status a macroblock (raster order, no
// stride) that the decoder filled as ff_er_add_slice fills it.  The
// codec's own steps (where the status comes from, the guessed vectors and
// how a vector is rendered) stay with the decoder.
struct ErrorResilience {
    enum { kAcError = 2, kDcError = 4, kMvError = 8, kAcEnd = 16, kDcEnd = 32, kMvEnd = 64,
           kMbError = kAcError | kDcError | kMvError, kMbEnd = kAcEnd | kDcEnd | kMvEnd, kVpStart = 1 };

    int mb_w = 0, mb_h = 0;
    std::vector<uint8_t> st;       // the status table
    std::vector<uint8_t> is_intra; // each macroblock's kind as the concealment takes it
    std::vector<int16_t> mv8;      // each 8x8 block's vector (2 a block, row of 2*mb_w)

    size_t blk8(int bx, int by) const { return (size_t)by * 2 * mb_w + bx; }

    // ff_er_frame_start: every macroblock damaged, a packet of its own
    void start(int w, int h) {
        mb_w = w;
        mb_h = h;
        st.assign((size_t)w * h, kMbError | kVpStart | kMbEnd);
        is_intra.assign((size_t)w * h, 0);
        mv8.assign((size_t)w * h * 8, 0);
    }

    // ff_er_add_slice for a slice decoded whole from macroblock ``first``
    // to ``last``
    void add_slice(int first, int last) {
        for (int m = first; m < last; m++) st[m] = 0;
        st[last] = kMbEnd;
        st[first] |= kVpStart;
    }

    // ff_er_add_slice for a slice that failed before macroblock ``end``
    // (the one after the last it decoded): its macroblocks cleared, the
    // error at ``end``
    void add_error(int first, int end) {
        const int num = mb_w * mb_h;
        for (int m = first; m < end && m < num; m++) st[m] = 0;
        if (end < num) st[end] = kMbError;
        st[first] |= kVpStart;
    }

    // the passes over the table: overlapping slices; the 50 macroblocks
    // before an error share it (``counted[m]`` 0: a skipped macroblock,
    // which does not count); forward within a slice; then all or nothing
    // (no partitions)
    void spread(const std::vector<uint8_t>& counted) {
        const int num = mb_w * mb_h;
        for (int type = 1; type <= 3; type++) {
            bool end_ok = false;
            for (int m = num - 1; m >= 0; m--) {
                const int e = st[m];
                if (e & (1 << type)) end_ok = true;
                if (e & (8 << type)) end_ok = true;
                if (!end_ok) st[m] |= 1 << type;
                if (e & kVpStart) end_ok = false;
            }
        }
        for (int type = 1; type <= 3; type++) {
            int distance = 9999999;
            for (int m = num - 1; m >= 0; m--) {
                const int e = st[m];
                if (counted[m]) distance++;
                if (e & (1 << type)) distance = 0;
                if (distance < 50) st[m] |= 1 << type;
                if (e & kVpStart) distance = 9999999;
            }
        }
        int err = 0;
        for (int m = 0; m < num; m++) {
            if (st[m] & kVpStart) err = st[m] & kMbError;
            else {
                err |= st[m] & kMbError;
                st[m] |= err;
            }
        }
        for (auto& e : st)
            if (e & kMbError) e |= kMbError;
    }

    bool damaged(int m) const { return (st[m] & kDcError) && (st[m] & kMvError); }

    // is_intra_more_likely: over the undamaged macroblocks (every
    // ``skip_amount``-th, the last row left out), in an I picture their SAD
    // against the last picture beside the last picture's against itself a
    // row of macroblocks down, in a P picture their intra count less their
    // inter count (is_intra holds the decoded macroblocks' kinds)
    bool intra_more_likely(const Picture& cur, const Picture* ref, int pict_type) const {
        if (!ref) return true;   // no previous picture: spatial
        const int num = mb_w * mb_h;
        int undamaged = 0;
        for (int m = 0; m < num; m++)
            if (!damaged(m)) undamaged++;
        if (undamaged < 5) return false;   // almost all damaged: temporal
        const int skip_amount = std::max(undamaged / 50, 1);
        int score = 0, j = 0;
        for (int y = 0; y < mb_h - 1; y++)
            for (int x = 0; x < mb_w; x++) {
                const int m = y * mb_w + x;
                if (damaged(m)) continue;
                j++;
                if (j % skip_amount) continue;
                if (pict_type == 2) {
                    score += is_intra[m] ? 1 : -1;
                    continue;
                }
                const Plane &c = cur.p[0], &l = ref->p[0];
                for (int r = 0; r < 16; r++)
                    for (int k = 0; k < 16; k++) {
                        score += std::abs(l.at(x * 16, y * 16 + r)[k] - c.at(x * 16, y * 16 + r)[k]);
                        score -= std::abs(l.at(x * 16, y * 16 + r)[k] - l.at(x * 16, y * 16 + 16 + r)[k]);
                    }
            }
        return score > 0;
    }

    // the steps after the vectors: every macroblock's DCs from its pixels
    // (8x the mean), the damaged intra ones' guessed, the luma DCs
    // smoothed, intra macroblocks with damaged AC rendered from their DCs
    // alone, and the edges of damaged blocks filtered
    void finish(Picture& cur) const {
        const int mw = mb_w, mh = mb_h, num = mw * mh;
        std::vector<int> dc0((size_t)4 * num), dc1((size_t)num), dc2((size_t)num);
        for (int m = 0; m < num; m++) {
            const int x = m % mw, y = m / mw;
            for (int n = 0; n < 4; n++) {
                int sum = 0;
                const uint8_t* p = cur.p[0].at(x * 16 + (n & 1) * 8, y * 16 + (n >> 1) * 8);
                for (int r = 0; r < 8; r++)
                    for (int c = 0; c < 8; c++) sum += p[r * cur.p[0].w + c];
                dc0[blk8(x * 2 + (n & 1), y * 2 + (n >> 1))] = (sum + 4) >> 3;
            }
            int su = 0, sv = 0;
            for (int r = 0; r < 8; r++)
                for (int c = 0; c < 8; c++) {
                    su += cur.p[1].at(x * 8, y * 8)[r * cur.p[1].w + c];
                    sv += cur.p[2].at(x * 8, y * 8)[r * cur.p[2].w + c];
                }
            dc1[m] = (su + 4) >> 3;
            dc2[m] = (sv + 4) >> 3;
        }
        guess_dc(dc0, 2 * mw, 2 * mh, true);
        guess_dc(dc1, mw, mh, false);
        guess_dc(dc2, mw, mh, false);
        filter181(dc0, 2 * mw, 2 * mh);
        for (int m = 0; m < num; m++) {
            if (!is_intra[m] || !(st[m] & kAcError)) continue;
            const int x = m % mw, y = m / mw;
            for (int n = 0; n < 4; n++) {
                const int d = std::min(std::max(dc0[blk8(x * 2 + (n & 1), y * 2 + (n >> 1))], 0), 2040) / 8;
                for (int r = 0; r < 8; r++)
                    memset(cur.p[0].at(x * 16 + (n & 1) * 8, y * 16 + (n >> 1) * 8 + r), d, 8);
            }
            const int du = std::min(std::max(dc1[m], 0), 2040) / 8;
            const int dv = std::min(std::max(dc2[m], 0), 2040) / 8;
            for (int r = 0; r < 8; r++) {
                memset(cur.p[1].at(x * 8, y * 8 + r), du, 8);
                memset(cur.p[2].at(x * 8, y * 8 + r), dv, 8);
            }
        }
        for (int pi = 0; pi < 3; pi++) {
            block_filter(cur.p[pi], pi == 0, true);
            block_filter(cur.p[pi], pi == 0, false);
        }
    }

    // guess_dc: a damaged intra block's DC from the nearest undamaged
    // block (or inter one) in each direction, weighted by 1/distance
    void guess_dc(std::vector<int>& dc, int w, int h, bool luma) const {
        auto mb_of = [&](int bx, int by) { return luma ? (by >> 1) * mb_w + (bx >> 1) : by * mb_w + bx; };
        auto source = [&](int m) { return !is_intra[m] || !(st[m] & kDcError); };
        std::vector<int> col((size_t)w * h * 4);
        std::vector<int64_t> dist((size_t)w * h * 4);
        for (int by = 0; by < h; by++) {
            int color = 1024, d = -1;
            for (int bx = 0; bx < w; bx++) {
                if (source(mb_of(bx, by))) {
                    color = dc[(size_t)by * w + bx];
                    d = bx;
                }
                col[((size_t)by * w + bx) * 4 + 1] = color;
                dist[((size_t)by * w + bx) * 4 + 1] = d >= 0 ? bx - d : 9999;
            }
            color = 1024;
            d = -1;
            for (int bx = w - 1; bx >= 0; bx--) {
                if (source(mb_of(bx, by))) {
                    color = dc[(size_t)by * w + bx];
                    d = bx;
                }
                col[((size_t)by * w + bx) * 4 + 0] = color;
                dist[((size_t)by * w + bx) * 4 + 0] = d >= 0 ? d - bx : 9999;
            }
        }
        for (int bx = 0; bx < w; bx++) {
            int color = 1024, d = -1;
            for (int by = 0; by < h; by++) {
                if (source(mb_of(bx, by))) {
                    color = dc[(size_t)by * w + bx];
                    d = by;
                }
                col[((size_t)by * w + bx) * 4 + 3] = color;
                dist[((size_t)by * w + bx) * 4 + 3] = d >= 0 ? by - d : 9999;
            }
            color = 1024;
            d = -1;
            for (int by = h - 1; by >= 0; by--) {
                if (source(mb_of(bx, by))) {
                    color = dc[(size_t)by * w + bx];
                    d = by;
                }
                col[((size_t)by * w + bx) * 4 + 2] = color;
                dist[((size_t)by * w + bx) * 4 + 2] = d >= 0 ? d - by : 9999;
            }
        }
        for (int by = 0; by < h; by++)
            for (int bx = 0; bx < w; bx++) {
                const int m = mb_of(bx, by);
                if (!is_intra[m] || !(st[m] & kDcError)) continue;
                int64_t guess = 0, weight_sum = 0;
                for (int j = 0; j < 4; j++) {
                    const size_t i = ((size_t)by * w + bx) * 4 + j;
                    const int64_t weight = 256LL * 256 * 256 * 16 / std::max<int64_t>(dist[i], 1);
                    guess += weight * col[i];
                    weight_sum += weight;
                }
                dc[(size_t)by * w + bx] = int((guess + weight_sum / 2) / weight_sum);
            }
    }

    // filter181: the luma DCs smoothed (-1, 8, -1)/6, rows then columns
    static void filter181(std::vector<int>& d, int w, int h) {
        auto f = [](int prev, int c, int next) {
            int dc = -prev + c * 8 - next;
            dc = std::min(std::max(dc, INT_MIN / 10923), INT_MAX / 10923 - 32768);
            return (dc * 10923 + 32768) >> 16;
        };
        for (int y = 1; y < h - 1; y++) {
            int prev = d[(size_t)y * w];
            for (int x = 1; x < w - 1; x++) {
                const int c = d[(size_t)y * w + x];
                d[(size_t)y * w + x] = f(prev, c, d[(size_t)y * w + x + 1]);
                prev = c;
            }
        }
        for (int x = 1; x < w - 1; x++) {
            int prev = d[x];
            for (int y = 1; y < h - 1; y++) {
                const int c = d[(size_t)y * w + x];
                d[(size_t)y * w + x] = f(prev, c, d[(size_t)(y + 1) * w + x]);
                prev = c;
            }
        }
    }

    // h_block_filter (``across``: the vertical edges between blocks side
    // by side) or v_block_filter: the edges of damaged blocks smoothed,
    // where both sides are inter with vectors that nearly agree (FFmpeg
    // adds the vertical components) excepted
    void block_filter(Plane& p, bool luma, bool across) const {
        const int w = luma ? 2 * mb_w : mb_w, h = luma ? 2 * mb_h : mb_h;
        const int ls = p.w;
        auto mb_of = [&](int bx, int by) { return luma ? (by >> 1) * mb_w + (bx >> 1) : by * mb_w + bx; };
        auto mv = [&](int bx, int by) { return &mv8[(luma ? blk8(bx, by) : blk8(2 * bx, 2 * by)) * 2]; };
        for (int by = 0; by < h - (across ? 0 : 1); by++)
            for (int bx = 0; bx < w - (across ? 1 : 0); bx++) {
                const int bx2 = across ? bx + 1 : bx, by2 = across ? by : by + 1;
                const int m1 = mb_of(bx, by), m2 = mb_of(bx2, by2);
                const bool dmg1 = st[m1] & kMbError, dmg2 = st[m2] & kMbError;
                if (!dmg1 && !dmg2) continue;
                const int16_t *v1 = mv(bx, by), *v2 = mv(bx2, by2);
                if (!is_intra[m1] && !is_intra[m2] && std::abs(v1[0] - v2[0]) + std::abs(v1[1] + v2[1]) < 2)
                    continue;
                uint8_t* base = p.d.data() + (size_t)by * 8 * ls + bx * 8;
                const int step = across ? 1 : ls, line = across ? ls : 1;
                for (int k = 0; k < 8; k++) {
                    uint8_t* q = base + (size_t)k * line;
                    const int a = q[7 * step] - q[6 * step];
                    const int b = q[8 * step] - q[7 * step];
                    const int c = q[9 * step] - q[8 * step];
                    int d = std::max(std::abs(b) - ((std::abs(a) + std::abs(c) + 1) >> 1), 0);
                    if (b < 0) d = -d;
                    if (!d) continue;
                    if (!(dmg1 && dmg2)) d = d * 16 / 9;
                    auto put = [&](int i, int v) { q[i * step] = (uint8_t)std::min(std::max(v, 0), 255); };
                    if (dmg1) {
                        put(7, q[7 * step] + ((d * 7) >> 4));
                        put(6, q[6 * step] + ((d * 5) >> 4));
                        put(5, q[5 * step] + ((d * 3) >> 4));
                        put(4, q[4 * step] + ((d * 1) >> 4));
                    }
                    if (dmg2) {
                        put(8, q[8 * step] - ((d * 7) >> 4));
                        put(9, q[9 * step] - ((d * 5) >> 4));
                        put(10, q[10 * step] - ((d * 3) >> 4));
                        put(11, q[11 * step] - ((d * 1) >> 4));
                    }
                }
            }
    }
};

}  // namespace mpegc
