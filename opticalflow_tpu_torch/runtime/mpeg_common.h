// The parts of an MPEG video decoder that MPEG-1/2 (mpeg12.cpp) and
// MPEG-4 Part 2 (mpeg4.cpp) share, as FFmpeg 8's decoders run them: errors
// as C++ exceptions with a message, VLC tables over a bit reader, the scans,
// macroblock-aligned planes and half-pel block prediction.
//
// Header only; each including source is one shared library.

#pragma once

#include <algorithm>
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

// the scans: zigzag, and the alternate vertical scan (MPEG-2's
// alternate_scan, MPEG-4's AC prediction from above)
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
    void reset(const uint8_t* d, int64_t n) {
        buf.assign(d, d + n);
        buf.resize(n + 8, 0);
        size = n * 8;
        pos = 0;
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
        if (pos > size) CORRUPT("bitstream overread (truncated picture)");
    }
    int vlc(const Vlc& v) {
        int i = (int)show(v.bits);
        int s = v.sym[i];
        if (s < 0 || pos >= size) CORRUPT("invalid VLC at bit %lld", (long long)pos);
        pos += v.len[i];
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

}  // namespace mpegc
