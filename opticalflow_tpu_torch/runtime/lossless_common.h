// What the port's HuffYUV, Ut Video and MagicYUV decoders (huffyuv.cpp,
// utvideo.cpp, magicyuv.cpp) share, and asv.cpp with them: their failures, the MSB-first bit reader over a packet's 32-bit
// little-endian words (FFmpeg's bswap_buf, then get_bits), a prefix code
// read symbol by symbol from (code, length, symbol) triples (what
// vlc_init builds), and lossless_videodsp's median prediction.
//
// Header only; each including source is one shared library.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace lossless {

enum { OK = 0, UNSUPPORTED = 2, CORRUPT = 3 };

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] inline void corrupt(const std::string& m) { throw Failure{CORRUPT, m}; }
[[noreturn]] inline void unsupported(const std::string& m) { throw Failure{UNSUPPORTED, m}; }

inline void put_msg(char* msg, int64_t cap, const std::string& m) {
    if (cap <= 0) return;
    const size_t n = std::min((size_t)cap - 1, m.size());
    std::memcpy(msg, m.data(), n);
    msg[n] = 0;
}

// bswap_buf over the whole 32-bit words of n bytes; the rest, and 16 bytes
// of padding a reader may look at past the end, zero
inline void swap_words(const uint8_t* src, int64_t n, std::vector<uint8_t>& dst) {
    dst.assign((size_t)n + 16, 0);
    for (int64_t i = 0; i < n / 4; i++) {
        dst[4 * i] = src[4 * i + 3];
        dst[4 * i + 1] = src[4 * i + 2];
        dst[4 * i + 2] = src[4 * i + 1];
        dst[4 * i + 3] = src[4 * i];
    }
}

// MSB-first reader over bytes padded with zeros (8 past the last it reads)
struct Bits {
    const uint8_t* p = nullptr;
    int64_t size = 0;   // bits
    int64_t pos = 0;
    void init(const uint8_t* data, int64_t nbytes) {
        p = data;
        size = nbytes * 8;
        pos = 0;
    }
    // the next n (<= 32) bits
    uint32_t show(int n) const {
        if (n == 0) return 0;
        const uint8_t* q = p + (pos >> 3);
        uint64_t v = 0;
        for (int i = 0; i < 8; i++) v = v << 8 | q[i];
        return (uint32_t)((v << (pos & 7)) >> (64 - n));
    }
    uint32_t get(int n) {
        const uint32_t v = show(n);
        pos += n;
        return v;
    }
    int64_t left() const { return size - pos; }
};

// A prefix code: a kBits-bit lookup, the longer codes listed by their
// first kBits bits
struct PrefixCode {
    static constexpr int kBits = 12;
    struct Code {
        uint32_t code;
        int len, sym;
    };
    std::vector<int16_t> sym;      // -1: no code; -2: longer codes start here
    std::vector<uint8_t> len;
    std::vector<std::vector<Code>> longer;

    void build(const std::vector<Code>& codes) {
        sym.assign(1 << kBits, -1);
        len.assign(1 << kBits, 0);
        longer.assign(1 << kBits, {});
        for (const Code& c : codes) {
            if (c.len <= kBits) {
                const int shift = kBits - c.len;
                for (uint32_t i = c.code << shift; i < (c.code + 1) << shift; i++) {
                    if (sym[i] != -1) corrupt("Huffman codes that are not prefix-free");
                    sym[i] = (int16_t)c.sym;
                    len[i] = (uint8_t)c.len;
                }
            } else {
                const uint32_t prefix = c.code >> (c.len - kBits);
                if (sym[prefix] >= 0) corrupt("Huffman codes that are not prefix-free");
                sym[prefix] = -2;
                longer[prefix].push_back(c);
            }
        }
    }

    int read(Bits& b) const {
        const uint32_t i = b.show(kBits);
        const int s = sym[i];
        if (s >= 0) {
            b.pos += len[i];
            return s;
        }
        if (s == -2)
            for (const Code& c : longer[i])
                if (b.show(c.len) == c.code) {
                    b.pos += c.len;
                    return c.sym;
                }
        corrupt("a code that no Huffman table holds");
    }
};

inline int mid_pred(int a, int b, int c) {
    if (a > b) std::swap(a, b);
    return std::max(a, std::min(b, c));
}

// add_median_pred (lossless_videodsp; huffyuvdsp's add_hfyu_median_pred is
// the same): each sample the median of left, top and left + top - topleft,
// plus its residual; left and topleft carried in and out
inline void add_median_pred(uint8_t* dst, const uint8_t* top, const uint8_t* diff, int w,
                            int* left, int* left_top) {
    uint8_t l = (uint8_t)*left, lt = (uint8_t)*left_top;
    for (int i = 0; i < w; i++) {
        l = (uint8_t)(mid_pred(l, top[i], (l + top[i] - lt) & 0xFF) + diff[i]);
        lt = top[i];
        dst[i] = l;
    }
    *left = l;
    *left_top = lt;
}

}  // namespace lossless
