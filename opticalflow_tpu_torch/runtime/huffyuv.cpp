// HuffYUV and FFVHuff decoded in host C++ as FFmpeg 8's huffyuv and
// ffvhuff decoder (huffyuvdec.c, huffyuvdsp.c, lossless_videodsp.c)
// decodes them for cv2.VideoCapture, bit for bit:
//
//   * the stream's version as decode_init picks it from the extradata and
//     the container's bits per sample: 0 and 1 (no extradata, or a
//     bit-count naming the predictor) read HuffYUV 2.1.1's fixed tables
//     (kClassic*, read out of libavcodec), 2 and 3 read run-length coded
//     code lengths from the extradata (read_len_table,
//     ff_huffyuv_generate_bits_table), and FFVHuff's context mode reads
//     them again at the head of every packet;
//   * the packet as 32-bit little-endian words read from their top bit
//     (bswap_buf), the Huffman codes symbol by symbol (FFmpeg's joint
//     tables give the same symbols);
//   * versions 0-2: 4:2:2 (YUY2-style, the commonest HuffYUV in the wild)
//     and FFVHuff's 4:2:0 with the left, plane (gradient) and median
//     predictors, the median's first line left-predicted and its 4:2:0
//     chroma row 1 beside luma row 1, as decode_slice lays them out; RGB24
//     and RGB32 with or without decorrelation (G, B-G, R-G), left and
//     plane, bottom-up; the interlaced flag (height over 288 unless the
//     extradata says) and its two-line strides;
//   * version 3 at 8 bits: grey, GBR and GBRA, YUV 4:4:4, 4:2:2, 4:1:1,
//     4:4:0, 4:2:0 and 4:1:0, with or without alpha, plane by plane, an
//     odd last sample of a line read alone.
//
// An RGB frame comes out as packed BGR (swscale's BGR0/BGRA or GBR(A)P ->
// BGR24 copy: the alpha dropped), grey as its plane, YCbCr as its planes.
// Samples above 8 bits, the median predictor on RGB (FFmpeg decodes
// nothing there) and subsampled version-3 frames of odd size raise
// lossless::UNSUPPORTED naming what; damaged data (a code table that is no
// Huffman code, a code no table holds, too short a packet) raises
// lossless::CORRUPT.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "lossless_common.h"

namespace {

using lossless::Bits;
using lossless::Failure;
using lossless::PrefixCode;
using lossless::add_median_pred;
using lossless::corrupt;
using lossless::unsupported;

enum { LEFT = 0, PLANE = 1, MEDIAN = 2 };
enum { B = 0, G = 1, R = 2, A = 3 };   // bytes of a little-endian BGR0/BGRA pixel

// the decoder's feature bits (huffyuv.py's FEATURES, in order)
enum Feature {
    F_LEFT, F_PLANE, F_MEDIAN, F_DECORRELATE, F_CLASSIC_TABLES, F_EXTRADATA_TABLES,
    F_CONTEXT, F_INTERLACED, F_YUV422, F_YUV420, F_RGB24, F_RGB32, F_VERSION_3, F_GRAY,
    F_GBRP, F_GBRAP, F_YUV444, F_YUV411, F_YUV440, F_YUV410, F_ALPHA, F_ODD_WIDTH
};

// HuffYUV 2.1.1's tables (huffyuvdec.c's classic_shift_luma/_chroma: code
// lengths in read_len_table's run-length form; classic_add_luma/_chroma:
// the codes), as libavcodec 62 holds them
const uint8_t kClassicShiftLuma[42] = {
     34,  36,  35,  69, 135, 232,   9,  16,  10,  24,  11,  23,  12,  16,  13,  10,
     14,   8,  15,   8,  16,   8,  17,  20,  16,  10, 207, 206, 205, 236,  11,   8,
     10,  21,   9,  23,   8,   8, 199,  70,  69,  68,
};

const uint8_t kClassicShiftChroma[59] = {
     66,  36,  37,  38,  39,  40,  41,  75,  76,  77, 110, 239, 144,  81,  82,  83,
     84,  85, 118, 183,  56,  57,  88,  89,  56,  89, 154,  57,  58,  57,  26, 141,
     57,  56,  58,  57,  58,  57, 184, 119, 214, 245, 116,  83,  82,  49,  80,  79,
     78,  77,  44,  75,  41,  40,  39,  38,  37,  36,  34,
};

const uint8_t kClassicAddLuma[256] = {
      3,   9,   5,  12,  10,  35,  32,  29,  27,  50,  48,  45,  44,  41,  39,  37,
     73,  70,  68,  65,  64,  61,  58,  56,  53,  50,  49,  46,  44,  41,  38,  36,
     68,  65,  63,  61,  58,  55,  53,  51,  48,  46,  45,  43,  41,  39,  38,  36,
     35,  33,  32,  30,  29,  27,  26,  25,  48,  47,  46,  44,  43,  41,  40,  39,
     37,  36,  35,  34,  32,  31,  30,  28,  27,  26,  24,  23,  22,  20,  19,  37,
     35,  34,  33,  31,  30,  29,  27,  26,  24,  23,  21,  20,  18,  17,  15,  29,
     27,  26,  24,  22,  21,  19,  17,  16,  14,  26,  25,  23,  21,  19,  18,  16,
     15,  27,  25,  23,  21,  19,  17,  16,  14,  26,  25,  23,  21,  18,  17,  14,
     12,  17,  19,  13,   4,   9,   2,  11,   1,   7,   8,   0,  16,   3,  14,   6,
     12,  10,   5,  15,  18,  11,  10,  13,  15,  16,  19,  20,  22,  24,  27,  15,
     18,  20,  22,  24,  26,  14,  17,  20,  22,  24,  27,  15,  18,  20,  23,  25,
     28,  16,  19,  22,  25,  28,  32,  36,  21,  25,  29,  33,  38,  42,  45,  49,
     28,  31,  34,  37,  40,  42,  44,  47,  49,  50,  52,  54,  56,  57,  59,  60,
     62,  64,  66,  67,  69,  35,  37,  39,  40,  42,  43,  45,  47,  48,  51,  52,
     54,  55,  57,  59,  60,  62,  63,  66,  67,  69,  71,  72,  38,  40,  42,  43,
     46,  47,  49,  51,  26,  28,  30,  31,  33,  34,  18,  19,  11,  13,   7,   8,
};

const uint8_t kClassicAddChroma[256] = {
      3,   1,   2,   2,   2,   2,   3,   3,   7,   5,   7,   5,   8,   6,  11,   9,
      7,  13,  11,  10,   9,   8,   7,   5,   9,   7,   6,   4,   7,   5,   8,   7,
     11,   8,  13,  11,  19,  15,  22,  23,  20,  33,  32,  28,  27,  29,  51,  77,
     43,  45,  76,  81,  46,  82,  75,  55,  56, 144,  58,  80,  60,  74, 147,  63,
    143,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  77,  78,  79,
     80,  81,  82,  83,  84,  85,  86,  87,  88,  89,  90,  91,  27,  30,  21,  22,
     17,  14,   5,   6, 100,  54,  47,  50,  51,  53, 106, 107, 108, 109, 110, 111,
    112, 113, 114, 115,   4, 117, 118,  92,  94, 121, 122,   3, 124, 103,   2,   1,
      0, 129, 130, 131, 120, 119, 126, 125, 136, 137, 138, 139, 140, 141, 142, 134,
    135, 132, 133, 104,  64, 101,  62,  57, 102,  95,  93,  59,  61,  28,  97,  96,
     52,  49,  48,  29,  32,  25,  24,  46,  23,  98,  45,  44,  43,  20,  42,  41,
     19,  18,  99,  40,  15,  39,  38,  16,  13,  12,  11,  37,  10,   9,   8,  36,
      7, 128, 127, 105, 123, 116,  35,  34,  33, 145,  31,  79,  42, 146,  78,  26,
     83,  48,  49,  50,  44,  47,  26,  31,  30,  18,  17,  19,  21,  24,  25,  13,
     14,  16,  17,  18,  20,  21,  12,  14,  15,   9,  10,   6,   9,   6,   5,   8,
      6,  12,   8,  10,   7,   9,   6,   4,   6,   2,   2,   3,   3,   3,   3,   2,
};

// vlc_init's code from (length, code) per symbol; a length of 0: no code
PrefixCode huffman(const uint8_t* lens, const uint32_t* codes, int n) {
    std::vector<PrefixCode::Code> list;
    for (int s = 0; s < n; s++)
        if (lens[s]) list.push_back({codes[s], lens[s], s});
    PrefixCode code;
    code.build(list);
    return code;
}

// read_len_table: n code lengths as (3-bit repeat, 5-bit length) runs, an
// 8-bit repeat where the 3-bit one is 0
void read_len_table(uint8_t* dst, Bits& gb, int n) {
    for (int i = 0; i < n;) {
        int repeat = (int)gb.get(3);
        const int val = (int)gb.get(5);
        if (repeat == 0) repeat = (int)gb.get(8);
        if (i + repeat > n || gb.left() < 0) corrupt("a code length table past its symbols");
        while (repeat--) dst[i++] = (uint8_t)val;
    }
}

// ff_huffyuv_generate_bits_table: canonical codes, the longest first
void generate_bits_table(uint32_t* dst, const uint8_t* lens_of, int n) {
    int lens[33] = {0};
    uint32_t codes[33];
    for (int i = 0; i < n; i++) lens[lens_of[i]]++;
    codes[32] = 0;
    for (int i = 32; i > 0; i--) {
        if ((lens[i] + codes[i]) & 1) corrupt("code lengths that make no Huffman code");
        codes[i - 1] = (lens[i] + codes[i]) >> 1;
    }
    for (int i = 0; i < n; i++)
        if (lens_of[i]) dst[i] = codes[lens_of[i]]++;
}

// lossless_videodsp's add_left_pred: the running sum, returned whole
inline int add_left_pred(uint8_t* dst, const uint8_t* src, int w, int acc) {
    for (int i = 0; i < w; i++) {
        acc += src[i];
        dst[i] = (uint8_t)acc;
    }
    return acc;
}

inline void add_bytes(uint8_t* dst, const uint8_t* src, int w) {
    for (int i = 0; i < w; i++) dst[i] = (uint8_t)(dst[i] + src[i]);
}

// add_hfyu_left_pred_bgr32
inline void add_left_pred_bgr32(uint8_t* dst, const uint8_t* src, int w, uint8_t* left) {
    uint8_t r = left[R], g = left[G], b = left[B], a = left[A];
    for (int i = 0; i < w; i++) {
        b = (uint8_t)(b + src[4 * i + B]);
        g = (uint8_t)(g + src[4 * i + G]);
        r = (uint8_t)(r + src[4 * i + R]);
        a = (uint8_t)(a + src[4 * i + A]);
        dst[4 * i + B] = b;
        dst[4 * i + G] = g;
        dst[4 * i + R] = r;
        dst[4 * i + A] = a;
    }
    left[B] = b;
    left[G] = g;
    left[R] = r;
    left[A] = a;
}

// the output pixel formats of decode_init
enum Format {
    YUV422P, YUV420P, BGR0, BGRA, GRAY8, GBRP, GBRAP, YUV444P, YUV411P, YUV440P, YUV410P,
    YUVA444P, YUVA422P, YUVA420P
};

struct Decoder {
    int width, height;
    int version = 0, predictor = LEFT, decorrelate = 0, bitstream_bpp = 0, bps = 8;
    int hshift = 0, vshift = 0, yuv = 0, chroma = 0, alpha = 0, interlaced = 0, context = 0;
    Format fmt = YUV422P;
    uint8_t len[4][256] = {};
    uint32_t bits[4][256] = {};
    PrefixCode vlc[4];
    std::vector<uint8_t> buf;                  // the packet, words swapped
    std::vector<uint8_t> plane[4];             // frame planes (or BGR0/BGRA in plane[0])
    int stride[4] = {0, 0, 0, 0};
    int rows[4] = {0, 0, 0, 0};
    std::vector<uint8_t> temp[3];
    Bits gb;
    int64_t features = 0;

    Decoder(int w, int h) : width(w), height(h) {}

    void set(Feature f) { features |= int64_t(1) << f; }

    void tables(int count) {
        for (int i = 0; i < count; i++) vlc[i] = huffman(len[i], bits[i], 256);
    }

    // read_huffman_tables: the tables' length in bytes
    int read_tables(const uint8_t* src, int64_t n) {
        std::vector<uint8_t> padded(src, src + n);
        padded.resize(n + 16, 0);
        Bits t;
        t.init(padded.data(), n);
        const int count = version > 2 ? 1 + alpha + 2 * chroma : 3;
        for (int i = 0; i < count; i++) {
            read_len_table(len[i], t, 256);
            generate_bits_table(bits[i], len[i], 256);
        }
        tables(count);
        return (int)((t.pos + 7) / 8);
    }

    // read_old_huffman_tables: HuffYUV 2.1.1's fixed tables
    void old_tables() {
        std::vector<uint8_t> l(kClassicShiftLuma, kClassicShiftLuma + sizeof kClassicShiftLuma);
        std::vector<uint8_t> c(kClassicShiftChroma, kClassicShiftChroma + sizeof kClassicShiftChroma);
        l.resize(l.size() + 16, 0);
        c.resize(c.size() + 16, 0);
        Bits t;
        t.init(l.data(), (int64_t)sizeof kClassicShiftLuma);
        read_len_table(len[0], t, 256);
        t.init(c.data(), (int64_t)sizeof kClassicShiftChroma);
        read_len_table(len[1], t, 256);
        for (int i = 0; i < 256; i++) {
            bits[0][i] = kClassicAddLuma[i];
            bits[1][i] = kClassicAddChroma[i];
        }
        if (bitstream_bpp >= 24) {
            std::memcpy(bits[1], bits[0], sizeof bits[0]);
            std::memcpy(len[1], len[0], sizeof len[0]);
        }
        std::memcpy(bits[2], bits[1], sizeof bits[1]);
        std::memcpy(len[2], len[1], sizeof len[1]);
        std::memcpy(bits[3], bits[2], sizeof bits[2]);
        std::memcpy(len[3], len[2], sizeof len[2]);
        tables(4);
        set(F_CLASSIC_TABLES);
    }

    // decode_init: the version, predictor, layout and tables
    void init(int bpc, const uint8_t* ext, int64_t n) {
        interlaced = height > 288;
        if (n) {
            if ((bpc & 7) && bpc != 12) version = 1;
            else if (n > 3 && ext[3] == 0) version = 2;
            else version = 3;
        }
        if (version >= 2) {
            if (n < 4) corrupt("extradata of fewer than 4 bytes");
            decorrelate = ext[0] & 64 ? 1 : 0;
            predictor = ext[0] & 63;
            if (version == 2) {
                bitstream_bpp = ext[1];
                if (!bitstream_bpp) bitstream_bpp = bpc & ~7;
            } else {
                bps = (ext[1] >> 4) + 1;
                hshift = ext[1] & 3;
                vshift = (ext[1] >> 2) & 3;
                yuv = ext[2] & 1;
                chroma = (ext[2] & 3) ? 1 : 0;
                alpha = (ext[2] & 4) ? 1 : 0;
                if (bps != 8)
                    unsupported(std::to_string(bps) + "-bit FFVHuff samples");
            }
            const int interlace = (ext[2] & 0x30) >> 4;
            interlaced = interlace == 1 ? 1 : interlace == 2 ? 0 : interlaced;
            context = ext[2] & 0x40 ? 1 : 0;
            read_tables(ext + 4, n - 4);
            set(F_EXTRADATA_TABLES);
        } else {
            switch (bpc & 7) {
            case 1: predictor = LEFT; decorrelate = 0; break;
            case 2: predictor = LEFT; decorrelate = 1; break;
            case 3: predictor = PLANE; decorrelate = bpc >= 24; break;
            case 4: predictor = MEDIAN; decorrelate = 0; break;
            default: predictor = LEFT; decorrelate = 0; break;
            }
            bitstream_bpp = bpc & ~7;
            context = 0;
            old_tables();
        }
        if (predictor > MEDIAN) corrupt("predictor " + std::to_string(predictor));
        if (version <= 2) {
            switch (bitstream_bpp) {
            case 12: fmt = YUV420P; yuv = 1; hshift = vshift = 1; break;
            case 16: fmt = YUV422P; yuv = 1; hshift = 1; break;
            case 24: fmt = BGR0; break;
            case 32: fmt = BGRA; alpha = 1; break;
            default: corrupt(std::to_string(bitstream_bpp) + " bits a pixel");
            }
        } else {
            const int key = chroma << 10 | yuv << 9 | alpha << 8 | (bps - 1) << 4 | hshift | vshift << 2;
            switch (key) {
            case 0x070: fmt = GRAY8; break;
            case 0x470: fmt = GBRP; break;
            case 0x570: fmt = GBRAP; break;
            case 0x670: fmt = YUV444P; break;
            case 0x671: fmt = YUV422P; break;
            case 0x672: fmt = YUV411P; break;
            case 0x674: fmt = YUV440P; break;
            case 0x675: fmt = YUV420P; break;
            case 0x67A: fmt = YUV410P; break;
            case 0x770: fmt = YUVA444P; break;
            case 0x771: fmt = YUVA422P; break;
            case 0x775: fmt = YUVA420P; break;
            default: corrupt("the version-3 layout " + std::to_string(key));
            }
            if ((width & ((1 << hshift) - 1)) || (height & ((1 << vshift) - 1)))
                unsupported("subsampled version-3 FFVHuff at an odd size");
        }
        if ((fmt == YUV422P || fmt == YUV420P) && (width & 1))
            corrupt("an odd width in 4:2:2 or 4:2:0");
        if (predictor == MEDIAN && fmt == YUV422P && width % 4)
            corrupt("a width that is not a multiple of 4 for the median predictor in 4:2:2");
        if (version <= 2 && bitstream_bpp >= 24 && predictor == MEDIAN)
            unsupported("the median predictor on RGB (FFmpeg decodes no picture there)");
        if (width < 8) unsupported("a picture narrower than 8 samples");
        // the frame's planes, with rows to spare below (two-line strides)
        const bool packed = fmt == BGR0 || fmt == BGRA;
        const int nplanes = packed ? 1 : version > 2 ? 1 + 2 * chroma + alpha : 3;
        for (int i = 0; i < nplanes; i++) {
            const bool sub = !packed && (i == 1 || i == 2);
            const int w = sub ? -((-width) >> hshift) : width;
            const int h = sub ? -((-height) >> vshift) : height;
            stride[i] = packed ? 4 * width : w;
            rows[i] = h;
            plane[i].assign((size_t)stride[i] * (h + 4) + 64, 0);
        }
        for (auto& t : temp) t.assign(4 * (size_t)width + 64, 0);
        set(predictor == LEFT ? F_LEFT : predictor == PLANE ? F_PLANE : F_MEDIAN);
        if (decorrelate) set(F_DECORRELATE);
        if (context) set(F_CONTEXT);
        if (interlaced) set(F_INTERLACED);
        if (version > 2) set(F_VERSION_3);
        if (alpha && version > 2) set(F_ALPHA);
        switch (fmt) {
        case YUV422P: set(F_YUV422); break;
        case YUV420P: set(F_YUV420); break;
        case BGR0: set(F_RGB24); break;
        case BGRA: set(F_RGB32); break;
        case GRAY8: set(F_GRAY); break;
        case GBRP: set(F_GBRP); break;
        case GBRAP: set(F_GBRAP); break;
        case YUV444P: case YUVA444P: set(F_YUV444); break;
        case YUV411P: set(F_YUV411); break;
        case YUV440P: set(F_YUV440); break;
        case YUV410P: set(F_YUV410); break;
        case YUVA422P: set(F_YUV422); break;
        case YUVA420P: set(F_YUV420); break;
        }
    }

    // ------------------------------------------------------------ symbols
    // decode_422_bitstream: count/2 pairs of Y, U, Y, V; zeros where the
    // bits run out
    void read_422(int count) {
        count /= 2;
        uint8_t* y = temp[0].data();
        uint8_t* u = temp[1].data();
        uint8_t* v = temp[2].data();
        int i = 0;
        for (; i < count && gb.left() > 0; i++) {
            y[2 * i] = (uint8_t)vlc[0].read(gb);
            u[i] = (uint8_t)vlc[1].read(gb);
            if (gb.left() <= 0) {
                i++;
                break;
            }
            y[2 * i + 1] = (uint8_t)vlc[0].read(gb);
            v[i] = (uint8_t)vlc[2].read(gb);
        }
        for (; i < count; i++) y[2 * i] = u[i] = y[2 * i + 1] = v[i] = 0;
    }

    // decode_gray_bitstream: count luma samples
    void read_gray(int count) {
        count /= 2;
        uint8_t* y = temp[0].data();
        int i = 0;
        for (; i < count && gb.left() > 0; i++) {
            y[2 * i] = (uint8_t)vlc[0].read(gb);
            y[2 * i + 1] = (uint8_t)vlc[0].read(gb);
        }
        for (; i < count; i++) y[2 * i] = y[2 * i + 1] = 0;
    }

    // decode_plane_bitstream (8 bits): pairs, the odd last sample alone
    void read_plane(int w, int p) {
        uint8_t* t = temp[0].data();
        const int count = w / 2;
        for (int i = 0; i < count && gb.left() > 0; i++) {
            t[2 * i] = (uint8_t)vlc[p].read(gb);
            t[2 * i + 1] = (uint8_t)vlc[p].read(gb);
        }
        if ((w & 1) && gb.left() > 0) {
            t[w - 1] = (uint8_t)vlc[p].read(gb);
            set(F_ODD_WIDTH);
        }
    }

    // decode_bgr_1: count pixels of B, G, R (G first and B, R as
    // differences from it where decorrelated), A from R's table
    void read_bgr(int count) {
        uint8_t* t = temp[0].data();
        for (int i = 0; i < count && gb.left() > 0; i++) {
            if (decorrelate) {
                t[4 * i + G] = (uint8_t)vlc[1].read(gb);
                t[4 * i + B] = (uint8_t)(vlc[0].read(gb) + t[4 * i + G]);
                t[4 * i + R] = (uint8_t)(vlc[2].read(gb) + t[4 * i + G]);
            } else {
                t[4 * i + B] = (uint8_t)vlc[0].read(gb);
                t[4 * i + G] = (uint8_t)vlc[1].read(gb);
                t[4 * i + R] = (uint8_t)vlc[2].read(gb);
            }
            if (bitstream_bpp == 32) t[4 * i + A] = (uint8_t)vlc[2].read(gb);
        }
    }

    // ------------------------------------------------------------ frame
    void decode(const uint8_t* data, int64_t n) {
        if (n < ((int64_t)width * height + 7) / 8) corrupt("a packet smaller than the picture's bits");
        lossless::swap_words(data, n, buf);
        int table_size = 0;
        if (context) table_size = read_tables(buf.data(), n);
        if (table_size > n) corrupt("code tables past the packet");
        gb.init(buf.data() + table_size, n - table_size);
        if (version > 2) planes_v3();
        else if (bitstream_bpp < 24) yuv_classic();
        else bgr_classic();
    }

    uint8_t* row(int p, int y) { return plane[p].data() + (size_t)stride[p] * y; }

    // decode_slice, version 3: each plane in turn
    void planes_v3() {
        const int n = 1 + 2 * chroma + alpha;
        for (int p = 0; p < n; p++) {
            int w = width, h = height;
            int fake = interlaced ? 2 * stride[p] : stride[p];
            if (chroma && (p == 1 || p == 2)) {
                w >>= hshift;
                h >>= vshift;
            }
            uint8_t* d0 = row(p, 0);
            int left, lefttop, y;
            switch (predictor) {
            case LEFT:
            case PLANE:
                read_plane(w, p);
                left = add_left_pred(d0, temp[0].data(), w, 0);
                for (y = 1; y < h; y++) {
                    uint8_t* dst = row(p, y);
                    read_plane(w, p);
                    left = add_left_pred(dst, temp[0].data(), w, left);
                    if (predictor == PLANE && y > interlaced) add_bytes(dst, dst - fake, w);
                }
                break;
            case MEDIAN:
                read_plane(w, p);
                left = add_left_pred(d0, temp[0].data(), w, 0);
                y = 1;
                if (y >= h) break;
                if (interlaced) {
                    read_plane(w, p);
                    left = add_left_pred(row(p, 1), temp[0].data(), w, left);
                    y++;
                    if (y >= h) break;
                }
                lefttop = d0[0];
                read_plane(w, p);
                add_median_pred(d0 + fake, d0, temp[0].data(), w, &left, &lefttop);
                y++;
                for (; y < h; y++) {
                    read_plane(w, p);
                    uint8_t* dst = row(p, y);
                    add_median_pred(dst, dst - fake, temp[0].data(), w, &left, &lefttop);
                }
                break;
            }
        }
    }

    // decode_slice, versions 0-2 below 24 bits: 4:2:2 and 4:2:0
    void yuv_classic() {
        const int w2 = width >> 1;
        const int fy = interlaced ? 2 * stride[0] : stride[0];
        const int fu = interlaced ? 2 * stride[1] : stride[1];
        const int fv = interlaced ? 2 * stride[2] : stride[2];
        uint8_t* Y = row(0, 0);
        uint8_t* U = row(1, 0);
        uint8_t* V = row(2, 0);
        const uint8_t *ty = temp[0].data(), *tu = temp[1].data(), *tv = temp[2].data();
        int leftv = V[0] = (uint8_t)gb.get(8);
        int lefty = Y[1] = (uint8_t)gb.get(8);
        int leftu = U[0] = (uint8_t)gb.get(8);
        Y[0] = (uint8_t)gb.get(8);
        int y, cy;
        switch (predictor) {
        case LEFT:
        case PLANE:
            read_422(width - 2);
            lefty = add_left_pred(Y + 2, ty, width - 2, lefty);
            leftu = add_left_pred(U + 1, tu, w2 - 1, leftu);
            leftv = add_left_pred(V + 1, tv, w2 - 1, leftv);
            for (cy = y = 1; y < height; y++, cy++) {
                if (bitstream_bpp == 12) {
                    read_gray(width);
                    uint8_t* yd = row(0, y);
                    lefty = add_left_pred(yd, ty, width, lefty);
                    if (predictor == PLANE && y > interlaced) add_bytes(yd, yd - fy, width);
                    y++;
                    if (y >= height) break;
                }
                uint8_t* yd = row(0, y);
                uint8_t* ud = row(1, cy);
                uint8_t* vd = row(2, cy);
                read_422(width);
                lefty = add_left_pred(yd, ty, width, lefty);
                leftu = add_left_pred(ud, tu, w2, leftu);
                leftv = add_left_pred(vd, tv, w2, leftv);
                if (predictor == PLANE && cy > interlaced) {
                    add_bytes(yd, yd - fy, width);
                    add_bytes(ud, ud - fu, w2);
                    add_bytes(vd, vd - fv, w2);
                }
            }
            break;
        case MEDIAN: {
            read_422(width - 2);
            lefty = add_left_pred(Y + 2, ty, width - 2, lefty);
            leftu = add_left_pred(U + 1, tu, w2 - 1, leftu);
            leftv = add_left_pred(V + 1, tv, w2 - 1, leftv);
            cy = y = 1;
            if (y >= height) break;
            if (interlaced) {
                read_422(width);
                lefty = add_left_pred(row(0, 1), ty, width, lefty);
                leftu = add_left_pred(row(1, 1), tu, w2, leftu);
                leftv = add_left_pred(row(2, 1), tv, w2, leftv);
                y++;
                cy++;
                if (y >= height) break;
            }
            // the next 4 pixels left-predicted too
            read_422(4);
            lefty = add_left_pred(Y + fy, ty, 4, lefty);
            leftu = add_left_pred(U + fu, tu, 2, leftu);
            leftv = add_left_pred(V + fv, tv, 2, leftv);
            // the rest of that line median-predicted
            int lefttopy = Y[3];
            read_422(width - 4);
            add_median_pred(Y + fy + 4, Y + 4, ty, width - 4, &lefty, &lefttopy);
            int lefttopu = U[1], lefttopv = V[1];
            add_median_pred(U + fu + 2, U + 2, tu, w2 - 2, &leftu, &lefttopu);
            add_median_pred(V + fv + 2, V + 2, tv, w2 - 2, &leftv, &lefttopv);
            y++;
            cy++;
            for (; y < height; y++, cy++) {
                if (bitstream_bpp == 12) {
                    while (2 * cy > y) {
                        read_gray(width);
                        uint8_t* yd = row(0, y);
                        add_median_pred(yd, yd - fy, ty, width, &lefty, &lefttopy);
                        y++;
                    }
                    if (y >= height) break;
                }
                read_422(width);
                uint8_t* yd = row(0, y);
                uint8_t* ud = row(1, cy);
                uint8_t* vd = row(2, cy);
                add_median_pred(yd, yd - fy, ty, width, &lefty, &lefttopy);
                add_median_pred(ud, ud - fu, tu, w2, &leftu, &lefttopu);
                add_median_pred(vd, vd - fv, tv, w2, &leftv, &lefttopv);
            }
            break;
        }
        }
    }

    // decode_slice, versions 0-2 at 24 and 32 bits: BGR0/BGRA lines from
    // the bottom up, left and plane prediction
    void bgr_classic() {
        const int ls = stride[0];
        const int fake = interlaced ? 2 * ls : ls;
        uint8_t* P = plane[0].data();
        const int last = (height - 1) * ls;
        uint8_t left[4];
        if (bitstream_bpp == 32) {
            left[A] = P[last + A] = (uint8_t)gb.get(8);
            left[R] = P[last + R] = (uint8_t)gb.get(8);
            left[G] = P[last + G] = (uint8_t)gb.get(8);
            left[B] = P[last + B] = (uint8_t)gb.get(8);
        } else {
            left[R] = P[last + R] = (uint8_t)gb.get(8);
            left[G] = P[last + G] = (uint8_t)gb.get(8);
            left[B] = P[last + B] = (uint8_t)gb.get(8);
            left[A] = P[last + A] = 255;
            gb.get(8);
        }
        read_bgr(width - 1);
        add_left_pred_bgr32(P + last + 4, temp[0].data(), width - 1, left);
        for (int y = height - 2; y >= 0; y--) {
            read_bgr(width);
            add_left_pred_bgr32(P + (size_t)ls * y, temp[0].data(), width, left);
            if (predictor == PLANE) {
                if (bitstream_bpp != 32) left[A] = 0;
                if (y < height - 1 - interlaced)
                    add_bytes(P + (size_t)ls * y, P + (size_t)ls * y + fake, 4 * width);
            }
        }
    }

    // the frame as cv2 receives it: 0 packed BGR (out[0]), 1 grey (Y in
    // out[0]), 2 YCbCr planes (Y, U, V in out[0..2]; shifts in info)
    int kind() const {
        if (fmt == BGR0 || fmt == BGRA || fmt == GBRP || fmt == GBRAP) return 0;
        if (fmt == GRAY8) return 1;
        return 2;
    }

    void output(uint8_t* a, uint8_t* b, uint8_t* c) const {
        const size_t n = (size_t)width * height;
        if (fmt == BGR0 || fmt == BGRA) {
            for (int y = 0; y < height; y++) {
                const uint8_t* s = plane[0].data() + (size_t)stride[0] * y;
                uint8_t* d = a + (size_t)3 * width * y;
                for (int x = 0; x < width; x++) {
                    d[3 * x] = s[4 * x + B];
                    d[3 * x + 1] = s[4 * x + G];
                    d[3 * x + 2] = s[4 * x + R];
                }
            }
            return;
        }
        if (fmt == GBRP || fmt == GBRAP) {   // planes G, B, R
            for (size_t i = 0; i < n; i++) {
                a[3 * i] = plane[1][i];
                a[3 * i + 1] = plane[0][i];
                a[3 * i + 2] = plane[2][i];
            }
            return;
        }
        std::memcpy(a, plane[0].data(), n);
        if (fmt == GRAY8) return;
        const size_t cn = (size_t)stride[1] * rows[1];
        std::memcpy(b, plane[1].data(), cn);
        std::memcpy(c, plane[2].data(), cn);
    }
};

}  // namespace

extern "C" {

void* hyuv_dec_new(int64_t width, int64_t height) { return new Decoder(int(width), int(height)); }

void hyuv_dec_free(void* h) { delete (Decoder*)h; }

// decode_init from the container's bits per sample and extradata; info
// gets (kind, hshift, vshift, alpha) of the frames to come
int hyuv_dec_init(void* h, int64_t bpc, const uint8_t* ext, int64_t n, int64_t* info,
                  char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->init(int(bpc), ext, n);
        info[0] = d->kind();
        info[1] = d->hshift;
        info[2] = d->vshift;
        info[3] = d->alpha;
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

int hyuv_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->decode(data, n);
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the frame: packed BGR into a, grey into a, or Y, U, V into a, b, c
void hyuv_dec_output(void* h, uint8_t* a, uint8_t* b, uint8_t* c) { ((Decoder*)h)->output(a, b, c); }

int64_t hyuv_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
