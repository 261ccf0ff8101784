// MagicYUV decoded in host C++ as FFmpeg 8's magicyuv decoder (magicyuv.c,
// lossless_videodsp.c) decodes it for cv2.VideoCapture, bit for bit:
//
//   * the MAGY frame header of version 7: the format byte (the 8-bit
//     layouts GBRP 0x65, GBRAP 0x66, YUV 4:4:4 0x67, 4:2:2 0x68, 4:2:0
//     0x69, YUVA 4:4:4 0x6a, grey 0x6b), the colour matrix and flags
//     bytes (BT.601/BT.709, full range), the width, height, slice width
//     and slice height, each plane's slice offsets;
//   * the Huffman tables, one a plane: code lengths of 1-32 with run
//     lengths (a byte's top bit: a count follows), the codes assigned
//     longest first, symbols ascending within a length (huff_build,
//     ff_vlc_init_from_lengths), each slice's bits read from the top bit of
//     each byte;
//   * each slice's flags byte (bit 0: the samples raw) and predictor byte:
//     left (each line left-predicted, its first sample from the one above),
//     gradient (the first sample from above, the rest left + top -
//     topleft) or median (lossless_videodsp's add_median_pred), each
//     slice's first line left-predicted from 0; another predictor byte
//     leaves the residuals as they are, as FFmpeg does;
//   * the RGB layouts' planes B-G, G, R-G restored by adding G (no 0x80
//     offset), and handed over in G, B, R order.
//
// An RGB frame comes out as packed BGR (swscale's GBR(A)P -> BGR24 copy,
// alpha dropped), grey as its plane, YCbCr as its planes.  The 10-, 12- and
// 14-bit layouts and interlaced frames raise lossless::UNSUPPORTED naming
// what; damaged data (a header or slice past the packet, a table that
// does not fill its plane's symbols, bits run out) raises
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

enum { PRED_LEFT = 1, PRED_GRADIENT = 2, PRED_MEDIAN = 3 };

// the decoder's feature bits (magicyuv.py's FEATURES, in order)
enum Feature {
    F_LEFT, F_GRADIENT, F_MEDIAN, F_OTHER_PRED, F_RAW_SLICE, F_SLICES, F_GBRP, F_GBRAP,
    F_YUV444, F_YUV422, F_YUV420, F_YUVA444, F_GRAY, F_BT709, F_FULL_RANGE, F_ODD_SIZE
};

inline uint32_t rl32(const uint8_t* p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}

// huff_build: lengths by symbol, codes in order of descending length,
// then ascending symbol
PrefixCode huffman(const uint8_t* lens) {
    std::vector<std::pair<int, int>> order;   // (length, symbol)
    for (int s = 0; s < 256; s++) order.push_back({lens[s], s});
    std::stable_sort(order.begin(), order.end(),
                     [](const auto& a, const auto& b) { return a.first > b.first; });
    std::vector<PrefixCode::Code> list;
    uint64_t code = 0;   // left-aligned in 32 bits
    for (const auto& [l, s] : order) {
        if (code >> 32) corrupt("code lengths that overflow a Huffman code");
        list.push_back({(uint32_t)(code >> (32 - l)), l, s});
        code += uint64_t(1) << (32 - l);
    }
    PrefixCode out;
    out.build(list);
    return out;
}

struct Slice {
    int64_t start, size;
};

struct Decoder {
    int width = 0, height = 0;
    int format = -1, planes = 0, hshift = 0, vshift = 0, slice_height = 0, nb_slices = 0;
    bool decorrelate = false, bt709 = false, full_range = false;
    std::vector<uint8_t> plane[4];   // pw(i) wide, rows as the slices reach
    std::vector<Slice> slices[4];
    std::vector<uint8_t> packet;
    uint8_t lens[4][256];
    int64_t features = 0;

    void set(Feature f) { features |= int64_t(1) << f; }

    int pw(int i) const { return (i == 1 || i == 2) ? (width + (1 << hshift) - 1) >> hshift : width; }
    int ph(int i) const { return (i == 1 || i == 2) ? (height + (1 << vshift) - 1) >> vshift : height; }

    // the format byte's layout (FFmpeg's pixel format): 8-bit ones read
    void layout(int f) {
        hshift = vshift = 0;
        decorrelate = false;
        switch (f) {
            case 0x65: planes = 3; decorrelate = true; set(F_GBRP); break;
            case 0x66: planes = 4; decorrelate = true; set(F_GBRAP); break;
            case 0x67: planes = 3; set(F_YUV444); break;
            case 0x68: planes = 3; hshift = 1; set(F_YUV422); break;
            case 0x69: planes = 3; hshift = vshift = 1; set(F_YUV420); break;
            case 0x6a: planes = 4; set(F_YUVA444); break;
            case 0x6b: planes = 1; set(F_GRAY); break;
            case 0x6c: case 0x6d: case 0x6e: case 0x73: case 0x76: case 0x7b:
                unsupported("10-bit samples (format byte " + std::to_string(f) + ")");
            case 0x6f: case 0x70: case 0x74: case 0x75:
                unsupported("12-bit samples (format byte " + std::to_string(f) + ")");
            case 0x71: case 0x72:
                unsupported("14-bit samples (format byte " + std::to_string(f) + ")");
            default:
                corrupt("the format byte " + std::to_string(f));
        }
    }

    // build_huffman: run-length coded lengths, one table a plane
    void tables(const uint8_t* t, int64_t n) {
        int i = 0, j = 0;
        int64_t p = 0;
        while (p < n) {
            const int b = t[p] & 0x80, x = t[p] & 0x7F;
            p++;
            int l = 1;
            if (b) {
                if (p >= n) break;
                l += t[p++];
            }
            const int k = j + l;
            if (k > 256 || x == 0 || x > 32) corrupt("invalid Huffman code lengths");
            for (; j < k; j++) lens[i][j] = (uint8_t)x;
            if (j == 256) {
                j = 0;
                if (++i == planes) break;
            }
        }
        if (i != planes) corrupt("Huffman tables too short");
    }

    void decode(const uint8_t* data, int64_t n) {
        // a padded copy: the bit reader looks 8 bytes past where it reads
        packet.assign(data, data + n);
        packet.resize((size_t)n + 16, 0);
        const uint8_t* d = packet.data();
        if (n < 36) corrupt("a packet shorter than the frame header");
        if (rl32(d) != 0x5947414D) corrupt("no MAGY tag");
        const uint32_t header_size = rl32(d + 4);
        if (header_size < 32 || header_size >= n) corrupt("a header past the packet");
        if (d[8] != 7) corrupt("a frame header of version " + std::to_string(d[8]) + " (FFmpeg reads version 7)");
        if (d[9] != format) {
            if (format >= 0) corrupt("a format that changes from frame to frame");
            format = d[9];
            layout(format);
        }
        const int matrix = d[11], flags = d[12];
        if (flags & 2) unsupported("interlaced frames");
        const bool yuv = !decorrelate;
        bt709 = yuv && matrix == 2;
        full_range = yuv && (flags & 4);
        if (bt709) set(F_BT709);
        if (full_range) set(F_FULL_RANGE);
        const uint32_t w = rl32(d + 16), h = rl32(d + 20);
        if (!w || !h || w > 16384 || h > 16384) corrupt("a frame of size " + std::to_string(w) + "x" + std::to_string(h));
        if ((int)w != width || (int)h != height) {
            if (width) corrupt("a size that changes from frame to frame");
            width = (int)w;
            height = (int)h;
            if ((width & 1) || (height & 1)) set(F_ODD_SIZE);
        }
        if (rl32(d + 24) != w) corrupt("a slice width other than the frame's (FFmpeg refuses it)");
        const uint32_t sh = rl32(d + 28);
        if (!sh || sh > 0x7FFFFFFF - h) corrupt("a slice height of " + std::to_string(sh));
        slice_height = (int)sh;
        nb_slices = (height + slice_height - 1) / slice_height;
        if (nb_slices > 1) set(F_SLICES);
        for (int i = 0; i < planes; i++) {   // an odd chroma slice height runs past the plane
            const int vs = (i == 1 || i == 2) ? vshift : 0;
            const int sheight = (slice_height + (1 << vs) - 1) >> vs;
            const int last = (height - (nb_slices - 1) * slice_height + (1 << vs) - 1) >> vs;
            const size_t need = (size_t)pw(i) * std::max((nb_slices - 1) * sheight + last, ph(i));
            if (plane[i].size() < need) plane[i].resize(need, 0);
        }
        int64_t pos = 36;
        if (n - pos <= (int64_t)nb_slices * planes * 5) corrupt("slice offsets past the packet");
        uint32_t first = 0;
        for (int i = 0; i < planes; i++) {
            slices[i].resize(nb_slices);
            uint32_t offset = rl32(d + pos);
            pos += 4;
            if (offset >= n - header_size) corrupt("a slice past the packet");
            if (i == 0) first = offset;
            int j = 0;
            for (; j < nb_slices - 1; j++) {
                slices[i][j].start = offset + header_size;
                const uint32_t next = rl32(d + pos);
                pos += 4;
                if (next <= offset || next >= n - header_size) corrupt("a slice past the packet");
                slices[i][j].size = next - offset;
                if (slices[i][j].size < 2) corrupt("a slice of fewer than 2 bytes");
                offset = next;
            }
            slices[i][j].start = offset + header_size;
            slices[i][j].size = n - slices[i][j].start;
            if (slices[i][j].size < 2) corrupt("a slice of fewer than 2 bytes");
        }
        if (d[pos] != planes) corrupt("a plane count that does not match the format");
        pos += 1 + (int64_t)nb_slices * planes;
        const int64_t table = (int64_t)header_size + first - pos;
        if (table < 2) corrupt("no Huffman tables");
        tables(d + pos, table);
        PrefixCode vlc[4];
        for (int i = 0; i < planes; i++) vlc[i] = huffman(lens[i]);
        for (int j = 0; j < nb_slices; j++) decode_slice(d, j, vlc);
    }

    // magy_decode_slice at 8 bits, one slice of every plane
    void decode_slice(const uint8_t* d, int j, const PrefixCode* vlc) {
        for (int i = 0; i < planes; i++) {
            const int vs = (i == 1 || i == 2) ? vshift : 0;
            const int height_j = (std::min(slice_height, height - j * slice_height) + (1 << vs) - 1) >> vs;
            const int w = pw(i);
            const int sheight = (slice_height + (1 << vs) - 1) >> vs;
            const uint8_t* s = d + slices[i][j].start;
            const int64_t size = slices[i][j].size;
            const int flags = s[0], pred = s[1];
            s += 2;
            uint8_t* dst0 = plane[i].data() + (size_t)j * sheight * w;
            uint8_t* dst = dst0;
            if (flags & 1) {
                set(F_RAW_SLICE);
                if (size - 2 < (int64_t)w * height_j) corrupt("a raw slice short of its samples");
                std::memcpy(dst, s, (size_t)w * height_j);
            } else {
                Bits gb;
                gb.init(s, size - 2);
                for (int k = 0; k < height_j; k++, dst += w)
                    for (int x = 0; x < w; x++) {
                        if (gb.left() <= 0) corrupt("a slice ran out of bits");
                        dst[x] = (uint8_t)vlc[i].read(gb);
                    }
            }
            dst = dst0;
            switch (pred) {
                case PRED_LEFT:
                    set(F_LEFT);
                    left_line(dst, w, 0);
                    for (int k = 1; k < height_j; k++) {
                        dst += w;
                        left_line(dst, w, dst[-w]);
                    }
                    break;
                case PRED_GRADIENT:
                    set(F_GRADIENT);
                    left_line(dst, w, 0);
                    for (int k = 1; k < height_j; k++) {
                        dst += w;
                        int left = dst[-w] + dst[0];
                        dst[0] = (uint8_t)left;
                        for (int x = 1; x < w; x++) {
                            left += dst[x - w] - dst[x - w - 1] + dst[x];
                            dst[x] = (uint8_t)left;
                        }
                    }
                    break;
                case PRED_MEDIAN: {
                    set(F_MEDIAN);
                    left_line(dst, w, 0);
                    int left = dst[0], lefttop = dst[0];
                    for (int k = 1; k < height_j; k++) {
                        dst += w;
                        add_median_pred(dst, dst - w, dst, w, &left, &lefttop);
                        left = lefttop = dst[0];
                    }
                    break;
                }
                default:
                    set(F_OTHER_PRED);   // FFmpeg asks for a sample and leaves the residuals
            }
        }
        if (decorrelate) {   // planes B-G, G, R-G
            const size_t at = (size_t)j * slice_height * width;
            const int rows = std::min(slice_height, height - j * slice_height);
            uint8_t *b = plane[0].data() + at, *g = plane[1].data() + at, *r = plane[2].data() + at;
            for (size_t k = 0, m = (size_t)rows * width; k < m; k++) {
                b[k] = (uint8_t)(b[k] + g[k]);
                r[k] = (uint8_t)(r[k] + g[k]);
            }
        }
    }

    // add_left_pred: a running sum from acc
    static void left_line(uint8_t* p, int w, int acc) {
        for (int x = 0; x < w; x++) {
            acc += p[x];
            p[x] = (uint8_t)acc;
        }
    }

    // the frame: packed BGR into a (planes B, G, R), grey into a, or the
    // YCbCr planes into a, b, c
    void output(uint8_t* a, uint8_t* b, uint8_t* c) const {
        if (decorrelate) {
            const size_t m = (size_t)width * height;
            for (size_t i = 0; i < m; i++) {
                a[3 * i] = plane[0][i];
                a[3 * i + 1] = plane[1][i];
                a[3 * i + 2] = plane[2][i];
            }
            return;
        }
        std::memcpy(a, plane[0].data(), (size_t)width * height);
        if (planes == 1) return;
        std::memcpy(b, plane[1].data(), (size_t)pw(1) * ph(1));
        std::memcpy(c, plane[2].data(), (size_t)pw(2) * ph(2));
    }
};

int fail(const Failure& f, char* msg, int64_t cap) {
    lossless::put_msg(msg, cap, f.msg);
    return f.kind;
}

}  // namespace

extern "C" {

void* magy_dec_new() { return new Decoder(); }

void magy_dec_free(void* h) { delete (Decoder*)h; }

// Decode one packet; info gets (width, height, layout: 0 RGB, 1 grey, 2
// YCbCr, 3 YCbCr with alpha; hshift, vshift, bt709, full range)
int magy_dec_decode(void* h, const uint8_t* data, int64_t n, int64_t* info, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->decode(data, n);
    } catch (const Failure& f) {
        return fail(f, msg, cap);
    }
    info[0] = d->width;
    info[1] = d->height;
    info[2] = d->decorrelate ? 0 : d->planes == 1 ? 1 : d->planes == 4 ? 3 : 2;
    info[3] = d->hshift;
    info[4] = d->vshift;
    info[5] = d->bt709;
    info[6] = d->full_range;
    return lossless::OK;
}

void magy_dec_output(void* h, uint8_t* a, uint8_t* b, uint8_t* c) { ((Decoder*)h)->output(a, b, c); }

int64_t magy_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
