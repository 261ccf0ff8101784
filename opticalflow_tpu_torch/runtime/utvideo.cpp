// Ut Video decoded in host C++ as FFmpeg 8's utvideo decoder
// (utvideodec.c, utvideodsp.c, lossless_videodsp.c) decodes it for
// cv2.VideoCapture, bit for bit:
//
//   * the layouts of the 8-bit fourccs: ULRG (G, B-G, R-G planes), ULRA
//     (the same and alpha), ULY0/ULH0 (4:2:0), ULY2/ULH2 (4:2:2),
//     ULY4/ULH4 (4:4:4); the extradata's slice count and flags;
//   * each plane's 256 code lengths (a length of 0: the whole plane is
//     that symbol; 255: no code), the codes as build_huff orders them
//     (longest first, symbols descending within a length), each slice's
//     bits as 32-bit little-endian words read from their top bit;
//   * slices at FFmpeg's row boundaries (height * (slice + 1) / slices,
//     even for 4:2:0 luma), the none, left, gradient and median
//     predictors (restore_median_planar, restore_gradient_planar: each
//     slice's first line left-predicted from 0x80, its first column from
//     the row above), and GBR's restore_rgb_planes.
//
// An RGB frame comes out as packed BGR (swscale's GBR(A)P -> BGR24 copy,
// alpha dropped), YCbCr as its planes.  The 10-bit UQ** family, the
// packed UM** family and interlaced streams raise lossless::UNSUPPORTED
// naming what; damaged data (slice offsets past the packet, a plane with no
// code, bits run out) raises lossless::CORRUPT.
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
using lossless::mid_pred;
using lossless::unsupported;

enum { PRED_NONE = 0, PRED_LEFT = 1, PRED_GRADIENT = 2, PRED_MEDIAN = 3 };

// the decoder's feature bits (utvideo.py's FEATURES, in order)
enum Feature {
    F_NONE, F_LEFT, F_GRADIENT, F_MEDIAN, F_SLICES, F_SINGLE_SYMBOL, F_RGB, F_ALPHA,
    F_YUV420, F_YUV422, F_YUV444, F_BT709
};

inline uint32_t rl32(const uint8_t* p) {
    return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}

// build_huff's code: lengths 1-32 by symbol (255: none), codes assigned
// in order of descending length, then descending symbol
// (ff_vlc_init_from_lengths)
PrefixCode huffman(const uint8_t* lens) {
    std::vector<std::pair<int, int>> order;   // (length, symbol)
    for (int s = 0; s < 256; s++)
        if (lens[s] != 255) order.push_back({lens[s], s});
    std::sort(order.begin(), order.end(), [](const auto& a, const auto& b) {
        return a.first != b.first ? a.first > b.first : a.second > b.second;
    });
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

struct Decoder {
    int width, height;
    int planes = 3, hshift = 0, vshift = 0, slices = 1, rgb = 0, bt709 = 0;
    bool yuv420 = false;
    std::vector<uint8_t> plane[4];
    std::vector<uint8_t> packet, bits;
    int64_t features = 0;

    Decoder(int w, int h) : width(w), height(h) {}

    void set(Feature f) { features |= int64_t(1) << f; }

    // decode_init: the layout by fourcc, the slices and flags by extradata
    void init(const char* tag, const uint8_t* ext, int64_t n) {
        const std::string t(tag, 4);
        if (t == "ULRG") { planes = 3; rgb = 1; }
        else if (t == "ULRA") { planes = 4; rgb = 1; }
        else if (t == "ULY0" || t == "ULH0") { hshift = vshift = 1; yuv420 = true; }
        else if (t == "ULY2" || t == "ULH2") { hshift = 1; }
        else if (t == "ULY4" || t == "ULH4") {}
        else if (t.compare(0, 2, "UQ") == 0) unsupported("10-bit Ut Video Pro (" + t + ")");
        else if (t.compare(0, 2, "UM") == 0) unsupported("packed Ut Video (" + t + ")");
        else corrupt("the fourcc " + t);
        bt709 = t[2] == 'H';
        if ((width & ((1 << hshift) - 1)) || (height & ((1 << vshift) - 1)))
            corrupt("odd dimensions in a subsampled layout (FFmpeg refuses them)");
        if (n < 16) corrupt("extradata of fewer than 16 bytes");
        const uint32_t frame_info_size = rl32(ext + 8), flags = rl32(ext + 12);
        if (frame_info_size != 4) unsupported("frame information of other than 4 bytes");
        slices = (int)(flags >> 24) + 1;
        if (flags & 0x800) unsupported("interlaced coding");
        for (int i = 0; i < planes; i++) {
            const bool sub = !rgb && (i == 1 || i == 2);
            plane[i].assign((size_t)(sub ? width >> hshift : width) * (sub ? height >> vshift : height), 0);
        }
        if (slices > 1) set(F_SLICES);
        set(rgb ? F_RGB : yuv420 ? F_YUV420 : hshift ? F_YUV422 : F_YUV444);
        if (planes == 4) set(F_ALPHA);
        if (bt709) set(F_BT709);
    }

    // decode_plane: the Huffman-coded residuals (left-predicted within
    // each slice where use_pred) of one plane
    void decode_plane(int no, uint8_t* dst, int w, int h, const uint8_t* src, bool use_pred) {
        const int cmask = ~(no == 0 && yuv420 ? 1 : 0);
        const uint8_t* lens = src;
        int fsym = -1;
        for (int i = 0; i < 256; i++) {
            if (lens[i] == 0) {
                fsym = i;
                break;
            }
            if (lens[i] != 255 && lens[i] > 32) corrupt("a code length over 32");
        }
        if (fsym >= 0) {   // the whole plane is one symbol
            set(F_SINGLE_SYMBOL);
            int send = 0;
            for (int s = 0; s < slices; s++) {
                const int sstart = send;
                send = (h * (s + 1) / slices) & cmask;
                int prev = 0x80;
                for (int j = sstart; j < send; j++) {
                    uint8_t* d = dst + (size_t)j * w;
                    for (int i = 0; i < w; i++) {
                        int pix = fsym;
                        if (use_pred) {
                            prev = (prev + pix) & 0xFF;
                            pix = prev;
                        }
                        d[i] = (uint8_t)pix;
                    }
                }
            }
            return;
        }
        bool any = false;
        for (int i = 0; i < 256; i++) any |= lens[i] != 255;
        if (!any) corrupt("a plane with no code");
        const PrefixCode vlc = huffman(lens);
        src += 256;
        int send = 0;
        for (int s = 0; s < slices; s++) {
            const int sstart = send;
            send = (h * (s + 1) / slices) & cmask;
            const uint32_t start = s ? rl32(src + 4 * s - 4) : 0, end = rl32(src + 4 * s);
            const int64_t size = (int64_t)end - start;
            if (size <= 0) corrupt("an empty slice in a plane of more than one symbol");
            const uint8_t* data = src + 4 * slices + start;
            lossless::swap_words(data, (size + 3) & ~int64_t(3), bits);
            Bits gb;
            gb.init(bits.data(), size);
            int prev = 0x80;
            for (int j = sstart; j < send; j++) {
                uint8_t* d = dst + (size_t)j * w;
                for (int i = 0; i < w; i++) {
                    int pix = vlc.read(gb);
                    if (use_pred) {
                        prev = (prev + pix) & 0xFF;
                        pix = prev;
                    }
                    d[i] = (uint8_t)pix;
                }
                if (gb.left() < 0) corrupt("a slice ran out of bits");
            }
        }
    }

    // the slices of restore_*_planar: rmode rounds 4:2:0 luma rows to pairs
    void slice_rows(int h, int s, bool rmode, int* start, int* rows) const {
        const int cmask = ~(rmode ? 1 : 0);
        *start = (s * h / slices) & cmask;
        *rows = (((s + 1) * h / slices) & cmask) - *start;
    }

    void restore_median(uint8_t* src, int w, int h, bool rmode) {
        for (int s = 0; s < slices; s++) {
            int start, rows;
            slice_rows(h, s, rmode, &start, &rows);
            if (!rows) continue;
            uint8_t* b = src + (size_t)start * w;
            b[0] = (uint8_t)(b[0] + 0x80);   // first line: left from 0x80
            for (int i = 1; i < w; i++) b[i] = (uint8_t)(b[i] + b[i - 1]);
            b += w;
            if (rows <= 1) continue;
            // second line: the first sample from above, the rest median
            int C = b[-w];
            b[0] = (uint8_t)(b[0] + C);
            int A = b[0], B = 0;
            for (int i = 1; i < w; i++) {
                B = b[i - w];
                b[i] = (uint8_t)(b[i] + mid_pred(A, B, (uint8_t)(A + B - C)));
                C = B;
                A = b[i];
            }
            b += w;
            // the rest continue the median from the line's end
            for (int j = 2; j < rows; j++) {
                add_median_pred(b, b - w, b, w, &A, &B);
                b += w;
            }
        }
    }

    void restore_gradient(uint8_t* src, int w, int h, bool rmode) {
        for (int s = 0; s < slices; s++) {
            int start, rows;
            slice_rows(h, s, rmode, &start, &rows);
            if (!rows) continue;
            uint8_t* b = src + (size_t)start * w;
            b[0] = (uint8_t)(b[0] + 0x80);
            for (int i = 1; i < w; i++) b[i] = (uint8_t)(b[i] + b[i - 1]);
            b += w;
            for (int j = 1; j < rows; j++) {
                b[0] = (uint8_t)(b[0] + b[-w]);
                for (int i = 1; i < w; i++)
                    b[i] = (uint8_t)(b[i - w] - b[i - w - 1] + b[i - 1] + b[i]);
                b += w;
            }
        }
    }

    void decode(const uint8_t* data, int64_t n) {
        // a padded copy: a slice's last word is read whole (bswap_buf)
        packet.assign(data, data + n);
        packet.resize((size_t)n + 16, 0);
        const uint8_t* buf = packet.data();
        const uint8_t* start[4];
        int64_t pos = 0;
        for (int i = 0; i < planes; i++) {
            start[i] = buf + pos;
            if (n - pos < 256 + 4 * (int64_t)slices) corrupt("a plane past the packet");
            pos += 256;
            int64_t s0 = 0, s1 = 0;
            for (int j = 0; j < slices; j++) {
                s1 = rl32(buf + pos);
                pos += 4;
                if (s1 < s0 || n - pos < s1) corrupt("a slice past the packet");
                s0 = s1;
            }
            pos += s1;
        }
        if (n - pos < 4) corrupt("no frame information");
        const uint32_t info = rl32(buf + pos);
        const int pred = (info >> 8) & 3;
        set(pred == PRED_NONE ? F_NONE : pred == PRED_LEFT ? F_LEFT
            : pred == PRED_GRADIENT ? F_GRADIENT : F_MEDIAN);
        for (int i = 0; i < planes; i++) {
            const bool sub = !rgb && (i == 1 || i == 2);
            const int w = sub ? width >> hshift : width, h = sub ? height >> vshift : height;
            const bool rmode = i == 0 && yuv420;
            decode_plane(i, plane[i].data(), w, h, start[i], pred == PRED_LEFT);
            if (pred == PRED_MEDIAN) restore_median(plane[i].data(), w, h, rmode);
            else if (pred == PRED_GRADIENT) restore_gradient(plane[i].data(), w, h, rmode);
        }
        if (rgb) {   // restore_rgb_planes: planes G, B, R
            uint8_t *g = plane[0].data(), *b = plane[1].data(), *r = plane[2].data();
            for (size_t i = 0, m = (size_t)width * height; i < m; i++) {
                r[i] = (uint8_t)(r[i] + g[i] - 0x80);
                b[i] = (uint8_t)(b[i] + g[i] - 0x80);
            }
        }
    }

    void output(uint8_t* a, uint8_t* b, uint8_t* c) const {
        if (rgb) {
            const size_t m = (size_t)width * height;
            for (size_t i = 0; i < m; i++) {
                a[3 * i] = plane[1][i];
                a[3 * i + 1] = plane[0][i];
                a[3 * i + 2] = plane[2][i];
            }
            return;
        }
        std::memcpy(a, plane[0].data(), plane[0].size());
        std::memcpy(b, plane[1].data(), plane[1].size());
        std::memcpy(c, plane[2].data(), plane[2].size());
    }
};

}  // namespace

extern "C" {

void* ut_dec_new(int64_t width, int64_t height) { return new Decoder(int(width), int(height)); }

void ut_dec_free(void* h) { delete (Decoder*)h; }

// decode_init from the fourcc and the extradata; info gets (rgb, hshift,
// vshift, bt709)
int ut_dec_init(void* h, const char* tag, const uint8_t* ext, int64_t n, int64_t* info,
                char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->init(tag, ext, n);
        info[0] = d->rgb;
        info[1] = d->hshift;
        info[2] = d->vshift;
        info[3] = d->bt709;
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

int ut_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->decode(data, n);
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the frame: packed BGR into a, or Y, U, V into a, b, c
void ut_dec_output(void* h, uint8_t* a, uint8_t* b, uint8_t* c) { ((Decoder*)h)->output(a, b, c); }

int64_t ut_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
