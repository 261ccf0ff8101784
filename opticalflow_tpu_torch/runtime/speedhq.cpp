// SpeedHQ video (fourcc SHQ0 in AVI, Matroska's V_MS/VFW/FOURCC,
// QuickTime, NUT and ASF: what cv2.VideoWriter writes through libavcodec's
// speedhq encoder), decoded in host C++ as FFmpeg 8's speedhq decoder
// (speedhqdec.c, speedhq.c) decodes it for cv2.VideoCapture, bit for bit:
//
//   * the frame header: the quality byte (the quantiser is 100 - quality)
//     and the 24-bit little-endian offset of the second field; an offset of
//     4, or of the packet's size less 4, codes one field: a progressive
//     picture, what the encoder writes;
//   * the field's four slices, each a 24-bit length then its bits: slice k
//     holds the macroblock rows k, k + 4, k + 8, ... of 16 lines, each row
//     of 16x16 macroblocks of four luma and two chroma 8x8 blocks (4:2:0),
//     the DC predictors reset to 1024 at each row; the lengths of the
//     first three slices are checked (at least 3, inside the packet), so a
//     picture of fewer than 64 lines, whose empty slices libavcodec's
//     encoder writes with length 0, fails as it fails in FFmpeg;
//   * every field read from each byte's lowest bit (FFmpeg's little-endian
//     reader): the DC sizes by MPEG-1/2's codes (mpeg_common.h's kDcLuma
//     and kDcChroma, read in the order they are written), the DC
//     differential subtracted from its predictor ("opposite of most
//     codecs"), then (run, level) codes of SpeedHQ's own table (speedhq.c's
//     ff_speedhq_vlc_table, run and level, read out of cv2's bundled
//     libavcodec: MPEG-2's table B-15 with other runs and levels) with a
//     sign bit, a 6-bit run and 12-bit level escape and an end of block;
//   * dequantisation: level x the MPEG-1 default intra matrix at the scan
//     position (its DC entry 16; mpeg_common.h's kDefaultIntra) x the
//     quantiser >> 4, stored as int16, the DC unscaled; the zigzag scan;
//     FFmpeg's simple IDCT (ffmpeg_dsp.h) into yuv420p planes of whole
//     macroblocks, cropped to the container's size.
//
// SHQ1-SHQ9 (4:2:2, 4:4:4, alpha), two fields (interlaced pictures) and a
// width not a multiple of 16 raise kUnsupported; a width not a multiple of 8, a damaged header or slice
// raises kCorrupt, where FFmpeg's decoder fails too.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "mpeg_common.h"

namespace {

using mpegc::Code;
using mpegc::Failure;
using mpegc::Vlc;

// the decoder's feature bits (speedhq.py's FEATURES, in order)
enum Feature { F_ESCAPE, F_PARTIAL_ROW };

// ff_speedhq_vlc_table: the 121 (run, level) codes as FFmpeg lists them
// (little-endian: the first bit read is the lowest), then the escape and
// the end of block
const Code kAc[123] = {
    {0x0001, 2}, {0x0003, 3}, {0x000E, 4}, {0x0007, 5}, {0x0017, 5}, {0x0028, 6},
    {0x0008, 6}, {0x006F, 7}, {0x001F, 7}, {0x00C4, 8}, {0x0044, 8}, {0x005F, 8},
    {0x00DF, 8}, {0x007F, 8}, {0x00FF, 8}, {0x3E00, 14}, {0x1E00, 14}, {0x2E00, 14},
    {0x0E00, 14}, {0x3600, 14}, {0x1600, 14}, {0x2600, 14}, {0x0600, 14}, {0x3A00, 14},
    {0x1A00, 14}, {0x2A00, 14}, {0x0A00, 14}, {0x3200, 14}, {0x1200, 14}, {0x2200, 14},
    {0x0200, 14}, {0x0C00, 15}, {0x7400, 15}, {0x3400, 15}, {0x5400, 15}, {0x1400, 15},
    {0x6400, 15}, {0x2400, 15}, {0x4400, 15}, {0x0400, 15}, {0x0002, 3}, {0x000C, 5},
    {0x004F, 7}, {0x00E4, 8}, {0x0004, 8}, {0x0D00, 13}, {0x1500, 13}, {0x7C00, 15},
    {0x3C00, 15}, {0x5C00, 15}, {0x1C00, 15}, {0x6C00, 15}, {0x2C00, 15}, {0x4C00, 15},
    {0xC800, 16}, {0x4800, 16}, {0x8800, 16}, {0x0800, 16}, {0x0300, 13}, {0x1D00, 13},
    {0x0014, 5}, {0x0070, 7}, {0x003F, 8}, {0x00C0, 10}, {0x0500, 13}, {0x0180, 12},
    {0x0280, 12}, {0x0C80, 12}, {0x0080, 12}, {0x0B00, 13}, {0x1300, 13}, {0x001C, 5},
    {0x0064, 8}, {0x0380, 12}, {0x1900, 13}, {0x0D80, 12}, {0x0018, 6}, {0x00BF, 8},
    {0x0480, 12}, {0x0B80, 12}, {0x0038, 6}, {0x0040, 9}, {0x0900, 13}, {0x0030, 7},
    {0x0780, 12}, {0x2800, 16}, {0x0010, 7}, {0x0A80, 12}, {0x0050, 7}, {0x0880, 12},
    {0x000F, 7}, {0x1100, 13}, {0x002F, 7}, {0x0100, 13}, {0x0084, 8}, {0x5800, 16},
    {0x00A4, 8}, {0x9800, 16}, {0x0024, 8}, {0x1800, 16}, {0x0140, 9}, {0xE800, 16},
    {0x01C0, 9}, {0x6800, 16}, {0x02C0, 10}, {0xA800, 16}, {0x0F80, 12}, {0x0580, 12},
    {0x0980, 12}, {0x0E80, 12}, {0x0680, 12}, {0x1F00, 13}, {0x0F00, 13}, {0x1700, 13},
    {0x0700, 13}, {0x1B00, 13}, {0xF800, 16}, {0x7800, 16}, {0xB800, 16}, {0x3800, 16},
    {0xD800, 16}, {0x0020, 6}, {0x0006, 4}};
constexpr int kEscape = 121, kEob = 122;
// ff_speedhq_run, ff_speedhq_level
const uint8_t kRun[121] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4,
    5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13,
    14, 14, 15, 15, 16, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31};
const uint8_t kLevel[121] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 1, 2, 3, 4, 5, 1, 2, 3, 4,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1};

struct Tables {
    Vlc dc_luma, dc_chroma, ac;
    Tables() {
        dc_luma.build(mpegc::kDcLuma, 12, 9);
        dc_chroma.build(mpegc::kDcChroma, 12, 10);
        // the AC codes in the order they are read (each reversed)
        Code rev[123];
        for (int i = 0; i < 123; i++) {
            unsigned v = 0;
            for (int b = 0; b < kAc[i].bits; b++) v |= (kAc[i].code >> b & 1u) << (kAc[i].bits - 1 - b);
            rev[i] = Code{(uint16_t)v, kAc[i].bits};
        }
        ac.build(rev, 123, 16);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// FFmpeg's little-endian bit reader over a slice (zeros past its end)
struct Bits {
    const uint8_t* p = nullptr;
    int64_t size = 0, pos = 0;   // bits
    unsigned bit() {
        const unsigned v = pos < size ? p[pos >> 3] >> (pos & 7) & 1 : 0;
        pos++;
        return v;
    }
    // n bits, the first read the lowest (get_bits on the LE reader)
    unsigned le(int n) {
        unsigned v = 0;
        for (int i = 0; i < n; i++) v |= bit() << i;
        return v;
    }
    // a VLC: the next bits in the order they are read against MSB-first codes
    int vlc(const Vlc& t) {
        unsigned v = 0;
        const int64_t at = pos;
        for (int i = 0; i < t.bits; i++) v = v << 1 | bit();
        const int s = t.sym[v];
        if (s < 0) CORRUPT("an invalid VLC code");
        pos = at + t.len[v];
        return s;
    }
};

struct Decoder {
    int width, height, cw, ch;   // the container's size, the chroma planes'
    int mb_w;
    std::vector<uint8_t> planes[3];
    int stride[3];
    int quant[64];
    int64_t features = 0;

    Decoder(int w, int h) : width(w), height(h) {
        if (w <= 0 || h <= 0 || (int64_t)(w + 128) * (h + 128) >= INT32_MAX / 8) w = h = width = height = 0;
        mb_w = (w + 15) / 16;
        cw = (w + 1) / 2;
        ch = (h + 1) / 2;
        stride[0] = mb_w * 16;
        stride[1] = stride[2] = mb_w * 8;
        // whole macroblock rows, as FFmpeg's padded buffers hold them
        const int rows = (h + 15) / 16 * 16;
        planes[0].assign((size_t)stride[0] * rows, 0);
        planes[1].assign((size_t)stride[1] * rows / 2, 0);
        planes[2].assign(planes[1].size(), 0);
    }

    // decode_dc_le, then the AC codes (decode_dct_block)
    void block(Bits& gb, int* last_dc, int comp, uint8_t* dest, int linesize) {
        const Tables& t = tables();
        int16_t blk[64] = {0};
        const int code = gb.vlc(comp == 0 ? t.dc_luma : t.dc_chroma);
        int diff = 0;
        if (code) {
            const unsigned v = gb.le(code);
            diff = v >> (code - 1) & 1 ? (int)v : (int)v - (int)((1u << code) - 1);
        }
        last_dc[comp] -= diff;
        blk[0] = (int16_t)last_dc[comp];
        int i = 0;
        for (;;) {
            const int s = gb.vlc(t.ac);
            if (s == kEob) break;
            int level;
            if (s == kEscape) {
                features |= 1 << F_ESCAPE;
                i += (int)gb.le(6) + 1;
                level = (int)gb.le(12) - 2048;
            } else {
                i += kRun[s] + 1;
                level = kLevel[s];
                if (gb.bit()) level = -level;
            }
            if (i > 63) CORRUPT("a coefficient past the block");
            const int pos = mpegc::kZigzag[i];
            blk[pos] = (int16_t)((level * quant[i]) >> 4);
        }
        ffdsp::idct(blk, dest, linesize, false);
    }

    // decode_speedhq_field for a progressive picture: its four slices
    void field(const uint8_t* buf, int64_t size, int64_t start, int64_t end) {
        if (end < start || end - start < 3 || end > size) CORRUPT("a field out of the packet");
        int64_t off[5];
        off[0] = start;
        off[4] = end;
        for (int k = 1; k < 4; k++) {
            const int64_t last = off[k - 1];
            const uint32_t len = buf[last] | buf[last + 1] << 8 | buf[last + 2] << 16;
            off[k] = last + len;
            if (len < 3 || off[k] > end - 3) CORRUPT("a slice length out of the field");
        }
        for (int k = 0; k < 4; k++) {
            Bits gb;
            gb.p = buf + off[k] + 3;
            gb.size = (off[k + 1] - off[k] - 3) * 8;
            for (int y = k * 16; y < height; y += 64) {
                int last_dc[4] = {1024, 1024, 1024, 1024};
                uint8_t* dy = planes[0].data() + (size_t)stride[0] * y;
                uint8_t* du = planes[1].data() + (size_t)stride[1] * (y / 2);
                uint8_t* dv = planes[2].data() + (size_t)stride[2] * (y / 2);
                const int ly = stride[0], lc = stride[1];
                for (int x = 0; x < width; x += 16) {
                    block(gb, last_dc, 0, dy, ly);
                    block(gb, last_dc, 0, dy + 8, ly);
                    block(gb, last_dc, 0, dy + 8 * ly, ly);
                    block(gb, last_dc, 0, dy + 8 * ly + 8, ly);
                    block(gb, last_dc, 1, du, lc);
                    block(gb, last_dc, 2, dv, lc);
                    dy += 16;
                    du += 8;
                    dv += 8;
                }
            }
        }
    }

    void decode(const uint8_t* buf, int64_t size) {
        if (size < 4 || width < 8 || width % 8) CORRUPT("a packet shorter than its header, or a width not a multiple of 8");
        if (height <= 0 || (int64_t)(width + 128) * (height + 128) >= INT32_MAX / 8) CORRUPT("picture size %dx%d", width, height);
        if (width % 16) UNSUPPORTED("a width not a multiple of 16 (%d)", width);
        if (size < (int64_t)width * height / 64 / 4) CORRUPT("a packet shorter than the picture's macroblocks");
        const int quality = buf[0];
        if (quality >= 100) CORRUPT("quality %d", quality);
        for (int i = 0; i < 64; i++) quant[i] = (i ? mpegc::kDefaultIntra[mpegc::kZigzag[i]] : 16) * (100 - quality);
        const uint32_t second = buf[1] | buf[2] << 8 | buf[3] << 16;
        if (second >= size - 3) CORRUPT("a second field past the packet");
        if (second != 4 && second != size - 4) UNSUPPORTED("two fields (an interlaced picture)");
        field(buf, size, 4, size);
        if (height % 16) features |= 1 << F_PARTIAL_ROW;
    }

    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        for (int r = 0; r < height; r++) std::memcpy(y + (size_t)r * width, planes[0].data() + (size_t)r * stride[0], width);
        for (int r = 0; r < ch; r++) {
            std::memcpy(u + (size_t)r * cw, planes[1].data() + (size_t)r * stride[1], cw);
            std::memcpy(v + (size_t)r * cw, planes[2].data() + (size_t)r * stride[2], cw);
        }
    }
};

}  // namespace

extern "C" {

void* shq_dec_new(int64_t width, int64_t height) {
    tables();
    return new Decoder((int)width, (int)height);
}

void shq_dec_free(void* h) { delete (Decoder*)h; }

int shq_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->decode(data, n);
        return mpegc::kOk;
    } catch (const Failure& f) {
        mpegc::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the picture's yuv420p planes, (width + 1) / 2 by (height + 1) / 2 chroma
void shq_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { ((Decoder*)h)->output(y, u, v); }

int64_t shq_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
