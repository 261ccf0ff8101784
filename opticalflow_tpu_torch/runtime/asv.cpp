// ASUS V1 and V2 video (fourccs ASV1, ASV2), decoded in host C++ as FFmpeg
// 8's asv1/asv2 decoder (asvdec.c, asv.c) decodes it for cv2.VideoCapture,
// bit for bit:
//
//   * every packet one intra picture of 16x16 macroblocks, each four luma
//     and two chroma 8x8 blocks, in FFmpeg's order: the whole macroblocks
//     row by row, then the right column of partial ones, then the bottom
//     row (a size that is not a multiple of 16 is cropped from the
//     decoded macroblocks, yuv420p);
//   * ASV1: the packet's 32-bit words byte-swapped (bswap_buf) and read
//     from their top bit; a block is an 8-bit DC, then up to ten coded
//     coefficient patterns (CCP: which of four coefficients in scan order
//     follow) closed by an end-of-block code, levels by a 7-entry code
//     with an 8-bit escape;
//   * ASV2: the packet read from each byte's lowest bit (FFmpeg's
//     little-endian reader and tables); a block is a 4-bit count of AC
//     groups, an 8-bit DC, a DC-group CCP of three coefficients, then the
//     count's CCPs, levels by a 63-entry code with an 8-bit escape;
//   * dequantisation: DC times 8, each AC level times FFmpeg's intra
//     matrix at its scan position (64 * scale * the MPEG-1 default intra
//     matrix / the extradata's first byte, 1 for ASV1, 2 for ASV2; a
//     missing or zero byte taken as 6 or 10) over 16, stored as int16;
//   * the simple IDCT (ffmpeg_dsp.h), coefficients in raster order (the
//     IDCT permutation FFmpeg applies to the scan is undone by its own
//     IDCT's layout).
//
// Damaged data (a packet shorter than 13 bits a macroblock, a CCP past the
// block) raises kCorrupt.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "lossless_common.h"

namespace {

using lossless::Failure;
using lossless::corrupt;

// the decoder's feature bits (asv.py's FEATURES, in order)
enum Feature { F_ASV1, F_ASV2, F_PARTIAL_COLUMN, F_PARTIAL_ROW, F_ESCAPE, F_DEFAULT_QSCALE };

// ff_asv_scantab
const uint8_t kScan[64] = {
    0x00, 0x08, 0x01, 0x09, 0x10, 0x18, 0x11, 0x19, 0x02, 0x0A, 0x03, 0x0B, 0x12, 0x1A, 0x13, 0x1B,
    0x04, 0x0C, 0x05, 0x0D, 0x20, 0x28, 0x21, 0x29, 0x06, 0x0E, 0x07, 0x0F, 0x14, 0x1C, 0x15, 0x1D,
    0x22, 0x2A, 0x23, 0x2B, 0x30, 0x38, 0x31, 0x39, 0x16, 0x1E, 0x17, 0x1F, 0x24, 0x2C, 0x25, 0x2D,
    0x32, 0x3A, 0x33, 0x3B, 0x26, 0x2E, 0x27, 0x2F, 0x34, 0x3C, 0x35, 0x3D, 0x36, 0x3E, 0x37, 0x3F};

// ff_mpeg1_default_intra_matrix, raster order
const uint8_t kIntraMatrix[64] = {
    8,  16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37, 19, 22, 26, 27, 29, 34,
    34, 38, 22, 22, 26, 27, 29, 34, 37, 40, 22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32,
    35, 40, 48, 58, 26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};

// (code, length) by symbol, as FFmpeg's asv.c lists them (read out of
// cv2's bundled libavcodec): ASV1's are read from the top bit down
// (ff_asv_ccp_tab: 16 is the end of block; ff_asv_level_tab: 3 is the
// escape), ASV2's from the lowest bit up (ff_asv_dc_ccp_tab,
// ff_asv_ac_ccp_tab, ff_asv2_level_tab: 31 is the escape)
struct Code {
    uint16_t code, len;
};
const Code kCcp[17] = {{0x2, 2}, {0x7, 5}, {0xB, 5}, {0x3, 5}, {0xD, 5}, {0x5, 5},
                       {0x9, 5}, {0x1, 5}, {0xE, 5}, {0x6, 5}, {0xA, 5}, {0x2, 5},
                       {0xC, 5}, {0x4, 5}, {0x8, 5}, {0x3, 2}, {0xF, 5}};
const Code kLevel[7] = {{3, 4}, {3, 3}, {3, 2}, {0, 3}, {2, 2}, {2, 3}, {2, 4}};
const Code kDcCcp[8] = {{2, 2}, {11, 4}, {15, 4}, {3, 4}, {5, 3}, {7, 4}, {1, 3}, {0, 2}};
const Code kAcCcp[16] = {{0, 2},  {55, 6}, {5, 4},  {23, 6}, {2, 3}, {39, 6}, {15, 6}, {7, 6},
                         {6, 3},  {47, 6}, {1, 4},  {31, 5}, {9, 4}, {13, 4}, {11, 4}, {3, 4}};
const Code kLevel2[63] = {
    {0x3F0, 10}, {0x3D0, 10}, {0x3B0, 10}, {0x390, 10}, {0x370, 10}, {0x350, 10}, {0x330, 10},
    {0x310, 10}, {0x2F0, 10}, {0x2D0, 10}, {0x2B0, 10}, {0x290, 10}, {0x270, 10}, {0x250, 10},
    {0x230, 10}, {0x210, 10}, {0x0F8, 8},  {0x0E8, 8},  {0x0D8, 8},  {0x0C8, 8},  {0x0B8, 8},
    {0x0A8, 8},  {0x098, 8},  {0x088, 8},  {0x03C, 6},  {0x034, 6},  {0x02C, 6},  {0x024, 6},
    {0x00E, 4},  {0x00A, 4},  {0x003, 2},  {0x000, 5},  {0x001, 2},  {0x002, 4},  {0x006, 4},
    {0x004, 6},  {0x00C, 6},  {0x014, 6},  {0x01C, 6},  {0x008, 8},  {0x018, 8},  {0x028, 8},
    {0x038, 8},  {0x048, 8},  {0x058, 8},  {0x068, 8},  {0x078, 8},  {0x010, 10}, {0x030, 10},
    {0x050, 10}, {0x070, 10}, {0x090, 10}, {0x0B0, 10}, {0x0D0, 10}, {0x0F0, 10}, {0x110, 10},
    {0x130, 10}, {0x150, 10}, {0x170, 10}, {0x190, 10}, {0x1B0, 10}, {0x1D0, 10}, {0x1F0, 10}};

constexpr int kLookup = 10;   // every code fits a 10-bit lookup

// A code's symbol by the next kLookup bits, in the reader's bit order
// (-1: no code); LSB-first codes are matched against bit-reversed lookups
struct Table {
    std::vector<int16_t> sym;
    std::vector<uint8_t> len;
    Table(const Code* codes, int n, bool lsb_first) : sym(1 << kLookup, -1), len(1 << kLookup, 0) {
        for (int s = 0; s < n; s++) {
            const int l = codes[s].len;
            const uint32_t c = codes[s].code;
            for (uint32_t rest = 0; rest < (1u << (kLookup - l)); rest++) {
                const uint32_t i = lsb_first ? c | rest << l : c << (kLookup - l) | rest;
                sym[i] = (int16_t)s;
                len[i] = (uint8_t)l;
            }
        }
    }
};

struct Tables {
    Table ccp{kCcp, 17, false}, level{kLevel, 7, false};
    Table dc_ccp{kDcCcp, 8, true}, ac_ccp{kAcCcp, 16, true}, level2{kLevel2, 63, true};
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// the packet's bits: MSB-first over byte-swapped words (ASV1) or LSB-first
// (ASV2), zeros past the end
struct Reader {
    std::vector<uint8_t> buf;
    int64_t pos = 0;
    bool lsb = false;

    void init(const uint8_t* d, int64_t n, bool lsb_first) {
        lsb = lsb_first;
        pos = 0;
        if (lsb) {
            buf.assign(d, d + n);
            buf.resize((size_t)n + 16, 0);
        } else {
            lossless::swap_words(d, n, buf);   // a tail short of a word: zeros
        }
    }
    // the next n (<= 24) bits: the first read is the top bit (MSB-first)
    // or bit 0 (LSB-first); zeros past the buffer, as FFmpeg's checked
    // reader gives
    uint32_t show(int n) const {
        const size_t at = (size_t)(pos >> 3);
        uint8_t q[4] = {};
        for (size_t k = 0; k < 4 && at + k < buf.size(); k++) q[k] = buf[at + k];
        if (lsb) {
            const uint32_t v = q[0] | (uint32_t)q[1] << 8 | (uint32_t)q[2] << 16 | (uint32_t)q[3] << 24;
            return (v >> (pos & 7)) & ((1u << n) - 1);
        }
        const uint32_t v = (uint32_t)q[0] << 24 | (uint32_t)q[1] << 16 | (uint32_t)q[2] << 8 | q[3];
        return (v << (pos & 7)) >> (32 - n);
    }
    uint32_t get(int n) {
        const uint32_t v = show(n);
        pos += n;
        return v;
    }
    // get_vlc2 with one level: -1 for a code no table holds (no bits read)
    int vlc(const Table& t) {
        const uint32_t i = show(kLookup);
        if (t.sym[i] >= 0) pos += t.len[i];
        return t.sym[i];
    }
};

struct Decoder {
    bool asv2;
    int width, height, mb_w, mb_h, mb_w2, mb_h2;
    int matrix[64];
    std::vector<uint8_t> plane[3];   // macroblock-aligned
    int stride[3];
    Reader br;
    int16_t blk[6][64];
    int64_t features = 0;

    void set(Feature f) { features |= int64_t(1) << f; }

    // decode_init (ff_asv_common_init)
    Decoder(int v2, int w, int h, const uint8_t* ext, int64_t n) : asv2(v2 != 0), width(w), height(h) {
        mb_w = (w + 15) / 16;
        mb_h = (h + 15) / 16;
        mb_w2 = w / 16;
        mb_h2 = h / 16;
        const int scale = asv2 ? 2 : 1;
        int inv_qscale = n >= 1 ? ext[0] : 0;
        if (!inv_qscale) {
            inv_qscale = asv2 ? 10 : 6;
            set(F_DEFAULT_QSCALE);
        }
        for (int i = 0; i < 64; i++) matrix[i] = 64 * scale * kIntraMatrix[kScan[i]] / inv_qscale;
        stride[0] = mb_w * 16;
        stride[1] = stride[2] = mb_w * 8;
        plane[0].assign((size_t)stride[0] * mb_h * 16, 0);
        plane[1].assign((size_t)stride[1] * mb_h * 8, 0);
        plane[2].assign((size_t)stride[2] * mb_h * 8, 0);
        set(asv2 ? F_ASV2 : F_ASV1);
        if (mb_w2 != mb_w) set(F_PARTIAL_COLUMN);
        if (mb_h2 != mb_h) set(F_PARTIAL_ROW);
    }

    void put(int16_t* b, int i, int level) { b[kScan[i]] = (int16_t)((level * matrix[i]) >> 4); }

    int asv1_level() {
        const int code = br.vlc(tables().level);
        if (code == 3) {
            set(F_ESCAPE);
            return (int8_t)br.get(8);
        }
        return code - 3;   // -4 for no code, as FFmpeg's -1 - 3
    }

    int asv2_level() {
        const int code = br.vlc(tables().level2);
        if (code == 31) {
            set(F_ESCAPE);
            return (int8_t)br.get(8);
        }
        return code - 31;
    }

    // asv1_decode_block
    void asv1_block(int16_t* b) {
        b[0] = (int16_t)(8 * br.get(8));
        for (int i = 0; i < 11; i++) {
            const int ccp = br.vlc(tables().ccp);
            if (!ccp) continue;
            if (ccp == 16) break;
            if (ccp < 0 || i >= 10) corrupt("a coded coefficient pattern past the block");
            if (ccp & 8) put(b, 4 * i + 0, asv1_level());
            if (ccp & 4) put(b, 4 * i + 1, asv1_level());
            if (ccp & 2) put(b, 4 * i + 2, asv1_level());
            if (ccp & 1) put(b, 4 * i + 3, asv1_level());
        }
    }

    // asv2_decode_block (a CCP no table holds is -1, which selects every
    // coefficient, as in FFmpeg)
    void asv2_block(int16_t* b) {
        const int count = (int)br.get(4);
        b[0] = (int16_t)(8 * br.get(8));
        int ccp = br.vlc(tables().dc_ccp);
        if (ccp) {
            if (ccp & 4) put(b, 1, asv2_level());
            if (ccp & 2) put(b, 2, asv2_level());
            if (ccp & 1) put(b, 3, asv2_level());
        }
        for (int i = 1; i < count + 1; i++) {
            ccp = br.vlc(tables().ac_ccp);
            if (!ccp) continue;
            if (ccp & 8) put(b, 4 * i + 0, asv2_level());
            if (ccp & 4) put(b, 4 * i + 1, asv2_level());
            if (ccp & 2) put(b, 4 * i + 2, asv2_level());
            if (ccp & 1) put(b, 4 * i + 3, asv2_level());
        }
    }

    void mb(int x, int y) {
        std::memset(blk, 0, sizeof blk);
        for (int n = 0; n < 6; n++) {
            if (asv2) asv2_block(blk[n]);
            else asv1_block(blk[n]);
        }
        uint8_t* dy = plane[0].data() + (size_t)y * 16 * stride[0] + x * 16;
        const int ls = stride[0];
        ffdsp::idct(blk[0], dy, ls, false);
        ffdsp::idct(blk[1], dy + 8, ls, false);
        ffdsp::idct(blk[2], dy + 8 * ls, ls, false);
        ffdsp::idct(blk[3], dy + 8 * ls + 8, ls, false);
        ffdsp::idct(blk[4], plane[1].data() + (size_t)y * 8 * stride[1] + x * 8, stride[1], false);
        ffdsp::idct(blk[5], plane[2].data() + (size_t)y * 8 * stride[2] + x * 8, stride[2], false);
    }

    void decode(const uint8_t* d, int64_t n) {
        if (n * 8 < (int64_t)mb_w * mb_h * 13) corrupt("a packet shorter than 13 bits a macroblock");
        br.init(d, n, asv2);
        for (int y = 0; y < mb_h2; y++)
            for (int x = 0; x < mb_w2; x++) mb(x, y);
        if (mb_w2 != mb_w)
            for (int y = 0; y < mb_h2; y++) mb(mb_w2, y);
        if (mb_h2 != mb_h)
            for (int x = 0; x < mb_w; x++) mb(x, mb_h2);
    }

    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        const int cw = (width + 1) / 2, ch = (height + 1) / 2;
        for (int r = 0; r < height; r++) std::memcpy(y + (size_t)r * width, &plane[0][(size_t)r * stride[0]], width);
        for (int r = 0; r < ch; r++) {
            std::memcpy(u + (size_t)r * cw, &plane[1][(size_t)r * stride[1]], cw);
            std::memcpy(v + (size_t)r * cw, &plane[2][(size_t)r * stride[2]], cw);
        }
    }
};

}  // namespace

extern "C" {

// a decoder for ASV2 (asv2 != 0) or ASV1 at width x height with the
// container's extradata
void* asv_dec_new(int64_t asv2, int64_t width, int64_t height, const uint8_t* ext, int64_t n) {
    tables();
    return new Decoder((int)asv2, (int)width, (int)height, ext, n);
}

void asv_dec_free(void* h) { delete (Decoder*)h; }

int asv_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->decode(data, n);
        return lossless::OK;
    } catch (const Failure& f) {
        lossless::put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// the picture's yuv420p planes, (width + 1) / 2 by (height + 1) / 2 chroma
void asv_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { ((Decoder*)h)->output(y, u, v); }

int64_t asv_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
