// FFV1 (RFC 9043) decoded in host C++ as FFmpeg 8's ffv1 decoder
// (ffv1dec.c, ffv1dec_template.c, rangecoder.h, golomb.h) decodes it for
// cv2.VideoCapture, bit for bit:
//
//   * versions 0 and 1 (the parameters in each key frame's header, one
//     slice), 2 (the parameters in the extradata, the slice layout in each
//     key frame's header) and 3 (the slice layout in each slice's own
//     header, the slices found from their 3-byte sizes at the end of the
//     packet, a CRC-32 at the end of each slice and of the extradata where
//     ec is set);
//   * the range coder (rangecoder.h, shared with snow.cpp: get_rac, the state transition table
//     ff_build_rac_states makes, or the custom one of the header) and the
//     Golomb-Rice coder with its run mode (get_vlc_symbol, ff_log2_run);
//   * the quantisation tables (read_quant_tables), contexts from three or
//     five neighbours, the median predictor, contexts kept from one frame
//     to the next until a key frame resets them;
//   * colour spaces: YCbCr (grey, and 4:2:0 with or without alpha) at 8
//     bits, and RGB through the reversible colour transform (RCT) at 8 bits
//     with its 9-bit planes.
//
// An RGB frame comes out as packed BGR (what swscale's BGR0/BGRA → BGR24
// copy gives cv2: the alpha plane dropped), a YCbCr frame as its planes.
// Other bit depths, 4:2:2/4:4:4/4:1:0 YCbCr and version 4 raise
// FFV1_UNSUPPORTED with a message naming what; damaged data (a CRC or
// slice-size mismatch, a read past a slice) raises FFV1_CORRUPT.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "rangecoder.h"

namespace {

enum { FFV1_OK = 0, FFV1_UNSUPPORTED = 2, FFV1_CORRUPT = 3 };
enum { AC_GOLOMB = 0, AC_RANGE = 1, AC_RANGE_TAB = 2 };
constexpr int kContext = 32;    // CONTEXT_SIZE: the states of one context
constexpr int kMaxQuantTables = 8;
constexpr int kMaxSlices = 1024;
constexpr int kMaxOverread = 2;

struct Failure {
    int kind;
    std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{FFV1_CORRUPT, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{FFV1_UNSUPPORTED, m}; }

// ff_log2_run
const uint8_t kLog2Run[41] = {0,  0,  0,  0,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,
                              3,  3,  4,  4,  5,  5,  6,  6,  7,  7,  8,  9,  10, 11,
                              12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

// av_crc with AV_CRC_32_IEEE: CRC-32 MSB first, no reflection, no final xor
uint32_t crc32(uint32_t crc, const uint8_t* p, size_t n) {
    static uint32_t table[256];
    static bool ready = false;
    if (!ready) {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i << 24;
            for (int j = 0; j < 8; j++) c = (c << 1) ^ (c & 0x80000000u ? 0x04C11DB7u : 0);
            table[i] = c;
        }
        ready = true;
    }
    for (size_t i = 0; i < n; i++) crc = (crc << 8) ^ table[(crc >> 24) ^ p[i]];
    return crc;
}

// ---------------------------------------------------------------- range coder

[[noreturn]] void symbol_overlong() { corrupt("a range-coded symbol longer than 32 bits"); }
using RangeCoder = rangecoder::Coder<symbol_overlong>;

// ---------------------------------------------------------- Golomb-Rice bits

struct BitReader {
    const uint8_t* buf = nullptr;
    int64_t size_bits = 0, pos = 0;

    void init(const uint8_t* b, int64_t n_bytes) {
        buf = b;
        size_bits = std::max<int64_t>(n_bytes, 0) * 8;
        pos = 0;
    }
    // 32 bits from pos, zeros past the end (FFmpeg's input padding)
    uint32_t show32() const {
        uint64_t v = 0;
        const int64_t bytes = size_bits >> 3;
        for (int k = 0; k < 5; k++) {
            const int64_t byte = (pos >> 3) + k;
            v = (v << 8) | (byte < bytes ? buf[byte] : 0);
        }
        return uint32_t(v >> (8 - (pos & 7)));
    }
    uint32_t get(int n) {
        if (!n) return 0;
        const uint32_t v = show32() >> (32 - n);
        pos += n;
        return v;
    }
    int64_t left() const { return size_bits - pos; }
};

int log2_u32(uint32_t v) { return v ? 31 - __builtin_clz(v) : 0; }

// get_ur_golomb(gb, k, 12, esc_len) / get_sr_golomb
int get_sr_golomb(BitReader& gb, int k, int esc_len) {
    const int limit = 12;
    uint32_t buf = gb.show32();
    const int log = log2_u32(buf);
    uint32_t v;
    if (log > 31 - limit) {
        buf >>= log - k;
        buf += (30u - log) << k;
        gb.pos += 32 + k - log;
        v = buf;
    } else {
        gb.pos += limit;
        v = gb.get(esc_len) + limit - 1;
    }
    return int(v >> 1) ^ -int(v & 1);
}

struct VlcState {
    int drift = 0, error_sum = 4, bias = 0, count = 1;
};

int fold(int diff, int bits) {
    const int shift = 32 - bits;
    return int(uint32_t(diff) << shift) >> shift;
}

int get_vlc_symbol(BitReader& gb, VlcState& s, int bits) {
    int i = s.count, k = 0;
    while (i < s.error_sum) {
        k++;
        i += i;
    }
    int v = get_sr_golomb(gb, k, bits);
    v ^= ((2 * s.drift + s.count) >> 31);
    const int ret = fold(v + s.bias, bits);
    // update_vlc_state
    int drift = s.drift, count = s.count;
    s.error_sum += std::abs(v);
    drift += v;
    if (count == 128) {
        count >>= 1;
        drift >>= 1;
        s.error_sum >>= 1;
    }
    count++;
    if (drift <= -count) {
        s.bias = std::max(s.bias - 1, -128);
        drift = std::max(drift + count, -count + 1);
    } else if (drift > 0) {
        s.bias = std::min(s.bias + 1, 127);
        drift = std::min(drift - count, 0);
    }
    s.drift = drift;
    s.count = count;
    return ret;
}

// ------------------------------------------------------------------ decoder

using QuantTable = int16_t[5][256];

struct Plane {
    int quant_table = 0;
    int context_count = 0;
    std::vector<uint8_t> state;       // context_count * kContext
    std::vector<VlcState> vlc;
};

struct Slice {
    int x = 0, y = 0, w = 0, h = 0;
    Plane plane[4];
    RangeCoder c;
    BitReader gb;
    int run_index = 0;
    std::vector<int32_t> sample;      // 8 lines of w + 6
};

int mid_pred(int a, int b, int c) {
    if (a > b) std::swap(a, b);
    return std::max(a, std::min(b, c));
}

struct Decoder {
    int width, height;
    int version = 0, micro = 0, ac = 0, colorspace = 0, bits = 8;
    int chroma_planes = 0, hshift = 0, vshift = 0, transparency = 0;
    int nh = 1, nv = 1, plane_count = 0, ec = 0;
    int quant_table_count = 0;
    QuantTable quant[kMaxQuantTables];
    int context_count[kMaxQuantTables] = {};
    std::vector<uint8_t> initial[kMaxQuantTables];
    uint8_t transition[256];
    bool have_params = false, key_ok = false;
    std::vector<Slice> slices;
    int slice_count = 0;
    // the frame: packed BGR for RGB, else Y, U, V (and A) planes
    std::vector<uint8_t> bgr, planes[4];
    int64_t features = 0;
    int frames = 0;

    Decoder(int w, int h) : width(w), height(h) {}

    int combined() const { return version << 16 | micro; }

    // read_quant_table / read_quant_tables
    static int read_quant_table(RangeCoder& c, int16_t* table, int scale) {
        uint8_t state[kContext];
        std::memset(state, 128, sizeof state);
        int v = 0, i = 0;
        for (; i < 128; v++) {
            const unsigned len = unsigned(c.symbol(state, false)) + 1u;
            if (len > unsigned(128 - i) || !len) corrupt("a quantisation table overruns");
            for (unsigned k = 0; k < len; k++) table[i++] = int16_t(scale * v);
        }
        for (i = 1; i < 128; i++) table[256 - i] = int16_t(-table[i]);
        table[128] = int16_t(-table[127]);
        return 2 * v - 1;
    }
    static int read_quant_tables(RangeCoder& c, QuantTable& q) {
        int count = 1;
        for (int i = 0; i < 5; i++) {
            count *= read_quant_table(c, q[i], count);
            if (count > 32768 || count <= 0) corrupt("too many contexts");
        }
        return (count + 1) / 2;
    }

    void check_params() {
        if (bits != 8) unsupported("FFV1 at " + std::to_string(bits) + " bits a sample");
        if (colorspace == 0) {
            if (chroma_planes && !(hshift == 1 && vshift == 1))
                unsupported("FFV1 YCbCr with chroma shifts " + std::to_string(hshift) + "," +
                            std::to_string(vshift) + " (the port reads 4:2:0 and grey)");
            if (!chroma_planes && transparency) unsupported("FFV1 grey with alpha");
        } else if (colorspace != 1) {
            unsupported("FFV1 colour space " + std::to_string(colorspace));
        }
    }

    // read_extra_header (versions 2 and 3)
    void read_extradata(const uint8_t* data, size_t n) {
        RangeCoder c;
        c.init(data, n);
        uint8_t state[kContext];
        std::memset(state, 128, sizeof state);
        version = c.symbol(state, false);
        if (version < 2) corrupt("extradata of FFV1 version " + std::to_string(version));
        if (version > 3) unsupported("FFV1 version " + std::to_string(version));
        if (version > 2) {
            if (n < 4) corrupt("extradata too short for its CRC");
            c.end -= 4;
            micro = c.symbol(state, false);
        }
        ac = c.symbol(state, false);
        if (ac == AC_RANGE_TAB)
            for (int i = 1; i < 256; i++) transition[i] = uint8_t(c.symbol(state, true) + c.one[i]);
        colorspace = c.symbol(state, false);
        bits = c.symbol(state, false);
        chroma_planes = c.bit(state);
        hshift = c.symbol(state, false);
        vshift = c.symbol(state, false);
        transparency = c.bit(state);
        plane_count = 1 + (chroma_planes || version < 4) + transparency;
        nh = 1 + c.symbol(state, false);
        nv = 1 + c.symbol(state, false);
        if (nh <= 0 || nh > width || nv <= 0 || nv > height || nh * nv > kMaxSlices)
            corrupt("a slice grid of " + std::to_string(nh) + "x" + std::to_string(nv));
        quant_table_count = c.symbol(state, false);
        if (quant_table_count <= 0 || quant_table_count > kMaxQuantTables)
            corrupt("quant_table_count " + std::to_string(quant_table_count));
        for (int i = 0; i < quant_table_count; i++) context_count[i] = read_quant_tables(c, quant[i]);
        uint8_t state2[32][kContext];
        std::memset(state2, 128, sizeof state2);
        for (int i = 0; i < quant_table_count; i++) {
            initial[i].assign(size_t(context_count[i]) * kContext, 128);
            if (c.bit(state)) {
                for (int j = 0; j < context_count[i]; j++)
                    for (int k = 0; k < kContext; k++) {
                        const int pred = j ? initial[i][(j - 1) * kContext + k] : 128;
                        initial[i][j * kContext + k] = uint8_t((pred + c.symbol(state2[k], true)) & 0xFF);
                    }
                features |= 1 << 4;
            }
        }
        if (version > 2) {
            ec = c.symbol(state, false);
            if (combined() >= 0x30003) c.symbol(state, false);   // intra
            if (ec > 1) unsupported("FFV1 error correction level " + std::to_string(ec));
            if (crc32(0, data, n) != 0) corrupt("the extradata's CRC does not match");
        }
        check_params();
        have_params = true;
    }

    // read_header: a key frame's header (versions 0-2; version 3 finds its
    // slices from their sizes)
    void read_header(RangeCoder& c, const uint8_t* buf, size_t n) {
        uint8_t state[kContext];
        std::memset(state, 128, sizeof state);
        int ctx_count = -1;
        if (version < 2) {
            const int v = c.symbol(state, false);
            if (v >= 2) corrupt("version " + std::to_string(v) + " in a version 0/1 header");
            version = v;
            ac = c.symbol(state, false);
            if (ac == AC_RANGE_TAB)
                for (int i = 1; i < 256; i++) {
                    const int st = c.symbol(state, true) + c.one[i];
                    if (st < 1 || st > 255) corrupt("a state transition out of range");
                    transition[i] = uint8_t(st);
                }
            colorspace = c.symbol(state, false);
            bits = version > 0 ? c.symbol(state, false) : 8;
            if (version == 0 && bits == 0) bits = 8;
            chroma_planes = c.bit(state);
            hshift = c.symbol(state, false);
            vshift = c.symbol(state, false);
            transparency = c.bit(state);
            plane_count = 2 + transparency;
            check_params();
            quant_table_count = 1;
            ctx_count = context_count[0] = read_quant_tables(c, quant[0]);
            slice_count = 1;
            nh = nv = 1;
        } else if (version < 3) {
            slice_count = c.symbol(state, false);
        } else {
            const uint8_t* p = buf + n;
            const int trailer = 3 + 5 * !!ec;
            for (slice_count = 0; slice_count < kMaxSlices && trailer < p - buf; slice_count++) {
                const int size = p[-trailer] << 16 | p[-trailer + 1] << 8 | p[-trailer + 2];
                if (size + trailer > p - buf) break;
                p -= size + trailer;
            }
        }
        if (slice_count <= 0 || slice_count > nh * nv)
            corrupt("a slice count of " + std::to_string(slice_count));
        slices.resize(slice_count);
        for (int j = 0; j < slice_count; j++) {
            Slice& s = slices[j];
            if (version < 2) {
                s.x = s.y = 0;
                s.w = width;
                s.h = height;
            } else if (version == 2) {
                const int sx = c.symbol(state, false), sy = c.symbol(state, false);
                const int sw = c.symbol(state, false) + 1, sh = c.symbol(state, false) + 1;
                if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > nh - sw || sy > nv - sh)
                    corrupt("a slice outside the grid");
                s.x = int(int64_t(sx) * width / nh);
                s.y = int(int64_t(sy) * height / nv);
                s.w = int(int64_t(sx + sw) * width / nh) - s.x;
                s.h = int(int64_t(sy + sh) * height / nv) - s.y;
            }
            for (int i = 0; i < plane_count; i++) {
                Plane& p = s.plane[i];
                if (version == 2) {
                    const int idx = c.symbol(state, false);
                    if (idx < 0 || idx >= quant_table_count) corrupt("a quant table index out of range");
                    p.quant_table = idx;
                    ctx_count = context_count[idx];
                }
                if (version <= 2) resize(p, ctx_count);
            }
        }
    }

    static void resize(Plane& p, int count) {
        if (int(p.state.size()) < count * kContext) {
            p.state.assign(size_t(count) * kContext, 128);
            p.vlc.assign(count, VlcState());
        }
        p.context_count = count;
    }

    // ff_ffv1_clear_slice_state
    void clear(Slice& s) {
        for (int i = 0; i < plane_count; i++) {
            Plane& p = s.plane[i];
            if (ac != AC_GOLOMB) {
                if (!initial[p.quant_table].empty())
                    std::memcpy(p.state.data(), initial[p.quant_table].data(), size_t(kContext) * p.context_count);
                else
                    std::memset(p.state.data(), 128, size_t(kContext) * p.context_count);
            } else {
                for (int j = 0; j < p.context_count; j++) p.vlc[j] = VlcState();
            }
        }
    }

    // decode_slice_header (version 3)
    void slice_header(Slice& s) {
        RangeCoder& c = s.c;
        uint8_t state[kContext];
        std::memset(state, 128, sizeof state);
        const int sx = c.symbol(state, false), sy = c.symbol(state, false);
        const int sw = c.symbol(state, false) + 1, sh = c.symbol(state, false) + 1;
        if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx + sw > nh || sy + sh > nv)
            corrupt("a slice outside the grid");
        // ff_slice_coord up to version 4.2
        s.x = int(int64_t(width) * sx / nh);
        s.y = int(int64_t(height) * sy / nv);
        s.w = int(int64_t(width) * (sx + sw) / nh) - s.x;
        s.h = int(int64_t(height) * (sy + sh) / nv) - s.y;
        for (int i = 0; i < plane_count; i++) {
            Plane& p = s.plane[i];
            const int idx = c.symbol(state, false);
            if (idx < 0 || idx >= quant_table_count) corrupt("a quant table index out of range");
            p.quant_table = idx;
            resize(p, context_count[idx]);
        }
        c.symbol(state, false);             // picture structure
        c.symbol(state, false);             // sample aspect ratio
        c.symbol(state, false);
    }

    // get_context
    static int context(const QuantTable& q, const int32_t* src, const int32_t* last, const int32_t* last2) {
        const int LT = last[-1], T = last[0], RT = last[1], L = src[-1];
        if (q[3][127] || q[4][127]) {
            const int TT = last2[0], LL = src[-2];
            return q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF] +
                   q[3][(LL - L) & 0xFF] + q[4][(TT - T) & 0xFF];
        }
        return q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF];
    }

    // decode_line: one line of samples into sample[1]
    void line(Slice& s, int w, int32_t* sample[2], int plane_index, int nbits) {
        Plane& p = s.plane[plane_index];
        const QuantTable& q = quant[p.quant_table];
        const bool golomb = ac == AC_GOLOMB;
        if (golomb ? s.gb.left() < 1 : s.c.overread > kMaxOverread) corrupt("a slice ends early");
        int run_count = 0, run_mode = 0, run_index = s.run_index;
        const uint32_t mask = (1u << nbits) - 1;
        for (int x = 0; x < w; x++) {
            if (!(x & 1023) && (golomb ? s.gb.left() < 1 : s.c.overread > kMaxOverread))
                corrupt("a slice ends early");
            int ctx = context(q, sample[1] + x, sample[0] + x, sample[1] + x);
            bool sign = false;
            if (ctx < 0) {
                ctx = -ctx;
                sign = true;
            }
            if (ctx >= p.context_count) corrupt("a context out of range");
            int diff;
            if (!golomb) {
                diff = s.c.symbol(&p.state[size_t(ctx) * kContext], true);
            } else {
                if (ctx == 0 && run_mode == 0) run_mode = 1;
                if (run_mode) {
                    if (run_count == 0 && run_mode == 1) {
                        if (s.gb.get(1)) {
                            run_count = 1 << kLog2Run[run_index];
                            if (x + run_count <= w) run_index++;
                        } else {
                            run_count = kLog2Run[run_index] ? int(s.gb.get(kLog2Run[run_index])) : 0;
                            if (run_index) run_index--;
                            run_mode = 2;
                        }
                        if (run_index > 40) corrupt("a run index out of range");
                        features |= 1 << 5;
                    }
                    run_count--;
                    if (run_count < 0) {
                        run_mode = 0;
                        run_count = 0;
                        diff = get_vlc_symbol(s.gb, p.vlc[ctx], nbits);
                        if (diff >= 0) diff++;
                    } else {
                        diff = 0;
                    }
                } else {
                    diff = get_vlc_symbol(s.gb, p.vlc[ctx], nbits);
                }
            }
            if (sign) diff = -diff;
            const int32_t* T = sample[0] + x;
            const int32_t* L = sample[1] + x;
            sample[1][x] = int32_t((uint32_t(mid_pred(L[-1], L[-1] + T[0] - T[-1], T[0])) + uint32_t(diff)) & mask);
        }
        s.run_index = run_index;
    }

    // decode_plane (8 bits)
    void plane(Slice& s, uint8_t* dst, int w, int h, int stride, int plane_index) {
        s.sample.assign(size_t(2) * (w + 6), 0);
        int32_t* sample[2] = {s.sample.data() + 3, s.sample.data() + w + 6 + 3};
        s.run_index = 0;
        for (int y = 0; y < h; y++) {
            std::swap(sample[0], sample[1]);
            sample[1][-1] = sample[0][0];
            sample[0][w] = sample[0][w - 1];
            line(s, w, sample, plane_index, 8);
            for (int x = 0; x < w; x++) dst[size_t(y) * stride + x] = uint8_t(sample[1][x]);
        }
    }

    // decode_rgb_frame (8 bits: 9-bit planes through the RCT)
    void rgb(Slice& s) {
        const int w = s.w, offset = 1 << bits;
        s.sample.assign(size_t(8) * (w + 6), 0);
        int32_t* sample[4][2];
        for (int k = 0; k < 4; k++) {
            sample[k][0] = s.sample.data() + k * 2 * (w + 6) + 3;
            sample[k][1] = s.sample.data() + (k * 2 + 1) * (w + 6) + 3;
        }
        s.run_index = 0;
        for (int y = 0; y < s.h; y++) {
            for (int p = 0; p < 3 + transparency; p++) {
                std::swap(sample[p][0], sample[p][1]);
                sample[p][1][-1] = sample[p][0][0];
                sample[p][0][w] = sample[p][0][w - 1];
                line(s, w, sample[p], (p + 1) / 2, 9);
            }
            uint8_t* out = bgr.data() + (size_t(s.y + y) * width + s.x) * 3;
            for (int x = 0; x < w; x++) {
                int g = sample[0][1][x], b = sample[1][1][x], r = sample[2][1][x];
                b -= offset;
                r -= offset;
                g -= (b + r) >> 2;
                b += g;
                r += g;
                out[3 * x] = uint8_t(b);
                out[3 * x + 1] = uint8_t(g);
                out[3 * x + 2] = uint8_t(r);
            }
        }
    }

    void slice(Slice& s, bool key, int index) {
        if (version > 2) {
            if (ac == AC_RANGE_TAB) s.c.use_transition(transition);
            slice_header(s);
        }
        if (ac == AC_RANGE_TAB) s.c.use_transition(transition);
        if (key) clear(s);
        if (s.w <= 0 || s.h <= 0) corrupt("an empty slice");
        if (ac == AC_GOLOMB) {
            if (combined() >= 0x30002) {
                uint8_t st = 129;
                s.c.bit(&st);
            }
            const int64_t skip = (version > 2 || (!s.x && !s.y)) ? (s.c.p - s.c.start) - 1 : 0;
            s.gb.init(s.c.start + skip, (s.c.end - s.c.start) - skip);
            features |= 1 << 1;
        } else {
            features |= 1 << (ac == AC_RANGE_TAB ? 3 : 2);
        }
        if (colorspace == 0) {
            plane(s, planes[0].data() + size_t(s.y) * width + s.x, s.w, s.h, width, 0);
            if (chroma_planes) {
                const int cw = (width + 1) >> 1;
                const int sw = -((-s.w) >> hshift), sh = -((-s.h) >> vshift);
                const int cx = s.x >> hshift, cy = s.y >> vshift;
                plane(s, planes[1].data() + size_t(cy) * cw + cx, sw, sh, cw, 1);
                plane(s, planes[2].data() + size_t(cy) * cw + cx, sw, sh, cw, 1);
            }
            if (transparency) plane(s, planes[3].data() + size_t(s.y) * width + s.x, s.w, s.h, width, 2);
        } else {
            rgb(s);
        }
        if (ac != AC_GOLOMB && version > 2) {
            uint8_t st = 129;
            s.c.bit(&st);
            const int64_t v = (s.c.end - s.c.p) - 2 - 5 * !!ec;
            if (v) corrupt("slice " + std::to_string(index) + " ends " + std::to_string(v) + " bytes off its size");
        }
    }

    void decode(const uint8_t* buf, size_t n) {
        if (n < 2) corrupt("an empty packet");
        if (version >= 2 && !have_params) corrupt("FFV1 version 2+ without its extradata");
        RangeCoder c;           // the frame's coder, which slice 0 goes on with
        c.init(buf, n);
        uint8_t keystate = 128;
        const bool key = c.bit(&keystate);
        if (key) {
            key_ok = false;
            read_header(c, buf, n);
            key_ok = true;
            features |= 1 << 0;
        } else {
            if (!key_ok) corrupt("a non-key frame before any key frame");
            features |= 1 << 6;
        }
        slices[0].c = c;
        if (slice_count > 1) features |= 1 << 7;
        features |= version < 2 ? 1 << 8 : 1 << (11 + version);
        if (ec) features |= 1 << 15;
        if (colorspace == 0)
            features |= chroma_planes ? 1 << 9 : 1 << 10;
        else
            features |= 1 << 11;
        if (transparency) features |= 1 << 12;
        // the slices, from the end of the packet
        const uint8_t* p = buf + n;
        const int trailer = 3 + 5 * !!ec;
        for (int i = slice_count - 1; i >= 0; i--) {
            Slice& s = slices[i];
            int64_t v;
            if (i || version > 2) {
                v = trailer > p - buf ? INT64_MAX : int64_t(p[-trailer] << 16 | p[-trailer + 1] << 8 | p[-trailer + 2]) + trailer;
            } else {
                v = p - buf;
            }
            if (p - buf < v) corrupt("the slice sizes do not add up");
            p -= v;
            if (ec && crc32(0, p, size_t(v)) != 0) corrupt("slice " + std::to_string(i) + "'s CRC does not match");
            if (i)
                s.c.init(p, size_t(v));
            else
                s.c.end = p + v;
        }
        if (colorspace == 1) {
            bgr.assign(size_t(width) * height * 3, 0);
        } else {
            planes[0].assign(size_t(width) * height, 0);
            const size_t cs = size_t((width + 1) >> 1) * ((height + 1) >> 1);
            planes[1].assign(chroma_planes ? cs : 0, 128);
            planes[2].assign(chroma_planes ? cs : 0, 128);
            planes[3].assign(transparency ? size_t(width) * height : 0, 0);
        }
        for (int i = 0; i < slice_count; i++) slice(slices[i], key, i);
        frames++;
    }
};

void put_msg(char* msg, int64_t cap, const std::string& s) {
    if (cap <= 0) return;
    const size_t n = std::min<size_t>(s.size(), size_t(cap - 1));
    std::memcpy(msg, s.data(), n);
    msg[n] = 0;
}

}  // namespace

extern "C" {

void* ffv1_dec_new(int64_t width, int64_t height) { return new Decoder(int(width), int(height)); }

void ffv1_dec_free(void* h) { delete (Decoder*)h; }

// The extradata (versions 2 and 3); FFV1_OK or the failure with a message.
int ffv1_dec_extradata(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    try {
        ((Decoder*)h)->read_extradata(data, size_t(n));
        return FFV1_OK;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// Decode one packet; info gets (colorspace, chroma_planes, transparency).
int ffv1_dec_decode(void* h, const uint8_t* data, int64_t n, int64_t* info, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->decode(data, size_t(n));
        info[0] = d->colorspace;
        info[1] = d->chroma_planes;
        info[2] = d->transparency;
        return FFV1_OK;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

// Copy the frame out: packed BGR (RGB streams) into out[0], else the
// Y, U, V planes into out[0..2].
void ffv1_dec_output(void* h, uint8_t* a, uint8_t* b, uint8_t* c) {
    Decoder* d = (Decoder*)h;
    if (d->colorspace == 1) {
        std::memcpy(a, d->bgr.data(), d->bgr.size());
        return;
    }
    std::memcpy(a, d->planes[0].data(), d->planes[0].size());
    if (b) std::memcpy(b, d->planes[1].data(), d->planes[1].size());
    if (c) std::memcpy(c, d->planes[2].data(), d->planes[2].size());
}

int64_t ffv1_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
