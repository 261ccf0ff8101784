// MS-MPEG4 v2 and v3 (fourccs MP42, DIV3/MP43, ...), WMV7 (WMV1) and WMV8
// (WMV2), decoded in host C++ as FFmpeg 8's msmpeg4v2, msmpeg4v3, wmv1 and
// wmv2 decoders (msmpeg4dec.c, msmpeg4.c, wmv2dec.c, h263dec.c) decode
// them for cv2.VideoCapture, bit for bit:
//
//   * the picture header: the picture type, the quantiser, an I-picture's
//     slice code (v2-WMV7: the picture height in macroblocks over code -
//     0x16; WMV8: the extradata's slice count, its 7 skipped bits), the
//     table choices of each version (v3/WMV7: the luma and chroma RL
//     tables by code012, the DC table, the MV table; WMV7/8's per-
//     macroblock RL choice; v2's skip flag), WMV7's extension header after
//     the slice code, v2/v3's at an I-picture's end (the bit rate and the
//     flip-flop rounding flag), WMV8's from the extradata (its P-pictures
//     skip map, coded-block table by the quantiser, and the flags each
//     picture reads);
//   * the macroblock layer: v2's H.263 codes (MCBPC, CBPY, MVD with the
//     range wrapped at +-64 half-pels) and v2's own DC code (MPEG-4's with
//     its bits inverted); v3's and WMV's I-picture coded-block code with
//     the pattern predicted from the left, above-left and above blocks,
//     the P-picture code of the macroblock type and pattern, the two MV
//     tables with their 12-bit escape, wrapped at +-64;
//   * the coefficients: six run-level tables, three escapes (a level
//     offset by the largest level of the run, a run offset by the longest
//     run of the level, and a fixed-length one: v2/v3 6-bit run and 8-bit
//     level, WMV7/8 lengths fixed at a picture's first escape);
//   * DC prediction from the left or above block's stored DC (which of
//     them by the gradient, v2/v3's test <=, WMV's <; v2/v3's first slice
//     line predicts from 1024 above), with each version's DC scale, and
//     WMV7's intra blocks in small, low-rate P-pictures predicted from the
//     decoded pixels in a direction the macroblock codes; AC prediction
//     (ff_mpeg4_pred_ac) with the alternate scans (v2/v3) or WMV's scans;
//     v2/v3's slices reset the predictors of the row above;
//   * H.263 dequantisation, the simple IDCT (ffmpeg_dsp.h) for v2, v3 and
//     WMV7, WMV8's own IDCT (wmv2dsp.c), half-pel motion compensation with
//     H.263's chroma vector, the rounding flipped each P-picture where the
//     stream sets flip-flop rounding (always in WMV8).
//
// MS-MPEG4 v1, WMV8's J-pictures (IntraX8), mspel motion, ABT blocks other
// than 8x8, its loop filter and a motion-vector prediction flag that
// libavcodec never writes raise MSM_UNSUPPORTED naming the feature.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "mpeg_common.h"
#include "msmpeg4_tables.h"

namespace {

using namespace mpegc;
using namespace msmp4;
using ffdsp::idct;

enum { MSM_OK = kOk, MSM_NO_FRAME = kNoFrame, MSM_UNSUPPORTED = kUnsupported,
       MSM_CORRUPT = kCorrupt };

// FFmpeg's msmpeg4_version order
enum Version { V2 = 2, V3 = 3, WMV1 = 4, WMV2 = 5 };

// what a stream reached (msmpeg4.py's FEATURES, in order)
enum Feature {
    F_P_PICTURES, F_SKIPPED_MB, F_INTRA_IN_P, F_AC_PRED, F_SLICES,
    F_RL_LUMA_0, F_RL_LUMA_1, F_RL_LUMA_2, F_RL_CHROMA_0, F_RL_CHROMA_1, F_RL_CHROMA_2,
    F_RL_INTER_0, F_RL_INTER_1, F_RL_INTER_2, F_DC_TABLE_0, F_DC_TABLE_1,
    F_MV_TABLE_0, F_MV_TABLE_1, F_MV_ESCAPE, F_MV_WRAP, F_ESCAPE_1, F_ESCAPE_2,
    F_ESCAPE_3, F_DC_ESCAPE, F_PER_MB_RL, F_SKIP_CODE, F_FLIPFLOP, F_EXT_HEADER,
    F_INTER_INTRA, F_CBP_TABLE_0, F_CBP_TABLE_1, F_CBP_TABLE_2, F_SKIP_MAP,
    F_OVERFLOW_IGNORED,
};

constexpr int kDcMax = 119;

// ------------------------------------------------------------------- VLCs

// A VLC whose codes may be long (26 bits): a first table over ``bits``
// bits and subtables under the longer codes' prefixes, as FFmpeg's
// multi-level tables
struct LongVlc {
    struct Entry {
        int32_t sym = -1;   // the symbol, or a subtable's offset
        int8_t len = 0;     // its length, -(subtable bits), 0: no code
    };
    struct Item {
        uint32_t code;
        int len, sym;
    };
    std::vector<Entry> t;
    int bits = 0;

    void build(std::vector<Item> items, int root) {
        bits = root;
        t.clear();
        level(items, root);
    }
    // (code, length) pairs, symbol = index
    void build(const LCode* c, int n, int root) {
        std::vector<Item> items;
        for (int i = 0; i < n; i++) items.push_back({c[i].code, c[i].len, i});
        build(items, root);
    }
    // lengths in code order, codes assigned as ff_vlc_init_from_lengths does
    void build_from_lengths(const uint8_t* lens, const uint16_t* syms, int n, int root) {
        std::vector<Item> items;
        uint64_t code = 0;
        for (int i = 0; i < n; i++) {
            items.push_back({(uint32_t)(code >> (32 - lens[i])), lens[i], syms[i]});
            code += (uint64_t)1 << (32 - lens[i]);
        }
        if (code != (uint64_t)1 << 32) abort();
        build(items, root);
    }
    int level(const std::vector<Item>& items, int nb) {
        const int off = (int)t.size();
        t.resize(off + ((size_t)1 << nb));
        std::vector<std::vector<Item>> sub((size_t)1 << nb);
        for (const Item& it : items) {
            if (it.len <= nb) {
                const uint32_t lo = it.code << (nb - it.len), n = 1u << (nb - it.len);
                for (uint32_t j = 0; j < n; j++) {
                    if (t[off + lo + j].len) abort();   // not a prefix code
                    t[off + lo + j] = {it.sym, (int8_t)it.len};
                }
            } else {
                const int rest = it.len - nb;
                sub[it.code >> rest].push_back({it.code & ((1u << rest) - 1), rest, it.sym});
            }
        }
        for (size_t p = 0; p < sub.size(); p++) {
            if (sub[p].empty()) continue;
            int deepest = 0;
            for (const Item& it : sub[p]) deepest = std::max(deepest, it.len);
            const int sb = std::min(deepest, 9);
            const int at = level(sub[p], sb);
            t[off + p] = {at, (int8_t)-sb};
        }
        return off;
    }
    int read(BitReader& br) const {
        int off = 0, n = bits;
        while (true) {
            const Entry& e = t[off + br.show(n)];
            if (e.len > 0) {
                br.skip(e.len);
                return e.sym;
            }
            if (e.len == 0) CORRUPT("invalid VLC at bit %lld", (long long)br.pos);
            br.skip(n);
            off = e.sym;
            n = -e.len;
        }
    }
};

// A run-level table: its codes (the last the escape), each code's run and
// level, the first code that ends a block, the largest level of each run
// and longest run of each level (ff_rl_init), by last
struct RunLevelTable {
    LongVlc vlc;
    int n = 0, last = 0;
    std::vector<int> run, level;
    int max_level[2][65] = {}, max_run[2][65] = {};

    void init(int last_) {
        last = last_;
        for (int i = 0; i < n; i++) {
            const int l = i >= last;
            max_level[l][run[i]] = std::max(max_level[l][run[i]], level[i]);
            if (level[i] <= 64) max_run[l][level[i]] = std::max(max_run[l][level[i]], run[i]);
        }
    }
    void build(const LCode* codes, const int8_t* r, const int8_t* l, int n_, int last_) {
        n = n_;
        run.assign(r, r + n);
        level.assign(l, l + n);
        vlc.build(codes, n + 1, 9);
        init(last_);
    }
    // from H.263/MPEG-4's tables (mpeg_common.h)
    void build(const Code* codes, const int* ml0, int n0, const int* ml1, int n1) {
        std::vector<LongVlc::Item> items;
        for (int i = 0; i < 103; i++) items.push_back({codes[i].code, codes[i].bits, i});
        vlc.build(items, 9);
        n = 102;
        int first_last = 0;
        for (int l = 0; l < 2; l++) {
            const int* ml = l ? ml1 : ml0;
            if (l) first_last = (int)run.size();
            for (int r = 0; r < (l ? n1 : n0); r++)
                for (int v = 1; v <= ml[r]; v++) {
                    run.push_back(r);
                    level.push_back(v);
                }
        }
        if ((int)run.size() != n) abort();
        init(first_last);
    }
};

struct Tables {
    LongVlc mb_i, cbp[4], dc[2][2], mv[2];
    Vlc v2_mb_type, v2_intra_cbpc, inter_intra, intra_mcbpc, inter_mcbpc, cbpy, mvd, dc_lum, dc_chrom;
    RunLevelTable rl[6];
    Tables() {
        mb_i.build(kMbI, 64, 9);
        const LCode* cbps[4] = {kCbp0, kCbp1, kCbp2, kCbp3};
        for (int i = 0; i < 4; i++) cbp[i].build(cbps[i], 128, 9);
        dc[0][0].build(kDc0L, 120, 9);
        dc[0][1].build(kDc0C, 120, 9);
        dc[1][0].build(kDc1L, 120, 9);
        dc[1][1].build(kDc1C, 120, 9);
        mv[0].build_from_lengths(kMv0Lens, kMv0Syms, 1100, 9);
        mv[1].build_from_lengths(kMv1Lens, kMv1Syms, 1100, 9);
        rl[0].build(kRl0Codes, kRl0Run, kRl0Level, 132, kRl0Last);
        rl[1].build(kRl185Codes, kRl185Run, kRl185Level, 185, kRl185Last);
        rl[2].build(kIntraTcoef, kIntraMaxLevel0, 15, kIntraMaxLevel1, 21);
        rl[3].build(kRl1Codes, kRl1Run, kRl1Level, 148, kRl1Last);
        rl[4].build(kRl168Codes, kRl168Run, kRl168Level, 168, kRl168Last);
        rl[5].build(kInterTcoef, kInterMaxLevel0, 27, kInterMaxLevel1, 41);
        auto small = [](Vlc& v, const LCode* c, int n, int bits) {
            std::vector<Code> cs;
            for (int i = 0; i < n; i++) cs.push_back({(uint16_t)c[i].code, c[i].len});
            v.build(cs.data(), n, bits);
        };
        small(v2_mb_type, kV2MbType, 8, 7);
        small(v2_intra_cbpc, kV2IntraCbpc, 4, 3);
        small(inter_intra, kInterIntra, 4, 3);
        intra_mcbpc.build(kIntraMcbpc, 9, 9);
        inter_mcbpc.build(kInterMcbpc, 28, 13);
        cbpy.build(kCbpy, 16, 6);
        mvd.build(kMvd, 33, 12);
        // v2's DC sizes: MPEG-4's codes with every bit inverted
        Code lum[13], chrom[13];
        for (int i = 0; i < 13; i++) {
            lum[i] = {(uint16_t)(kDcLum[i].code ^ ((1 << kDcLum[i].bits) - 1)), kDcLum[i].bits};
            chrom[i] = {(uint16_t)(kDcChrom[i].code ^ ((1 << kDcChrom[i].bits) - 1)), kDcChrom[i].bits};
        }
        dc_lum.build(lum, 13, 11);
        dc_chrom.build(chrom, 13, 12);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ------------------------------------------------------- WMV8's IDCT

// wmv2dsp.c: a row, then a column with the rows' extended precision
constexpr int W0 = 2048, W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108, W7 = 565;

inline void wmv2_idct_row(int16_t* b) {
    const int a1 = W1 * b[1] + W7 * b[7];
    const int a7 = W7 * b[1] - W1 * b[7];
    const int a5 = W5 * b[5] + W3 * b[3];
    const int a3 = W3 * b[5] - W5 * b[3];
    const int a2 = W2 * b[2] + W6 * b[6];
    const int a6 = W6 * b[2] - W2 * b[6];
    const int a0 = W0 * b[0] + W0 * b[4];
    const int a4 = W0 * b[0] - W0 * b[4];
    const int s1 = (int)(181U * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
    const int s2 = (int)(181U * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
    b[0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 7)) >> 8);
    b[1] = (int16_t)((a4 + a6 + s1 + (1 << 7)) >> 8);
    b[2] = (int16_t)((a4 - a6 + s2 + (1 << 7)) >> 8);
    b[3] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 7)) >> 8);
    b[4] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 7)) >> 8);
    b[5] = (int16_t)((a4 - a6 - s2 + (1 << 7)) >> 8);
    b[6] = (int16_t)((a4 + a6 - s1 + (1 << 7)) >> 8);
    b[7] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 7)) >> 8);
}

inline void wmv2_idct_col(int16_t* b) {
    const int a1 = (W1 * b[8 * 1] + W7 * b[8 * 7] + 4) >> 3;
    const int a7 = (W7 * b[8 * 1] - W1 * b[8 * 7] + 4) >> 3;
    const int a5 = (W5 * b[8 * 5] + W3 * b[8 * 3] + 4) >> 3;
    const int a3 = (W3 * b[8 * 5] - W5 * b[8 * 3] + 4) >> 3;
    const int a2 = (W2 * b[8 * 2] + W6 * b[8 * 6] + 4) >> 3;
    const int a6 = (W6 * b[8 * 2] - W2 * b[8 * 6] + 4) >> 3;
    const int a0 = (W0 * b[8 * 0] + W0 * b[8 * 4]) >> 3;
    const int a4 = (W0 * b[8 * 0] - W0 * b[8 * 4]) >> 3;
    const int s1 = (int)(181U * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
    const int s2 = (int)(181U * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
    b[8 * 0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 13)) >> 14);
    b[8 * 1] = (int16_t)((a4 + a6 + s1 + (1 << 13)) >> 14);
    b[8 * 2] = (int16_t)((a4 - a6 + s2 + (1 << 13)) >> 14);
    b[8 * 3] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 13)) >> 14);
    b[8 * 4] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 13)) >> 14);
    b[8 * 5] = (int16_t)((a4 - a6 - s2 + (1 << 13)) >> 14);
    b[8 * 6] = (int16_t)((a4 + a6 - s1 + (1 << 13)) >> 14);
    b[8 * 7] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 13)) >> 14);
}

inline void wmv2_idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
    for (int i = 0; i < 64; i += 8) wmv2_idct_row(blk + i);
    for (int i = 0; i < 8; i++) wmv2_idct_col(blk + i);
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) {
            const int v = blk[y * 8 + x] + (add ? dst[y * stride + x] : 0);
            dst[y * stride + x] = (uint8_t)std::min(std::max(v, 0), 255);
        }
}

// ------------------------------------------------------------- decoder

struct MbData {
    bool intra = false, skip = false, ac_pred = false;
    int aic_dir = 0;
    int mv[2] = {};
    int16_t blk[6][64];
    int last[6];
};

class Decoder {
  public:
    int version = V3, width = 0, height = 0, mb_w = 0, mb_h = 0;
    Picture cur, ref;
    bool have_ref = false;
    MvPred mvp;
    // the predictors, kept across pictures as FFmpeg keeps them: each luma
    // block's and each macroblock's chroma DCs (dequantised; 1024: none),
    // their first row and column of levels, the luma blocks' coded flags
    std::vector<int16_t> dc_val[3], ac_val[3];
    std::vector<uint8_t> coded;
    int dc_wrap[3] = {};
    BitReader br;
    int64_t features = 0;
    // the picture's choices
    bool inter = false, no_rnd = false, flipflop = false, use_skip = false, per_mb_rl = false,
         inter_intra = false;
    int qscale = 1, slice_height = 0, rl_index = 0, rl_chroma = 0, dc_table = 0, mv_table = 0;
    int bit_rate = 0, esc3_level = 0, esc3_run = 0, mb_x = 0, mb_y = 0;
    // WMV8's extradata and per-picture state
    bool abt = false, j_type_bit = false, mspel_bit = false, top_left_mv = false, per_mb_rl_bit = false;
    int cbp_table = 0;
    std::vector<uint8_t> skip_map;
    const uint8_t *y_dc_scale = nullptr, *c_dc_scale = nullptr;

    void feature(int f) { features |= (int64_t)1 << f; }

    void init(int v, int w, int h, const uint8_t* extra, int64_t extra_n) {
        version = v;
        width = w;
        height = h;
        mb_w = (w + 15) / 16;
        mb_h = (h + 15) / 16;
        cur.alloc(mb_w, mb_h);
        ref.alloc(mb_w, mb_h);
        dc_wrap[0] = 2 * mb_w + 1;
        dc_wrap[1] = dc_wrap[2] = mb_w + 1;
        for (int c = 0; c < 3; c++) {
            const size_t n = (size_t)dc_wrap[c] * ((c ? mb_h : 2 * mb_h) + 1);
            dc_val[c].assign(n, 1024);
            ac_val[c].assign(n * 16, 0);
        }
        coded.assign((size_t)dc_wrap[0] * (2 * mb_h + 1), 0);
        static const uint8_t kEight[32] = {0, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
                                           8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8};
        if (version == V2) {
            y_dc_scale = c_dc_scale = kEight;   // ff_mpeg1_dc_scale_table
        } else if (version == V3) {
            y_dc_scale = kOldYDcScale;
            c_dc_scale = kWmv1CDcScale;
        } else {
            y_dc_scale = kWmv1YDcScale;
            c_dc_scale = kWmv1CDcScale;
        }
        if (version == WMV2) wmv2_ext_header(extra, extra_n);
    }

    // decode_ext_header (wmv2dec.c): the extradata's 32 bits
    void wmv2_ext_header(const uint8_t* d, int64_t n) {
        if (n < 4) CORRUPT("WMV8 extradata of %lld bytes (4 needed)", (long long)n);
        BitReader b;
        b.reset(d, 4);
        b.skip(5);   // fps
        bit_rate = (int)b.get(11) * 1024;
        mspel_bit = b.get1();
        const bool loop = b.get1();
        abt = b.get1();
        j_type_bit = b.get1();
        top_left_mv = b.get1();
        per_mb_rl_bit = b.get1();
        const int code = (int)b.get(3);
        slice_height = mb_h / code;
        if (!slice_height) CORRUPT("WMV8 extradata with %d slices for %d rows", code, mb_h);
        if (loop) UNSUPPORTED("WMV8's loop filter (its extradata's loop filter bit)");
        if (top_left_mv) UNSUPPORTED("WMV8's top-left motion vector prediction flag");
    }

    static int decode012(BitReader& b) { return b.get1() ? (int)b.get1() + 1 : 0; }

    // ff_msmpeg4_decode_ext_header: v2's 16 bits, v3's and WMV7's 17
    void ext_header(int64_t size_bits) {
        const int64_t left = size_bits - br.pos;
        const int length = version >= V3 ? 17 : 16;
        if (left >= length && left < length + 8) {
            feature(F_EXT_HEADER);
            br.skip(5);   // fps
            bit_rate = (int)br.get(11) * 1024;
            flipflop = version >= V3 ? br.get1() : false;
        } else if (left < length + 8) {
            flipflop = false;
        }
    }

    // ff_msmpeg4_decode_picture_header (v2, v3, WMV7)
    void picture_header() {
        if (br.left() * 8 < (int64_t)mb_w * mb_h) CORRUPT("a picture of %lld bits (FFmpeg drops it)", (long long)br.left());
        const int type = (int)br.get(2);
        if (type > 1) CORRUPT("picture type %d", type + 1);
        inter = type == 1;
        qscale = (int)br.get(5);
        if (!qscale) CORRUPT("quantiser 0");
        if (!inter) {
            const int code = (int)br.get(5);
            if (code < 0x17) CORRUPT("slice code %d", code);
            slice_height = mb_h / (code - 0x16);
            if (!slice_height) CORRUPT("slice code %d gives more slices than rows", code);
            if (code > 0x17) feature(F_SLICES);
            if (version == V2) {
                rl_chroma = rl_index = 2;
                dc_table = 0;
            } else if (version == V3) {
                rl_chroma = decode012(br);
                rl_index = decode012(br);
                dc_table = br.get1();
            } else {
                ext_header(32);   // as if the packet were (2+5+5+17+7)/8 bytes
                per_mb_rl = bit_rate > 50 * 1024 ? br.get1() : false;
                if (!per_mb_rl) {
                    rl_chroma = decode012(br);
                    rl_index = decode012(br);
                }
                dc_table = br.get1();
                inter_intra = false;
            }
            no_rnd = true;
        } else {
            if (version == V2) {
                use_skip = br.get1();
                rl_index = rl_chroma = 2;
                dc_table = mv_table = 0;
            } else if (version == V3) {
                use_skip = br.get1();
                rl_index = rl_chroma = decode012(br);
                dc_table = br.get1();
                mv_table = br.get1();
            } else {
                use_skip = br.get1();
                per_mb_rl = bit_rate > 50 * 1024 ? br.get1() : false;
                if (!per_mb_rl) rl_index = rl_chroma = decode012(br);
                dc_table = br.get1();
                mv_table = br.get1();
                inter_intra = width * height < 320 * 240 && bit_rate <= 128 * 1024;
            }
            no_rnd = flipflop ? !no_rnd : false;
        }
    }

    // ff_wmv2_decode_picture_header and _secondary_picture_header; false:
    // a P-picture whose skip map skips every macroblock (FRAME_SKIPPED)
    bool wmv2_header() {
        inter = br.get1();
        if (!inter) br.skip(7);
        qscale = (int)br.get(5);
        if (!qscale) CORRUPT("quantiser 0");
        if (inter && br.show(1)) {   // a skip map that skips everything
            BitReader b = br;
            const int type = (int)b.get(2);
            int run = type == 3 ? mb_w : mb_h;
            while (run > 0) {
                const int block = std::min(run, 25);
                if ((int64_t)b.get(block) + 1 != (int64_t)1 << block) break;
                run -= block;
            }
            if (!run) return false;
        }
        if (!inter) {
            const bool j_type = j_type_bit ? br.get1() : false;
            if (j_type) UNSUPPORTED("WMV8 J-pictures (IntraX8)");
            per_mb_rl = per_mb_rl_bit ? br.get1() : false;
            if (!per_mb_rl) {
                rl_chroma = decode012(br);
                rl_index = decode012(br);
            }
            dc_table = br.get1();
            if (br.left() * 8 < (int64_t)mb_w * mb_h) CORRUPT("a picture of %lld bits (FFmpeg drops it)", (long long)br.left());
            inter_intra = false;
            no_rnd = true;
        } else {
            skip_types();
            static const uint8_t kMap[3][3] = {{0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
            cbp_table = kMap[(qscale > 10) + (qscale > 20)][decode012(br)];
            feature(F_CBP_TABLE_0 + cbp_table);
            if (mspel_bit && br.get1()) UNSUPPORTED("WMV8 mspel motion compensation");
            if (abt) {
                const bool per_mb_abt = !br.get1();
                if (per_mb_abt) UNSUPPORTED("WMV8 ABT block types chosen per macroblock");
                if (decode012(br)) UNSUPPORTED("WMV8 ABT blocks other than 8x8");
            }
            per_mb_rl = per_mb_rl_bit ? br.get1() : false;
            if (!per_mb_rl) rl_index = rl_chroma = decode012(br);
            if (br.left() < 2) CORRUPT("truncated WMV8 picture header");
            dc_table = br.get1();
            mv_table = br.get1();
            inter_intra = false;
            no_rnd = !no_rnd;
        }
        return true;
    }

    // parse_mb_skip
    void skip_types() {
        skip_map.assign((size_t)mb_w * mb_h, 0);
        const int type = (int)br.get(2);
        if (type) feature(F_SKIP_MAP);
        if (type == 1) {
            if (br.left() < (int64_t)mb_w * mb_h) CORRUPT("truncated WMV8 skip map");
            for (auto& s : skip_map) s = (uint8_t)br.get1();
        } else if (type == 2) {
            for (int y = 0; y < mb_h; y++) {
                if (br.left() < 1) CORRUPT("truncated WMV8 skip map");
                const bool all = br.get1();
                for (int x = 0; x < mb_w; x++) skip_map[y * mb_w + x] = all ? 1 : (uint8_t)br.get1();
            }
        } else if (type == 3) {
            for (int x = 0; x < mb_w; x++) {
                if (br.left() < 1) CORRUPT("truncated WMV8 skip map");
                const bool all = br.get1();
                for (int y = 0; y < mb_h; y++) skip_map[y * mb_w + x] = all ? 1 : (uint8_t)br.get1();
            }
        }
        int64_t coded_mbs = 0;
        for (uint8_t s : skip_map) coded_mbs += !s;
        if (coded_mbs > br.left()) CORRUPT("a WMV8 picture shorter than its coded macroblocks");
    }

    // one packet: its picture (MSM_OK, planes in ``ref``)
    int decode(const uint8_t* d, int64_t n) {
        br.reset(d, n);
        if (version == WMV2) {
            if (!wmv2_header()) return MSM_NO_FRAME;
        } else {
            picture_header();
        }
        if (inter && !have_ref) CORRUPT("a P-picture without a reference picture");
        if (inter) feature(F_P_PICTURES);
        if (no_rnd && inter) feature(F_FLIPFLOP);
        if (per_mb_rl) feature(F_PER_MB_RL);
        if (use_skip && inter) feature(F_SKIP_CODE);
        if (inter_intra && inter) feature(F_INTER_INTRA);
        esc3_level = esc3_run = 0;
        mvp.init_mv(mb_w, mb_h);
        for (mb_y = 0; mb_y < mb_h; mb_y++) {
            if (mb_y == 0 || mb_y % slice_height == 0) {   // a new slice
                if (mb_y && version < WMV1) clean_buffers();
                mvp.first_line = true;
                mvp.resync_x = 0;
                mvp.resync_y = mb_y;
            }
            for (mb_x = 0; mb_x < mb_w; mb_x++) {
                if (mvp.resync_x == mb_x && mvp.resync_y + 1 == mb_y) mvp.first_line = false;
                MbData mb;
                if (version == WMV2) wmv2_mb(mb);
                else if (version == V2) v2_mb(mb);
                else v34_mb(mb);
                const bool moved = !mb.intra && !mb.skip;
                mvp.set_mv16(mb_x, mb_y, moved ? mb.mv[0] : 0, moved ? mb.mv[1] : 0);
                br.check();
                reconstruct(mb);
            }
        }
        if (version < WMV1 && !inter) ext_header(n * 8);
        std::swap(cur, ref);
        have_ref = true;
        return MSM_OK;
    }

    // ff_mpeg4_clean_buffers at a slice's start (v2, v3): the predictors of
    // the row above
    void clean_buffers() {
        const int lw = dc_wrap[0], cw = dc_wrap[1];
        const size_t l = (size_t)(2 * mb_y) * lw;   // row 2*mb_y - 1, column -1
        std::fill(dc_val[0].begin() + l, dc_val[0].begin() + l + 2 * lw + 1, 1024);
        std::fill(ac_val[0].begin() + l * 16, ac_val[0].begin() + (l + 2 * lw + 1) * 16, 0);
        const size_t c = (size_t)mb_y * cw;
        for (int k = 1; k < 3; k++) {
            std::fill(dc_val[k].begin() + c, dc_val[k].begin() + c + cw + 1, 1024);
            std::fill(ac_val[k].begin() + c * 16, ac_val[k].begin() + (c + cw + 1) * 16, 0);
        }
    }

    void skipped(MbData& mb) {
        feature(F_SKIPPED_MB);
        mb.skip = true;
        mb.intra = false;
        mb.mv[0] = mb.mv[1] = 0;
        for (int i = 0; i < 6; i++) mb.last[i] = -1;
    }

    // msmpeg4v2_decode_motion: H.263's MVD, the range wrapped at +-64
    int v2_motion(int pred) {
        int code = br.vlc(tables().mvd);
        if (code == 0) return pred;
        const int sign = br.get1();
        int val = sign ? -code : code;
        val += pred;
        if (val <= -64) {
            val += 64;
            feature(F_MV_WRAP);
        } else if (val >= 64) {
            val -= 64;
            feature(F_MV_WRAP);
        }
        return val;
    }

    // ff_msmpeg4_decode_motion
    void motion(int* mx, int* my) {
        const int sym = tables().mv[mv_table].read(br);
        feature(F_MV_TABLE_0 + mv_table);
        int x, y;
        if (sym) {
            x = sym >> 8;
            y = sym & 0xFF;
        } else {
            feature(F_MV_ESCAPE);
            x = (int)br.get(6);
            y = (int)br.get(6);
        }
        x += *mx - 32;
        y += *my - 32;
        auto wrap = [&](int& v) {
            if (v <= -64) {
                v += 64;
                feature(F_MV_WRAP);
            } else if (v >= 64) {
                v -= 64;
                feature(F_MV_WRAP);
            }
        };
        wrap(x);
        wrap(y);
        *mx = x;
        *my = y;
    }

    // msmpeg4v12_decode_mb (v2)
    void v2_mb(MbData& mb) {
        const Tables& t = tables();
        int cbp;
        if (inter) {
            if (use_skip && br.get1()) return skipped(mb);
            const int code = br.vlc(t.v2_mb_type);
            mb.intra = code >> 2;
            cbp = code & 3;
        } else {
            mb.intra = true;
            cbp = br.vlc(t.v2_intra_cbpc);
        }
        if (!mb.intra) {
            cbp |= br.vlc(t.cbpy) << 2;
            if ((cbp & 3) != 3) cbp ^= 0x3C;
            int px, py;
            mvp.pred_mv(0, mb_x, mb_y, &px, &py);
            mb.mv[0] = v2_motion(px);
            mb.mv[1] = v2_motion(py);
        } else {
            if (inter) feature(F_INTRA_IN_P);
            mb.ac_pred = br.get1();
            cbp |= br.vlc(t.cbpy) << 2;
        }
        blocks(mb, cbp);
    }

    // ff_msmpeg4_coded_block_pred: the luma block's coded flag predicted
    // from the left (A), above-left (B) and above (C) blocks'
    uint8_t& coded_at(int n) {
        return coded[(size_t)(2 * mb_y + (n >> 1) + 1) * dc_wrap[0] + 2 * mb_x + (n & 1) + 1];
    }
    int intra_cbp(int code) {
        int cbp = 0;
        for (int i = 0; i < 6; i++) {
            int val = (code >> (5 - i)) & 1;
            if (i < 4) {
                uint8_t& c = coded_at(i);
                const int w = dc_wrap[0];
                const int a = (&c)[-1], b = (&c)[-1 - w], cc = (&c)[-w];
                val ^= b == cc ? a : cc;
                c = (uint8_t)val;
            }
            cbp |= val << (5 - i);
        }
        return cbp;
    }

    // msmpeg4v34_decode_mb (v3, WMV7)
    void v34_mb(MbData& mb) {
        const Tables& t = tables();
        if (br.left() <= 0) CORRUPT("truncated picture at macroblock (%d, %d)", mb_x, mb_y);
        int cbp;
        if (inter) {
            if (use_skip && br.get1()) return skipped(mb);
            const int code = t.cbp[3].read(br);
            mb.intra = !(code & 0x40);
            cbp = code & 0x3F;
        } else {
            mb.intra = true;
            cbp = intra_cbp(t.mb_i.read(br));
        }
        if (!mb.intra) {
            if (per_mb_rl && cbp) rl_index = rl_chroma = decode012(br);
            int px, py;
            mvp.pred_mv(0, mb_x, mb_y, &px, &py);
            motion(&px, &py);
            mb.mv[0] = px;
            mb.mv[1] = py;
        } else {
            if (inter) feature(F_INTRA_IN_P);
            mb.ac_pred = br.get1();
            if (inter_intra) mb.aic_dir = br.vlc(t.inter_intra);
            if (per_mb_rl && cbp) rl_index = rl_chroma = decode012(br);
        }
        blocks(mb, cbp);
    }

    // ff_wmv2_decode_mb
    void wmv2_mb(MbData& mb) {
        const Tables& t = tables();
        int cbp;
        if (inter) {
            if (skip_map[mb_y * mb_w + mb_x]) return skipped(mb);
            if (br.left() <= 0) CORRUPT("truncated picture at macroblock (%d, %d)", mb_x, mb_y);
            const int code = t.cbp[cbp_table].read(br);
            mb.intra = !(code & 0x40);
            cbp = code & 0x3F;
        } else {
            mb.intra = true;
            if (br.left() <= 0) CORRUPT("truncated picture at macroblock (%d, %d)", mb_x, mb_y);
            cbp = intra_cbp(t.mb_i.read(br));
        }
        if (!mb.intra) {
            int px, py;
            mvp.pred_mv(0, mb_x, mb_y, &px, &py);   // wmv2_pred_motion, type 2
            if (cbp && per_mb_rl) rl_index = rl_chroma = decode012(br);
            // (abt: per_mb_abt is refused in the header)
            motion(&px, &py);
            mb.mv[0] = px;
            mb.mv[1] = py;
        } else {
            if (inter) feature(F_INTRA_IN_P);
            mb.ac_pred = br.get1();
            if (per_mb_rl && cbp) rl_index = rl_chroma = decode012(br);
        }
        blocks(mb, cbp);
    }

    void blocks(MbData& mb, int cbp) {
        if (mb.intra && mb.ac_pred) feature(F_AC_PRED);
        for (int n = 0; n < 6; n++) block(mb, n, (cbp >> (5 - n)) & 1);
    }

    // the first-row rule, the scales and the direction of
    // ff_msmpeg4_pred_dc; returns the prediction, sets dir (0 left, 1 up)
    int pred_dc(MbData& mb, int n, int16_t** store, int* dir) {
        const int c = n < 4 ? 0 : n - 3;
        const int scale = n < 4 ? y_dc_scale[qscale] : c_dc_scale[qscale];
        const int wrap = dc_wrap[c];
        const size_t at = n < 4 ? (size_t)(2 * mb_y + (n >> 1) + 1) * wrap + 2 * mb_x + (n & 1) + 1
                                : (size_t)(mb_y + 1) * wrap + mb_x + 1;
        int16_t* dc = &dc_val[c][at];
        int a = dc[-1], b = dc[-1 - wrap], cc = dc[-wrap];
        if (mvp.first_line && !(n & 2) && version < WMV1) b = cc = 1024;
        a = (a + (scale >> 1)) / scale;
        b = (b + (scale >> 1)) / scale;
        cc = (cc + (scale >> 1)) / scale;
        *store = dc;
        int pred;
        if (version > V3) {
            if (inter_intra && mb.intra && inter) {
                feature(F_INTER_INTRA);
                if (n == 1) {
                    pred = a;
                    *dir = 0;
                } else if (n == 2) {
                    pred = cc;
                    *dir = 1;
                } else if (n == 3) {
                    if (std::abs(a - b) < std::abs(b - cc)) {
                        pred = cc;
                        *dir = 1;
                    } else {
                        pred = a;
                        *dir = 0;
                    }
                } else {
                    // the mean of the decoded block to the left and above
                    const Plane& p = cur.p[c];
                    const int bx = n < 4 ? 16 * mb_x : 8 * mb_x, by = n < 4 ? 16 * mb_y : 8 * mb_y;
                    auto get_dc = [&](int x0, int y0) {
                        int sum = 0;
                        for (int y = 0; y < 8; y++)
                            for (int x = 0; x < 8; x++) sum += p.at(x0, y0)[y * p.w + x];
                        return (sum + ((scale * 8) >> 1)) / (scale * 8);
                    };
                    a = mb_x == 0 ? (1024 + (scale >> 1)) / scale : get_dc(bx - 8, by);
                    cc = mb_y == 0 ? (1024 + (scale >> 1)) / scale : get_dc(bx, by - 8);
                    const int d = mb.aic_dir;
                    if (d == 0 || (d == 1 && n != 0) || (d == 2 && n == 0)) {
                        pred = a;
                        *dir = 0;
                    } else {
                        pred = cc;
                        *dir = 1;
                    }
                }
            } else if (std::abs(a - b) < std::abs(b - cc)) {
                pred = cc;
                *dir = 1;
            } else {
                pred = a;
                *dir = 0;
            }
        } else if (std::abs(a - b) <= std::abs(b - cc)) {
            pred = cc;
            *dir = 1;
        } else {
            pred = a;
            *dir = 0;
        }
        return pred;
    }

    // msmpeg4_decode_dc: the quantised DC, its predictor updated
    int decode_dc(MbData& mb, int n, int* dir) {
        const Tables& t = tables();
        int level;
        if (version == V2) {
            // MPEG-4's DC size code with its bits inverted, then the value
            const int size = br.vlc(n < 4 ? t.dc_lum : t.dc_chrom);
            if (size == 0) {
                level = 0;
            } else {
                const int v = (int)br.get(size);
                level = (v >> (size - 1)) ? v : v - (1 << size) + 1;
                if (size > 8) br.skip(1);   // the marker
            }
        } else {
            level = t.dc[dc_table][n >= 4].read(br);
            feature(F_DC_TABLE_0 + dc_table);
            if (level == kDcMax) {
                feature(F_DC_ESCAPE);
                level = (int)br.get(8);
                if (br.get1()) level = -level;
            } else if (level != 0 && br.get1()) {
                level = -level;
            }
        }
        int16_t* store;
        level += pred_dc(mb, n, &store, dir);
        *store = (int16_t)(level * (n < 4 ? y_dc_scale[qscale] : c_dc_scale[qscale]));
        return level;
    }

    // ff_msmpeg4_decode_block: levels in raster order (intra ones not yet
    // dequantised, inter ones dequantised as FFmpeg's RL tables do it)
    void block(MbData& mb, int n, bool coded_blk) {
        const Tables& t = tables();
        int16_t* blk = mb.blk[n];
        memset(blk, 0, 64 * sizeof(int16_t));
        const RunLevelTable* rl;
        const uint8_t* scan;
        int qmul, qadd, run_diff, i, dir = 0;
        if (mb.intra) {
            qmul = 1;
            qadd = 0;
            int level = decode_dc(mb, n, &dir);
            if (level < 0 && inter_intra) level = 0;   // FFmpeg goes on either way
            if (n < 4) {
                rl = &t.rl[rl_index];
                feature(F_RL_LUMA_0 + rl_index);
            } else {
                rl = &t.rl[3 + rl_chroma];
                feature(F_RL_CHROMA_0 + rl_chroma);
            }
            if (level > 256 * (n < 4 ? y_dc_scale[qscale] : c_dc_scale[qscale]) && !inter_intra)
                CORRUPT("DC overflow at macroblock (%d, %d)", mb_x, mb_y);
            blk[0] = (int16_t)level;
            run_diff = version >= WMV1;
            i = 0;
            if (mb.ac_pred) scan = dir == 0 ? (version >= WMV1 ? kWmv1Scan3 : kAltVertical)
                                            : (version >= WMV1 ? kWmv1Scan2 : kAltHorizontal);
            else scan = version >= WMV1 ? kWmv1Scan1 : kZigzag;
            if (!coded_blk) {
                pred_ac(mb, n, dir);
                mb.last[n] = 0;
                return;
            }
        } else {
            qmul = qscale << 1;
            qadd = (qscale - 1) | 1;
            i = -1;
            rl = &t.rl[3 + rl_index];
            run_diff = version != V2;
            if (!coded_blk) {
                mb.last[n] = -1;
                return;
            }
            feature(F_RL_INTER_0 + rl_index);
            scan = version >= WMV1 ? kWmv1Scan0 : kZigzag;
        }
        while (true) {
            int sym = rl->vlc.read(br);
            int run, level, last;
            if (sym != rl->n) {
                last = sym >= rl->last;
                run = rl->run[sym] + 1;
                level = rl->level[sym] * qmul + qadd;
                if (br.get1()) level = -level;
                i += run;
            } else if (!br.show(1)) {
                if (!(br.show(2) & 1)) {   // escape 3
                    feature(F_ESCAPE_3);
                    br.skip(2);
                    last = br.get1();
                    if (version <= V3) {
                        run = (int)br.get(6);
                        level = (int8_t)br.get(8);
                    } else {
                        if (!esc3_level) {
                            int ll;
                            if (qscale < 8) {
                                ll = (int)br.get(3);
                                if (!ll) ll = 8 + br.get1();
                            } else {
                                ll = 2;
                                while (ll < 8 && !br.show(1)) {
                                    ll++;
                                    br.skip(1);
                                }
                                if (ll < 8) br.skip(1);
                            }
                            esc3_level = ll;
                            esc3_run = (int)br.get(2) + 3;
                        }
                        run = (int)br.get(esc3_run);
                        const int sign = br.get1();
                        level = (int)br.get(esc3_level);
                        if (sign) level = -level;
                    }
                    level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                    i += run + 1;
                } else {   // escape 2: the run offset by the level's longest
                    feature(F_ESCAPE_2);
                    br.skip(2);
                    sym = rl->vlc.read(br);
                    if (sym == rl->n) CORRUPT("an escape after escape 2 at macroblock (%d, %d)", mb_x, mb_y);
                    last = sym >= rl->last;
                    const int l = rl->level[sym];
                    level = l * qmul + qadd;
                    i += rl->run[sym] + 1 + rl->max_run[last][l] + run_diff;
                    if (br.get1()) level = -level;
                }
            } else {   // escape 1: the level offset by the run's largest
                feature(F_ESCAPE_1);
                br.skip(1);
                sym = rl->vlc.read(br);
                if (sym == rl->n) CORRUPT("an escape after escape 1 at macroblock (%d, %d)", mb_x, mb_y);
                last = sym >= rl->last;
                run = rl->run[sym];
                level = (rl->level[sym] + rl->max_level[last][run]) * qmul + qadd;
                i += run + 1;
                if (br.get1()) level = -level;
            }
            if (last && i < 64) {
                blk[scan[i]] = (int16_t)level;
                break;
            }
            if (i > 62) {   // past the block, or not ending it at 63: dropped
                if (br.left() < 0) CORRUPT("a run past the block's end at macroblock (%d, %d)", mb_x, mb_y);
                feature(F_OVERFLOW_IGNORED);
                i = 63;
                break;
            }
            blk[scan[i]] = (int16_t)level;
        }
        if (mb.intra) {
            pred_ac(mb, n, dir);
            if (mb.ac_pred) i = 63;
        }
        mb.last[n] = i;
    }

    // ff_mpeg4_pred_ac: the first column (from the left, dir 0) or row
    // (from above) added from the neighbour's, the block's own stored
    void pred_ac(MbData& mb, int n, int dir) {
        int16_t* blk = mb.blk[n];
        const int c = n < 4 ? 0 : n - 3;
        const int wrap = dc_wrap[c];
        const size_t at = n < 4 ? (size_t)(2 * mb_y + (n >> 1) + 1) * wrap + 2 * mb_x + (n & 1) + 1
                                : (size_t)(mb_y + 1) * wrap + mb_x + 1;
        int16_t* ac = &ac_val[c][at * 16];
        if (mb.ac_pred) {
            if (dir == 0) {
                const int16_t* l = ac - 16;
                for (int k = 1; k < 8; k++) blk[k * 8] = (int16_t)(blk[k * 8] + l[k]);
            } else {
                const int16_t* tp = ac - 16 * (size_t)wrap;
                for (int k = 1; k < 8; k++) blk[k] = (int16_t)(blk[k] + tp[k + 8]);
            }
        }
        for (int k = 1; k < 8; k++) {
            ac[k] = blk[k * 8];
            ac[8 + k] = blk[k];
        }
    }

    // ff_clean_intra_table_entries: a macroblock that is not intra leaves
    // no predictor
    void clean_intra() {
        for (int n = 0; n < 4; n++) {
            const size_t at = (size_t)(2 * mb_y + (n >> 1) + 1) * dc_wrap[0] + 2 * mb_x + (n & 1) + 1;
            dc_val[0][at] = 1024;
            memset(&ac_val[0][at * 16], 0, 16 * sizeof(int16_t));
            if (version >= V3) coded[at] = 0;
        }
        for (int c = 1; c < 3; c++) {
            const size_t at = (size_t)(mb_y + 1) * dc_wrap[c] + mb_x + 1;
            dc_val[c][at] = 1024;
            memset(&ac_val[c][at * 16], 0, 16 * sizeof(int16_t));
        }
    }

    void transform(int16_t* blk, uint8_t* dst, int stride, bool add) const {
        if (version == WMV2) wmv2_idct(blk, dst, stride, add);
        else idct(blk, dst, stride, add);
    }

    void reconstruct(MbData& mb) {
        Plane* p = cur.p;
        const int x = mb_x, y = mb_y;
        uint8_t* dy = p[0].at(x * 16, y * 16);
        uint8_t* du = p[1].at(x * 8, y * 8);
        uint8_t* dv = p[2].at(x * 8, y * 8);
        const int ls = p[0].w, cs = p[1].w;
        uint8_t* dst[6] = {dy, dy + 8, dy + 8 * ls, dy + 8 * ls + 8, du, dv};
        const int stride[6] = {ls, ls, ls, ls, cs, cs};
        if (mb.intra) {
            // dct_unquantize_h263_intra, then the IDCT
            const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
            for (int n = 0; n < 6; n++) {
                int16_t* blk = mb.blk[n];
                blk[0] = (int16_t)(blk[0] * (n < 4 ? y_dc_scale[qscale] : c_dc_scale[qscale]));
                for (int i = 1; i < 64; i++) {
                    const int l = blk[i];
                    if (l) blk[i] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
                }
                transform(blk, dst[n], stride[n], false);
            }
            return;
        }
        clean_intra();
        const Edges e{mb_w * 16, mb_h * 16, width, height};
        mpeg_motion(ref, e, x, y, mb.mv[0], mb.mv[1], no_rnd, dy, du, dv, ls, cs);
        for (int n = 0; n < 6; n++)
            if (mb.last[n] >= 0) transform(mb.blk[n], dst[n], stride[n], true);
    }

    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        const int w = width, h = height, cw = (w + 1) / 2, ch = (h + 1) / 2;
        for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, ref.p[0].at(0, r), w);
        for (int r = 0; r < ch; r++) {
            memcpy(u + (size_t)r * cw, ref.p[1].at(0, r), cw);
            memcpy(v + (size_t)r * cw, ref.p[2].at(0, r), cw);
        }
    }
};

}  // namespace

// ===================================================================== C API

extern "C" {

// a decoder of MS-MPEG4 v2 (2), v3 (3), WMV7 (4) or WMV8 (5) at the
// container's size; WMV8 reads its extradata (MSM_OK, else the error in
// msg and the decoder freed)
int msmpeg4_dec_new(int64_t version, int64_t w, int64_t h, const uint8_t* extra, int64_t extra_n,
                    void** out, char* msg, int64_t cap) {
    tables();
    *out = nullptr;
    Decoder* d = new Decoder();
    try {
        if (version < V2 || version > WMV2) CORRUPT("unknown MS-MPEG4 version %lld", (long long)version);
        if (w <= 0 || h <= 0 || w > 16384 || h > 16384) CORRUPT("a %lldx%lld picture", (long long)w, (long long)h);
        d->init((int)version, (int)w, (int)h, extra, extra_n);
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        delete d;
        return f.kind;
    }
    *out = d;
    return MSM_OK;
}

void msmpeg4_dec_free(void* h) { delete (Decoder*)h; }

// Decode one packet; on MSM_OK msmpeg4_dec_output copies the picture's
// I420 planes out (MSM_NO_FRAME: a WMV8 picture that skips everything)
int msmpeg4_dec_decode(void* h, const uint8_t* data, int64_t n, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        return d->decode(data, n);
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

void msmpeg4_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { ((Decoder*)h)->output(y, u, v); }

int64_t msmpeg4_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
