// VP9 decoder (profile 0: 8-bit 4:2:0) in host C++: what FFmpeg's native
// vp9 decoder gives cv2.VideoCapture, frame for frame.  VP9's
// reconstruction is exact integer arithmetic, and FFmpeg's decoder is
// bit-exact to libvpx's; where the two read the bitstream differently the
// rules below are FFmpeg's:
//
//   * a packet may be a superframe: its index (the last bytes) splits it
//     into frames, decoded in turn, as FFmpeg's vp9_superframe_split does;
//   * a frame with show_frame = 0 updates the references and hands over no
//     picture; show_existing_frame hands over a reference again;
//   * the above contexts are cleared once a frame, the left ones at each
//     tile column of each superblock row; intra prediction reads the
//     unfiltered reconstruction inside the 8-aligned decoded area (127
//     above the frame, 129 left of it and of a tile column), motion
//     compensation reads references edge-extended at their visible size;
//   * the previous frame's motion vectors are candidates when it was shown,
//     had this frame's size and this frame is not error resilient;
//   * a segmentation map persists while a frame keeps segmentation enabled
//     without updating it;
//   * the loop filter runs over the whole frame after its tiles, superblock
//     by superblock (luma, then chroma; columns, then rows), with libvpx's
//     edge masks;
//   * probabilities adapt backwards (coefficients always, modes and motion
//     vectors on inter frames) unless error_resilient_mode or
//     frame_parallel_decoding_mode is set.
//
// A reference of another size is read through FFmpeg's scaled motion
// compensation (mc_scaled).  Profiles 1-3 and frames FFmpeg refuses raise
// (vp9_dec_decode's codes).  Output: yuv420p planes at the frame size.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "vp9_tables.h"

namespace {

using namespace vp9tab;

enum Code { OK = 0, NO_FRAME = 1, CORRUPT = 2, UNSUPPORTED = 3 };

struct Error : std::runtime_error {
    int code;
    Error(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

// what a stream reached (vp9.py's FEATURES, in order)
enum Feature {
    F_TILE_COLS, F_TILE_ROWS, F_HIDDEN, F_SUPERFRAME, F_SHOW_EXISTING, F_INTRA_ONLY,
    F_ERROR_RES, F_ADAPT, F_SEGMENTATION, F_SEG_TEMPORAL, F_SEG_ALT_Q, F_SEG_ALT_LF,
    F_SEG_REF, F_SEG_SKIP, F_LOSSLESS, F_COMPOUND, F_SWITCHABLE, F_SMOOTH, F_SHARP,
    F_BILINEAR, F_HIGH_PRECISION, F_TX_SELECT, F_TX32, F_SUB8X8, F_SCALED, F_RESET_CTX,
    F_LF_DELTAS, F_SHARPNESS, F_Q_DELTAS, F_FULL_RANGE, F_COLOR_SPACE, F_NO_CTX_REFRESH,
    F_SIZE_CHANGE, F_PREV_MVS, F_INTRA_IN_INTER, F_NEW_MV, F_CTX_IDX,
};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// ------------------------------------------------------------ enums
enum { KEY_FRAME = 0 };
enum { INTRA_FRAME = 0, LAST_FRAME = 1, GOLDEN_FRAME = 2, ALTREF_FRAME = 3, NONE_FRAME = -1 };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED,
       TM_PRED, NEARESTMV, NEARMV, ZEROMV, NEWMV };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32 };
enum { ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST };
enum { B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16, B32X32, B32X64, B64X32, B64X64 };
enum { PART_NONE, PART_HORZ, PART_VERT, PART_SPLIT };
// libvpx's filter numbering (the switchable tree's): regular, smooth, sharp, bilinear
enum { EIGHTTAP = 0, EIGHTTAP_SMOOTH = 1, EIGHTTAP_SHARP = 2, BILINEAR = 3, SWITCHABLE = 4 };
enum { SINGLE_REF, COMPOUND_REF, REF_SELECT };
enum { SEG_ALT_Q, SEG_ALT_LF, SEG_REF, SEG_SKIP };

const uint8_t kBw8[13] = {1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8};   // width in 8x8 units
const uint8_t kBh8[13] = {1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8};
const uint8_t kBw4[13] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16};  // in 4x4 units
const uint8_t kBh4[13] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16};
const uint8_t kMaxTx[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
const uint8_t kSizeGroup[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
const uint8_t kTxModeMax[5] = {0, 1, 2, 3, 3};
const uint8_t kSubsize[4][13] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12},
    {255, 255, 255, B8X4, 255, 255, B16X8, 255, 255, B32X16, 255, 255, B64X32},
    {255, 255, 255, B4X8, 255, 255, B8X16, 255, 255, B16X32, 255, 255, B32X64},
    {255, 255, 255, B4X4, 255, 255, B8X8, 255, 255, B16X16, 255, 255, B32X32}};
// partition context values (above, left) of each block size
const uint8_t kPartCtxAbove[13] = {15, 15, 14, 14, 14, 12, 12, 12, 8, 8, 8, 0, 0};
const uint8_t kPartCtxLeft[13] = {15, 14, 15, 14, 12, 14, 12, 8, 12, 8, 0, 8, 0};
const uint8_t kModeToTxType[10] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST,
                                   ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST};
const uint8_t kLiteralToFilter[4] = {EIGHTTAP_SMOOTH, EIGHTTAP, EIGHTTAP_SHARP, BILINEAR};
const uint8_t kSegFeatureBits[4] = {8, 6, 2, 0};
const uint8_t kSegFeatureMax[4] = {255, 63, 3, 0};
const bool kSegFeatureSigned[4] = {true, true, false, false};

// trees (libvpx's vpx_tree_index arrays)
const int8_t kIntraModeTree[18] = {-DC_PRED, 2, -TM_PRED, 4, -V_PRED, 6, 8, 12, -H_PRED, 10,
                                   -D135_PRED, -D117_PRED, -D45_PRED, 14, -D63_PRED, 16,
                                   -D153_PRED, -D207_PRED};
const int8_t kSegmentTree[14] = {2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7};
const int8_t kPartitionTree[6] = {-PART_NONE, 2, -PART_HORZ, 4, -PART_VERT, -PART_SPLIT};
const int8_t kInterModeTree[6] = {-(ZEROMV - NEARESTMV), 2, -(NEARESTMV - NEARESTMV), 4,
                                  -(NEARMV - NEARESTMV), -(NEWMV - NEARESTMV)};
const int8_t kSwitchableTree[4] = {-EIGHTTAP, 2, -EIGHTTAP_SMOOTH, -EIGHTTAP_SHARP};
const int8_t kMvJointTree[6] = {0, 2, -1, 4, -2, -3};
const int8_t kMvClassTree[20] = {0, 2, -1, 4, 6, 8, -2, -3, 10, 12, -4, -5, -6, 14,
                                 16, 18, -7, -8, -9, -10};
const int8_t kMvFrTree[6] = {0, 2, -1, 4, -2, -3};
const int8_t kCoefConTree[16] = {2, 6, -2, 4, -3, -4, 8, 10, -5, -6, 12, 14, -7, -8, -9, -10};

// token categories: extra-bit probabilities, base values
const uint8_t kCat1[1] = {159}, kCat2[2] = {165, 145}, kCat3[3] = {173, 148, 140},
              kCat4[4] = {176, 155, 140, 135}, kCat5[5] = {180, 157, 141, 134, 130},
              kCat6[14] = {254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133, 130, 129};
const uint8_t kEnergyClass[12] = {0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5, 5};

// motion vector candidates: (row, col) in 8x8 units, per block size
const int8_t kMvRefBlocks[13][8][2] = {
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, -1}, {-2, 0}, {0, -2}, {-2, -1}, {-1, -2}, {-2, -2}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, -1}, {0, -2}, {-2, 0}, {-2, -1}, {-1, -2}},
    {{-1, 0}, {0, -1}, {-1, 1}, {-1, -1}, {-2, 0}, {0, -2}, {-1, -2}, {-2, -1}},
    {{-1, 0}, {0, -1}, {-1, 1}, {1, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {2, -1}, {-1, -1}, {-1, 1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 2}, {-1, -1}, {1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{-1, 1}, {1, -1}, {-1, 2}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {4, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {2, -1}},
    {{-1, 0}, {0, -1}, {-1, 4}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-1, 2}},
    {{-1, 3}, {3, -1}, {-1, 4}, {4, -1}, {-1, -1}, {-1, 0}, {0, -1}, {-1, 6}}};
const int kModeToCounter[14] = {9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 0, 0, 3, 1};
const int kCounterToContext[19] = {2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6};
const int kSubblockFromColumn[4][2] = {{1, 2}, {1, 3}, {3, 2}, {3, 3}};

// ------------------------------------------------------------ scans
struct ScanOrder {
    const int16_t* scan;
    std::vector<int16_t> nb;   // two raster neighbours per position
};

struct Scans {
    ScanOrder s[4][4];   // [tx size][tx type]
    Scans() {
        const int16_t* d[4] = {kDefaultScan4x4, kDefaultScan8x8, kDefaultScan16x16, kDefaultScan32x32};
        const int16_t* c[3] = {kColScan4x4, kColScan8x8, kColScan16x16};
        const int16_t* r[3] = {kRowScan4x4, kRowScan8x8, kRowScan16x16};
        for (int t = 0; t < 4; t++)
            for (int k = 0; k < 4; k++) {
                // ADST_DCT reads rows first, DCT_ADST columns; 32x32 has one scan
                int kind = t == 3 ? 0 : k == ADST_DCT ? 2 : k == DCT_ADST ? 1 : 0;
                const int16_t* sc = kind == 0 ? d[t] : kind == 1 ? c[t] : r[t];
                s[t][k].scan = sc;
                const int n = 4 << t;
                std::vector<int16_t>& nb = s[t][k].nb;
                nb.assign(2 * (n * n + 1), 0);
                for (int p = 1; p < n * n; p++) {
                    const int rc = sc[p], i = rc / n, j = rc % n;
                    int a, b;
                    if (i > 0 && j > 0) {
                        const int up = (i - 1) * n + j, left = i * n + j - 1;
                        if (kind == 1) a = b = up;
                        else if (kind == 2) a = b = left;
                        else a = up, b = left;
                    } else if (i > 0) {
                        a = b = (i - 1) * n + j;
                    } else {
                        a = b = i * n + j - 1;
                    }
                    nb[2 * p] = (int16_t)a;
                    nb[2 * p + 1] = (int16_t)b;
                }
            }
    }
};
const Scans& scans() {
    static const Scans s;
    return s;
}

inline int band_of(int tx, int c) {
    static const uint8_t b4[16] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5};
    static const uint8_t b8[21] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4};
    return tx == TX_4X4 ? b4[c] : c < 21 ? b8[c] : 5;
}

// ------------------------------------------------------------ bit readers
struct BitReader {   // the uncompressed header
    const uint8_t* d;
    size_t n, pos = 0;
    BitReader(const uint8_t* data, size_t size) : d(data), n(size) {}
    int bit() {
        if (pos >= 8 * n) throw Error(CORRUPT, "the frame header runs past the end of the frame");
        int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    int f(int bits) {
        int v = 0;
        for (int i = 0; i < bits; i++) v = (v << 1) | bit();
        return v;
    }
    int s(int bits) {   // su(n): magnitude, then sign
        int v = f(bits);
        return bit() ? -v : v;
    }
    size_t bytes() const { return (pos + 7) >> 3; }
};

struct BoolDecoder {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    uint64_t value = 0;
    int count = -8;
    uint32_t range = 255;
    size_t overrun = 0;

    void init(const uint8_t* data, size_t size) {
        p = data;
        end = data + size;
        value = 0;
        count = -8;
        range = 255;
        overrun = 0;
        fill();
        if (read(128)) throw Error(CORRUPT, "a boolean decoder's marker bit is set");
    }
    void fill() {
        while (count <= 48) {
            uint64_t byte = 0;
            if (p < end) byte = *p++;
            else overrun++;
            value |= byte << (48 - count);
            count += 8;
        }
    }
    inline int read(int prob) {
        if (count < 8) fill();
        const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
        const uint64_t big = (uint64_t)split << 56;
        int bit;
        if (value >= big) {
            range -= split;
            value -= big;
            bit = 1;
        } else {
            range = split;
            bit = 0;
        }
        const int shift = __builtin_clz(range) - 24;
        range <<= shift;
        value <<= shift;
        count -= shift;
        return bit;
    }
    int literal(int bits) {
        int v = 0;
        for (int i = 0; i < bits; i++) v = (v << 1) | read(128);
        return v;
    }
    int tree(const int8_t* t, const uint8_t* probs) {
        int i = 0;
        while ((i = t[i + read(probs[i >> 1])]) > 0) {
        }
        return -i;
    }
};

// ------------------------------------------------------------ probabilities
struct MvComp {
    uint8_t sign, classes[10], class0[1], bits[10], class0_fr[2][3], fr[3], class0_hp, hp;
};

struct Probs {
    uint8_t coef[4][2][2][6][6][3];
    uint8_t y_mode[4][9], uv_mode[10][9], partition[16][3], skip[3];
    uint8_t tx8[2][1], tx16[2][2], tx32[2][3];
    uint8_t inter_mode[7][3], interp[4][2], is_inter[4], comp_inter[5], single_ref[5][2], comp_ref[5];
    uint8_t mv_joint[3];
    MvComp mv[2];
};

Probs default_probs() {
    Probs p;
    memcpy(p.coef, kCoefProbs, sizeof p.coef);
    memcpy(p.y_mode, kYModeProbs, sizeof p.y_mode);
    memcpy(p.uv_mode, kUvModeProbs, sizeof p.uv_mode);
    memcpy(p.partition, kPartitionProbs, sizeof p.partition);
    const uint8_t skip[3] = {192, 128, 64};
    memcpy(p.skip, skip, 3);
    const uint8_t tx8[2][1] = {{100}, {66}}, tx16[2][2] = {{20, 152}, {15, 101}},
                  tx32[2][3] = {{3, 136, 37}, {5, 52, 13}};
    memcpy(p.tx8, tx8, sizeof tx8);
    memcpy(p.tx16, tx16, sizeof tx16);
    memcpy(p.tx32, tx32, sizeof tx32);
    const uint8_t im[7][3] = {{2, 173, 34}, {7, 145, 85}, {7, 166, 63}, {7, 94, 66},
                              {8, 64, 46}, {17, 81, 31}, {25, 29, 30}};
    memcpy(p.inter_mode, im, sizeof im);
    const uint8_t interp[4][2] = {{235, 162}, {36, 255}, {34, 3}, {149, 144}};
    memcpy(p.interp, interp, sizeof interp);
    const uint8_t is_inter[4] = {9, 102, 187, 225}, comp_inter[5] = {239, 183, 119, 96, 41},
                  comp_ref[5] = {50, 126, 123, 221, 226};
    const uint8_t single_ref[5][2] = {{33, 16}, {77, 74}, {142, 142}, {172, 170}, {238, 247}};
    memcpy(p.is_inter, is_inter, 4);
    memcpy(p.comp_inter, comp_inter, 5);
    memcpy(p.comp_ref, comp_ref, 5);
    memcpy(p.single_ref, single_ref, sizeof single_ref);
    const uint8_t joints[3] = {32, 64, 96};
    memcpy(p.mv_joint, joints, 3);
    const uint8_t classes[2][10] = {{224, 144, 192, 168, 192, 176, 192, 198, 198, 245},
                                    {216, 128, 176, 160, 176, 176, 192, 198, 198, 208}};
    const uint8_t class0[2] = {216, 208};
    const uint8_t bits[10] = {136, 140, 148, 160, 176, 192, 224, 234, 234, 240};
    const uint8_t c0fr[2][3] = {{128, 128, 64}, {96, 112, 64}}, fr[3] = {64, 96, 64};
    for (int i = 0; i < 2; i++) {
        MvComp& m = p.mv[i];
        m.sign = 128;
        memcpy(m.classes, classes[i], 10);
        m.class0[0] = class0[i];
        memcpy(m.bits, bits, 10);
        memcpy(m.class0_fr, c0fr, 6);
        memcpy(m.fr, fr, 3);
        m.class0_hp = 160;
        m.hp = 128;
    }
    return p;
}

struct MvCounts {
    uint32_t sign[2], classes[11], class0[2], bits[10][2], class0_fr[2][4], fr[4], class0_hp[2], hp[2];
};

struct Counts {
    uint32_t coef[4][2][2][6][6][4];
    uint32_t eob[4][2][2][6][6];
    uint32_t y_mode[4][10], uv_mode[10][10], partition[16][4], skip[3][2];
    uint32_t tx8[2][2], tx16[2][3], tx32[2][4];
    uint32_t inter_mode[7][4], interp[4][3], is_inter[4][2], comp_inter[5][2], single_ref[5][2][2],
        comp_ref[5][2];
    uint32_t mv_joint[4];
    MvCounts mv[2];
};

// the inverse of libvpx's remapping of a coded probability delta
int inv_remap_prob(int v, int m) {
    static uint8_t map[255];
    static bool init = false;
    if (!init) {
        int k = 0;
        for (int i = 0; i < 20; i++) map[k++] = (uint8_t)(7 + 13 * i);
        for (int x = 1; x <= 253; x++)
            if ((x - 7) % 13 != 0 || x < 7) map[k++] = (uint8_t)x;
        map[254] = 253;
        init = true;
    }
    v = map[v];
    m--;
    auto recenter = [](int v, int m) {
        if (v > 2 * m) return v;
        return (v & 1) ? m - ((v + 1) >> 1) : m + (v >> 1);
    };
    if ((m << 1) <= 255) return 1 + recenter(v, m);
    return 255 - recenter(v, 255 - 1 - m);
}

int decode_term_subexp(BoolDecoder& r) {
    if (!r.read(128)) return r.literal(4);
    if (!r.read(128)) return r.literal(4) + 16;
    if (!r.read(128)) return r.literal(5) + 32;
    int v = r.literal(7);
    if (v < 65) return v + 64;
    v = (v << 1) - 65 + r.read(128);
    return v + 64;
}

void diff_update(BoolDecoder& r, uint8_t* p) {
    if (r.read(252)) *p = (uint8_t)inv_remap_prob(decode_term_subexp(r), *p);
}

void mv_update(BoolDecoder& r, uint8_t* p) {
    if (r.read(252)) *p = (uint8_t)((r.literal(7) << 1) | 1);
}

// ------------------------------------------------------------ inverse transforms
// libvpx's butterflies (vpx_dsp/inv_txfm.c): 14-bit cosine constants, each
// product rounded back by 14 bits
const int C1 = 16364, C2 = 16305, C3 = 16207, C4 = 16069, C5 = 15893, C6 = 15679, C7 = 15426,
          C8 = 15137, C9 = 14811, C10 = 14449, C11 = 14053, C12 = 13623, C13 = 13160, C14 = 12665,
          C15 = 12140, C16 = 11585, C17 = 11003, C18 = 10394, C19 = 9760, C20 = 9102, C21 = 8423,
          C22 = 7723, C23 = 7005, C24 = 6270, C25 = 5520, C26 = 4756, C27 = 3981, C28 = 3196,
          C29 = 2404, C30 = 1606, C31 = 804;
const int S1 = 5283, S2 = 9929, S3 = 13377, S4 = 15212;   // sinpi_k_9

inline int R14(int64_t x) { return (int)((x + (1 << 13)) >> 14); }

void idct4(const int* in, int* out) {
    const int s0 = R14((int64_t)(in[0] + in[2]) * C16), s1 = R14((int64_t)(in[0] - in[2]) * C16);
    const int s2 = R14((int64_t)in[1] * C24 - (int64_t)in[3] * C8);
    const int s3 = R14((int64_t)in[1] * C8 + (int64_t)in[3] * C24);
    out[0] = s0 + s3;
    out[1] = s1 + s2;
    out[2] = s1 - s2;
    out[3] = s0 - s3;
}

void iadst4(const int* in, int* out) {
    const int64_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
    if (!(x0 | x1 | x2 | x3)) {
        out[0] = out[1] = out[2] = out[3] = 0;
        return;
    }
    int64_t s0 = S1 * x0, s1 = S2 * x0, s2 = S3 * x1, s3 = S4 * x2, s4 = S1 * x2, s5 = S2 * x3,
            s6 = S4 * x3;
    const int64_t s7 = x0 - x2 + x3;
    s0 = s0 + s3 + s5;
    s1 = s1 - s4 - s6;
    s3 = s2;
    s2 = S3 * s7;
    out[0] = R14(s0 + s3);
    out[1] = R14(s1 + s3);
    out[2] = R14(s2);
    out[3] = R14(s0 + s1 - s3);
}

void idct8(const int* in, int* out) {
    int a[8], b[8];
    a[0] = in[0];
    a[2] = in[4];
    a[1] = in[2];
    a[3] = in[6];
    a[4] = R14((int64_t)in[1] * C28 - (int64_t)in[7] * C4);
    a[7] = R14((int64_t)in[1] * C4 + (int64_t)in[7] * C28);
    a[5] = R14((int64_t)in[5] * C12 - (int64_t)in[3] * C20);
    a[6] = R14((int64_t)in[5] * C20 + (int64_t)in[3] * C12);
    b[0] = R14((int64_t)(a[0] + a[2]) * C16);
    b[1] = R14((int64_t)(a[0] - a[2]) * C16);
    b[2] = R14((int64_t)a[1] * C24 - (int64_t)a[3] * C8);
    b[3] = R14((int64_t)a[1] * C8 + (int64_t)a[3] * C24);
    b[4] = a[4] + a[5];
    b[5] = a[4] - a[5];
    b[6] = -a[6] + a[7];
    b[7] = a[6] + a[7];
    a[0] = b[0] + b[3];
    a[1] = b[1] + b[2];
    a[2] = b[1] - b[2];
    a[3] = b[0] - b[3];
    a[4] = b[4];
    a[5] = R14((int64_t)(b[6] - b[5]) * C16);
    a[6] = R14((int64_t)(b[5] + b[6]) * C16);
    a[7] = b[7];
    for (int i = 0; i < 4; i++) {
        out[i] = a[i] + a[7 - i];
        out[7 - i] = a[i] - a[7 - i];
    }
}

void iadst8(const int* in, int* out) {
    int64_t x0 = in[7], x1 = in[0], x2 = in[5], x3 = in[2], x4 = in[3], x5 = in[4], x6 = in[1],
            x7 = in[6];
    if (!(x0 | x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
        for (int i = 0; i < 8; i++) out[i] = 0;
        return;
    }
    int64_t s0 = C2 * x0 + C30 * x1, s1 = C30 * x0 - C2 * x1, s2 = C10 * x2 + C22 * x3,
            s3 = C22 * x2 - C10 * x3, s4 = C18 * x4 + C14 * x5, s5 = C14 * x4 - C18 * x5,
            s6 = C26 * x6 + C6 * x7, s7 = C6 * x6 - C26 * x7;
    x0 = R14(s0 + s4);
    x1 = R14(s1 + s5);
    x2 = R14(s2 + s6);
    x3 = R14(s3 + s7);
    x4 = R14(s0 - s4);
    x5 = R14(s1 - s5);
    x6 = R14(s2 - s6);
    x7 = R14(s3 - s7);
    s0 = x0;
    s1 = x1;
    s2 = x2;
    s3 = x3;
    s4 = C8 * x4 + C24 * x5;
    s5 = C24 * x4 - C8 * x5;
    s6 = -C24 * x6 + C8 * x7;
    s7 = C8 * x6 + C24 * x7;
    x0 = s0 + s2;
    x1 = s1 + s3;
    x2 = s0 - s2;
    x3 = s1 - s3;
    x4 = R14(s4 + s6);
    x5 = R14(s5 + s7);
    x6 = R14(s4 - s6);
    x7 = R14(s5 - s7);
    s2 = C16 * (x2 + x3);
    s3 = C16 * (x2 - x3);
    s6 = C16 * (x6 + x7);
    s7 = C16 * (x6 - x7);
    x2 = R14(s2);
    x3 = R14(s3);
    x6 = R14(s6);
    x7 = R14(s7);
    out[0] = (int)x0;
    out[1] = (int)-x4;
    out[2] = (int)x6;
    out[3] = (int)-x2;
    out[4] = (int)x3;
    out[5] = (int)-x7;
    out[6] = (int)x5;
    out[7] = (int)-x1;
}

#define BF(o0, o1, i0, i1, ca, cb)                              \
    do {                                                        \
        const int64_t t0 = (int64_t)(i0) * (ca) - (int64_t)(i1) * (cb); \
        const int64_t t1 = (int64_t)(i0) * (cb) + (int64_t)(i1) * (ca); \
        o0 = R14(t0);                                           \
        o1 = R14(t1);                                           \
    } while (0)

void idct16(const int* in, int* out) {
    int a[16], b[16];
    const int order[16] = {0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15};
    for (int i = 0; i < 16; i++) a[i] = in[order[i]];
    for (int i = 0; i < 8; i++) b[i] = a[i];
    BF(b[8], b[15], a[8], a[15], C30, C2);
    BF(b[9], b[14], a[9], a[14], C14, C18);
    BF(b[10], b[13], a[10], a[13], C22, C10);
    BF(b[11], b[12], a[11], a[12], C6, C26);
    // stage 3
    for (int i = 0; i < 4; i++) a[i] = b[i];
    BF(a[4], a[7], b[4], b[7], C28, C4);
    BF(a[5], a[6], b[5], b[6], C12, C20);
    a[8] = b[8] + b[9];
    a[9] = b[8] - b[9];
    a[10] = -b[10] + b[11];
    a[11] = b[10] + b[11];
    a[12] = b[12] + b[13];
    a[13] = b[12] - b[13];
    a[14] = -b[14] + b[15];
    a[15] = b[14] + b[15];
    // stage 4
    b[0] = R14((int64_t)(a[0] + a[1]) * C16);
    b[1] = R14((int64_t)(a[0] - a[1]) * C16);
    BF(b[2], b[3], a[2], a[3], C24, C8);
    b[4] = a[4] + a[5];
    b[5] = a[4] - a[5];
    b[6] = -a[6] + a[7];
    b[7] = a[6] + a[7];
    b[8] = a[8];
    b[15] = a[15];
    b[9] = R14(-(int64_t)a[9] * C8 + (int64_t)a[14] * C24);
    b[14] = R14((int64_t)a[9] * C24 + (int64_t)a[14] * C8);
    b[10] = R14(-(int64_t)a[10] * C24 - (int64_t)a[13] * C8);
    b[13] = R14(-(int64_t)a[10] * C8 + (int64_t)a[13] * C24);
    b[11] = a[11];
    b[12] = a[12];
    // stage 5
    a[0] = b[0] + b[3];
    a[1] = b[1] + b[2];
    a[2] = b[1] - b[2];
    a[3] = b[0] - b[3];
    a[4] = b[4];
    a[5] = R14((int64_t)(b[6] - b[5]) * C16);
    a[6] = R14((int64_t)(b[5] + b[6]) * C16);
    a[7] = b[7];
    a[8] = b[8] + b[11];
    a[9] = b[9] + b[10];
    a[10] = b[9] - b[10];
    a[11] = b[8] - b[11];
    a[12] = -b[12] + b[15];
    a[13] = -b[13] + b[14];
    a[14] = b[13] + b[14];
    a[15] = b[12] + b[15];
    // stage 6
    for (int i = 0; i < 4; i++) {
        b[i] = a[i] + a[7 - i];
        b[7 - i] = a[i] - a[7 - i];
    }
    b[8] = a[8];
    b[9] = a[9];
    b[10] = R14((int64_t)(-a[10] + a[13]) * C16);
    b[13] = R14((int64_t)(a[10] + a[13]) * C16);
    b[11] = R14((int64_t)(-a[11] + a[12]) * C16);
    b[12] = R14((int64_t)(a[11] + a[12]) * C16);
    b[14] = a[14];
    b[15] = a[15];
    for (int i = 0; i < 8; i++) {
        out[i] = b[i] + b[15 - i];
        out[15 - i] = b[i] - b[15 - i];
    }
}

void iadst16(const int* in, int* out) {
    int64_t x[16];
    const int order[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    int64_t any = 0;
    for (int i = 0; i < 16; i++) any |= x[i] = in[order[i]];
    if (!any) {
        for (int i = 0; i < 16; i++) out[i] = 0;
        return;
    }
    int64_t s[16];
    const int ca[8] = {C1, C5, C9, C13, C17, C21, C25, C29};
    const int cb[8] = {C31, C27, C23, C19, C15, C11, C7, C3};
    for (int k = 0; k < 8; k++) {
        s[2 * k] = x[2 * k] * ca[k] + x[2 * k + 1] * cb[k];
        s[2 * k + 1] = x[2 * k] * cb[k] - x[2 * k + 1] * ca[k];
    }
    for (int k = 0; k < 8; k++) {
        x[k] = R14(s[k] + s[k + 8]);
        x[k + 8] = R14(s[k] - s[k + 8]);
    }
    // stage 2
    for (int k = 0; k < 8; k++) s[k] = x[k];
    s[8] = x[8] * C4 + x[9] * C28;
    s[9] = x[8] * C28 - x[9] * C4;
    s[10] = x[10] * C20 + x[11] * C12;
    s[11] = x[10] * C12 - x[11] * C20;
    s[12] = -x[12] * C28 + x[13] * C4;
    s[13] = x[12] * C4 + x[13] * C28;
    s[14] = -x[14] * C12 + x[15] * C20;
    s[15] = x[14] * C20 + x[15] * C12;
    for (int k = 0; k < 4; k++) {
        x[k] = s[k] + s[k + 4];
        x[k + 4] = s[k] - s[k + 4];
        x[k + 8] = R14(s[k + 8] + s[k + 12]);
        x[k + 12] = R14(s[k + 8] - s[k + 12]);
    }
    // stage 3
    for (int base = 0; base < 16; base += 8) {
        s[base] = x[base];
        s[base + 1] = x[base + 1];
        s[base + 2] = x[base + 2];
        s[base + 3] = x[base + 3];
        s[base + 4] = x[base + 4] * C8 + x[base + 5] * C24;
        s[base + 5] = x[base + 4] * C24 - x[base + 5] * C8;
        s[base + 6] = -x[base + 6] * C24 + x[base + 7] * C8;
        s[base + 7] = x[base + 6] * C8 + x[base + 7] * C24;
        x[base] = s[base] + s[base + 2];
        x[base + 1] = s[base + 1] + s[base + 3];
        x[base + 2] = s[base] - s[base + 2];
        x[base + 3] = s[base + 1] - s[base + 3];
        x[base + 4] = R14(s[base + 4] + s[base + 6]);
        x[base + 5] = R14(s[base + 5] + s[base + 7]);
        x[base + 6] = R14(s[base + 4] - s[base + 6]);
        x[base + 7] = R14(s[base + 5] - s[base + 7]);
    }
    // stage 4
    s[2] = -C16 * (x[2] + x[3]);
    s[3] = C16 * (x[2] - x[3]);
    s[6] = C16 * (x[6] + x[7]);
    s[7] = C16 * (-x[6] + x[7]);
    s[10] = C16 * (x[10] + x[11]);
    s[11] = C16 * (-x[10] + x[11]);
    s[14] = -C16 * (x[14] + x[15]);
    s[15] = C16 * (x[14] - x[15]);
    x[2] = R14(s[2]);
    x[3] = R14(s[3]);
    x[6] = R14(s[6]);
    x[7] = R14(s[7]);
    x[10] = R14(s[10]);
    x[11] = R14(s[11]);
    x[14] = R14(s[14]);
    x[15] = R14(s[15]);
    out[0] = (int)x[0];
    out[1] = (int)-x[8];
    out[2] = (int)x[12];
    out[3] = (int)-x[4];
    out[4] = (int)x[6];
    out[5] = (int)x[14];
    out[6] = (int)x[10];
    out[7] = (int)x[2];
    out[8] = (int)x[3];
    out[9] = (int)x[11];
    out[10] = (int)x[15];
    out[11] = (int)x[7];
    out[12] = (int)x[5];
    out[13] = (int)-x[13];
    out[14] = (int)x[9];
    out[15] = (int)-x[1];
}

void idct32(const int* in, int* out) {
    int a[32], b[32];
    const int order[16] = {0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30};
    for (int i = 0; i < 16; i++) a[i] = in[order[i]];
    BF(a[16], a[31], in[1], in[31], C31, C1);
    BF(a[17], a[30], in[17], in[15], C15, C17);
    BF(a[18], a[29], in[9], in[23], C23, C9);
    BF(a[19], a[28], in[25], in[7], C7, C25);
    BF(a[20], a[27], in[5], in[27], C27, C5);
    BF(a[21], a[26], in[21], in[11], C11, C21);
    BF(a[22], a[25], in[13], in[19], C19, C13);
    BF(a[23], a[24], in[29], in[3], C3, C29);
    // stage 2
    for (int i = 0; i < 8; i++) b[i] = a[i];
    BF(b[8], b[15], a[8], a[15], C30, C2);
    BF(b[9], b[14], a[9], a[14], C14, C18);
    BF(b[10], b[13], a[10], a[13], C22, C10);
    BF(b[11], b[12], a[11], a[12], C6, C26);
    for (int k = 16; k < 32; k += 4) {
        b[k] = a[k] + a[k + 1];
        b[k + 1] = a[k] - a[k + 1];
        b[k + 2] = -a[k + 2] + a[k + 3];
        b[k + 3] = a[k + 2] + a[k + 3];
    }
    // stage 3
    for (int i = 0; i < 4; i++) a[i] = b[i];
    BF(a[4], a[7], b[4], b[7], C28, C4);
    BF(a[5], a[6], b[5], b[6], C12, C20);
    a[8] = b[8] + b[9];
    a[9] = b[8] - b[9];
    a[10] = -b[10] + b[11];
    a[11] = b[10] + b[11];
    a[12] = b[12] + b[13];
    a[13] = b[12] - b[13];
    a[14] = -b[14] + b[15];
    a[15] = b[14] + b[15];
    a[16] = b[16];
    a[31] = b[31];
    a[17] = R14(-(int64_t)b[17] * C4 + (int64_t)b[30] * C28);
    a[30] = R14((int64_t)b[17] * C28 + (int64_t)b[30] * C4);
    a[18] = R14(-(int64_t)b[18] * C28 - (int64_t)b[29] * C4);
    a[29] = R14(-(int64_t)b[18] * C4 + (int64_t)b[29] * C28);
    a[19] = b[19];
    a[20] = b[20];
    a[21] = R14(-(int64_t)b[21] * C20 + (int64_t)b[26] * C12);
    a[26] = R14((int64_t)b[21] * C12 + (int64_t)b[26] * C20);
    a[22] = R14(-(int64_t)b[22] * C12 - (int64_t)b[25] * C20);
    a[25] = R14(-(int64_t)b[22] * C20 + (int64_t)b[25] * C12);
    a[23] = b[23];
    a[24] = b[24];
    a[27] = b[27];
    a[28] = b[28];
    // stage 4
    b[0] = R14((int64_t)(a[0] + a[1]) * C16);
    b[1] = R14((int64_t)(a[0] - a[1]) * C16);
    BF(b[2], b[3], a[2], a[3], C24, C8);
    b[4] = a[4] + a[5];
    b[5] = a[4] - a[5];
    b[6] = -a[6] + a[7];
    b[7] = a[6] + a[7];
    b[8] = a[8];
    b[15] = a[15];
    b[9] = R14(-(int64_t)a[9] * C8 + (int64_t)a[14] * C24);
    b[14] = R14((int64_t)a[9] * C24 + (int64_t)a[14] * C8);
    b[10] = R14(-(int64_t)a[10] * C24 - (int64_t)a[13] * C8);
    b[13] = R14(-(int64_t)a[10] * C8 + (int64_t)a[13] * C24);
    b[11] = a[11];
    b[12] = a[12];
    b[16] = a[16] + a[19];
    b[17] = a[17] + a[18];
    b[18] = a[17] - a[18];
    b[19] = a[16] - a[19];
    b[20] = -a[20] + a[23];
    b[21] = -a[21] + a[22];
    b[22] = a[21] + a[22];
    b[23] = a[20] + a[23];
    b[24] = a[24] + a[27];
    b[25] = a[25] + a[26];
    b[26] = a[25] - a[26];
    b[27] = a[24] - a[27];
    b[28] = -a[28] + a[31];
    b[29] = -a[29] + a[30];
    b[30] = a[29] + a[30];
    b[31] = a[28] + a[31];
    // stage 5
    a[0] = b[0] + b[3];
    a[1] = b[1] + b[2];
    a[2] = b[1] - b[2];
    a[3] = b[0] - b[3];
    a[4] = b[4];
    a[5] = R14((int64_t)(b[6] - b[5]) * C16);
    a[6] = R14((int64_t)(b[5] + b[6]) * C16);
    a[7] = b[7];
    a[8] = b[8] + b[11];
    a[9] = b[9] + b[10];
    a[10] = b[9] - b[10];
    a[11] = b[8] - b[11];
    a[12] = -b[12] + b[15];
    a[13] = -b[13] + b[14];
    a[14] = b[13] + b[14];
    a[15] = b[12] + b[15];
    a[16] = b[16];
    a[17] = b[17];
    a[18] = R14(-(int64_t)b[18] * C8 + (int64_t)b[29] * C24);
    a[29] = R14((int64_t)b[18] * C24 + (int64_t)b[29] * C8);
    a[19] = R14(-(int64_t)b[19] * C8 + (int64_t)b[28] * C24);
    a[28] = R14((int64_t)b[19] * C24 + (int64_t)b[28] * C8);
    a[20] = R14(-(int64_t)b[20] * C24 - (int64_t)b[27] * C8);
    a[27] = R14(-(int64_t)b[20] * C8 + (int64_t)b[27] * C24);
    a[21] = R14(-(int64_t)b[21] * C24 - (int64_t)b[26] * C8);
    a[26] = R14(-(int64_t)b[21] * C8 + (int64_t)b[26] * C24);
    a[22] = b[22];
    a[23] = b[23];
    a[24] = b[24];
    a[25] = b[25];
    a[30] = b[30];
    a[31] = b[31];
    // stage 6
    for (int i = 0; i < 4; i++) {
        b[i] = a[i] + a[7 - i];
        b[7 - i] = a[i] - a[7 - i];
    }
    b[8] = a[8];
    b[9] = a[9];
    b[10] = R14((int64_t)(-a[10] + a[13]) * C16);
    b[13] = R14((int64_t)(a[10] + a[13]) * C16);
    b[11] = R14((int64_t)(-a[11] + a[12]) * C16);
    b[12] = R14((int64_t)(a[11] + a[12]) * C16);
    b[14] = a[14];
    b[15] = a[15];
    for (int i = 0; i < 4; i++) {
        b[16 + i] = a[16 + i] + a[23 - i];
        b[23 - i] = a[16 + i] - a[23 - i];
        b[24 + i] = -a[24 + i] + a[31 - i];
        b[31 - i] = a[24 + i] + a[31 - i];
    }
    // stage 7
    for (int i = 0; i < 8; i++) {
        a[i] = b[i] + b[15 - i];
        a[15 - i] = b[i] - b[15 - i];
    }
    for (int i = 16; i < 20; i++) a[i] = b[i];
    for (int i = 0; i < 4; i++) {
        a[20 + i] = R14((int64_t)(-b[20 + i] + b[27 - i]) * C16);
        a[27 - i] = R14((int64_t)(b[20 + i] + b[27 - i]) * C16);
    }
    for (int i = 28; i < 32; i++) a[i] = b[i];
    for (int i = 0; i < 16; i++) {
        out[i] = a[i] + a[31 - i];
        out[31 - i] = a[i] - a[31 - i];
    }
}

// the lossless Walsh-Hadamard transform, added to dst
void iwht4_add(const int16_t* in, uint8_t* dst, int stride) {
    int tmp[16];
    for (int i = 0; i < 4; i++) {
        int a = in[4 * i] >> 2, c = in[4 * i + 1] >> 2, d = in[4 * i + 2] >> 2, b = in[4 * i + 3] >> 2;
        a += c;
        d -= b;
        const int e = (a - d) >> 1;
        b = e - b;
        c = e - c;
        a -= b;
        d += c;
        tmp[4 * i] = a;
        tmp[4 * i + 1] = b;
        tmp[4 * i + 2] = c;
        tmp[4 * i + 3] = d;
    }
    for (int i = 0; i < 4; i++) {
        int a = tmp[i], c = tmp[4 + i], d = tmp[8 + i], b = tmp[12 + i];
        a += c;
        d -= b;
        const int e = (a - d) >> 1;
        b = e - b;
        c = e - c;
        a -= b;
        d += c;
        dst[i] = clip8(dst[i] + a);
        dst[stride + i] = clip8(dst[stride + i] + b);
        dst[2 * stride + i] = clip8(dst[2 * stride + i] + c);
        dst[3 * stride + i] = clip8(dst[3 * stride + i] + d);
    }
}

typedef void (*Tx1d)(const int*, int*);

// rows, then columns; the columns rounded by 4/5/6/6 bits and added to dst
void inverse_transform_add(const int16_t* coef, int tx, int type, uint8_t* dst, int stride) {
    static const Tx1d dct[4] = {idct4, idct8, idct16, idct32};
    static const Tx1d adst[3] = {iadst4, iadst8, iadst16};
    const int n = 4 << tx;
    const int shift = tx == TX_4X4 ? 4 : tx == TX_8X8 ? 5 : 6;
    const Tx1d rows = (tx < 3 && (type == DCT_ADST || type == ADST_ADST)) ? adst[tx] : dct[tx];
    const Tx1d cols = (tx < 3 && (type == ADST_DCT || type == ADST_ADST)) ? adst[tx] : dct[tx];
    int buf[32 * 32], in[32], out[32];
    for (int r = 0; r < n; r++) {
        bool any = false;
        for (int c = 0; c < n; c++) any |= (in[c] = coef[r * n + c]) != 0;
        if (!any) {
            memset(buf + r * n, 0, sizeof(int) * n);
            continue;
        }
        rows(in, buf + r * n);
        // the 8-bit decoders keep row outputs in 16 bits
        for (int c = 0; c < n; c++) buf[r * n + c] = (int16_t)buf[r * n + c];
    }
    for (int c = 0; c < n; c++) {
        for (int r = 0; r < n; r++) in[r] = buf[r * n + c];
        cols(in, out);
        for (int r = 0; r < n; r++) {
            uint8_t* p = dst + r * stride + c;
            *p = clip8(*p + (((int16_t)out[r] + (1 << (shift - 1))) >> shift));
        }
    }
}

// ------------------------------------------------------------ intra prediction
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }

// A: the above row, A[-1] the corner, A[0..2bs-1]; L: the left column
void intra_predict(int mode, int bs, const uint8_t* A, const uint8_t* L, bool have_above,
                   bool have_left, uint8_t* d, int s) {
    switch (mode) {
    case DC_PRED: {
        int v = 128;
        const int lg = __builtin_ctz(bs);
        int sum = 0;
        if (have_above && have_left) {
            for (int i = 0; i < bs; i++) sum += A[i] + L[i];
            v = (sum + bs) >> (lg + 1);
        } else if (have_above) {
            for (int i = 0; i < bs; i++) sum += A[i];
            v = (sum + (bs >> 1)) >> lg;
        } else if (have_left) {
            for (int i = 0; i < bs; i++) sum += L[i];
            v = (sum + (bs >> 1)) >> lg;
        }
        for (int r = 0; r < bs; r++) memset(d + r * s, v, bs);
        break;
    }
    case V_PRED:
        for (int r = 0; r < bs; r++) memcpy(d + r * s, A, bs);
        break;
    case H_PRED:
        for (int r = 0; r < bs; r++) memset(d + r * s, L[r], bs);
        break;
    case TM_PRED:
        for (int r = 0; r < bs; r++)
            for (int c = 0; c < bs; c++) d[r * s + c] = clip8(L[r] + A[c] - A[-1]);
        break;
    case D45_PRED:
        for (int r = 0; r < bs; r++)
            for (int c = 0; c < bs; c++)
                d[r * s + c] = r + c + 2 < 2 * bs ? avg3(A[r + c], A[r + c + 1], A[r + c + 2])
                                                  : A[2 * bs - 1];
        break;
    case D63_PRED:
        for (int r = 0; r < bs; r++)
            for (int c = 0; c < bs; c++) {
                const int i = r / 2 + c;
                d[r * s + c] = (r & 1) ? avg3(A[i], A[i + 1], A[i + 2]) : avg2(A[i], A[i + 1]);
            }
        break;
    case D207_PRED: {
        uint8_t p[32][32];
        for (int c = 0; c < bs; c++) p[bs - 1][c] = L[bs - 1];
        for (int r = 0; r < bs - 1; r++) p[r][0] = avg2(L[r], L[r + 1]);
        for (int r = 0; r < bs - 2; r++) p[r][1] = avg3(L[r], L[r + 1], L[r + 2]);
        p[bs - 2][1] = (uint8_t)((L[bs - 2] + 3 * L[bs - 1] + 2) >> 2);
        for (int c = 2; c < bs; c++)
            for (int r = bs - 2; r >= 0; r--) p[r][c] = p[r + 1][c - 2];
        for (int r = 0; r < bs; r++) memcpy(d + r * s, p[r], bs);
        break;
    }
    case D117_PRED: {
        uint8_t p[32][32];
        for (int c = 0; c < bs; c++) p[0][c] = avg2(A[c - 1], A[c]);
        p[1][0] = avg3(L[0], A[-1], A[0]);
        for (int c = 1; c < bs; c++) p[1][c] = avg3(A[c - 2], A[c - 1], A[c]);
        p[2][0] = avg3(A[-1], L[0], L[1]);
        for (int r = 3; r < bs; r++) p[r][0] = avg3(L[r - 3], L[r - 2], L[r - 1]);
        for (int r = 2; r < bs; r++)
            for (int c = 1; c < bs; c++) p[r][c] = p[r - 2][c - 1];
        for (int r = 0; r < bs; r++) memcpy(d + r * s, p[r], bs);
        break;
    }
    case D135_PRED: {
        uint8_t p[32][32];
        p[0][0] = avg3(L[0], A[-1], A[0]);
        for (int c = 1; c < bs; c++) p[0][c] = avg3(A[c - 2], A[c - 1], A[c]);
        p[1][0] = avg3(A[-1], L[0], L[1]);
        for (int r = 2; r < bs; r++) p[r][0] = avg3(L[r - 2], L[r - 1], L[r]);
        for (int r = 1; r < bs; r++)
            for (int c = 1; c < bs; c++) p[r][c] = p[r - 1][c - 1];
        for (int r = 0; r < bs; r++) memcpy(d + r * s, p[r], bs);
        break;
    }
    case D153_PRED: {
        uint8_t p[32][32];
        p[0][0] = avg2(L[0], A[-1]);
        for (int r = 1; r < bs; r++) p[r][0] = avg2(L[r - 1], L[r]);
        p[0][1] = avg3(L[0], A[-1], A[0]);
        p[1][1] = avg3(A[-1], L[0], L[1]);
        for (int r = 2; r < bs; r++) p[r][1] = avg3(L[r - 2], L[r - 1], L[r]);
        for (int c = 2; c < bs; c++) p[0][c] = avg3(A[c - 3], A[c - 2], A[c - 1]);
        for (int r = 1; r < bs; r++)
            for (int c = 2; c < bs; c++) p[r][c] = p[r - 1][c - 2];
        for (int r = 0; r < bs; r++) memcpy(d + r * s, p[r], bs);
        break;
    }
    }
}

// ------------------------------------------------------------ motion compensation
// a w x h block of the 8-tap filter at (mx, my) sixteenths from src, which
// holds (h + 7) rows of (w + 7) samples starting 3 up and 3 left; two
// passes, each rounded by 7 bits and clipped; avg: the rounded mean with
// dst (the second prediction of a compound block)
void convolve(const uint8_t* src, int ss, uint8_t* dst, int ds, int w, int h, const int16_t* fx,
              const int16_t* fy, bool avg) {
    uint8_t tmp[71 * 64];
    for (int r = 0; r < h + 7; r++)
        for (int c = 0; c < w; c++) {
            const uint8_t* p = src + r * ss + c;
            int sum = 0;
            for (int k = 0; k < 8; k++) sum += p[k] * fx[k];
            tmp[r * 64 + c] = clip8((sum + 64) >> 7);
        }
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int sum = 0;
            for (int k = 0; k < 8; k++) sum += tmp[(r + k) * 64 + c] * fy[k];
            const uint8_t v = clip8((sum + 64) >> 7);
            uint8_t* o = dst + r * ds + c;
            *o = avg ? (uint8_t)((*o + v + 1) >> 1) : v;
        }
}

// do_scaled_8tap_c: a bw x bh block from the reference plane (pw x ph,
// read edge-extended) at integer position (X, Y) and phase (fx, fy) in
// 1/16 pel, stepping dx, dy sixteenths a pixel; rows filtered first, each
// pass rounded and clipped to 8 bits; ``avg`` averages with dst
void scaled_8tap(const uint8_t* ref, int rs, int pw, int ph, int X, int Y, int fx, int fy, int dx,
                 int dy, int bw, int bh, const int16_t (*F)[8], uint8_t* dst, int ds, bool avg) {
    const int th = (((bh - 1) * dy + fy) >> 4) + 8;
    uint8_t tmp[135 * 64];
    for (int r = 0; r < th; r++) {
        const uint8_t* row = ref + (size_t)clampi(Y - 3 + r, 0, ph - 1) * rs;
        int imx = fx, ioff = 0;
        for (int c = 0; c < bw; c++) {
            int sum = 0;
            for (int k = 0; k < 8; k++) sum += F[imx][k] * row[clampi(X + ioff - 3 + k, 0, pw - 1)];
            tmp[r * 64 + c] = clip8((sum + 64) >> 7);
            imx += dx;
            ioff += imx >> 4;
            imx &= 15;
        }
    }
    const uint8_t* t = tmp;
    for (int r = 0; r < bh; r++, dst += ds) {
        for (int c = 0; c < bw; c++) {
            int sum = 0;
            for (int k = 0; k < 8; k++) sum += F[fy][k] * t[k * 64 + c];
            const uint8_t v = clip8((sum + 64) >> 7);
            dst[c] = avg ? (uint8_t)((dst[c] + v + 1) >> 1) : v;
        }
        fy += dy;
        t += (fy >> 4) * 64;
        fy &= 15;
    }
}

// ------------------------------------------------------------ loop filter
// one line across an edge: s points at q0, step crosses the edge
inline void lpf_line(uint8_t* s, int step, int size, int E, int I, int H) {
    const int p3 = s[-4 * step], p2 = s[-3 * step], p1 = s[-2 * step], p0 = s[-step];
    const int q0 = s[0], q1 = s[step], q2 = s[2 * step], q3 = s[3 * step];
    if (abs(p3 - p2) > I || abs(p2 - p1) > I || abs(p1 - p0) > I || abs(q1 - q0) > I ||
        abs(q2 - q1) > I || abs(q3 - q2) > I || abs(p0 - q0) * 2 + abs(p1 - q1) / 2 > E)
        return;
    const bool flat = size >= 8 && abs(p1 - p0) <= 1 && abs(q1 - q0) <= 1 && abs(p2 - p0) <= 1 &&
                      abs(q2 - q0) <= 1 && abs(p3 - p0) <= 1 && abs(q3 - q0) <= 1;
    if (flat && size == 16) {
        int x[16];
        for (int k = 0; k < 16; k++) x[k] = s[(k - 8) * step];
        if (abs(x[0] - p0) <= 1 && abs(x[1] - p0) <= 1 && abs(x[2] - p0) <= 1 &&
            abs(x[3] - p0) <= 1 && abs(x[15] - q0) <= 1 && abs(x[14] - q0) <= 1 &&
            abs(x[13] - q0) <= 1 && abs(x[12] - q0) <= 1) {
            // 15 taps: out[i] = (sum of x[i-7..i+7], ends repeated, + x[i] + 8) >> 4
            for (int i = 1; i < 15; i++) {
                int sum = x[i];
                for (int j = i - 7; j <= i + 7; j++) sum += x[clampi(j, 0, 15)];
                s[(i - 8) * step] = (uint8_t)((sum + 8) >> 4);
            }
            return;
        }
    }
    if (flat) {
        const int x[8] = {p3, p2, p1, p0, q0, q1, q2, q3};
        for (int i = 1; i < 7; i++) {
            int sum = x[i];
            for (int j = i - 3; j <= i + 3; j++) sum += x[clampi(j, 0, 7)];
            s[(i - 4) * step] = (uint8_t)((sum + 4) >> 3);
        }
        return;
    }
    const bool hev = abs(p1 - p0) > H || abs(q1 - q0) > H;
    auto sc = [](int v) { return v < -128 ? -128 : v > 127 ? 127 : v; };
    const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
    int f = hev ? sc(ps1 - qs1) : 0;
    f = sc(f + 3 * (qs0 - ps0));
    const int f1 = sc(f + 4) >> 3, f2 = sc(f + 3) >> 3;
    s[0] = (uint8_t)(sc(qs0 - f1) + 128);
    s[-step] = (uint8_t)(sc(ps0 + f2) + 128);
    if (!hev) {
        const int f3 = (f1 + 1) >> 1;
        s[step] = (uint8_t)(sc(qs1 - f3) + 128);
        s[-2 * step] = (uint8_t)(sc(ps1 + f3) + 128);
    }
}

// ------------------------------------------------------------ frames
struct MV {
    int16_t row = 0, col = 0;
};
inline bool operator==(MV a, MV b) { return a.row == b.row && a.col == b.col; }
inline bool operator!=(MV a, MV b) { return !(a == b); }

struct MvRef {
    int8_t ref[2];
    MV mv[2];
};

struct Frame {
    int w = 0, h = 0, mi_cols = 0, mi_rows = 0;
    int stride[3] = {0, 0, 0}, rows[3] = {0, 0, 0};
    std::vector<uint8_t> p[3];
    std::vector<MvRef> mvs;
    Frame(int width, int height) : w(width), h(height) {
        mi_cols = (w + 7) >> 3;
        mi_rows = (h + 7) >> 3;
        // planes cover whole 64x64 superblocks, whose blocks are predicted
        // and reconstructed in full
        const int aw = ((mi_cols + 7) >> 3) * 64, ah = ((mi_rows + 7) >> 3) * 64;
        for (int k = 0; k < 3; k++) {
            stride[k] = (k ? aw / 2 : aw);
            rows[k] = (k ? ah / 2 : ah);
            p[k].assign((size_t)stride[k] * rows[k], 0);
        }
        mvs.resize((size_t)mi_cols * mi_rows);
    }
    uint8_t* at(int k, int x, int y) { return p[k].data() + (size_t)y * stride[k] + x; }
    int pw(int k) const { return k ? (w + 1) >> 1 : w; }
    int ph(int k) const { return k ? (h + 1) >> 1 : h; }
};
using FramePtr = std::shared_ptr<Frame>;

struct Block {
    uint8_t sb_type = 0, mode = 0, uv_mode = 0, tx_size = 0, skip = 0, seg_id = 0, seg_pred = 0;
    uint8_t filter = 3;   // SWITCHABLE_FILTERS for intra blocks (the interp context)
    int row = 0, col = 0;  // the top-left 8x8 cell
    int8_t ref[2] = {INTRA_FRAME, NONE_FRAME};
    uint8_t bmode[4] = {0, 0, 0, 0};
    MV mv[2];
    MV bmv[4][2];
    bool inter() const { return ref[0] > INTRA_FRAME; }
    bool compound() const { return ref[1] > INTRA_FRAME; }
};

struct Decoder {
    // ---- persistent state
    Probs ctx[4];
    FramePtr refs[8];
    FramePtr cur, last_frame, shown;
    bool have_key = false, last_show = false, last_key = false;
    int lf_ref_deltas[4] = {1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
    bool seg_enabled = false, seg_update_map = false, seg_temporal = false, seg_abs = false;
    uint8_t seg_tree[7] = {255, 255, 255, 255, 255, 255, 255}, seg_pred_probs[3] = {255, 255, 255};
    bool seg_feature[8][4] = {};
    int seg_data[8][4] = {};
    std::vector<uint8_t> seg_map_prev, seg_map_cur;
    int64_t features = 0;

    // ---- this frame's header
    int profile = 0, show_existing = 0, keyframe = 0, show_frame = 0, error_res = 0;
    int intra_only = 0, reset_ctx = 0, refresh_flags = 0, ref_idx[3] = {0, 0, 0};
    int sign_bias[4] = {0, 0, 0, 0}, allow_hp = 0, interp_filter = 0;
    int refresh_ctx = 0, parallel = 0, ctx_idx = 0;
    int lf_level = 0, lf_sharpness = 0, lf_delta_enabled = 0;
    int base_q = 0, dq_y_dc = 0, dq_uv_dc = 0, dq_uv_ac = 0, lossless = 0;
    int tile_cols_log2 = 0, tile_rows_log2 = 0;
    int tx_mode = 0, ref_mode = SINGLE_REF, comp_fixed = 0, comp_var[2] = {0, 0};
    int color_space = 0, color_range = 0;
    int width = 0, height = 0, mi_cols = 0, mi_rows = 0, sb_cols = 0, sb_rows = 0;
    bool use_prev_mvs = false, intra = false;
    Probs fc;
    Counts counts;
    int16_t dq[8][2][2];   // [segment][plane > 0][dc, ac]

    // ---- block state
    std::vector<Block> blocks;
    std::vector<int32_t> grid;   // block index of every 8x8 cell
    std::vector<uint8_t> above_nz[3], above_part, above_seg;
    uint8_t left_nz[3][16], left_part[8], left_seg[8];
    int tile_col_start = 0, tile_col_end = 0;
    int16_t coef[32 * 32];
    BoolDecoder* bd = nullptr;

    void feature(int f) { features |= (int64_t)1 << f; }

    Decoder() {
        memset(coef, 0, sizeof coef);
        for (auto& c : ctx) c = default_probs();
    }

    // ------------------------------------------------------- headers
    // profile 0's colour config (profiles 1-3 are refused before it)
    void read_color(BitReader& b) {
        color_space = b.f(3);
        if (color_space == 7) throw Error(UNSUPPORTED, "VP9 RGB (a profile 1 format) is not read by the port");
        color_range = b.bit();
        if (color_range) feature(F_FULL_RANGE);
        if (color_space > 1) feature(F_COLOR_SPACE);
    }

    void read_size(BitReader& b) {
        width = b.f(16) + 1;
        height = b.f(16) + 1;
    }

    void read_render_size(BitReader& b) {
        if (b.bit()) {
            b.f(16);
            b.f(16);
        }
    }

    void setup_past_independence() {
        memset(seg_feature, 0, sizeof seg_feature);
        memset(seg_data, 0, sizeof seg_data);
        seg_abs = false;
        std::fill(seg_map_prev.begin(), seg_map_prev.end(), 0);
        const int ref_deltas[4] = {1, 0, -1, -1};
        memcpy(lf_ref_deltas, ref_deltas, sizeof ref_deltas);
        lf_mode_deltas[0] = lf_mode_deltas[1] = 0;
        const Probs def = default_probs();
        if (keyframe || error_res || reset_ctx == 3) {
            for (auto& c : ctx) c = def;
        } else if (reset_ctx == 2) {
            ctx[ctx_idx] = def;
        }
        ctx_idx = 0;
    }

    // returns the byte size of the uncompressed header (0 for show_existing_frame)
    size_t read_uncompressed(const uint8_t* data, size_t size) {
        BitReader b(data, size);
        if (b.f(2) != 2) throw Error(CORRUPT, "bad VP9 frame marker");
        profile = b.bit();
        profile |= b.bit() << 1;
        if (profile == 3 && b.bit()) throw Error(CORRUPT, "reserved bit set in the profile");
        if (profile > 0)
            throw Error(UNSUPPORTED, "VP9 profile " + std::to_string(profile) +
                                         " (4:4:4, 4:2:2, 4:4:0 or 10/12-bit) is not read by the port");
        show_existing = b.bit();
        if (show_existing) {
            const int idx = b.f(3);
            if (!refs[idx]) throw Error(CORRUPT, "show_existing_frame of an empty reference");
            shown = refs[idx];
            return 0;
        }
        last_key = keyframe;
        keyframe = b.bit() == KEY_FRAME;
        show_frame = b.bit();
        error_res = b.bit();
        const int old_w = width, old_h = height;
        if (keyframe) {
            if (b.f(8) != 0x49 || b.f(8) != 0x83 || b.f(8) != 0x42)
                throw Error(CORRUPT, "bad VP9 sync code");
            read_color(b);
            read_size(b);
            read_render_size(b);
            refresh_flags = 0xFF;
            intra_only = 0;
            reset_ctx = 0;
        } else {
            intra_only = show_frame ? 0 : b.bit();
            reset_ctx = error_res ? 0 : b.f(2);
            if (intra_only) {
                if (b.f(8) != 0x49 || b.f(8) != 0x83 || b.f(8) != 0x42)
                    throw Error(CORRUPT, "bad VP9 sync code");
                color_space = 1;   // profile 0: BT.601, 4:2:0, 8-bit
                color_range = 0;
                refresh_flags = b.f(8);
                read_size(b);
                read_render_size(b);
                feature(F_INTRA_ONLY);
            } else {
                if (!have_key) throw Error(CORRUPT, "an inter frame before any key frame");
                refresh_flags = b.f(8);
                for (int i = 0; i < 3; i++) {
                    ref_idx[i] = b.f(3);
                    sign_bias[LAST_FRAME + i] = b.bit();
                    if (!refs[ref_idx[i]]) throw Error(CORRUPT, "an empty reference slot");
                }
                bool found = false;
                for (int i = 0; i < 3 && !found; i++)
                    if (b.bit()) {
                        width = refs[ref_idx[i]]->w;
                        height = refs[ref_idx[i]]->h;
                        found = true;
                    }
                if (!found) read_size(b);
                read_render_size(b);
                allow_hp = b.bit();
                interp_filter = b.bit() ? (int)SWITCHABLE : (int)kLiteralToFilter[b.f(2)];
                for (int i = 0; i < 3; i++) {
                    const Frame& r = *refs[ref_idx[i]];
                    if (2 * width < r.w || 2 * height < r.h || width > 16 * r.w || height > 16 * r.h)
                        throw Error(CORRUPT, "a reference of an invalid size");
                }
            }
        }
        if (width != old_w || height != old_h) {
            if (old_w) feature(F_SIZE_CHANGE);
        }
        if (!error_res) {
            refresh_ctx = b.bit();
            parallel = b.bit();
        } else {
            refresh_ctx = 0;
            parallel = 1;
            feature(F_ERROR_RES);
        }
        ctx_idx = b.f(2);
        if (ctx_idx) feature(F_CTX_IDX);
        if (!refresh_ctx) feature(F_NO_CTX_REFRESH);
        if (reset_ctx) feature(F_RESET_CTX);
        // FFmpeg's av_image_check_size
        if ((int64_t)(width + 128) * (height + 128) >= INT32_MAX / 8)
            throw Error(CORRUPT, "invalid frame size " + std::to_string(width) + "x" + std::to_string(height));
        intra = keyframe || intra_only;
        mi_cols = (width + 7) >> 3;
        mi_rows = (height + 7) >> 3;
        sb_cols = (mi_cols + 7) >> 3;
        sb_rows = (mi_rows + 7) >> 3;
        if (seg_map_prev.size() != (size_t)mi_cols * mi_rows || width != old_w || height != old_h)
            seg_map_prev.assign((size_t)mi_cols * mi_rows, 0);
        if (intra || error_res) setup_past_independence();
        // loop filter
        lf_level = b.f(6);
        lf_sharpness = b.f(3);
        if (lf_sharpness) feature(F_SHARPNESS);
        lf_delta_enabled = b.bit();
        if (lf_delta_enabled && b.bit()) {
            for (int i = 0; i < 4; i++)
                if (b.bit()) lf_ref_deltas[i] = b.s(6);
            for (int i = 0; i < 2; i++)
                if (b.bit()) lf_mode_deltas[i] = b.s(6);
        }
        if (lf_delta_enabled) feature(F_LF_DELTAS);
        // quantisers
        base_q = b.f(8);
        auto delta = [&]() { return b.bit() ? b.s(4) : 0; };
        dq_y_dc = delta();
        dq_uv_dc = delta();
        dq_uv_ac = delta();
        if (dq_y_dc || dq_uv_dc || dq_uv_ac) feature(F_Q_DELTAS);
        lossless = base_q == 0 && !dq_y_dc && !dq_uv_dc && !dq_uv_ac;
        if (lossless) feature(F_LOSSLESS);
        // segmentation
        seg_update_map = false;
        seg_enabled = b.bit();
        if (seg_enabled) {
            feature(F_SEGMENTATION);
            seg_update_map = b.bit();
            if (seg_update_map) {
                for (auto& p : seg_tree) p = b.bit() ? b.f(8) : 255;
                seg_temporal = b.bit();
                for (auto& p : seg_pred_probs) p = seg_temporal && b.bit() ? b.f(8) : 255;
                if (seg_temporal) feature(F_SEG_TEMPORAL);
            }
            if (b.bit()) {
                seg_abs = b.bit();
                memset(seg_feature, 0, sizeof seg_feature);
                memset(seg_data, 0, sizeof seg_data);
                for (int i = 0; i < 8; i++)
                    for (int j = 0; j < 4; j++) {
                        int v = 0;
                        if (b.bit()) {
                            seg_feature[i][j] = true;
                            v = std::min(b.f(kSegFeatureBits[j]), (int)kSegFeatureMax[j]);
                            if (kSegFeatureSigned[j] && b.bit()) v = -v;
                            feature(F_SEG_ALT_Q + j);
                        }
                        seg_data[i][j] = v;
                    }
            }
        }
        // tiles
        int min_log2 = 0, max_log2 = 1;
        while ((64 << min_log2) < sb_cols) min_log2++;
        while ((sb_cols >> max_log2) >= 4) max_log2++;
        max_log2--;
        tile_cols_log2 = min_log2;
        while (tile_cols_log2 < max_log2 && b.bit()) tile_cols_log2++;
        tile_rows_log2 = b.bit();
        if (tile_rows_log2) tile_rows_log2 += b.bit();
        if (tile_cols_log2) feature(F_TILE_COLS);
        if (tile_rows_log2) feature(F_TILE_ROWS);
        const int header_size = b.f(16);
        if (!header_size) throw Error(CORRUPT, "a VP9 frame without a compressed header");
        const size_t at = b.bytes();
        if (at + header_size > size) throw Error(CORRUPT, "the compressed header runs past the frame");
        compressed_size = header_size;
        return at;
    }
    int compressed_size = 0;

    void read_compressed(const uint8_t* d, size_t n) {
        BoolDecoder r;
        r.init(d, n);
        if (lossless) {
            tx_mode = ONLY_4X4;
        } else {
            tx_mode = r.literal(2);
            if (tx_mode == ALLOW_32X32) tx_mode += r.literal(1);
        }
        if (tx_mode == TX_MODE_SELECT) {
            feature(F_TX_SELECT);
            for (int i = 0; i < 2; i++) diff_update(r, &fc.tx8[i][0]);
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 2; j++) diff_update(r, &fc.tx16[i][j]);
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 3; j++) diff_update(r, &fc.tx32[i][j]);
        }
        for (int t = 0; t <= kTxModeMax[tx_mode]; t++)
            if (r.literal(1))
                for (int i = 0; i < 2; i++)
                    for (int j = 0; j < 2; j++)
                        for (int k = 0; k < 6; k++)
                            for (int l = 0; l < (k ? 6 : 3); l++)
                                for (int m = 0; m < 3; m++) diff_update(r, &fc.coef[t][i][j][k][l][m]);
        for (int i = 0; i < 3; i++) diff_update(r, &fc.skip[i]);
        if (intra) return;
        for (int i = 0; i < 7; i++)
            for (int j = 0; j < 3; j++) diff_update(r, &fc.inter_mode[i][j]);
        if (interp_filter == SWITCHABLE)
            for (int j = 0; j < 4; j++)
                for (int i = 0; i < 2; i++) diff_update(r, &fc.interp[j][i]);
        for (int i = 0; i < 4; i++) diff_update(r, &fc.is_inter[i]);
        ref_mode = SINGLE_REF;
        if (sign_bias[GOLDEN_FRAME] != sign_bias[LAST_FRAME] ||
            sign_bias[ALTREF_FRAME] != sign_bias[LAST_FRAME]) {
            if (r.literal(1)) ref_mode = r.literal(1) ? REF_SELECT : COMPOUND_REF;
            if (sign_bias[LAST_FRAME] == sign_bias[GOLDEN_FRAME]) {
                comp_fixed = ALTREF_FRAME;
                comp_var[0] = LAST_FRAME;
                comp_var[1] = GOLDEN_FRAME;
            } else if (sign_bias[LAST_FRAME] == sign_bias[ALTREF_FRAME]) {
                comp_fixed = GOLDEN_FRAME;
                comp_var[0] = LAST_FRAME;
                comp_var[1] = ALTREF_FRAME;
            } else {
                comp_fixed = LAST_FRAME;
                comp_var[0] = GOLDEN_FRAME;
                comp_var[1] = ALTREF_FRAME;
            }
        }
        if (ref_mode == REF_SELECT)
            for (int i = 0; i < 5; i++) diff_update(r, &fc.comp_inter[i]);
        if (ref_mode != COMPOUND_REF)
            for (int i = 0; i < 5; i++) {
                diff_update(r, &fc.single_ref[i][0]);
                diff_update(r, &fc.single_ref[i][1]);
            }
        if (ref_mode != SINGLE_REF)
            for (int i = 0; i < 5; i++) diff_update(r, &fc.comp_ref[i]);
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 9; j++) diff_update(r, &fc.y_mode[i][j]);
        for (int i = 0; i < 16; i++)
            for (int j = 0; j < 3; j++) diff_update(r, &fc.partition[i][j]);
        for (int j = 0; j < 3; j++) mv_update(r, &fc.mv_joint[j]);
        for (int i = 0; i < 2; i++) {
            MvComp& c = fc.mv[i];
            mv_update(r, &c.sign);
            for (int j = 0; j < 10; j++) mv_update(r, &c.classes[j]);
            mv_update(r, &c.class0[0]);
            for (int j = 0; j < 10; j++) mv_update(r, &c.bits[j]);
        }
        for (int i = 0; i < 2; i++) {
            MvComp& c = fc.mv[i];
            for (int j = 0; j < 2; j++)
                for (int k = 0; k < 3; k++) mv_update(r, &c.class0_fr[j][k]);
            for (int k = 0; k < 3; k++) mv_update(r, &c.fr[k]);
        }
        if (allow_hp)
            for (int i = 0; i < 2; i++) {
                mv_update(r, &fc.mv[i].class0_hp);
                mv_update(r, &fc.mv[i].hp);
            }
    }

    // ------------------------------------------------------- backward adaptation
    static uint8_t get_prob(uint32_t num, uint32_t den) {
        const int p = (int)(((uint64_t)num * 256 + (den >> 1)) / den);
        return (uint8_t)(p > 255 ? 255 : p < 1 ? 1 : p);
    }
    static uint8_t weighted(int pre, int prob, int factor) {
        return (uint8_t)((pre * (256 - factor) + prob * factor + 128) >> 8);
    }
    static uint8_t merge(uint8_t pre, uint32_t c0, uint32_t c1, uint32_t sat, uint32_t max_factor) {
        const uint32_t den = c0 + c1;
        const uint8_t prob = den ? get_prob(c0, den) : 128;
        const uint32_t factor = max_factor * std::min(den, sat) / sat;
        return weighted(pre, prob, (int)factor);
    }
    static uint8_t mode_merge(uint8_t pre, uint32_t c0, uint32_t c1) {
        static const int factor[21] = {0, 6, 12, 19, 25, 32, 38, 44, 51, 57, 64,
                                       70, 76, 83, 89, 96, 102, 108, 115, 121, 128};
        const uint32_t den = c0 + c1;
        if (!den) return pre;
        return weighted(pre, get_prob(c0, den), factor[std::min(den, 20u)]);
    }
    static uint32_t tree_merge(const int8_t* tree, int i, const uint8_t* pre, const uint32_t* counts,
                               uint8_t* probs) {
        const int l = tree[i], r = tree[i + 1];
        const uint32_t lc = l <= 0 ? counts[-l] : tree_merge(tree, l, pre, counts, probs);
        const uint32_t rc = r <= 0 ? counts[-r] : tree_merge(tree, r, pre, counts, probs);
        probs[i >> 1] = mode_merge(pre[i >> 1], lc, rc);
        return lc + rc;
    }

    void adapt() {
        feature(F_ADAPT);
        const Probs& pre = ctx[ctx_idx];
        const uint32_t uf = intra ? 112 : last_key ? 128 : 112;
        for (int t = 0; t < 4; t++)
            for (int i = 0; i < 2; i++)
                for (int j = 0; j < 2; j++)
                    for (int k = 0; k < 6; k++)
                        for (int l = 0; l < (k ? 6 : 3); l++) {
                            const uint32_t* c = counts.coef[t][i][j][k][l];
                            const uint32_t e = counts.eob[t][i][j][k][l];
                            const uint8_t* p = pre.coef[t][i][j][k][l];
                            uint8_t* o = fc.coef[t][i][j][k][l];
                            o[0] = merge(p[0], c[3], e - c[3], 24, uf);
                            o[1] = merge(p[1], c[0], c[1] + c[2], 24, uf);
                            o[2] = merge(p[2], c[1], c[2], 24, uf);
                        }
        if (intra) return;
        for (int i = 0; i < 4; i++) fc.is_inter[i] = mode_merge(pre.is_inter[i], counts.is_inter[i][0], counts.is_inter[i][1]);
        for (int i = 0; i < 5; i++) fc.comp_inter[i] = mode_merge(pre.comp_inter[i], counts.comp_inter[i][0], counts.comp_inter[i][1]);
        for (int i = 0; i < 5; i++) fc.comp_ref[i] = mode_merge(pre.comp_ref[i], counts.comp_ref[i][0], counts.comp_ref[i][1]);
        for (int i = 0; i < 5; i++)
            for (int j = 0; j < 2; j++)
                fc.single_ref[i][j] = mode_merge(pre.single_ref[i][j], counts.single_ref[i][j][0], counts.single_ref[i][j][1]);
        for (int i = 0; i < 7; i++) tree_merge(kInterModeTree, 0, pre.inter_mode[i], counts.inter_mode[i], fc.inter_mode[i]);
        for (int i = 0; i < 4; i++) tree_merge(kIntraModeTree, 0, pre.y_mode[i], counts.y_mode[i], fc.y_mode[i]);
        for (int i = 0; i < 10; i++) tree_merge(kIntraModeTree, 0, pre.uv_mode[i], counts.uv_mode[i], fc.uv_mode[i]);
        for (int i = 0; i < 16; i++) tree_merge(kPartitionTree, 0, pre.partition[i], counts.partition[i], fc.partition[i]);
        if (interp_filter == SWITCHABLE)
            for (int i = 0; i < 4; i++) tree_merge(kSwitchableTree, 0, pre.interp[i], counts.interp[i], fc.interp[i]);
        if (tx_mode == TX_MODE_SELECT)
            for (int i = 0; i < 2; i++) {
                const uint32_t* c8 = counts.tx8[i];
                const uint32_t* c16 = counts.tx16[i];
                const uint32_t* c32 = counts.tx32[i];
                fc.tx8[i][0] = mode_merge(pre.tx8[i][0], c8[0], c8[1]);
                fc.tx16[i][0] = mode_merge(pre.tx16[i][0], c16[0], c16[1] + c16[2]);
                fc.tx16[i][1] = mode_merge(pre.tx16[i][1], c16[1], c16[2]);
                fc.tx32[i][0] = mode_merge(pre.tx32[i][0], c32[0], c32[1] + c32[2] + c32[3]);
                fc.tx32[i][1] = mode_merge(pre.tx32[i][1], c32[1], c32[2] + c32[3]);
                fc.tx32[i][2] = mode_merge(pre.tx32[i][2], c32[2], c32[3]);
            }
        for (int i = 0; i < 3; i++) fc.skip[i] = mode_merge(pre.skip[i], counts.skip[i][0], counts.skip[i][1]);
        tree_merge(kMvJointTree, 0, pre.mv_joint, counts.mv_joint, fc.mv_joint);
        for (int i = 0; i < 2; i++) {
            const MvComp& p = pre.mv[i];
            MvComp& o = fc.mv[i];
            const MvCounts& c = counts.mv[i];
            o.sign = mode_merge(p.sign, c.sign[0], c.sign[1]);
            tree_merge(kMvClassTree, 0, p.classes, c.classes, o.classes);
            o.class0[0] = mode_merge(p.class0[0], c.class0[0], c.class0[1]);
            for (int j = 0; j < 10; j++) o.bits[j] = mode_merge(p.bits[j], c.bits[j][0], c.bits[j][1]);
            for (int j = 0; j < 2; j++) tree_merge(kMvFrTree, 0, p.class0_fr[j], c.class0_fr[j], o.class0_fr[j]);
            tree_merge(kMvFrTree, 0, p.fr, c.fr, o.fr);
            if (allow_hp) {
                o.class0_hp = mode_merge(p.class0_hp, c.class0_hp[0], c.class0_hp[1]);
                o.hp = mode_merge(p.hp, c.hp[0], c.hp[1]);
            }
        }
    }

    // ------------------------------------------------------- mode info
    Block* above = nullptr;
    Block* left = nullptr;

    Block* cell(int r, int c) { return &blocks[grid[(size_t)r * mi_cols + c]]; }
    bool seg_active(int seg, int f) const { return seg_enabled && seg_feature[seg][f]; }

    int read_skip(BoolDecoder& r, const Block& b) {
        if (seg_active(b.seg_id, SEG_SKIP)) return 1;
        const int ctx = (above ? above->skip : 0) + (left ? left->skip : 0);
        const int v = r.read(fc.skip[ctx]);
        counts.skip[ctx][v]++;
        return v;
    }

    int read_tx_size(BoolDecoder& r, const Block& b, bool allow_select) {
        const int max_tx = kMaxTx[b.sb_type];
        if (!(allow_select && tx_mode == TX_MODE_SELECT && b.sb_type >= B8X8))
            return std::min(max_tx, (int)kTxModeMax[tx_mode]);
        int a = (above && !above->skip) ? above->tx_size : max_tx;
        int l = (left && !left->skip) ? left->tx_size : max_tx;
        if (!left) l = a;
        if (!above) a = l;
        const int ctx = (a + l) > max_tx;
        const uint8_t* p = max_tx == TX_8X8 ? fc.tx8[ctx] : max_tx == TX_16X16 ? fc.tx16[ctx] : fc.tx32[ctx];
        int tx = r.read(p[0]);
        if (tx != TX_4X4 && max_tx >= TX_16X16) {
            tx += r.read(p[1]);
            if (tx != TX_8X8 && max_tx >= TX_32X32) tx += r.read(p[2]);
        }
        if (max_tx == TX_8X8) counts.tx8[ctx][tx]++;
        else if (max_tx == TX_16X16) counts.tx16[ctx][tx]++;
        else counts.tx32[ctx][tx]++;
        if (tx == TX_32X32) feature(F_TX32);
        return tx;
    }

    int prev_segment(int mi_row, int mi_col, int xm, int ym) const {
        int v = 8;
        for (int y = 0; y < ym; y++)
            for (int x = 0; x < xm; x++)
                v = std::min(v, (int)seg_map_prev[(size_t)(mi_row + y) * mi_cols + mi_col + x]);
        return v;
    }

    void set_segment(int mi_row, int mi_col, int xm, int ym, int id) {
        for (int y = 0; y < ym; y++)
            memset(&seg_map_cur[(size_t)(mi_row + y) * mi_cols + mi_col], id, xm);
    }

    void read_segment(BoolDecoder& r, Block& b, int mi_row, int mi_col, int xm, int ym) {
        if (!seg_enabled) return;
        if (intra) {
            b.seg_id = seg_update_map ? r.tree(kSegmentTree, seg_tree) : 0;
            set_segment(mi_row, mi_col, xm, ym, b.seg_id);
            return;
        }
        const int pred = error_res ? 0 : prev_segment(mi_row, mi_col, xm, ym);
        if (!seg_update_map) {
            b.seg_id = pred;
            for (int y = 0; y < ym; y++)
                memcpy(&seg_map_cur[(size_t)(mi_row + y) * mi_cols + mi_col],
                       &seg_map_prev[(size_t)(mi_row + y) * mi_cols + mi_col], xm);
            return;
        }
        if (seg_temporal) {
            const int ctx = (above ? above->seg_pred : 0) + (left ? left->seg_pred : 0);
            b.seg_pred = (uint8_t)r.read(seg_pred_probs[ctx]);
            b.seg_id = b.seg_pred ? pred : r.tree(kSegmentTree, seg_tree);
        } else {
            b.seg_id = r.tree(kSegmentTree, seg_tree);
        }
        set_segment(mi_row, mi_col, xm, ym, b.seg_id);
    }

    // the above and left sub-block modes of sub-block i (DC beyond the edge
    // or next to an inter block)
    int above_mode(const Block& b, int i) const {
        if (i >= 2) return b.bmode[i - 2];
        if (!above || above->inter()) return DC_PRED;
        return above->bmode[i + 2];
    }
    int left_mode(const Block& b, int i) const {
        if (i & 1) return b.bmode[i - 1];
        if (!left || left->inter()) return DC_PRED;
        return left->bmode[i + 1];
    }

    int read_y_mode(BoolDecoder& r, Block& b, int i) {
        if (intra) return r.tree(kIntraModeTree, kKfYModeProbs[above_mode(b, i)][left_mode(b, i)]);
        const int g = b.sb_type < B8X8 ? 0 : kSizeGroup[b.sb_type];
        const int m = r.tree(kIntraModeTree, fc.y_mode[g]);
        counts.y_mode[g][m]++;
        return m;
    }

    void read_intra_modes(BoolDecoder& r, Block& b) {
        switch (b.sb_type) {
        case B4X4:
            for (int i = 0; i < 4; i++) b.bmode[i] = (uint8_t)read_y_mode(r, b, i);
            break;
        case B4X8:
            b.bmode[0] = b.bmode[2] = (uint8_t)read_y_mode(r, b, 0);
            b.bmode[1] = b.bmode[3] = (uint8_t)read_y_mode(r, b, 1);
            break;
        case B8X4:
            b.bmode[0] = b.bmode[1] = (uint8_t)read_y_mode(r, b, 0);
            b.bmode[2] = b.bmode[3] = (uint8_t)read_y_mode(r, b, 2);
            break;
        default:
            b.bmode[0] = (uint8_t)read_y_mode(r, b, 0);
            b.bmode[1] = b.bmode[2] = b.bmode[3] = b.bmode[0];
        }
        b.mode = b.bmode[3];
        if (intra) {
            b.uv_mode = (uint8_t)r.tree(kIntraModeTree, kKfUvModeProbs[b.mode]);
        } else {
            b.uv_mode = (uint8_t)r.tree(kIntraModeTree, fc.uv_mode[b.mode]);
            counts.uv_mode[b.mode][b.uv_mode]++;
        }
        if (b.sb_type < B8X8) feature(F_SUB8X8);
    }

    // ---- reference frames
    int comp_ref_ctx() const {
        const int fix_idx = sign_bias[comp_fixed], var_idx = !fix_idx;
        const int cv1 = comp_var[1];
        if (above && left) {
            const bool ai = !above->inter(), li = !left->inter();
            if (ai && li) return 2;
            if (ai || li) {
                const Block* e = ai ? left : above;
                if (!e->compound()) return 1 + 2 * (e->ref[0] != cv1);
                return 1 + 2 * (e->ref[var_idx] != cv1);
            }
            const bool l_sg = !left->compound(), a_sg = !above->compound();
            const int vrfa = a_sg ? above->ref[0] : above->ref[var_idx];
            const int vrfl = l_sg ? left->ref[0] : left->ref[var_idx];
            if (vrfa == vrfl && cv1 == vrfa) return 0;
            if (l_sg && a_sg) {
                if ((vrfa == comp_fixed && vrfl == comp_var[0]) || (vrfl == comp_fixed && vrfa == comp_var[0]))
                    return 4;
                if (vrfa == vrfl) return 3;
                return 1;
            }
            if (l_sg || a_sg) {
                const int vrfc = l_sg ? vrfa : vrfl, rfs = a_sg ? vrfa : vrfl;
                if (vrfc == cv1 && rfs != cv1) return 1;
                if (rfs == cv1 && vrfc != cv1) return 2;
                return 4;
            }
            return vrfa == vrfl ? 4 : 2;
        }
        if (above || left) {
            const Block* e = above ? above : left;
            if (!e->inter()) return 2;
            if (e->compound()) return 4 * (e->ref[var_idx] != cv1);
            return 3 * (e->ref[0] != cv1);
        }
        return 2;
    }

    int comp_mode_ctx() const {
        if (above && left) {
            if (!above->compound() && !left->compound())
                return (above->ref[0] == comp_fixed) ^ (left->ref[0] == comp_fixed);
            if (!above->compound()) return 2 + (above->ref[0] == comp_fixed || !above->inter());
            if (!left->compound()) return 2 + (left->ref[0] == comp_fixed || !left->inter());
            return 4;
        }
        if (above || left) {
            const Block* e = above ? above : left;
            return e->compound() ? 3 : e->ref[0] == comp_fixed;
        }
        return 1;
    }

    int single_ref_p1_ctx() const {
        if (above && left) {
            const bool ai = !above->inter(), li = !left->inter();
            if (ai && li) return 2;
            if (ai || li) {
                const Block* e = ai ? left : above;
                if (!e->compound()) return 4 * (e->ref[0] == LAST_FRAME);
                return 1 + (e->ref[0] == LAST_FRAME || e->ref[1] == LAST_FRAME);
            }
            const bool ac = above->compound(), lc = left->compound();
            const int a0 = above->ref[0], a1 = above->ref[1], l0 = left->ref[0], l1 = left->ref[1];
            if (ac && lc) return 1 + (a0 == LAST_FRAME || a1 == LAST_FRAME || l0 == LAST_FRAME || l1 == LAST_FRAME);
            if (ac || lc) {
                const int rfs = !ac ? a0 : l0, crf1 = ac ? a0 : l0, crf2 = ac ? a1 : l1;
                if (rfs == LAST_FRAME) return 3 + (crf1 == LAST_FRAME || crf2 == LAST_FRAME);
                return crf1 == LAST_FRAME || crf2 == LAST_FRAME;
            }
            return 2 * (a0 == LAST_FRAME) + 2 * (l0 == LAST_FRAME);
        }
        if (above || left) {
            const Block* e = above ? above : left;
            if (!e->inter()) return 2;
            if (!e->compound()) return 4 * (e->ref[0] == LAST_FRAME);
            return 1 + (e->ref[0] == LAST_FRAME || e->ref[1] == LAST_FRAME);
        }
        return 2;
    }

    int single_ref_p2_ctx() const {
        if (above && left) {
            const bool ai = !above->inter(), li = !left->inter();
            if (ai && li) return 2;
            if (ai || li) {
                const Block* e = ai ? left : above;
                if (!e->compound()) {
                    if (e->ref[0] == LAST_FRAME) return 3;
                    return 4 * (e->ref[0] == GOLDEN_FRAME);
                }
                return 1 + 2 * (e->ref[0] == GOLDEN_FRAME || e->ref[1] == GOLDEN_FRAME);
            }
            const bool ac = above->compound(), lc = left->compound();
            const int a0 = above->ref[0], a1 = above->ref[1], l0 = left->ref[0], l1 = left->ref[1];
            if (ac && lc) {
                if (a0 == l0 && a1 == l1)
                    return 3 * (a0 == GOLDEN_FRAME || a1 == GOLDEN_FRAME || l0 == GOLDEN_FRAME || l1 == GOLDEN_FRAME);
                return 2;
            }
            if (ac || lc) {
                const int rfs = !ac ? a0 : l0, crf1 = ac ? a0 : l0, crf2 = ac ? a1 : l1;
                if (rfs == GOLDEN_FRAME) return 3 + (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
                if (rfs == ALTREF_FRAME) return crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME;
                return 1 + 2 * (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
            }
            if (a0 == LAST_FRAME && l0 == LAST_FRAME) return 3;
            if (a0 == LAST_FRAME || l0 == LAST_FRAME) {
                const int e0 = a0 == LAST_FRAME ? l0 : a0;
                return 4 * (e0 == GOLDEN_FRAME);
            }
            return 2 * (a0 == GOLDEN_FRAME) + 2 * (l0 == GOLDEN_FRAME);
        }
        if (above || left) {
            const Block* e = above ? above : left;
            if (!e->inter() || (e->ref[0] == LAST_FRAME && !e->compound())) return 2;
            if (!e->compound()) return 4 * (e->ref[0] == GOLDEN_FRAME);
            return 3 * (e->ref[0] == GOLDEN_FRAME || e->ref[1] == GOLDEN_FRAME);
        }
        return 2;
    }

    void read_refs(BoolDecoder& r, Block& b) {
        if (seg_active(b.seg_id, SEG_REF)) {
            b.ref[0] = (int8_t)seg_data[b.seg_id][SEG_REF];
            b.ref[1] = NONE_FRAME;
            return;
        }
        int mode = ref_mode;
        if (ref_mode == REF_SELECT) {
            const int ctx = comp_mode_ctx();
            mode = r.read(fc.comp_inter[ctx]);
            counts.comp_inter[ctx][mode]++;
        }
        if (mode == COMPOUND_REF) {
            const int idx = sign_bias[comp_fixed];
            const int ctx = comp_ref_ctx();
            const int bit = r.read(fc.comp_ref[ctx]);
            counts.comp_ref[ctx][bit]++;
            b.ref[idx] = (int8_t)comp_fixed;
            b.ref[!idx] = (int8_t)comp_var[bit];
            feature(F_COMPOUND);
        } else {
            const int c0 = single_ref_p1_ctx();
            const int b0 = r.read(fc.single_ref[c0][0]);
            counts.single_ref[c0][0][b0]++;
            if (b0) {
                const int c1 = single_ref_p2_ctx();
                const int b1 = r.read(fc.single_ref[c1][1]);
                counts.single_ref[c1][1][b1]++;
                b.ref[0] = b1 ? ALTREF_FRAME : GOLDEN_FRAME;
            } else {
                b.ref[0] = LAST_FRAME;
            }
            b.ref[1] = NONE_FRAME;
        }
    }

    // ---- motion vectors
    int cur_row = 0, cur_col = 0;   // the block being decoded, in 8x8 units

    void clamp_mv(MV& m, const Block& b, int margin) const {
        const int bw8 = kBw8[b.sb_type], bh8 = kBh8[b.sb_type];
        const int to_left = -cur_col * 64, to_right = (mi_cols - bw8 - cur_col) * 64;
        const int to_top = -cur_row * 64, to_bottom = (mi_rows - bh8 - cur_row) * 64;
        m.col = (int16_t)clampi(m.col, to_left - margin, to_right + margin);
        m.row = (int16_t)clampi(m.row, to_top - margin, to_bottom + margin);
    }

    MV scale_mv(MV m, int cand_ref, int ref_frame) const {
        if (sign_bias[cand_ref] != sign_bias[ref_frame]) {
            m.row = (int16_t)-m.row;
            m.col = (int16_t)-m.col;
        }
        return m;
    }

    // libvpx's find_mv_refs: two candidates (clamped), and the mode context
    int find_mv_refs(const Block& b, int ref_frame, int block, MV list[2]) {
        list[0] = list[1] = MV();
        int n = 0, counter = 0;
        bool diff_found = false;
        const int8_t(*pos)[2] = kMvRefBlocks[b.sb_type];
        auto inside = [&](int i, int& r, int& c) {
            r = cur_row + pos[i][0];
            c = cur_col + pos[i][1];
            return r >= 0 && r < mi_rows && c >= tile_col_start && c < tile_col_end;
        };
        auto add = [&](MV m) {
            if (n) {
                if (m != list[0]) {
                    list[1] = m;
                    n = 2;
                    return true;
                }
                return false;
            }
            list[0] = m;
            n = 1;
            return false;
        };
        const MvRef* prev = use_prev_mvs ? &last_frame->mvs[(size_t)cur_row * mi_cols + cur_col] : nullptr;
        int r, c;
        for (int i = 0; i < 2; i++)
            if (inside(i, r, c)) {
                const Block* k = cell(r, c);
                counter += kModeToCounter[k->mode];
                diff_found = true;
                for (int w = 0; w < 2; w++)
                    if (k->ref[w] == ref_frame) {
                        const MV m = block >= 0 && k->sb_type < B8X8
                                         ? k->bmv[kSubblockFromColumn[block][pos[i][1] == 0]][w]
                                         : k->mv[w];
                        if (add(m)) goto done;
                        break;
                    }
            }
        for (int i = 2; i < 8; i++)
            if (inside(i, r, c)) {
                const Block* k = cell(r, c);
                diff_found = true;
                for (int w = 0; w < 2; w++)
                    if (k->ref[w] == ref_frame) {
                        if (add(k->mv[w])) goto done;
                        break;
                    }
            }
        if (prev) {
            if (prev->ref[0] == ref_frame) {
                if (add(prev->mv[0])) goto done;
            } else if (prev->ref[1] == ref_frame) {
                if (add(prev->mv[1])) goto done;
            }
        }
        if (diff_found)
            for (int i = 0; i < 8; i++)
                if (inside(i, r, c)) {
                    const Block* k = cell(r, c);
                    if (!k->inter()) continue;
                    if (k->ref[0] != ref_frame && add(scale_mv(k->mv[0], k->ref[0], ref_frame))) goto done;
                    if (k->compound() && k->ref[1] != ref_frame && k->mv[1] != k->mv[0] &&
                        add(scale_mv(k->mv[1], k->ref[1], ref_frame)))
                        goto done;
                }
        if (prev) {
            if (prev->ref[0] != ref_frame && prev->ref[0] > INTRA_FRAME &&
                add(scale_mv(prev->mv[0], prev->ref[0], ref_frame)))
                goto done;
            if (prev->ref[1] > INTRA_FRAME && prev->ref[1] != ref_frame && prev->mv[1] != prev->mv[0] &&
                add(scale_mv(prev->mv[1], prev->ref[1], ref_frame)))
                goto done;
        }
    done:
        for (int i = 0; i < 2; i++) clamp_mv(list[i], b, 128);
        return kCounterToContext[counter];
    }

    // nearest and near of a block: precision lowered, clamped again
    void best_mvs(const Block& b, MV list[2]) const {
        for (int i = 0; i < 2; i++) {
            MV& m = list[i];
            const bool hp = allow_hp && abs(m.row) < 64 && abs(m.col) < 64;
            if (!hp) {
                if (m.row & 1) m.row += m.row > 0 ? -1 : 1;
                if (m.col & 1) m.col += m.col > 0 ? -1 : 1;
            }
            clamp_mv(m, b, 1248);
        }
    }

    int read_mv_component(BoolDecoder& r, int i, bool usehp) {
        const MvComp& p = fc.mv[i];
        MvCounts& c = counts.mv[i];
        const int sign = r.read(p.sign);
        const int cls = r.tree(kMvClassTree, p.classes);
        int d, mag;
        if (cls == 0) {
            d = r.read(p.class0[0]);
            mag = 0;
            c.class0[d]++;
        } else {
            d = 0;
            for (int k = 0; k < cls; k++) {
                const int bit = r.read(p.bits[k]);
                d |= bit << k;
                c.bits[k][bit]++;
            }
            mag = 2 << (cls + 2);
        }
        const int fr = r.tree(kMvFrTree, cls == 0 ? p.class0_fr[d] : p.fr);
        const int hp = usehp ? r.read(cls == 0 ? p.class0_hp : p.hp) : 1;
        c.sign[sign]++;
        c.classes[cls]++;
        if (cls == 0) {
            c.class0_fr[d][fr]++;
            c.class0_hp[hp]++;
        } else {
            c.fr[fr]++;
            c.hp[hp]++;
        }
        mag += ((d << 3) | (fr << 1) | hp) + 1;
        return sign ? -mag : mag;
    }

    MV read_mv(BoolDecoder& r, MV ref) {
        const int joint = r.tree(kMvJointTree, fc.mv_joint);
        counts.mv_joint[joint]++;
        const bool usehp = allow_hp && abs(ref.row) < 64 && abs(ref.col) < 64;
        if (usehp) feature(F_HIGH_PRECISION);
        int dr = 0, dc = 0;
        if (joint == 2 || joint == 3) dr = read_mv_component(r, 0, usehp);
        if (joint == 1 || joint == 3) dc = read_mv_component(r, 1, usehp);
        feature(F_NEW_MV);
        MV m;
        m.row = (int16_t)(ref.row + dr);
        m.col = (int16_t)(ref.col + dc);
        if (abs(m.row) >= (1 << 14) || abs(m.col) >= (1 << 14)) throw Error(CORRUPT, "a motion vector out of range");
        return m;
    }

    int read_inter_mode(BoolDecoder& r, int ctx) {
        const int m = r.tree(kInterModeTree, fc.inter_mode[ctx]);
        counts.inter_mode[ctx][m]++;
        return NEARESTMV + m;
    }

    void read_inter_modes(BoolDecoder& r, Block& b) {
        read_refs(r, b);
        const int nref = 1 + b.compound();
        MV best[2][2];   // [ref][nearest, near]
        int ctx = 0;
        for (int k = 0; k < nref; k++) {
            const int c = find_mv_refs(b, b.ref[k], -1, best[k]);
            if (k == 0) ctx = c;
            best_mvs(b, best[k]);
        }
        if (seg_active(b.seg_id, SEG_SKIP)) {
            b.mode = ZEROMV;
            if (b.sb_type < B8X8) throw Error(CORRUPT, "the segment skip feature on a block under 8x8");
        } else if (b.sb_type >= B8X8) {
            b.mode = (uint8_t)read_inter_mode(r, ctx);
        }
        if (interp_filter == SWITCHABLE) {
            const int lt = left ? left->filter : 3, at = above ? above->filter : 3;
            const int fctx = lt == at ? lt : lt == 3 ? at : at == 3 ? lt : 3;
            b.filter = (uint8_t)r.tree(kSwitchableTree, fc.interp[fctx]);
            counts.interp[fctx][b.filter]++;
            feature(F_SWITCHABLE);
        } else {
            b.filter = (uint8_t)interp_filter;
        }
        if (b.filter == EIGHTTAP_SMOOTH) feature(F_SMOOTH);
        if (b.filter == EIGHTTAP_SHARP) feature(F_SHARP);
        if (b.filter == BILINEAR) feature(F_BILINEAR);
        if (b.sb_type < B8X8) {
            feature(F_SUB8X8);
            const int nw = b.sb_type == B8X4 ? 2 : 1, nh = b.sb_type == B4X8 ? 2 : 1;
            int bmode = ZEROMV;
            for (int y = 0; y < 2; y += nh)
                for (int x = 0; x < 2; x += nw) {
                    const int j = y * 2 + x;
                    bmode = read_inter_mode(r, ctx);
                    MV mv[2];
                    for (int k = 0; k < nref; k++) {
                        if (bmode == NEWMV) {
                            mv[k] = read_mv(r, best[k][0]);
                        } else if (bmode == ZEROMV) {
                            mv[k] = MV();
                        } else {
                            MV list[2], nearest, near;
                            find_mv_refs(b, b.ref[k], j, list);
                            if (j == 0) {
                                nearest = list[0];
                                near = list[1];
                            } else if (j == 3) {
                                nearest = b.bmv[2][k];
                                const MV cand[4] = {b.bmv[1][k], b.bmv[0][k], list[0], list[1]};
                                for (int q = 0; q < 4; q++)
                                    if (cand[q] != nearest) {
                                        near = cand[q];
                                        break;
                                    }
                            } else {
                                nearest = b.bmv[0][k];
                                for (int q = 0; q < 2; q++)
                                    if (list[q] != nearest) {
                                        near = list[q];
                                        break;
                                    }
                            }
                            mv[k] = bmode == NEARESTMV ? nearest : near;
                        }
                        b.bmv[j][k] = mv[k];
                        if (nh == 2) b.bmv[j + 2][k] = mv[k];
                        if (nw == 2) b.bmv[j + 1][k] = mv[k];
                    }
                }
            b.mode = (uint8_t)bmode;
            b.mv[0] = b.bmv[3][0];
            b.mv[1] = b.bmv[3][1];
        } else {
            for (int k = 0; k < nref; k++) {
                if (b.mode == NEWMV) b.mv[k] = read_mv(r, best[k][0]);
                else if (b.mode == NEARESTMV) b.mv[k] = best[k][0];
                else if (b.mode == NEARMV) b.mv[k] = best[k][1];
                else b.mv[k] = MV();
                for (int j = 0; j < 4; j++) b.bmv[j][k] = b.mv[k];
            }
        }
    }

    // ------------------------------------------------------- residuals
    int read_coef_extra(BoolDecoder& r, const uint8_t* p, int n) {
        int v = 0;
        for (int i = 0; i < n; i++) v = (v << 1) | r.read(p[i]);
        return v;
    }

    int decode_coefs(BoolDecoder& r, int plane, int tx, const ScanOrder& so, bool inter, const int16_t* dqv,
                     int ctx) {
        const int type = plane > 0;
        uint8_t(*probs)[6][3] = fc.coef[tx][type][inter];
        uint32_t(*cnt)[6][4] = counts.coef[tx][type][inter];
        uint32_t(*eobc)[6] = counts.eob[tx][type][inter];
        const int max = 16 << (2 * tx), shift = tx == TX_32X32;
        const int16_t* scan = so.scan;
        const int16_t* nb = so.nb.data();
        uint8_t cache[1024];
        int c = 0, dq = dqv[0];
        while (c < max) {
            int band = band_of(tx, c);
            const uint8_t* p = probs[band][ctx];
            eobc[band][ctx]++;
            if (!r.read(p[0])) {
                cnt[band][ctx][3]++;
                break;
            }
            while (!r.read(p[1])) {
                cnt[band][ctx][0]++;
                dq = dqv[1];
                cache[scan[c]] = 0;
                if (++c >= max) return c;
                ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1;
                band = band_of(tx, c);
                p = probs[band][ctx];
            }
            int val, token;
            if (!r.read(p[2])) {
                cnt[band][ctx][1]++;
                token = 1;
                val = 1;
            } else {
                cnt[band][ctx][2]++;
                token = r.tree(kCoefConTree, kPareto8[p[2] - 1]);
                switch (token) {
                case 5: val = 5 + read_coef_extra(r, kCat1, 1); break;
                case 6: val = 7 + read_coef_extra(r, kCat2, 2); break;
                case 7: val = 11 + read_coef_extra(r, kCat3, 3); break;
                case 8: val = 19 + read_coef_extra(r, kCat4, 4); break;
                case 9: val = 35 + read_coef_extra(r, kCat5, 5); break;
                case 10: val = 67 + read_coef_extra(r, kCat6, 14); break;
                default: val = token;
                }
            }
            const int v = (val * dq) >> shift;
            coef[scan[c]] = (int16_t)(r.read(128) ? -v : v);
            cache[scan[c]] = kEnergyClass[token];
            ++c;
            ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1;
            dq = dqv[1];
        }
        return c;
    }

    // the tokens of one transform block at (x4, y4), in 4x4 units of the
    // plane, with their above/left nonzero contexts; returns the eob
    int read_tokens(BoolDecoder& r, const Block& b, int plane, int x4, int y4, int tx, int type) {
        const int n = 1 << tx, ss = plane > 0;
        uint8_t* a = &above_nz[plane][x4];
        uint8_t* l = &left_nz[plane][y4 & (15 >> ss)];
        int ctx_a = 0, ctx_l = 0;
        for (int i = 0; i < n; i++) {
            ctx_a |= a[i];
            ctx_l |= l[i];
        }
        const ScanOrder& so = scans().s[tx][type];
        const int eob = decode_coefs(r, plane, tx, so, b.inter(), dq[b.seg_id][plane > 0], ctx_a + ctx_l);
        const int cols4 = (mi_cols * 2) >> ss, rows4 = (mi_rows * 2) >> ss;
        for (int i = 0; i < n; i++) {
            a[i] = x4 + i < cols4 ? eob > 0 : 0;
            l[i] = y4 + i < rows4 ? eob > 0 : 0;
        }
        return eob;
    }

    void add_residual(int plane, int x, int y, int tx, int type) {
        const int n = 4 << tx;
        uint8_t* dst = cur->at(plane, x, y);
        const int stride = cur->stride[plane];
        if (lossless) iwht4_add(coef, dst, stride);
        else inverse_transform_add(coef, tx, type, dst, stride);
        memset(coef, 0, sizeof(int16_t) * n * n);
    }

    void predict_intra_tx(const Block& b, int plane, int mode, int tx, int aoff, int loff, int n4w) {
        const int ss = plane > 0, bs = 4 << tx;
        const int x0 = ((cur_col * 8) >> ss) + 4 * aoff, y0 = ((cur_row * 8) >> ss) + 4 * loff;
        const int fw = (mi_cols * 8) >> ss, fh = (mi_rows * 8) >> ss;
        const int bw8 = kBw8[b.sb_type], bh8 = kBh8[b.sb_type];
        const bool right_out = mi_cols - bw8 - cur_col < 0, bottom_out = mi_rows - bh8 - cur_row < 0;
        const bool have_top = loff || above, have_left = aoff || left;
        const bool have_right = aoff + (1 << tx) < n4w;
        Frame& f = *cur;
        uint8_t abuf[16 + 64 + 16];
        uint8_t* A = abuf + 16;
        uint8_t L[32];
        if (have_left) {
            const int avail = bottom_out && y0 + bs > fh ? fh - y0 : bs;
            for (int i = 0; i < avail; i++) L[i] = *f.at(plane, x0 - 1, y0 + i);
            for (int i = avail; i < bs; i++) L[i] = L[avail - 1];
        } else {
            memset(L, 129, bs);
        }
        if (have_top) {
            const uint8_t* ar = f.at(plane, x0, y0 - 1);
            int copy;
            if (right_out) {
                if (x0 + 2 * bs <= fw) copy = have_right && bs == 4 ? 2 * bs : bs;
                else if (x0 + bs <= fw) copy = have_right && bs == 4 ? fw - x0 : bs;
                else copy = fw - x0;
            } else {
                copy = have_right && bs == 4 ? 2 * bs : bs;
            }
            memcpy(A, ar, copy);
            for (int i = copy; i < 2 * bs; i++) A[i] = A[copy - 1];
            A[-1] = have_left ? ar[-1] : 129;
        } else {
            memset(A - 1, 127, 2 * bs + 1);
        }
        intra_predict(mode, bs, A, L, have_top, have_left, f.at(plane, x0, y0), f.stride[plane]);
    }

    // ------------------------------------------------------- inter prediction
    void mc(int plane, const Frame& rf, int x, int y, int w, int h, MV mv, int bw, int bh, const Block& b,
            bool avg) {
        const int ss = plane > 0, mul = 1 << (1 - ss);
        const int bw8 = kBw8[b.sb_type], bh8 = kBh8[b.sb_type];
        const int to_left = -cur_col * 64, to_right = (mi_cols - bw8 - cur_col) * 64;
        const int to_top = -cur_row * 64, to_bottom = (mi_rows - bh8 - cur_row) * 64;
        const int spel_left = (4 + bw) << 4, spel_top = (4 + bh) << 4;
        const int mcol = clampi(mv.col * mul, to_left * mul - spel_left, to_right * mul + spel_left - 16);
        const int mrow = clampi(mv.row * mul, to_top * mul - spel_top, to_bottom * mul + spel_top - 16);
        const int px = x + (mcol >> 4) - 3, py = y + (mrow >> 4) - 3;
        const int pw = rf.pw(plane), ph = rf.ph(plane), rs = rf.stride[plane];
        const uint8_t* base = rf.p[plane].data();
        uint8_t src[71 * 71];
        const int sw = w + 7, sh = h + 7;
        if (px >= 0 && py >= 0 && px + sw <= pw && py + sh <= ph) {
            for (int r = 0; r < sh; r++) memcpy(src + r * sw, base + (size_t)(py + r) * rs + px, sw);
        } else {
            for (int r = 0; r < sh; r++) {
                const uint8_t* row = base + (size_t)clampi(py + r, 0, ph - 1) * rs;
                for (int c = 0; c < sw; c++) src[r * sw + c] = row[clampi(px + c, 0, pw - 1)];
            }
        }
        convolve(src, sw, cur->at(plane, x, y), cur->stride[plane], w, h, kFilters[b.filter][mcol & 15],
                 kFilters[b.filter][mrow & 15], avg);
    }

    // Scaled motion compensation, as FFmpeg's vp9recon.c (mc_luma_scaled,
    // mc_chroma_scaled) and vp9dsp_template.c (do_scaled_8tap_c) run it: the
    // vector clamped around the block, the block's position and the vector
    // scaled to the reference by 14-bit factors (libvpx scales chroma's x
    // and y apart, and FFmpeg reproduces the rounding that follows), then
    // one filter phase a pixel, stepping 1/16 pel by ``step``; reads are
    // edge-extended at the reference's visible size.  (x, y) is the block's
    // position in the plane, (px, py) a sub-8x8 block's offset in its 8x8
    // and (pw, ph) the size the vector is clamped around.
    void mc_scaled(int plane, const Frame& rf, int x, int y, int bw, int bh, MV mv, int px, int py,
                   int pw, int ph, const Block& b, bool avg) {
        const int64_t sx = ((int64_t)rf.w << 14) / width, sy = ((int64_t)rf.h << 14) / height;
        const int dx = (int)((16 * sx) >> 14), dy = (int)((16 * sy) >> 14);
        auto scale = [](int64_t n, int64_t s) { return (n * s) >> 14; };
        int64_t mx, my;
        if (plane == 0) {
            const int vx = clampi(mv.col, -(x + pw - px + 4) * 8, (mi_cols * 8 - x + px + 3) * 8);
            const int vy = clampi(mv.row, -(y + ph - py + 4) * 8, (mi_rows * 8 - y + py + 3) * 8);
            mx = scale(vx * 2, sx) + scale(x * 16, sx);
            my = scale(vy * 2, sy) + scale(y * 16, sy);
        } else {
            const int vx = clampi(mv.col, -(x + pw - px + 4) * 16, (mi_cols * 4 - x + px + 3) * 16);
            const int vy = clampi(mv.row, -(y + ph - py + 4) * 16, (mi_rows * 4 - y + py + 3) * 16);
            mx = scale(vx, sx) + (scale(x * 16, sx) & ~15) + (scale(x * 32, sx) & 15);
            my = scale(vy, sy) + (scale(y * 16, sy) & ~15) + (scale(y * 32, sy) & 15);
        }
        scaled_8tap(rf.p[plane].data(), rf.stride[plane], rf.pw(plane), rf.ph(plane), (int)(mx >> 4),
                    (int)(my >> 4), (int)(mx & 15), (int)(my & 15), dx, dy, bw, bh, kFilters[b.filter],
                    cur->at(plane, x, y), cur->stride[plane], avg);
    }

    // A block's prediction from each of its references.  A reference of
    // another size goes through mc_scaled; one of this frame's size through
    // mc, whose pixels equal FFmpeg's whichever way it splits the block.
    void inter_predict(const Block& b) {
        for (int k = 0; k < 1 + b.compound(); k++) {
            const Frame& rf = *refs[ref_idx[b.ref[k] - 1]];
            const bool scaled = rf.w != width || rf.h != height;
            if (scaled) feature(F_SCALED);
            auto pred = [&](int plane, int x, int y, int w, int h, MV mv, int px, int py, int pw, int ph) {
                if (scaled) mc_scaled(plane, rf, x, y, w, h, mv, px, py, pw, ph, b, k > 0);
                else mc(plane, rf, x, y, w, h, mv, pw, ph, b, k > 0);
            };
            for (int plane = 0; plane < 3; plane++) {
                const int ss = plane > 0;
                const int x0 = (cur_col * 8) >> ss, y0 = (cur_row * 8) >> ss;
                if (b.sb_type < B8X8) {
                    if (plane == 0) {
                        for (int y = 0; y < 2; y++)
                            for (int x = 0; x < 2; x++)
                                pred(0, x0 + 4 * x, y0 + 4 * y, 4, 4, b.bmv[y * 2 + x][k], 4 * x, 4 * y, 8, 8);
                    } else {
                        int sr = 0, sc = 0;
                        for (int j = 0; j < 4; j++) {
                            sr += b.bmv[j][k].row;
                            sc += b.bmv[j][k].col;
                        }
                        MV m;
                        m.row = (int16_t)((sr < 0 ? sr - 2 : sr + 2) / 4);
                        m.col = (int16_t)((sc < 0 ? sc - 2 : sc + 2) / 4);
                        pred(plane, x0, y0, 4, 4, m, 0, 0, 4, 4);
                    }
                } else {
                    const int w = (kBw8[b.sb_type] * 8) >> ss, h = (kBh8[b.sb_type] * 8) >> ss;
                    pred(plane, x0, y0, w, h, b.mv[k], 0, 0, w, h);
                }
            }
        }
    }

    // ------------------------------------------------------- blocks
    void decode_block(BoolDecoder& r, int mi_row, int mi_col, int bsize) {
        Block b;
        b.sb_type = (uint8_t)bsize;
        b.row = mi_row;
        b.col = mi_col;
        cur_row = mi_row;
        cur_col = mi_col;
        const int bw8 = kBw8[bsize], bh8 = kBh8[bsize];
        const int xm = std::min(bw8, mi_cols - mi_col), ym = std::min(bh8, mi_rows - mi_row);
        above = mi_row > 0 ? cell(mi_row - 1, mi_col) : nullptr;
        left = mi_col > tile_col_start ? cell(mi_row, mi_col - 1) : nullptr;
        read_segment(r, b, mi_row, mi_col, xm, ym);
        b.skip = (uint8_t)read_skip(r, b);
        if (intra) {
            b.tx_size = (uint8_t)read_tx_size(r, b, true);
            read_intra_modes(r, b);
        } else {
            int is_inter;
            if (seg_active(b.seg_id, SEG_REF)) {
                is_inter = seg_data[b.seg_id][SEG_REF] != INTRA_FRAME;
            } else {
                int ctx = 0;
                if (above && left) {
                    const bool ai = !above->inter(), li = !left->inter();
                    ctx = ai && li ? 3 : (ai || li);
                } else if (above || left) {
                    ctx = 2 * !(above ? above : left)->inter();
                }
                is_inter = r.read(fc.is_inter[ctx]);
                counts.is_inter[ctx][is_inter]++;
            }
            b.tx_size = (uint8_t)read_tx_size(r, b, !b.skip || !is_inter);
            if (is_inter) {
                read_inter_modes(r, b);
            } else {
                read_intra_modes(r, b);
                feature(F_INTRA_IN_INTER);
            }
        }
        const int32_t idx = (int32_t)blocks.size();
        blocks.push_back(b);
        for (int y = 0; y < ym; y++)
            for (int x = 0; x < xm; x++) grid[(size_t)(mi_row + y) * mi_cols + mi_col + x] = idx;
        Block& B = blocks.back();
        reconstruct(r, B);
        MvRef m;
        m.ref[0] = B.ref[0];
        m.ref[1] = B.ref[1];
        m.mv[0] = B.mv[0];
        m.mv[1] = B.mv[1];
        for (int y = 0; y < ym; y++)
            for (int x = 0; x < xm; x++) cur->mvs[(size_t)(mi_row + y) * mi_cols + mi_col + x] = m;
    }

    void reconstruct(BoolDecoder& r, Block& B) {
        const int bsize = std::max((int)B.sb_type, (int)B8X8);
        const int bw8 = kBw8[B.sb_type], bh8 = kBh8[B.sb_type];
        const int right = (mi_cols - bw8 - cur_col) * 64, bottom = (mi_rows - bh8 - cur_row) * 64;
        const int uv_tx = B.sb_type < B8X8 ? TX_4X4
                                            : std::min((int)B.tx_size, (int)__builtin_ctz(std::min(bw8, bh8)));
        if (B.skip) {
            for (int plane = 0; plane < 3; plane++) {
                const int ss = plane > 0;
                const int n4w = std::max(1, kBw4[bsize] >> ss), n4h = std::max(1, kBh4[bsize] >> ss);
                memset(&above_nz[plane][(cur_col * 2) >> ss], 0, n4w);
                memset(&left_nz[plane][((cur_row & 7) * 2) >> ss], 0, n4h);
            }
        }
        if (B.inter()) inter_predict(B);
        int eobtotal = 0;
        for (int plane = 0; plane < 3; plane++) {
            const int ss = plane > 0;
            const int tx = plane ? uv_tx : B.tx_size, step = 1 << tx;
            const int n4w = std::max(1, kBw4[bsize] >> ss), n4h = std::max(1, kBh4[bsize] >> ss);
            const int max_w = n4w + (right < 0 ? right >> (5 + ss) : 0);
            const int max_h = n4h + (bottom < 0 ? bottom >> (5 + ss) : 0);
            const int x4 = (cur_col * 2) >> ss, y4 = (cur_row * 2) >> ss;
            for (int row = 0; row < max_h; row += step)
                for (int col = 0; col < max_w; col += step) {
                    int type = DCT_DCT;
                    if (!B.inter()) {
                        const int mode = plane ? B.uv_mode
                                               : B.sb_type < B8X8 ? B.bmode[(row << 1) + col] : B.mode;
                        predict_intra_tx(B, plane, mode, tx, col, row, n4w);
                        if (!plane && !lossless) type = kModeToTxType[mode];
                    }
                    if (B.skip) continue;
                    const int eob = read_tokens(r, B, plane, x4 + col, y4 + row, tx, type);
                    if (eob) add_residual(plane, 4 * (x4 + col), 4 * (y4 + row), tx, type);
                    eobtotal += eob;
                }
        }
        if (B.inter() && !B.skip && B.sb_type >= B8X8 && eobtotal == 0) B.skip = 1;
    }

    void decode_partition(BoolDecoder& r, int mi_row, int mi_col, int bsize) {
        if (mi_row >= mi_rows || mi_col >= mi_cols) return;
        const int n8 = kBw8[bsize], hbs = n8 >> 1, bsl = __builtin_ctz(n8);
        const bool has_rows = mi_row + hbs < mi_rows, has_cols = mi_col + hbs < mi_cols;
        const int a = (above_part[mi_col] >> bsl) & 1, l = (left_part[mi_row & 7] >> bsl) & 1;
        const int ctx = bsl * 4 + l * 2 + a;
        const uint8_t* p = intra ? kKfPartitionProbs[ctx] : fc.partition[ctx];
        int part;
        if (has_rows && has_cols) part = r.tree(kPartitionTree, p);
        else if (!has_rows && has_cols) part = r.read(p[1]) ? PART_SPLIT : PART_HORZ;
        else if (has_rows && !has_cols) part = r.read(p[2]) ? PART_SPLIT : PART_VERT;
        else part = PART_SPLIT;
        counts.partition[ctx][part]++;
        const int sub = kSubsize[part][bsize];
        if (!hbs) {
            decode_block(r, mi_row, mi_col, sub);
        } else {
            switch (part) {
            case PART_NONE: decode_block(r, mi_row, mi_col, sub); break;
            case PART_HORZ:
                decode_block(r, mi_row, mi_col, sub);
                if (has_rows) decode_block(r, mi_row + hbs, mi_col, sub);
                break;
            case PART_VERT:
                decode_block(r, mi_row, mi_col, sub);
                if (has_cols) decode_block(r, mi_row, mi_col + hbs, sub);
                break;
            default:
                decode_partition(r, mi_row, mi_col, sub);
                decode_partition(r, mi_row, mi_col + hbs, sub);
                decode_partition(r, mi_row + hbs, mi_col, sub);
                decode_partition(r, mi_row + hbs, mi_col + hbs, sub);
            }
        }
        if (bsize == B8X8 || part != PART_SPLIT) {
            memset(&above_part[mi_col], kPartCtxAbove[sub], n8);
            memset(&left_part[mi_row & 7], kPartCtxLeft[sub], n8);
        }
    }

    static int tile_offset(int i, int mis, int log2) {
        const int sbs = (mis + 7) >> 3;
        return std::min(((i * sbs) >> log2) << 3, mis);
    }

    void decode_tiles(const uint8_t* data, size_t size) {
        const int tcols = 1 << tile_cols_log2, trows = 1 << tile_rows_log2;
        const int acols = sb_cols * 16;
        for (int k = 0; k < 3; k++) above_nz[k].assign(acols + 16, 0);
        above_part.assign(sb_cols * 8 + 8, 0);
        size_t pos = 0;
        for (int tr = 0; tr < trows; tr++)
            for (int tc = 0; tc < tcols; tc++) {
                size_t tsize;
                if (tr == trows - 1 && tc == tcols - 1) {
                    tsize = size - pos;
                } else {
                    if (size - pos < 4) throw Error(CORRUPT, "a tile size past the end of the frame");
                    tsize = (size_t)data[pos] << 24 | data[pos + 1] << 16 | data[pos + 2] << 8 | data[pos + 3];
                    pos += 4;
                    if (tsize > size - pos) throw Error(CORRUPT, "a tile runs past the end of the frame");
                }
                if (tsize < 1) throw Error(CORRUPT, "an empty tile");
                BoolDecoder r;
                r.init(data + pos, tsize);
                tile_col_start = tile_offset(tc, mi_cols, tile_cols_log2);
                tile_col_end = tile_offset(tc + 1, mi_cols, tile_cols_log2);
                const int rs = tile_offset(tr, mi_rows, tile_rows_log2), re = tile_offset(tr + 1, mi_rows, tile_rows_log2);
                for (int mi_row = rs; mi_row < re; mi_row += 8) {
                    memset(left_nz, 0, sizeof left_nz);
                    memset(left_part, 0, sizeof left_part);
                    for (int mi_col = tile_col_start; mi_col < tile_col_end; mi_col += 8)
                        decode_partition(r, mi_row, mi_col, B64X64);
                }
                pos += tsize;
            }
    }

    // ------------------------------------------------------- loop filter
    struct Masks {
        uint64_t left[3], above[3], int4;   // by filter size: 4, 8, 16 (and 32)
        uint16_t left_uv[3], above_uv[3], int4_uv;
        uint8_t lfl[64];
    };

    int block_level(const Block& b, const uint8_t (*lvl)[4][2]) const {
        if (!b.inter()) return lvl[b.seg_id][INTRA_FRAME][0];
        return lvl[b.seg_id][b.ref[0]][b.mode != ZEROMV];
    }

    void build_masks(int sb_row, int sb_col, const uint8_t (*lvl)[4][2], Masks& m) {
        memset(&m, 0, sizeof m);
        const int r0 = sb_row * 8, c0 = sb_col * 8;
        const int rows = std::min(8, mi_rows - r0), cols = std::min(8, mi_cols - c0);
        auto cat = [](int tx) { return tx == TX_32X32 ? 2 : tx; };
        auto aligned = [](int pos, int tx) { return tx <= TX_8X8 || (pos & ((1 << (tx - 1)) - 1)) == 0; };
        for (int r = 0; r < rows; r++)
            for (int c = 0; c < cols; c++) {
                const Block& b = *cell(r0 + r, c0 + c);
                const int level = block_level(b, lvl);
                if (!level) continue;
                m.lfl[r * 8 + c] = (uint8_t)level;
                const int tx = b.tx_size;
                const bool skip_inter = b.skip && b.inter();
                const uint64_t bit = (uint64_t)1 << (r * 8 + c);
                if (r0 + r == b.row || (!skip_inter && aligned(r, tx))) m.above[cat(tx)] |= bit;
                if (c0 + c == b.col || (!skip_inter && aligned(c, tx))) m.left[cat(tx)] |= bit;
                if (tx == TX_4X4 && !skip_inter) m.int4 |= bit;
            }
        for (int r = 0; r < 4 && 2 * r < rows; r++)
            for (int c = 0; c < 4 && 2 * c < cols; c++) {
                const Block& b = *cell(r0 + 2 * r, c0 + 2 * c);
                if (!block_level(b, lvl)) continue;
                const int bw8 = kBw8[b.sb_type], bh8 = kBh8[b.sb_type];
                const int tx = b.sb_type < B8X8 ? TX_4X4
                                                : std::min((int)b.tx_size, (int)__builtin_ctz(std::min(bw8, bh8)));
                const bool skip_inter = b.skip && b.inter();
                const uint16_t bit = (uint16_t)(1 << (r * 4 + c));
                if (r0 + 2 * r == (b.row & ~1) || (!skip_inter && aligned(r, tx))) m.above_uv[cat(tx)] |= bit;
                if (c0 + 2 * c == (b.col & ~1) || (!skip_inter && aligned(c, tx))) m.left_uv[cat(tx)] |= bit;
                if (tx == TX_4X4 && !skip_inter) m.int4_uv |= bit;
            }
        // at least an 8-wide filter on every 32x32 edge
        const uint64_t left_border = 0x1111111111111111ULL, above_border = 0x000000ff000000ffULL;
        m.left[1] |= m.left[0] & left_border;
        m.left[0] &= ~left_border;
        m.above[1] |= m.above[0] & above_border;
        m.above[0] &= ~above_border;
        m.left_uv[1] |= m.left_uv[0] & 0x1111;
        m.left_uv[0] &= (uint16_t)~0x1111;
        m.above_uv[1] |= m.above_uv[0] & 0x000f;
        m.above_uv[0] &= (uint16_t)~0x000f;
        if (rows < 8) {
            if (rows == 1) {
                m.above_uv[1] |= m.above_uv[2];
                m.above_uv[2] = 0;
            }
            if (rows == 5) {
                m.above_uv[1] |= m.above_uv[2] & 0xff00;
                m.above_uv[2] &= (uint16_t)~(m.above_uv[2] & 0xff00);
            }
        }
        if (cols < 8) {
            m.int4_uv &= (uint16_t)(((1 << (cols >> 1)) - 1) * 0x1111);
            if (cols == 1) {
                m.left_uv[1] |= m.left_uv[2];
                m.left_uv[2] = 0;
            }
            if (cols == 5) {
                m.left_uv[1] |= m.left_uv[2] & 0xcccc;
                m.left_uv[2] &= (uint16_t)~(m.left_uv[2] & 0xcccc);
            }
        }
        if (sb_col == 0) {
            for (int k = 0; k < 3; k++) {
                m.left[k] &= 0xfefefefefefefefeULL;
                m.left_uv[k] &= 0xeeee;
            }
        }
    }

    void filter_plane(int plane, int sb_row, int sb_col, const Masks& m, const uint8_t* lim,
                      const uint8_t* mblim) {
        const int ss = plane > 0, n = ss ? 4 : 8;
        const int rows_in = std::min(8, mi_rows - sb_row * 8);
        const int nrows = ss ? (rows_in + 1) >> 1 : rows_in;
        uint8_t* base = cur->at(plane, (sb_col * 64) >> ss, (sb_row * 64) >> ss);
        const int s = cur->stride[plane];
        auto bitof = [&](int which, int k, int r, int c) -> bool {
            const int i = r * n + c;
            if (ss) {
                const uint16_t v = which == 0 ? m.left_uv[k] : which == 1 ? m.above_uv[k] : m.int4_uv;
                return v >> i & 1;
            }
            const uint64_t v = which == 0 ? m.left[k] : which == 1 ? m.above[k] : m.int4;
            return v >> i & 1;
        };
        auto level = [&](int r, int c) { return ss ? m.lfl[(2 * r) * 8 + 2 * c] : m.lfl[r * 8 + c]; };
        auto edge = [&](uint8_t* p, int across, int along, int size, int lv) {
            for (int i = 0; i < 8; i++) lpf_line(p + i * along, across, size, mblim[lv], lim[lv], lv >> 4);
        };
        // columns: every vertical edge, left to right along each row
        for (int r = 0; r < nrows; r++)
            for (int c = 0; c < n; c++) {
                uint8_t* p = base + (size_t)r * 8 * s + c * 8;
                const int lv = level(r, c);
                if (bitof(0, 2, r, c)) edge(p, 1, s, 16, lv);
                else if (bitof(0, 1, r, c)) edge(p, 1, s, 8, lv);
                else if (bitof(0, 0, r, c)) edge(p, 1, s, 4, lv);
                if (bitof(2, 0, r, c)) edge(p + 4, 1, s, 4, lv);
            }
        // rows: every horizontal edge, top to bottom
        for (int r = 0; r < nrows; r++) {
            const bool top = sb_row == 0 && r == 0;
            const bool skip_int = ss && sb_row * 8 + 2 * r == mi_rows - 1;
            for (int c = 0; c < n; c++) {
                uint8_t* p = base + (size_t)r * 8 * s + c * 8;
                const int lv = level(r, c);
                if (!top) {
                    if (bitof(1, 2, r, c)) edge(p, s, 1, 16, lv);
                    else if (bitof(1, 1, r, c)) edge(p, s, 1, 8, lv);
                    else if (bitof(1, 0, r, c)) edge(p, s, 1, 4, lv);
                }
                if (!skip_int && bitof(2, 0, r, c)) edge(p + 4 * s, s, 1, 4, lv);
            }
        }
    }

    void loop_filter() {
        if (!lf_level) return;
        uint8_t lvl[8][4][2];
        const int scale = 1 << (lf_level >> 5);
        for (int seg = 0; seg < 8; seg++) {
            int ls = lf_level;
            if (seg_active(seg, SEG_ALT_LF))
                ls = clampi(seg_abs ? seg_data[seg][SEG_ALT_LF] : lf_level + seg_data[seg][SEG_ALT_LF], 0, 63);
            if (!lf_delta_enabled) {
                memset(lvl[seg], ls, sizeof lvl[seg]);
                continue;
            }
            lvl[seg][0][0] = lvl[seg][0][1] = (uint8_t)clampi(ls + lf_ref_deltas[0] * scale, 0, 63);
            for (int ref = 1; ref < 4; ref++)
                for (int mode = 0; mode < 2; mode++)
                    lvl[seg][ref][mode] =
                        (uint8_t)clampi(ls + lf_ref_deltas[ref] * scale + lf_mode_deltas[mode] * scale, 0, 63);
        }
        uint8_t lim[64], mblim[64];
        for (int lv = 0; lv < 64; lv++) {
            int inner = lv >> ((lf_sharpness > 0) + (lf_sharpness > 4));
            if (lf_sharpness > 0 && inner > 9 - lf_sharpness) inner = 9 - lf_sharpness;
            if (inner < 1) inner = 1;
            lim[lv] = (uint8_t)inner;
            mblim[lv] = (uint8_t)(2 * (lv + 2) + inner);
        }
        Masks m;
        for (int sr = 0; sr < sb_rows; sr++)
            for (int sc = 0; sc < sb_cols; sc++) {
                build_masks(sr, sc, lvl, m);
                for (int plane = 0; plane < 3; plane++) filter_plane(plane, sr, sc, m, lim, mblim);
            }
    }

    // ------------------------------------------------------- a frame
    void setup_dequant() {
        for (int seg = 0; seg < 8; seg++) {
            int q = base_q;
            if (seg_active(seg, SEG_ALT_Q))
                q = clampi(seg_abs ? seg_data[seg][SEG_ALT_Q] : base_q + seg_data[seg][SEG_ALT_Q], 0, 255);
            dq[seg][0][0] = kDcQLookup[clampi(q + dq_y_dc, 0, 255)];
            dq[seg][0][1] = kAcQLookup[q];
            dq[seg][1][0] = kDcQLookup[clampi(q + dq_uv_dc, 0, 255)];
            dq[seg][1][1] = kAcQLookup[clampi(q + dq_uv_ac, 0, 255)];
        }
    }

    // one frame (not a superframe); returns whether it is shown (in shown)
    bool decode_frame(const uint8_t* data, size_t size) {
        if (!size) throw Error(CORRUPT, "an empty frame");
        const size_t at = read_uncompressed(data, size);
        if (show_existing) {
            feature(F_SHOW_EXISTING);
            return true;
        }
        use_prev_mvs = !error_res && last_frame && last_show && last_frame->w == width &&
                       last_frame->h == height && !intra;
        if (use_prev_mvs) feature(F_PREV_MVS);
        cur = std::make_shared<Frame>(width, height);
        fc = ctx[ctx_idx];
        memset(&counts, 0, sizeof counts);
        read_compressed(data + at, compressed_size);
        setup_dequant();
        blocks.clear();
        blocks.reserve((size_t)mi_cols * mi_rows);
        grid.assign((size_t)mi_cols * mi_rows, 0);
        seg_map_cur.assign((size_t)mi_cols * mi_rows, 0);
        const size_t body = at + compressed_size;
        decode_tiles(data + body, size - body);
        loop_filter();
        if (!error_res && !parallel) adapt();
        if (refresh_ctx) ctx[ctx_idx] = fc;
        if (seg_enabled) seg_map_prev.swap(seg_map_cur);
        for (int i = 0; i < 8; i++)
            if (refresh_flags >> i & 1) refs[i] = cur;
        last_frame = cur;
        last_show = show_frame;
        have_key = true;
        if (show_frame) shown = cur;
        else feature(F_HIDDEN);
        return show_frame != 0;
    }

    std::vector<FramePtr> out;

    // a packet: a superframe's frames in turn (FFmpeg's vp9_superframe_split)
    void decode_packet(const uint8_t* data, size_t size) {
        out.clear();
        if (!size) throw Error(CORRUPT, "an empty packet");
        const uint8_t marker = data[size - 1];
        std::vector<size_t> sizes;
        if ((marker & 0xe0) == 0xc0) {
            const int nframes = (marker & 7) + 1, mag = ((marker >> 3) & 3) + 1;
            const size_t idx = 2 + (size_t)mag * nframes;
            if (size >= idx && data[size - idx] == marker) {
                const uint8_t* p = data + size - idx + 1;
                size_t total = 0;
                for (int i = 0; i < nframes; i++) {
                    size_t s = 0;
                    for (int k = 0; k < mag; k++) s |= (size_t)p[k] << (8 * k);
                    p += mag;
                    sizes.push_back(s);
                    total += s;
                }
                if (total > size - idx) throw Error(CORRUPT, "a superframe index larger than its packet");
                feature(F_SUPERFRAME);
            }
        }
        if (sizes.empty()) sizes.push_back(size);
        size_t pos = 0;
        for (size_t s : sizes) {
            if (!s) continue;
            if (decode_frame(data + pos, s)) out.push_back(shown);
            pos += s;
        }
    }
};

int fail(const Error& e, char* msg, int64_t cap) {
    snprintf(msg, (size_t)cap, "%s", e.what());
    return e.code;
}

}  // namespace

extern "C" {

// do_scaled_8tap_c alone (the tests hold it to a numpy version): filter
// 0-3 in libvpx's numbering (regular, smooth, sharp, bilinear)
void vp9_scaled_8tap(const uint8_t* ref, int64_t rs, int64_t pw, int64_t ph, int64_t x, int64_t y,
                     int64_t fx, int64_t fy, int64_t dx, int64_t dy, int64_t bw, int64_t bh,
                     int64_t filter, uint8_t* dst, int64_t ds, int64_t avg) {
    scaled_8tap(ref, (int)rs, (int)pw, (int)ph, (int)x, (int)y, (int)fx, (int)fy, (int)dx, (int)dy,
                (int)bw, (int)bh, kFilters[filter], dst, (int)ds, avg != 0);
}

void* vp9_dec_new() { return new Decoder(); }

void vp9_dec_free(void* h) { delete (Decoder*)h; }

// one packet: OK with info = {pictures, color_space, color_range, (width,
// height) of each picture (up to 8)}, or an error code with msg
int vp9_dec_decode(void* h, const uint8_t* data, int64_t size, int64_t* info, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        d->decode_packet(data, (size_t)size);
        const size_t n = std::min(d->out.size(), (size_t)8);
        info[0] = (int64_t)n;
        info[1] = d->color_space;
        info[2] = d->color_range;
        for (size_t i = 0; i < n; i++) {
            info[3 + 2 * i] = d->out[i]->w;
            info[4 + 2 * i] = d->out[i]->h;
        }
        return n ? OK : NO_FRAME;
    } catch (const Error& e) {
        return fail(e, msg, cap);
    } catch (const std::exception& e) {
        return fail(Error(CORRUPT, e.what()), msg, cap);
    }
}

// picture i of the last packet as yuv420p planes
void vp9_dec_output(void* h, int64_t i, uint8_t* y, uint8_t* u, uint8_t* v) {
    Frame& f = *((Decoder*)h)->out[(size_t)i];
    uint8_t* dst[3] = {y, u, v};
    for (int k = 0; k < 3; k++)
        for (int r = 0; r < f.ph(k); r++) memcpy(dst[k] + (size_t)r * f.pw(k), f.at(k, 0, r), f.pw(k));
}

int64_t vp9_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
