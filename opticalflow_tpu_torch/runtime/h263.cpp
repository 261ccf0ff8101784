// H.263 video (ITU-T H.263, baseline and H.263+ with PLUSPTYPE), decoded
// in host C++ as FFmpeg 8's h263 decoder (ituh263dec.c, h263dec.c, h263.c)
// decodes it for cv2.VideoCapture, bit for bit:
//
//   * the picture header: PSC, TR, PTYPE with the five source formats
//     (sub-QCIF 128x96, QCIF 176x144, CIF 352x288, 4CIF 704x576, 16CIF
//     1408x1152), I- and P-pictures, PQUANT, the CPM bit (FFmpeg reads no
//     PSBI after it) and PEI/PSUPP;
//   * PLUSPTYPE (H.263+): UFEP and the optional part (OPPTYPE), kept from
//     picture to picture where UFEP is 0; the custom picture format
//     (CPFMT: any size in steps of 4, the pixel aspect code and extended
//     PAR) and the custom picture clock (CPCFC); the mandatory part
//     (MPPTYPE) with the rounding type, which P-pictures alternate;
//   * GOB headers (GBSC, GN, GFID, GQUANT), found as ff_h263_resync finds
//     them: a macroblock followed by 16 zero bits ends a slice; each GOB
//     starts a new one for motion-vector prediction;
//   * the macroblock layer: COD, MCBPC, CBPY, DQUANT, an 8-bit INTRADC with
//     no DC/AC prediction, TCOEF with H.263's escape (LAST, RUN 6, LEVEL 8,
//     and FFmpeg's 11-bit level after -128), MVD with ff_h263_pred_motion
//     (no MPEG-4 above-right rule at a slice's first line);
//   * H.263 dequantisation applied at reconstruction (int16 wrap, as FFmpeg
//     stores it), the simple IDCT (ffmpeg_dsp.h) and half-pel motion
//     compensation over edge-clamped references (macroblock-aligned edges)
//     with the picture's rounding, 16x16 or 8x8 vectors with H.263's
//     chroma vector (mpeg_common.h);
//   * Annex D inside PLUSPTYPE: unrestricted vectors through the reversible
//     code (h263p_decode_umotion) and its stuffing bit;
//   * Annex F, advanced prediction: 8x8 vectors and overlapped block motion
//     compensation (apply_obmc, put_obmc), the right neighbour's vectors
//     previewed from the bitstream as FFmpeg's preview_obmc reads them
//     (before the current macroblock's own 16x16 vector is stored);
//   * Annex I, advanced intra coding: INTRA_MODE, the intra TCOEF table,
//     the alternate scans, ff_h263_pred_acdc's DC/AC prediction (DC
//     clipped to 0 and made odd) and dequantisation without INTRADC;
//   * Annex J, the deblocking filter (ff_h263_loop_filter), applied to each
//     macroblock after its reconstruction in FFmpeg's order;
//   * Annex K, slice-structured mode: the first slice's MBA in the picture
//     header, SSC headers with MBA and SQUANT at each resync;
//   * Annex S, the alternative inter VLC: CBPY as coded for full inter
//     macroblocks, and an inter block that overruns 64 coefficients read
//     again with the intra table;
//   * Annex T, modified quantisation: DQUANT through FFmpeg's table or a
//     5-bit value, the chroma QP table, the extended coefficient range.
//
// Sorenson H.263 (FLV1: Flash video and what FFmpeg's flv encoder writes)
// is read as FFmpeg's flvdec.c and its h263_flv branches read it: the
// 17-bit start code with a 5-bit version (0: H.263's escape; 1: a bit that
// selects a 7- or 11-bit level), an 8-bit TR, the 3-bit size code with
// 8- or 16-bit custom sizes, the picture type (I, P, disposable P), the
// ignored deblocking flag, a 5-bit quantiser, PEI, and no GOB headers.  A
// disposable picture is shown and not kept as a reference; FFmpeg skips one
// while it holds no last picture (right after a stream's first key frame),
// and so does the port; after OpenCV's seek it holds the pictures of the
// capture's first read, and skips none (h263_dec_after_seek).
//
// Syntax-based arithmetic coding (Annex E), PB-frames (Annexes G and M),
// B- and EI/EP-pictures (Annex O), reference picture selection (Annex N),
// reference picture resampling (Annex P), reduced-resolution update
// (Annex Q), independent segments (Annex R), rectangular or unordered
// slices and unrestricted vectors outside PLUSPTYPE raise H263_UNSUPPORTED
// with a message naming the feature.
//
// Built by runtime/_native.py with g++ at first use; called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "ffmpeg_dsp.h"
#include "mpeg_common.h"

namespace {

using namespace mpegc;
using ffdsp::idct;

enum { H263_OK = kOk, H263_NO_FRAME = kNoFrame, H263_UNSUPPORTED = kUnsupported,
       H263_CORRUPT = kCorrupt };

// what a stream reached (h263.py's FEATURES, in order)
enum Feature {
    F_SUB_QCIF, F_QCIF, F_CIF, F_4CIF, F_16CIF, F_P_PICTURES, F_SKIPPED_MB, F_INTRA_IN_P,
    F_DQUANT, F_MV4, F_ADVANCED_PREDICTION, F_GOB_HEADERS, F_ESCAPE, F_ESCAPE_EXTENDED,
    F_PEI, F_SIZE_CHANGE, F_MCBPC_STUFFING, F_DC_128,
    F_PLUSPTYPE, F_CUSTOM_FORMAT, F_EXTENDED_PAR, F_CUSTOM_CLOCK, F_ROUNDING, F_UFEP_0,
    F_UMV, F_UMV_LONG, F_UMV_STUFFING, F_AIC, F_AIC_VERTICAL, F_AIC_HORIZONTAL,
    F_LOOP_FILTER, F_SLICES, F_ALT_INTER_VLC, F_ALT_INTER_RETRY, F_MODIFIED_QUANT,
    F_DQUANT_ESCAPE,
    // Sorenson H.263
    F_FLV_VERSION_0, F_FLV_VERSION_1, F_FLV_CUSTOM_SIZE, F_FLV_DISPOSABLE, F_FLV_DROPPED,
    F_FLV_ESCAPE_11,
};

// ff_h263_format: the source formats' sizes (0 forbidden, 6 and 7 are
// PLUSPTYPE's)
const int kFormats[6][2] = {{0, 0}, {128, 96}, {176, 144}, {352, 288}, {704, 576}, {1408, 1152}};

// Annex I's intra TCOEF codes (intra_vlc_aic): the inter table's codewords
// assigned to other (LAST, RUN, LEVEL) triples, in that order, then the
// escape; the largest level of each run (ff_rl_intra_aic)
const Code kAicTcoef[103] = {
    {0x2, 2}, {0x6, 3}, {0xe, 4}, {0xc, 5}, {0xd, 5}, {0x10, 6}, {0x11, 6}, {0x12, 6},
    {0x16, 7}, {0x1b, 8}, {0x20, 9}, {0x21, 9}, {0x1a, 9}, {0x1b, 9}, {0x1c, 9}, {0x1d, 9},
    {0x1e, 9}, {0x1f, 9}, {0x23, 11}, {0x22, 11}, {0x57, 12}, {0x56, 12}, {0x55, 12},
    {0x54, 12}, {0x53, 12}, {0xf, 4}, {0x14, 6}, {0x14, 7}, {0x1e, 8}, {0xf, 10}, {0x21, 11},
    {0x50, 12}, {0xb, 5}, {0x15, 7}, {0xe, 10}, {0x9, 10}, {0x15, 6}, {0x1d, 8}, {0xd, 10},
    {0x51, 12}, {0x13, 6}, {0x23, 9}, {0x7, 11}, {0x17, 7}, {0x22, 9}, {0x52, 12}, {0x1c, 8},
    {0xc, 10}, {0x1f, 8}, {0xb, 10}, {0x25, 9}, {0xa, 10}, {0x24, 9}, {0x6, 11}, {0x21, 10},
    {0x20, 10}, {0x8, 10}, {0x20, 11}, {0x7, 4}, {0xc, 6}, {0x10, 7}, {0x13, 8}, {0x11, 9},
    {0x12, 9}, {0x4, 10}, {0x27, 11}, {0x26, 11}, {0x5f, 12}, {0xf, 6}, {0x13, 9}, {0x5, 10},
    {0x25, 11}, {0xe, 6}, {0x14, 9}, {0x24, 11}, {0xd, 6}, {0x6, 10}, {0x5e, 12}, {0x11, 7},
    {0x7, 10}, {0x13, 7}, {0x5d, 12}, {0x12, 7}, {0x5c, 12}, {0x14, 8}, {0x5b, 12}, {0x15, 8},
    {0x1a, 8}, {0x19, 8}, {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x19, 9}, {0x15, 9}, {0x16, 9},
    {0x18, 9}, {0x17, 9}, {0x4, 11}, {0x5, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x3, 7}};
const int kAicMaxLevel0[] = {25, 7, 4, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1};
const int kAicMaxLevel1[] = {10, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,
                             1,  1, 1, 1, 1, 1, 1, 1};

// Annex T: DQUANT's two codes by the prior QUANT (ff_modified_quant_tab),
// and the chroma QUANT by the luma one (ff_h263_chroma_qscale_table)
const uint8_t kModifiedQuant[2][32] = {
    {0, 3, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 10, 11, 12, 13,
     14, 15, 16, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28},
    {0, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17,
     18, 19, 20, 21, 22, 24, 25, 26, 27, 28, 29, 30, 31, 31, 31, 26}};
const uint8_t kChromaQ[32] = {0,  1,  2,  3,  4,  5,  6,  6,  7,  8,  9,  9,  10, 10, 11, 11,
                              12, 12, 12, 13, 13, 13, 14, 14, 14, 14, 14, 15, 15, 15, 15, 15};

// Annex J: the filter's strength by QUANT (ff_h263_loop_filter_strength)
const uint8_t kLoopStrength[32] = {0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 7,
                                   7, 8, 8, 8, 9, 9, 9, 10, 10, 10, 11, 11, 11, 12, 12, 12};

// Annex K: MBA's length by the picture's macroblock count (ff_mba_max,
// ff_mba_length)
const int kMbaMax[6] = {47, 98, 395, 1583, 6335, 9215};
const int kMbaLength[7] = {6, 7, 9, 11, 13, 14, 14};

struct Tables {
    Vlc intra_mcbpc, inter_mcbpc, cbpy, mvd;
    RunLevel tcoef, aic;
    Tables() {
        intra_mcbpc.build(kIntraMcbpc, 9, 9);
        inter_mcbpc.build(kInterMcbpc, 28, 13);
        cbpy.build(kCbpy, 16, 6);
        mvd.build(kMvd, 33, 12);
        tcoef.build(kInterTcoef, kInterMaxLevel0, 27, kInterMaxLevel1, 41);
        aic.build(kAicTcoef, kAicMaxLevel0, 14, kAicMaxLevel1, 24);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// Annex F's weights of the current block's own prediction, and of the
// above/below and left/right neighbours' (each used on its half)
const uint8_t kObmcMid[8][8] = {{4, 5, 5, 5, 5, 5, 5, 4}, {5, 5, 5, 5, 5, 5, 5, 5},
                                {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
                                {5, 5, 6, 6, 6, 6, 5, 5}, {5, 5, 6, 6, 6, 6, 5, 5},
                                {5, 5, 5, 5, 5, 5, 5, 5}, {4, 5, 5, 5, 5, 5, 5, 4}};
const uint8_t kObmcTopBottom[8][8] = {{2, 2, 2, 2, 2, 2, 2, 2}, {1, 1, 2, 2, 2, 2, 1, 1},
                                      {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
                                      {1, 1, 1, 1, 1, 1, 1, 1}, {1, 1, 1, 1, 1, 1, 1, 1},
                                      {1, 1, 2, 2, 2, 2, 1, 1}, {2, 2, 2, 2, 2, 2, 2, 2}};
const uint8_t kObmcLeftRight[8][8] = {{2, 1, 1, 1, 1, 1, 1, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
                                      {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
                                      {2, 2, 1, 1, 1, 1, 2, 2}, {2, 2, 1, 1, 1, 1, 2, 2},
                                      {2, 2, 1, 1, 1, 1, 2, 2}, {2, 1, 1, 1, 1, 1, 1, 2}};

// h263_{h,v}_loop_filter_c: one 8-sample edge between p1 and p2 (p0 p1 |
// p2 p3 across it); ``step`` walks along the edge, ``across`` over it
inline void loop_filter_edge(uint8_t* src, int step, int across, int q) {
    const int strength = kLoopStrength[q];
    for (int k = 0; k < 8; k++, src += step) {
        const int p0 = src[-2 * across], p3 = src[across];
        int p1 = src[-across], p2 = src[0];
        const int d = (p0 - p3 + 4 * (p2 - p1)) / 8;
        int d1;
        if (d < -2 * strength) d1 = 0;
        else if (d < -strength) d1 = -2 * strength - d;
        else if (d < strength) d1 = d;
        else if (d < 2 * strength) d1 = 2 * strength - d;
        else d1 = 0;
        p1 += d1;
        p2 -= d1;
        if (p1 & 256) p1 = ~(p1 >> 31);
        if (p2 & 256) p2 = ~(p2 >> 31);
        src[-across] = (uint8_t)p1;
        src[0] = (uint8_t)p2;
        const int ad1 = std::abs(d1) >> 1;
        const int d2 = std::min(std::max((p0 - p3) / 4, -ad1), ad1);
        src[-2 * across] = (uint8_t)(p0 - d2);
        src[across] = (uint8_t)(p3 + d2);
    }
}

struct MbData {
    bool intra = false, skip = false, mv4 = false, ac_pred = false;
    int aic_dir = 0;
    int q = 1, cq = 1;
    int mv[4][2] = {};
    int16_t blk[6][64];
    int last[6];
};

enum { SLICE_OK, SLICE_END };

class Decoder {
  public:
    int width = 0, height = 0, mb_w = 0, mb_h = 0, gob_height = 1;
    Picture cur, ref;
    bool have_ref = false;
    MvPred mvp;
    std::vector<uint8_t> intra_mb;   // the picture's intra macroblocks (mb_type)
    std::vector<uint8_t> skip_mb;    // its skipped ones (the loop filter's IS_SKIP)
    std::vector<uint8_t> mb_q;       // their QUANT (qscale_table)
    // Annex I's predictors, kept across pictures: the DC (1024: none) and
    // the first row and column of each luma block's and each macroblock's
    // chroma blocks' levels, with a border row and column
    std::vector<int16_t> dc_val[3], ac_val[3];
    int dc_wrap[3] = {};
    BitReader br;
    int qscale = 1, chroma_q = 1;
    bool inter = false, obmc = false;
    // PLUSPTYPE's optional modes (kept where UFEP is 0), the rounding type
    bool plus = false, plus_seen = false, custom_pcf = false, umv = false, aic = false,
         loop = false, slices = false, alt_vlc = false, modified_quant = false,
         chroma_table = false, no_rnd = false;
    int plus_format = 0;
    int mb_x = 0, mb_y = 0;
    int64_t last_resync = 0;
    int64_t features = 0;
    // Sorenson: the stream's (set by the caller), the picture's version
    // (FFmpeg's h263_flv - 1) and disposable flag, the reference pictures
    // decoded (FFmpeg's last_pic is set from the second on), and whether
    // the picture shown is ``cur`` (a disposable one) or ``ref``
    bool flv = false, droppable = false, show_cur = false;
    int flv_version = 0, refs = 0;

    void feature(int f) { features |= (int64_t)1 << f; }

    // one packet: its picture (H263_OK, planes in ``ref``)
    int decode(const uint8_t* d, int64_t n) {
        br.reset(d, n);
        droppable = false;
        if (flv) flv_picture_header();
        else picture_header();
        if (droppable && refs < 2) {   // FFmpeg holds no last_pic yet: skipped
            feature(F_FLV_DROPPED);
            return H263_NO_FRAME;
        }
        if (inter && !have_ref) CORRUPT("a P-picture without a reference picture");
        mvp.init_mv(mb_w, mb_h);   // FFmpeg zeroes motion_val every picture
        intra_mb.assign((size_t)mb_w * mb_h, 0);
        skip_mb.assign((size_t)mb_w * mb_h, 0);
        mb_q.assign((size_t)mb_w * mb_h, 0);
        mb_x = mb_y = 0;
        slice();
        while (mb_y < mb_h) {
            const int prev = mb_y * mb_w + mb_x;
            if (!resync()) CORRUPT("macroblocks %d on are missing (FFmpeg conceals them)", prev);
            if (prev < mb_y * mb_w + mb_x)
                CORRUPT("a GOB or slice header skips macroblocks %d-%d (FFmpeg conceals them)", prev,
                        mb_y * mb_w + mb_x - 1);
            slice();
        }
        show_cur = droppable;
        if (!droppable) {
            std::swap(cur, ref);
            have_ref = true;
            refs++;
        }
        return H263_OK;
    }

    // ff_flv_decode_picture_header
    void flv_picture_header() {
        if (br.get(17) != 1) CORRUPT("bad Sorenson picture start code");
        const int version = (int)br.get(5);
        if (version > 1) CORRUPT("bad Sorenson version %d", version);
        flv_version = version;
        feature(version ? F_FLV_VERSION_1 : F_FLV_VERSION_0);
        br.skip(8);   // TR
        int w = 0, h = 0;
        switch (br.get(3)) {
            case 0: w = (int)br.get(8); h = (int)br.get(8); feature(F_FLV_CUSTOM_SIZE); break;
            case 1: w = (int)br.get(16); h = (int)br.get(16); feature(F_FLV_CUSTOM_SIZE); break;
            case 2: w = 352; h = 288; break;
            case 3: w = 176; h = 144; break;
            case 4: w = 128; h = 96; break;
            case 5: w = 320; h = 240; break;
            case 6: w = 160; h = 120; break;
            default: break;
        }
        if (w <= 0 || h <= 0) CORRUPT("a Sorenson picture of size %dx%d", w, h);
        const int type = (int)br.get(2);
        inter = type != 0;
        droppable = type > 1;
        if (droppable) feature(F_FLV_DISPOSABLE);
        br.skip(1);   // deblocking flag: FFmpeg reads no more of it
        qscale = (int)br.get(5);
        plus = umv = aic = loop = slices = alt_vlc = modified_quant = chroma_table = false;
        obmc = no_rnd = false;
        while (br.get1()) {   // PEI, PSUPP
            feature(F_PEI);
            br.skip(8);
            if (br.left() <= 0) CORRUPT("truncated PSUPP");
        }
        set_size(w, h);
        br.check();
        if (inter) feature(F_P_PICTURES);
    }

    // ff_h263_decode_picture_header
    void picture_header() {
        uint32_t sc = br.get(14);
        for (int64_t i = br.left(); i > 24; i -= 8) {
            sc = ((sc << 8) | br.get(8)) & 0x3FFFFF;
            if (sc == 0x20) break;
        }
        if (sc != 0x20) CORRUPT("no picture start code");
        br.skip(8);   // TR
        if (!br.get1()) CORRUPT("PTYPE's marker bit is 0");
        if (br.get1()) CORRUPT("bad H.263 id bit");
        br.skip(3);   // split screen, document camera, freeze picture release
        const int format = (int)br.get(3);
        int w = width, h = height;
        if (format != 7 && format != 6) {
            plus = false;
            if (!format) CORRUPT("forbidden source format 0");
            w = kFormats[format][0];
            h = kFormats[format][1];
            feature(F_SUB_QCIF + format - 1);
            inter = br.get1();
            if (br.get1()) UNSUPPORTED("unrestricted motion vectors (H.263 Annex D) outside PLUSPTYPE");
            if (br.get1()) UNSUPPORTED("syntax-based arithmetic coding (H.263 Annex E)");
            obmc = br.get1();
            if (br.get1()) UNSUPPORTED("PB-frames (H.263 Annex G)");
            qscale = (int)br.get(5);
            br.skip(1);   // CPM
        } else {
            plus = true;
            feature(F_PLUSPTYPE);
            const int ufep = (int)br.get(3);
            if (ufep == 1) {   // OPPTYPE
                plus_format = (int)br.get(3);
                custom_pcf = br.get1();
                umv = br.get1();
                if (br.get1()) UNSUPPORTED("syntax-based arithmetic coding (H.263 Annex E)");
                obmc = br.get1();
                aic = br.get1();
                loop = br.get1();
                slices = br.get1();
                if (br.get1()) UNSUPPORTED("reference picture selection (H.263 Annex N)");
                if (br.get1()) UNSUPPORTED("independent segment decoding (H.263 Annex R)");
                alt_vlc = br.get1();
                modified_quant = br.get1();
                if (modified_quant) chroma_table = true;
                br.skip(4);   // start code emulation bit, reserved
                plus_seen = true;
            } else if (ufep != 0) {
                CORRUPT("bad UFEP %d", ufep);
            } else {
                feature(F_UFEP_0);
                if (!plus_seen) CORRUPT("a PLUSPTYPE header without UFEP before any with it");
            }
            switch (br.get(3)) {   // MPPTYPE
                case 0: inter = false; break;
                case 1: inter = true; break;
                case 2: UNSUPPORTED("improved PB-frames (H.263 Annex M)");
                case 3: UNSUPPORTED("B-pictures (H.263 Annex O)");
                case 7: UNSUPPORTED("ZyGo's intra pictures (picture type 7)");
                default: CORRUPT("reserved H.263+ picture type");
            }
            if (br.get1()) UNSUPPORTED("reference picture resampling (H.263 Annex P)");
            if (br.get1()) UNSUPPORTED("reduced-resolution update (H.263 Annex Q)");
            no_rnd = br.get1();
            if (no_rnd) feature(F_ROUNDING);
            br.skip(4);   // reserved, start code emulation bit, CPM
            if (ufep) {
                if (plus_format == 6) {   // CPFMT
                    feature(F_CUSTOM_FORMAT);
                    const int par = (int)br.get(4);
                    w = ((int)br.get(9) + 1) * 4;
                    br.skip(1);   // FFmpeg only logs a bad marker here
                    h = (int)br.get(9) * 4;
                    if (par == 15) {   // extended PAR
                        feature(F_EXTENDED_PAR);
                        br.skip(16);
                    }
                } else {
                    if (plus_format == 0 || plus_format == 7) CORRUPT("forbidden source format %d", plus_format);
                    w = kFormats[plus_format][0];
                    h = kFormats[plus_format][1];
                    feature(F_SUB_QCIF + plus_format - 1);
                }
                if (!w || !h) CORRUPT("a picture of size %dx%d", w, h);
                if (custom_pcf) {   // CPCFC: clock conversion code, divisor
                    feature(F_CUSTOM_CLOCK);
                    br.skip(1);
                    if (!br.get(7)) CORRUPT("zero custom picture clock divisor");
                }
            }
            if (custom_pcf) br.skip(2);   // ETR
            if (ufep) {
                if (umv && !br.get1()) br.skip(1);   // UUI
                if (slices) {
                    if (br.get1()) UNSUPPORTED("rectangular slices (H.263 Annex K submode)");
                    if (br.get1()) UNSUPPORTED("arbitrary slice ordering (H.263 Annex K submode)");
                }
            }
            qscale = (int)br.get(5);
        }
        if ((int64_t)w * h / 256 / 8 > br.left())
            CORRUPT("a %dx%d picture in %lld bits (FFmpeg drops it)", w, h, (long long)br.left());
        if (br.left() <= 0) CORRUPT("truncated picture header");
        while (br.get1()) {   // PEI, PSUPP
            feature(F_PEI);
            br.skip(8);
            if (br.left() <= 0) CORRUPT("truncated PSUPP");
        }
        set_size(w, h);
        if (plus && slices) {   // the first slice's SEPB1, MBA, SEPB2
            if (!br.get1()) CORRUPT("SEPB1 is 0");
            br.skip(mba_length());
            if (!br.get1()) CORRUPT("SEPB2 is 0");
        }
        br.check();
        if (inter) feature(F_P_PICTURES);
        if (obmc) feature(F_ADVANCED_PREDICTION);
        if (umv) feature(F_UMV);
        if (aic) feature(F_AIC);
        if (loop) feature(F_LOOP_FILTER);
        if (slices) feature(F_SLICES);
        if (alt_vlc) feature(F_ALT_INTER_VLC);
        if (modified_quant) feature(F_MODIFIED_QUANT);
    }

    int mba_length() const {
        int i = 0;
        while (i < 6 && mb_w * mb_h - 1 > kMbaMax[i]) i++;
        return kMbaLength[i];
    }

    void set_size(int w, int h) {
        if (w == width && h == height) return;
        if (width) {
            feature(F_SIZE_CHANGE);
            refs = 0;   // FFmpeg drops its pictures at a new size
        }
        width = w;
        height = h;
        mb_w = (w + 15) / 16;
        mb_h = (h + 15) / 16;
        gob_height = h <= 400 ? 1 : h <= 800 ? 2 : 4;
        cur.alloc(mb_w, mb_h);
        ref.alloc(mb_w, mb_h);
        have_ref = false;
        dc_wrap[0] = 2 * mb_w + 1;
        dc_wrap[1] = dc_wrap[2] = mb_w + 1;
        for (int c = 0; c < 3; c++) {
            const size_t n = (size_t)dc_wrap[c] * ((c ? mb_h : 2 * mb_h) + 1);
            dc_val[c].assign(n, 1024);
            ac_val[c].assign(n * 16, 0);
        }
    }

    // h263_decode_gob_header at the reader's position (a slice header in
    // slice-structured mode)
    bool gob_header() {
        if (br.show(16)) return false;
        br.skip(16);
        int64_t left = std::min<int64_t>(br.left(), 32);
        for (; left > 13; left--)
            if (br.get1()) break;
        if (left <= 13) return false;
        if (plus && slices) {
            if (!br.get1()) return false;
            const int mba = (int)br.get(mba_length());
            mb_x = mba % mb_w;
            mb_y = mba / mb_w;
            if (mb_w * mb_h > 1583 && !br.get1()) return false;
            qscale = (int)br.get(5);   // SQUANT
            if (!br.get1()) return false;
            br.skip(2);   // GFID
        } else {
            const int gn = (int)br.get(5);
            mb_x = 0;
            mb_y = gob_height * gn;
            br.skip(2);   // GFID
            qscale = (int)br.get(5);
        }
        if (mb_y >= mb_h || !qscale) return false;
        feature(F_GOB_HEADERS);
        return true;
    }

    // ff_h263_resync: a GOB header where the slice ended, else the first
    // one found byte by byte from where the slice started
    bool resync() {
        if (br.show(16) == 0 && gob_header()) return true;
        br.pos = last_resync;
        br.align();
        for (int64_t left = br.left(); left > 16 + 1 + 5 + 5; left -= 8) {
            if (br.show(16) == 0) {
                const int64_t bak = br.pos;
                if (gob_header()) return true;
                br.pos = bak;
            }
            br.skip(8);
        }
        return false;
    }

    // ff_set_qscale
    void set_q(int q) {
        qscale = std::min(std::max(q, 1), 31);
        chroma_q = chroma_table ? kChromaQ[qscale] : qscale;
    }

    // h263_decode_dquant
    void dquant() {
        feature(F_DQUANT);
        if (modified_quant) {
            if (br.get1()) {
                set_q(kModifiedQuant[br.get1()][qscale]);
            } else {
                feature(F_DQUANT_ESCAPE);
                set_q((int)br.get(5));
            }
        } else {
            set_q(qscale + kDquant[br.get(2)]);
        }
    }

    // decode_slice
    void slice() {
        last_resync = br.pos;
        mvp.first_line = true;
        mvp.resync_x = mb_x;
        mvp.resync_y = mb_y;
        set_q(qscale);
        MbData mb;
        for (; mb_y < mb_h; mb_y++) {
            for (; mb_x < mb_w; mb_x++) {
                if (mvp.resync_x == mb_x && mvp.resync_y + 1 == mb_y) mvp.first_line = false;
                const int ret = decode_mb(mb);
                if (!mb.mv4) {   // ff_h263_update_motion_val
                    const bool moved = !mb.intra && !mb.skip;
                    mvp.set_mv16(mb_x, mb_y, moved ? mb.mv[0][0] : 0, moved ? mb.mv[0][1] : 0);
                }
                reconstruct(mb);
                if (loop) loop_filter();
                if (ret == SLICE_END) {
                    if (++mb_x >= mb_w) {
                        mb_x = 0;
                        mb_y++;
                    }
                    return;
                }
            }
            mb_x = 0;
        }
    }

    // one vector component: Annex D's reversible code in PLUSPTYPE
    // (h263p_decode_umotion, no wrap), else ff_h263_decode_motion
    int motion(int pred) {
        if (!umv) return read_motion(br, tables().mvd, pred, 1);
        if (br.get1()) return pred;
        int code = 2 + br.get1();
        while (br.get1()) {
            code = (code << 1) + br.get1();
            if (code >= 32768) CORRUPT("a huge motion vector difference");
        }
        const int v = code & 1 ? pred - (code >> 1) : pred + (code >> 1);
        if (v < -32 || v > 31) feature(F_UMV_LONG);
        return v;
    }

    // a vector pair; Annex D's stuffing bit after a (1, 1) difference
    void vector(int px, int py, int* mx, int* my) {
        *mx = motion(px);
        *my = motion(py);
        if (umv && *mx - px == 1 && *my - py == 1) {
            feature(F_UMV_STUFFING);
            br.skip(1);
        }
    }

    // ff_h263_decode_mb
    int decode_mb(MbData& mb) {
        const Tables& t = tables();
        const int xy = mb_y * mb_w + mb_x;
        mb.intra = mb.skip = mb.mv4 = mb.ac_pred = false;
        mb.aic_dir = 0;
        int cbpc;
        if (inter) {
            while (true) {
                if (br.get1()) {   // COD: skipped
                    feature(F_SKIPPED_MB);
                    mb.skip = true;
                    mb.q = qscale;
                    mb.cq = chroma_q;
                    mb.mv[0][0] = mb.mv[0][1] = 0;
                    for (int n = 0; n < 6; n++) mb.last[n] = -1;
                    intra_mb[xy] = 0;
                    skip_mb[xy] = 1;
                    return mb_end();
                }
                cbpc = br.vlc(t.inter_mcbpc);
                if (cbpc != 20) break;
                feature(F_MCBPC_STUFFING);
            }
            mb.intra = (cbpc & 4) != 0;
            if (mb.intra) feature(F_INTRA_IN_P);
        } else {
            while ((cbpc = br.vlc(t.intra_mcbpc)) == 8) feature(F_MCBPC_STUFFING);
            mb.intra = true;
        }
        skip_mb[xy] = 0;
        const bool dq = mb.intra && !inter ? (cbpc & 4) != 0 : (cbpc & 8) != 0;
        if (mb.intra && aic) {   // INTRA_MODE
            mb.ac_pred = br.get1();
            if (mb.ac_pred) {
                mb.aic_dir = br.get1();
                feature(mb.aic_dir ? F_AIC_HORIZONTAL : F_AIC_VERTICAL);
            }
        }
        int cbpy = br.vlc(t.cbpy);
        if (!mb.intra && (!alt_vlc || (cbpc & 3) != 3)) cbpy ^= 0xF;
        int cbp = (cbpc & 3) | (cbpy << 2);
        if (dq) dquant();
        mb.q = qscale;
        mb.cq = chroma_q;
        intra_mb[xy] = mb.intra;
        if (!mb.intra) {
            if (!(cbpc & 16)) {
                int px, py;
                mvp.pred_mv(0, mb_x, mb_y, &px, &py, false);
                vector(px, py, &mb.mv[0][0], &mb.mv[0][1]);
            } else {
                feature(F_MV4);
                mb.mv4 = true;
                for (int n = 0; n < 4; n++) {
                    int px, py;
                    mvp.pred_mv(n, mb_x, mb_y, &px, &py, false);
                    vector(px, py, &mb.mv[n][0], &mb.mv[n][1]);
                    int16_t* m = mvp.mv_at(n, mb_x, mb_y);
                    m[0] = (int16_t)mb.mv[n][0];
                    m[1] = (int16_t)mb.mv[n][1];
                }
            }
        }
        for (int n = 0; n < 6; n++, cbp += cbp) decode_block(mb, n, (cbp & 32) != 0);
        if (obmc && !mb.intra && inter && mb_x + 1 < mb_w) preview_obmc();
        return mb_end();
    }

    // the per-macroblock end-of-slice check: 16 zero bits (or the end)
    int mb_end() {
        if (br.left() < 0) CORRUPT("bitstream overread (truncated picture)");
        uint32_t v = br.show(16);
        if (br.left() < 16) v >>= 16 - br.left();
        return v == 0 ? SLICE_END : SLICE_OK;
    }

    // h263_decode_block: levels in raster order, not yet dequantised; an
    // Annex I intra block's DC and first row or column predicted
    void decode_block(MbData& mb, int n, bool coded) {
        const Tables& t = tables();
        const RunLevel* rl = &t.tcoef;
        const uint8_t* scan = kZigzag;
        int16_t* blk = mb.blk[n];
        memset(blk, 0, 64 * sizeof(int16_t));
        const bool aic_intra = aic && mb.intra;
        int i = 0;
        if (aic_intra) {
            rl = &t.aic;
            if (mb.ac_pred) scan = mb.aic_dir ? kAltVertical : kAltHorizontal;
        } else if (mb.intra) {
            int level = (int)br.get(8);
            if (level == 255) {
                level = 128;
                feature(F_DC_128);
            }
            blk[0] = (int16_t)level;
            i = 1;
        }
        if (!coded) {
            if (aic_intra) {
                pred_acdc(mb, n);
                mb.last[n] = 63;
            } else {
                mb.last[n] = i - 1;
            }
            return;
        }
        const int64_t start = br.pos;
        i--;
        while (true) {
            const int idx = br.vlc(rl->vlc);
            int run, level;
            if (idx == 102 && flv && flv_version == 1) {   // IS11, LAST, RUN, LEVEL
                feature(F_ESCAPE);
                const int is11 = br.get1();
                if (is11) feature(F_FLV_ESCAPE_11);
                run = (int)br.get(7) + 1;
                const int nbits = is11 ? 11 : 7;
                const int v = (int)br.get(nbits);
                level = v >= 1 << (nbits - 1) ? v - (1 << nbits) : v;
            } else if (idx == 102) {   // escape: LAST, RUN, LEVEL
                feature(F_ESCAPE);
                run = (int)br.get(7) + 1;   // LAST lands at bit 6: run + 64
                level = (int8_t)br.get(8);
                if (level == -128) {
                    feature(F_ESCAPE_EXTENDED);
                    const int lo = (int)br.get(5);
                    const int hi = (int)br.get(6);
                    level = lo | ((hi >= 32 ? hi - 64 : hi) * 32);
                }
            } else {
                run = rl->run[idx] + 1 + (rl->last[idx] ? 192 : 0);
                level = br.get1() ? -rl->level[idx] : rl->level[idx];
            }
            i += run;
            if (i >= 64) {   // the last coefficient, or a run past the block
                i = i - run + ((run - 1) & 63) + 1;
                if (i < 64) {
                    blk[scan[i]] = (int16_t)level;
                    break;
                }
                if (alt_vlc && rl == &t.tcoef && !mb.intra) {   // Annex S: the intra table
                    feature(F_ALT_INTER_RETRY);
                    rl = &t.aic;
                    i = -1;
                    br.pos = start;
                    memset(blk, 0, 64 * sizeof(int16_t));
                    continue;
                }
                CORRUPT("TCOEF run past the block's end at macroblock (%d, %d)", mb_x, mb_y);
            }
            blk[scan[i]] = (int16_t)level;
        }
        if (aic_intra) {
            pred_acdc(mb, n);
            i = 63;
        }
        mb.last[n] = i;
    }

    // ff_h263_pred_acdc: block n's DC (dequantised, clipped to 0 and made
    // odd) and, with AC prediction, its first column (from the left) or
    // row (from above), in levels; the block's own stored for the next
    void pred_acdc(MbData& mb, int n) {
        int16_t* blk = mb.blk[n];
        int x, y, c, scale;
        if (n < 4) {
            x = 2 * mb_x + (n & 1);
            y = 2 * mb_y + (n >> 1);
            c = 0;
            scale = 2 * mb.q;
        } else {
            x = mb_x;
            y = mb_y;
            c = n - 3;
            scale = 2 * mb.cq;
        }
        const int wrap = dc_wrap[c];
        const size_t at = (size_t)(y + 1) * wrap + x + 1;
        int16_t* dc = &dc_val[c][at];
        int16_t* ac = &ac_val[c][at * 16];
        int a = dc[-1], above = dc[-wrap];
        if (mvp.first_line && n != 3) {   // no prediction from another slice
            if (n != 2) above = 1024;
            if (n != 1 && mb_x == mvp.resync_x) a = 1024;
        }
        int pred;
        if (mb.ac_pred) {
            pred = 1024;
            if (mb.aic_dir) {
                if (a != 1024) {
                    const int16_t* l = ac - 16;
                    for (int i = 1; i < 8; i++) blk[i * 8] = (int16_t)(blk[i * 8] + l[i]);
                    pred = a;
                }
            } else if (above != 1024) {
                const int16_t* tp = ac - 16 * (size_t)wrap;
                for (int i = 1; i < 8; i++) blk[i] = (int16_t)(blk[i] + tp[i + 8]);
                pred = above;
            }
        } else if (a != 1024 && above != 1024) {
            pred = (a + above) >> 1;
        } else {
            pred = a != 1024 ? a : above;
        }
        blk[0] = (int16_t)(blk[0] * scale + pred);
        if (blk[0] < 0) blk[0] = 0;
        else blk[0] |= 1;
        dc[0] = blk[0];
        for (int i = 1; i < 8; i++) {
            ac[i] = blk[i * 8];
            ac[8 + i] = blk[i];
        }
    }

    // ff_clean_intra_table_entries: a macroblock that is not intra leaves
    // no predictor
    void clean_intra() {
        for (int n = 0; n < 4; n++) {
            const size_t at = (size_t)(2 * mb_y + (n >> 1) + 1) * dc_wrap[0] + 2 * mb_x + (n & 1) + 1;
            dc_val[0][at] = 1024;
            memset(&ac_val[0][at * 16], 0, 16 * sizeof(int16_t));
        }
        for (int c = 1; c < 3; c++) {
            const size_t at = (size_t)(mb_y + 1) * dc_wrap[c] + mb_x + 1;
            dc_val[c][at] = 1024;
            memset(&ac_val[c][at * 16], 0, 16 * sizeof(int16_t));
        }
    }

    // get_vlc2 as preview_obmc meets it: -1 for a code not in the table
    // (past a slice's end, say), which reads no bits
    int peek_vlc(const Vlc& v) {
        const int s = v.sym[br.show(v.bits)];
        if (s >= 0) br.pos += v.len[br.show(v.bits)];
        return s;
    }

    // preview's vector component: ff_h263_decode_motion's 0xffff (stored
    // as -1) for an invalid code
    int peek_motion(int pred) {
        if (umv) return motion(pred);
        const int64_t pos = br.pos;
        if (peek_vlc(tables().mvd) < 0) return -1;
        br.pos = pos;
        return read_motion(br, tables().mvd, pred, 1);
    }

    // preview_obmc: the next macroblock's vectors and type, read ahead
    // (the reader is restored); it may read past the slice's end, where
    // FFmpeg takes an invalid MCBPC for an intra macroblock
    void preview_obmc() {
        const Tables& t = tables();
        const int64_t pos = br.pos;
        const int nx = mb_x + 1, xy = mb_y * mb_w + nx;
        int cbpc;
        while (true) {
            if (br.get1()) {
                mvp.set_mv16(nx, mb_y, 0, 0);
                intra_mb[xy] = 0;
                br.pos = pos;
                return;
            }
            cbpc = peek_vlc(t.inter_mcbpc);
            if (cbpc != 20) break;
        }
        intra_mb[xy] = (cbpc & 4) != 0;
        if (!(cbpc & 4)) {
            peek_vlc(t.cbpy);
            if (cbpc & 8) {
                if (modified_quant) br.skip(br.get1() ? 1 : 5);
                else br.skip(2);
            }
            if (!(cbpc & 16)) {
                int px, py;
                mvp.pred_mv(0, nx, mb_y, &px, &py, false);
                const int mx = peek_motion(px);
                const int my = peek_motion(py);
                mvp.set_mv16(nx, mb_y, mx, my);
            } else {
                for (int n = 0; n < 4; n++) {
                    int px, py;
                    mvp.pred_mv(n, nx, mb_y, &px, &py, false);
                    const int mx = peek_motion(px);
                    const int my = peek_motion(py);
                    if (umv && mx - px == 1 && my - py == 1) br.skip(1);
                    int16_t* m = mvp.mv_at(n, nx, mb_y);
                    m[0] = (int16_t)mx;
                    m[1] = (int16_t)my;
                }
            }
        }
        br.pos = pos;
    }

    // ---- reconstruction (ff_mpv_reconstruct_mb)

    // dct_unquantize_h263_{intra,inter}: int16 results, as FFmpeg stores
    // them; Annex I's intra blocks keep their DC and add no rounding term
    void dequant(int16_t* blk, int q, bool intra) const {
        const bool aic_intra = intra && aic;
        const int qmul = q << 1, qadd = aic_intra ? 0 : (q - 1) | 1;
        int i = 0;
        if (intra) {
            if (!aic_intra) blk[0] = (int16_t)(blk[0] * 8);   // ff_mpeg1_dc_scale_table
            i = 1;
        }
        for (; i < 64; i++) {
            const int l = blk[i];
            if (l) blk[i] = (int16_t)(l < 0 ? l * qmul - qadd : l * qmul + qadd);
        }
    }

    Edges edges() const { return Edges{mb_w * 16, mb_h * 16, width, height}; }

    void reconstruct(MbData& mb) {
        Plane* p = cur.p;
        const int x = mb_x, y = mb_y;
        mb_q[y * mb_w + x] = (uint8_t)mb.q;
        uint8_t* dy = p[0].at(x * 16, y * 16);
        uint8_t* du = p[1].at(x * 8, y * 8);
        uint8_t* dv = p[2].at(x * 8, y * 8);
        const int ls = p[0].w, cs = p[1].w;
        uint8_t* dst[6] = {dy, dy + 8, dy + 8 * ls, dy + 8 * ls + 8, du, dv};
        const int stride[6] = {ls, ls, ls, ls, cs, cs};
        if (mb.intra) {
            for (int n = 0; n < 6; n++) {
                dequant(mb.blk[n], n < 4 ? mb.q : mb.cq, true);
                idct(mb.blk[n], dst[n], stride[n], false);
            }
            return;
        }
        if (aic) clean_intra();
        const Edges e = edges();
        if (obmc) {
            apply_obmc(dy, du, dv, ls, cs);
        } else if (mb.mv4) {
            int sumx = 0, sumy = 0;
            for (int i = 0; i < 4; i++) {
                hpel_motion(ref.p[0], e, x * 16 + (i & 1) * 8, y * 16 + (i >> 1) * 8, mb.mv[i][0],
                            mb.mv[i][1], no_rnd, dy + (i & 1) * 8 + (i >> 1) * 8 * ls, ls);
                sumx += mb.mv[i][0];
                sumy += mb.mv[i][1];
            }
            chroma_4mv_motion(ref, e, x, y, sumx, sumy, no_rnd, du, dv, cs);
        } else {
            mpeg_motion(ref, e, x, y, mb.mv[0][0], mb.mv[0][1], no_rnd, dy, du, dv, ls, cs);
        }
        for (int n = 0; n < 6; n++) {
            if (mb.last[n] < 0) continue;
            dequant(mb.blk[n], n < 4 ? mb.q : mb.cq, false);
            idct(mb.blk[n], dst[n], stride[n], true);
        }
    }

    // apply_obmc: each 8x8 luma block blended from its own vector's
    // prediction and its neighbours' (a missing or intra neighbour's taken
    // from the block itself; below, the macroblock's own lower row), the
    // chroma from the sum of the four own vectors
    void apply_obmc(uint8_t* dy, uint8_t* du, uint8_t* dv, int ls, int cs) {
        const int x = mb_x, y = mb_y, xy = y * mb_w + x;
        int16_t cache[4][4][2];
        auto put = [&](int r, int c, const int16_t* m) {
            cache[r][c][0] = m[0];
            cache[r][c][1] = m[1];
        };
        put(1, 1, mvp.mv_at(0, x, y));
        put(1, 2, mvp.mv_at(1, x, y));
        put(2, 1, mvp.mv_at(2, x, y));
        put(2, 2, mvp.mv_at(3, x, y));
        put(3, 1, mvp.mv_at(2, x, y));
        put(3, 2, mvp.mv_at(3, x, y));
        const bool above = y > 0 && !intra_mb[xy - mb_w];
        put(0, 1, above ? mvp.mv_at(2, x, y - 1) : cache[1][1]);
        put(0, 2, above ? mvp.mv_at(3, x, y - 1) : cache[1][2]);
        const bool left = x > 0 && !intra_mb[xy - 1];
        put(1, 0, left ? mvp.mv_at(1, x - 1, y) : cache[1][1]);
        put(2, 0, left ? mvp.mv_at(3, x - 1, y) : cache[2][1]);
        const bool right = x + 1 < mb_w && !intra_mb[xy + 1];
        put(1, 3, right ? mvp.mv_at(0, x + 1, y) : cache[1][2]);
        put(2, 3, right ? mvp.mv_at(2, x + 1, y) : cache[2][2]);
        const Edges e = edges();
        int sumx = 0, sumy = 0;
        for (int i = 0; i < 4; i++) {
            const int c = (i & 1) + 1, r = (i >> 1) + 1;
            // mid, top, left, right, bottom
            const int16_t* mv[5] = {cache[r][c], cache[r - 1][c], cache[r][c - 1], cache[r][c + 1],
                                    cache[r + 1][c]};
            uint8_t pred[5][64];
            for (int k = 0; k < 5; k++)
                hpel_motion(ref.p[0], e, x * 16 + (i & 1) * 8, y * 16 + (i >> 1) * 8, mv[k][0], mv[k][1],
                            no_rnd, pred[k], 8);
            uint8_t* d = dy + (i & 1) * 8 + (i >> 1) * 8 * ls;
            for (int yy = 0; yy < 8; yy++)
                for (int xx = 0; xx < 8; xx++) {
                    const int j = yy * 8 + xx;
                    const int tb = kObmcTopBottom[yy][xx], lr = kObmcLeftRight[yy][xx];
                    const int v = kObmcMid[yy][xx] * pred[0][j] + (yy < 4 ? tb * pred[1][j] : tb * pred[4][j]) +
                                  (xx < 4 ? lr * pred[2][j] : lr * pred[3][j]);
                    d[yy * ls + xx] = (uint8_t)((v + 4) >> 3);
                }
            sumx += mv[0][0];
            sumy += mv[0][1];
        }
        chroma_4mv_motion(ref, e, x, y, sumx, sumy, no_rnd, du, dv, cs);
    }

    // ff_h263_loop_filter: the current macroblock's inner edges and its
    // edges with the macroblocks above and to the left, the lower halves
    // of the vertical edges one row later; a skipped macroblock filters
    // with its neighbour's QUANT, none with two skipped sides
    void loop_filter() {
        const int x = mb_x, y = mb_y, xy = y * mb_w + x;
        const int ls = cur.p[0].w, cs = cur.p[1].w;
        uint8_t* dy = cur.p[0].at(x * 16, y * 16);
        uint8_t* du = cur.p[1].at(x * 8, y * 8);
        uint8_t* dv = cur.p[2].at(x * 8, y * 8);
        auto cq = [&](int q) { return chroma_table ? kChromaQ[q] : q; };
        // v: a horizontal edge (filtered vertically); h: a vertical one
        auto v = [&](uint8_t* s, int stride, int q) { loop_filter_edge(s, 1, stride, q); };
        auto h = [&](uint8_t* s, int stride, int q) { loop_filter_edge(s, stride, 1, q); };
        int qp_c = 0;
        if (!skip_mb[xy]) {
            qp_c = qscale;
            v(dy + 8 * ls, ls, qp_c);
            v(dy + 8 * ls + 8, ls, qp_c);
        }
        if (y) {
            const int qp_tt = skip_mb[xy - mb_w] ? 0 : mb_q[xy - mb_w];
            const int qp_tc = qp_c ? qp_c : qp_tt;
            if (qp_tc) {
                v(dy, ls, qp_tc);
                v(dy + 8, ls, qp_tc);
                v(du, cs, cq(qp_tc));
                v(dv, cs, cq(qp_tc));
            }
            if (qp_tt) h(dy - 8 * ls + 8, ls, qp_tt);
            if (x) {
                const int qp_dt =
                    qp_tt || skip_mb[xy - 1 - mb_w] ? qp_tt : mb_q[xy - 1 - mb_w];
                if (qp_dt) {
                    h(dy - 8 * ls, ls, qp_dt);
                    h(du - 8 * cs, cs, cq(qp_dt));
                    h(dv - 8 * cs, cs, cq(qp_dt));
                }
            }
        }
        if (qp_c) {
            h(dy + 8, ls, qp_c);
            if (y + 1 == mb_h) h(dy + 8 * ls + 8, ls, qp_c);
        }
        if (x) {
            const int qp_lc = qp_c || skip_mb[xy - 1] ? qp_c : mb_q[xy - 1];
            if (qp_lc) {
                h(dy, ls, qp_lc);
                if (y + 1 == mb_h) {
                    h(dy + 8 * ls, ls, qp_lc);
                    h(du, cs, cq(qp_lc));
                    h(dv, cs, cq(qp_lc));
                }
            }
        }
    }

    void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
        const Picture& pic = show_cur ? cur : ref;
        const int w = width, h = height, cw = (w + 1) / 2, ch = (h + 1) / 2;
        for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, pic.p[0].at(0, r), w);
        for (int r = 0; r < ch; r++) {
            memcpy(u + (size_t)r * cw, pic.p[1].at(0, r), cw);
            memcpy(v + (size_t)r * cw, pic.p[2].at(0, r), cw);
        }
    }
};

}  // namespace

// ===================================================================== C API

extern "C" {

// a decoder of H.263 and H.263+ (flv 0) or of Sorenson H.263 (flv 1)
void* h263_dec_new(int64_t flv) {
    tables();
    Decoder* d = new Decoder();
    d->flv = flv != 0;
    return d;
}

void h263_dec_free(void* h) { delete (Decoder*)h; }

// a decoder that starts where OpenCV's seek leaves FFmpeg's: holding the
// pictures its first read decoded, so no disposable picture is skipped
void h263_dec_after_seek(void* h) { ((Decoder*)h)->refs = 2; }

// Decode one packet.  On H263_OK the picture's size is in wh[0..1];
// h263_dec_output copies its I420 planes out.
int h263_dec_decode(void* h, const uint8_t* data, int64_t n, int64_t* wh, char* msg, int64_t cap) {
    Decoder* d = (Decoder*)h;
    try {
        const int rc = d->decode(data, n);
        wh[0] = d->width;
        wh[1] = d->height;
        return rc;
    } catch (const Failure& f) {
        put_msg(msg, cap, f.msg);
        return f.kind;
    }
}

void h263_dec_output(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { ((Decoder*)h)->output(y, u, v); }

int64_t h263_dec_features(void* h) { return ((Decoder*)h)->features; }

}  // extern "C"
